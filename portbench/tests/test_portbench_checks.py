"""The checks that decide ``correct``: a sound run passes, and the control
and each fault a cell can have fail, at a size a CPU test holds.

Each fault breaks the timed path underneath the harness (the harness's look
for a chip is skipped: the cells run on the CPU through the port's plain
versions, in complex64 as on the card)."""

from __future__ import annotations

import importlib
import io
import re

import numpy as np
import torch

from portbench import runner


def _run(cell, seconds=0.3):
    return runner.execute(cell, 2 ** 31 + 17, seconds, 0, device="cpu")


def _failed(res):
    return [c["name"] for c in res["checks"] if not runner.passed(c)]


# ----- solve.deflector.b1024 -----

SOLVE = "solve.deflector.b1024"


def test_solve_sound_run_is_correct(tiny):
    res = _run(tiny(SOLVE))
    assert res["correct"] and res["failed"] == 0, res["checks"]


def test_solve_control_is_not_correct(tiny):
    cell = tiny(SOLVE)
    driver = cell.driver()
    state = driver.setup(cell, 5, "cpu")
    units, _ = runner.window(driver, state, _spans(), 0.2)
    limit = cell.workload["check"]["limits"]["amp_err"]["max"]
    program = driver.check(state)[0][0]["value"]
    control = driver.control(state)[0]["value"]
    assert program <= limit < control


def _spans():
    from portbench import harness
    return harness.Spans(torch, False)


def _wrap_solve(monkeypatch, alter):
    rcwa = importlib.import_module("metalens_tpu_torch.solver.rcwa")
    real = rcwa.cell_amplitudes

    def broken(*a, **k):
        af, ar, Kx, Ky = real(*a, **k)
        return (*alter(af.clone(), ar.clone()), Kx, Ky)
    monkeypatch.setattr(rcwa, "cell_amplitudes", broken)


def test_solve_answer_altered_is_not_correct(tiny, monkeypatch):
    def alter(af, ar):
        af[1, 0, 0] += 0.02      # one amplitude of one cell, as produced
        return af, ar
    _wrap_solve(monkeypatch, alter)
    res = _run(tiny(SOLVE))
    assert not res["correct"] and _failed(res) == ["amp_err"]
    assert res["failed"] >= 1


def test_solve_half_batch_left_out_is_not_correct(tiny, monkeypatch):
    def alter(af, ar):
        h = af.shape[0] // 2     # the second half copies the first
        af[h:2 * h], ar[h:2 * h] = af[:h], ar[:h]
        return af, ar
    _wrap_solve(monkeypatch, alter)
    res = _run(tiny(SOLVE))
    assert not res["correct"] and _failed(res) == ["amp_err"]


# ----- design.ns2_member.rp40 -----

DESIGN = "design.ns2_member.rp40"


def _fused():
    return importlib.import_module("metalens_tpu_torch.optimize_fused")


def test_design_sound_run_is_correct(tiny):
    res = _run(tiny(DESIGN), seconds=0.5)
    assert res["correct"], res["checks"]


def test_design_control_is_not_correct(tiny):
    cell = tiny(DESIGN)
    driver = cell.driver()
    state = driver.setup(cell, 9, "cpu")
    runner.window(driver, state, _spans(), 0.5)
    lim = cell.workload["check"]["limits"]["fom_gap"]["max"]
    program = driver.check(state)[0]
    control = {c["name"]: c["value"] for c in driver.control(state)}
    assert program[0]["value"] <= lim < control["fom_gap"]


def _report(g, fom, attempts, accepted):
    print(f"#optimize2_fused: fom={fom:.6f} after {attempts} attempts "
          f"({accepted} accepted)")
    print("mygrating=" + repr(g))


def test_design_state_unchanged_is_not_correct(tiny, monkeypatch):
    """Every call returns its start, with the start's FOM."""
    from metalens_tpu_torch.solver.fom import FomTerm

    def stuck(g, lam, attempts, numG, terms, seed, verbose, device, dtype):
        _report(g.copy(), g.fom(lam, numG, terms, device=device,
                                dtype=dtype), attempts, 0)
        return g.copy()
    monkeypatch.setattr(_fused(), "optimize2_fused", stuck)
    assert FomTerm
    res = _run(tiny(DESIGN), seconds=0.5)
    assert not res["correct"] and "fom_rise" in _failed(res)


def test_design_answer_altered_is_not_correct(tiny, monkeypatch):
    """The result moves 3 nm after its FOM was taken."""
    real = _fused().optimize2_fused

    def altered(g, *a, **k):
        buf = io.StringIO()
        import contextlib
        with contextlib.redirect_stdout(buf):
            out = real(g, *a, **k)
        fom = float(re.search(r"fom=(\S+)", buf.getvalue()).group(1))
        out.xyrra_list[0, 0] += 3e-9
        _report(out, fom, k["attempts"], 1)
        return out
    monkeypatch.setattr(_fused(), "optimize2_fused", altered)
    res = _run(tiny(DESIGN), seconds=0.5)
    assert not res["correct"] and "fom_gap" in _failed(res)


def test_design_accept_logic_inverted_is_not_correct(tiny, monkeypatch):
    """The loop takes the worse points (its batches score -FOM), and each
    call reports its result's true FOM."""
    fused = _fused()
    real_eval, real_opt = fused._fom_eval, fused.optimize2_fused

    def negated(xyrra, *a, **k):
        return -real_eval(xyrra, *a, **k)

    def inverted(g, lam, attempts, numG, terms, seed, verbose, device, dtype):
        with monkeypatch.context() as m:
            m.setattr(fused, "_fom_eval", negated)
            buf = io.StringIO()
            import contextlib
            with contextlib.redirect_stdout(buf):
                out = real_opt(g, lam, attempts=attempts, numG=numG,
                               terms=terms, seed=seed, verbose=True,
                               device=device, dtype=dtype)
        _report(out, out.fom(lam, numG, terms, device=device, dtype=dtype),
                attempts, 1)
        return out
    monkeypatch.setattr(fused, "optimize2_fused", inverted)
    res = _run(tiny(DESIGN), seconds=0.5)
    assert not res["correct"]
    assert {"accept_drop", "fom_rise"} <= set(_failed(res))


# ----- db4.ns2_rgb (a gloo world of four ranks on the CPU) -----

DB4 = "db4.ns2_rgb"
NO_EXCHANGE = '''

# the fault: the exchange between ranks left out -- each rank's "gathered"
# result is its own block in every rank's place
from metalens_tpu_torch.parallel import mesh as _mesh  # noqa: E402


def _own_block_only(self, t):
    return t.repeat((self.size,) + (1,) * (t.ndim - 1))


_mesh.Mesh.all_gather = _own_block_only
'''


def test_db4_sound_run_is_correct(tiny):
    res = _run(tiny(DB4), seconds=0.5)
    assert res["correct"] and res["device"]["count"] == 4, res["checks"]


def test_db4_exchange_left_out_is_not_correct(tiny):
    cell = tiny(DB4)
    path = cell.base / "drivers" / "db4.py"
    path.write_text(path.read_text() + NO_EXCHANGE)
    res = _run(cell, seconds=0.5)
    assert not res["correct"] and _failed(res) == ["amp_err"]


def test_db4_control_is_not_correct(tiny):
    cell = tiny(DB4)
    res = cell.driver().execute(cell, 3, 0.3, 0, 0.0, device="cpu",
                                control=True)
    limit = cell.workload["check"]["limits"]["amp_err"]["max"]
    assert res["correct"] and res["control"]["amp_err"] > limit
    assert np.isfinite(res["checks"][0]["value"])
