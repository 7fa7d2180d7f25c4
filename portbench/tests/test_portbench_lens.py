"""The lens cell at a size a CPU test holds: the plain reference agrees with
the port in complex128, and the control and each fault the cell can have
fail its check.

Each fault breaks the timed path underneath the harness (the harness's look
for a chip is skipped: the port runs on the CPU)."""

from __future__ import annotations

import importlib

import pytest
import torch

from portbench import harness, runner

LENS = "lens.ns2_580"


def _run(cell, seconds=0.3):
    return runner.execute(cell, 2 ** 31 + 29, seconds, 0, device="cpu")


def _failed(res):
    return [c["name"] for c in res["checks"] if not runner.passed(c)]


def test_lens_reference_agrees_with_the_port_in_complex128(tiny):
    """On the CPU the port runs in complex128: every compared number is
    rounding."""
    res = _run(tiny(LENS))
    got = {c["name"]: c["value"] for c in res["checks"]}
    assert got["layout_miss"] == 0 and got["pick_loss"] == 0
    for name in ("db_err", "db_med_err", "stitch_err", "ff_err",
                 "focal_gap"):
        assert got[name] < 1e-7, got


def test_lens_reports_its_metrics(tiny):
    cell = tiny(LENS)
    res = _run(cell)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "lens_check_s"}
    res = runner.execute(cell, 11, 0.1, 1, device="cpu")
    assert res["correct"]
    assert {"make_design_ms.lens", "stitch_ms.lens", "farfield_ms.lens"} \
        & set(res["metrics"]) == {"make_design_ms.lens"}


def test_lens_control_is_not_correct(tiny):
    cell = tiny(LENS)
    driver = cell.driver()
    state = driver.setup(cell, 4, "cpu")
    runner.window(driver, state, harness.Spans(torch, False), 0.1)
    driver.release(state)
    program, _, _ = driver.check(state)
    assert all(runner.passed(c) for c in program)
    lim = cell.workload["check"]["limits"]
    control = driver.control(state)
    assert any(c["value"] > lim[c["name"]]["max"] for c in control)


def _db_entry(m):
    engine = importlib.import_module("metalens_tpu_torch.engine")
    real = engine.characterize_grating

    def broken(*a, **k):
        data = real(*a, **k)
        data[0] = dict(data[0], ampfx=data[0]["ampfx"] + 0.1)
        return data
    m.setattr(engine, "characterize_grating", broken)


def _near_field(alter):
    def fault(m):
        nf = importlib.import_module("metalens_tpu_torch.nearfield")
        real = nf.build_nearfield

        def broken(*a, **k):
            out = list(real(*a, **k))
            out[:4] = alter([f.clone() for f in out[:4]])
            return tuple(out)
        m.setattr(nf, "build_nearfield", broken)
    return fault


def _altered_point(F):
    Ex = F[0]
    i, j = divmod(int(Ex.abs().argmax()), Ex.shape[1])
    Ex[i, j] *= 1.05
    return F


def _half_left_out(F):
    for f in F:
        f[:, f.shape[1] // 2:] = 0
    return F


def _ring_dropped(m):
    asm = importlib.import_module("metalens_tpu_torch.assembly")
    real = asm.make_design

    def broken(*a, **k):
        lps, lcs, r_sw, xyrra = real(*a, **k)
        lps = {k2: (v[:-1] if k2.endswith("_list") and k2 !=
                    "gratingcollection_list" else v)
               for k2, v in lps.items()}
        return lps, lcs, r_sw, xyrra
    m.setattr(asm, "make_design", broken)


def _far_field(m):
    ff = importlib.import_module("metalens_tpu_torch.farfield")
    real = ff.farfield

    def broken(*a, **k):
        P, *rest = real(*a, **k)
        P = P.clone()
        P[P.shape[0] // 2, P.shape[1] // 2] *= 1.05
        return (P, *rest)
    m.setattr(ff, "farfield", broken)


@pytest.mark.parametrize("fault,fails", [
    (_db_entry, "db_err"),
    (_near_field(_altered_point), "stitch_err"),
    (_near_field(_half_left_out), "stitch_err"),
    (_ring_dropped, "layout_miss"),
    (_far_field, "ff_err"),
], ids=["database_entry_altered", "near_field_point_altered",
        "half_the_aperture_left_out", "ring_dropped", "far_field_altered"])
def test_lens_fault_is_not_correct(tiny, monkeypatch, fault, fails):
    fault(monkeypatch)
    res = _run(tiny(LENS))
    assert not res["correct"] and fails in _failed(res), res["checks"]
