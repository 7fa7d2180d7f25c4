"""The fused design loop: chained ``optimize2_fused`` calls on one member of
the configuration's periphery, each call starting from the last result.

The member is the configuration's seed member (``pillars`` pillars across
the supercell at ``angle_deg``, radii ramped and shrunk until they pass the
fabrication check), with normal noise of ``perturb_m`` on the centres and
semi-axes drawn from the seed.  A unit is one call of ``attempts``
attempts, each one FOM batch of 10 candidates at the configuration's RGB
terms and design numG, with its own draw seed taken from the cell's seed.

The check takes ``calls`` calls of the window, drawn from the seed, and the
plain reference's FOM in complex128 of their starts and results:

* ``fom_gap``: the FOM the call reports for its result against the
  reference's FOM of that result;
* ``accept_drop``: how far the reference's FOM of a result lies below that
  of its start (the accept logic takes no worse point);
* ``fom_rise``: the reference's FOM of the window's last result over that of
  its first start (the loop moves).
"""

from __future__ import annotations

import contextlib
import io
import math
import re

import numpy as np
import torch

from portbench import gen
from portbench.reference import fom as rfom
from portbench.reference.rcwa import FULL, Precision

REPORT = re.compile(r"#optimize2_fused: fom=(\S+) after (\d+) attempts "
                    r"\((\d+) accepted\)")


def seed_member(Grating, validate, cfg, angle_deg, n_pillars):
    """The configuration's seed member: n pillars across the supercell with
    ramped radii, shrunk until ``validate`` passes."""
    angle = math.radians(angle_deg)
    lam = cfg["design_wavelength"]
    period_nm = lam * 1e9 / math.sin(angle)
    rows = []
    for i in range(n_pillars):
        f = i / max(n_pillars - 1, 1)
        rows.append([-period_nm / 2 + (i + 0.5) * period_nm / n_pillars, 0.0,
                     60.0 + 55.0 * f, 68.0 + 42.0 * f, 0.0])
    g = Grating(lateral_period=cfg["lateral_period"],
                cyl_height=cfg["cyl_height"], target_wavelength=lam,
                angle_in_air=angle, xyrra_list_in_nm_deg=np.array(rows))
    for _ in range(30):
        if validate(g):
            return g
        g.xyrra_list[:, 2:4] *= 0.95
    raise RuntimeError(f"no feasible seed member at {angle_deg} deg")


def setup(cell, seed, device):
    from metalens_tpu_torch import Grating, validate
    from metalens_tpu_torch.optimize_fused import optimize2_fused
    from metalens_tpu_torch.solver.fom import FomTerm
    cfg, tr = cell.config, cell.traffic
    rng = gen.rng(seed)
    g = seed_member(Grating, validate, cfg, tr["angle_deg"], tr["pillars"])
    base = g.xyrra_list.copy()
    for _ in range(100):
        g.xyrra_list = gen.noisy_rows(rng, base, 1, tr["perturb_m"])[0]
        if validate(g):
            break
    else:
        raise RuntimeError("no feasible perturbed member")
    terms = [FomTerm(lam, w, order, inphase)
             for lam, w, order, inphase in cfg["terms"]]
    state = {"cfg": cfg, "tr": tr, "g": g, "terms": terms, "device": device,
             "opt": optimize2_fused, "calls": [],
             "chk": cell.workload["check"], "rng": rng}
    # the cell's shapes (the start at B = 1, the attempts at B = 10), built
    # and warm; the warm-up's result is dropped
    _call(state, g, 2, 0)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return state


def _call(state, start, attempts, seed):
    cfg = state["cfg"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = state["opt"](start, cfg["design_wavelength"], attempts=attempts,
                         numG=cfg["design_numG"], terms=state["terms"],
                         seed=seed, verbose=True, device=state["device"],
                         dtype=torch.complex64)
    m = REPORT.search(buf.getvalue())
    if m is None:
        raise RuntimeError("optimize2_fused printed no report: "
                           + buf.getvalue()[-400:])
    return g, float(m.group(1)), int(m.group(3))


def run_unit(state, spans):
    start = state["g"]
    attempts = state["tr"]["attempts"]
    seed = gen.child_seeds(state["rng"], 1)[0]
    with spans("optimize2_fused"):
        g, fom, accepted = _call(state, start, attempts, seed)
    state["calls"].append({"start": start.xyrra_list.copy(),
                           "result": g.xyrra_list.copy(), "fom": fom,
                           "accepted": accepted, "attempts": attempts})
    state["g"] = g


def candidates(call):
    """Candidate geometries whose FOM one call evaluates: its start and 10
    per attempt."""
    return 1 + 10 * call["attempts"]


def end_to_end(state, units, window_s):
    done = state["calls"][-units:]
    return {"design_cands_per_s": sum(map(candidates, done)) / window_s}


def trace_units(state):
    return 1


def release(state):
    state["opt"] = None


def _sample(state):
    """The calls the check compares, drawn once from the seed."""
    if "sample" not in state:
        calls = state["calls"]
        k = min(state["chk"]["calls"], len(calls))
        idx = sorted(state["rng"].choice(len(calls), size=k, replace=False))
        state["sample"] = [calls[i] for i in idx]
    return state["sample"]


def _reference_foms(state, rows, prec=FULL, dtype=torch.float64):
    g = state["g"]
    return rfom.fom(state["cfg"], g.grating_period, rows,
                    device=state["device"], dtype=dtype, prec=prec)


def readings(state, fom_of_results=None):
    """The three compared numbers; ``fom_of_results`` stands in for the
    FOMs the calls report (the control)."""
    calls = state["calls"]
    sample = _sample(state)
    rows = ([c["start"] for c in sample] + [c["result"] for c in sample]
            + [calls[0]["start"], calls[-1]["result"]])
    f = _reference_foms(state, np.stack(rows))
    k = len(sample)
    f_start, f_result = f[:k], f[k:2 * k]
    reported = (np.array([c["fom"] for c in sample]) if fom_of_results is None
                else fom_of_results(np.stack([c["result"] for c in sample])))
    gaps = np.abs(reported - f_result)
    drop = float((f_start - f_result).max())
    return ([{"name": "fom_gap", "value": float(gaps.max())},
             {"name": "accept_drop", "value": drop},
             {"name": "fom_rise", "value": float(f[-1] - f[-2])}],
            gaps)


def check(state):
    lim = state["chk"]["limits"]
    checks, gaps = readings(state)
    for c in checks:
        c.update(lim[c["name"]])
    attempted = sum(map(candidates, state["calls"]))
    return checks, attempted, int((gaps > lim["fom_gap"]["max"]).sum())


def control(state):
    """The reference's FOM one precision step below complex64 (TF32
    operands) in place of the FOM the calls report."""
    checks, _ = readings(state, lambda rows: _reference_foms(
        state, rows, prec=Precision("tf32"), dtype=torch.float32))
    return checks
