"""Unit-cell solves: back-to-back batches through the port's
``solver.rcwa.cell_amplitudes``, one caller in a closed loop.

A unit is one batch of ``batch`` cells: the configuration's pillars with
normal noise of ``noise_m`` on their centres and semi-axes, each cell at
its own incidence ux drawn uniformly from ``ux`` (uy = 0), both
polarizations.  ``pool`` distinct batches are made from the seed and
cycled.  The check (the cell's ``check``) solves ``batches`` batches of the
window, drawn from the seed, again with the plain reference in complex128
and compares every amplitude of an order that propagates with normalized
|kz| >= ``min_kz`` in its medium.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen
from portbench.checks import propagating
from portbench.reference import rcwa as ref
DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}
REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def schedule(cfg):
    """The order set and the (n_slabs, taylor_terms) schedule the port
    picks for the configuration, as the port's own callers do."""
    from metalens_tpu_torch.solver import orders as ordmod, rcwa
    orders = ordmod.select_orders(cfg["grating_period"],
                                  cfg["lateral_period"], cfg["numG"])
    k0h = 2 * np.pi * cfg["cyl_height"] / cfg["wavelength"]
    n_slabs, terms = rcwa.slab_schedule(
        k0h, orders, cfg["grating_period"], cfg["lateral_period"],
        cfg["wavelength"], max(cfg["n_pillar"], cfg["n_glass"]) ** 2,
        dtype=DTYPES[cfg["dtype"]])
    return orders, n_slabs, terms


def setup(cell, seed, device):
    from metalens_tpu_torch.solver import rcwa
    cfg, tr = cell.config, cell.traffic
    rdt = REAL[DTYPES[cfg["dtype"]]]
    orders, n_slabs, terms = schedule(cfg)
    N = len(orders)
    rng = gen.rng(seed)
    pool = []
    for _ in range(tr["pool"]):
        xy = gen.noisy_rows(rng, cfg["xyrra"], tr["batch"], tr["noise_m"])
        ux = gen.uniform(rng, tr["ux"], tr["batch"])
        pool.append((torch.as_tensor(xy, dtype=rdt, device=device),
                     torch.as_tensor(ux, dtype=rdt, device=device)))
    i0 = ref.order_index(orders, 0, 0)
    c = np.zeros((2 * N, 2))
    c[i0, 0] = c[i0 + N, 1] = 1.0
    state = {"cfg": cfg, "tr": tr, "orders": orders, "pool": pool, "c": c,
             "n_slabs": n_slabs, "terms": terms, "rcwa": rcwa, "done": 0,
             "chk": cell.workload["check"],
             "kept": gen.Reservoir(rng, cell.workload["check"]["batches"]),
             "device": device}
    for _ in range(2):      # the one shape of the traffic, built and warm
        _solve(state, 0)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return state


def _solve(state, k):
    cfg = state["cfg"]
    xy, ux = state["pool"][k]
    af, ar, _, _ = state["rcwa"].cell_amplitudes(
        state["orders"], xy, cfg["grating_period"], cfg["lateral_period"],
        cfg["cyl_height"], cfg["n_pillar"] ** 2, cfg["n_glass"] ** 2,
        cfg["wavelength"], ux, 0.0, state["c"], n_slabs=state["n_slabs"],
        taylor_terms=state["terms"], fff=cfg["nv"])
    return af, ar


def run_unit(state, spans):
    k = state["done"] % len(state["pool"])
    with spans("cell_amplitudes"):
        af, ar = _solve(state, k)
        if af.is_cuda:
            torch.cuda.synchronize()
    state["kept"].offer((k, af, ar))
    state["done"] += 1


def end_to_end(state, units, window_s):
    return {"solves_per_s": units * state["tr"]["batch"] / window_s}


def trace_units(state):
    return state["tr"]["trace_units"]


def release(state):
    state["rcwa"] = None


def compare(state, prec=ref.FULL, outputs=None, block=256):
    """Largest amplitude gap between the kept batches' outputs (or
    ``outputs``, a list of (k, af, ar)) and the reference in complex128,
    over the orders that propagate in glass (transmitted) and in air
    (reflected); and the gap of each cell."""
    cfg, chk = state["cfg"], state["chk"]
    kept = state["kept"].items if outputs is None else outputs
    orders = ref.select_orders(cfg["grating_period"], cfg["lateral_period"],
                               cfg["numG"])
    if not np.array_equal(orders, state["orders"]):
        # the program's amplitudes are laid out by its own order set
        return float("inf"), torch.full((1,), float("inf"))
    worst = 0.0
    per_cell = []
    for k, af, ar in kept:
        xy, ux = state["pool"][k]
        for s in range(0, xy.shape[0], block):
            sl = slice(s, s + block)
            bf, br, Kx, Ky = ref.cell_amplitudes(
                orders, xy[sl].double(), cfg["grating_period"],
                cfg["lateral_period"], cfg["cyl_height"],
                cfg["n_pillar"] ** 2, cfg["n_glass"] ** 2, cfg["wavelength"],
                ux[sl].double(), 0.0, state["c"], nv=cfg["nv"])
            mf = propagating(Kx, Ky, cfg["n_glass"] ** 2, chk["min_kz"])
            mr = propagating(Kx, Ky, 1.0, chk["min_kz"])
            gf = ((af[sl].to(bf.dtype) - bf).abs().amax(-1) * mf).amax(-1)
            gr = ((ar[sl].to(br.dtype) - br).abs().amax(-1) * mr).amax(-1)
            gap = torch.maximum(gf, gr).nan_to_num(nan=float("inf"))
            per_cell.append(gap.cpu())
            worst = max(worst, float(gap.max()))
    return worst, torch.cat(per_cell) if per_cell else torch.zeros(0)


def check(state):
    limit = state["chk"]["limits"]["amp_err"]["max"]
    worst, per_cell = compare(state)
    attempted = state["done"] * state["tr"]["batch"]
    return ([{"name": "amp_err", "value": worst, "max": limit}], attempted,
            int((per_cell > limit).sum()))


def control(state, block=256):
    """The control: the reference put in the program's place on the kept
    batches, one precision step below the configuration's complex64
    (TF32 operands in every product), held to the same check."""
    cfg = state["cfg"]
    orders = ref.select_orders(cfg["grating_period"], cfg["lateral_period"],
                               cfg["numG"])
    outs = []
    for k, _, _ in state["kept"].items:
        xy, ux = state["pool"][k]
        fs, rs = [], []
        for s in range(0, xy.shape[0], block):
            sl = slice(s, s + block)
            cf, cr, _, _ = ref.cell_amplitudes(
                orders, xy[sl].float(), cfg["grating_period"],
                cfg["lateral_period"], cfg["cyl_height"],
                cfg["n_pillar"] ** 2, cfg["n_glass"] ** 2, cfg["wavelength"],
                ux[sl].float(), 0.0, state["c"], nv=cfg["nv"],
                prec=ref.Precision("tf32"))
            fs.append(cf)
            rs.append(cr)
        outs.append((k, torch.cat(fs), torch.cat(rs)))
    worst, _ = compare(state, outputs=outs)
    return [{"name": "amp_err", "value": worst}]
