"""The periphery database over a world of ranks: repeated passes of the
port's ``parallel.sharded_characterize_amps``, one process per card.

The database is the configuration's brackets, each an unoptimized
collection of ``bracket_members`` two-pillar members (the published
round-lens collection: angles evenly over the bracket, lateral periods
scaled by tan(angle)), with normal noise of ``perturb_m`` on the pillars
drawn from the seed.  Each member is characterized at the configuration's
characterize numG over the u_steps x u_steps grid of directions its
collection deflects (ux over the bracket's angles +- 0.25, uy over +-0.2,
inside the unit circle), at each of the configuration's RGB wavelengths.  A
call is one bracket at one wavelength, member-major, so each rank solves
one member's directions; a pass (the unit) is every bracket at every
wavelength.

The check takes ``calls`` calls of the window, drawn from the seed on rank
0, and compares the gathered amplitudes of every rank with the plain
reference in complex128, every order that propagates with normalized
|kz| >= ``min_kz`` in its medium.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import gen, harness, work
from portbench.checks import propagating
from portbench.reference import rcwa as ref
from portbench.reference.fom import index
from portbench.runner import passed, per_layer_values


def database(cfg, perturb, rng):
    """The calls of one pass: dicts of host arrays (xyrra (B, 2, 5), Lx,
    Ly, ux, uy (B,)) and the wavelength, B = members x directions,
    member-major."""
    lam0 = cfg["design_wavelength"]
    n = cfg["bracket_members"]
    calls = []
    for b in gen.round_brackets(cfg, perturb, rng):
        Lx, Ly, rows = zip(*b["members"])
        # the directions the collection deflects (its own rule: angles in
        # radians +- 0.25 as ux, clipped to +-0.99)
        a_in, a_out = math.asin(lam0 / Lx[0]), math.asin(lam0 / Lx[-1])
        k = cfg["u_steps"]
        ux = np.linspace(max(-0.99, a_in - 0.25), min(0.99, a_out + 0.25), k)
        uy = np.linspace(-0.2, 0.2, k)
        UX, UY = np.meshgrid(ux, uy, indexing="ij")
        inside = UX.ravel() ** 2 + UY.ravel() ** 2 < 1.0
        ux_d, uy_d = UX.ravel()[inside], UY.ravel()[inside]
        d = len(ux_d)
        for lam in cfg["wavelengths"]:
            calls.append({
                "lam": lam,
                "xyrra": np.repeat(np.stack(rows), d, axis=0),
                "Lx": np.repeat(Lx, d), "Ly": np.repeat(Ly, d),
                "ux": np.tile(ux_d, n), "uy": np.tile(uy_d, n)})
    return calls


def execute(cell, seed, seconds, trace, t_start, device="cuda", seeds=None,
            control=False):
    from portbench import ranks
    args = {"seeds": [seed] if seeds is None else list(seeds),
            "seconds": seconds, "trace": trace, "t_start": t_start,
            "control": control}
    return ranks.spawn(cell, cell.chips, args, device=device)


def _pass(ch, args, spans, keep=None):
    with spans("pass"):
        for k, a in enumerate(args):
            af, ar = ch(*a)
            if keep is not None:
                keep.offer((k, af, ar))
        if af.is_cuda:
            torch.cuda.synchronize()


def _args(cfg, calls, device):
    out = []
    for c in calls:
        lam = c["lam"]
        t = (lambda x: torch.as_tensor(x, dtype=torch.float32, device=device))
        out.append((t(c["xyrra"]), c["Lx"], c["Ly"], cfg["cyl_height"],
                    complex(index(cfg["n_tio2"], lam)) ** 2,
                    complex(index(cfg["n_glass"], lam)) ** 2, lam,
                    t(c["ux"]), t(c["uy"])))
    return out


def rank_run(cell, mesh, seeds, seconds, trace, t_start, control=False):
    import torch.distributed as dist
    from metalens_tpu_torch import parallel
    cfg, tr, chk = cell.config, cell.traffic, cell.workload["check"]
    cuda = mesh.device.type == "cuda"
    ch = parallel.sharded_characterize_amps(mesh, cfg["characterize_numG"],
                                            None, dtype=torch.complex64)
    out = []
    for seed in seeds:
        rng = gen.rng(seed)
        calls = database(cfg, tr["perturb_m"], rng)
        args = _args(cfg, calls, mesh.device)
        cells = sum(len(c["ux"]) for c in calls)
        off = harness.Spans(torch, False)
        _pass(ch, args, off)            # every shape, built and warm
        dist.barrier()
        setup_s = time.perf_counter() - t_start
        keep = gen.Reservoir(rng, chk["calls"]) if mesh.rank == 0 else None
        spans = harness.Spans(torch, cuda)
        passes, t0 = 0, time.perf_counter()
        while True:
            _pass(ch, args, spans, keep)
            passes += 1
            elapsed = time.perf_counter() - t0
            go = torch.tensor([float(elapsed < seconds)], device=mesh.device)
            dist.broadcast(go, 0)
            if not go.item():
                break
        window_s = elapsed
        rec = {"setup_s": setup_s, "window_s": window_s, "passes": passes}
        if trace:
            tspans = harness.Spans(torch, cuda)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                t1 = time.perf_counter()
                _pass(ch, args, tspans, keep)
                traced_s = time.perf_counter() - t1
            s = harness.trace_summary(prof, torch, traced_s)
            del prof
            rec.update(summary=s, pass_ms=tspans.device_ms("pass"))
        rec["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
        recs = mesh.all_gather_object(rec)
        if mesh.rank == 0:
            out.append(_result(cell, calls, keep, recs, cells, trace, cuda,
                               chk, control))
        del keep
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
    if mesh.rank != 0:
        return None
    return out[0] if len(seeds) == 1 else out


def _result(cell, calls, keep, recs, cells, trace, cuda, chk, control):
    r0 = recs[0]
    metrics, extra, breakdown = {}, {}, None
    if trace:
        ctx = {"ranks": recs, "units": 1, "cells": cells, "work": work}
        metrics = per_layer_values(cell, ctx)
        slow = max(recs, key=lambda r: sum(r["pass_ms"]))["summary"]
        extra = {"busy_s": sum(r["summary"]["busy_s"] for r in recs)
                 / len(recs),
                 "window_s": max(r["summary"]["window_s"] for r in recs)}
        breakdown = {"device_ops": [[k, v] for k, v in slow["device_ops"]],
                     "idle_gaps": slow["idle_gaps"]}
    else:
        values = {"db_cells_per_s": r0["passes"] * cells / r0["window_s"],
                  "setup_s": r0["setup_s"]}
        for m in cell.end_to_end():
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    worst, per_cell = compare(cell.config, calls, keep.items, chk["min_kz"])
    limit = chk["limits"]["amp_err"]["max"]
    checks = [{"name": "amp_err", "value": worst, "max": limit}]
    res = {"correct": all(passed(c) for c in checks),
           "attempted": int((r0["passes"] + int(bool(trace))) * cells),
           "failed": int((per_cell > limit).sum()),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": len(recs),
                      "memory_peak_bytes": int(max(r["peak"] for r in recs)),
                      **extra}}
    if breakdown is not None:
        res["breakdown"] = breakdown
    if control:
        res["control"] = {"amp_err": control_err(cell.config, calls,
                                                 keep.items, chk["min_kz"])}
    res["checks"] = checks
    return res


def _reference(cfg, call, prec=ref.FULL, dtype=torch.float64, device="cpu",
               block=64):
    """The reference's (slice, ampf, ampr, Kx, Ky, eps_glass) of one call,
    amplitudes (B, 2, 2N) in the program's layout, member by member (one
    period each) in blocks of at most ``block`` cells."""
    lam = call["lam"]
    eps_p = index(cfg["n_tio2"], lam) ** 2
    eps_g = index(cfg["n_glass"], lam) ** 2
    B = len(call["ux"])
    starts = [0] + [i for i in range(1, B)
                    if call["Lx"][i] != call["Lx"][i - 1]] + [B]
    spans = [(a, min(s + block, b)) for a, b in zip(starts, starts[1:])
             for s in range(a, b, block)]
    res = []
    for s, e in spans:
        sl = slice(s, e)
        Lx, Ly = call["Lx"][s], call["Ly"][s]
        orders = ref.select_orders(Lx, Ly, cfg["characterize_numG"])
        N = len(orders)
        i0 = ref.order_index(orders, 0, 0)
        c = np.zeros((2 * N, 2))
        c[i0, 0] = c[i0 + N, 1] = 1.0
        kw = dict(dtype=dtype, device=device)
        bf, br, Kx, Ky = ref.cell_amplitudes(
            orders, torch.as_tensor(call["xyrra"][sl], **kw), Lx, Ly,
            cfg["cyl_height"], eps_p, eps_g, lam,
            torch.as_tensor(call["ux"][sl], **kw),
            torch.as_tensor(call["uy"][sl], **kw), c, nv=cfg["nv"],
            prec=prec)
        res.append((sl, bf.transpose(1, 2), br.transpose(1, 2), Kx, Ky,
                    eps_g))
    return res


def _gaps(af, ar, min_kz, ref_out):
    gaps = []
    for sl, bf, br, Kx, Ky, eps_g in ref_out:
        mf = propagating(Kx, Ky, eps_g, min_kz)[:, None, :]
        mr = propagating(Kx, Ky, 1.0, min_kz)[:, None, :]
        gf = ((af[sl].to(bf.device, bf.dtype) - bf).abs() * mf).amax((1, 2))
        gr = ((ar[sl].to(br.device, br.dtype) - br).abs() * mr).amax((1, 2))
        gaps.append(torch.maximum(gf, gr).nan_to_num(nan=float("inf")).cpu())
    return torch.cat(gaps)


def compare(cfg, calls, kept, min_kz):
    """Largest amplitude gap of the kept calls' gathered outputs against
    the reference in complex128, and each cell's gap."""
    per = []
    for k, af, ar in kept:
        dev = af.device
        per.append(_gaps(af, ar, min_kz,
                         _reference(cfg, calls[k], device=dev)))
    per = torch.cat(per) if per else torch.zeros(0)
    return (float(per.max()) if len(per) else float("inf")), per


def control_err(cfg, calls, kept, min_kz):
    """The control: the reference in the program's place one precision step
    below complex64 (TF32 operands), held to the same check."""
    worst = 0.0
    for k, af, _ in kept:
        dev = af.device
        low = _reference(cfg, calls[k], prec=ref.Precision("tf32"),
                         dtype=torch.float32, device=dev)
        cf = torch.cat([bf for _, bf, _, _, _, _ in low])
        cr = torch.cat([br for _, _, br, _, _, _ in low])
        g = _gaps(cf, cr, min_kz, _reference(cfg, calls[k], device=dev))
        worst = max(worst, float(g.max()))
    return worst
