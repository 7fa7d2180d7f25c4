#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (metalens_tpu_torch) on one NVIDIA GPU.

Builds the port's hand-written CUDA kernels from ``metalens_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card at the inputs the
main path gives it, drives the main path -- the unit-cell RCWA solve at the
bench cell (numG = 50, NV on, B = 1024 cells, complex64) and the FOM entry
points -- and checks the results against the committed float64 truth, the
path with the plain versions in place of the kernels, and CPU complex128
runs.  It times each kernel against its plain version (for the inverse,
``torch.linalg.inv``: the library call) in turns, at every size the main
path gives it at numG = 50 and numG = 100, beside the least time the card
could take for the same work (its bound).  It also times the path with the
kernels against the path with the plain versions, in turns, at both numG,
and prints the torch.profiler device time by kernel of each.  Phase 6 drives
the design loop: the kernels' backward passes against autograd through the
plain versions, ``fom_value_and_grad`` on the card against the CPU in
complex128 (launches counted, timed, profiled forward and backward),
``optimize_gradient`` for 20 steps and one ``vary_angle`` member.  Phase 7
drives the amplitude databases at characterize's own width (numG = 100,
n = 200): a 4-member ``GratingCollection`` at u_steps = 5, 580 nm and then a
joint 450/650 nm sweep, and a 20-entry ``HexGridSet``; it holds entries to
the CPU in complex128, the kernels to their plain versions on the
characterize path's own inputs, and the interpolators on the card to tables
built on the CPU, and it counts, times and profiles the member sweeps.
Phase 8 drives the lens check: ``benchmarks/run_configs.py`` config 5 on
the card and on the CPU in complex128, held to the JAX package's committed
values, then ``benchmarks/northstar2.py``'s 0.5 mm collimator at 580 nm
(databases at numG = 100, ``make_design``, the stitch at 1944 x 1944
points, the far field, the focal metrics), with near-field slabs and the
far field held to CPU complex128, the kernels held to their plain versions
on the lens's characterize inputs, and the stages timed and profiled.

    python3 chip_smoke.py

Every phase is fatal: a failed check exits nonzero.  The last two lines of
standard output are a JSON object describing each kernel (launches in the
counted runs of the main path at numG = 50 and numG = 100, of one
``fom_value_and_grad`` call and of the characterize sweeps, summed and per
path, with the inverse's per route; error against the plain version;
times and bound at the main path's bench size, and the same per size
under ``sizes``) and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits nonzero
before printing any result.  Imports nothing of JAX.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NM = 1e-9
LX, LY, LAM, H = 1200 * NM, 320 * NM, 580 * NM, 550 * NM
NT, NG = 2.372, 1.459
BASE = np.array([[-215 * NM, 2 * NM, 144 * NM, 111 * NM, 0.0],
                 [196 * NM, -8 * NM, 100 * NM, 130 * NM, 0.1]])
TOL_GUARD = 2e-3      # bench.py's accuracy-guard bound vs the f64 truth
TOL_INV = 1e-4        # inverse kernel vs plain, per matrix, max-normalized
TOL_TAYLOR = 2e-5     # the bound of tests/test_pallas_taylor.py
TOL_FOM = 1e-5        # fom_value_and_grad: |fom| on CUDA vs CPU complex128
TOL_GRAD = 2e-3       # and the relative norm of the gradient's difference
# the design loop's cell: the bench cell's periods and height, two rotated
# pillars inside the fabrication constraints (validate), in nm and degrees
DESIGN_NM_DEG = [[-215., 2., 144., 105., 0.], [196., -8., 100., 102., 6.]]
BATCH = 1024
CHAR_NUMG = 100       # characterize's own default (metalens_tpu/grating.py)
HEX_ENTRIES = 20      # benchmarks/run_configs.py config 1 at full scale
TOL_INTERP = 1e-5     # interpolators on the card vs complex128, of table max
AMPS = ("ampfy", "ampfx", "ampry", "amprx")
# The lens check's anchor: benchmarks/run_configs.py config 5 at --scale
# small, through the JAX package on the CPU in float32 (JAX_PLATFORMS=cpu,
# jax_enable_x64 off), printed by
#     python benchmarks/run_configs.py --config 5
CONFIG5_JAX = {"transmission": 0.9157, "spot_fraction_of_total": 0.6281}
TOL_CONFIG5 = 1e-3
TOL_NEARFIELD = 2e-3  # stitch on the card vs CPU complex128, of field max
TOL_FARFIELD = 1e-4   # far field on the card vs CPU complex128
# benchmarks/northstar2.py's production lens at 580 nm: a 0.5 mm aperture,
# the source 150 um away, four angle brackets in degrees
NS_RADIUS, NS_SOURCE = 250e-6, 150e-6
NS_BRACKETS = ((20.0, 27.0), (27.0, 37.0), (37.0, 48.0), (48.0, 59.5))
NS_HEX_ENTRIES = 16
PEAK_F32 = 67e12          # flop/s, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops, nbytes):
    """The least time the card could take for the work: the larger of the
    flops at the f32 peak outside the tensor cores and the bytes at the
    memory rate (H100 SXM at 700 W), and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_F32, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, iters):
    """Mean device time of fn over iters calls (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(plain, kernel, iters):
    """Plain and kernel times measured in turns (plain, kernel, kernel,
    plain) on one card; returns the mean of each."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def batch_ms(fn, windows=3, per_window=2):
    """Wall time per batch of fn on the host clock, work ending in
    torch.cuda.synchronize(): best of ``windows`` windows of
    ``per_window`` calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(per_window):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / per_window)
    return best * 1e3


def rel_err(got, want):
    """Worst per-matrix max-normalized error over a batch (B, n, n), and
    the batch index where it occurs."""
    per = ((got - want).abs().amax((-2, -1))
           / want.abs().amax((-2, -1)))
    i = int(per.argmax())
    return float(per[i]), i


def incidence(orders, numG):
    from metalens_tpu_torch.solver import orders as ordmod
    i0 = ordmod.order_index(orders, 0, 0)
    c = np.zeros((2 * numG, 2))
    c[i0, 0] = c[i0 + numG, 1] = 1.0
    return c


def capture(module, name, run):
    """Record the arguments of every call of module.name during run() (the
    hot-path capture pattern of tests/test_pallas_inv.py)."""
    seen = []
    orig = getattr(module, name)

    def spy(*args):
        seen.append(args)
        return orig(*args)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return seen


@contextlib.contextmanager
def plain_versions(inverse=True, taylor_factors=True):
    """Route the path's inverses and/or Taylor factors to the plain PyTorch
    versions, for the end-to-end comparison with the kernels."""
    from metalens_tpu_torch.solver import inv, taylor
    saved = inv.inv, taylor.taylor_factors
    if inverse:
        inv.inv = inv.inv_reference
    if taylor_factors:
        taylor.taylor_factors = taylor.taylor_factors_reference
    try:
        yield
    finally:
        inv.inv, taylor.taylor_factors = saved


def profile(fn, label, rows=10, wall_ms=None):
    """One call of fn under torch.profiler: total self device time and the
    kernels that take most of it; with ``wall_ms`` (the call's time without
    the profiler), the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: a host op's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events) / 1e3
    idle = ("" if wall_ms is None else
            f"; against {wall_ms:.3f} ms of wall per call the device idles "
            f"{100 * (1 - total / wall_ms):.1f}%")
    print(f"profile {label}: self device time {total:.3f} ms, "
          f"wall {wall:.3f} ms under the profiler{idle}")
    for e in sorted(events, key=dev_us, reverse=True)[:rows]:
        print(f"profile {label}:   {dev_us(e) / 1e3:9.3f} ms "
              f"{e.count:5d} calls  {e.key[:80]}")


def profile_split(fn, label, wall_ms, rows=6):
    """One call of fn (a forward and a backward pass) under torch.profiler:
    device time by kernel, split into the kernels launched by forward ops
    and by backward ops (those under an
    ``autograd::engine::evaluate_function`` or a backward function's
    event), and the device's idle
    share against ``wall_ms``, the call's time without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device_total = sum(e.self_device_time_total for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    parts = {"forward": {}, "backward": {}}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        p = e      # scope 1: a backward function's record scope
        while p is not None and not (p.scope == 1 or p.name.startswith(
                "autograd::engine::evaluate_function")):
            p = p.cpu_parent
        part = parts["forward" if p is None else "backward"]
        for k in e.kernels:
            n_calls, us = part.get(k.name, (0, 0.0))
            part[k.name] = (n_calls + 1, us + k.duration)
    split = {name: sum(us for _, us in part.values()) / 1e3
             for name, part in parts.items()}
    ops = {name: sum(n for n, _ in part.values())
           for name, part in parts.items()}
    print(f"profile {label}: device time {device_total / 1e3:.3f} ms "
          f"(forward {split['forward']:.3f} ms in {ops['forward']} device "
          f"operations, backward {split['backward']:.3f} ms in "
          f"{ops['backward']}, unattributed "
          f"{device_total / 1e3 - sum(split.values()):.3f} ms); against "
          f"{wall_ms:.3f} ms of wall per call the device idles "
          f"{100 * (1 - device_total / 1e3 / wall_ms):.1f}%")
    for name, part in parts.items():
        for k, (n_calls, us) in sorted(part.items(), key=lambda kv: -kv[1][1]
                                       )[:rows]:
            print(f"profile {label} {name}: {us / 1e3:9.3f} ms "
                  f"{n_calls:5d} calls  {k[:80]}")
    return device_total / 1e3, split


@contextlib.contextmanager
def cpu_threads(n):
    """torch's CPU thread count set to n for the block: CPU work at n = 200
    runs single-threaded (some CPU builds of torch hang in a multi-threaded
    batched inverse of that size)."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _entry_key(e):
    return (e["wavelength_in_nm"], e["x_or_y"], e["ux"], e["uy"], e["ox"],
            e["oy"])


def db_err(got, want):
    """Largest amplitude difference between the entries of ``want`` and
    the entries of ``got`` with the same key; every key of ``want`` must be
    in ``got``."""
    index = {_entry_key(e): e for e in got}
    worst = 0.0
    for e in want:
        g = index.get(_entry_key(e))
        require(g is not None, f"entry {_entry_key(e)} missing from the "
                f"card's database")
        worst = max(worst, max(abs(g[k] - e[k]) for k in AMPS))
    return worst


def taylor_work(n, B, n_terms):
    """Flops and bytes of one Taylor call (B matrices of n x n, n_terms
    terms): the products of the launch plan (8 n^3 flops each), the
    coefficient x power terms of the chunks (4 flops an entry) and the
    Horner epilogue adds (2 flops an entry); F and G read, the four factors
    written, and the coefficient table.  Also the count of products (GEMM
    launches) and of coefficient x power terms."""
    from metalens_tpu_torch.solver import taylor
    s, r = taylor._ps_split(n_terms)
    products = 1 + (s - 1) + 3 * (r - 1) + 4
    power_terms = sum(1 for p in range(3) for k in range(n_terms + 1)
                      if k % s)
    flops = (products * 8 * n ** 3
             + (4 * power_terms + 2 * 3 * (r - 1)) * n * n) * B
    nbytes = 6 * 8 * n * n * B + B * 3 * (n_terms + 1) * 4
    return flops, nbytes, products, power_terms


def sweep_launches(glist, lams):
    """Kernel launches of one characterize sweep per member of ``glist``:
    per wavelength <<1/eps>>^-1, one batch of E^-1 at N; at 2N the slab,
    each doubling, the inner and the outer star; one Taylor call."""
    import torch
    from metalens_tpu_torch.engine import static_solve_config
    out = {"cinv": 0, "taylor": 0, "taylor_chunks": 0}
    for g in glist:
        _, ns, nt, _ = static_solve_config(g, lams, CHAR_NUMG,
                                           torch.complex64)
        out["cinv"] += len(lams) + 1 + 3 + int(math.log2(ns))
        out["taylor"] += taylor_work(2 * CHAR_NUMG, 1, nt)[2]
        out["taylor_chunks"] += 1
    return out


def collection_sweep(gc, u_steps, numG):
    """The direction sweep of GratingCollection.characterize: the family's
    angle range +-0.25 in ux, uy in [-0.2, 0.2]."""
    wl = gc.target_wavelength
    return dict(ux_min=max(-0.99, gc.get_innermost().get_angle_in_air(wl)
                           - 0.25),
                ux_max=min(0.99, gc.get_outermost().get_angle_in_air(wl)
                           + 0.25),
                uy_min=-0.2, uy_max=0.2, u_steps=u_steps, numG=numG)


def interp_errors(tables, tables_cpu, pts, by_key):
    """Worst error of the card's interpolators (complex64) at ``pts``
    against the same tables built on the CPU in complex128, and at the
    grid nodes against the stored entries (``by_key``: key -> rows of
    (ux, uy, third axis, amplitude)), each as a share of the table's
    largest entry."""
    import torch
    rand = node = 0.0
    for key, f in tables.items():
        require(f.values.is_cuda and f.values.dtype == torch.complex64,
                f"interpolator {key}: {f.values.device} {f.values.dtype}")
        ref = tables_cpu[key]
        scale = float(ref.values.abs().max()) or 1.0
        rand = max(rand, float(np.abs(f(pts) - ref(pts)).max()) / scale)
        if key not in by_key:     # an order kept at no direction
            require(not bool(f.values.abs().max() > 0), f"table {key}")
            continue
        rows = np.array(by_key[key])
        node = max(node, float(np.abs(f(rows[:, :3].real) - rows[:, 3]).max())
                   / scale)
    return rand, node


def kernels_at_inputs(dev, results, inv_caps, tay_caps, path, label):
    """Hold the kernels to their plain versions on captured inputs of a
    path (inverse batches; Taylor calls as (F, G, t, terms)), then time
    each size in turns against the plain version beside its bound and add
    it to ``results``' sizes.  Returns the worst per-matrix inverse error,
    the worst max-normalized Taylor error and the distinct values of t in
    each Taylor batch."""
    import torch
    from metalens_tpu_torch.solver import inv, taylor
    worst = 0.0
    for A in inv_caps:
        W, R = inv.inv_cuda(A), inv.inv_reference(A)
        worst = max(worst, rel_err(W, R)[0])
        results["cinv"]["max_abs_err"] = max(results["cinv"]["max_abs_err"],
                                             (W - R).abs().max().item())
    tay_worst = 0.0
    t_values = []
    for F, Gm, t, k in tay_caps:
        t_values.append(len(set(torch.as_tensor(t).flatten().tolist())))
        for a, b in zip(taylor.taylor_factors(F, Gm, t, k),
                        taylor.taylor_factors_reference(F, Gm, t, k)):
            tay_worst = max(tay_worst, ((a - b).abs().max()
                                        / b.abs().max()).item())
            results["taylor"]["max_abs_err"] = max(
                results["taylor"]["max_abs_err"], (a - b).abs().max().item())
    print(f"{label} kernels at the {path} inputs: {len(inv_caps)} "
          f"inverse batches (n, B: "
          f"{sorted({(A.shape[-1], A.shape[0]) for A in inv_caps})}) worst "
          f"rel err vs plain {worst:.3e} (bound {TOL_INV}); Taylor batches "
          f"B={[c[0].shape[0] for c in tay_caps]} with {t_values} distinct t,"
          f" max-normalized err {tay_worst:.3e} (bound {TOL_TAYLOR})")
    require(worst <= TOL_INV and tay_worst <= TOL_TAYLOR,
            f"kernels at the {path} inputs: {worst}, {tay_worst}")
    # times in turns against the plain versions, beside the bound, at every
    # size of the path
    timed = set()
    for A in inv_caps:
        n, B = A.shape[-1], A.shape[0]
        if (n, B) in timed:
            continue
        timed.add((n, B))
        k_ms, p_ms = ab_ms(lambda: inv.inv_reference(A),
                           lambda: inv.inv_cuda(A), 20)
        b_ms, b_by = bound_ms(8 * n ** 3 * B, 2 * 8 * n * n * B)
        results["cinv"]["sizes"].append(dict(
            path=path, numG=CHAR_NUMG, n=n, B=B, ms=k_ms, plain_ms=p_ms,
            library_ms=p_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"{label} time inverse n={n} B={B}: kernel {k_ms:.4f} ms, "
              f"torch.linalg.inv {p_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})")
    for F, Gm, t, k in tay_caps:
        n, B = F.shape[-1], F.shape[0]
        coeffs = taylor.coeff_table(t, k, B, dev)
        td = torch.as_tensor(t).to(dev) if torch.is_tensor(t) else t
        k_ms, p_ms = ab_ms(
            lambda: taylor.taylor_factors_reference(F, Gm, td, k),
            lambda: taylor.taylor_factors_cuda(F, Gm, coeffs, k), 10)
        flops, nbytes, products, _ = taylor_work(n, B, k)
        b_ms, b_by = bound_ms(flops, nbytes)
        results["taylor"]["sizes"].append(dict(
            path=path, n=n, B=B, terms=k,
            distinct_t=len(set(torch.as_tensor(t).flatten().tolist())),
            ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
            bound_by=b_by))
        print(f"{label} time Taylor n={n} B={B} terms={k}: kernels "
              f"{k_ms:.4f} ms ({products} GEMM launches + 1 chunk pass), "
              f"plain {p_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})")
    return worst, tay_worst, t_values


def characterize_phase(dev, gd, results, path_launches, reset_counts,
                       launch_counts):
    """Phase 7: the amplitude databases on the card at numG = 100."""
    import torch
    from metalens_tpu_torch import (GratingCollection, HexGridSet, resize,
                                    validate)
    from metalens_tpu_torch.characterize import (
        build_collection_interpolators, build_hexgrid_interpolators)
    from metalens_tpu_torch.engine import (_direction_grid,
                                           characterize_grating)
    from metalens_tpu_torch.grating import Grating
    from metalens_tpu_torch.solver import inv, taylor
    t7 = time.perf_counter()
    rgb = [450 * NM, 650 * NM]

    # 7.1: a 4-member collection from the design cell at distinct periods
    members = [resize(gd, Grating(lateral_period=LY, grating_period=LX * f,
                                  cyl_height=H))
               for f in (1.0, 0.97, 0.94, 0.91)]
    gc = GratingCollection(LAM, LY, "cyl", members)
    periods = [g.grating_period for g in gc.grating_list]
    require(len(set(periods)) == 4 and all(validate(g) for g in members),
            f"collection members: periods {periods}")
    sweep = collection_sweep(gc, 5, CHAR_NUMG)
    ux_grid, uy_grid = _direction_grid(sweep["ux_min"], sweep["ux_max"],
                                       -0.2, 0.2, 5)
    n_dir = len(ux_grid)

    sweeps = {}
    for label, run, glist, lams, cells in (
            ("characterize", lambda: gc.characterize(
                LAM, numG=CHAR_NUMG, u_steps=5), members, [LAM], n_dir),
            ("characterize 450+650 nm", lambda: gc.characterize(
                rgb, numG=CHAR_NUMG, u_steps=5, append=True), members, rgb,
             2 * n_dir)):
        reset_counts()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = launch_counts()
        want = sweep_launches(glist, lams)
        path_launches[label] = c
        results["cinv"]["route_launches_by_path"][label] = dict(
            inv.route_launches)
        sweeps[label] = wall
        print(f"phase 7 {label} numG={CHAR_NUMG} u_steps=5 ({n_dir} "
              f"directions, B={cells} per member): {len(glist)} members in "
              f"{wall:.3f} s, {wall / len(glist) * 1e3:.1f} ms per member "
              f"sweep, {len(glist) * cells / wall:.1f} cells/s; launches "
              f"{c} (expected {want}), per member sweep "
              f"{ {k: v / len(glist) for k, v in c.items()} }")
        require(all(v > 0 for v in c.values()) and c == want,
                f"{label}: launches {c}, expected {want}")
    for g in gc.grating_list:
        lam_set = {e["wavelength_in_nm"] for e in g.data}
        finite = all(np.isfinite(e[k]) for e in g.data for k in AMPS)
        require(lam_set == {450.0, 580.0, 650.0} and finite,
                f"database of {g.grating_period / NM:.1f} nm: wavelengths "
                f"{lam_set}, finite {finite}")
        for lam in (450.0, 580.0, 650.0):
            dirs = {(e["ux"], e["uy"]) for e in g.data
                    if e["wavelength_in_nm"] == lam}
            require(len(dirs) == n_dir, f"{lam} nm: {len(dirs)} directions")
    m0 = gc.grating_list[0]
    one = dict(sweep, wavelength=LAM)
    ms = batch_ms(lambda: characterize_grating(m0, **one))
    print(f"phase 7 one member sweep at 580 nm (B={n_dir}, "
          f"n={2 * CHAR_NUMG}): {ms:.3f} ms ({n_dir / ms * 1e3:.1f} "
          f"cells/s; best of 3 windows of 2 calls)")
    profile_split(lambda: characterize_grating(m0, **one),
                  f"characterize member sweep B={n_dir}", ms)

    # 7.2: the 20-entry HexGridSet, one member sweep (B = 1) per entry
    hgs = HexGridSet(sep=320 * NM, cyl_height=550 * NM,
                     num_entries=HEX_ENTRIES)
    reset_counts()
    t0 = time.perf_counter()
    hgs.characterize(wavelength=LAM, numG=CHAR_NUMG, just_normal=True)
    torch.cuda.synchronize()
    hex_s = time.perf_counter() - t0
    c = launch_counts()
    want = sweep_launches(hgs.grating_list, [LAM])
    path_launches["characterize hexgrid"] = c
    results["cinv"]["route_launches_by_path"]["characterize hexgrid"] = dict(
        inv.route_launches)
    require(all(v > 0 for v in c.values()) and c == want,
            f"HexGridSet launches {c}, expected {want}")
    xa = hgs.x_amp_list
    require(xa.shape == (HEX_ENTRIES,) and bool(np.isfinite(xa).all()),
            f"x_amp_list {xa.shape}")
    span = float(abs(np.unwrap(np.angle(xa))[-1] - np.angle(xa[0])))
    print(f"phase 7 HexGridSet {HEX_ENTRIES} entries numG={CHAR_NUMG} "
          f"just_normal: {hex_s:.3f} s in all, {hex_s / HEX_ENTRIES * 1e3:.1f}"
          f" ms per member sweep (B=1); launches {c} (expected {want}); "
          f"|x_amp| {np.abs(xa).min():.4f}..{np.abs(xa).max():.4f}, phase "
          f"span {span:.3f} rad")
    h0 = hgs.grating_list[0]
    hex_one = dict(ux_min=0.001, ux_max=0.001, uy_min=0.001, uy_max=0.001,
                   u_steps=1, wavelength=LAM, numG=CHAR_NUMG,
                   just_normal=True)
    ms1 = batch_ms(lambda: characterize_grating(h0, **hex_one))
    print(f"phase 7 one HexGridSet member sweep (B=1, n={2 * CHAR_NUMG}): "
          f"{ms1:.3f} ms")
    profile_split(lambda: characterize_grating(h0, **hex_one),
                  "characterize hexgrid member sweep B=1", ms1)

    # 7.3: entries against the CPU in complex128: one member at every
    # direction at 580 nm, three directions of the joint sweep, and the
    # first and last HexGridSet entries
    t0 = time.perf_counter()
    with cpu_threads(1):
        ref = characterize_grating(m0, **one, device="cpu")
        err_dir = db_err(m0.data, ref)
        require(len(ref) == sum(1 for e in m0.data
                                if e["wavelength_in_nm"] == 580.0),
                "the CPU sweep kept other orders than the card's")
        err_rgb = 0.0
        picks = sorted({0, n_dir // 2, n_dir - 1})
        for b in picks:
            err_rgb = max(err_rgb, db_err(m0.data, characterize_grating(
                m0, ux_grid[b], ux_grid[b], uy_grid[b], uy_grid[b], 1, rgb,
                CHAR_NUMG, device="cpu")))
        ends = (hgs.grating_list[0], hgs.grating_list[-1])
        err_hex = max(db_err(g.data, characterize_grating(
            g, **hex_one, device="cpu")) for g in ends)
        # the same two entries with the second pillar 1.5 nm off its
        # hexagonal site, so that no raster point of the NV normal field
        # lies on the bisector between the pillars
        err_off = 0.0
        for g in ends:
            g = g.copy()
            g.xyrra_list[1, :2] += [1.3 * NM, -0.7 * NM]
            err_off = max(err_off, db_err(
                characterize_grating(g, **hex_one),
                characterize_grating(g, **hex_one, device="cpu")))
    print(f"phase 7 vs CPU complex128 ({time.perf_counter() - t0:.1f} s, one "
          f"thread): member {m0.grating_period / NM:.1f} nm all {n_dir} "
          f"directions at 580 nm max err {err_dir:.3e}; {len(picks)} "
          f"directions x 2 wavelengths of the joint sweep {err_rgb:.3e}; "
          f"HexGridSet entries 1 and {HEX_ENTRIES} {err_hex:.3e}, the same "
          f"with the second pillar 1.5 nm off its site {err_off:.3e} (bound "
          f"{TOL_GUARD})")
    require(max(err_dir, err_rgb, err_hex, err_off) <= TOL_GUARD,
            f"characterize vs CPU: {err_dir}, {err_rgb}, {err_hex}, "
            f"{err_off}")

    # 7.4: the kernels at the characterize path's own inputs: the joint
    # sweep of one member (t takes two values along the Taylor batch), a
    # three-wavelength cell (t takes three) and a HexGridSet member (B = 1)
    joint = dict(sweep, wavelength=rgb)
    three = (ux_grid[0], ux_grid[0], uy_grid[0], uy_grid[0], 1,
             [450 * NM, LAM, 650 * NM], CHAR_NUMG)
    inv_caps = [a for run in (lambda: characterize_grating(m0, **joint),
                              lambda: characterize_grating(h0, **hex_one))
                for (a,) in capture(inv, "inv", run)]
    tay_caps = [c for run in (lambda: characterize_grating(m0, **joint),
                              lambda: characterize_grating(m0, *three),
                              lambda: characterize_grating(h0, **hex_one))
                for c in capture(taylor, "taylor_factors", run)]
    _, _, t_values = kernels_at_inputs(
        dev, results, inv_caps, tay_caps, "characterize", "phase 7")
    require(t_values == [2, 3, 1], f"distinct t per Taylor batch {t_values}")
    del inv_caps, tay_caps

    # 7.5: the interpolators on the card against the CPU's complex128
    # tables, at 1,000 random in-bounds points and at the stored entries
    rng = np.random.default_rng(7)
    checks = {}
    for name, obj, build_cpu, amps, third in (
            ("collection", gc, build_collection_interpolators,
             ("ampfy", "ampfx"), lambda k, g: g.grating_period),
            ("hexgrid", hgs, build_hexgrid_interpolators, AMPS,
             lambda k, g: float(k))):
        t0 = time.perf_counter()
        tables = obj.build_interpolators()
        build_s = time.perf_counter() - t0
        tables_cpu, bounds = build_cpu(obj, device="cpu")
        require(obj.interpolator_bounds == bounds
                and list(tables) == list(tables_cpu),
                f"{name} interpolators: bounds or keys differ from the CPU's")
        lo, hi = np.array(bounds[0::2]), np.array(bounds[1::2])
        pts = lo + rng.random((1000, 3)) * (hi - lo)
        by_key = {}
        for k, g in enumerate(obj.grating_list):
            for e in g.data:
                for amp in amps:
                    by_key.setdefault(
                        (round(e["wavelength_in_nm"]), (e["ox"], e["oy"]),
                         e["x_or_y"], amp), []).append(
                        (e["ux"], e["uy"], third(k, g), e[amp]))
        rand, node = interp_errors(tables, tables_cpu, pts, by_key)
        checks[name] = rand, node
        print(f"phase 7 {name} interpolators: {len(tables)} tables on the "
              f"card built in {build_s:.3f} s; 1000 random in-bounds points "
              f"vs complex128 tables max err {rand:.3e} of the table's max "
              f"(bound {TOL_INTERP}); stored entries at the nodes "
              f"{node:.3e} (bound {np.finfo(np.float32).eps:.3e})")
        require(rand <= TOL_INTERP and node <= np.finfo(np.float32).eps,
                f"{name} interpolators: {rand}, {node}")
    chosen = [hgs.pick_from_phase(p) for p in np.linspace(-np.pi, np.pi, 721)]
    require(all(isinstance(i, int) and 0 <= i < HEX_ENTRIES for i in chosen),
            "pick_from_phase outside the set")
    print(f"phase 7 pick_from_phase over 721 phases: {len(set(chosen))} "
          f"distinct members picked, every pick in range")
    print(f"phase 7 characterize: {time.perf_counter() - t7:.2f} s")


def round_collection(lo_deg, hi_deg, n_members=3):
    """``tests/test_full_lens.py::make_round_collection`` in the port: a
    round-lens collection over [lo, hi] degrees of simple, unoptimized
    two-pillar cells."""
    from metalens_tpu_torch import Grating, GratingCollection
    angles = np.linspace(lo_deg, hi_deg, n_members) * math.pi / 180
    lp_over_tan = 320 * NM / math.tan(angles[len(angles) // 2])
    gs = []
    for ang in angles:
        gp = LAM / math.sin(ang)
        frac = (ang - angles[0]) / (angles[-1] - angles[0] + 1e-12)
        gs.append(Grating(
            lateral_period=lp_over_tan * math.tan(ang), cyl_height=H,
            grating_period=gp, xyrra_list_in_nm_deg=np.array(
                [[-gp / NM / 4, 0.0, 90.0 + 5 * frac, 70.0, 0.0],
                 [gp / NM / 4, 0.0, 70.0, 80.0 + 5 * frac, 0.0]])))
    return GratingCollection(target_wavelength=LAM,
                             lateral_period=lp_over_tan, lens_type="round",
                             grating_list=gs)


@contextlib.contextmanager
def stage(times, name):
    """Time the block by CUDA events on the current stream and by the host
    clock (the block's work ends in a synchronize); store both in ms."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    yield
    end.record()
    torch.cuda.synchronize()
    times[name] = (start.elapsed_time(end), (time.perf_counter() - t0) * 1e3)


def lens_metrics(nf, ff, lps, lcs, hgs, d, half, spot_u, device="cuda"):
    """The lens check of benchmarks/run_configs.py config 5 and
    northstar2.py: an 'x' dipole at (0, 0, -d), the aperture
    [-half, half]^2 at good_fft_number points per side, the stitch, the far
    field and the focal metrics."""
    from metalens_tpu_torch.geometry import good_fft_number
    pts = np.linspace(-half, half, good_fft_number(2 * half / (LAM / 2.2)))
    out = nf.build_nearfield(0.0, 0.0, -d, "x", LAM, lps, lcs, hgs, pts, pts,
                             dipole_moment=1e-30, device=device)
    far = ff.farfield(*out[:4], pts, pts, LAM, out[7], device=device)
    P, tot, ux, uy, dux, duy = far
    return out, far, ff.focal_metrics(P, ux, uy, dux, duy, tot, out[6],
                                      spot_radius_u=spot_u)


def classification(nf, lps, lcs, hgs, d, xs, ys, device):
    """The stitch's point classification on ``device``: collection index,
    centre flag, the grating copy's rotation (cos) and the centre site."""
    import torch
    X, Y = (p.contiguous() for p in torch.meshgrid(
        torch.as_tensor(xs, device=device), torch.as_tensor(ys, device=device),
        indexing="ij"))
    planes = nf._geometry_planes(
        X, Y, *nf._ring_tables(lps, device), lps["r_max_list"][-1], 0.0, 0.0,
        -d, 2 * math.pi / LAM, [1, 0, 0], 1.0, 1e-30, True, False,
        torch.complex64)
    table, n1, n2 = nf._hex_site_table(lcs, hgs.sep, device)
    rows, _ = nf._nearest_center_site(
        X, Y, table, n1, n2, hgs.sep,
        torch.as_tensor(lcs[:, 0:2], device=device))
    return [planes[0].cpu(), planes[1].cpu(), planes[8].cpu(), rows.cpu()]


def lens_phase(dev, results, path_launches, reset_counts, launch_counts):
    """Phase 8: the lens check on the card -- characterized databases,
    assembly, the near-field stitch, the far field and the focal metrics."""
    import importlib
    import torch
    from metalens_tpu_torch import HexGridSet
    from metalens_tpu_torch.assembly import make_design
    from metalens_tpu_torch.engine import characterize_grating
    from metalens_tpu_torch.solver import inv, taylor
    nf = importlib.import_module("metalens_tpu_torch.nearfield")
    ff = importlib.import_module("metalens_tpu_torch.farfield")
    t8 = time.perf_counter()
    deg = math.pi / 180

    # 8a: benchmarks/run_configs.py config 5 at --scale small, on the card
    # and on the CPU in complex128 (the same calls with device="cpu")
    d, radius = 25e-6, 7.5e-6
    hi = math.atan(radius / d) + 1 * deg

    def config5(device):
        gc = round_collection(8.0, hi / deg)
        gc.characterize(LAM, numG=20, u_steps=3, device=device)
        gc.build_interpolators(device=device)
        hgs = HexGridSet(sep=320 * NM, cyl_height=H, num_entries=5)
        hgs.characterize(wavelength=LAM, numG=20, just_normal=False,
                         u_steps=3, device=device)
        hgs.build_interpolators(device=device)
        lps, lcs, _ = make_design([[(8.0 * deg, hi), gc]], d, radius, hgs)
        out, _, m = lens_metrics(nf, ff, lps, lcs, hgs, d, 1.05 * radius,
                                 0.15, device)
        return out[0], m
    got = {device: config5(device) for device in ("cuda", "cpu")}
    for device, dtype in (("cuda", torch.complex64),
                          ("cpu", torch.complex128)):
        f = got[device][0]
        require(f.device.type == device and f.dtype == dtype
                and f.shape == (60, 60), f"config 5 near field on {device}: "
                f"{f.device} {f.dtype} {tuple(f.shape)}")
    m, m_cpu = got["cuda"][1], got["cpu"][1]
    errs = {k: abs(m[k] - v) for k, v in CONFIG5_JAX.items()}
    errs_cpu = {k: abs(m[k] - m_cpu[k]) for k in CONFIG5_JAX}
    print(f"phase 8a config 5 (radius 7.5 um, source 25 um, numG=20, 60x60 "
          f"aperture) on the card: transmission {m['transmission']:.6f}, "
          f"spot fraction {m['spot_fraction_of_total']:.6f}, peak "
          f"({m['peak_ux']:.4f}, {m['peak_uy']:.4f}); JAX package on the "
          f"CPU (float32) {CONFIG5_JAX}: |diff| "
          f"{ {k: float(f'{e:.3e}') for k, e in errs.items()} } (bound "
          f"{TOL_CONFIG5}); the port on the CPU in complex128: transmission "
          f"{m_cpu['transmission']:.7f}, spot fraction "
          f"{m_cpu['spot_fraction_of_total']:.7f}, |card - CPU| "
          f"{ {k: float(f'{e:.3e}') for k, e in errs_cpu.items()} }")
    require(max(errs.values()) <= TOL_CONFIG5
            and max(errs_cpu.values()) <= TOL_CONFIG5,
            f"config 5 vs JAX: {errs}; card vs CPU: {errs_cpu}")
    del got

    # 8b: the production lens of benchmarks/northstar2.py at 580 nm, with
    # unoptimized make_round_collection cells in its four brackets
    d, radius = NS_SOURCE, NS_RADIUS
    gcs = [round_collection(lo, hi) for lo, hi in NS_BRACKETS]
    hgs = HexGridSet(sep=320 * NM, cyl_height=H, num_entries=NS_HEX_ENTRIES)
    times = {}
    members = [g for gc in gcs for g in gc.grating_list]
    want = sweep_launches(members + hgs.grating_list, [LAM])
    reset_counts()
    with stage(times, "characterize 4 collections"):
        for gc in gcs:
            gc.characterize(LAM, numG=CHAR_NUMG, u_steps=5)
    with stage(times, "characterize HexGridSet"):
        hgs.characterize(wavelength=LAM, numG=CHAR_NUMG, just_normal=False,
                         u_steps=5)
    c = launch_counts()
    path_launches["characterize lens"] = c
    results["cinv"]["route_launches_by_path"]["characterize lens"] = dict(
        inv.route_launches)
    batches = ([len({(e["ux"], e["uy"]) for e in g.data}) for g in members]
               + [len({(e["ux"], e["uy"]) for e in g.data})
                  for g in hgs.grating_list])
    print(f"phase 8b characterize lens numG={CHAR_NUMG} u_steps=5: "
          f"{len(members)} collection members (B={batches[:len(members)]}) "
          f"and {NS_HEX_ENTRIES} HexGridSet members (B={batches[-1]}); "
          f"launches {c} (expected {want})")
    require(all(v > 0 for v in c.values()) and c == want,
            f"characterize lens: launches {c}, expected {want}")
    with stage(times, "interpolators"):
        for obj in (*gcs, hgs):
            obj.build_interpolators()
    collections = [[(lo * deg, hi * deg), gc]
                   for (lo, hi), gc in zip(NS_BRACKETS, gcs)]
    with stage(times, "make_design"):
        lps, lcs, r_sw, xyrra = make_design(collections, d, radius, hgs,
                                            make_xyrra_list=True)
    torch.cuda.reset_peak_memory_stats()
    with stage(times, "stitch + far field + focal metrics"):
        out, far, m = lens_metrics(nf, ff, lps, lcs, hgs, d, 1.02 * radius,
                                   0.1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    pts = out[4]
    P, tot, ux, uy, dux, duy = far
    n = len(pts)
    print(f"phase 8b design: {len(xyrra)} pillars, "
          f"{len(lps['r_center_list'])} rings, {len(lcs)} centre sites, "
          f"r_switch {r_sw * 1e6:.2f} um; aperture {n} x {n} = {n * n} "
          f"points; peak device memory {peak_gib:.2f} GiB")
    print(f"phase 8b focal metrics: transmission {m['transmission']:.6f}, "
          f"spot fraction (0.1) {m['spot_fraction_of_total']:.6f}, peak "
          f"({m['peak_ux']:.5f}, {m['peak_uy']:.5f}), total_P {tot:.6e}, "
          f"power through the lens {out[6]:.6e}")
    require(all(f.is_cuda and f.dtype == torch.complex64
                and f.shape == (n, n) and bool(torch.isfinite(f).all())
                for f in out[:4]), "8b near field: device, dtype, shape or "
            "non-finite values")
    require(0 < m["transmission"] <= 1 and tot <= out[6]
            and abs(m["peak_ux"]) <= dux and abs(m["peak_uy"]) <= duy,
            f"8b physics: {m}, total_P {tot}, through the lens {out[6]}")

    # the stitch and the far field alone: CUDA events over repeated calls,
    # the host clock, and one torch.profiler breakdown of each
    def stitch():
        return nf.build_nearfield(0.0, 0.0, -d, "x", LAM, lps, lcs, hgs,
                                  pts, pts, dipole_moment=1e-30)

    def far_field():
        return ff.farfield(*out[:4], pts, pts, LAM, out[7])
    for name, fn, iters in (("stitch", stitch, 2),
                            ("far field", far_field, 5)):
        ev_ms = cuda_ms(fn, iters)
        wall = batch_ms(fn, windows=2, per_window=1)
        times[f"{name} (repeat)"] = (ev_ms, wall)
        profile(fn, f"8b {name} {n}x{n}", rows=12, wall_ms=wall)
    print(f"phase 8b stage times (CUDA events ms, host ms): "
          + "; ".join(f"{k} {a:.1f}, {b:.1f}" for k, (a, b) in times.items()))

    # the near field against CPU complex128 on three slabs of 8 columns:
    # the axis, the centre/periphery seam and the rim, from complex128
    # tables built on the CPU from the same database entries
    card_tables = [(obj, obj.interpolators) for obj in (*gcs, hgs)]
    for obj in (*gcs, hgs):
        obj.build_interpolators(device="cpu")
    fmax = [f.abs().max().item() for f in out[:4]]
    slab_err, n_class = {}, {}
    t0 = time.perf_counter()
    for name, y in (("axis", 0.0), ("seam", r_sw), ("rim", radius)):
        c0 = int(np.argmin(np.abs(pts - y))) - 4
        cols = slice(c0, c0 + 8)
        ref = nf.build_nearfield(0.0, 0.0, -d, "x", LAM, lps, lcs, hgs, pts,
                                 pts[cols], dipole_moment=1e-30,
                                 device="cpu")
        require(ref[0].dtype == torch.complex128, f"CPU slab {ref[0].dtype}")
        slab_err[name] = max(
            (f[:, cols].cpu().to(r.dtype) - r).abs().max().item() / fm
            for f, r, fm in zip(out[:4], ref[:4], fmax))
        cls = [classification(nf, lps, lcs, hgs, d, pts, pts[cols], dv)
               for dv in (dev, "cpu")]
        (g1, c1, r1, s1), (g2, c2, r2, s2) = cls
        n_class[name] = int(((g1 != g2) | (c1 != c2)
                             | ((r1 - r2).abs() > 1e-9)
                             | (c1 & (s1 != s2))).sum())
    for obj, tables in card_tables:
        obj.interpolators = tables
    slab_s = time.perf_counter() - t0
    print(f"phase 8b near field vs CPU complex128 ({slab_s:.1f} s), slabs "
          f"of 8 x {n} points, max |diff| over Ex, Ey, Hx, Hy "
          f"as a share of each field's max: "
          f"{ {k: float(f'{v:.3e}') for k, v in slab_err.items()} } (bound "
          f"{TOL_NEARFIELD}); points classified differently: {n_class}")
    require(max(slab_err.values()) <= TOL_NEARFIELD,
            f"8b near field vs CPU: {slab_err}")

    # the far field against farfield() in complex128 on the CPU, of the
    # card's near field copied to the host
    t0 = time.perf_counter()
    Pr, totr, *_ = ff.farfield(*(f.cpu() for f in out[:4]), pts, pts, LAM,
                               out[7], device="cpu")
    mr = ff.focal_metrics(Pr, ux, uy, dux, duy, totr, out[6],
                          spot_radius_u=0.1)
    Pc = P.cpu().double()
    fin = torch.isfinite(Pr)
    require(bool((torch.isfinite(Pc) == fin).all()),
            "8b far field: finite bins differ from the CPU's")
    far_err = {"P": ((Pc - Pr)[fin].abs().max() / Pr[fin].max()).item(),
               "total_P": abs(tot - totr) / totr}
    for k in ("transmission", "spot_fraction_of_total"):
        far_err[k] = abs(m[k] - mr[k]) / mr[k]
    print(f"phase 8b far field vs CPU complex128 "
          f"({time.perf_counter() - t0:.1f} s): relative errors "
          f"{ {k: float(f'{v:.3e}') for k, v in far_err.items()} } (bound "
          f"{TOL_FARFIELD}; P as a share of its max)")
    require(max(far_err.values()) <= TOL_FARFIELD,
            f"8b far field vs CPU: {far_err}")
    del out, far, P, Pr, Pc

    # the kernels at the lens-characterize inputs: one periphery member
    # sweep (B = 25 directions) and one HexGridSet member sweep (B = 81)
    peri = dict(collection_sweep(gcs[0], 5, CHAR_NUMG), wavelength=LAM)
    hexa = dict(ux_min=-0.499, ux_max=0.501, uy_min=-0.499, uy_max=0.501,
                u_steps=9, wavelength=LAM, numG=CHAR_NUMG)
    runs = (lambda: characterize_grating(gcs[0].grating_list[0], **peri),
            lambda: characterize_grating(hgs.grating_list[0], **hexa))
    inv_caps = [a for run in runs for (a,) in capture(inv, "inv", run)]
    tay_caps = [c for run in runs
                for c in capture(taylor, "taylor_factors", run)]
    kernels_at_inputs(dev, results, inv_caps, tay_caps, "characterize lens",
                      "phase 8b")
    print(f"phase 8 lens check: {time.perf_counter() - t8:.2f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from metalens_tpu_torch import _cuda
    from metalens_tpu_torch.engine import fom_batch_fn
    from metalens_tpu_torch.grating import Grating
    from metalens_tpu_torch.solver import inv, orders as ordmod, rcwa, taylor

    # float32 products in full float32: no TF32 anywhere on the path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    results = {}

    # ---- phase 1: build the kernels from the checkout's sources --------
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_cuda.build, ("cinv", "taylor")))
    _cuda.load("cinv", inv._SIGNATURES)
    _cuda.load("taylor", taylor._SIGNATURES)
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in _cuda.build_seconds.items())}"
          f"; nvcc {' '.join(_cuda.NVCC_FLAGS)})")

    rng = np.random.default_rng(0)
    xy_np = np.stack([BASE + rng.normal(scale=2 * NM, size=BASE.shape)
                      for _ in range(BATCH)]).astype(np.float32)
    xyrra = torch.as_tensor(xy_np, device=dev)
    ux = torch.linspace(0.35, 0.55, BATCH, dtype=torch.float32, device=dev)
    uy = torch.zeros(BATCH, dtype=torch.float32, device=dev)

    def path_at(numG, stride):
        """The main path at numG on every stride-th cell of the batch, and
        its float32 slab schedule."""
        o = ordmod.select_orders(LX, LY, numG)
        n_s, n_t = rcwa.slab_schedule(2 * np.pi * H / LAM, o, LX, LY, LAM,
                                      NT ** 2, dtype=torch.float32)
        xy, u, v = (x[::stride].contiguous() for x in (xyrra, ux, uy))
        c = torch.as_tensor(incidence(o, numG))

        def run():
            return rcwa.cell_amplitudes(o, xy, LX, LY, H, NT ** 2, NG ** 2,
                                        LAM, u, v, c, n_slabs=n_s,
                                        taylor_terms=n_t, fff=True)
        return run, o, n_s, n_t

    numG = 50
    main_path, orders, ns, terms = path_at(numG, 1)      # B = 1024, n = 100
    path100, _, ns100, terms100 = path_at(100, 4)        # B = 256, n = 200
    c_inc = torch.as_tensor(incidence(orders, numG))

    # ---- phase 2: inverse kernel vs inv_reference (complex64) ----------
    # random matrices at the main path's sizes and at the edges between the
    # routes (registers to n = 128, a 2-block cluster to 200, 4 blocks above)
    gen = torch.Generator(device="cpu").manual_seed(1)
    err_abs = 0.0
    for n in (50, 100, 128, 129, 200, 256):
        noise = torch.randn(64, n, n, 2, generator=gen)
        A = (torch.eye(n) + 0.4 * torch.view_as_complex(noise) / math.sqrt(n)
             ).to(torch.complex64).to(dev)
        W = inv.inv_cuda(A)
        torch.cuda.synchronize()
        eye = torch.eye(n, dtype=A.dtype, device=dev)
        resid = (W @ A - eye).abs().max().item()
        err_abs = max(err_abs, (W - inv.inv_reference(A)).abs().max().item())
        print(f"phase 2 random n={n} B=64: max|W A - I| = {resid:.3e}")
        require(resid <= 5e-5, f"inverse residual {resid} at n={n}")
    # every inverse the main path takes, at its own batch: per NV cell, E
    # and <<1/eps>> at N; the slab, each doubling, the inner and the outer
    # conversion star at 2N.  One batch of each size is timed against
    # torch.linalg.inv (the plain version, and the library call) in turns,
    # and the timed result is held to the plain version too.
    expected = 5 + int(math.log2(ns))
    worst = 0.0
    inv_sizes = []
    for label, run, n_s, stride, G in (("numG=50", main_path, ns, 1, 50),
                                       ("numG=100", path100, ns100, 4, 100)):
        caps = capture(inv, "inv", run)
        require(len(caps) == 5 + int(math.log2(n_s)),
                f"{label}: expected {5 + int(math.log2(n_s))} inverses per "
                f"NV cell, got {len(caps)}")
        for (A,) in caps:
            W = inv.inv_cuda(A)
            R = inv.inv_reference(A)
            rel, at = rel_err(W, R)
            rel64, _ = rel_err(W, inv.inv_reference(A.to(torch.complex128)))
            err_abs = max(err_abs, (W - R).abs().max().item())
            worst = max(worst, rel)
            print(f"phase 2 main path {label} n={A.shape[-1]} "
                  f"B={A.shape[0]}: worst per-matrix rel err vs plain "
                  f"{rel:.3e} at ux={ux[at * stride].item():.4f} "
                  f"(kernel vs complex128 {rel64:.3e})")
        if run is main_path:
            require(len(caps) == expected, "inverse count")
        # E at N, the slab matrices at 2N
        for n in (G, 2 * G):
            A = next(a for (a,) in caps if a.shape[-1] == n)
            B = A.shape[0]
            held = {}
            k_ms, p_ms = ab_ms(lambda: inv.inv_reference(A),
                               lambda: held.update(W=inv.inv_cuda(A)), 10)
            rel, _ = rel_err(held["W"], inv.inv_reference(A))
            b_ms, b_by = bound_ms(8 * n ** 3 * B, 2 * 8 * n * n * B)
            print(f"phase 2 time {label} B={B} n={n} (main-path matrices): "
                  f"kernel {k_ms:.3f} ms, torch.linalg.inv {p_ms:.3f} ms; "
                  f"bound {b_ms:.4f} ms ({b_by}), kernel at "
                  f"{100 * b_ms / k_ms:.1f}% of it; timed result rel err vs "
                  f"plain {rel:.3e}")
            require(rel <= TOL_INV, f"timed inverse vs plain: {rel}")
            inv_sizes.append(dict(numG=G, n=n, B=B, ms=k_ms, plain_ms=p_ms,
                                  library_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by))
            del held
        del caps, W, R, A
    require(worst <= TOL_INV, f"inverse vs plain on the main path: {worst}")
    main_inv = next(d for d in inv_sizes if d["numG"] == 50 and d["n"] == 100)
    results["cinv"] = dict(
        route="cuda", source="metalens_tpu_torch/csrc/cinv.cu",
        replaces="metalens_tpu/solver/pallas_inv.py:175",
        max_abs_err=err_abs,
        **{k: main_inv[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
        sizes=inv_sizes)

    # ---- phase 3: Taylor kernels vs their plain versions ---------------
    # F and G of the main path's own call at numG = 50 (B = 1024) and
    # numG = 100 (B = 256); t varies along the batch.  The whole call (the
    # GEMM kernel and the chunk pass) against taylor_factors_reference, and
    # the chunk pass alone against chunk_sums_reference on Y0's powers.
    err_abs = chunk_err_abs = 0.0
    tay_sizes, chunk_sizes = [], []
    for run in (main_path, path100):
        (F, Gm, t_path, n_terms), = capture(taylor, "taylor_factors", run)
        B, n = F.shape[0], F.shape[-1]
        t = float(t_path) * torch.linspace(0.8, 1.0, B, dtype=torch.float32)
        got = taylor.taylor_factors(F, Gm, t, n_terms)
        want = taylor.taylor_factors_reference(F, Gm, t.to(dev), n_terms)
        torch.cuda.synchronize()
        for name, k, r in zip(("CS", "SF", "GS", "GRF"), got, want):
            rel = ((k - r).abs().max() / r.abs().max()).item()
            err_abs = max(err_abs, (k - r).abs().max().item())
            print(f"phase 3 n={n} B={B} terms={n_terms} {name}: "
                  f"max-normalized err {rel:.3e}")
            require(rel <= TOL_TAYLOR, f"Taylor {name} at n={n}: {rel}")
        del got, want
        coeffs = taylor.coeff_table(t, n_terms, B, dev)
        td = t.to(dev)
        k_ms, p_ms = ab_ms(
            lambda: taylor.taylor_factors_reference(F, Gm, td, n_terms),
            lambda: taylor.taylor_factors_cuda(F, Gm, coeffs, n_terms), 5)
        s, r = taylor._ps_split(n_terms)
        flops, nbytes, products, power_terms = taylor_work(n, B, n_terms)
        b_ms, b_by = bound_ms(flops, nbytes)
        print(f"phase 3 time B={B} n={n} terms={n_terms}: kernels "
              f"{k_ms:.3f} ms ({products} GEMM launches + 1 chunk pass), "
              f"plain {p_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}, "
              f"{flops:.3e} flop), kernels at {100 * b_ms / k_ms:.1f}% of it")
        # one GEMM of the plan (Y0 = F G) against cuBLAS's complex GEMM
        # (torch.matmul) on the same operands
        y_k, y_l = torch.empty_like(F), torch.empty_like(F)
        g_ms, gl_ms = ab_ms(lambda: torch.matmul(F, Gm, out=y_l),
                            lambda: taylor.gemm_cuda(F, Gm, y_k), 10)
        rel = ((y_k - y_l).abs().max() / y_l.abs().max()).item()
        require(rel <= TOL_TAYLOR, f"Taylor GEMM vs torch.matmul: {rel}")
        gb_ms, gb_by = bound_ms(8 * n ** 3 * B, 3 * 8 * n * n * B)
        print(f"phase 3 one GEMM B={B} n={n}: kernel {g_ms:.3f} ms "
              f"({8 * n ** 3 * B / g_ms / 1e9:.1f} TFLOP/s), torch.matmul "
              f"(cuBLAS) {gl_ms:.3f} ms; bound {gb_ms:.4f} ms ({gb_by}); "
              f"max-normalized err {rel:.3e}")
        del y_k, y_l
        tay_sizes.append(dict(n=n, B=B, terms=n_terms, ms=k_ms, plain_ms=p_ms,
                              library_ms=None, bound_ms=b_ms, bound_by=b_by,
                              gemm_ms=g_ms, gemm_library_ms=gl_ms,
                              gemm_bound_ms=gb_ms))
        # the chunk pass alone, on the powers of this F G
        pows = torch.empty((B, s, n, n), dtype=F.dtype, device=dev)
        pows[:, 0] = F @ Gm
        for m in range(1, s):
            pows[:, m] = pows[:, m - 1] @ pows[:, 0]
        ck = torch.empty((B, 3, r, n, n), dtype=F.dtype, device=dev)
        cp, cl = torch.empty_like(ck), torch.empty_like(ck)
        # the library call: one batched complex matmul of the coefficient
        # block (B, 3r, s-1) with the stacked powers Y0^1..Y0^(s-1)
        # (B, s-1, n^2), and the Y0^0 = I term added on the diagonal
        idx = (torch.arange(r, device=dev)[:, None] * s
               + torch.arange(s, device=dev))
        cblk = (coeffs[:, :, idx.clamp(max=n_terms)] * (idx <= n_terms)
                ).reshape(B, 3 * r, s).to(F.dtype)
        cmat, c0 = cblk[:, :, 1:].contiguous(), cblk[:, :, :1].contiguous()
        pw = pows[:, :s - 1].reshape(B, s - 1, n * n)
        cl_flat = cl.view(B, 3 * r, n * n)
        cl_diag = cl.view(B, 3 * r, n, n).diagonal(dim1=-2, dim2=-1)

        def chunk_library():
            torch.matmul(cmat, pw, out=cl_flat)
            cl_diag.add_(c0)

        cl1_ms = cuda_ms(chunk_library, 10)
        c_ms, cp_ms = ab_ms(
            lambda: taylor.chunk_sums_reference(pows, coeffs, n_terms, s, r,
                                                cp),
            lambda: taylor.chunk_sums_cuda(pows, coeffs, n_terms, s, r, ck),
            10)
        cl_ms = (cl1_ms + cuda_ms(chunk_library, 10)) / 2
        rel = ((ck - cp).abs().amax((-2, -1))
               / cp.abs().amax((-2, -1))).max().item()
        rel_lib = ((cl - cp).abs().amax((-2, -1))
                   / cp.abs().amax((-2, -1))).max().item()
        chunk_err_abs = max(chunk_err_abs, (ck - cp).abs().max().item())
        require(rel <= TOL_TAYLOR, f"chunk pass at n={n}: {rel}")
        require(rel_lib <= TOL_TAYLOR, f"chunk library call at n={n}: "
                f"{rel_lib}")
        cb_ms, cb_by = bound_ms(4 * power_terms * n * n * B,
                                (s - 1 + 3 * r) * 8 * n * n * B
                                + coeffs.numel() * 4)
        print(f"phase 3 chunk pass B={B} n={n} s={s} r={r}: kernel "
              f"{c_ms:.3f} ms, plain {cp_ms:.3f} ms, library (batched "
              f"torch.matmul + diagonal add) {cl_ms:.3f} ms; bound "
              f"{cb_ms:.4f} ms ({cb_by}), kernel at {100 * cb_ms / c_ms:.1f}% "
              f"of it; worst per-chunk max-normalized err {rel:.3e} "
              f"(library call {rel_lib:.3e})")
        chunk_sizes.append(dict(n=n, B=B, terms=n_terms, ms=c_ms,
                                plain_ms=cp_ms, library_ms=cl_ms,
                                bound_ms=cb_ms, bound_by=cb_by))
        del F, Gm, pows, ck, cp, cl, cl_flat, cl_diag, pw
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    results["taylor"] = dict(
        route="cuda", source="metalens_tpu_torch/csrc/taylor.cu",
        replaces="metalens_tpu/solver/pallas_taylor.py:96",
        entry="cgemm_ps_c64 (times: the whole Taylor call)",
        max_abs_err=err_abs, **{k: tay_sizes[0][k] for k in keys},
        sizes=tay_sizes)
    results["taylor_chunks"] = dict(
        route="cuda", source="metalens_tpu_torch/csrc/taylor.cu",
        replaces="metalens_tpu/solver/pallas_taylor.py:96",
        entry="ps_chunks_c64", max_abs_err=chunk_err_abs,
        **{k: chunk_sizes[0][k] for k in keys}, sizes=chunk_sizes)

    # ---- phase 4: the main path at numG = 50 (the bench cell, B = 1024)
    # and numG = 100 (B = 256), complex64, each driven once with every
    # launch count set to 0 just before it and read just after it
    def reset_counts():
        inv.launches = taylor.launches = taylor.chunk_launches = 0
        for route in inv.route_launches:
            inv.route_launches[route] = 0

    def launch_counts():
        return {"cinv": inv.launches, "taylor": taylor.launches,
                "taylor_chunks": taylor.chunk_launches}

    path_launches, path_routes = {}, {}
    amps = {}
    for G, run, B, sched in ((numG, main_path, BATCH, (ns, terms)),
                             (100, path100, BATCH // 4, (ns100, terms100))):
        label = f"numG={G}"
        reset_counts()
        af, ar, _, _ = run()
        torch.cuda.synchronize()
        counts = {"cinv": inv.launches, "taylor": taylor.launches,
                  "taylor_chunks": taylor.chunk_launches}
        path_launches[label] = counts
        path_routes[label] = dict(inv.route_launches)
        print(f"phase 4 main path {label} B={B} schedule={sched}: launches "
              f"{counts}, inverse routes {path_routes[label]}")
        require(all(v > 0 for v in counts.values()),
                f"{label}: a kernel of the path did not launch: {counts}")
        require(af.shape == (B, 2 * G, 2) and af.dtype == torch.complex64,
                f"{label}: ampf {tuple(af.shape)} {af.dtype}")
        require(bool(torch.isfinite(torch.view_as_real(af)).all())
                and bool(torch.isfinite(torch.view_as_real(ar)).all()),
                f"{label}: non-finite amplitudes")
        # every cell against the same path with the plain versions
        with plain_versions():
            pf, pr, _, _ = run()
        plain_err = max((af - pf).abs().max().item(),
                        (ar - pr).abs().max().item())
        print(f"phase 4 {label} all {B} cells, kernels vs plain versions: "
              f"max err {plain_err:.3e} (bound {TOL_GUARD})")
        require(plain_err <= TOL_GUARD, f"{label} vs plain: {plain_err}")
        amps[G] = af, ar
        del pf, pr
    # n = 200 inverts on the cluster route, n <= 128 on the register route
    require(path_routes["numG=50"]["cluster"] == 0
            and path_routes["numG=100"]["cluster"] > 0
            and path_routes["numG=100"]["registers"] > 0,
            f"inverse routes per path: {path_routes}")
    results["cinv"]["route_launches_by_path"] = path_routes
    ampf, ampr = amps.pop(numG)
    del amps
    # cells across the ux sweep, and the one nearest the grazing ux = 0.45,
    # against the same schedule in complex128 on the CPU
    ux_np = ux.cpu().numpy()
    idx = sorted(set(np.linspace(0, BATCH - 1, 8).astype(int).tolist())
                 | {int(np.abs(ux_np - 0.45).argmin())})
    cf, cr, _, _ = rcwa.cell_amplitudes(
        orders, xyrra[idx].cpu().double(), LX, LY, H, NT ** 2, NG ** 2,
        LAM, ux[idx].cpu().double(), uy[idx].cpu().double(), c_inc,
        n_slabs=ns, taylor_terms=terms, fff=True)
    require(cf.dtype == torch.complex128, f"CPU reference dtype {cf.dtype}")
    cpu_err = max((ampf[idx].cpu().to(cf.dtype) - cf).abs().max().item(),
                  (ampr[idx].cpu().to(cr.dtype) - cr).abs().max().item())
    print(f"phase 4 {len(idx)} cells (ux {ux_np[idx[0]]:.3f}..."
          f"{ux_np[idx[-1]]:.3f}) vs CPU complex128: max err {cpu_err:.3e} "
          f"(bound {TOL_GUARD})")
    require(cpu_err <= TOL_GUARD, f"main path vs CPU complex128: {cpu_err}")

    # end to end, kernels against plain versions, in turns on this card
    modes = {"kernels": {}, "plain": dict(inverse=True, taylor_factors=True),
             "plain inverse only": dict(inverse=True, taylor_factors=False),
             "plain Taylor only": dict(inverse=False, taylor_factors=True)}
    turns = ("plain", "kernels", "plain inverse only", "plain Taylor only",
             "kernels", "plain")
    e2e = {}
    for G, run, B in ((50, main_path, BATCH), (100, path100, BATCH // 4)):
        for mode in turns:
            with (plain_versions(**modes[mode]) if modes[mode]
                  else contextlib.nullcontext()):
                ms = batch_ms(run)
            e2e.setdefault((G, mode), []).append(ms)
            print(f"phase 4 end to end numG={G} B={B} {mode}: {ms:.3f} ms "
                  f"per batch ({B / ms * 1e3:.1f} solves/s)")
    best = min(e2e[(50, "kernels")])
    print(f"phase 4 smoke timing (not a benchmark): {BATCH / best * 1e3:.1f} "
          f"solves/s, {best:.3f} ms per batch of {BATCH} (best of "
          f"{len(e2e[(50, 'kernels')])} turns, each the best of 3 windows "
          f"of 2 batches)")
    profile(main_path, f"numG=50 B={BATCH} kernels")
    with plain_versions():
        profile(main_path, f"numG=50 B={BATCH} plain")
    profile(path100, f"numG=100 B={BATCH // 4} kernels")
    with plain_versions():
        profile(path100, f"numG=100 B={BATCH // 4} plain")

    def amps_at(height, n_slabs, n_terms):
        af, ar, _, _ = rcwa.cell_amplitudes(
            orders, torch.as_tensor(BASE[None], dtype=torch.float32,
                                    device=dev),
            LX, LY, height, NT ** 2, NG ** 2, LAM,
            torch.tensor([0.45], dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.float32, device=dev), c_inc,
            n_slabs=n_slabs, taylor_terms=n_terms, fff=True)
        require(af.dtype == torch.complex64, f"guard dtype {af.dtype}")
        return np.stack([af.real.cpu().numpy(), af.imag.cpu().numpy(),
                         ar.real.cpu().numpy(), ar.imag.cpu().numpy()])

    truth = np.load(os.path.join(REPO, "benchmarks", "bench_truth.npz"))
    op_err = float(np.abs(amps_at(H, ns, terms)
                          - truth[f"ampfr_numG{numG}"]).max())
    print(f"phase 4 guard cell vs f64 truth: max err {op_err:.3e} "
          f"(bound {TOL_GUARD})")
    require(op_err <= TOL_GUARD, f"operating point error {op_err}")
    cap = rcwa.slab_cap(torch.float32)
    kx = orders[:, 0] * LAM / LX
    ky = orders[:, 1] * LAM / LY
    kmax = float(np.sqrt(kx ** 2 + ky ** 2).max()) + 1.0
    q = math.sqrt((kmax * kmax + NT ** 2) * 1.05)
    k0h_cap = cap / q
    H_cap = k0h_cap * LAM / (2 * np.pi)
    _, t1 = rcwa.slab_schedule(k0h_cap, orders, LX, LY, LAM, NT ** 2,
                               target=cap * 1.0001)
    _, t16 = rcwa.slab_schedule(k0h_cap, orders, LX, LY, LAM, NT ** 2,
                                target=cap / 15.99)
    cap_err = float(np.abs(amps_at(H_cap, 1, t1)
                           - amps_at(H_cap, 16, t16)).max())
    print(f"phase 4 at-cap (t*q = {cap}) 1 vs 16 slabs: max err "
          f"{cap_err:.3e} (bound {TOL_GUARD})")
    require(cap_err <= TOL_GUARD, f"at-cap error {cap_err}")

    # ---- phase 5: entry points on CUDA vs CPU complex128 ---------------
    g = Grating(lateral_period=LY, grating_period=LX, cyl_height=H,
                xyrra_list_in_nm_deg=BASE * [1 / NM, 1 / NM, 1 / NM, 1 / NM,
                                             180 / np.pi])
    reset_counts()
    f_gpu = g.fom(target_wavelength=LAM, numG=numG)
    require(inv.launches > 0 and taylor.launches > 0
            and taylor.chunk_launches > 0,
            "Grating.fom on CUDA launched no kernel")
    f_cpu = g.fom(target_wavelength=LAM, numG=numG, device="cpu")
    print(f"phase 5 Grating.fom numG={numG}: cuda {f_gpu:.6f}, "
          f"cpu complex128 {f_cpu:.6f}")
    require(abs(f_gpu - f_cpu) <= TOL_GUARD, "Grating.fom cuda vs cpu")
    cand = np.stack([g.xyrra_list + rng.normal(scale=3 * NM,
                                               size=g.xyrra_list.shape)
                     * [1, 1, 1, 1, 0] for _ in range(20)])
    fb_gpu = fom_batch_fn(g, LAM, numG)(cand)
    fb_cpu = fom_batch_fn(g, LAM, numG, device="cpu")(cand)
    require(fb_gpu.dtype == torch.float32 and fb_gpu.shape == (20,),
            f"fom_batch_fn {fb_gpu.dtype} {tuple(fb_gpu.shape)}")
    fb_err = float((fb_gpu.cpu().double() - fb_cpu).abs().max())
    print(f"phase 5 fom_batch_fn B=20: max |cuda - cpu| = {fb_err:.3e}")
    require(fb_err <= TOL_GUARD, f"fom_batch_fn cuda vs cpu: {fb_err}")

    # ---- phase 6: the design loop on the card ---------------------------
    import importlib
    from metalens_tpu_torch import (GratingCollection, fom_value_and_grad,
                                    optimize_gradient, resize, validate,
                                    vary_angle)
    from metalens_tpu_torch.engine import fom_of_grating, static_solve_config
    from metalens_tpu_torch.solver.fom import DEFAULT_FOM_TERMS
    opt_module = importlib.import_module("metalens_tpu_torch.optimize")
    t6 = time.perf_counter()
    gen6 = torch.Generator(device=dev).manual_seed(6)

    def crandn(like):
        return torch.view_as_complex(torch.randn(
            *like.shape, 2, generator=gen6, device=dev)).to(like.dtype)

    # 6.1: InverseFn's backward on the kernel against autograd through
    # torch.linalg.inv, on every n = 100 inverse of the main path
    worst = 0.0
    caps = [A for (A,) in capture(inv, "inv", main_path)
            if A.shape[-1] == 2 * numG]
    for A in caps:
        ct = crandn(A)
        A_k, A_r = (A.detach().clone().requires_grad_() for _ in range(2))
        got, = torch.autograd.grad(inv.inv(A_k), A_k, ct)
        want, = torch.autograd.grad(inv.inv_reference(A_r), A_r, ct)
        require(got.dtype == torch.complex64, f"inverse grad {got.dtype}")
        worst = max(worst, rel_err(got, want)[0])
    print(f"phase 6 inverse backward, {len(caps)} main-path batches n=100 "
          f"B={BATCH}: worst per-matrix rel err vs torch.linalg.inv autograd "
          f"{worst:.3e} (bound {TOL_INV})")
    require(len(caps) == 5 and worst <= TOL_INV,
            f"inverse backward: {len(caps)} batches, err {worst}")
    del caps, A, A_k, A_r, ct, got, want

    # 6.2: TaylorFn (kernels forward, plain replay backward) against
    # autograd through taylor_factors_reference, on the path's own F, G
    (F, Gm, t_path, n_terms), = capture(taylor, "taylor_factors", main_path)
    cts = [crandn(F) for _ in range(4)]
    F_k, G_k, F_r, G_r = (M.detach().clone().requires_grad_()
                          for M in (F, Gm, F, Gm))
    got = torch.autograd.grad(taylor.taylor_factors(F_k, G_k, t_path,
                                                    n_terms), (F_k, G_k), cts)
    want = torch.autograd.grad(taylor.taylor_factors_reference(
        F_r, G_r, t_path, n_terms), (F_r, G_r), cts)
    for name, k, r in zip(("grad F", "grad G"), got, want):
        rel = ((k - r).abs().max() / r.abs().max()).item()
        print(f"phase 6 Taylor backward n={F.shape[-1]} B={F.shape[0]} "
              f"terms={n_terms} {name}: max-normalized err {rel:.3e} "
              f"(bound {TOL_TAYLOR})")
        require(k.dtype == torch.complex64 and rel <= TOL_TAYLOR,
                f"Taylor backward {name}: {k.dtype} {rel}")
    del F, Gm, cts, F_k, G_k, F_r, G_r, got, want
    torch.cuda.empty_cache()

    # 6.3: fom_value_and_grad at numG = 50, the default FOM terms, on CUDA
    # complex64 against the CPU in complex128
    gd = Grating(lateral_period=LY, grating_period=LX, cyl_height=H,
                 xyrra_list_in_nm_deg=DESIGN_NM_DEG)
    require(validate(gd), "the design cell is not feasible")
    vg = fom_value_and_grad(gd, LAM, numG)
    _, n_s, n_t, _ = static_solve_config(
        gd, [t.wavelength for t in DEFAULT_FOM_TERMS], numG, torch.complex64)
    n_fom = len(DEFAULT_FOM_TERMS)
    expect = {"cinv": n_fom * (5 + int(math.log2(n_s))),
              "taylor": n_fom * taylor_work(2 * numG, 1, n_t)[2],
              "taylor_chunks": n_fom}
    reset_counts()
    f_gpu, g_gpu = vg(gd.xyrra_list)
    torch.cuda.synchronize()
    counts = {"cinv": inv.launches, "taylor": taylor.launches,
              "taylor_chunks": taylor.chunk_launches}
    path_launches["fom_value_and_grad numG=50"] = counts
    print(f"phase 6 fom_value_and_grad numG={numG} ({n_fom} terms, schedule "
          f"{n_s} slabs, {n_t} Taylor terms): launches {counts}, expected "
          f"{expect} (the forward's; both backward passes are torch ops)")
    require(all(v > 0 for v in counts.values()) and counts == expect,
            f"fom_value_and_grad launches {counts}, expected {expect}")
    require(f_gpu.dtype == g_gpu.dtype == torch.float32 and f_gpu.ndim == 0
            and g_gpu.shape == (2, 5) and bool(torch.isfinite(g_gpu).all()),
            f"fom_value_and_grad on CUDA: {f_gpu.dtype} {g_gpu.dtype} "
            f"{tuple(g_gpu.shape)}")
    f_cpu, g_cpu = fom_value_and_grad(gd, LAM, numG,
                                      device="cpu")(gd.xyrra_list)
    require(g_cpu.dtype == torch.float64, f"CPU gradient {g_cpu.dtype}")
    d_fom = abs(f_gpu.item() - f_cpu.item())
    d_grad = ((g_gpu.cpu().double() - g_cpu).norm() / g_cpu.norm()).item()
    print(f"phase 6 fom_value_and_grad: fom cuda {f_gpu.item():.7f}, cpu "
          f"complex128 {f_cpu.item():.7f}, |dfom| {d_fom:.3e} (bound "
          f"{TOL_FOM}); |dgrad|/|grad| {d_grad:.3e} (bound {TOL_GRAD})")
    print(f"phase 6 gradient cuda (per m, per rad): "
          f"{np.array2string(g_gpu.cpu().numpy(), precision=5)}")
    require(d_fom <= TOL_FOM, f"fom cuda vs cpu: {d_fom}")
    require(d_grad <= TOL_GRAD, f"gradient cuda vs cpu: {d_grad}")
    # the kernels at this path's own inputs (B = 1) against their plain
    # versions, and timed against them in turns beside their bound
    inv_caps = [A.detach()
                for (A,) in capture(inv, "inv", lambda: vg(gd.xyrra_list))]
    worst = max(rel_err(inv.inv_cuda(A), inv.inv_reference(A))[0]
                for A in inv_caps)
    tay_caps = capture(taylor, "taylor_factors", lambda: vg(gd.xyrra_list))
    tay_worst = 0.0
    with torch.no_grad():
        for F, Gm, t_path, k in tay_caps:
            for a, b in zip(taylor.taylor_factors(F, Gm, t_path, k),
                            taylor.taylor_factors_reference(F, Gm, t_path,
                                                            k)):
                tay_worst = max(tay_worst, ((a - b).abs().max()
                                            / b.abs().max()).item())
    print(f"phase 6 kernels at the fom_value_and_grad inputs (B=1): worst "
          f"inverse rel err vs plain {worst:.3e} (bound {TOL_INV}), Taylor "
          f"{tay_worst:.3e} (bound {TOL_TAYLOR})")
    require(worst <= TOL_INV and tay_worst <= TOL_TAYLOR,
            f"kernels at the B=1 inputs: {worst}, {tay_worst}")
    F, Gm, t_path, k = (x.detach() if torch.is_tensor(x) else x
                        for x in tay_caps[0])
    A1 = next(A for A in inv_caps if A.shape[-1] == 2 * numG)
    k_ms, p_ms = ab_ms(lambda: inv.inv_reference(A1),
                       lambda: inv.inv_cuda(A1), 20)
    n1 = A1.shape[-1]
    b_ms, b_by = bound_ms(8 * n1 ** 3, 2 * 8 * n1 * n1)
    results["cinv"]["sizes"].append(dict(
        path="fom_value_and_grad", numG=numG, n=n1, B=1, ms=k_ms,
        plain_ms=p_ms, library_ms=p_ms, bound_ms=b_ms, bound_by=b_by))
    coeffs1 = taylor.coeff_table(t_path, k, 1, dev)
    k_ms2, p_ms2 = ab_ms(
        lambda: taylor.taylor_factors_reference(F, Gm, t_path, k),
        lambda: taylor.taylor_factors_cuda(F, Gm, coeffs1, k), 20)
    flops1 = taylor_work(n1, 1, k)[2] * 8 * n1 ** 3
    b_ms2, b_by2 = bound_ms(flops1, 6 * 8 * n1 * n1)
    results["taylor"]["sizes"].append(dict(
        path="fom_value_and_grad", n=n1, B=1, terms=k, ms=k_ms2,
        plain_ms=p_ms2, library_ms=None, bound_ms=b_ms2, bound_by=b_by2))
    print(f"phase 6 time B=1 n={n1}: inverse kernel {k_ms:.4f} ms, "
          f"torch.linalg.inv {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"Taylor ({k} terms) kernels {k_ms2:.4f} ms, plain {p_ms2:.4f} ms,"
          f" bound {b_ms2:.5f} ms ({b_by2}, products only)")
    del inv_caps, tay_caps, F, Gm, A1
    vg_ms = batch_ms(lambda: vg(gd.xyrra_list))
    print(f"phase 6 fom_value_and_grad numG={numG} B=1: {vg_ms:.3f} ms per "
          f"call (best of 3 windows of 2 calls)")
    profile_split(lambda: vg(gd.xyrra_list),
                  f"fom_value_and_grad numG={numG}", vg_ms)

    # 6.4: optimize_gradient, 20 steps at numG = 50 on CUDA
    f_start = fom_of_grating(gd, LAM, numG)
    t0 = time.perf_counter()
    g_opt = optimize_gradient(gd, LAM, steps=20, numG=numG, verbose=False)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    f_opt = fom_of_grating(g_opt, LAM, numG)
    print(f"phase 6 optimize_gradient 20 steps numG={numG}: fom "
          f"{f_start:.6f} -> {f_opt:.6f}, {opt_s * 1e3 / 20:.1f} ms per step "
          f"({opt_s:.2f} s)")
    require(validate(g_opt), "optimize_gradient's result fails validate")
    require(f_opt > f_start, f"optimize_gradient: {f_start} -> {f_opt}")

    # 6.5: one vary_angle member (cyl, derivative-free, 20 optimize2
    # attempts); end_angle between the first and the second rung
    rung = [math.asin(LAM / (LX * 1.01 ** k)) for k in (1, 2)]
    opt_module.probe_batches = 0
    t0 = time.perf_counter()
    gc = vary_angle(gd, sum(rung) / 2, "cyl", LAM, numG=numG,
                    optimize2_attempts=20, verbose=False,
                    rng=np.random.default_rng(3))
    torch.cuda.synchronize()
    vary_s = time.perf_counter() - t0
    batches = opt_module.probe_batches
    require(len(gc.grating_list) == 2, f"vary_angle made "
            f"{len(gc.grating_list) - 1} members, expected 1")
    member = gc.grating_list[-1]
    seed = resize(gd, GratingCollection(LAM, LY, "cyl", [gd.copy()])
                  .get_one(grating_period=LX * 1.01))
    ok = validate(member, similar_to=seed.xyrra_list, how_similar=0.03)
    # both in one batch of the probes' own size (20, padded by repetition)
    # through the probes' own function, so the comparison sees the values
    # the optimizers accepted
    pair = fom_batch_fn(seed, LAM, numG)(np.stack(
        [seed.xyrra_list] + [member.xyrra_list] * 19))[:2].cpu().numpy()
    print(f"phase 6 vary_angle one member (cyl, {seed.grating_period / NM:.1f}"
          f" nm, optimize2_attempts=20): {vary_s:.2f} s, {batches} probe "
          f"batches of 20 cells; fom {pair[0]:.6f} (resized start) -> "
          f"{pair[1]:.6f}; validate under the 3% trust region: {ok}")
    require(ok, "the vary_angle member fails validate")
    require(pair[1] >= pair[0], f"vary_angle member fom {pair}")
    print(f"phase 6 design loop: {time.perf_counter() - t6:.2f} s")

    # ---- phase 7: the amplitude databases at numG = 100 -----------------
    characterize_phase(dev, gd, results, path_launches, reset_counts,
                       launch_counts)

    # ---- phase 8: the lens check ----------------------------------------
    lens_phase(dev, results, path_launches, reset_counts, launch_counts)

    # launches: the sum over the counted runs of each path
    kernels = [dict(name=name,
                    launches=sum(c[name] for c in path_launches.values()),
                    launches_by_path={p: c[name]
                                      for p, c in path_launches.items()},
                    **r)
               for name, r in results.items()]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
