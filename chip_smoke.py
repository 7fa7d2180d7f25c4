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
on the lens's characterize inputs, and the stages timed and profiled; 8c
then characterizes the same lens's databases at 450 and 650 nm as well
(appended), designs it once more and runs the stitch, the far field and
the focal metrics at each of northstar2's three wavelengths on its grid
for that wavelength, each held to CPU complex128 as at 580 nm.
Phase 9 drives the fused design loop at ``benchmarks/northstar2.py``'s
design config (5 pillars at 19.7 deg, its RGB terms, numG = 50):
``optimize_fused`` then ``optimize2_fused`` (40 attempts) with the loop's
FOM held to ``Grating.fom`` on the card and to CPU complex128, the same
member again (identical), ``feasible_traced`` on the card against the
host's float64 ``validate``, a two-member ``vary_angle(use_fused=True)``
continuation with NS2's steps, and the kernels held to their plain versions
on a screen and a walk batch; it counts launches against the schedule, host
syncs per FOM batch and per round, and times and profiles a round.  Phase
10 drives the sharded paths of ``metalens_tpu_torch.parallel`` through a
one-rank NCCL process group (a file store, no network): the dry run of all
six paths, then each at full width held to the unsharded port call on the
same card -- the sharded FOM + gradient step at the bench cell (numG = 50,
B = 64) against ``fom_value_and_grad`` cell by cell and CPU complex128, the
characterize sweep over phase 7's four periods in one batch against phase
7's databases, the stitch of phase 8b's lens against phase 8b's near field,
``fft2_sharded`` against ``torch.fft.fft2`` and ``farfield_sharded``
against ``farfield``, and the member design of phase 9's member against
the member alone; it holds the kernels to their plain versions on the step's
and the sweep's inputs, counts launches, times each path beside its twin in
turns and profiles the step.  Phase 11 holds the cell solve to independent
physics and drives the rest of the port end to end: 11a, in complex64 on the
card at the bench cell's width (numG = 50) and through the port in
complex128 on the CPU, a uniform slab against the transfer-matrix method and
lamellar gratings against the independent 1D RCWA (the numpy oracles of
``tests/``), Lorentz reciprocity and energy of lossless and absorbing
pillars with NV off and on, and 64 random cells against the port's eigenmode
reference, with launches against the schedule and the kernels held to their
plain versions on these inputs; 11b, the native exporter built from
``native/fastexport.cpp``, phase 8b's lens written as DXF, SVG and GDSII
(pillars/s), the native files against the Python writers byte for byte on
its first and last 20,000 pillars and the GDSII read back; 11c, the port's
collimator demo (``metalens_tpu_torch.examples.collimator_demo --rgb``) in a
subprocess, its printed lines parsed and checked.  Phase 12 runs
``benchmarks/run_configs.py`` configs 1-4 at ``--scale small`` through the
port on the card (their twins below, seeded as the JAX run was) and holds
each config's headline values to the JAX package's (``CONFIGS_JAX``);
config 5 is phase 8a.

    python3 chip_smoke.py

Every phase is fatal: a failed check exits nonzero.  The last two lines of
standard output are a JSON object describing each kernel (launches in the
counted runs of the main path at numG = 50 and numG = 100, of one
``fom_value_and_grad`` call, of the characterize sweeps (the lens's at
580 nm and at 450 + 650 nm among them), of the fused member, of the sharded
step, sweep and member, of the physics checks and of each config of phase
12, summed and per path, with the inverse's per route; error against the plain
version; times and bound at the main path's bench size, and the same per
size under ``sizes``) and ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits nonzero
before printing any result.  Imports nothing of JAX.
"""

import contextlib
import functools
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
# Phase 12's anchors: benchmarks/run_configs.py configs 1-4 at --scale small
# through the JAX package on the CPU in float32, each in its own process
# with random and numpy.random seeded to 0 before the run, as printed by
#     python -c "import random, runpy, sys, numpy; random.seed(0); \
#       numpy.random.seed(0); sys.argv = ['run_configs.py', '--cpu', \
#       '--config', 'K']; runpy.run_path('benchmarks/run_configs.py', \
#       run_name='__main__')"
# (K = 1..4; values as printed, rounded).  The FOM after optimize_gradient
# (config 2) and each member's FOM (config 3) come from the same command
# with metalens_tpu.optimize.optimize_gradient and .vary_angle wrapped,
# after the seeding, to print the FOM of what they return (Grating.fom at
# the config's numG and terms, which draws no random number; the run's
# printed values are unchanged):
#     import metalens_tpu.optimize as O
#     og, va = O.optimize_gradient, O.vary_angle
#     def grad(g, *a, **k):
#         out = og(g, *a, **k)
#         print(out.fom(k["target_wavelength"], numG=k["numG"],
#                       terms=k["terms"])); return out
#     def vary(*a, **k):
#         gc = va(*a, **k)
#         print([g.fom(k["target_wavelength"], numG=k["numG"],
#                      terms=k["terms"]) for g in gc.grating_list]); return gc
#     O.optimize_gradient, O.vary_angle = grad, vary
# ``import jax`` draws from numpy.random, so that run's optimize2 draws
# differ from a run seeded after the imports, as this script's is (it
# imports torch and the port before seeding).  "fom_end_same_draws" is
# config 2's fom_end from the wrapped command with the seeding moved after
# ``import metalens_tpu.optimize``: the sequence the port draws.
CONFIGS_JAX = {
    1: {"phase_span_rad": 3.866},
    2: {"fom_start": 0.1023, "fom_after_gradient": 0.2364051342010498,
        "fom_end": 0.241, "fom_end_same_draws": 0.23849324882030487},
    3: {"members": 2, "db_entries": 400,
        "member_foms": [0.2415083646774292, 0.2643738090991974]},
    4: {"pillars": 1149, "aperture_pts": 3600}}
TOL_CONFIG1 = 2e-3        # rad
TOL_CONFIG2 = {"fom_start": 1e-3, "fom_after_gradient": 2e-3,
               "fom_end": 5e-3, "fom_end_same_draws": 2e-3}
TOL_CONFIG3_FOM = 2e-3
TOL_NEARFIELD = 2e-3  # stitch on the card vs CPU complex128, of field max
TOL_FARFIELD = 1e-4   # far field on the card vs CPU complex128
# benchmarks/northstar2.py's production lens at 580 nm: a 0.5 mm aperture,
# the source 150 um away, four angle brackets in degrees
NS_RADIUS, NS_SOURCE = 250e-6, 150e-6
NS_BRACKETS = ((20.0, 27.0), (27.0, 37.0), (37.0, 48.0), (48.0, 59.5))
NS_HEX_ENTRIES = 16
# benchmarks/northstar2.py's design config: _rgb_terms (equal weights, in
# phase at 580 nm and magnitude at 650 and 450 nm, order -1), numG = 50 and
# its continuation steps; benchmarks/bench_design_member_fused.py's member
NS2_RGB_TERMS = ((650, False), (580, True), (450, False))
NS2_DESIGN_NUMG = 50
NS2_CHANGE_EACH_STEP, NS2_SIMILARITY = 1.05, 0.15
FUSED_PILLARS, FUSED_ANGLE_DEG, FUSED_ATTEMPTS = 5, 19.7, 40
TOL_FUSED_FOM = 1e-5      # the loop's returned FOM vs Grating.fom on the card
PEAK_F32 = 67e12          # flop/s, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# phase 11a: the physics checks at the bench cell's width; complex64 on the
# card within bench.py's accuracy guard, complex128 on the CPU within the
# reference tests' own bounds (tests/test_rcwa_fresnel.py and
# tests/test_lamellar_independent.py, tests/test_reciprocity.py,
# tests/test_lossy_and_random.py)
PHYS_NUMG = 50
LAMELLAR_M = 24           # the lamellar order line: 2 M + 1 = 49 orders
LAMELLAR = ((25.0, 0.45, 5.6257), (0.001, 0.6, 4.0),
            (40.0, 0.3, 5.6257 + 0.05j))   # (deg, fill, eps of the fill)
TMM_THETAS = (0.001, math.radians(35.0))
RECIP_U = (0.31, 0.12)
EIG_CELLS, EIG_CPU_CELLS = 64, 8
TOL_PHYS = TOL_GUARD
PHYS_TOL64 = {"TMM": 1e-10, "lamellar": 5e-5, "reciprocity": 1e-8,
              "energy": 1e-8, "eigenmode": 1e-6}
# phase 11b: the native files against the Python writers on this many of the
# lens's first and last pillars; phase 11c: the demo subprocess's time limit
EXPORT_CHECK = 20000
DEMO_TIMEOUT_S = 700


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def reset_counts():
    """Clear the port's trace registry: the kernels' launch counters with
    the rest."""
    from metalens_tpu_torch import trace
    trace.reset()


def launch_counts():
    """Launches of each hand-written kernel since :func:`reset_counts`
    (the trace registry records while :func:`main` runs)."""
    from metalens_tpu_torch import _cuda
    return _cuda.launch_counts()


def route_counts():
    """The inverse's launches since :func:`reset_counts` by route."""
    from metalens_tpu_torch import _cuda
    return _cuda.route_counts()


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
    copies = {d: [e for e in events if f"Memcpy {d}" in e.key]
              for d in ("HtoD", "DtoH")}
    print(f"profile {label}: self device time {total:.3f} ms in "
          f"{sum(e.count for e in events)} device operations, wall "
          f"{wall:.3f} ms under the profiler{idle}; copies "
          + ", ".join(f"{d} {sum(e.count for e in v)} "
                      f"({sum(dev_us(e) for e in v) / 1e3:.3f} ms)"
                      for d, v in copies.items()))
    for e in sorted(events, key=dev_us, reverse=True)[:rows]:
        print(f"profile {label}:   {dev_us(e) / 1e3:9.3f} ms "
              f"{e.count:5d} calls  {e.key[:80]}")


def sync_sites(fn):
    """Host syncs during fn() by torch.cuda.set_sync_debug_mode, by the
    site in the repo that caused each (torch's own frames apart)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        # torch's notice that the debug mode is a prototype is not a sync
        if ("synchroniz" in str(w.message)
                and "prototype" not in str(w.message)):
            path = os.path.relpath(w.filename, REPO)
            key = ("(torch)" if path.startswith("..")
                   else f"{path}:{w.lineno}")
            sites[key] = sites.get(key, 0) + 1
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


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


def kernels_at_inputs(dev, results, inv_caps, tay_caps, path, label,
                      numG=CHAR_NUMG):
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
            path=path, numG=numG, n=n, B=B, ms=k_ms, plain_ms=p_ms,
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


def characterize_phase(dev, gd, results, path_launches):
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
        results["cinv"]["route_launches_by_path"][label] = route_counts()
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
    results["cinv"]["route_launches_by_path"]["characterize hexgrid"] = \
        route_counts()
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
    return gc


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


def lens_metrics(nf, ff, lps, lcs, hgs, d, half, spot_u, device="cuda",
                 lam=LAM, times=None):
    """The lens check of benchmarks/run_configs.py config 5 and
    northstar2.py at wavelength ``lam``: an 'x' dipole at (0, 0, -d), the
    aperture [-half, half]^2 at good_fft_number points per side (lam / 2.2
    apart), the stitch, the far field and the focal metrics; with
    ``times``, each of the two stages timed there (``stage``)."""
    from metalens_tpu_torch.geometry import good_fft_number
    pts = np.linspace(-half, half, good_fft_number(2 * half / (lam / 2.2)))

    def timed(name):
        return (contextlib.nullcontext() if times is None
                else stage(times, name))
    with timed("stitch"):
        out = nf.build_nearfield(0.0, 0.0, -d, "x", lam, lps, lcs, hgs, pts,
                                 pts, dipole_moment=1e-30, device=device)
    with timed("far field + focal metrics"):
        far = ff.farfield(*out[:4], pts, pts, lam, out[7], device=device)
        P, tot, ux, uy, dux, duy = far
        m = ff.focal_metrics(P, ux, uy, dux, duy, tot, out[6],
                             spot_radius_u=spot_u)
    return out, far, m


def classification(nf, lps, lcs, hgs, d, xs, ys, device, lam=LAM):
    """The stitch's point classification on ``device``: collection index,
    centre flag, the grating copy's rotation (cos) and the centre site."""
    import torch
    X, Y = (p.contiguous() for p in torch.meshgrid(
        torch.as_tensor(xs, device=device), torch.as_tensor(ys, device=device),
        indexing="ij"))
    planes = nf._geometry_planes(
        X, Y, *nf._ring_tables(lps, device), lps["r_max_list"][-1], 0.0, 0.0,
        -d, 2 * math.pi / lam, [1, 0, 0], 1.0, 1e-30, True, False,
        torch.complex64)
    table, n1, n2 = nf._hex_site_table(lcs, hgs.sep, device)
    rows, _ = nf._nearest_center_site(
        X, Y, table, n1, n2, hgs.sep,
        torch.as_tensor(lcs[:, 0:2], device=device))
    return [planes[0].cpu(), planes[1].cpu(), planes[8].cpu(), rows.cpu()]


@contextlib.contextmanager
def cpu_tables(objs):
    """The objects' interpolators swapped for complex128 tables built on
    the CPU from the same database entries; the card's are put back
    after."""
    card = [obj.interpolators for obj in objs]
    for obj in objs:
        obj.build_interpolators(device="cpu")
    try:
        yield
    finally:
        for obj, tables in zip(objs, card):
            obj.interpolators = tables


def nearfield_slabs(nf, lens, out, lam, slabs, dev):
    """The card's near field ``out`` against the stitch in complex128 on
    the CPU (tables on the CPU: ``cpu_tables``) on slabs of 8 columns
    centred at the ``slabs`` positions (name, y): the max |diff| over Ex,
    Ey, Hx, Hy as a share of each field's max, and the count of points the
    two devices classify differently (collection, centre flag, rotation,
    centre site)."""
    import torch
    lps, lcs, hgs, d, pts = (lens[k] for k in ("lps", "lcs", "hgs", "d",
                                               "pts"))
    fmax = [f.abs().max().item() for f in out[:4]]
    slab_err, n_class = {}, {}
    for name, y in slabs:
        c0 = int(np.argmin(np.abs(pts - y))) - 4
        cols = slice(c0, c0 + 8)
        ref = nf.build_nearfield(0.0, 0.0, -d, "x", lam, lps, lcs, hgs, pts,
                                 pts[cols], dipole_moment=1e-30,
                                 device="cpu")
        require(ref[0].dtype == torch.complex128, f"CPU slab {ref[0].dtype}")
        slab_err[name] = max(
            (f[:, cols].cpu().to(r.dtype) - r).abs().max().item() / fm
            for f, r, fm in zip(out[:4], ref[:4], fmax))
        cls = [classification(nf, lps, lcs, hgs, d, pts, pts[cols], dv, lam)
               for dv in (dev, "cpu")]
        (g1, c1, r1, s1), (g2, c2, r2, s2) = cls
        n_class[name] = int(((g1 != g2) | (c1 != c2)
                             | ((r1 - r2).abs() > 1e-9)
                             | (c1 & (s1 != s2))).sum())
    return slab_err, n_class


def farfield_vs_cpu(ff, out, far, m, pts, lam, spot_u, what):
    """The card's far field and focal metrics against ``farfield()`` in
    complex128 on the CPU of the card's near field copied to the host:
    relative errors (P as a share of its max)."""
    import torch
    P, tot, ux, uy, dux, duy = far
    Pr, totr, *_ = ff.farfield(*(f.cpu() for f in out[:4]), pts, pts, lam,
                               out[7], device="cpu")
    mr = ff.focal_metrics(Pr, ux, uy, dux, duy, totr, out[6],
                          spot_radius_u=spot_u)
    Pc = P.cpu().double()
    fin = torch.isfinite(Pr)
    require(bool((torch.isfinite(Pc) == fin).all()),
            f"{what} far field: finite bins differ from the CPU's")
    far_err = {"P": ((Pc - Pr)[fin].abs().max() / Pr[fin].max()).item(),
               "total_P": abs(tot - totr) / totr}
    for k in ("transmission", "spot_fraction_of_total"):
        far_err[k] = abs(m[k] - mr[k]) / mr[k]
    return far_err


def lens_phase(dev, results, path_launches):
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
    # and on the CPU in complex128 (the same calls with device="cpu"):
    # config 4's lens and near field, then the far field
    def config5(device):
        res, _ = config4_assembly_nearfield(device)
        out, pts = res.pop("_out")
        P, tot, ux, uy, dux, duy = ff.farfield(*out[:4], pts, pts, LAM,
                                               out[7], device=device)
        return out[0], ff.focal_metrics(P, ux, uy, dux, duy, tot, out[6],
                                        spot_radius_u=0.15)
    t0 = time.perf_counter()
    got = {"cuda": config5("cuda")}
    t_config5 = time.perf_counter() - t0
    got["cpu"] = config5("cpu")
    for device, dtype in (("cuda", torch.complex64),
                          ("cpu", torch.complex128)):
        f = got[device][0]
        require(f.device.type == device and f.dtype == dtype
                and f.shape == (60, 60), f"config 5 near field on {device}: "
                f"{f.device} {f.dtype} {tuple(f.shape)}")
    m, m_cpu = got["cuda"][1], got["cpu"][1]
    config5_card = dict(m)
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
    results["cinv"]["route_launches_by_path"]["characterize lens"] = \
        route_counts()
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
    lens = dict(lps=lps, lcs=lcs, hgs=hgs, d=d, pts=pts)
    slabs = (("axis", 0.0), ("seam", r_sw), ("rim", radius))
    t0 = time.perf_counter()
    with cpu_tables((*gcs, hgs)):
        slab_err, n_class = nearfield_slabs(nf, lens, out, LAM, slabs, dev)
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
    far_err = farfield_vs_cpu(ff, out, far, m, pts, LAM, 0.1, "8b")
    print(f"phase 8b far field vs CPU complex128 "
          f"({time.perf_counter() - t0:.1f} s): relative errors "
          f"{ {k: float(f'{v:.3e}') for k, v in far_err.items()} } (bound "
          f"{TOL_FARFIELD}; P as a share of its max)")
    require(max(far_err.values()) <= TOL_FARFIELD,
            f"8b far field vs CPU: {far_err}")
    del far, P

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
    return dict(lps=lps, lcs=lcs, hgs=hgs, d=d, pts=pts, out=out,
                xyrra=xyrra, gcs=gcs, r_sw=r_sw, radius=radius,
                config5=config5_card, t_config5=t_config5)


def rgb_lens_phase(dev, lens, results, path_launches):
    """Phase 8c: phase 8b's lens at benchmarks/northstar2.py's three
    wavelengths.  Its brackets and HexGridSet are characterized at 450 and
    650 nm as well (one joint sweep per member, appended to the 580 nm
    data as the port's collimator demo does), the interpolators rebuilt,
    the lens designed once, and at each wavelength the stitch on
    northstar2's grid for that wavelength, the far field and the focal
    metrics, held to CPU complex128 as 8b holds 580 nm."""
    import importlib
    import torch
    from metalens_tpu_torch.assembly import make_design
    from metalens_tpu_torch.engine import characterize_grating
    from metalens_tpu_torch.solver import inv, taylor
    nf = importlib.import_module("metalens_tpu_torch.nearfield")
    ff = importlib.import_module("metalens_tpu_torch.farfield")
    t8 = time.perf_counter()
    deg = math.pi / 180
    gcs, hgs, d, radius = (lens[k] for k in ("gcs", "hgs", "d", "radius"))
    objs = (*gcs, hgs)
    members = [g for gc in gcs for g in gc.grating_list]
    lams = [450 * NM, 650 * NM]
    want = sweep_launches(members + hgs.grating_list, lams)
    tables_580 = [dict(obj.interpolators) for obj in objs]
    # the centre's phase library stays 580 nm's, the design wavelength
    # (characterize takes it at the first wavelength of its call)
    x_amp_580 = hgs.x_amp_list
    times = {}
    reset_counts()
    with stage(times, "characterize 4 collections"):
        for gc in gcs:
            gc.characterize(lams, numG=CHAR_NUMG, u_steps=5, append=True)
    with stage(times, "characterize HexGridSet"):
        hgs.characterize(wavelength=lams, numG=CHAR_NUMG, just_normal=False,
                         u_steps=5, append=True)
    c = launch_counts()
    path_launches["characterize lens rgb"] = c
    results["cinv"]["route_launches_by_path"]["characterize lens rgb"] = \
        route_counts()
    hgs.x_amp_list = x_amp_580
    lams_nm = sorted({e["wavelength_in_nm"] for g in members + hgs.grating_list
                      for e in g.data})
    print(f"phase 8c characterize lens at 450 + 650 nm numG={CHAR_NUMG} "
          f"u_steps=5 (appended; wavelengths now {lams_nm} nm): "
          f"{len(members)} collection members and {len(hgs.grating_list)} "
          f"HexGridSet members; launches {c} (expected {want})")
    require(all(v > 0 for v in c.values()) and c == want,
            f"characterize lens rgb: launches {c}, expected {want}")
    require(lams_nm == [450, 580, 650], f"8c database wavelengths {lams_nm}")
    with stage(times, "interpolators"):
        for obj in objs:
            obj.build_interpolators()
    same = all(key in obj.interpolators
               and torch.equal(obj.interpolators[key].values, f.values)
               for obj, old in zip(objs, tables_580)
               for key, f in old.items())
    require(same, "8c: the 580 nm tables changed when 450/650 nm were "
            "appended")
    collections = [[(lo * deg, hi * deg), gc]
                   for (lo, hi), gc in zip(NS_BRACKETS, gcs)]
    with stage(times, "make_design"):
        lps, lcs, r_sw = make_design(collections, d, radius, hgs)
    require(r_sw == lens["r_sw"] and np.array_equal(lcs, lens["lcs"])
            and np.array_equal(lps["r_center_list"],
                               lens["lps"]["r_center_list"]),
            "8c: the design differs from 8b's")
    print(f"phase 8c design: {len(lps['r_center_list'])} rings, "
          f"{len(lcs)} centre sites, r_switch {r_sw * 1e6:.2f} um (8b's)")

    # the stitch, far field and focal metrics at each wavelength; the
    # stitch and the far field run no cell solve, so none of the kernels
    rgb = dict(lps=lps, lcs=lcs, hgs=hgs, d=d)
    fields = {}
    reset_counts()
    for lam_nm in (450, 580, 650):
        lam = lam_nm * NM
        t_lam = {}
        torch.cuda.reset_peak_memory_stats()
        out, far, m = lens_metrics(nf, ff, lps, lcs, hgs, d, 1.02 * radius,
                                   0.1, lam=lam, times=t_lam)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        n = len(out[4])
        P, tot, ux, uy, dux, duy = far
        print(f"phase 8c {lam_nm} nm: aperture {n} x {n} = {n * n} points; "
              f"transmission {m['transmission']:.6f}, spot fraction (0.1) "
              f"{m['spot_fraction_of_total']:.6f}, peak ({m['peak_ux']:.5f}, "
              f"{m['peak_uy']:.5f}) (bin {dux:.5f} x {duy:.5f}), total_P "
              f"{tot:.6e}, power through the lens {out[6]:.6e}; peak device "
              f"memory {peak_gib:.2f} GiB; stage times (CUDA events ms, host "
              f"ms): " + "; ".join(f"{k} {a:.1f}, {b:.1f}"
                                   for k, (a, b) in t_lam.items()))
        require(all(f.is_cuda and f.dtype == torch.complex64
                    and f.shape == (n, n) and bool(torch.isfinite(f).all())
                    for f in out[:4]), f"8c {lam_nm} nm near field: device, "
                f"dtype, shape or non-finite values")
        require(0 < m["transmission"] <= 1 and tot <= out[6],
                f"8c {lam_nm} nm physics: {m}, total_P {tot}, through the "
                f"lens {out[6]}")
        if lam_nm == 580:
            require(abs(m["peak_ux"]) <= dux and abs(m["peak_uy"]) <= duy,
                    f"8c 580 nm peak ({m['peak_ux']}, {m['peak_uy']}) beyond "
                    f"one bin ({dux}, {duy}) of (0, 0)")
        fields[lam_nm] = (out, far, m)
        times.update({f"{lam_nm} nm {k}": v for k, v in t_lam.items()})
    c = launch_counts()
    path_launches["lens check rgb"] = c
    print(f"phase 8c launches of the three stitches and far fields: {c} "
          f"(expected none)")
    require(not any(c.values()), f"lens check rgb: launches {c}")

    # each wavelength against CPU complex128: near-field slabs at the axis,
    # the seam and the rim from complex128 tables built on the CPU, and the
    # far field of the card's near field
    slabs = (("axis", 0.0), ("seam", r_sw), ("rim", radius))
    t0 = time.perf_counter()
    with cpu_tables(objs):
        for lam_nm, (out, far, m) in fields.items():
            lam = lam_nm * NM
            pts = out[4]
            slab_err, n_class = nearfield_slabs(
                nf, dict(rgb, pts=pts), out, lam, slabs, dev)
            far_err = farfield_vs_cpu(ff, out, far, m, pts, lam, 0.1,
                                      f"8c {lam_nm} nm")
            print(f"phase 8c {lam_nm} nm vs CPU complex128: near field "
                  f"(slabs of 8 x {len(pts)} points, max |diff| over Ex, "
                  f"Ey, Hx, Hy as a share of each field's max) "
                  f"{ {k: float(f'{v:.3e}') for k, v in slab_err.items()} } "
                  f"(bound {TOL_NEARFIELD}), points classified differently "
                  f"{n_class}; far field relative errors "
                  f"{ {k: float(f'{v:.3e}') for k, v in far_err.items()} } "
                  f"(bound {TOL_FARFIELD})")
            require(max(slab_err.values()) <= TOL_NEARFIELD,
                    f"8c {lam_nm} nm near field vs CPU: {slab_err}")
            require(max(far_err.values()) <= TOL_FARFIELD,
                    f"8c {lam_nm} nm far field vs CPU: {far_err}")
    print(f"phase 8c vs CPU complex128: {time.perf_counter() - t0:.1f} s")
    del fields, out, far

    # the kernels at the joint 450/650 nm inputs: one periphery member
    # sweep (B = 2 x 25) and one HexGridSet member sweep (B = 2 x 81)
    peri = dict(collection_sweep(gcs[0], 5, CHAR_NUMG), wavelength=lams)
    hexa = dict(ux_min=-0.499, ux_max=0.501, uy_min=-0.499, uy_max=0.501,
                u_steps=9, wavelength=lams, numG=CHAR_NUMG)
    runs = (lambda: characterize_grating(gcs[0].grating_list[0], **peri),
            lambda: characterize_grating(hgs.grating_list[0], **hexa))
    inv_caps = [a for run in runs for (a,) in capture(inv, "inv", run)]
    tay_caps = [c for run in runs
                for c in capture(taylor, "taylor_factors", run)]
    kernels_at_inputs(dev, results, inv_caps, tay_caps,
                      "characterize lens rgb", "phase 8c")
    print(f"phase 8c stage times (CUDA events ms, host ms): "
          + "; ".join(f"{k} {a:.1f}, {b:.1f}" for k, (a, b) in times.items()))
    print(f"phase 8c lens check at 450, 580 and 650 nm: "
          f"{time.perf_counter() - t8:.2f} s")


def rgb_terms():
    """benchmarks/northstar2.py's _rgb_terms on the port."""
    from metalens_tpu_torch.solver.fom import FomTerm
    return [FomTerm(lam * NM, 1.0, -1, inphase)
            for lam, inphase in NS2_RGB_TERMS]


def seed_grating(angle_deg, n_pillars):
    """benchmarks/northstar2.py's _seed_grating on the port: n pillars
    across the supercell with ramped radii, shrunk until validate()
    passes."""
    from metalens_tpu_torch import Grating, validate
    angle = angle_deg * math.pi / 180
    period_nm = 580.0 / math.sin(angle)
    rows = []
    for i in range(n_pillars):
        f = i / max(n_pillars - 1, 1)
        rows.append([-period_nm / 2 + (i + 0.5) * period_nm / n_pillars, 0.0,
                     60.0 + 55.0 * f, 68.0 + 42.0 * f, 0.0])
    g = Grating(lateral_period=320 * NM, cyl_height=550 * NM,
                target_wavelength=LAM, angle_in_air=angle,
                xyrra_list_in_nm_deg=np.array(rows))
    for _ in range(30):
        if validate(g):
            return g
        g.xyrra_list[:, 2:4] *= 0.95
    raise SystemExit(f"chip_smoke: no feasible seed at {angle_deg} deg")


@contextlib.contextmanager
def fused_spies(fused, rec):
    """Record, in ``rec``, the batch size of every FOM batch of the fused
    loops and the return of every coordinate-descent dispatch ("cd") and
    random-perturbation run ("rp")."""
    orig = fused._fom_eval, fused._cd_run, fused._rp_run

    def fom_spy(rows, *args, **kwargs):
        rec["batches"].append(rows.shape[0])
        return orig[0](rows, *args, **kwargs)

    def recording(make, key):
        def config(*static):
            run = make(*static)

            def rec_run(*args):
                out = run(*args)
                rec[key].append(out)
                return out
            return rec_run
        return config

    fused._fom_eval = fom_spy
    fused._cd_run = recording(orig[1], "cd")
    fused._rp_run = recording(orig[2], "rp")
    try:
        yield rec
    finally:
        fused._fom_eval, fused._cd_run, fused._rp_run = orig


def fused_phase(dev, results, path_launches):
    """Phase 9: the fused design loop on the card at the production design
    config (5 pillars, 19.7 deg, the RGB terms, numG = 50)."""
    import importlib
    import warnings
    import torch
    from metalens_tpu_torch import validate, vary_angle
    from metalens_tpu_torch.engine import static_solve_config
    from metalens_tpu_torch.grating import min_diameter, min_distance
    from metalens_tpu_torch.solver import inv, taylor
    fused = importlib.import_module("metalens_tpu_torch.optimize_fused")
    opt_module = importlib.import_module("metalens_tpu_torch.optimize")
    t9 = time.perf_counter()
    deg = math.pi / 180
    terms, numG, nE = rgb_terms(), NS2_DESIGN_NUMG, FUSED_PILLARS
    g0 = seed_grating(FUSED_ANGLE_DEG, nE)
    _, n_s, n_t, _ = static_solve_config(g0, [t.wavelength for t in terms],
                                         numG, torch.complex64)
    # per FOM batch and term: <<1/eps>>^-1, E^-1 at N, the slab, each
    # doubling, the inner and the outer star; one Taylor call
    per_batch = {"cinv": len(terms) * (5 + int(math.log2(n_s))),
                 "taylor": len(terms) * taylor_work(2 * numG, 1, n_t)[2],
                 "taylor_chunks": len(terms)}

    def fom_card(g):
        return g.fom(LAM, numG=numG, terms=terms)

    def member(g, seed, **kw):
        """optimize_fused then optimize2_fused on the card, timed by the
        host clock and by CUDA events; the loops' batches and returns."""
        rec = {"batches": [], "cd": [], "rp": []}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with fused_spies(fused, rec):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            g1 = fused.optimize_fused(g, LAM, numG=numG, terms=terms,
                                      seed=seed, verbose=False, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cd_batches = len(rec["batches"])
            g2 = fused.optimize2_fused(g1, LAM, attempts=FUSED_ATTEMPTS,
                                       numG=numG, terms=terms, seed=seed + 1,
                                       verbose=False, **kw)
            ev[2].record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        x, fom, tried, accepted = rec["rp"][-1]
        require(x.dtype == torch.float32 and fom.dtype == torch.float32
                and x.is_cuda, f"fused loop state {x.dtype} {fom.dtype} "
                f"{x.device}")
        rounds = sum(out[3] for out in rec["cd"])
        require(rec["cd"][-1][2], "optimize_fused ended without a stall")
        return g2, dict(
            wall_s=t2 - t0, cd_s=t1 - t0, rp_s=t2 - t1,
            cd_ms=ev[0].elapsed_time(ev[1]), rp_ms=ev[1].elapsed_time(ev[2]),
            rounds=rounds, cd_batches=cd_batches,
            rp_batches=len(rec["batches"]) - cd_batches, tried=tried,
            rp_accepted=int(accepted), fom=float(fom),
            batch_sizes=sorted(set(rec["batches"])))

    def report(label, info):
        r = info["rounds"]
        print(f"phase 9 {label}: {info['wall_s']:.2f} s (optimize_fused "
              f"{info['cd_s']:.2f} s: {r} rounds, {r - 1} accepted moves, "
              f"{info['cd_batches']} FOM batches, {info['cd_ms'] / r:.2f} ms "
              f"per round by CUDA events, {info['cd_s'] * 1e3 / r:.2f} ms by "
              f"the host clock; optimize2_fused {info['rp_s']:.2f} s: "
              f"{info['tried']} attempts, {info['rp_accepted']} accepted, "
              f"{info['rp_batches']} FOM batches, "
              f"{info['rp_ms'] / info['tried']:.2f} ms per attempt by CUDA "
              f"events, {info['rp_s'] * 1e3 / info['tried']:.2f} ms by the "
              f"host clock); batch sizes {info['batch_sizes']}")

    # 9a: benchmarks/bench_design_member_fused.py's member on the card
    f_start = fom_card(g0)
    reset_counts()
    g_m, info = member(g0, 1000)
    torch.cuda.synchronize()
    counts = launch_counts()
    path_launches[f"fused member numG={numG}"] = counts
    batches = info["cd_batches"] + info["rp_batches"]
    expect = {k: v * batches for k, v in per_batch.items()}
    report(f"9a member ({nE} pillars, {FUSED_ANGLE_DEG} deg, RGB terms, "
           f"numG={numG}, attempts={FUSED_ATTEMPTS})", info)
    print(f"phase 9a launches {counts} in {batches} FOM batches, expected "
          f"{expect} ({per_batch} per batch, {n_s} slabs, {n_t} Taylor "
          f"terms; a coordinate-descent round is 2 batches: "
          f"{ {k: 2 * v for k, v in per_batch.items()} })")
    require(all(v > 0 for v in counts.values()) and counts == expect,
            f"fused member launches {counts}, expected {expect}")
    f_end = fom_card(g_m)
    f_cpu = g_m.fom(LAM, numG=numG, terms=terms, device="cpu")
    ok = validate(g_m)
    print(f"phase 9a fom {f_start:.6f} (seed) -> {f_end:.6f} (Grating.fom "
          f"on the card); the loop returned {info['fom']:.6f}, |diff| "
          f"{abs(info['fom'] - f_end):.3e} (bound {TOL_FUSED_FOM}); CPU "
          f"complex128 {f_cpu:.6f}, |card - CPU| {abs(f_end - f_cpu):.3e} "
          f"(bound {TOL_GUARD}); validate: {ok}")
    require(ok, "the fused member fails validate")
    require(f_end >= f_start, f"fused member fom {f_start} -> {f_end}")
    require(abs(info["fom"] - f_end) <= TOL_FUSED_FOM,
            f"loop fom {info['fom']} vs Grating.fom {f_end}")
    require(abs(f_end - f_cpu) <= TOL_GUARD, f"card vs CPU: {f_end} {f_cpu}")

    # 9d: the same member again with the same seed
    g_again, info2 = member(g0, 1000)
    report("9d the same member again", info2)
    same = (np.array_equal(g_again.xyrra_list, g_m.xyrra_list)
            and info2["fom"] == info["fom"])
    print(f"phase 9d same seed, identical result: {same}")
    require(same, "the fused member is not reproducible on the card")

    # 9b: device feasibility in float32 (margin 1e-5) against the host's
    # float64 validate, around the seed under NS2's trust region
    rng = np.random.default_rng(9)
    sim = g0.xyrra_list
    n_geo = 400
    scale = np.geomspace(1.0, 40.0, n_geo)[:, None, None]
    xs = sim + rng.normal(size=(n_geo,) + sim.shape) * scale * NM
    xs[..., 4] = sim[:, 4] + (rng.normal(size=(n_geo, nE)) * scale[:, :, 0]
                              * 0.2 * deg)

    def f32(v):
        return torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=dev)
    dev_ok = fused.feasible_traced(
        f32(xs), g0.grating_period, g0.lateral_period, f32(min_diameter / 2),
        f32(min_distance), sim=f32(sim), how_similar=f32(NS2_SIMILARITY),
        margin=1e-5).cpu().numpy()
    host_ok = []
    for x in xs:
        gg = g0.copy()
        gg.xyrra_list = x
        host_ok.append(validate(gg, similar_to=sim,
                                how_similar=NS2_SIMILARITY))
    host_ok = np.array(host_ok)
    wrong = int((dev_ok & ~host_ok).sum())
    print(f"phase 9b feasible_traced on the card (float32, margin 1e-5) on "
          f"{n_geo} geometries: {int(dev_ok.sum())} accepted, host float64 "
          f"validate accepts {int(host_ok.sum())}; device accepts the host "
          f"refuses: {wrong}; host accepts the device refuses: "
          f"{int((host_ok & ~dev_ok).sum())}")
    require(wrong == 0 and dev_ok.sum() > 0,
            f"{wrong} device accepts fail the host's validate")

    # 9c: a continuation from the 9a member with NS2's steps, two members
    a0 = g_m.get_angle_in_air(LAM)
    rungs = [math.atan(NS2_CHANGE_EACH_STEP ** k * math.tan(a0))
             for k in (2, 3)]
    starts, members = [], []
    orig_cd, orig_rp = opt_module.optimize_fused, opt_module.optimize2_fused

    def cd_spy(g, **kw):
        starts.append(g.copy())
        return orig_cd(g, **kw)

    def rp_spy(g, **kw):
        members.append(orig_rp(g, **kw))
        return members[-1]
    opt_module.optimize_fused, opt_module.optimize2_fused = cd_spy, rp_spy
    try:
        t0 = time.perf_counter()
        gc = vary_angle(g_m, sum(rungs) / 2, "round", LAM, numG=numG,
                        terms=terms, use_fused=True,
                        optimize2_attempts=FUSED_ATTEMPTS, verbose=False,
                        change_each_step=NS2_CHANGE_EACH_STEP,
                        similarity_each_step=NS2_SIMILARITY,
                        rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        vary_s = time.perf_counter() - t0
    finally:
        opt_module.optimize_fused, opt_module.optimize2_fused = orig_cd, orig_rp
    require(len(gc.grating_list) == 3 and len(members) == 2,
            f"the continuation made {len(members)} members, expected 2")
    for k, (st, mem) in enumerate(zip(starts, members), start=1):
        ok = validate(mem, similar_to=st.xyrra_list,
                      how_similar=NS2_SIMILARITY)
        f0, f1 = fom_card(st), fom_card(mem)
        print(f"phase 9c member {k} ({mem.get_angle_in_air(LAM) / deg:.3f} "
              f"deg, period {mem.grating_period / NM:.1f} nm): fom "
              f"{f0:.6f} (resized seed) -> {f1:.6f}; validate under the "
              f"{NS2_SIMILARITY:.0%} trust region: {ok}")
        require(ok and f1 >= f0, f"continuation member {k}: {ok} {f0} {f1}")
    print(f"phase 9c vary_angle(use_fused=True), 2 members: {vary_s:.2f} s "
          f"({vary_s / 2:.2f} s per member)")

    # 9e: the kernels at the inputs of a screen batch (B = 2*nE*5) and of a
    # walk batch (B = 9) at the member, then the host reads and the device
    # time of one coordinate-descent round
    config, trust, cell, rdt = fused._member_inputs(
        g0, LAM, numG, terms, None, None, None, None, dev, None)
    fom1 = fused._fom_fn(*config)
    x = torch.as_tensor(g_m.xyrra_list, dtype=rdt, device=dev)
    dirs = fused._unit_directions(nE, rdt, dev)
    ks = torch.arange(2, 11, dtype=rdt, device=dev)
    screen = (x[None] + dirs).contiguous()
    walk = (x[None] + ks[:, None, None] * dirs[1]).contiguous()
    runs = [lambda: fom1(screen, *cell), lambda: fom1(walk, *cell)]
    with torch.no_grad():
        inv_caps = [A for run in runs for (A,) in capture(inv, "inv", run)]
        tay_caps = [c for run in runs
                    for c in capture(taylor, "taylor_factors", run)]
        kernels_at_inputs(dev, results, inv_caps, tay_caps,
                          f"fused member numG={numG}", "phase 9e",
                          numG=numG)
    del inv_caps, tay_caps

    x0 = torch.as_tensor(g0.xyrra_list, dtype=rdt, device=dev)
    draws = fused.TorchDraws(0, dev, rdt)
    run1, run3 = (fused._cd_run(*config, nE, r, 10) for r in (1, 3))

    def one_round():
        return run1(x0, *trust, draws, *cell)
    one_round()
    torch.cuda.synchronize()
    batch_sites = sync_sites(lambda: fom1(screen, *cell))
    round_sites = sync_sites(lambda: run3(x0, *trust, draws, *cell))
    in_batch = sum(v for k, v in batch_sites.items() if k != "(torch)")
    in_rounds = sum(v for k, v in round_sites.items() if k != "(torch)")
    print(f"phase 9e host syncs in the repo's code: one screen FOM batch "
          f"(B={2 * nE * 5}) {in_batch} {batch_sites}; one dispatch of 3 "
          f"rounds from the seed (its start's FOM batch, then 2 batches a "
          f"round) {in_rounds}, by site {round_sites}")
    require(in_batch == 0, f"host syncs inside a FOM batch: {batch_sites}")
    round_ms = batch_ms(one_round)
    print(f"phase 9e one dispatch of one round: {round_ms:.2f} ms of wall "
          f"(best of 3 windows of 2)")
    profile(one_round, "fused dispatch of one round", rows=12,
            wall_ms=round_ms)
    print(f"phase 9 fused design loop: {time.perf_counter() - t9:.2f} s")


def in_turns(label, twin, sharded, reps=1, warm=True,
             names=("unsharded", "sharded")):
    """The unsharded twin and the sharded path timed in turns (twin,
    sharded, sharded, twin), each by CUDA events and by the host clock
    around work that ends in a synchronize; returns the mean (events ms,
    host ms) per call of each.  ``names`` label the two in the line."""
    import torch
    if warm:
        twin()
        sharded()
    acc = {"twin": [], "sharded": []}
    for name in ("twin", "sharded", "sharded", "twin"):
        fn = twin if name == "twin" else sharded
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        acc[name].append((start.elapsed_time(end) / reps,
                          (time.perf_counter() - t0) * 1e3 / reps))
    out = {k: tuple(float(x) for x in np.mean(v, axis=0))
           for k, v in acc.items()}
    (te, th), (se, sh) = out["twin"], out["sharded"]
    a, b = names
    print(f"phase {label} in turns ({a}, {b}, {b}, {a}), ms per call by "
          f"CUDA events / host clock: {a} {te:.3f} / {th:.3f}, {b} "
          f"{se:.3f} / {sh:.3f}; {b} - {a} {sh - th:+.3f} ms of host time "
          f"({100 * (sh - th) / th:+.2f}%)")
    return out


def capture_kernels(run):
    """The inputs of every inverse and Taylor call during run(), detached
    (the kernels' raw wrappers refuse a gradient)."""
    import torch
    from metalens_tpu_torch.solver import inv, taylor
    tay = []
    inv_caps = capture(inv, "inv", lambda: tay.extend(
        capture(taylor, "taylor_factors", run)))

    def det(x):
        return x.detach() if torch.is_tensor(x) else x
    return ([det(A) for (A,) in inv_caps],
            [tuple(det(x) for x in c) for c in tay])


def parallel_phase(dev, results, path_launches, gd, gc7, lens):
    """Phase 10: the sharded paths of metalens_tpu_torch.parallel at full
    width through a one-rank NCCL process group on the card, each held to
    the unsharded port call on the same card and timed beside it."""
    import importlib
    import tempfile
    import torch
    import torch.distributed as dist
    from metalens_tpu_torch import parallel
    from metalens_tpu_torch.engine import (_direction_grid, _fom_inputs,
                                           characterize_grating,
                                           fom_value_and_grad,
                                           static_solve_config)
    from metalens_tpu_torch.materials import resolve_indices
    from metalens_tpu_torch.parallel import dryrun
    from metalens_tpu_torch.parallel.mesh import Mesh
    from metalens_tpu_torch.solver import orders as ordmod
    nf = importlib.import_module("metalens_tpu_torch.nearfield")
    ff = importlib.import_module("metalens_tpu_torch.farfield")
    fused = importlib.import_module("metalens_tpu_torch.optimize_fused")
    t10 = time.perf_counter()
    # the one-rank group bootstraps over loopback: the machine may have no
    # other network interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        parallel.init_distributed(f"file://{tmp}/store", 1, 0, device="cuda",
                                  timeout=600)
        try:
            require(dist.get_backend() == "nccl",
                    f"process group backend {dist.get_backend()}")
            mesh = parallel.make_mesh()
            # the same card without the group: the collectives are skipped
            local = Mesh(0, 1, mesh.device)
            print(f"phase 10 process group: backend {dist.get_backend()}, "
                  f"world {dist.get_world_size()}, rank {mesh.rank}, device "
                  f"{mesh.device}, NCCL {torch.cuda.nccl.version()}")
            t0 = time.perf_counter()
            dryrun.dryrun_multichip(1, device="cuda")
            print(f"phase 10 dry run of the six paths at the dry run's "
                  f"shapes on the card: {time.perf_counter() - t0:.2f} s")

            # 10a: the sharded FOM + gradient step at the bench cell
            numG, B = 50, 64
            orders, n_s, n_t, _, tgt, inph, per_term = _fom_inputs(
                gd, LAM, numG, None, torch.complex64)
            eps_p, eps_g, lam, ux, ngs, cth, w = per_term
            T = len(tgt)
            rng = np.random.default_rng(10)
            xy = np.stack([gd.xyrra_list + rng.normal(
                scale=NM, size=gd.xyrra_list.shape) * [1, 1, 1, 1, 0]
                for _ in range(B)])
            args = (xy, np.full(B, LX), np.full(B, LY), H, np.array(eps_p),
                    np.array(eps_g), np.array(lam), np.tile(ux, (B, 1)),
                    np.array(ngs), np.tile(cth, (B, 1)), np.array(w))
            step = parallel.sharded_fom_and_grad(mesh, orders, n_s, tgt,
                                                 inph, taylor_terms=n_t)
            want = {"cinv": T * (5 + int(math.log2(n_s))),
                    "taylor": T * taylor_work(2 * numG, 1, n_t)[2],
                    "taylor_chunks": T}
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            fom, grad = step(*args)
            torch.cuda.synchronize()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            c = launch_counts()
            label = f"sharded fom+grad numG={numG} B={B}"
            path_launches[label] = c
            results["cinv"]["route_launches_by_path"][label] = route_counts()
            print(f"phase 10a {label} ({T} terms, {n_s} slabs, {n_t} "
                  f"Taylor terms): mean fom {fom.item():.7f}; launches {c} "
                  f"(expected {want}: the forward's); peak device memory "
                  f"{peak_gib:.3f} GiB")
            require(c == want and all(v > 0 for v in c.values()),
                    f"10a launches {c}, expected {want}")
            require(fom.dtype == grad.dtype == torch.float32 and grad.is_cuda
                    and grad.shape == (B, 2, 5)
                    and bool(torch.isfinite(grad).all()),
                    f"10a: {fom.dtype} {grad.dtype} {tuple(grad.shape)}")
            vg = fom_value_and_grad(gd, LAM, numG)
            t0 = time.perf_counter()
            per = [vg(x) for x in xy]
            torch.cuda.synchronize()
            loop_ms = (time.perf_counter() - t0) * 1e3
            f_ref = torch.stack([f for f, _ in per]).mean()
            g_ref = torch.stack([g for _, g in per]) / B
            d_fom = abs(fom.item() - f_ref.item()) / abs(f_ref.item())
            d_gmax = ((grad - g_ref).abs().max() / g_ref.abs().max()).item()
            d_grad = ((grad - g_ref).norm() / g_ref.norm()).item()
            picks = [0, B // 3, 2 * B // 3, B - 1]
            with cpu_threads(1):
                vg_cpu = fom_value_and_grad(gd, LAM, numG, device="cpu")
                g_cpu = [vg_cpu(xy[b])[1] for b in picks]
            d_cpu = max(((grad[b].cpu().double() * B - g).norm()
                         / g.norm()).item() for b, g in zip(picks, g_cpu))
            print(f"phase 10a vs fom_value_and_grad on the card, cell by "
                  f"cell ({B} calls, {loop_ms:.1f} ms): mean fom rel err "
                  f"{d_fom:.3e}, gradient |dgrad|/|grad| {d_grad:.3e} (bound "
                  f"2e-5; max err / max {d_gmax:.3e}); {len(picks)} cells' "
                  f"gradients vs CPU complex128 "
                  f"|dgrad|/|grad| {d_cpu:.3e} (bound {TOL_GRAD})")
            require(d_fom <= 2e-5 and d_grad <= 2e-5,
                    f"10a vs fom_value_and_grad: {d_fom}, {d_grad}")
            require(d_cpu <= TOL_GRAD, f"10a vs CPU complex128: {d_cpu}")
            inv_caps, tay_caps = capture_kernels(lambda: step(*args))
            with torch.no_grad():
                kernels_at_inputs(dev, results, inv_caps, tay_caps, label,
                                  "phase 10a", numG=numG)
            del inv_caps, tay_caps, per
            step_local = parallel.sharded_fom_and_grad(
                local, orders, n_s, tgt, inph, taylor_terms=n_t)
            times = in_turns("10a (twin: the same step without the group)",
                             lambda: step_local(*args), lambda: step(*args),
                             reps=3)
            profile(lambda: step(*args), f"10a {label}", rows=12,
                    wall_ms=times["sharded"][1])
            # a training loop keeps its tables on the card: the same step
            # on device tensors, sliced there, equals the host arrays' step
            dargs = tuple(torch.as_tensor(a, device=mesh.device)
                          if isinstance(a, np.ndarray) else a for a in args)
            fom_d, grad_d = step(*dargs)
            d_tab = max(abs(fom_d.item() - fom.item()) / abs(fom.item()),
                        ((grad_d - grad).abs().max()
                         / grad.abs().max()).item())
            print(f"phase 10a on device tables against host arrays: max "
                  f"rel diff {d_tab:.3e} (bound 1e-6; identical: "
                  f"{d_tab == 0})")
            require(d_tab <= 1e-6, f"10a on device tables: {d_tab}")
            dtimes = in_turns("10a inputs (host arrays against device "
                              "tables)", lambda: step(*args),
                              lambda: step(*dargs), reps=3,
                              names=("host arrays", "device tables"))
            profile(lambda: step(*dargs), f"10a {label} on device tables",
                    rows=4, wall_ms=dtimes["sharded"][1])
            print(f"phase 10a host syncs by site (set_sync_debug_mode), one "
                  f"step on host arrays: {sync_sites(lambda: step(*args))}; "
                  f"on device tables: {sync_sites(lambda: step(*dargs))}")

            # 10b: the characterize sweep over phase 7's collection, four
            # periods in one (direction x cell) batch
            members = gc7.grating_list
            sw = collection_sweep(gc7, 5, CHAR_NUMG)
            uxg, uyg = _direction_grid(sw["ux_min"], sw["ux_max"],
                                       sw["uy_min"], sw["uy_max"], 5)
            cells = [(g, a, b) for a, b in zip(uxg, uyg) for g in members]
            n_g, n_t7 = resolve_indices(members[0].n_glass,
                                        members[0].n_tio2, LAM)
            cargs = (np.stack([g.xyrra_list for g, _, _ in cells]),
                     np.array([g.grating_period for g, _, _ in cells]),
                     np.array([g.lateral_period for g, _, _ in cells]), H,
                     complex(n_t7) ** 2, complex(n_g) ** 2, LAM,
                     np.array([x[1] for x in cells]),
                     np.array([x[2] for x in cells]))
            ch = parallel.sharded_characterize_amps(mesh, CHAR_NUMG, None)
            want = sweep_launches(members, [LAM])
            reset_counts()
            ampf, ampr = ch(*cargs)
            torch.cuda.synchronize()
            c = launch_counts()
            label = f"sharded characterize numG={CHAR_NUMG} B={len(cells)}"
            path_launches[label] = c
            results["cinv"]["route_launches_by_path"][label] = route_counts()
            require(c == want and all(v > 0 for v in c.values()),
                    f"10b launches {c}, expected {want}")
            require(ampf.dtype == torch.complex64 and ampf.shape == (
                len(cells), 2, 2 * CHAR_NUMG), f"10b ampf {ampf.dtype} "
                f"{tuple(ampf.shape)}")
            af, ar = ampf.cpu().numpy(), ampr.cpu().numpy()
            worst, n_entries = 0.0, 0
            for m, g in enumerate(members):
                o = ordmod.select_orders(g.grating_period, g.lateral_period,
                                         CHAR_NUMG)
                for e in g.data:
                    if e["wavelength_in_nm"] != 580.0:
                        continue
                    b = next(k for k in range(m, len(cells), len(members))
                             if abs(cells[k][1] - e["ux"]) < 1e-12
                             and abs(cells[k][2] - e["uy"]) < 1e-12)
                    i = ordmod.order_index(o, e["ox"], e["oy"])
                    p = 0 if e["x_or_y"] == "y" else 1
                    got = (af[b, p, i], af[b, p, i + CHAR_NUMG],
                           ar[b, p, i], ar[b, p, i + CHAR_NUMG])
                    worst = max(worst, max(abs(x - e[k])
                                           for x, k in zip(got, AMPS)))
                    n_entries += 1
            print(f"phase 10b {label} ({len(members)} periods "
                  f"{[round(g.grating_period / NM, 1) for g in members]} nm, "
                  f"{len(uxg)} directions): launches {c} (expected {want}); "
                  f"{n_entries} database entries of phase 7 at 580 nm, max "
                  f"|diff| {worst:.3e} (bound 2e-5)")
            require(n_entries > 0 and worst <= 2e-5,
                    f"10b vs phase 7's databases: {worst} over {n_entries}")
            inv_caps, tay_caps = capture_kernels(lambda: ch(*cargs))
            kernels_at_inputs(dev, results, inv_caps, tay_caps, label,
                              "phase 10b")
            del inv_caps, tay_caps
            one = dict(ux_min=sw["ux_min"], ux_max=sw["ux_max"],
                       uy_min=sw["uy_min"], uy_max=sw["uy_max"], u_steps=5,
                       wavelength=LAM, numG=CHAR_NUMG)
            in_turns("10b (twin: characterize_grating per member)",
                     lambda: [characterize_grating(g, **one)
                              for g in members], lambda: ch(*cargs))

            # 10c: the stitch of phase 8b's lens, rows over the ranks
            lps, lcs, hgs, d, pts, out8 = (lens[k] for k in (
                "lps", "lcs", "hgs", "d", "pts", "out"))

            def stitch_sharded():
                return parallel.build_nearfield_sharded(
                    mesh, 0.0, 0.0, -d, "x", LAM, lps, lcs, hgs, pts, pts,
                    dipole_moment=1e-30)

            def stitch():
                return nf.build_nearfield(0.0, 0.0, -d, "x", LAM, lps, lcs,
                                          hgs, pts, pts, dipole_moment=1e-30)
            got = stitch_sharded()
            n = len(pts)
            nf_err = max(np.abs(f - r.cpu().numpy()).max()
                         / r.abs().max().item()
                         for f, r in zip(got[:4], out8[:4]))
            p_err = abs(got[6] - out8[6]) / out8[6]
            print(f"phase 10c build_nearfield_sharded {n} x {n}: fields "
                  f"{got[0].dtype} on the host, max |diff| vs phase 8b's "
                  f"build_nearfield {nf_err:.3e} of each field's max (bound "
                  f"1e-6), power through the lens {got[6]:.6e} rel err "
                  f"{p_err:.3e} (bound 1e-6)")
            require(got[0].shape == (n, n) and nf_err <= 1e-6
                    and p_err <= 1e-6, f"10c: {nf_err}, {p_err}")
            in_turns("10c (twin: build_nearfield)", stitch, stitch_sharded)

            # 10d: the distributed fft2 and the far field of 10c's fields
            gen = torch.Generator(device=dev).manual_seed(10)
            z = torch.view_as_complex(torch.randn(n, n, 2, generator=gen,
                                                  device=dev))
            fft2 = parallel.fft2_sharded(mesh)
            f_err = ((fft2(z) - torch.fft.fft2(z)).abs().max()
                     / torch.fft.fft2(z).abs().max()).item()
            P, tot, *_ = parallel.farfield_sharded(mesh, *got[:4], pts, pts,
                                                   LAM, got[7])
            Pr, totr, *_ = ff.farfield(*got[:4], pts, pts, LAM, got[7])
            fin = torch.isfinite(Pr)
            require(bool((torch.isfinite(P) == fin).all()),
                    "10d: finite bins differ from farfield's")
            ff_err = ((P - Pr)[fin].abs().max() / Pr[fin].max()).item()
            tot_err = abs(tot - totr) / totr
            print(f"phase 10d fft2_sharded {n} x {n} complex64 vs "
                  f"torch.fft.fft2: max err / max {f_err:.3e} (bound 1e-5); "
                  f"farfield_sharded vs farfield: P {ff_err:.3e} of its max, "
                  f"total_P {tot_err:.3e} (bound 1e-5)")
            require(f_err <= 1e-5 and ff_err <= 1e-5 and tot_err <= 1e-5,
                    f"10d: {f_err}, {ff_err}, {tot_err}")
            in_turns("10d fft2 (twin: torch.fft.fft2)",
                     lambda: torch.fft.fft2(z), lambda: fft2(z), reps=5)
            in_turns("10d far field (twin: farfield)",
                     lambda: ff.farfield(*out8[:4], pts, pts, LAM, got[7]),
                     lambda: parallel.farfield_sharded(
                         mesh, *out8[:4], pts, pts, LAM, got[7]), reps=3)
            del got, P, Pr, z

            # 10e: the member design, NS2's 5-pillar member on this rank
            terms, nE = rgb_terms(), FUSED_PILLARS
            g0 = seed_grating(FUSED_ANGLE_DEG, nE)
            caps = dict(max_rounds_per_dispatch=8, max_dispatches=2,
                        attempts=10)
            seed = 1000
            _, n_s, n_t, _ = static_solve_config(
                g0, [t.wavelength for t in terms], NS2_DESIGN_NUMG,
                torch.complex64)
            per_batch = {"cinv": len(terms) * (5 + int(math.log2(n_s))),
                         "taylor": len(terms) * taylor_work(
                             2 * NS2_DESIGN_NUMG, 1, n_t)[2],
                         "taylor_chunks": len(terms)}

            def sharded_member():
                return parallel.sharded_member_optimize(
                    mesh, [g0], LAM, numG=NS2_DESIGN_NUMG, terms=terms,
                    seeds=[seed], verbose=False, **caps)

            def member_alone():
                config, trust, cell, rdt = fused._member_inputs(
                    g0, LAM, NS2_DESIGN_NUMG, terms, None, None, None, None,
                    dev, None)
                cd = fused._cd_run(*config, nE,
                                   caps["max_rounds_per_dispatch"], 10)
                draws = fused.TorchDraws(seed, dev, rdt)
                x = torch.as_tensor(g0.xyrra_list, dtype=rdt, device=dev)
                for _ in range(caps["max_dispatches"]):
                    x, _, stalled, _ = cd(x, *trust, draws, *cell)
                    if stalled:
                        break
                sc = np.empty_like(g0.xyrra_list)
                sc[:, 0:4] = 1 * NM
                sc[:, 4] = 0.1 * math.pi / 180
                sc /= g0.xyrra_list.size
                x, fom, _, _ = fused._rp_run(*config, nE, 10)(
                    x, *trust, fused.TorchDraws(seed + 1, dev, rdt),
                    caps["attempts"], torch.as_tensor(sc, dtype=rdt,
                                                      device=dev), *cell)
                g = g0.copy()
                g.xyrra_list = x.cpu().numpy().astype(np.float64)
                g.standardize()
                return g, float(fom)
            rec = {"batches": [], "cd": [], "rp": []}
            reset_counts()
            with fused_spies(fused, rec):
                des, foms = sharded_member()
            torch.cuda.synchronize()
            c = launch_counts()
            label = f"sharded member design numG={NS2_DESIGN_NUMG}"
            path_launches[label] = c
            results["cinv"]["route_launches_by_path"][label] = route_counts()
            batches = len(rec["batches"])
            want = {k: v * batches for k, v in per_batch.items()}
            g_alone, f_alone = member_alone()
            same = (np.array_equal(des[0].xyrra_list, g_alone.xyrra_list)
                    and foms[0] == f_alone)
            print(f"phase 10e {label} (NS2's {nE}-pillar member, seed "
                  f"{seed}, {caps}): fom {foms[0]:.6f} in {batches} FOM "
                  f"batches (sizes {sorted(set(rec['batches']))}); launches "
                  f"{c} (expected {want}); the member alone through _cd_run "
                  f"/ _rp_run: fom {f_alone:.6f}, identical xyrra and fom: "
                  f"{same}")
            require(c == want and all(v > 0 for v in c.values()),
                    f"10e launches {c}, expected {want}")
            require(same, "10e: the sharded member differs from the member "
                    "alone")
            in_turns("10e (twin: the member alone)", member_alone,
                     sharded_member, warm=False)
        finally:
            dist.destroy_process_group()
    print(f"phase 10 sharded paths: {time.perf_counter() - t10:.2f} s")



# ---- phase 11: the physics checks, the native export and the demo --------

def _load_oracle(name):
    """A numpy oracle of the tests (tests/<name>.py), loaded by path: it
    imports nothing of JAX or of the repo's packages."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phys_schedule(orders, L, Ly, h, eps_max, dtype, terms64):
    """(n_slabs, taylor_terms): complex64 takes the production float32
    schedule (rcwa.slab_schedule), complex128 the reference tests' pairing
    (default_n_slabs over q2_upper_bound, with their series length)."""
    import torch
    from metalens_tpu_torch.solver import rcwa
    k0h = 2 * np.pi * h / LAM
    if dtype == torch.complex64:
        return rcwa.slab_schedule(k0h, orders, L, Ly, LAM, eps_max,
                                  dtype=torch.float32)
    q2 = rcwa.q2_upper_bound(orders, L, Ly, LAM, eps_max)
    return rcwa.default_n_slabs(k0h, q2), terms64


def eig_cells(B, seed=11):
    """B random two-pillar cells (tests/test_lossy_and_random.py's draw:
    pillars near x = -+Lx/3, radii 60-110 nm, rotations +-0.6, ux in
    [0.1, 0.6], uy in [-0.2, 0.2]), redrawn while an order of the
    numG = PHYS_NUMG set lies within 0.02 of the light cone in air or glass
    (|K|^2 against 1 and NG^2): the 1/kz basis there amplifies rounding."""
    from metalens_tpu_torch.solver import orders as ordmod
    rng = np.random.default_rng(seed)
    o = ordmod.select_orders(LX, LY, PHYS_NUMG)
    xy, u = [], []
    while len(xy) < B:
        cell = [[x0 + rng.uniform(-30, 30) * NM, rng.uniform(-20, 20) * NM,
                 rng.uniform(60, 110) * NM, rng.uniform(60, 110) * NM,
                 rng.uniform(-0.6, 0.6)] for x0 in (-LX / 3, LX / 3)]
        ux, uy = rng.uniform(0.1, 0.6), rng.uniform(-0.2, 0.2)
        k2 = ((ux + o[:, 0] * LAM / LX) ** 2 + (uy + o[:, 1] * LAM / LY) ** 2)
        if min(np.abs(k2 - 1).min(), np.abs(k2 - NG ** 2).min()) < 0.02:
            continue
        xy.append(cell)
        u.append((ux, uy))
    return np.array(xy), np.array(u)


def physics_checks(device, dtype, tmm, rcwa1d, eig_rows):
    """The independent physics checks of one cell solve on ``device`` in
    ``dtype``, at the bench cell's width (numG = PHYS_NUMG; the lamellar
    line has 2 * LAMELLAR_M + 1 orders): a uniform slab against TMM, three
    lamellar gratings against the 1D RCWA, the reciprocity identities and
    energy of lossless and lossy pillars with NV off and on, and random
    cells (``eig_rows`` of them compared) against the port's eigenmode
    reference.  Returns the worst error of each check, the calls' shapes
    (for the launch schedule) and the times (CUDA events when on CUDA)."""
    import torch
    from metalens_tpu_torch.solver import (checks, epsilon, orders as ordmod,
                                           rcwa)
    from metalens_tpu_torch.solver.eig import reference_cell_smatrix
    rdt = {torch.complex64: torch.float32,
           torch.complex128: torch.float64}[dtype]
    kw = dict(dtype=rdt, device=device)
    err, calls, times = {}, [], {}
    timer = functools.partial(
        stage if torch.device(device).type == "cuda" else host_stage, times)

    def solved(label, S, B, n2, ns, nt, n_small):
        require(S.s11.dtype == dtype and S.s11.device.type ==
                torch.device(device).type and bool(torch.isfinite(
                    torch.view_as_real(S.s11)).all()),
                f"{label}: {S.s11.dtype} on {S.s11.device}, or non-finite")
        calls.append(dict(label=label, B=B, n2=n2, n_slabs=ns, terms=nt,
                          n_small=n_small))

    # 1: air / (n = 2) uniform slab / glass, rect_layer_toeplitz at fill 1
    with timer("TMM"):
        o = ordmod.select_orders(LX, LY, PHYS_NUMG)
        N, i0 = len(o), ordmod.order_index(o, 0, 0)
        ns, nt = _phys_schedule(o, LX, LY, H, 4.0, dtype, 12)
        E = epsilon.rect_layer_toeplitz(o, LX, LY, (0.0, 0.0), (LX, LY),
                                        4.0 + 0j, device=device, dtype=dtype)
        ux = torch.tensor([math.sin(t) for t in TMM_THETAS], **kw)
        S, Kx, Ky = rcwa.cell_smatrix_with_eps(
            o, E.expand(len(TMM_THETAS), N, N).contiguous(), LX, LY, H,
            NG ** 2, LAM, ux, 0.0, n_slabs=ns, taylor_terms=nt)
        solved("TMM", S, len(TMM_THETAS), 2 * N, ns, nt, 1)
        worst = 0.0
        for pol in ("s", "p"):
            t, r = checks.order_efficiencies(S, Kx, Ky, checks.incident_vector(
                ux, torch.zeros_like(ux), pol, i0, N), NG ** 2, NG)
            for k, theta in enumerate(TMM_THETAS):
                R_ref, T_ref = tmm.tmm_rt([1.0, 2.0, NG], [H], LAM, theta,
                                          pol)
                worst = max(worst, abs(t[k].sum().item() - T_ref),
                            abs(r[k].sum().item() - R_ref))
        err["TMM"] = worst

    # 2: lamellar gratings (tests/test_lamellar_independent.py's cases)
    with timer("lamellar"):
        m = np.arange(-LAMELLAR_M, LAMELLAR_M + 1)
        o = np.stack([m, np.zeros_like(m)], axis=1)
        L = 900 * NM
        E = torch.stack([epsilon.rect_layer_toeplitz(
            o, L, LY, (0.0, 0.0), (fill * L, LY), complex(epsf),
            device=device, dtype=dtype) for _, fill, epsf in LAMELLAR])
        ns, nt = _phys_schedule(o, L, LY, H, max(abs(c[2]) for c in LAMELLAR),
                                dtype, 12)
        th = [math.radians(c[0]) for c in LAMELLAR]
        ux = torch.tensor([math.sin(t) for t in th], **kw)
        S, Kx, Ky = rcwa.cell_smatrix_with_eps(o, E, L, LY, H, NG ** 2, LAM,
                                               ux, 0.0, n_slabs=ns,
                                               taylor_terms=nt)
        solved("lamellar", S, len(LAMELLAR), 2 * len(m), ns, nt, 1)
        worst = 0.0
        for pol in ("s", "p"):
            t, r = checks.order_efficiencies(S, Kx, Ky, checks.incident_vector(
                ux, torch.zeros_like(ux), pol, LAMELLAR_M, len(m)),
                NG ** 2, NG)
            for k, (theta, (_, fill, epsf)) in enumerate(zip(th, LAMELLAR)):
                m1, r1, t1 = rcwa1d.lamellar_rcwa(
                    pol, LAM, L, H, epsf, 1.0, 1.0, NG ** 2, theta,
                    M=LAMELLAR_M, fill=fill)
                require((m1 == m).all(), "lamellar order lines differ")
                worst = max(worst, np.abs(t[k].cpu().numpy() - t1).max(),
                            np.abs(r[k].cpu().numpy() - r1).max())
        err["lamellar"] = worst

    # 3 + 4: reciprocity at (ux, uy) against (-ux, -uy) in one batch, and
    # energy, for lossless and absorbing pillars, NV off and on
    _, o, perm = checks.negation_closed_orders(LX, LY, PHYS_NUMG)
    N, i0 = len(o), ordmod.order_index(o, 0, 0)
    xy = torch.as_tensor(np.stack([BASE, BASE]), **kw)
    u = torch.tensor([RECIP_U[0], -RECIP_U[0]], **kw)
    v = torch.tensor([RECIP_U[1], -RECIP_U[1]], **kw)
    recip, energy, absorbed = 0.0, 0.0, float("inf")
    with timer("reciprocity + energy"):
        for eps_p in (NT ** 2 + 0j, NT ** 2 + 0.4j):
            lossless = eps_p.imag == 0
            ns, nt = _phys_schedule(o, LX, LY, H, abs(eps_p), dtype, 10)
            for fff in (False, True):
                S, Kx, Ky = rcwa.cell_smatrix(
                    o, xy, LX, LY, H, eps_p, NG ** 2, LAM, u, v,
                    n_slabs=ns, taylor_terms=nt, fff=fff,
                    hermitian_eps=lossless)
                solved(f"reciprocity eps={eps_p} fff={fff}", S, 2, 2 * N,
                       ns, nt, (2 if fff else 1) if lossless else 0)
                one = [rcwa.SMatrix(*(x[k:k + 1] for x in S)) for k in (0, 1)]
                res = checks.reciprocity_residuals(
                    one[0], one[1], perm,
                    checks.flux_form(Kx[:1], Ky[:1], 1.0, 1.0),
                    checks.flux_form(Kx[:1], Ky[:1], NG ** 2, NG))
                recip = max(recip, max(r.max().item() for r in res.values()))
                for pol in ("s", "p"):
                    t, r = checks.order_efficiencies(
                        S, Kx, Ky, checks.incident_vector(u, v, pol, i0, N),
                        NG ** 2, NG)
                    tot = (t.sum(-1) + r.sum(-1)).cpu().numpy()
                    if lossless:
                        energy = max(energy, np.abs(tot - 1).max())
                    else:
                        absorbed = min(absorbed, (1 - tot).min())
    err["reciprocity"], err["energy"] = recip, energy
    err["absorbed (min)"] = absorbed

    # 5: random cells against the eigenmode reference, all four blocks
    with timer("eigenmode"):
        cells, dirs = eig_cells(EIG_CELLS)
        o = ordmod.select_orders(LX, LY, PHYS_NUMG)
        ns, nt = _phys_schedule(o, LX, LY, H, NT ** 2, dtype, 12)
        S, _, _ = rcwa.cell_smatrix(
            o, torch.as_tensor(cells, **kw), LX, LY, H, NT ** 2, NG ** 2, LAM,
            torch.as_tensor(dirs[:, 0], **kw),
            torch.as_tensor(dirs[:, 1], **kw), n_slabs=ns, taylor_terms=nt)
        solved("eigenmode", S, EIG_CELLS, 2 * len(o), ns, nt, 1)
        blocks = {k: getattr(S, k).cpu().numpy() for k in S._fields}
    t0 = time.perf_counter()
    worst = {k: 0.0 for k in blocks}
    for b in range(eig_rows):
        ref, _, _ = reference_cell_smatrix(o, cells[b], LX, LY, H, NT ** 2,
                                           NG ** 2, LAM, *dirs[b])
        for k in blocks:
            want = getattr(ref, k)
            worst[k] = max(worst[k], np.abs(blocks[k][b] - want).max()
                           / np.abs(want).max())
    times["eigenmode reference (host)"] = (
        None, (time.perf_counter() - t0) * 1e3)
    err.update({f"eigenmode {k}": e for k, e in worst.items()})
    return err, calls, times


@contextlib.contextmanager
def host_stage(times, name):
    """Time the block by the host clock alone (CPU work), in ms."""
    t0 = time.perf_counter()
    yield
    times[name] = (None, (time.perf_counter() - t0) * 1e3)


def physics_launches(calls):
    """The kernel launches of the physics calls on CUDA: per call the
    N-size inverses (E^-1, and <<1/eps>>^-1 with NV; none for absorbing
    eps, which takes the pivoted solve), at 2N the slab, each doubling and
    the two conversion stars; one Taylor call."""
    out = {"cinv": 0, "taylor": 0, "taylor_chunks": 0}
    for c in calls:
        out["cinv"] += c["n_small"] + 3 + int(math.log2(c["n_slabs"]))
        out["taylor"] += taylor_work(c["n2"], c["B"], c["terms"])[2]
        out["taylor_chunks"] += 1
    return out


def _fmt_times(times):
    return "; ".join(f"{k} {'-' if a is None else f'{a:.1f}'}, {b:.1f}"
                     for k, (a, b) in times.items())


def physics_phase(dev, results, path_launches):
    """Phase 11a: the physics checks on the card in complex64 (both
    kernels) against the oracles, each also through the port in complex128
    on the CPU; launches against the schedule; the kernels against their
    plain versions on this path's inputs."""
    import torch
    t11 = time.perf_counter()
    tmm, rcwa1d = _load_oracle("tmm_reference"), _load_oracle(
        "rcwa1d_reference")
    reset_counts()
    holder = {}
    inv_caps, tay_caps = capture_kernels(lambda: holder.update(
        out=physics_checks(dev, torch.complex64, tmm, rcwa1d, EIG_CELLS)))
    torch.cuda.synchronize()
    counts = launch_counts()
    err, calls, times = holder["out"]
    want = physics_launches(calls)
    path_launches["physics"] = counts
    print(f"phase 11a physics on the card (complex64, numG={PHYS_NUMG}): "
          f"{len(calls)} cell solves "
          f"{[(c['label'], c['B'], c['n2'], c['n_slabs'], c['terms']) for c in calls]}; "
          f"launches {counts} (expected {want})")
    print(f"phase 11a times (CUDA events ms, host ms): {_fmt_times(times)}")
    require(all(v > 0 for v in counts.values()) and counts == want,
            f"physics launches {counts}, expected {want}")
    from metalens_tpu_torch.solver import epsilon, orders as ordmod
    o = ordmod.select_orders(LX, LY, PHYS_NUMG)
    sites = sync_sites(lambda: epsilon.rect_layer_toeplitz(
        o, LX, LY, (0.0, 0.0), (LX, LY), 4.0 + 0j, device=dev))
    print(f"phase 11a host syncs in rect_layer_toeplitz on the card: "
          f"{sites or 'none'}")
    require(not sites, f"rect_layer_toeplitz synchronizes: {sites}")
    with cpu_threads(8):
        err64, _, times64 = physics_checks("cpu", torch.complex128, tmm,
                                           rcwa1d, EIG_CPU_CELLS)
    print(f"phase 11a the same checks through the port in complex128 on the "
          f"CPU ({EIG_CPU_CELLS} eigenmode cells; host ms): "
          f"{_fmt_times(times64)}")
    for name in err:
        if name == "absorbed (min)":
            print(f"phase 11a absorbed share of the lossy pillars (least): "
                  f"card {err[name]:.4f}, CPU complex128 {err64[name]:.4f} "
                  f"(must exceed {TOL_PHYS})")
            require(min(err[name], err64[name]) > TOL_PHYS,
                    f"the absorbing pillars absorb {err[name]}")
            continue
        bound64 = PHYS_TOL64[name.split()[0]]
        print(f"phase 11a {name}: card {err[name]:.3e} (bound {TOL_PHYS}), "
              f"CPU complex128 {err64[name]:.3e} (bound {bound64})")
        require(err[name] <= TOL_PHYS and err64[name] <= bound64,
                f"physics {name}: card {err[name]}, CPU {err64[name]}")
    kernels_at_inputs(dev, results, inv_caps, tay_caps, "physics",
                      "phase 11a", numG=PHYS_NUMG)
    print(f"phase 11a physics: {time.perf_counter() - t11:.2f} s")


def gds_boundary_count(path):
    """Minimal GDSII record walk: the number of BOUNDARY records, checking
    that the records tile the file."""
    with open(path, "rb") as f:
        raw = memoryview(f.read())
    i, n, size = 0, 0, len(raw)
    while i < size:
        length = (raw[i] << 8) | raw[i + 1]
        require(length >= 4, f"GDS record of length {length} at {i}")
        if raw[i + 2] == 0x08 and raw[i + 3] == 0x00:
            n += 1
        i += length
    require(i == size, "GDS records overrun the file")
    return n


def export_phase(lens):
    """Phase 11b: the native exporter built from the checkout, the whole
    lens of phase 8b written natively, the native files against the Python
    writers byte for byte on its first and last EXPORT_CHECK pillars, and
    the GDS read back."""
    from metalens_tpu_torch import export
    xyrra = lens["xyrra"]
    n = len(xyrra)
    outdir = os.path.join(REPO, "build", "export_check")
    os.makedirs(outdir, exist_ok=True)
    times = {}
    with stage(times, "build"):
        export._native_lib()
    makers = {"dxf": export.make_dxf, "svg": export.make_svg,
              "gds": export.make_gds}
    for fmt, make in makers.items():
        path = os.path.join(outdir, f"lens.{fmt}")
        with stage(times, f"native {fmt}"):
            make(xyrra, path, use_native=True)
        size = os.path.getsize(path)
        if fmt == "gds":
            with stage(times, "gds walk"):
                n_bound = gds_boundary_count(path)
            require(n_bound == n, f"GDS holds {n_bound} boundaries, the "
                    f"lens {n} pillars")
        os.remove(path)
        sec = times[f"native {fmt}"][1] / 1e3
        print(f"phase 11b native {fmt}: {n} pillars, {size / 2 ** 20:.1f} MiB "
              f"in {sec:.2f} s ({n / sec:,.0f} pillars/s)"
              + (f"; read back: {n_bound} boundaries" if fmt == "gds" else ""))
    # the first pillars are the centre's circles, the last the periphery's
    # ellipses (polylines and rotated ellipses)
    for end, part in (("first", xyrra[:EXPORT_CHECK]),
                      ("last", xyrra[-EXPORT_CHECK:])):
        circles = int((part[:, 2] == part[:, 3]).sum())
        for fmt, make in makers.items():
            paths = [os.path.join(outdir, f"{end}_{k}.{fmt}")
                     for k in ("native", "python")]
            make(part, paths[0], use_native=True)
            with stage(times, f"python {fmt} ({end})"):
                make(part, paths[1], use_native=False)
            with open(paths[0], "rb") as f1, open(paths[1], "rb") as f2:
                same = f1.read() == f2.read()
            for p in paths:
                os.remove(p)
            print(f"phase 11b {end} {len(part)} pillars ({circles} circles), "
                  f"{fmt}: native and Python writers byte-identical: {same}")
            require(same, f"native {fmt} differs from the Python writer on "
                    f"the {end} pillars")
    print(f"phase 11b times (CUDA events ms, host ms): {_fmt_times(times)}")


def demo_phase():
    """Phase 11c: the port's collimator demo end to end on the card, in a
    subprocess at its defaults with --rgb, its printed lines parsed."""
    import re
    from metalens_tpu_torch.geometry import good_fft_number
    from metalens_tpu_torch.materials import n_glass
    outdir = os.path.join(REPO, "build", "demo_out")
    cmd = [sys.executable, "-m", "metalens_tpu_torch.examples.collimator_demo",
           "--rgb", "--outdir", outdir]
    times = {}
    with stage(times, "demo"):
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=DEMO_TIMEOUT_S)
    for line in proc.stdout.splitlines():
        print(f"phase 11c | {line}")
    require(proc.returncode == 0, f"the demo exited {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    out = proc.stdout
    members = int(re.search(r"collection: (\d+) members", out).group(1))
    pillars = int(re.search(r"lens: (\d+) pillars", out).group(1))
    metrics = {int(w): tuple(map(float, vals)) for w, *vals in re.findall(
        r"\[(\d+)nm\] transmission: ([-\d.]+)\s+peak \(ux, uy\) = "
        r"\(([-\d.]+), ([-\d.]+)\)\s+0\.1-cone fraction: ([-\d.]+)", out)}
    sizes = {f: os.path.getsize(os.path.join(outdir, f"collimator.{f}"))
             for f in ("dxf", "svg", "gds")}
    # the far field's bin at 580 nm: the demo's aperture (radius 10.9 um,
    # 1.05 of it on each side) at good_fft_number points
    half = 10.9e-6 * 1.05
    n_pts = good_fft_number(2 * half / (LAM / 2.2))
    bin_u = (LAM / n_glass(LAM)) / (2 * half / (n_pts - 1) * n_pts)
    t580, pux, puy, cone = metrics[580]
    print(f"phase 11c demo: {members} members, {pillars} pillars (JAX demo "
          f"documents about 75 and 1,700); export sizes {sizes} bytes; "
          f"wall {times['demo'][1] / 1e3:.1f} s")
    for w, doc in ((450, 0.725), (580, 0.843), (650, 0.884)):
        t, ux, uy, c = metrics[w]
        print(f"phase 11c {w} nm: transmission {t:.3f} (JAX demo documents "
              f"{doc}), peak ({ux:.3f}, {uy:.3f}), 0.1-cone fraction "
              f"{c:.3f}")
    require(members > 1 and pillars > 0 and all(sizes.values()),
            f"demo: {members} members, {pillars} pillars, sizes {sizes}")
    require(set(metrics) == {450, 580, 650}, f"demo wavelengths {metrics}")
    require(abs(pux) <= bin_u and abs(puy) <= bin_u and t580 >= 0.75,
            f"demo at 580 nm: peak ({pux}, {puy}) against a bin of "
            f"{bin_u:.4f}, transmission {t580}")
    print(f"phase 11c 580 nm: peak within one bin ({bin_u:.4f}) of (0, 0), "
          f"transmission {t580:.3f} >= 0.75")


# ---- phase 12: benchmarks/run_configs.py configs 1-4 through the port ----

def _seeded():
    """``random`` and ``numpy.random`` seeded to 0, as for the JAX run of
    each config (CONFIGS_JAX)."""
    import random
    random.seed(0)
    np.random.seed(0)


def config1_hex_phase_sweep():
    """run_configs.py config1_hex_phase_sweep at --scale small."""
    from metalens_tpu_torch import HexGridSet
    hgs = HexGridSet(sep=320 * NM, cyl_height=H, num_entries=8)
    hgs.characterize(wavelength=LAM, numG=30, just_normal=True)
    phases = np.unwrap(np.angle(hgs.x_amp_list))
    return dict(phase_span_rad=float(abs(phases[-1] - phases[0]))), (
        lambda: hgs.grating_list[0].characterize(
            wavelength=LAM, numG=30, just_normal=True))


def config2_optimize_rgb():
    """run_configs.py config2_optimize_rgb at --scale small (numG = 25,
    25 gradient steps, then optimize2 with 5 attempts), with the FOM after
    optimize_gradient as well."""
    from metalens_tpu_torch import Grating
    from metalens_tpu_torch.engine import fom_value_and_grad
    from metalens_tpu_torch.optimize import optimize_gradient, optimize2
    from metalens_tpu_torch.solver.fom import FomTerm
    terms = [FomTerm(650 * NM, 1.0, -1, False), FomTerm(LAM, 1.0, -1, True),
             FomTerm(500 * NM, 1.0, -1, False)]
    g = Grating(lateral_period=320 * NM, cyl_height=H, target_wavelength=LAM,
                angle_in_air=30 * math.pi / 180,
                xyrra_list_in_nm_deg=np.array([[0., 0., 120., 90., 0.],
                                               [500., 10., 80., 110., 5.]]))
    kw = dict(target_wavelength=LAM, numG=25, terms=terms)
    f0 = g.fom(**kw)
    g_opt = optimize_gradient(g, steps=25, verbose=False, **kw)
    f_grad = g_opt.fom(**kw)
    g_opt = optimize2(g_opt, attempts=5, verbose=False, **kw)
    out = dict(fom_start=f0, fom_after_gradient=f_grad, fom_end=g_opt.fom(**kw))
    return out, lambda: fom_value_and_grad(g, **kw)(g.xyrra_list)


def config3_vary_angle_characterize():
    """run_configs.py config3_vary_angle_characterize at --scale small
    (numG = 20, to 29.4 deg, 8 gradient steps and 2 optimize2 attempts a
    member; the database at numG = 40, u_steps = 5), with each member's
    FOM as well."""
    from metalens_tpu_torch import Grating
    from metalens_tpu_torch.engine import characterize_grating
    from metalens_tpu_torch.optimize import vary_angle
    from metalens_tpu_torch.solver.fom import FomTerm
    terms = [FomTerm(LAM, 1.0, -1, True)]
    g0 = Grating(lateral_period=320 * NM, cyl_height=H, target_wavelength=LAM,
                 angle_in_air=30 * math.pi / 180,
                 xyrra_list_in_nm_deg=np.array([[0., 0., 110., 90., 0.]]))
    gc = vary_angle(start_grating=g0, end_angle=29.4 * math.pi / 180,
                    lens_type="cyl", target_wavelength=LAM, numG=20,
                    terms=terms, use_gradient=True, gradient_steps=8,
                    optimize2_attempts=2, verbose=False)
    gc.characterize(LAM, numG=40, u_steps=5)
    gc.build_interpolators()
    out = dict(members=len(gc.grating_list),
               db_entries=sum(len(g.data) for g in gc.grating_list),
               member_foms=[g.fom(LAM, numG=20, terms=terms)
                            for g in gc.grating_list])
    sweep = dict(collection_sweep(gc, 5, 40), wavelength=LAM)
    return out, lambda: characterize_grating(gc.grating_list[-1], **sweep)


def config4_assembly_nearfield(device="cuda"):
    """run_configs.py config4_assembly_nearfield at --scale small (radius
    7.5 um, source 25 um, numG = 20), with this script's round_collection
    in place of tests/test_full_lens.py::make_round_collection.  As there,
    "_out" carries the near field (and its points) to config 5."""
    import importlib
    from metalens_tpu_torch import HexGridSet
    from metalens_tpu_torch.assembly import make_design
    from metalens_tpu_torch.geometry import good_fft_number
    nf = importlib.import_module("metalens_tpu_torch.nearfield")
    deg = math.pi / 180
    d, radius = 25e-6, 7.5e-6
    gc = round_collection(8.0, math.degrees(math.atan(radius / d)) + 1)
    gc.characterize(wavelength=LAM, numG=20, u_steps=3, device=device)
    gc.build_interpolators(device=device)
    hgs = HexGridSet(sep=320 * NM, cyl_height=H, num_entries=5)
    hgs.characterize(wavelength=LAM, numG=20, just_normal=False, u_steps=3,
                     device=device)
    hgs.build_interpolators(device=device)
    lps, lcs, r_switch, xyrra = make_design(
        [[(8.0 * deg, math.atan(radius / d) + 1 * deg), gc]], d, radius, hgs,
        make_xyrra_list=True)
    half = radius * 1.05
    n_pts = good_fft_number(2 * half / (LAM / 2.2))
    x_pts = np.linspace(-half, half, n_pts)
    out = nf.build_nearfield(0.0, 0.0, -d, "x", LAM, lps, lcs, hgs, x_pts,
                             x_pts, dipole_moment=1e-30, device=device)
    return (dict(pillars=int(xyrra.shape[0]), aperture_pts=n_pts * n_pts,
                 _out=(out, x_pts)),
            lambda: hgs.grating_list[0].characterize(
                wavelength=LAM, numG=20, just_normal=False, ux_min=-0.499,
                ux_max=0.501, uy_min=-0.499, uy_max=0.501, u_steps=5,
                device=device))


def configs_phase(dev, lens, results, path_launches):
    """Phase 12: benchmarks/run_configs.py configs 1-4 at --scale small
    through the port on the card, each seeded as the JAX run was and held
    to the JAX package's values (CONFIGS_JAX); config 5 is phase 8a."""
    import torch
    from metalens_tpu_torch.solver import inv, taylor
    t12 = time.perf_counter()
    runs = {1: config1_hex_phase_sweep, 2: config2_optimize_rgb,
            3: config3_vary_angle_characterize,
            4: config4_assembly_nearfield}
    inv_caps, tay_caps = [], []
    for k, run in runs.items():
        _seeded()
        reset_counts()
        t0 = time.perf_counter()
        got, one_call = run()
        wall = time.perf_counter() - t0
        near = got.pop("_out", None)
        c = launch_counts()
        path_launches[f"config {k}"] = c
        want = CONFIGS_JAX[k]
        print(f"phase 12 config {k} on the card: {wall:.2f} s, launches "
              f"{c}; port {got}; JAX package (CPU, float32) {want}")
        require(all(v > 0 for v in c.values()),
                f"config {k}: a kernel did not launch: {c}")
        if k == 1:
            err = abs(got["phase_span_rad"] - want["phase_span_rad"])
            require(err <= TOL_CONFIG1, f"config 1 phase span: |diff| {err}")
        elif k == 2:
            errs = {key: abs(got[key.replace("_same_draws", "")] - v)
                    for key, v in want.items()}
            print(f"phase 12 config 2 |port - JAX| "
                  f"{ {key: float(f'{e:.3e}') for key, e in errs.items()} } "
                  f"(bounds {TOL_CONFIG2})")
            require(all(errs[key] <= TOL_CONFIG2[key] for key in errs)
                    and got["fom_end"] >= got["fom_after_gradient"],
                    f"config 2: {got} against {want}")
        elif k == 3:
            errs = [abs(a - b) for a, b in zip(got["member_foms"],
                                               want["member_foms"])]
            print(f"phase 12 config 3 member FOMs |port - JAX| "
                  f"{[float(f'{e:.3e}') for e in errs]} (bound "
                  f"{TOL_CONFIG3_FOM})")
            require(got["members"] == want["members"]
                    and got["db_entries"] == want["db_entries"]
                    and max(errs) <= TOL_CONFIG3_FOM,
                    f"config 3: {got} against {want}")
        else:
            out, n = near[0], len(near[1])
            require(all(f.is_cuda and f.dtype == torch.complex64
                        and f.shape == (n, n)
                        and bool(torch.isfinite(f).all()) for f in out[:4]),
                    "config 4 near field: device, dtype, shape or non-finite "
                    "values")
            require(got == want, f"config 4: {got} against {want}")
        # the kernels at one call of the config's path (not counted; the
        # gradient's inputs detached: the raw kernels are forward-only)
        inv_caps += [a.detach() for (a,) in capture(inv, "inv", one_call)]
        tay_caps += [tuple(x.detach() if torch.is_tensor(x) else x
                           for x in c)
                     for c in capture(taylor, "taylor_factors", one_call)]
    kernels_at_inputs(dev, results, inv_caps, tay_caps, "configs 1-4",
                      "phase 12", numG=None)
    m = lens["config5"]
    print(f"phase 12 config 5 (phase 8a, not rerun): {lens['t_config5']:.2f} "
          f"s on the card, transmission {m['transmission']:.6f}, spot "
          f"fraction {m['spot_fraction_of_total']:.6f}; JAX package "
          f"{CONFIG5_JAX}")
    print(f"phase 12 configs: {time.perf_counter() - t12:.2f} s")


def main():
    """Every phase, with the port's trace registry recording (the launch
    counters and the build spans are read from it)."""
    sys.path.insert(0, REPO)
    from metalens_tpu_torch import trace
    with trace.collect():
        run_phases()


def run_phases():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA GPU")
    from metalens_tpu_torch import _cuda, trace
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
    builds = {k.rsplit(".", 1)[1]: v["host_ms"] / 1e3
              for k, v in trace.snapshot()["spans"].items()
              if k.startswith("cuda.build.")}
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in builds.items())}"
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
    path_launches, path_routes = {}, {}
    amps = {}
    for G, run, B, sched in ((numG, main_path, BATCH, (ns, terms)),
                             (100, path100, BATCH // 4, (ns100, terms100))):
        label = f"numG={G}"
        reset_counts()
        af, ar, _, _ = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        path_launches[label] = counts
        path_routes[label] = route_counts()
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
    require(all(v > 0 for v in launch_counts().values()),
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
    from metalens_tpu_torch import (GratingCollection, fom_value_and_grad,
                                    optimize_gradient, resize, validate,
                                    vary_angle)
    from metalens_tpu_torch.engine import fom_of_grating, static_solve_config
    from metalens_tpu_torch.solver.fom import DEFAULT_FOM_TERMS
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
    counts = launch_counts()
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
    reset_counts()
    t0 = time.perf_counter()
    gc = vary_angle(gd, sum(rung) / 2, "cyl", LAM, numG=numG,
                    optimize2_attempts=20, verbose=False,
                    rng=np.random.default_rng(3))
    torch.cuda.synchronize()
    vary_s = time.perf_counter() - t0
    batches = trace.snapshot()["counters"].get("optimize.probe_batches", 0)
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
    gc7 = characterize_phase(dev, gd, results, path_launches)

    # ---- phase 8: the lens check ----------------------------------------
    lens = lens_phase(dev, results, path_launches)
    rgb_lens_phase(dev, lens, results, path_launches)

    # ---- phase 9: the fused design loop ----------------------------------
    fused_phase(dev, results, path_launches)

    # ---- phase 10: the sharded paths through a NCCL process group -------
    parallel_phase(dev, results, path_launches, gd, gc7, lens)

    # ---- phase 11: physics checks, native export, the demo --------------
    physics_phase(dev, results, path_launches)
    export_phase(lens)
    demo_phase()

    # ---- phase 12: run_configs.py configs 1-4 through the port ----------
    configs_phase(dev, lens, results, path_launches)

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
