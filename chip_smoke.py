#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (metalens_tpu_torch) on one NVIDIA GPU.

Builds the port's hand-written CUDA kernels from ``metalens_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card at the inputs the
main path gives it, drives the main path -- the unit-cell RCWA solve at the
bench cell (numG = 50, NV on, B = 1024 cells, complex64) and the FOM entry
points -- and checks the results against the committed float64 truth, the
path with the plain versions in place of the kernels, and CPU complex128
runs.  It also times the path with the kernels against the path with the
plain versions, in turns, at numG = 50 and numG = 100, and prints the
torch.profiler device time by kernel of each.

    python3 chip_smoke.py

Every phase is fatal: a failed check exits nonzero.  The last two lines of
standard output are a JSON object describing each kernel (launches in the
main-path run, error against the plain version, times) and
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
BATCH = 1024


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


def profile(fn, label, rows=10):
    """One call of fn under torch.profiler: total self device time and the
    kernels that take most of it."""
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
    print(f"profile {label}: self device time {total:.3f} ms, "
          f"wall {wall:.3f} ms under the profiler")
    for e in sorted(events, key=dev_us, reverse=True)[:rows]:
        print(f"profile {label}:   {dev_us(e) / 1e3:9.3f} ms "
              f"{e.count:5d} calls  {e.key[:80]}")


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
    t0 = time.perf_counter()
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
    gen = torch.Generator(device="cpu").manual_seed(1)
    err_abs = 0.0
    for n in (50, 100, 200):
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
    # conversion star at 2N
    expected = 5 + int(math.log2(ns))
    worst = 0.0
    for label, run, n_s, stride in (("numG=50", main_path, ns, 1),
                                    ("numG=100", path100, ns100, 4)):
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
            A100 = next(a for (a,) in caps if a.shape[-1] == 2 * numG)
        del caps, W, R
    require(worst <= TOL_INV, f"inverse vs plain on the main path: {worst}")
    # timed on the main path's own slab matrices (B = 1024, n = 100); the
    # result of the timed kernel calls is held to the plain version too
    held = {}
    k_ms, p_ms = ab_ms(lambda: inv.inv_reference(A100),
                       lambda: held.update(W=inv.inv_cuda(A100)), 20)
    rel, _ = rel_err(held["W"], inv.inv_reference(A100))
    print(f"phase 2 time B={A100.shape[0]} n={A100.shape[-1]} (main-path "
          f"slab matrices): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
          f"timed result rel err vs plain {rel:.3e}")
    require(rel <= TOL_INV, f"timed inverse vs plain: {rel}")
    results["cinv"] = dict(
        route="cuda", source="metalens_tpu_torch/csrc/cinv.cu",
        replaces="metalens_tpu/solver/pallas_inv.py:175",
        max_abs_err=err_abs, ms=k_ms, plain_ms=p_ms)
    del A100, held

    # ---- phase 3: Taylor kernel vs taylor_factors_reference ------------
    # F and G of the main path's own call at numG = 50 (B = 1024) and
    # numG = 100 (B = 256); t varies along the batch
    err_abs = 0.0
    times = {}
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
        coeffs = taylor.coeff_table(t, n_terms, B, dev)
        td = t.to(dev)
        times[n] = ab_ms(
            lambda: taylor.taylor_factors_reference(F, Gm, td, n_terms),
            lambda: taylor.taylor_factors_cuda(F, Gm, coeffs, n_terms), 5)
        print(f"phase 3 time B={B} n={n} terms={n_terms}: kernel "
              f"{times[n][0]:.3f} ms, plain {times[n][1]:.3f} ms")
        del F, Gm, got, want
    results["taylor"] = dict(
        route="cuda", source="metalens_tpu_torch/csrc/taylor.cu",
        replaces="metalens_tpu/solver/pallas_taylor.py:96",
        max_abs_err=err_abs, ms=times[100][0], plain_ms=times[100][1])

    # ---- phase 4: the main path (bench cell, B=1024, complex64) --------
    inv.launches = 0
    taylor.launches = 0
    ampf, ampr, _, _ = main_path()
    torch.cuda.synchronize()
    launches = {"cinv": inv.launches, "taylor": taylor.launches}
    print(f"phase 4 main path numG={numG} B={BATCH} schedule=({ns},{terms}): "
          f"launches {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path did not launch: {launches}")
    require(ampf.shape == (BATCH, 2 * numG, 2) and ampf.dtype ==
            torch.complex64, f"ampf {tuple(ampf.shape)} {ampf.dtype}")
    require(bool(torch.isfinite(torch.view_as_real(ampf)).all())
            and bool(torch.isfinite(torch.view_as_real(ampr)).all()),
            "non-finite amplitudes")
    # every cell against the same path with the plain versions (complex64)
    with plain_versions():
        pf, pr, _, _ = main_path()
    plain_err = max((ampf - pf).abs().max().item(),
                    (ampr - pr).abs().max().item())
    print(f"phase 4 all {BATCH} cells, kernels vs plain versions: max err "
          f"{plain_err:.3e} (bound {TOL_GUARD})")
    require(plain_err <= TOL_GUARD, f"main path vs plain: {plain_err}")
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
    del pf, pr

    # end to end, kernels against plain versions, in turns on this card
    modes = {"kernels": {}, "plain": dict(inverse=True, taylor_factors=True),
             "plain inverse only": dict(inverse=True, taylor_factors=False),
             "plain Taylor only": dict(inverse=False, taylor_factors=True)}
    turns = {50: ("plain", "kernels", "plain inverse only",
                  "plain Taylor only", "kernels", "plain"),
             100: ("plain", "kernels", "kernels", "plain")}
    e2e = {}
    for G, run, B in ((50, main_path, BATCH), (100, path100, BATCH // 4)):
        for mode in turns[G]:
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
    inv.launches = taylor.launches = 0
    f_gpu = g.fom(target_wavelength=LAM, numG=numG, device="cuda")
    require(inv.launches > 0 and taylor.launches > 0,
            "Grating.fom on CUDA launched no kernel")
    f_cpu = g.fom(target_wavelength=LAM, numG=numG, device="cpu")
    print(f"phase 5 Grating.fom numG={numG}: cuda {f_gpu:.6f}, "
          f"cpu complex128 {f_cpu:.6f}")
    require(abs(f_gpu - f_cpu) <= TOL_GUARD, "Grating.fom cuda vs cpu")
    cand = np.stack([g.xyrra_list + rng.normal(scale=3 * NM,
                                               size=g.xyrra_list.shape)
                     * [1, 1, 1, 1, 0] for _ in range(20)])
    fb_gpu = fom_batch_fn(g, LAM, numG, device="cuda")(cand)
    fb_cpu = fom_batch_fn(g, LAM, numG, device="cpu")(cand)
    require(fb_gpu.dtype == torch.float32 and fb_gpu.shape == (20,),
            f"fom_batch_fn {fb_gpu.dtype} {tuple(fb_gpu.shape)}")
    fb_err = float((fb_gpu.cpu().double() - fb_cpu).abs().max())
    print(f"phase 5 fom_batch_fn B=20: max |cuda - cpu| = {fb_err:.3e}")
    require(fb_err <= TOL_GUARD, f"fom_batch_fn cuda vs cpu: {fb_err}")

    kernels = [dict(name=name, launches=launches[name], **r)
               for name, r in results.items()]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
