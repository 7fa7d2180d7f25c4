"""Entry hooks of the port: the flagship forward step and a multi-rank dry
run of every sharded path.

Counterpart of ``__graft_entry__.py``.  :func:`entry` returns the forward
step at the heart of optimization, characterize sweeps and the benchmark:
a batched unit-cell RCWA figure-of-merit solve.  :func:`dryrun_multichip`
runs all six sharded paths of :mod:`metalens_tpu_torch.parallel` over an
n-rank world at tiny shapes: the sharded FOM + gradient step with an
update, the characterize sweep, the near-field stitch, the distributed
fft2 (against ``torch.fft.fft2``), the far field and the member design.

On the CPU it starts n gloo ranks itself, by the ``spawn`` method, with a
file store under a work directory (no TCP port).  The rank function lives
in this module, so a spawned rank imports torch and the port and nothing
else.  On CUDA the ranks are one process per card: a launcher (such as
``torchrun``) starts them and joins them to a NCCL group, or, for one
rank, this module makes the group itself; NCCL takes one rank per card.

    python -m metalens_tpu_torch.parallel.dryrun --ranks 2 --device cpu
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

NM = 1e-9
LX, LY, LAM, H = 1200 * NM, 320 * NM, 580 * NM, 550 * NM
LX2 = 1100 * NM            # the second period of the two-period batches
NT, NG = 2.372, 1.459
BASE = np.array([[-215 * NM, 2 * NM, 144 * NM, 111 * NM, 0.0],
                 [196 * NM, -8 * NM, 100 * NM, 130 * NM, 0.1]])
NM_DEG = np.array([1 / NM] * 4 + [180 / math.pi])   # SI -> nm and degrees
# the sweep's term: (wavelength, target order, in phase, ux, weight)
SWEEP_TERMS = ((LAM, -1, True, 0.3, 1.0),)
# the characterize sweep: numG = 14 selects other order sets at LX and LX2
CHAR_NUMG = 14
CHAR_DIRECTIONS = dict(ux_min=0.3, ux_max=0.6, uy_min=-0.1, uy_max=0.1,
                       u_steps=2)
LENS_NUMG, LENS_POINTS = 10, 48
FFT_SHAPE = (48, 40)
DESIGN_NUMG, DESIGN_ATTEMPTS = 3, 10


def _tiny_problem(numG=9, B=8, dtype=torch.float64):
    """The dry run's cell batch: ``bench.py``'s cell (two pillars) with
    2 nm of seeded noise per cell, its order set at ``LX`` and the slab
    schedule for the working ``dtype``."""
    from ..solver import orders as ordmod, rcwa
    orders = ordmod.select_orders(LX, LY, numG)
    n_slabs, taylor = rcwa.slab_schedule(2 * np.pi * H / LAM, orders, LX,
                                         LY, LAM, NT ** 2, dtype=dtype)
    rng = np.random.default_rng(0)
    xyrra = np.stack([BASE + rng.normal(scale=2 * NM, size=BASE.shape)
                      for _ in range(B)])
    return dict(orders=orders, n_slabs=n_slabs, taylor=taylor, xyrra=xyrra)


def entry(*, device="cuda"):
    """(fn, example_args): the forward step -- one batched unit-cell
    S-matrix solve and the figure of merit of the order -1 at 580 nm,
    ``fn(xyrra_batch, ux_batch) -> FOM (B,)`` -- on ``device``."""
    from ..engine import _device
    from ..solver import cpx, orders as ordmod, rcwa
    from ..solver.fom import term_score
    from .sweep import incidence_sp
    device = _device(device)
    rdt = cpx.real_dtype(cpx.complex_dtype(device))
    p = _tiny_problem(numG=25, B=4, dtype=rdt)
    orders = p["orders"]
    N = len(orders)
    i0 = ordmod.order_index(orders, 0, 0)
    im1 = ordmod.order_index(orders, -1, 0)

    def forward(xyrra_batch, ux_batch):
        u = ux_batch
        ampf, _, _, _ = rcwa.cell_amplitudes(
            orders, xyrra_batch, LX, LY, H, NT ** 2, NG ** 2, LAM, u, 0.0,
            incidence_sp(u, N, i0, cpx.to_complex(rdt)),
            n_slabs=p["n_slabs"], taylor_terms=p["taylor"], fff=True,
            want_reflection=False)
        return term_score(ampf[:, im1, 0], ampf[:, im1 + N, 1], NG,
                          torch.sqrt(1.0 - u * u), True)

    example_args = (torch.as_tensor(p["xyrra"], dtype=rdt, device=device),
                    torch.linspace(0.4, 0.5, 4, dtype=rdt, device=device))
    return forward, example_args


def sweep_inputs(p):
    """The sharded step's global inputs for the batch ``p``: cells
    alternate between the periods ``LX`` and ``LX2``, with the terms of
    ``SWEEP_TERMS``.  Returns (target_idx, inphase, args)."""
    from ..materials import resolve_indices
    from ..solver import orders as ordmod
    B = len(p["xyrra"])
    Lx = np.where(np.arange(B) % 2, LX2, LX)
    eps_p, eps_g, ng, idx = [], [], [], []
    for lam, order, _, _, _ in SWEEP_TERMS:
        n_g, n_t = resolve_indices(0, 0, lam)
        eps_p.append(complex(n_t) ** 2)
        eps_g.append(complex(n_g) ** 2)
        ng.append(float(n_g))
        idx.append(ordmod.order_index(p["orders"], order, 0))
    ux = np.array([[t[3] for t in SWEEP_TERMS]] * B)
    args = (p["xyrra"], Lx, np.full(B, LY), H, np.array(eps_p),
            np.array(eps_g), np.array([t[0] for t in SWEEP_TERMS]), ux,
            np.array(ng), np.sqrt(1 - ux ** 2),
            np.array([t[4] for t in SWEEP_TERMS]))
    return tuple(idx), tuple(t[2] for t in SWEEP_TERMS), args


def characterize_members():
    """Two cells of the dry run's geometry at the periods ``LX`` and
    ``LX2``."""
    from ..grating import Grating
    return [Grating(lateral_period=LY, grating_period=lx, cyl_height=H,
                    xyrra_list_in_nm_deg=BASE * NM_DEG)
            for lx in (LX, LX2)]


def characterize_shared_config(dtype):
    """The characterize sweep in the JAX package's form: one order set and
    one slab schedule for every cell, those ``characterize_grating`` takes
    at the first member's period.  Returns (orders, n_slabs, taylor)."""
    from ..engine import static_solve_config
    orders, n_slabs, taylor, _ = static_solve_config(
        characterize_members()[0], [LAM], CHAR_NUMG, dtype)
    return orders, n_slabs, taylor


def characterize_inputs(members):
    """The (direction x cell) batch of ``characterize_grating``'s direction
    grid over ``members``, direction-major (so every rank's block holds
    every period)."""
    from ..engine import _direction_grid
    ux, uy = _direction_grid(**CHAR_DIRECTIONS)
    cells = [(g, a, b) for a, b in zip(ux, uy) for g in members]
    return (np.stack([g.xyrra_list for g, _, _ in cells]),
            np.array([g.grating_period for g, _, _ in cells]),
            np.array([g.lateral_period for g, _, _ in cells]), H,
            NT ** 2, NG ** 2, LAM, np.array([c[1] for c in cells]),
            np.array([c[2] for c in cells]))


def tiny_lens(device):
    """A 5.5 um lens: one round collection of three unoptimized two-pillar
    cells over 15-32 deg and a 3-entry HexGridSet, characterized on
    ``device`` at numG = 10, and its 48 x 48 aperture.  Returns (lps, lcs,
    hgs, pts)."""
    from ..assembly import make_design
    from ..grating import Grating, GratingCollection
    from ..hexgrid import HexGridSet
    angles = np.linspace(15, 32, 3) * math.pi / 180
    lpt = LY / math.tan(angles[1])
    gs = [Grating(lateral_period=lpt * math.tan(a), cyl_height=H,
                  grating_period=LAM / math.sin(a),
                  xyrra_list_in_nm_deg=[[-580 / math.sin(a) / 4, 0, 90, 70, 0],
                                        [580 / math.sin(a) / 4, 0, 70, 80, 0]])
          for a in angles]
    gc = GratingCollection(LAM, lpt, "round", gs)
    gc.characterize(LAM, numG=LENS_NUMG, u_steps=2, device=device)
    gc.build_interpolators(device=device)
    hgs = HexGridSet(sep=LY, cyl_height=H, num_entries=3)
    hgs.characterize(LAM, numG=LENS_NUMG, just_normal=False, u_steps=2,
                     device=device)
    hgs.build_interpolators(device=device)
    lps, lcs, _ = make_design([[(angles[0], angles[-1]), gc]], 10e-6,
                              5.5e-6, hgs)
    return lps, lcs, hgs, np.linspace(-6.3e-6, 6.3e-6, LENS_POINTS)


def fft_field():
    rng = np.random.default_rng(1)
    return (rng.normal(size=FFT_SHAPE) + 1j * rng.normal(size=FFT_SHAPE))


def design_members(n):
    """n two-pillar members over 25-27 deg (one per rank), each with a 1%
    trust region around its start, and the FOM terms."""
    from ..grating import Grating
    from ..solver.fom import FomTerm
    out = []
    for adeg in np.linspace(25.0, 27.0, n):
        out.append(Grating(
            lateral_period=LY, cyl_height=H,
            grating_period=LAM / math.sin(adeg * math.pi / 180),
            xyrra_list_in_nm_deg=[[-300, 0, 110, 90, 0],
                                  [250, 40, 80, 70, 10]]))
    return out, [FomTerm(LAM, 1.0, -1, True)]


DESIGN_CAPS = dict(attempts=DESIGN_ATTEMPTS, max_rounds_per_dispatch=4,
                   max_dispatches=16, how_similar=0.01)


def rank_work(mesh) -> dict:
    """Every sharded path on this rank's part of ``mesh`` at the dry run's
    shapes; returns host numpy results (the same on every rank)."""
    from ..solver import cpx
    from . import (build_nearfield_sharded, farfield_sharded, fft2_sharded,
                   multihost_barrier, sharded_characterize_amps,
                   sharded_fom_and_grad, sharded_member_optimize)
    out = {}
    cdt = cpx.complex_dtype(mesh.device)
    rdt = cpx.real_dtype(cdt)

    # the sharded training step: FOM + exact gradient, then an update
    p = _tiny_problem(numG=9, B=math.lcm(8, mesh.size), dtype=rdt)
    tgt, inph, args = sweep_inputs(p)
    step = sharded_fom_and_grad(mesh, p["orders"], p["n_slabs"], tgt, inph,
                                taylor_terms=p["taylor"])
    fom, grad = step(*args)
    grad = grad.cpu().double().numpy()
    update = args[0] + 0.1 * NM * grad / (np.abs(grad).max() + 1e-30)
    fom2, _ = step(update, *args[1:])
    out.update(sweep_fom=float(fom), sweep_grad=grad,
               sweep_fom2=float(fom2), sweep_schedule=np.array(
                   [p["n_slabs"], p["taylor"]]))
    if not (np.isfinite(out["sweep_fom"]) and np.isfinite(grad).all()):
        raise RuntimeError("sharded FOM or gradient not finite")

    # the characterize sweep, two periods in one batch: each on its own
    # order set (numG), then on one shared set (the JAX package's form)
    cin = characterize_inputs(characterize_members())
    ch = sharded_characterize_amps(mesh, CHAR_NUMG, None)
    ampf, ampr = ch(*cin)
    out.update(char_ampf=ampf.cpu().numpy(), char_ampr=ampr.cpu().numpy())
    orders, n_slabs, taylor = characterize_shared_config(cdt)
    ch = sharded_characterize_amps(mesh, orders, n_slabs,
                                   taylor_terms=taylor)
    ampf, ampr = ch(*cin)
    out.update(char_shared_ampf=ampf.cpu().numpy(),
               char_shared_ampr=ampr.cpu().numpy())

    # the near-field stitch, the aperture rows over the ranks
    lps, lcs, hgs, pts = tiny_lens(mesh.device)
    Ex, Ey, Hx, Hy, _, _, power, n_glass = build_nearfield_sharded(
        mesh, 0.0, 0.0, -10e-6, "x", LAM, lps, lcs, hgs, pts, pts,
        dipole_moment=1e-30)
    out.update(nf_fields=np.stack([Ex, Ey, Hx, Hy]), nf_power=power)

    # the distributed fft2 against torch.fft.fft2
    z = fft_field()
    lo, hi = mesh.block(len(z))
    got = mesh.all_gather(fft2_sharded(mesh)(torch.as_tensor(z[lo:hi])))
    got = got.cpu().numpy()
    want = torch.fft.fft2(torch.as_tensor(z)).numpy()
    out.update(fft_out=got)
    if np.abs(got - want).max() > 1e-4 * np.abs(want).max():
        raise RuntimeError("distributed fft2 disagrees with torch.fft.fft2")

    # the far field of the stitched aperture
    P, total_P, *_ = farfield_sharded(mesh, Ex, Ey, Hx, Hy, pts, pts, LAM,
                                      n_glass)
    out.update(ff_P=P.cpu().numpy(), ff_total=total_P)

    # the member design, one member per rank
    members, terms = design_members(mesh.size)
    des, foms = sharded_member_optimize(
        mesh, members, LAM, numG=DESIGN_NUMG, terms=terms,
        seeds=list(range(mesh.size)),
        similar_to=[g.xyrra_list for g in members], verbose=False,
        **DESIGN_CAPS)
    out.update(design_xyrra=np.stack([g.xyrra_list for g in des]),
               design_foms=np.array(foms))
    if not np.isfinite(out["design_foms"]).all():
        raise RuntimeError("sharded design FOM not finite")
    multihost_barrier()
    return out


def _summary(n, out):
    return (f"dryrun_multichip({n}): sharded train step fom="
            f"{out['sweep_fom']:.6f} -> {out['sweep_fom2']:.6f}; sharded "
            f"characterize ampf{tuple(out['char_ampf'].shape)} on own and "
            f"shared order sets; sharded "
            f"stitch P_lens={out['nf_power']:.3e}; distributed FFT parity "
            f"ok; farfield total_P={out['ff_total']:.3e}; sharded fused "
            f"design {len(out['design_foms'])} members foms[min,max]="
            f"[{out['design_foms'].min():.4f},"
            f"{out['design_foms'].max():.4f}] OK")


def _spawned_rank(rank, n, store, result_path, threads, timeout):
    """One gloo rank of :func:`dryrun_multichip` on the CPU (the target of
    a spawned process)."""
    from .mesh import make_mesh
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = rank_work(make_mesh(device="cpu"))
        if rank == 0:
            np.savez(result_path, **out)
    finally:
        dist.destroy_process_group()


def _spawn_cpu_world(n, workdir, timeout):
    """Start n gloo ranks by spawn, wait for them (at most ``timeout``
    seconds), and return rank 0's results."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(workdir, "dryrun_store")
    result_path = os.path.join(workdir, "dryrun_result.npz")
    for path in (store, result_path):
        if os.path.exists(path):
            os.remove(path)
    threads = max(1, torch.get_num_threads() // n)
    procs = [ctx.Process(target=_spawned_rank,
                         args=(r, n, store, result_path, threads, timeout))
             for r in range(n)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [proc for proc in procs if proc.is_alive()]
        for proc in hung:
            proc.kill()
            proc.join()
    codes = [proc.exitcode for proc in procs]
    if hung or any(codes):
        raise RuntimeError(f"dry run ranks failed: exit codes {codes}"
                           + (f", {len(hung)} killed at the {timeout} s "
                              f"deadline" if hung else ""))
    with np.load(result_path) as f:
        return {k: f[k] for k in f.files}


def dryrun_multichip(n_devices: int, *, device="cuda", workdir=None,
                     timeout=300) -> dict:
    """ALL SIX sharded paths on an ``n_devices``-rank world at tiny shapes
    (see the module docstring); returns rank 0's results as host arrays
    and prints one summary line.

    ``device="cpu"``: starts ``n_devices`` gloo ranks by spawn, with their
    file store and results under ``workdir`` (default: a new temporary
    directory), each collective and the whole run bounded by ``timeout``
    seconds.  ``device="cuda"``: a one-rank NCCL group of its own.  In a
    process group (ranks a launcher started, one per card) it runs this
    process's rank."""
    from ..engine import _device
    from .mesh import make_mesh
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the process group has {dist.get_world_size()}"
                             f" ranks, not {n_devices}")
        out = rank_work(make_mesh(device=device))
    elif _device(device).type == "cpu":
        if workdir is not None:
            out = _spawn_cpu_world(n_devices, str(workdir), timeout)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                out = _spawn_cpu_world(n_devices, tmp, timeout)
    elif n_devices == 1:
        from .distributed import init_distributed
        with tempfile.TemporaryDirectory() as tmp:
            init_distributed(f"file://{tmp}/store", 1, 0, device=device,
                             timeout=timeout)
            try:
                out = rank_work(make_mesh(device=device))
            finally:
                dist.destroy_process_group()
    else:
        raise RuntimeError(
            f"{n_devices} CUDA ranks need a launcher (one process per card, "
            f"e.g. torchrun --nproc-per-node {n_devices}); NCCL takes one "
            f"rank per card")
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(_summary(n_devices, out), flush=True)
    return out


def differences(out, ref) -> dict:
    """The largest difference of each result from a reference run's, over
    the reference's largest entry (finite entries; the member design over
    the members both runs have)."""
    diff = {}
    for k in ref:
        a, b = np.atleast_1d(out[k]), np.atleast_1d(ref[k])
        m = min(len(a), len(b))
        a, b = a[:m], b[:m]
        fin = np.isfinite(b)
        diff[k] = float(np.abs(a[fin] - b[fin]).max()
                        / max(np.abs(b[fin]).max(), 1e-300))
    return diff


def main(argv=None):
    """The command line: ``--device`` is ``cuda`` unless asked otherwise,
    as for :func:`dryrun_multichip`."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; one process per card) or cpu "
                    "(gloo ranks spawned here)")
    ap.add_argument("--out", help="save rank 0's results to this npz")
    ap.add_argument("--against", help="an earlier run's npz (e.g. one "
                    "rank's): fail if a result differs by more than 1e-4 "
                    "of its largest entry")
    a = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:          # ranks started by a launcher
        from .distributed import init_distributed
        init_distributed("env://", device=a.device, timeout=600)
    res = dryrun_multichip(a.ranks, device=a.device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        if a.out:
            np.savez(a.out, **res)
        if a.against:
            with np.load(a.against) as f:
                d = differences(res, {k: f[k] for k in f.files})
            print(f"against {a.against}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in d.items()))
            if max(d.values()) > 1e-4:
                raise SystemExit("dry run: results differ from the "
                                 "reference run")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
