"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card.  CUDA kernels have no CPU mode, so every test here needs an
NVIDIA GPU and skips without one.  The GPU machine has no JAX: this file
imports only torch and the port, and runs there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from metalens_tpu_torch import _cuda, trace
from metalens_tpu_torch.solver import inv, orders as ordmod, rcwa, taylor

NM = 1e-9
LX, LY, LAM, H = 1200 * NM, 320 * NM, 580 * NM, 550 * NM
NT, NG = 2.372, 1.459
BASE = np.array([[-215 * NM, 2 * NM, 144 * NM, 111 * NM, 0.0],
                 [196 * NM, -8 * NM, 100 * NM, 130 * NM, 0.1]])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _hot_path_calls(device, module, name, numG=25):
    """Arguments of every call of module.name during one port cell solve
    (NV on, complex64 on the card)."""
    seen = []
    orig = getattr(module, name)

    def spy(*args):
        seen.append(args)
        return orig(*args)

    orders = ordmod.select_orders(LX, LY, numG)
    ns, terms = rcwa.slab_schedule(2 * np.pi * H / LAM, orders, LX, LY, LAM,
                                   NT ** 2, dtype=torch.float32)
    i0 = ordmod.order_index(orders, 0, 0)
    c = torch.zeros(2 * numG, 2)
    c[i0, 0] = c[i0 + numG, 1] = 1.0
    xy = torch.as_tensor(BASE[None], dtype=torch.float32, device=device)
    setattr(module, name, spy)
    try:
        rcwa.cell_amplitudes(orders, xy, LX, LY, H, NT ** 2, NG ** 2, LAM,
                             0.38, 0.1, c, n_slabs=ns, taylor_terms=terms,
                             fff=True)
    finally:
        setattr(module, name, orig)
    return seen


def _launched():
    """Launches the trace registry counted since its last reset: (inverse,
    Taylor GEMM, chunk pass)."""
    return tuple(_cuda.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 25, 50, 100, 128, 129, 200, 256])
def test_inverse_kernel_random(cuda_device, n):
    """Both routes: registers (n <= 128), then a cluster of 2 blocks
    (n <= 200) and of 4 blocks above."""
    gen = torch.Generator().manual_seed(n)
    noise = torch.view_as_complex(torch.randn(3, n, n, 2, generator=gen))
    A = (torch.eye(n) + 0.4 * noise / math.sqrt(n)).to(torch.complex64)
    A = A.to(cuda_device)
    route = "cluster" if n > inv.REGISTER_MAX_N else "registers"
    with trace.collect():
        W = inv.inv(A)
        assert _launched()[0] == 1
        assert _cuda.route_counts()[route] == 1
    eye = torch.eye(n, dtype=A.dtype, device=cuda_device)
    assert (W @ A - eye).abs().max().item() < 5e-5


@pytest.mark.cuda
def test_inverse_kernel_on_hot_path_matrices(cuda_device):
    calls = _hot_path_calls(cuda_device, inv, "inv")
    assert len(calls) >= 5
    for (A,) in calls:
        W = inv.inv_cuda(A)
        R = inv.inv_reference(A)
        assert ((W - R).abs().max() / R.abs().max()).item() < 1e-4


@pytest.mark.cuda
def test_inverse_kernel_refuses(cuda_device):
    A = torch.eye(4, dtype=torch.complex128, device=cuda_device)[None]
    with pytest.raises(TypeError):
        inv.inv(A)
    with pytest.raises(ValueError, match="256"):
        inv.inv_cuda(torch.eye(257, dtype=torch.complex64,
                               device=cuda_device)[None])
    with pytest.raises(ValueError, match="contiguous"):
        inv.inv_cuda(torch.eye(8, dtype=torch.complex64,
                               device=cuda_device)[None].mT.expand(2, 8, 8))
    A = torch.eye(4, dtype=torch.complex64, device=cuda_device)[None]
    with pytest.raises(NotImplementedError):
        inv.inv_cuda(A.requires_grad_())


@pytest.mark.cuda
def test_taylor_kernel_batch_above_grid_z_limit(cuda_device):
    """The batch shares gridDim.x with the tiles: 70,000 matrices (more
    than gridDim.z's 65,535) in one call."""
    gen = torch.Generator().manual_seed(7)
    B, n, terms = 70_000, 4, 8
    F = 0.35 * torch.view_as_complex(torch.randn(B, n, n, 2, generator=gen))
    G = 0.35 * torch.view_as_complex(torch.randn(B, n, n, 2, generator=gen))
    F = F.to(torch.complex64).to(cuda_device)
    G = G.to(torch.complex64).to(cuda_device)
    t = torch.linspace(0.3, 0.9, B)
    got = taylor.taylor_factors(F, G, t, terms)
    want = taylor.taylor_factors_reference(F, G, t.to(cuda_device), terms)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 2e-5


@pytest.mark.cuda
def test_taylor_kernel_refuses(cuda_device):
    F = torch.zeros(2, 8, 8, dtype=torch.complex64, device=cuda_device)
    table = torch.zeros(2, 3, 162, device=cuda_device)
    with pytest.raises(ValueError, match="160 terms"):
        taylor.taylor_factors_cuda(F, F, table, 161)
    with pytest.raises(ValueError, match="coefficient table"):
        taylor.taylor_factors_cuda(F, F, taylor.coeff_table(0.5, 8, 1, "cpu"),
                                   8)
    with pytest.raises(ValueError, match="contiguous"):
        taylor.taylor_factors(F.mT, F, 0.5, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n,terms", [(100, 20), (37, 8), (200, 24)])
def test_taylor_kernel_random_batched_t(cuda_device, n, terms):
    gen = torch.Generator().manual_seed(n)
    F = 0.35 * torch.view_as_complex(torch.randn(4, n, n, 2, generator=gen))
    G = 0.35 * torch.view_as_complex(torch.randn(4, n, n, 2, generator=gen))
    F = F.to(torch.complex64).to(cuda_device)
    G = G.to(torch.complex64).to(cuda_device)
    t = torch.tensor([0.3, 0.5, 0.7, 0.9])
    with trace.collect():
        got = taylor.taylor_factors(F, G, t, terms)
        assert _launched()[1] > 0
    want = taylor.taylor_factors_reference(F, G, t.to(cuda_device), terms)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 2e-5


@pytest.mark.cuda
def test_taylor_kernel_on_hot_path_matrices(cuda_device):
    (F, G, t, terms), = _hot_path_calls(cuda_device, taylor,
                                        "taylor_factors")
    got = taylor.taylor_factors(F, G, t, terms)
    want = taylor.taylor_factors_reference(F, G, t, terms)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 2e-5
    with pytest.raises(TypeError):
        taylor.taylor_factors(F.to(torch.complex128), G.to(torch.complex128),
                              t, terms)


def _max_rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 100, 200])
def test_inverse_backward_against_linalg_inv(cuda_device, n):
    """InverseFn's gradient on the kernel's inverse against autograd
    through torch.linalg.inv, with a random cotangent."""
    gen = torch.Generator().manual_seed(10 + n)
    noise = torch.view_as_complex(torch.randn(3, n, n, 2, generator=gen))
    A = (torch.eye(n) + 0.4 * noise / math.sqrt(n)).to(torch.complex64)
    ct = torch.view_as_complex(torch.randn(3, n, n, 2, generator=gen))
    A, ct = A.to(cuda_device), ct.to(torch.complex64).to(cuda_device)
    A_k, A_r = A.clone().requires_grad_(), A.clone().requires_grad_()
    with trace.collect():
        got, = torch.autograd.grad(inv.inv(A_k), A_k, ct)
        assert _launched()[0] == 1
    want, = torch.autograd.grad(torch.linalg.inv(A_r), A_r, ct)
    assert got.dtype == torch.complex64
    assert _max_rel(got, want) < 1e-4


@pytest.mark.cuda
def test_taylor_backward_against_reference_autograd(cuda_device):
    """TaylorFn's gradient (the kernels forward, the plain replay backward)
    against autograd through taylor_factors_reference; the direct kernel
    entry still refuses a gradient."""
    gen = torch.Generator().manual_seed(11)
    n, terms = 100, 20
    F, G, *cts = (0.35 * torch.view_as_complex(
        torch.randn(4, n, n, 2, generator=gen)).to(torch.complex64)
        .to(cuda_device) for _ in range(6))
    t = torch.tensor([0.3, 0.5, 0.7, 0.9])
    leaves_k = [M.clone().requires_grad_() for M in (F, G)]
    leaves_r = [M.clone().requires_grad_() for M in (F, G)]
    with trace.collect():
        got = torch.autograd.grad(
            taylor.taylor_factors(*leaves_k, t, terms), leaves_k, cts)
        assert _launched()[1] > 0
        assert _launched()[2] == 1
    want = torch.autograd.grad(
        taylor.taylor_factors_reference(*leaves_r, t.to(cuda_device), terms),
        leaves_r, cts)
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        assert _max_rel(g, w) < 2e-5
    with pytest.raises(NotImplementedError):
        taylor.taylor_factors_cuda(leaves_k[0], G,
                                   taylor.coeff_table(t, terms, 4,
                                                      cuda_device), terms)


@pytest.mark.cuda
def test_characterize_three_wavelengths_against_plain_versions(cuda_device):
    """One characterize sweep with three wavelengths in its batch (so the
    slab thickness t varies across the Taylor batch) through the kernels,
    against the same sweep with the plain versions in their place."""
    from metalens_tpu_torch.engine import characterize_grating
    from metalens_tpu_torch.grating import Grating
    g = Grating(lateral_period=320 * NM, grating_period=1250 * NM,
                cyl_height=550 * NM,
                xyrra_list_in_nm_deg=[[125., 0., 100., 90., 0.],
                                      [-312.5, 5., 110., 80., 10.]])
    kw = dict(ux_min=0.2, ux_max=0.5, uy_min=-0.2, uy_max=0.2, u_steps=3,
              wavelength=[450 * NM, 580 * NM, 650 * NM], numG=25)
    with trace.collect():
        got = characterize_grating(g, **kw)
        assert all(a > 0 for a in _launched())
    saved = inv.inv, taylor.taylor_factors
    inv.inv, taylor.taylor_factors = (inv.inv_reference,
                                      taylor.taylor_factors_reference)
    try:
        with trace.collect():
            want = characterize_grating(g, **kw)
            assert _launched() == (0, 0, 0)
    finally:
        inv.inv, taylor.taylor_factors = saved
    assert len(got) == len(want) > 0
    assert {e["wavelength_in_nm"] for e in got} == {450.0, 580.0, 650.0}
    worst = 0.0
    for a, b in zip(got, want):
        assert [a[k] for k in ("wavelength_in_nm", "x_or_y", "ux", "uy",
                               "ox", "oy")] \
            == [b[k] for k in ("wavelength_in_nm", "x_or_y", "ux", "uy",
                               "ox", "oy")]
        worst = max(worst, max(abs(a[k] - b[k]) for k in
                               ("ampfy", "ampfx", "ampry", "amprx")))
    assert worst < 2e-3


def _small_lens():
    """A round collection over 15-32 degrees and a 3-entry HexGridSet,
    characterized on the CPU at numG = 10, and the design of a lens of
    5.5 um radius with its source 10 um away."""
    from metalens_tpu_torch import (Grating, GratingCollection, HexGridSet,
                                    make_design)
    angles = np.linspace(15.0, 32.0, 3) * math.pi / 180
    lp_over_tan = 320 * NM / math.tan(angles[1])
    gs = [Grating(lateral_period=lp_over_tan * math.tan(a),
                  cyl_height=H, grating_period=LAM / math.sin(a),
                  xyrra_list_in_nm_deg=[[-LAM / math.sin(a) / NM / 4, 0., 90.,
                                         70., 0.],
                                        [LAM / math.sin(a) / NM / 4, 0., 70.,
                                         80., 0.]])
          for a in angles]
    gc = GratingCollection(LAM, lp_over_tan, "round", gs)
    gc.characterize(LAM, numG=10, u_steps=2, device="cpu")
    hgs = HexGridSet(sep=320 * NM, cyl_height=H, num_entries=3)
    hgs.characterize(wavelength=LAM, numG=10, just_normal=False, u_steps=2,
                     device="cpu")
    lps, lcs, _ = make_design([[(angles[0], angles[-1]), gc]], 10e-6,
                              5.5e-6, hgs)
    return gc, hgs, lps, lcs


@pytest.mark.cuda
def test_stitch_on_cuda_against_cpu(cuda_device):
    """The near-field stitch of a small lens on the card (complex64 tables
    and fields, float64 geometry) against the same stitch in complex128 on
    the CPU, from the same databases."""
    from metalens_tpu_torch.nearfield import build_nearfield
    gc, hgs, lps, lcs = _small_lens()
    pts = np.linspace(-6.3e-6, 6.3e-6, 48)
    out = {}
    for dev in ("cpu", "cuda"):
        for obj in (gc, hgs):
            obj.build_interpolators(device=dev)
        out[dev] = build_nearfield(0.0, 0.0, -10e-6, "x", LAM, lps, lcs, hgs,
                                   pts, pts, dipole_moment=1e-30, device=dev)
    for got, want in zip(out["cuda"][:4], out["cpu"][:4]):
        assert got.is_cuda and got.dtype == torch.complex64
        assert want.dtype == torch.complex128
        err = (got.cpu().to(want.dtype) - want).abs().max()
        assert err <= 1e-5 * want.abs().max()
    assert abs(out["cuda"][6] - out["cpu"][6]) <= 1e-12 * out["cpu"][6]


@pytest.mark.cuda
def test_farfield_on_cuda_against_cpu(cuda_device):
    """farfield on the card (complex64 FFT) against complex128 on the CPU,
    on a non-square aperture of structured and noisy fields."""
    import importlib
    ff = importlib.import_module("metalens_tpu_torch.farfield")
    rng = np.random.default_rng(5)
    nx, ny, dx = 96, 80, LAM / 2.2
    xs, ys = (np.arange(nx) - nx / 2) * dx, (np.arange(ny) - ny / 2) * dx
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    phase = np.exp(2j * np.pi * NG / LAM * (0.2 * X - 0.1 * Y))
    fields = [phase * (1 + 0.1 * rng.standard_normal((nx, ny)))
              for _ in range(4)]
    got = ff.farfield(*fields, xs, ys, LAM, NG)
    want = ff.farfield(*fields, xs, ys, LAM, NG, device="cpu")
    assert got[0].is_cuda and got[0].dtype == torch.float32
    P, Pr = got[0].cpu().double(), want[0]
    fin = torch.isfinite(Pr)
    assert bool((torch.isfinite(P) == fin).all())
    assert (P - Pr)[fin].abs().max() <= 1e-5 * Pr[fin].max()
    assert abs(got[1] - want[1]) <= 1e-5 * abs(want[1])


@pytest.mark.cuda
def test_fused_member_on_cuda_against_cpu(cuda_device):
    """optimize_fused then optimize2_fused on the card in complex64 at a
    small numG: float32 state, a result that validates, a FOM that did not
    drop, the same launches per FOM batch on each, and the card's result
    scored within 2e-3 of CPU complex128."""
    import importlib
    from metalens_tpu_torch import Grating, validate
    from metalens_tpu_torch.solver.fom import FomTerm
    fused = importlib.import_module("metalens_tpu_torch.optimize_fused")
    g = Grating(lateral_period=LY, grating_period=LX, cyl_height=H,
                xyrra_list_in_nm_deg=[[-215, 2, 144, 105, 0],
                                      [196, -8, 100, 102, 6]])
    terms = [FomTerm(LAM, 1.0, -1, True), FomTerm(450 * NM, 0.5, 0, True)]
    kw = dict(numG=15, terms=terms, similar_to=g.xyrra_list,
              how_similar=0.02, verbose=False)
    returned = []
    orig = fused._rp_run

    def rp_spy(*config):
        run = orig(*config)

        def rec(*args):
            returned.append(run(*args))
            return returned[-1]
        return rec
    fused._rp_run = rp_spy
    try:
        out = fused.optimize_fused(g, LAM, seed=3, **kw)
        out = fused.optimize2_fused(out, LAM, attempts=5, seed=4, **kw)
    finally:
        fused._rp_run = orig
    x, fom = returned[-1][:2]
    assert x.is_cuda and x.dtype == fom.dtype == torch.float32
    assert validate(out, similar_to=g.xyrra_list, how_similar=0.02)
    f0 = g.fom(LAM, numG=15, terms=terms)
    f1 = out.fom(LAM, numG=15, terms=terms)
    assert f1 >= f0 and abs(f1 - fom.item()) <= 1e-5
    assert abs(f1 - out.fom(LAM, numG=15, terms=terms, device="cpu")) <= 2e-3


@pytest.mark.cuda
def test_sharded_step_on_a_one_rank_nccl_group(cuda_device, tmp_path):
    """sharded_fom_and_grad on the card through a one-rank NCCL group (a
    file store, no network) against the same step on the CPU in
    complex128: the mean FOM within 1e-5 and the gradient within 2e-3 of
    its norm; both kernels launch."""
    import torch.distributed as dist
    from metalens_tpu_torch import parallel
    from metalens_tpu_torch.parallel import dryrun
    parallel.init_distributed(f"file://{tmp_path}/store", 1, 0,
                              device="cuda", timeout=120)
    try:
        assert dist.get_backend() == "nccl"
        p = dryrun._tiny_problem(numG=9, B=4, dtype=torch.float32)
        tgt, inph, args = dryrun.sweep_inputs(p)
        got = {}
        for dev in ("cuda", "cpu"):
            # the CPU reference without the group: NCCL takes CUDA tensors
            mesh = (parallel.make_mesh() if dev == "cuda" else
                    parallel.mesh.Mesh(0, 1, torch.device("cpu")))
            step = parallel.sharded_fom_and_grad(
                mesh, p["orders"], p["n_slabs"], tgt, inph,
                taylor_terms=p["taylor"])
            with trace.collect():
                got[dev] = step(*args)
                if dev == "cuda":
                    assert _launched()[0] > 0 and _launched()[1] > 0
        (f, g), (fr, gr) = got["cuda"], got["cpu"]
        assert f.is_cuda and g.dtype == torch.float32 and g.shape == (4, 2, 5)
        assert gr.dtype == torch.float64
        assert abs(f.item() - fr.item()) <= 1e-5 * abs(fr.item())
        assert (g.cpu().double() - gr).norm() <= 2e-3 * gr.norm()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_reciprocity_of_a_lossless_cell_on_cuda(cuda_device):
    """The four Lorentz reciprocity identities of one lossless NV cell,
    solved on the card in complex64 at (0.31, 0.12) and (-0.31, -0.12) in
    one batch: each relative residual within 2e-3 (the accuracy guard of
    bench.py); both kernels launch."""
    from metalens_tpu_torch.solver import checks
    _, orders, perm = checks.negation_closed_orders(LX, LY, 25)
    ns, terms = rcwa.slab_schedule(2 * np.pi * H / LAM, orders, LX, LY, LAM,
                                   NT ** 2, dtype=torch.float32)
    kw = dict(dtype=torch.float32, device=cuda_device)
    xy = torch.as_tensor(np.stack([BASE, BASE]), **kw)
    u = torch.tensor([0.31, -0.31], **kw)
    v = torch.tensor([0.12, -0.12], **kw)
    with trace.collect():
        S, Kx, Ky = rcwa.cell_smatrix(orders, xy, LX, LY, H, NT ** 2,
                                      NG ** 2, LAM, u, v, n_slabs=ns,
                                      taylor_terms=terms, fff=True)
        assert _launched()[0] > 0 and _launched()[1] > 0
    assert S.s11.dtype == torch.complex64 and S.s11.is_cuda
    one = [rcwa.SMatrix(*(x[k:k + 1] for x in S)) for k in (0, 1)]
    res = checks.reciprocity_residuals(
        one[0], one[1], perm, checks.flux_form(Kx[:1], Ky[:1], 1.0, 1.0),
        checks.flux_form(Kx[:1], Ky[:1], NG ** 2, NG))
    for name, r in res.items():
        assert float(r.max()) <= 2e-3, (name, float(r.max()))
