"""Port parity of the cell solve (metalens_tpu_torch.solver.rcwa against
metalens_tpu.solver.rcwa) on the same numpy inputs, energy conservation,
and the bench guard cell against the committed float64 truth
(benchmarks/bench_truth.npz) in complex128 and complex64."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from metalens_tpu.solver import cpx as jcpx, orders as jord, rcwa as jrcwa
from metalens_tpu.units import nm
from metalens_tpu_torch.solver import basis as tbasis, cpx as tcpx, \
    rcwa as trcwa

torch.set_num_threads(1)

LX, LY, LAM, H = 1200 * nm, 320 * nm, 580 * nm, 550 * nm
NT, NG = 2.372, 1.459
BASE = np.array([[-215 * nm, 2 * nm, 144 * nm, 111 * nm, 0.0],
                 [196 * nm, -8 * nm, 100 * nm, 130 * nm, 0.1]])
TRUTH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "bench_truth.npz")


def _incidence(orders, numG):
    i0 = jord.order_index(orders, 0, 0)
    c = np.zeros((2 * numG, 2))
    c[i0, 0] = c[i0 + numG, 1] = 1.0
    return c


@pytest.mark.parametrize("fff", [True, False])
def test_cell_amplitudes_match_jax_f64_and_conserve_energy(fff):
    """Batched cell_amplitudes at numG = 25 against the JAX solve per cell
    (incidences away from the grazing orders of ux = 0.45, where the
    1/kz basis amplifies float64 rounding to ~1e-9), and the power balance
    of the lossless cell."""
    numG = 25
    orders = jord.select_orders(LX, LY, numG)
    ns, terms = trcwa.slab_schedule(2 * np.pi * H / LAM, orders, LX, LY, LAM,
                                    NT ** 2, dtype=torch.float64)
    rng = np.random.default_rng(0)
    xy = np.stack([BASE + rng.normal(scale=2 * nm, size=BASE.shape)
                   for _ in range(3)])
    ux, uy = np.array([0.2, 0.3, 0.38]), np.array([0.0, 0.1, -0.05])
    c = _incidence(orders, numG)
    af, ar, Kx, Ky = trcwa.cell_amplitudes(
        orders, torch.as_tensor(xy), LX, LY, H, NT ** 2, NG ** 2, LAM,
        torch.as_tensor(ux), torch.as_tensor(uy), torch.as_tensor(c),
        n_slabs=ns, taylor_terms=terms, fff=fff)
    assert af.dtype == torch.complex128 and af.shape == (3, 2 * numG, 2)

    def one(x, a, b):
        f, r, _, _ = jrcwa.cell_amplitudes(
            orders, x, LX, LY, H, NT ** 2, NG ** 2, LAM, a, b,
            jnp.asarray(c), n_slabs=ns, taylor_terms=terms, fff=fff)
        return f, r
    jf, jr = jax.jit(jax.vmap(one))(jnp.asarray(xy), jnp.asarray(ux),
                                    jnp.asarray(uy))
    for got, want in ((af, jcpx.to_np(jf)), (ar, jcpx.to_np(jr))):
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-10

    Kz_a = tbasis.kz_norm(Kx, Ky, 1.0)
    Kz_g = tbasis.kz_norm(Kx, Ky, NG ** 2)
    n_g = tcpx.csqrt_posim(torch.tensor(NG ** 2 + 0j, dtype=torch.complex128))
    cin = torch.as_tensor(c, dtype=torch.complex128)
    for col in range(2):
        Pt = tbasis.order_powers(af[..., col], Kx, Ky, Kz_g, n_g).sum(-1)
        Pr = -tbasis.order_powers(ar[..., col], Kx, Ky, -Kz_a, 1.0).sum(-1)
        Pin = tbasis.order_powers(cin[:, col].expand(3, -1), Kx, Ky, Kz_a,
                                  1.0).sum(-1)
        assert ((Pt + Pr - Pin).abs() / Pin).max().item() < 1e-8


def test_cell_smatrix_agrees_with_cell_amplitudes():
    """The composite S-matrix applied to the incidence equals the
    amplitudes path that never forms it (both in the port)."""
    numG = 13
    orders = jord.select_orders(LX, LY, numG)
    ns, terms = trcwa.slab_schedule(2 * np.pi * H / LAM, orders, LX, LY, LAM,
                                    NT ** 2, dtype=torch.float64)
    xy = torch.as_tensor(BASE[None])
    c = torch.as_tensor(_incidence(orders, numG), dtype=torch.complex128)
    args = (orders, xy, LX, LY, H, NT ** 2, NG ** 2, LAM, 0.3, 0.1)
    S, _, _ = trcwa.cell_smatrix(*args, n_slabs=ns, taylor_terms=terms,
                                 fff=True)
    af, ar, _, _ = trcwa.cell_amplitudes(*args, c, n_slabs=ns,
                                         taylor_terms=terms, fff=True)
    assert torch.allclose(S.s11 @ c, af, rtol=0, atol=1e-12)
    assert torch.allclose(S.s21 @ c, ar, rtol=0, atol=1e-12)


def _guard_cell(dtype, schedule_dtype):
    numG = 50
    orders = jord.select_orders(LX, LY, numG)
    ns, terms = trcwa.slab_schedule(2 * np.pi * H / LAM, orders, LX, LY, LAM,
                                    NT ** 2, dtype=schedule_dtype)
    rdt = tcpx.real_dtype(dtype)
    af, ar, _, _ = trcwa.cell_amplitudes(
        orders, torch.as_tensor(BASE[None], dtype=rdt), LX, LY, H, NT ** 2,
        NG ** 2, LAM, torch.tensor([0.45], dtype=rdt),
        torch.zeros(1, dtype=rdt), torch.as_tensor(_incidence(orders, numG)),
        n_slabs=ns, taylor_terms=terms, fff=True)
    # f64 promotion anywhere would hide the float32 error being measured
    assert af.dtype == dtype and ar.dtype == dtype
    got = np.stack([af.real.numpy(), af.imag.numpy(), ar.real.numpy(),
                    ar.imag.numpy()])
    return got, np.load(TRUTH)["ampfr_numG50"]


def test_bench_cell_complex128_matches_truth():
    """The bench guard cell at the float64 schedule of gen_bench_truth.py."""
    got, truth = _guard_cell(torch.complex128, torch.float64)
    assert got.shape == truth.shape
    assert np.abs(got - truth).max() < 1e-8


def test_bench_cell_complex64_within_guard():
    """complex64 at the float32 schedule (slab cap 11.0) within bench.py's
    accuracy-guard tolerance of the float64 truth."""
    assert trcwa.slab_cap(torch.complex64) == 11.0
    got, truth = _guard_cell(torch.complex64, torch.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - truth).max() < 2e-3


def test_slab_cap_needs_dtype():
    assert trcwa.slab_cap(torch.float64) == 16.5
    with pytest.raises(ValueError, match="dtype"):
        trcwa.slab_schedule(10.0, np.zeros((1, 2), int), LX, LY, LAM, 5.6)
