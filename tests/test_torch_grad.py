"""Gradients of the port: the two kernels' autograd Functions run with
their plain forwards (``InverseFn``, ``TaylorFn``), and
``fom_value_and_grad`` against central differences and in float32.  Its
parity with ``metalens_tpu.engine.fom_value_and_grad`` is in
tests/test_torch_optimize.py, beside the optimizers' runs of the same
compiled JAX program."""

import numpy as np
import torch

from metalens_tpu.grating import Grating as JGrating
from metalens_tpu.units import nm
from metalens_tpu_torch import engine as tengine
from metalens_tpu_torch.convert import grating_from_reference
from metalens_tpu_torch.solver import inv as tinv, taylor as ttay
from metalens_tpu_torch.solver.fom import FomTerm as TFomTerm

torch.set_num_threads(1)

NUMG = 15
XY_NM_DEG = np.array([[-215., 2., 144., 111., 0.], [196., -8., 100., 130., 6.]])
TERMS = [(580 * nm, 1.0, -1, True), (450 * nm, 0.5, 0, False)]


def _crandn(gen, *shape):
    return torch.view_as_complex(
        torch.randn(*shape, 2, generator=gen, dtype=torch.float64))


def _inverse_fn_plain(A):
    return tinv.InverseFn.apply(A, tinv.inv_reference)


def _taylor_fn_plain(F, G, t, terms):
    return ttay.TaylorFn.apply(F, G, t, terms, ttay.gemm_reference,
                               ttay.chunk_sums_reference)


def _grads(fn, inputs, cotangents):
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return torch.autograd.grad(outs, leaves, cotangents)


def test_inverse_fn_gradcheck_and_matches_linalg_inv():
    gen = torch.Generator().manual_seed(0)
    n = 6
    A = torch.eye(n, dtype=torch.complex128) + 0.3 * _crandn(gen, 2, n, n)
    assert torch.autograd.gradcheck(_inverse_fn_plain,
                                    (A.clone().requires_grad_(True),))
    ct = _crandn(gen, 2, n, n)
    got, = _grads(_inverse_fn_plain, (A,), (ct,))
    want, = _grads(torch.linalg.inv, (A,), (ct,))
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-12
    assert torch.equal(_inverse_fn_plain(A), torch.linalg.inv(A))


def test_taylor_fn_gradcheck_and_matches_reference_autograd():
    gen = torch.Generator().manual_seed(1)
    n, terms = 5, 6
    F, G = (0.35 * _crandn(gen, 2, n, n) for _ in range(2))
    t = torch.tensor([0.4, 0.8], dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda F, G: _taylor_fn_plain(F, G, t, terms),
        (F.clone().requires_grad_(True), G.clone().requires_grad_(True)))
    cts = tuple(_crandn(gen, 2, n, n) for _ in range(4))
    got = _grads(lambda F, G: _taylor_fn_plain(F, G, t, terms), (F, G), cts)
    want = _grads(lambda F, G: ttay.taylor_factors_reference(F, G, t, terms),
                  (F, G), cts)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-12
    # the forward is the launch plan on the plain primitives, float64 table
    for g, w in zip(_taylor_fn_plain(F, G, 0.6, terms),
                    ttay.taylor_factors_reference(F, G, 0.6, terms)):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-13


def test_fom_gradient_matches_finite_difference():
    tg = grating_from_reference(
        JGrating(lateral_period=320 * nm, grating_period=1200 * nm,
                 cyl_height=550 * nm, xyrra_list_in_nm_deg=XY_NM_DEG))
    vg = tengine.fom_value_and_grad(tg, 580 * nm, NUMG,
                                    [TFomTerm(*t) for t in TERMS],
                                    device="cpu")
    _, grad = vg(tg.xyrra_list)
    eps = 0.01 * nm
    for e, p in ((0, 2), (1, 1)):
        xp, xm = tg.xyrra_list.copy(), tg.xyrra_list.copy()
        xp[e, p] += eps
        xm[e, p] -= eps
        g_fd = (vg(xp)[0].item() - vg(xm)[0].item()) / (2 * eps)
        g_ad = grad[e, p].item()
        assert abs(g_ad - g_fd) / abs(g_fd) < 1e-4


def test_fom_gradient_in_float32_stays_float32():
    """complex64 on the CPU: the gradient is float32 (no float64 promotion
    hides its error) and close to the float64 gradient."""
    tg = grating_from_reference(
        JGrating(lateral_period=320 * nm, grating_period=1200 * nm,
                 cyl_height=550 * nm, xyrra_list_in_nm_deg=XY_NM_DEG))
    terms = [TFomTerm(*t) for t in TERMS]
    f32, g32 = tengine.fom_value_and_grad(
        tg, 580 * nm, NUMG, terms, device="cpu",
        dtype=torch.complex64)(tg.xyrra_list)
    f64, g64 = tengine.fom_value_and_grad(tg, 580 * nm, NUMG, terms,
                                          device="cpu")(tg.xyrra_list)
    assert f32.dtype == g32.dtype == torch.float32
    assert abs(f32.item() - f64.item()) < 1e-4
    assert ((g32.double() - g64).norm() / g64.norm()).item() < 2e-3
