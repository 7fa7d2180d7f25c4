"""Port parity of the solver front end (metalens_tpu_torch against
metalens_tpu at float64): the J1 fit, the ellipse structure Toeplitz, the
NV blocks and the plane-wave basis blocks, on the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from metalens_tpu.solver import basis as jbasis, cpx as jcpx, \
    epsilon as jeps, fff as jfff, orders as jord, special as jspecial
from metalens_tpu.units import nm
from metalens_tpu_torch.solver import basis as tbasis, epsilon as teps, \
    fff as tfff, special as tspecial

torch.set_num_threads(2)

TOL = 1e-10   # float64 on both sides, same formulas
LX, LY = 1200 * nm, 320 * nm


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _xyrra(rng, B):
    base = np.array([[-215 * nm, 2 * nm, 144 * nm, 111 * nm, 0.0],
                     [196 * nm, -8 * nm, 100 * nm, 130 * nm, 0.1]])
    return np.stack([base + rng.normal(scale=3 * nm, size=base.shape)
                     for _ in range(B)])


@pytest.mark.parametrize("small_arg_only", [False, True])
def test_j1_over_x_from_sq(small_arg_only):
    rng = np.random.default_rng(0)
    hi = 7.9 if small_arg_only else 30.0
    x2 = np.concatenate([[0.0, 1e-13, 1e-6], rng.uniform(0, hi, 500) ** 2])
    got = tspecial.j1_over_x_from_sq(torch.as_tensor(x2), small_arg_only)
    want = jax.jit(jspecial.j1_over_x_from_sq, static_argnums=1)(
        jnp.asarray(x2), small_arg_only)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) < TOL


def test_structure_toeplitz_traced_and_static():
    rng = np.random.default_rng(1)
    xy = _xyrra(rng, 3)
    orders = jord.select_orders(LX, LY, 21)
    mx, my = orders[:, 0], orders[:, 1]
    Dx, Dy = 16, 8
    S_t, z_t = teps.ellipse_structure_toeplitz_traced(
        torch.as_tensor(mx), torch.as_tensor(my), Dx, Dy, LX, LY,
        torch.as_tensor(xy))
    S_s, z_s = teps.ellipse_structure_toeplitz(orders, LX, LY,
                                               torch.as_tensor(xy))
    S_j, z_j = jax.jit(jax.vmap(
        lambda x: jeps.ellipse_structure_toeplitz_traced(
            jnp.asarray(mx), jnp.asarray(my), Dx, Dy, LX, LY, x)))(
        jnp.asarray(xy))
    for b in range(3):
        assert _rel(S_t[b].numpy(), jcpx.to_np(S_j)[b]) < TOL
        assert _rel(S_s[b].numpy(), jcpx.to_np(S_j)[b]) < TOL
        np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j)[b])
        np.testing.assert_array_equal(z_s.numpy(), np.asarray(z_j)[b])
    with pytest.raises(ValueError, match="dense grid"):
        teps.traced_gather_idx(torch.as_tensor(mx), torch.as_tensor(my), 1, 1)


@pytest.mark.parametrize("eps_pillar,hermitian",
                         [(2.372 ** 2, True), ((2.6 + 0.08j) ** 2, False)])
def test_nv_blocks(eps_pillar, hermitian):
    """E, Mxx, Mxy, Myy of the NV factorization, lossless (Hermitian-part
    route, unpivoted inverse) and absorbing (anticommutator route, pivoted
    solve)."""
    rng = np.random.default_rng(2)
    xy = _xyrra(rng, 2)
    orders = jord.select_orders(LX, LY, 17)
    got = tfff.fff_eps_blocks(orders, LX, LY, torch.as_tensor(xy),
                              eps_pillar, hermitian=hermitian)
    want = jax.jit(jax.vmap(lambda x: jfff.fff_eps_blocks(
        orders, LX, LY, x, eps_pillar, hermitian=hermitian)))(
        jnp.asarray(xy))
    for b in range(2):
        for g, w in zip(got, want):
            assert _rel(g[b].numpy(), jcpx.to_np(w)[b]) < TOL


def test_nv_projector_traced():
    rng = np.random.default_rng(3)
    xy = _xyrra(rng, 2)
    orders = jord.select_orders(LX, LY, 13)
    mx, my = orders[:, 0], orders[:, 1]
    got = tfff.normal_projector_toeplitz_traced(
        torch.as_tensor(mx), torch.as_tensor(my), 16, 8, LX, LY,
        torch.as_tensor(xy), R=32)
    want = jax.jit(jax.vmap(lambda x: jfff.normal_projector_toeplitz_traced(
        jnp.asarray(mx), jnp.asarray(my), 16, 8, LX, LY, x, R=32)))(
        jnp.asarray(xy))
    for b in range(2):
        for g, w in zip(got, want):
            assert _rel(g[b].numpy(), jcpx.to_np(w)[b]) < TOL


@pytest.mark.parametrize("eps", [1.0, 1.459 ** 2, 1.5 + 1.0j])
def test_basis_blocks(eps):
    rng = np.random.default_rng(4)
    Kx = rng.uniform(-2.0, 2.0, size=(3, 19))
    Ky = rng.uniform(-1.5, 1.5, size=(3, 19))
    Kz_t = tbasis.kz_norm(torch.as_tensor(Kx), torch.as_tensor(Ky), eps)
    n_t = (1.0 if eps == 1.0 else
           torch.sqrt(torch.tensor(complex(eps), dtype=torch.complex128)))
    we_t = tbasis.we_blocks(torch.as_tensor(Kx), torch.as_tensor(Ky), Kz_t,
                            n_t)
    wi_t = tbasis.we_inv_blocks(torch.as_tensor(Kx), torch.as_tensor(Ky),
                                Kz_t, n_t)
    c = rng.normal(size=(3, 38)) + 1j * rng.normal(size=(3, 38))
    P_t = tbasis.order_powers(torch.as_tensor(c), torch.as_tensor(Kx),
                              torch.as_tensor(Ky), Kz_t, n_t)
    for b in range(3):
        kx, ky = jnp.asarray(Kx[b]), jnp.asarray(Ky[b])
        Kz_j = jbasis.kz_norm(kx, ky, eps)
        n_j = 1.0 if eps == 1.0 else jcpx.from_np(np.sqrt(complex(eps)))
        assert _rel(Kz_t[b].numpy(), jcpx.to_np(Kz_j)) < TOL
        for g, w in zip(we_t, jbasis.we_blocks(kx, ky, Kz_j, n_j)):
            assert _rel(g[b].numpy(), jcpx.to_np(w)) < TOL
        for g, w in zip(wi_t, jbasis.we_inv_blocks(kx, ky, Kz_j, n_j)):
            assert _rel(g[b].numpy(), jcpx.to_np(w)) < TOL
        P_j = jbasis.order_powers(jcpx.from_np(c[b]), kx, ky, Kz_j, n_j)
        # evanescent orders carry ~0 power: scale by the amplitudes
        scale = (np.abs(c[b]) ** 2).max()
        assert np.abs(P_t[b].numpy() - np.asarray(P_j)).max() / scale < TOL


@pytest.mark.parametrize("pol", ["s", "p"])
def test_incident_amplitudes(pol):
    ux = np.array([0.0, 0.3, -0.45, 0.7])
    uy = np.array([0.0, 0.1, 0.2, 0.0])
    got = tbasis.incident_sp_amplitudes(torch.as_tensor(ux),
                                        torch.as_tensor(uy), pol)
    want = jbasis.incident_sp_amplitudes(jnp.asarray(ux), jnp.asarray(uy),
                                         pol)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=1e-15)
