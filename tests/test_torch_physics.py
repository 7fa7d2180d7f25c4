"""The port's general S-matrix API and its independent physics checks.

The port's cell solve in complex128 on the CPU against oracles that share
no code with it: the transfer-matrix method on uniform slabs
(``tests/tmm_reference.py``), the independent 1D RCWA on lamellar gratings
(``tests/rcwa1d_reference.py``), Lorentz reciprocity, energy and
dissipation, and the port's own eigenmode reference on random cells -- at
the tolerances of the reference's tests.  Each new solver function is also
held to the JAX package's eager function on the same numpy inputs at
1e-12.  No JAX program is jitted here.
"""

import numpy as np
import pytest
import torch

from metalens_tpu.solver import basis as jbasis, cpx as jcpx, \
    epsilon as jepsilon, rcwa as jrcwa, special as jspecial
from metalens_tpu.solver.eig import reference_cell_smatrix as jax_eig_ref
from metalens_tpu_torch.solver import basis, checks, epsilon, orders as \
    ordmod, rcwa, special
from metalens_tpu_torch.solver.eig import reference_cell_smatrix

from rcwa1d_reference import lamellar_rcwa
from tmm_reference import tmm_rt

torch.set_num_threads(1)

NM = 1e-9
LX, LY, LAM, H = 1200 * NM, 320 * NM, 580 * NM, 550 * NM
NG, NT = 1.459, 2.372
XYRRA = np.array([[-215 * NM, 2 * NM, 144 * NM, 111 * NM, 0.35],
                  [196 * NM, -8 * NM, 100 * NM, 130 * NM, 0.1]])
# tests/test_eig_ref.py's cell (the first pillar unrotated)
XYRRA_EIG = XYRRA * [[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]]
F64 = dict(dtype=torch.float64)
TOL_PARITY = 1e-12


def t64(x):
    return torch.as_tensor(np.asarray(x), **F64)


def c128(x):
    return torch.as_tensor(np.asarray(x, dtype=complex))


def close(got, want, tol=TOL_PARITY):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def rnd_c(rng, *shape, scale=1.0):
    return scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))


def rnd_smatrix(rng, n2, scale=0.3):
    return [rnd_c(rng, n2, n2, scale=scale / np.sqrt(n2)) for _ in range(4)]


def schedule(orders, eps, h=H, L=LX, Ly=LY):
    """The reference tests' slab count: default_n_slabs over q2_upper_bound."""
    q2 = rcwa.q2_upper_bound(orders, L, Ly, LAM, abs(eps))
    return rcwa.default_n_slabs(2 * np.pi * h / LAM, q2)


# ----- each new solver function against JAX's eager function -----

def _parity_j1():
    x = np.array([0.0, 1e-7, -3e-7, 0.3, -1.7, 5.0, 7.99, 8.01, -20.0])
    close(special.j1_over_x(t64(x)), jspecial.j1_over_x(x))


def _parity_sp_to_xy():
    ux = np.array([0.0, 0.31, -0.2, 0.6, 0.0, 0.1, -0.45, 0.2, 0.0])
    uy = np.array([0.0, 0.12, 0.05, -0.3, 0.4, -0.1, 0.0, 0.2, -0.3])
    for got, want in zip(basis.sp_to_xy_coefficients(t64(ux), t64(uy)),
                         jbasis.sp_to_xy_coefficients(ux, uy)):
        close(got, want)


def _parity_backward_powers():
    rng = np.random.default_rng(1)
    Kx, Ky = rng.uniform(-1.5, 1.5, 9), rng.uniform(-1.5, 1.5, 9)
    c = rnd_c(rng, 18)
    ng = np.sqrt(NG ** 2 + 0j)
    got = basis.backward_order_powers(
        c128(c), t64(Kx), t64(Ky), basis.kz_norm(t64(Kx), t64(Ky), NG ** 2),
        ng)
    want = jbasis.backward_order_powers(
        jcpx.from_np(c), Kx, Ky, jbasis.kz_norm(Kx, Ky, NG ** 2), ng)
    close(got, want)


def _parity_eps_fourier():
    g = np.linspace(-3e7, 3e7, 9)
    gx, gy = np.meshgrid(g, 0.7 * g, indexing="ij")
    eps_f, area = NT ** 2 + 0.05j, LX * LY
    close(epsilon.eps_fourier_ellipses(t64(gx), t64(gy), t64(XYRRA), eps_f,
                                       1.0, area),
          jcpx.to_np(jepsilon.eps_fourier_ellipses(gx, gy, XYRRA, eps_f,
                                                   1.0, area)))
    gx[3, 4] = gy[3, 4] = 0.0      # the zero-difference term
    args = ((40 * NM, -10 * NM), (500 * NM, 200 * NM), 5.6 + 0j, 1.2, area)
    close(epsilon.eps_fourier_rect(t64(gx), t64(gy), *args),
          jcpx.to_np(jepsilon.eps_fourier_rect(gx, gy, *args)))


def _parity_rect_toeplitz():
    orders = ordmod.select_orders(LX, LY, 9)
    args = (orders, LX, LY, (30 * NM, 0.0), (600 * NM, 200 * NM), 5.6 + 0.1j)
    got = epsilon.rect_layer_toeplitz(*args, device="cpu")
    assert got.dtype == torch.complex128 and got.shape == (9, 9)
    close(got, jcpx.to_np(jepsilon.rect_layer_toeplitz(*args)))


def _parity_transfer_and_star():
    rng = np.random.default_rng(2)
    M = [np.eye(18) + m for m in rnd_smatrix(rng, 18)]
    got = rcwa._transfer_to_smatrix(*(c128(m)[None] for m in M))
    want = jrcwa._transfer_to_smatrix(*(jcpx.from_np(m) for m in M))
    for a, b in zip(got, want):
        close(a[0], jcpx.to_np(b))
    A, B = rnd_smatrix(rng, 18), rnd_smatrix(rng, 18)
    got = rcwa.redheffer_star(rcwa.SMatrix(*(c128(m)[None] for m in A)),
                              rcwa.SMatrix(*(c128(m)[None] for m in B)))
    want = jrcwa.redheffer_star(jrcwa.SMatrix(*map(jcpx.from_np, A)),
                                jrcwa.SMatrix(*map(jcpx.from_np, B)))
    for a, b in zip(got, want):
        close(a[0], jcpx.to_np(b))
    S = rcwa.SMatrix(*(c128(m)[None] for m in A))
    c = rnd_c(rng, 18, 2)
    for a, b in zip(rcwa.scatter_amplitudes(S, c),
                    jrcwa.scatter_amplitudes(
                        jrcwa.SMatrix(*map(jcpx.from_np, A)), c)):
        close(a[0], jcpx.to_np(b))


def _medium(Kx, Ky, eps, n, jax_side):
    b = jbasis if jax_side else basis
    Kz = b.kz_norm(Kx, Ky, eps)
    return b.we_blocks(Kx, Ky, Kz, n), b.we_inv_blocks(Kx, Ky, Kz, n)


def _parity_interface_and_slab():
    orders = ordmod.select_orders(LX, LY, 9)
    Kx = 0.31 + orders[:, 0] * LAM / LX
    Ky = 0.12 + orders[:, 1] * LAM / LY
    ref = (1.5 + 1.0j, np.sqrt(1.5 + 1.0j))
    glass = (NG ** 2, NG)
    ours = [_medium(t64(Kx), t64(Ky), e, n, False) for e, n in (ref, glass)]
    theirs = [_medium(Kx, Ky, e, n, True) for e, n in (ref, glass)]
    got = rcwa.interface_smatrix(*ours[0], *ours[1])
    want = jrcwa.interface_smatrix(*theirs[0], *theirs[1])
    for a, b in zip(got, want):
        close(a, jcpx.to_np(b))
    # a thin slab's transfer blocks -> S in the reference basis, both forms
    rng = np.random.default_rng(3)
    T = [np.eye(18) * (k in (0, 3)) + rnd_c(rng, 18, 18, scale=0.05)
         for k in range(4)]
    (we, wei), (jwe, jwei) = ours[0], theirs[0]
    for sym in (True, False):
        got = rcwa.slab_smatrix_in_basis([c128(t)[None] for t in T],
                                         [x[None] for x in we],
                                         [x[None] for x in wei],
                                         symmetric=sym)
        want = jrcwa.slab_smatrix_in_basis([jcpx.from_np(t) for t in T],
                                           jwe, jwei, symmetric=sym)
        for a, b in zip(got, want):
            close(a[0], jcpx.to_np(b), tol=1e-11)


def _parity_schedule():
    orders = ordmod.select_orders(LX, LY, 25)
    for eps in (NT ** 2, 6.5):
        q2 = rcwa.q2_upper_bound(orders, LX, LY, LAM, eps)
        assert q2 == jrcwa.q2_upper_bound(orders, LX, LY, LAM, eps)
        for k0h in (0.3, 5.96, 40.0):
            assert rcwa.default_n_slabs(k0h, q2) == \
                jrcwa.default_n_slabs(k0h, q2)


def _parity_eig_reference():
    orders = ordmod.select_orders(LX, LY, 9)
    args = (orders, XYRRA, LX, LY, H, NT ** 2 + 0.02j, NG ** 2, LAM, 0.31,
            0.12)
    S, Kx, Ky = reference_cell_smatrix(*args)
    Sj, Kxj, Kyj = jax_eig_ref(*args)
    np.testing.assert_allclose(Kx, Kxj, rtol=0, atol=1e-15)
    for a, b in zip(S, Sj):
        close(a, b, tol=1e-10)


def _parity_layer_smatrix(eps_ref):
    """A rectangle layer's doubled S-matrix in the eps_ref basis (``None``:
    the default, the lossy EPS_REF), at an incidence whose orders keep
    0.1 from the light cone of every medium involved."""
    orders = ordmod.select_orders(LX, LY, 9)
    Kx = 0.31 + orders[:, 0] * LAM / LX
    Ky = 0.12 + orders[:, 1] * LAM / LY
    for eps in (1.0, NG ** 2, 2.25):
        assert np.abs(Kx ** 2 + Ky ** 2 - eps).min() > 0.1
    rect = (orders, LX, LY, (30 * NM, 0.0), (600 * NM, 200 * NM), 5.6)
    E = epsilon.rect_layer_toeplitz(*rect, device="cpu")
    k0h, n_slabs, terms = 2 * np.pi * H / LAM, 4, 16
    kw = {} if eps_ref is None else {"eps_ref": eps_ref}
    got = rcwa.layer_smatrix(E[None], t64(Kx)[None], t64(Ky)[None], k0h,
                             n_slabs, terms, **kw)
    want = jrcwa.layer_smatrix(jepsilon.rect_layer_toeplitz(*rect), Kx, Ky,
                               k0h, n_slabs, terms, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.complex128
        close(a[0], jcpx.to_np(b), tol=1e-10)


PARITY = {"j1_over_x": _parity_j1, "sp_to_xy_coefficients": _parity_sp_to_xy,
          "backward_order_powers": _parity_backward_powers,
          "eps_fourier": _parity_eps_fourier,
          "rect_layer_toeplitz": _parity_rect_toeplitz,
          "transfer_star_scatter": _parity_transfer_and_star,
          "interface_and_slab": _parity_interface_and_slab,
          "schedule": _parity_schedule,
          "reference_cell_smatrix": _parity_eig_reference,
          "layer_smatrix_default_ref":
              lambda: _parity_layer_smatrix(None),
          "layer_smatrix_real_ref": lambda: _parity_layer_smatrix(2.25)}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_matches_jax_eager(name):
    PARITY[name]()


# ----- uniform slab against the transfer-matrix method -----

@pytest.mark.parametrize("pol", ["s", "p"])
@pytest.mark.parametrize("theta", [0.001, np.deg2rad(35.0)])
def test_uniform_slab_matches_tmm(pol, theta):
    """air / (n = 2) slab / glass: rect_layer_toeplitz at fill 1 is the
    uniform layer; power reflection and transmission to 1e-10."""
    orders = ordmod.select_orders(LX, LY, 25)
    N, i0 = len(orders), ordmod.order_index(orders, 0, 0)
    E = epsilon.rect_layer_toeplitz(orders, LX, LY, (0.0, 0.0), (LX, LY),
                                    4.0 + 0j, device="cpu")
    ux = t64([np.sin(theta)])
    S, Kx, Ky = rcwa.cell_smatrix_with_eps(
        orders, E[None], LX, LY, H, NG ** 2, LAM, ux, 0.0,
        n_slabs=schedule(orders, 4.0), taylor_terms=12)
    t, r = checks.order_efficiencies(S, Kx, Ky, checks.incident_vector(
        ux, torch.zeros_like(ux), pol, i0, N), NG ** 2, NG)
    R_ref, T_ref = tmm_rt([1.0, 2.0, NG], [H], LAM, theta, pol)
    assert abs(float(t.sum()) - T_ref) < 1e-10
    assert abs(float(r.sum()) - R_ref) < 1e-10


# ----- lamellar gratings against the independent 1D RCWA -----

@pytest.mark.parametrize("pol", ["s", "p"])
@pytest.mark.parametrize("theta_deg,fill,epsf", [
    (25.0, 0.45, 5.6257), (0.001, 0.6, 4.0), (40.0, 0.3, 5.6257 + 0.05j)])
def test_lamellar_matches_independent_rcwa(pol, theta_deg, fill, epsf):
    """Per-order efficiencies on a my = 0 order line (M = 16), plain
    Laurent factorization on both sides, as
    tests/test_lamellar_independent.py holds the JAX package (5e-5)."""
    theta, L, h, M = np.deg2rad(theta_deg), 900 * NM, 550 * NM, 16
    m1, r1, t1 = lamellar_rcwa(pol, LAM, L, h, epsf, 1.0, 1.0, NG ** 2,
                               theta, M=M, fill=fill)
    m = np.arange(-M, M + 1)
    orders = np.stack([m, np.zeros_like(m)], axis=1)
    E = epsilon.rect_layer_toeplitz(orders, L, LY, (0.0, 0.0),
                                    (fill * L, LY), complex(epsf),
                                    device="cpu")
    ux = t64([np.sin(theta)])
    S, Kx, Ky = rcwa.cell_smatrix_with_eps(
        orders, E[None], L, LY, h, NG ** 2, LAM, ux, 0.0,
        n_slabs=schedule(orders, epsf, h, L), taylor_terms=12)
    t2, r2 = checks.order_efficiencies(S, Kx, Ky, checks.incident_vector(
        ux, torch.zeros_like(ux), pol, M, len(m)), NG ** 2, NG)
    np.testing.assert_array_equal(m1, m)
    np.testing.assert_allclose(t2[0].numpy(), t1, atol=5e-5)
    np.testing.assert_allclose(r2[0].numpy(), r1, atol=5e-5)
    assert (t1 > 1e-3).sum() >= 3


# ----- Lorentz reciprocity -----

def _smatrix_pair(orders, ux, uy, fff, eps_pillar):
    """One batched cell_smatrix over (ux, uy) and (-ux, -uy)."""
    u = t64([ux, -ux])
    v = t64([uy, -uy])
    xy = t64(np.stack([XYRRA, XYRRA]))
    S, Kx, Ky = rcwa.cell_smatrix(
        orders, xy, LX, LY, H, eps_pillar, NG ** 2, LAM, u, v,
        n_slabs=schedule(orders, eps_pillar), taylor_terms=10, fff=fff,
        hermitian_eps=complex(eps_pillar).imag == 0.0)
    one = lambda k: rcwa.SMatrix(*(x[k:k + 1] for x in S))   # noqa: E731
    return one(0), one(1), Kx[:1], Ky[:1], Kx[1:], Ky[1:]


@pytest.mark.parametrize("fff", [False, True])
@pytest.mark.parametrize("eps_pillar", [NT ** 2 + 0j, NT ** 2 + 0.4j])
def test_lorentz_reciprocity(fff, eps_pillar):
    """The four identities at (0.31, 0.12) against (-0.31, -0.12), lossless
    and absorbing pillars (the latter inverts eps by the pivoted solve),
    NV on and off: 1e-8, as tests/test_reciprocity.py."""
    _, orders, perm = checks.negation_closed_orders(LX, LY, 25)
    S, Sn, Kx, Ky, Kxn, Kyn = _smatrix_pair(orders, 0.31, 0.12, fff,
                                            eps_pillar)
    np.testing.assert_allclose(Kxn[0, perm].numpy(), -Kx[0].numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(Kyn[0, perm].numpy(), -Ky[0].numpy(),
                               atol=1e-12)
    res = checks.reciprocity_residuals(
        S, Sn, perm, checks.flux_form(Kx, Ky, 1.0, 1.0),
        checks.flux_form(Kx, Ky, NG ** 2, NG))
    assert set(res) == {"s11", "s12", "s21", "s22"}
    for name, r in res.items():
        assert float(r.max()) < 1e-8, (name, float(r.max()))


def test_normal_incidence_internal_reciprocity():
    """At ux = uy = 0 the negated problem is the problem itself."""
    _, orders, perm = checks.negation_closed_orders(LX, LY, 25)
    S, _, Kx, Ky, _, _ = _smatrix_pair(orders, 0.0, 0.0, False, NT ** 2)
    res = checks.reciprocity_residuals(
        S, S, perm, checks.flux_form(Kx, Ky, 1.0, 1.0),
        checks.flux_form(Kx, Ky, NG ** 2, NG))
    for name in ("s21", "s12", "s11"):
        assert float(res[name].max()) < 1e-8, (name, float(res[name]))


# ----- energy, dissipation and the eigenmode reference -----

def _cells(xyrra, eps_p, ux, uy, numG, hermitian=True):
    orders = ordmod.select_orders(LX, LY, numG)
    u, v = t64([ux]), t64([uy])
    S, Kx, Ky = rcwa.cell_smatrix(
        orders, t64(xyrra)[None], LX, LY, H, eps_p, NG ** 2, LAM, u, v,
        n_slabs=schedule(orders, eps_p), hermitian_eps=hermitian)
    t, r = checks.order_efficiencies(S, Kx, Ky, checks.incident_vector(
        u, v, "p", ordmod.order_index(orders, 0, 0), numG), NG ** 2, NG)
    ref, _, _ = reference_cell_smatrix(orders, xyrra, LX, LY, H, eps_p,
                                       NG ** 2, LAM, ux, uy)
    return S, float(t.sum()), float(r.sum()), ref


def _max_rel(got, ref):
    return np.abs(got[0].numpy() - ref).max() / np.abs(ref).max()


def test_absorbing_pillars_dissipate():
    """UV-class TiO2 (n = 2.9 + 0.25i): T + R < 1, T > 0.05, R > 0, and the
    solve on the pivoted eps inverse matches the eigenmode reference to
    1e-7, as tests/test_lossy_and_random.py."""
    S, T, R, ref = _cells(XYRRA_EIG, (2.9 + 0.25j) ** 2, 0.45,
                          0.0, 25, hermitian=False)
    assert T + R < 0.995 and T > 0.05 and R > 0.0
    assert _max_rel(S.s11, ref.s11) < 1e-7


@pytest.mark.parametrize("ux,uy", [(0.45, 0.0), (0.3, 0.15)])
def test_production_matches_eigenmode_reference(ux, uy):
    """All four blocks against the eigenmode route (1e-7 of the largest
    entry), energy to 1e-8 (tests/test_eig_ref.py at numG = 25)."""
    S, T, R, ref = _cells(XYRRA_EIG, NT ** 2, ux, uy, 25)
    assert abs(T + R - 1.0) < 1e-8
    for name in ("s11", "s12", "s21", "s22"):
        assert _max_rel(getattr(S, name), getattr(ref, name)) < 1e-7, name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_cells_match_eigenmode_reference(seed):
    """Random geometries and incidence (tests/test_lossy_and_random.py's
    draw): energy to 1e-8, s11 and s21 to 1e-6 of the largest entry."""
    rng = np.random.default_rng(seed)
    n_ell = int(rng.integers(1, 4))
    xyrra = np.zeros((n_ell, 5))
    xs = np.linspace(-LX / 3, LX / 3, n_ell)
    for i in range(n_ell):
        xyrra[i] = [xs[i] + rng.uniform(-30, 30) * NM,
                    rng.uniform(-20, 20) * NM, rng.uniform(60, 110) * NM,
                    rng.uniform(60, 110) * NM, rng.uniform(-0.6, 0.6)]
    ux, uy = float(rng.uniform(0.1, 0.6)), float(rng.uniform(-0.2, 0.2))
    S, T, R, ref = _cells(xyrra, NT ** 2, ux, uy, 21)
    assert abs(T + R - 1.0) < 1e-8
    assert _max_rel(S.s11, ref.s11) < 1e-6
    assert _max_rel(S.s21, ref.s21) < 1e-6
