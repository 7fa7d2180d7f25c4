"""Eig-free RCWA (Fourier Modal Method) S-matrix solver of the port.

Counterpart of ``metalens_tpu/solver/rcwa.py`` (see its docstring for the
derivation).  The layer S-matrix is built without an eigensolver:

1. Maxwell in Fourier space: d/dz [e; h] = i k0 [[0, F], [G, 0]] [e; h]
   (:func:`build_FG`).
2. The transfer matrix of a thin sub-slab is three Taylor series in
   Y = t^2 F G (:func:`thin_slab_T_blocks`, via :mod:`.taylor` -- the CUDA
   kernel on the card).
3. The thin-slab transfer matrix becomes an S-matrix in the lossy reference
   basis ``EPS_REF``, and the layer is assembled by Redheffer doubling.
4. Analytic per-order 2x2 interfaces connect to air and glass.

Every dense solve is :func:`cpx.inverse` / :func:`cpx.solve` (the CUDA
inverse on the card).  Every function takes a leading batch axis B (cells x
directions): E is (B, N, N), Kx and Ky are (B, N), S-matrix blocks
(B, 2N, 2N), per-order block operators (B, N).  Amplitude conventions match
S4 exactly (see :mod:`.basis`).
"""

from __future__ import annotations

import math
import numbers
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from . import basis, cpx, taylor
from .epsilon import ellipse_layer_toeplitz

TWO_PI = 2.0 * np.pi


class SMatrix(NamedTuple):
    """Scattering matrix with ports [c_f(top-in); c_b(bottom-in)] ->
    [c_f(bottom-out); c_b(top-out)]:

        c_f(bot) = s11 c_f(top) + s12 c_b(bot)
        c_b(top) = s21 c_f(top) + s22 c_b(bot)
    """
    s11: torch.Tensor
    s12: torch.Tensor
    s21: torch.Tensor
    s22: torch.Tensor


# ----- block helpers: multiply dense (B, 2N, K) by diag-block operators -----

def _left_bmul(blocks, M):
    A, B, Cb, D = blocks
    N = A.shape[-1]
    top = A[..., :, None] * M[..., :N, :] + B[..., :, None] * M[..., N:, :]
    bot = Cb[..., :, None] * M[..., :N, :] + D[..., :, None] * M[..., N:, :]
    return torch.cat([top, bot], dim=-2)


def _right_bmul(M, blocks):
    A, B, Cb, D = blocks
    N = A.shape[-1]
    left = M[..., :, :N] * A[..., None, :] + M[..., :, N:] * Cb[..., None, :]
    right = M[..., :, :N] * B[..., None, :] + M[..., :, N:] * D[..., None, :]
    return torch.cat([left, right], dim=-1)


def build_FG(E, Einv, Kx, Ky, M_blocks=None):
    """The first-order Maxwell operators of a patterned layer (K's
    normalized by k0): dz [ex;ey] = i k0 F [hx;hy], dz [hx;hy] = i k0 G
    [ex;ey].  ``M_blocks = (Mxx, Mxy, Myy)`` is the in-plane eps operator;
    None means the Laurent rule (Mxx = Myy = E, Mxy = 0).  The E_z
    elimination in F always uses the Laurent inverse Einv."""
    N = Kx.shape[-1]
    KxE = Einv * Kx[..., :, None]
    KyE = Einv * Ky[..., :, None]
    I = cpx.eye(N, E)
    F = torch.cat([
        torch.cat([KxE * Ky[..., None, :], (KxE * Kx[..., None, :]) * -1.0 + I],
                  dim=-1),
        torch.cat([KyE * Ky[..., None, :] - I, (KyE * Kx[..., None, :]) * -1.0],
                  dim=-1)], dim=-2)
    dKxKy = torch.diag_embed(Kx * Ky).to(E.dtype)
    dKx2 = torch.diag_embed(Kx * Kx).to(E.dtype)
    dKy2 = torch.diag_embed(Ky * Ky).to(E.dtype)
    if M_blocks is None:
        Mxx, Mxy, Myy = E, None, E
    else:
        Mxx, Mxy, Myy = M_blocks
    G11 = -dKxKy if Mxy is None else (-Mxy) + (-dKxKy)
    G22 = dKxKy if Mxy is None else Mxy + dKxKy
    G = torch.cat([
        torch.cat([G11, (-Myy) + dKx2], dim=-1),
        torch.cat([Mxx - dKy2, G22], dim=-1)], dim=-2)
    return F, G


def thin_slab_T_blocks(F, G, t, taylor_terms: int):
    """Blocks of expm(i t [[0,F],[G,0]]) via the Taylor series in
    Y = t^2 F G (the factors come from :func:`taylor.taylor_factors`); t is
    a number or a (B,) tensor (one slab thickness per cell):

        T11 = CS,  T12 = i t SF,  T21 = i t GS,  T22 = I + t^2 GRF.
    """
    CS, SF, GS, GRF = taylor.taylor_factors(F, G, t, taylor_terms)
    I = cpx.eye(F.shape[-1], F)
    tt = taylor._batch_scalar(t, F)
    return CS, SF * 1j * tt, GS * 1j * tt, I + GRF * (tt * tt)


def _transfer_to_smatrix(M11, M12, M21, M22) -> SMatrix:
    """Amplitude-space transfer matrix -> scattering matrix."""
    M22inv = cpx.inverse(M22)
    s21 = -(M22inv @ M21)
    return SMatrix(M11 + M12 @ s21, M12 @ M22inv, s21, M22inv)


def _transfer_to_smatrix_symmetric(M21, M22) -> SMatrix:
    """Transfer -> scattering for a mirror-symmetric slab: s11 = s22 =
    M22^-1 and s12 = s21 = -M22^-1 M21."""
    M22inv = cpx.inverse(M22)
    s21 = -(M22inv @ M21)
    return SMatrix(M22inv, s21, s21, M22inv)


def slab_smatrix_in_basis(T, we, we_inv, symmetric: bool = True) -> SMatrix:
    """Field-space transfer blocks T of a z-uniform slab -> amplitude-space
    S-matrix in the uniform-medium basis ``we`` / ``we_inv`` (same medium
    both sides; e = We (c_f - c_b), h = c_f + c_b).  Such a slab is mirror
    symmetric, so ``symmetric=True`` forms only M21 and M22; ``False``
    takes the general transfer -> scattering conversion."""
    T11, T12, T21, T22 = T
    T11we = _right_bmul(T11, we)
    T21we = _right_bmul(T21, we)
    P11, P12 = T11we + T12, -T11we + T12       # act on c_f, c_b
    P21, P22 = T21we + T22, -T21we + T22
    M21 = (-_left_bmul(we_inv, P11) + P21) * 0.5
    M22 = (-_left_bmul(we_inv, P12) + P22) * 0.5
    if symmetric:
        return _transfer_to_smatrix_symmetric(M21, M22)
    M11 = (_left_bmul(we_inv, P11) + P21) * 0.5
    M12 = (_left_bmul(we_inv, P12) + P22) * 0.5
    return _transfer_to_smatrix(M11, M12, M21, M22)


def redheffer_star_self_symmetric(S: SMatrix) -> SMatrix:
    """Star of a mirror-symmetric S-matrix with itself (the doubling step):
    Y = X0 s11 with X0 = (I - s12^2)^-1, s11' = s11 Y,
    s12' = s12 + s11 (s12 Y)."""
    I = cpx.eye(S.s11.shape[-1], S.s11)
    Y = cpx.solve(I - S.s12 @ S.s12, S.s11)
    s11 = S.s11 @ Y
    s12 = S.s12 + S.s11 @ (S.s12 @ Y)
    return SMatrix(s11, s12, s12, s11)


def redheffer_star(A: SMatrix, B: SMatrix) -> SMatrix:
    """Stack S-matrix A (top) on B (bottom): the general star product, one
    solve with both right-hand sides."""
    n2 = A.s11.shape[-1]
    I = cpx.eye(n2, A.s11)
    X = cpx.solve(I - A.s12 @ B.s21,
                  torch.cat([A.s11, A.s12 @ B.s22], dim=-1))
    XA11, XA12B22 = X[..., :, :n2], X[..., :, n2:]
    return SMatrix(B.s11 @ XA11, B.s12 + B.s11 @ XA12B22,
                   A.s21 + A.s22 @ (B.s21 @ XA11),
                   A.s22 @ (B.s21 @ XA12B22 + B.s22))


class BlockSMatrix(NamedTuple):
    """S-matrix of a zero-thickness interface: each port map is a per-order
    2x2, stored as an (A, B, C, D) tuple of (B, N) tensors."""
    s11: tuple
    s12: tuple
    s21: tuple
    s22: tuple


def interface_smatrix_blocks(we_top, we_top_inv, we_bot, we_bot_inv) \
        -> BlockSMatrix:
    """Analytic S-matrix of a flat interface between two uniform media in
    their own plane-wave bases: M11 = M22 = (Wb^-1 Wa + I)/2,
    M12 = M21 = (I - Wb^-1 Wa)/2."""
    one = torch.ones_like(we_top[0])
    zero = one * 0.0
    ident = (one, zero, zero, one)
    WbiWa = basis.block_compose(we_bot_inv, we_top)
    M11 = tuple((x + y) * 0.5 for x, y in zip(WbiWa, ident))
    M12 = tuple((x - y) * 0.5 for x, y in zip(ident, WbiWa))
    M22inv = basis.block_inv(M11)       # M22 == M11, M21 == M12
    s21_b = tuple(-x for x in basis.block_compose(M22inv, M12))
    s11_b = tuple(x + y for x, y in
                  zip(M11, basis.block_compose(M12, s21_b)))
    s12_b = basis.block_compose(M12, M22inv)
    return BlockSMatrix(s11_b, s12_b, s21_b, M22inv)


def interface_smatrix(we_top, we_top_inv, we_bot, we_bot_inv) -> SMatrix:
    """Dense form of :func:`interface_smatrix_blocks`."""
    b = interface_smatrix_blocks(we_top, we_top_inv, we_bot, we_bot_inv)
    return SMatrix(*(basis.block_to_dense(x) for x in b))


FULL_OUTPUTS = ("s11", "s12", "s21", "s22")


def star_blockdiag_dense(A: BlockSMatrix, B: SMatrix,
                         outputs=FULL_OUTPUTS) -> SMatrix:
    """Star product with a diag-block TOP factor (a zero-thickness
    interface); only the blocks named in ``outputs`` are formed (the others
    are None).  ``B`` may have None blocks as long as the ones read are
    present: s21 always; s11 for s11'/s12'; s12 for s12'; s22 for
    s12'/s22'."""
    n2 = B.s21.shape[-1]
    I = cpx.eye(n2, B.s21)
    X0 = cpx.inverse(I - _left_bmul(A.s12, B.s21))
    XA11 = _right_bmul(X0, A.s11)
    s11 = B.s11 @ XA11 if "s11" in outputs else None
    s21 = (basis.block_to_dense(A.s21) + _left_bmul(A.s22, B.s21 @ XA11)
           if "s21" in outputs else None)
    s12 = s22 = None
    if "s12" in outputs or "s22" in outputs:
        XA12B22 = _right_bmul(X0, A.s12) @ B.s22
        if "s12" in outputs:
            s12 = B.s12 + B.s11 @ XA12B22
        if "s22" in outputs:
            s22 = _left_bmul(A.s22, B.s21 @ XA12B22 + B.s22)
    return SMatrix(s11, s12, s21, s22)


def star_dense_blockdiag(A: SMatrix, B: BlockSMatrix,
                         outputs=FULL_OUTPUTS) -> SMatrix:
    """Star product with a diag-block BOTTOM factor (mirror of
    :func:`star_blockdiag_dense`; dropping s12/s22 also halves the solve's
    right-hand side)."""
    n2 = A.s11.shape[-1]
    I = cpx.eye(n2, A.s11)
    A12B21 = _right_bmul(A.s12, B.s21)
    back = "s12" in outputs or "s22" in outputs
    rhs = (torch.cat([A.s11, _right_bmul(A.s12, B.s22)], dim=-1)
           if back else A.s11)
    X = cpx.solve(I - A12B21, rhs)
    XA11 = X[..., :, :n2]
    s11 = _left_bmul(B.s11, XA11) if "s11" in outputs else None
    s21 = (A.s21 + A.s22 @ _left_bmul(B.s21, XA11)
           if "s21" in outputs else None)
    s12 = s22 = None
    if back:
        XA12B22 = X[..., :, n2:]
        if "s12" in outputs:
            s12 = basis.block_to_dense(B.s12) + _left_bmul(B.s11, XA12B22)
        if "s22" in outputs:
            s22 = A.s22 @ (_left_bmul(B.s21, XA12B22)
                           + basis.block_to_dense(B.s22))
    return SMatrix(s11, s12, s21, s22)


# ----- slab schedule -----

def default_n_slabs(k0h_max: float, q2_max: float, target: float = 4.5) -> int:
    """Smallest power of two slab count with t*q_max <= target (4.5 pairs
    with the 12-term series)."""
    n = max(1.0, k0h_max * math.sqrt(q2_max) / target)
    return int(2 ** math.ceil(math.log2(n)))


def q2_upper_bound(orders, grating_period, lateral_period, wavelength,
                   eps_max: float) -> float:
    """Cheap upper bound on the spectral radius of FG (normalized q^2)."""
    orders = np.asarray(orders)
    kx = orders[:, 0] * wavelength / grating_period
    ky = orders[:, 1] * wavelength / lateral_period
    kmax2 = float(((np.abs(kx) + 1.0) ** 2 + (np.abs(ky) + 1.0) ** 2).max())
    return kmax2 + eps_max


# Per-slab t*q caps by working precision (measured table and mechanism in
# ``metalens_tpu/solver/rcwa.py`` above SLAB_CAP_F64): in float32 the slab
# transfer entries grow ~e^{t*q} and the S-conversion cancels them back to
# O(1), so the recoverable accuracy is ~eps * e^{t*q}.
SLAB_CAP_F64 = 16.5
SLAB_CAP_F32 = 11.0


def slab_cap(dtype: torch.dtype) -> float:
    """Per-slab t*q cap for the working dtype (real or complex), always
    given explicitly."""
    wide = dtype in (torch.float64, torch.complex128)
    if not wide and dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"no slab cap for dtype {dtype}")
    return SLAB_CAP_F64 if wide else SLAB_CAP_F32


def slab_schedule(k0h_max: float, orders, grating_period, lateral_period,
                  wavelength, eps_max: float, u_max: float = 1.0,
                  target: float | None = None, safety: float = 1.05, *,
                  dtype: torch.dtype | None = None):
    """(n_slabs, taylor_terms) pairing for the doubling assembly, sized from
    the per-order spectral bound (|G_i| + u_max)^2 + eps_max >= rho(FG).
    ``target`` caps the per-slab t*q; ``target=None`` takes
    :func:`slab_cap` of ``dtype``, which must then be given.  The series
    length is sized from the actual per-slab norm (tail < 1e-12) and
    rounded up to a multiple of 4."""
    if target is None:
        if dtype is None:
            raise ValueError("slab_schedule needs target or dtype")
        target = slab_cap(dtype)
    orders = np.asarray(orders)
    kx = orders[:, 0] * wavelength / grating_period
    ky = orders[:, 1] * wavelength / lateral_period
    kmax = float(np.sqrt(kx ** 2 + ky ** 2).max()) + u_max
    q2 = (kmax * kmax + eps_max) * safety
    n = max(1.0, k0h_max * math.sqrt(q2) / target)
    n_slabs = int(2 ** math.ceil(math.log2(n)))
    y = (k0h_max * math.sqrt(q2) / n_slabs) ** 2 * safety
    term, k = y, 1
    while term * y / ((2 * k + 1) * (2 * k + 2)) > 1e-12 or k < 3:
        k += 1
        term = term * y / ((2 * k - 1) * (2 * k))
    return n_slabs, -(-k // 4) * 4


# The lossy reference medium of the doubling basis: a complex eps_ref bounds
# |kz| below for every real transverse k, so no order grazes and every
# doubling stays well conditioned (a real-medium basis amplifies noise ~1e4x).
EPS_REF = 1.5 + 1.0j


def _medium_blocks(Kx, Ky, eps, branch_eps):
    """(we, we_inv) of the uniform medium eps: a python number, or a (B,)
    complex tensor (one medium per cell)."""
    if torch.is_tensor(eps) and eps.ndim > 0:
        eps = cpx.to_device(eps, cpx.to_complex(Kx.dtype),
                            Kx.device).reshape(-1, 1)
        Kz = basis.kz_norm(Kx, Ky, eps, branch_eps)
        n = cpx.csqrt_posim(eps)
    else:
        Kz = basis.kz_norm(Kx, Ky, eps, branch_eps)
        n = 1.0 if eps == 1.0 else cpx.csqrt_posim(cpx.scalar(eps, Kz))
    return basis.we_blocks(Kx, Ky, Kz, n), basis.we_inv_blocks(Kx, Ky, Kz, n)


def layer_smatrix(E, Kx, Ky, k0h, n_slabs: int, taylor_terms: int,
                  eps_ref=EPS_REF, branch_eps: float = 1e-9,
                  M_blocks=None, hermitian_eps: bool = True,
                  Einv=None) -> SMatrix:
    """S-matrix of the patterned layer of normalized thickness ``k0h`` (a
    number or a (B,) tensor) in the plane-wave basis of the uniform
    ``eps_ref`` medium (a real or complex number, by default the lossy
    ``EPS_REF``) on both faces.  ``hermitian_eps=False`` (absorbing
    pillars) inverts E by the pivoted solve.  A caller that sweeps many
    incidence directions over one geometry passes the
    direction-independent ``Einv``."""
    if n_slabs & (n_slabs - 1) or n_slabs < 1:
        raise ValueError(f"n_slabs must be a power of two (doubling "
                         f"assembly), got {n_slabs}")
    if Einv is None:
        Einv = invert_eps(E, hermitian_eps)
    F, G = build_FG(E, Einv, Kx, Ky, M_blocks)
    t = k0h / n_slabs
    T = thin_slab_T_blocks(F.contiguous(), G.contiguous(), t, taylor_terms)
    we, we_inv = _medium_blocks(Kx, Ky, eps_ref, branch_eps)
    S = slab_smatrix_in_basis(T, we, we_inv)
    for _ in range(int(math.log2(n_slabs))):
        S = redheffer_star_self_symmetric(S)
    return S


def invert_eps(E, hermitian_eps: bool = True):
    """E^-1 of a batch of eps Toeplitz matrices: the unpivoted inverse (the
    CUDA kernel on the card) for lossless eps, which is Hermitian positive
    definite, and the pivoted solve for absorbing eps."""
    if hermitian_eps:
        return cpx.inverse(E)
    return cpx.solve_embed(E, cpx.eye(E.shape[-1], E).expand_as(E))


@trace.traced("rcwa.eps")
def build_layer_eps(orders, grating_period, lateral_period, xyrra,
                    eps_pillar, eps_small_u: bool = False, fff: bool = False,
                    hermitian_eps: bool = True):
    """The eps front end shared by the cell solves: (E, M_blocks) -- the
    Laurent eps matrix plus, with ``fff``, the NV blocks (Mxx, Mxy, Myy)."""
    if fff:
        from .fff import fff_eps_blocks
        E, Mxx, Mxy, Myy = fff_eps_blocks(
            np.asarray(orders), grating_period, lateral_period, xyrra,
            eps_pillar, small_arg_only=eps_small_u, hermitian=hermitian_eps)
        return E, (Mxx, Mxy, Myy)
    E = ellipse_layer_toeplitz(np.asarray(orders), grating_period,
                               lateral_period, xyrra, eps_pillar,
                               small_arg_only=eps_small_u)
    return E, None


def _batch_col(x, B: int, like: torch.Tensor):
    """A number or a (B,) tensor as a (B, 1) real column (a number is
    filled in on the device: no upload, so no host sync on CUDA)."""
    if isinstance(x, numbers.Real):
        x = torch.full((1,), float(x), dtype=like.dtype, device=like.device)
    else:
        x = cpx.to_device(x, like.dtype, like.device)
    return x.reshape(-1, 1).expand(B, 1)


def _per_cell(x):
    """True for a (B,) tensor (one value per cell), False for a number."""
    return torch.is_tensor(x) and x.ndim > 0


def _cell_parts(orders, E, grating_period, lateral_period, cyl_height,
                eps_glass, wavelength, ux, uy, n_slabs: int,
                taylor_terms: int, branch_eps: float, M_blocks,
                hermitian_eps: bool, Einv=None):
    """The doubled layer S-matrix in the lossy reference basis plus the two
    conversion interfaces (air | ref on top, ref | glass below).
    ``wavelength`` and ``eps_glass`` are numbers or (B,) tensors, one per
    cell (a wavelength-major characterize batch)."""
    B = E.shape[0]
    rdt = cpx.real_dtype(E.dtype)
    o = cpx.to_device(orders, rdt, E.device)
    lam = _batch_col(wavelength, B, o) if _per_cell(wavelength) \
        else wavelength
    Kx = _batch_col(ux, B, o) + o[None, :, 0] * (lam / grating_period)
    Ky = _batch_col(uy, B, o) + o[None, :, 1] * (lam / lateral_period)
    k0h = TWO_PI * cyl_height / lam
    if _per_cell(wavelength):
        k0h = k0h.reshape(B)
    S_layer = layer_smatrix(E, Kx, Ky, k0h, n_slabs, taylor_terms,
                            branch_eps=branch_eps, M_blocks=M_blocks,
                            hermitian_eps=hermitian_eps, Einv=Einv)
    we_a, wei_a = _medium_blocks(Kx, Ky, 1.0, branch_eps)
    we_g, wei_g = _medium_blocks(Kx, Ky, eps_glass, branch_eps)
    we_r, wei_r = _medium_blocks(Kx, Ky, EPS_REF, branch_eps)
    S_air_ref = interface_smatrix_blocks(we_a, wei_a, we_r, wei_r)
    S_ref_glass = interface_smatrix_blocks(we_r, wei_r, we_g, wei_g)
    return S_layer, S_air_ref, S_ref_glass, Kx, Ky


def cell_smatrix_with_eps(orders, E, grating_period, lateral_period,
                          cyl_height, eps_glass, wavelength, ux, uy,
                          n_slabs: int, taylor_terms: int = 12,
                          branch_eps: float = 1e-9, M_blocks=None,
                          hermitian_eps: bool = True, outputs=FULL_OUTPUTS):
    """Air / layer / glass S-matrix for a batch of Toeplitz eps matrices E
    (B, N, N).  Returns (S, Kx, Ky); blocks not in ``outputs`` are None."""
    S_layer, S_air_ref, S_ref_glass, Kx, Ky = _cell_parts(
        orders, E, grating_period, lateral_period, cyl_height, eps_glass,
        wavelength, ux, uy, n_slabs, taylor_terms, branch_eps, M_blocks,
        hermitian_eps)
    # the outer star's block dependencies on the inner result
    inner = {"s21"}
    if "s11" in outputs or "s12" in outputs:
        inner.add("s11")
    if "s12" in outputs or "s22" in outputs:
        inner.add("s22")
    if "s12" in outputs:
        inner.add("s12")
    S = star_blockdiag_dense(
        S_air_ref,
        star_dense_blockdiag(S_layer, S_ref_glass,
                             outputs=tuple(sorted(inner))),
        outputs=outputs)
    return S, Kx, Ky


def cell_smatrix(orders, xyrra, grating_period, lateral_period, cyl_height,
                 eps_pillar, eps_glass, wavelength, ux, uy,
                 n_slabs: int, taylor_terms: int = 12,
                 branch_eps: float = 1e-9, eps_small_u: bool = False,
                 fff: bool = False, hermitian_eps: bool = True,
                 outputs=FULL_OUTPUTS):
    """Air / pillar-layer / glass S-matrix of a batch of unit cells
    (``xyrra`` (B, nE, 5)) at incidence (ux, uy) (numbers or (B,)).  Ports:
    top = air plane-wave basis, bottom = glass plane-wave basis (S4's
    GetAmplitudes bases).  Returns (S, Kx, Ky)."""
    E, M_blocks = build_layer_eps(orders, grating_period, lateral_period,
                                  xyrra, eps_pillar, eps_small_u=eps_small_u,
                                  fff=fff, hermitian_eps=hermitian_eps)
    return cell_smatrix_with_eps(orders, E, grating_period, lateral_period,
                                 cyl_height, eps_glass, wavelength, ux, uy,
                                 n_slabs=n_slabs, taylor_terms=taylor_terms,
                                 branch_eps=branch_eps, M_blocks=M_blocks,
                                 hermitian_eps=hermitian_eps, outputs=outputs)


@trace.traced("rcwa.solve")
def cell_amplitudes_with_eps(orders, E, grating_period, lateral_period,
                             cyl_height, eps_glass, wavelength, ux, uy,
                             c_inc, n_slabs: int, taylor_terms: int = 12,
                             branch_eps: float = 1e-9, M_blocks=None,
                             hermitian_eps: bool = True,
                             want_reflection: bool = True, Einv=None):
    """Scattered amplitudes (s11 @ c_inc, s21 @ c_inc) without forming the
    composite S-matrix: the outer conversion star is applied straight to
    the incident amplitudes c_inc ((2N, K) or (B, 2N, K)):

        ampf = inner.s11 @ (X0 @ (A.s11 . c)),
        ampr = A.s21 . c + A.s22 . (inner.s21 @ (X0 @ (A.s11 . c))).

    ``wavelength``, ``eps_glass``, ``ux`` and ``uy`` are numbers or (B,)
    tensors.  ``Einv``: E's inverse, when the caller has it (it depends on
    the geometry and the wavelength, not on the direction).
    ``want_reflection=False`` (the FOM path) skips ampr.  Returns
    (ampf, ampr or None, Kx, Ky)."""
    S_layer, A, S_ref_glass, Kx, Ky = _cell_parts(
        orders, E, grating_period, lateral_period, cyl_height, eps_glass,
        wavelength, ux, uy, n_slabs, taylor_terms, branch_eps, M_blocks,
        hermitian_eps, Einv=Einv)
    inner = star_dense_blockdiag(S_layer, S_ref_glass,
                                 outputs=("s11", "s21"))
    n2 = inner.s11.shape[-1]
    I = cpx.eye(n2, inner.s11)
    X0 = cpx.inverse(I - _left_bmul(A.s12, inner.s21))
    c = cpx.to_device(c_inc, E.dtype, E.device)
    if c.ndim < 2:
        raise ValueError("c_inc must be (2N, K) or (B, 2N, K)")
    v = X0 @ _left_bmul(A.s11, c)
    ampf = inner.s11 @ v
    if not want_reflection:
        return ampf, None, Kx, Ky
    ampr = _left_bmul(A.s21, c) + _left_bmul(A.s22, inner.s21 @ v)
    return ampf, ampr, Kx, Ky


def cell_amplitudes(orders, xyrra, grating_period, lateral_period,
                    cyl_height, eps_pillar, eps_glass, wavelength, ux, uy,
                    c_inc, n_slabs: int, taylor_terms: int = 12,
                    branch_eps: float = 1e-9, eps_small_u: bool = False,
                    fff: bool = False, hermitian_eps: bool = True,
                    want_reflection: bool = True):
    """:func:`cell_amplitudes_with_eps` with the eps Toeplitz built from the
    ellipse batch ``xyrra`` (B, nE, 5); the device and dtype follow
    ``xyrra`` (float64 -> complex128, float32 -> complex64)."""
    E, M_blocks = build_layer_eps(orders, grating_period, lateral_period,
                                  xyrra, eps_pillar, eps_small_u=eps_small_u,
                                  fff=fff, hermitian_eps=hermitian_eps)
    return cell_amplitudes_with_eps(
        orders, E, grating_period, lateral_period, cyl_height, eps_glass,
        wavelength, ux, uy, c_inc, n_slabs=n_slabs,
        taylor_terms=taylor_terms, branch_eps=branch_eps,
        M_blocks=M_blocks, hermitian_eps=hermitian_eps,
        want_reflection=want_reflection)


def scatter_amplitudes(S: SMatrix, c_inc):
    """Transmitted (into glass, forward) and reflected (into air, backward)
    amplitudes (s11 @ c, s21 @ c) for incident amplitudes c_inc ((2N,),
    (2N, K) or (B, 2N, K), in S4's [y-block; x-block] layout), moved to
    S's device and dtype."""
    c = torch.as_tensor(c_inc).to(device=S.s11.device, dtype=S.s11.dtype)
    return S.s11 @ c, S.s21 @ c
