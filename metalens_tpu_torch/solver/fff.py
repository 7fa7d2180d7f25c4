"""Normal-vector-field Fourier factorization (NV).

Counterpart of ``metalens_tpu/solver/fff.py`` (see its docstring for the
physics): the in-plane eps operator

    [eps E]  =  <<eps>> E  -  sym(Delta P_hat) E,
    Delta    =  <<eps>> - inv(<<1/eps>>),
    P_hat    =  Toeplitz blocks of the normal-projector field n_i n_j,

with sym the anticommutator (Delta P + P Delta)/2, which for lossless Delta
equals the Hermitian part (X + X^H)/2 of X = Delta P -- one product cheaper.
The Hermitian part is wrong for lossy Delta (it breaks reciprocity and drops
the correction's absorption), so :func:`nv_blocks` keeps both routes.

Batched: ``xyrra`` is (..., nE, 5) and every block is (..., N, N).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace
from . import cpx
from .epsilon import (_distinct_differences, dense_difference_grid,
                      ellipse_structure_toeplitz, toeplitz_from_structure,
                      traced_gather_idx)

TWO_PI = 2.0 * np.pi


def _raster_basis_for(dmx_u, dmy_u, R: int):
    """Raster fractional coordinates and the DFT basis e^{-i g.r} over the
    given difference list (half-pixel offset, 1/R^2 normalization)."""
    f = (np.arange(R) + 0.5) / R - 0.5
    FX, FY = np.meshgrid(f, f, indexing="ij")
    ang = -TWO_PI * (np.outer(FX.ravel(), dmx_u) + np.outer(FY.ravel(), dmy_u))
    return (FX.ravel(), FY.ravel(), np.cos(ang) / (R * R),
            np.sin(ang) / (R * R))


@trace.watch_cache
@functools.lru_cache(maxsize=4)
def _raster_and_basis(orders_key, R: int):
    """Raster and DFT basis over the distinct differences of a static order
    set, plus the gather map (numpy; small cache, one entry is
    O(R^2 x nDiff))."""
    orders = np.asarray(orders_key, dtype=np.int64).reshape(-1, 2)
    dmx_u, dmy_u, gather = _distinct_differences(orders)
    return _raster_basis_for(dmx_u, dmy_u, R) + (gather,)


def _dense_raster_and_basis(Dx: int, Dy: int, R: int):
    """As :func:`_raster_and_basis` over the dense difference grid."""
    dmx_u, dmy_u = dense_difference_grid(Dx, Dy)
    return _raster_basis_for(dmx_u, dmy_u, R)


def _normal_field(xyrra, X, Y, Lx, Ly):
    """Raster samples (..., R^2) of the global nearest-pillar outward
    normal (nx, ny) at the points (X, Y) (R^2,) of one unit cell."""
    shape = xyrra.shape[:-2] + X.shape
    nx_acc = torch.zeros(shape, dtype=X.dtype, device=X.device)
    ny_acc = torch.zeros_like(nx_acc)
    u_best = torch.full_like(nx_acc, float("inf"))
    for e in range(xyrra.shape[-2]):
        x0, y0, rx, ry, a = (xyrra[..., e, k, None] for k in range(5))
        ca, sa = torch.cos(a), torch.sin(a)
        # periodic-nearest displacement to the pillar center
        dx = X - x0
        dx = dx - Lx * torch.round(dx / Lx)
        dy = Y - y0
        dy = dy - Ly * torch.round(dy / Ly)
        xp = dx * ca + dy * sa
        yp = -dx * sa + dy * ca
        u = torch.sqrt((xp / rx) ** 2 + (yp / ry) ** 2 + 1e-30)
        # outward normal of the level set: grad of (xp/rx)^2 + (yp/ry)^2
        gx_ = xp / rx ** 2
        gy_ = yp / ry ** 2
        norm = torch.sqrt(gx_ ** 2 + gy_ ** 2 + 1e-30)
        nxp, nyp = gx_ / norm, gy_ / norm
        nx = nxp * ca - nyp * sa
        ny = nxp * sa + nyp * ca
        # distance-to-boundary proxy in scaled coords: |u - 1|
        d = torch.abs(u - 1.0)
        take = d < u_best
        nx_acc = torch.where(take, nx, nx_acc)
        ny_acc = torch.where(take, ny, ny_acc)
        u_best = torch.minimum(u_best, d)
    return nx_acc, ny_acc


def _projector_blocks(xyrra, fx, fy, dft_re, dft_im, idx, Lx, Ly):
    kw = dict(dtype=xyrra.dtype, device=xyrra.device)
    X = cpx.to_device(fx, **kw) * Lx
    Y = cpx.to_device(fy, **kw) * Ly
    nx_acc, ny_acc = _normal_field(xyrra, X, Y, Lx, Ly)
    basis_re = cpx.to_device(dft_re, **kw)
    basis_im = cpx.to_device(dft_im, **kw)

    def project(field):
        return torch.complex(field @ basis_re, field @ basis_im)[..., idx]

    return (project(nx_acc * nx_acc), project(nx_acc * ny_acc),
            project(ny_acc * ny_acc))


def normal_projector_toeplitz(orders, grating_period, lateral_period, xyrra,
                              R: int = 64):
    """Toeplitz blocks (Pxx, Pxy, Pyy) of the normal-projector field
    n_i n_j for a static order set.  The field is global (|n| = 1
    everywhere): at every raster point, the normal of the nearest pillar."""
    orders_key = tuple(map(tuple, np.asarray(orders).tolist()))
    fx, fy, dft_re, dft_im, gather = _raster_and_basis(orders_key, R)
    idx = cpx.to_device(gather, None, xyrra.device)
    return _projector_blocks(xyrra, fx, fy, dft_re, dft_im, idx,
                             grating_period, lateral_period)


@trace.watch_cache
@functools.lru_cache(maxsize=4)
def _dense_raster_and_basis_tensors(Dx: int, Dy: int, R: int,
                                    dtype: torch.dtype,
                                    device: torch.device):
    """:func:`_dense_raster_and_basis` as tensors, made once per dtype and
    device, so that a FOM batch uploads nothing (callers must not write to
    them)."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in _dense_raster_and_basis(Dx, Dy, R))


def normal_projector_toeplitz_traced(mx, my, Dx: int, Dy: int,
                                     grating_period, lateral_period, xyrra,
                                     R: int = 64):
    """:func:`normal_projector_toeplitz` with the order set given as integer
    tensors mx, my (bound |dmx| <= Dx, |dmy| <= Dy): projects onto the
    dense difference grid and gathers."""
    fx, fy, dft_re, dft_im = _dense_raster_and_basis_tensors(
        Dx, Dy, R, xyrra.dtype, xyrra.device)
    idx = traced_gather_idx(mx.to(xyrra.device), my.to(xyrra.device), Dx, Dy)
    return _projector_blocks(xyrra, fx, fy, dft_re, dft_im, idx,
                             grating_period, lateral_period)


def hermitian_part(X):
    """(X + X^H)/2 of each matrix of the batch."""
    return (X + X.mH) * 0.5


def nv_blocks(E, Delta, Pxx, Pxy, Pyy, hermitian: bool = True):
    """The symmetrized NV-corrected in-plane eps blocks (Mxx, Mxy, Myy).

    ``hermitian=True`` (lossless Delta) takes the Hermitian part of
    Delta P, identical there to the anticommutator; ``hermitian=False``
    (lossy Delta) must take the anticommutator (Delta P + P Delta)/2."""
    if hermitian:
        def sym(P):
            return hermitian_part(Delta @ P)
    else:
        def sym(P):
            return (Delta @ P + P @ Delta) * 0.5
    Mxx = E - sym(Pxx)
    Mxy = -sym(Pxy)
    Myy = E - sym(Pyy)
    return Mxx, Mxy, Myy


def nv_blocks_from_structure(S_struct, at_zero, eps_pillar, P_blocks,
                             hermitian: bool = True, eps_bg=1.0, E=None):
    """The whole NV eps build from a geometry structure matrix: <<eps>>,
    the inverse of <<1/eps>> (same structure, reciprocal fill), Delta and
    the symmetrized blocks.  Returns (E, (Mxx, Mxy, Myy)).

    Routing: lossless eps (``hermitian=True``) makes <<1/eps>> Hermitian
    positive definite, so the unpivoted :func:`cpx.solve` contract holds
    (the CUDA inverse on the card, :func:`cpx.inverse`); absorbing eps
    takes the pivoted :func:`cpx.solve_embed`."""
    if E is None:
        E = toeplitz_from_structure(S_struct, at_zero, eps_pillar, eps_bg)
    inv_fill = 1.0 / complex(eps_pillar)
    inv_bg = 1.0 / complex(eps_bg)
    E_recip = S_struct * (inv_fill - inv_bg) + at_zero * inv_bg
    if hermitian:
        inv_recip = cpx.inverse(E_recip)
    else:
        inv_recip = cpx.solve_embed(E_recip,
                                    cpx.eye(E.shape[-1], E).expand_as(E))
    Delta = E - inv_recip
    Pxx, Pxy, Pyy = P_blocks
    return E, nv_blocks(E, Delta, Pxx, Pxy, Pyy, hermitian=hermitian)


def fff_eps_blocks(orders, grating_period, lateral_period, xyrra,
                   eps_pillar, eps_bg=1.0, R: int = 64,
                   small_arg_only: bool = False, hermitian: bool = True):
    """<<eps>> and the NV blocks (Mxx, Mxy, Myy) for a static order set;
    ``hermitian=False`` for absorbing pillar materials."""
    S, at_zero = ellipse_structure_toeplitz(orders, grating_period,
                                            lateral_period, xyrra,
                                            small_arg_only)
    P_blocks = normal_projector_toeplitz(
        orders, grating_period, lateral_period, xyrra, R=R)
    E, (Mxx, Mxy, Myy) = nv_blocks_from_structure(
        S, at_zero, eps_pillar, P_blocks, hermitian=hermitian, eps_bg=eps_bg)
    return E, Mxx, Mxy, Myy
