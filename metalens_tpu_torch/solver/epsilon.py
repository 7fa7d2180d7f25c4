"""Analytic Fourier representation of the patterned (pillar) layer.

Counterpart of ``metalens_tpu/solver/epsilon.py``: the Laurent Toeplitz eps
matrix E[i, j] = eps_hat(G_i - G_j) of a layout of elliptical pillars, from
the closed-form ellipse transform

    FT[indicator](G) = 2 pi rx ry J1(u)/u,
    u = sqrt((G.e1 rx)^2 + (G.e2 ry)^2),  e1/e2 = rotated axes.

Geometry comes in batched: ``xyrra`` is (..., nE, 5) and every Toeplitz
result is (..., N, N).  The eps_hat values are computed once per distinct
order difference (static order set) or on a dense difference grid (order
set given as index tensors) and gathered into the Toeplitz layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace
from . import cpx
from .special import j1_over_x_from_sq

TWO_PI = 2.0 * np.pi


def _order_differences(orders):
    """Integer order differences dm[i,j] = m_i - m_j, for x and y."""
    orders = np.asarray(orders)
    mx = orders[:, 0]
    my = orders[:, 1]
    return (mx[:, None] - mx[None, :]).astype(np.float64), \
           (my[:, None] - my[None, :]).astype(np.float64)


def _distinct_differences(orders):
    """Distinct difference vectors (dmx_u, dmy_u) and the (N, N) int map
    into them (the Toeplitz structure: O(range_x * range_y) distinct
    values among the N^2 differences)."""
    dmx, dmy = _order_differences(orders)
    pairs = np.stack([dmx.ravel(), dmy.ravel()], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    return (uniq[:, 0], uniq[:, 1],
            inv.reshape(dmx.shape).astype(np.int64))


def ellipse_shape_sum(gx, gy, xyrra, area, small_arg_only=False):
    """Geometry-only structure factor S(G) = (1/area) sum_ellipses
    FT[indicator](G) e^{-i G.r0} at the K wavevectors (gx, gy); xyrra
    (..., nE, 5) gives (..., K) complex."""
    x0, y0 = xyrra[..., None, :, 0], xyrra[..., None, :, 1]
    rx, ry = xyrra[..., None, :, 2], xyrra[..., None, :, 3]
    ang = xyrra[..., None, :, 4]
    ca, sa = torch.cos(ang), torch.sin(ang)
    gxe = gx[:, None]
    gye = gy[:, None]
    u1 = (gxe * ca + gye * sa) * rx
    u2 = (-gxe * sa + gye * ca) * ry
    shape_ft = TWO_PI * rx * ry * j1_over_x_from_sq(
        u1 * u1 + u2 * u2, small_arg_only=small_arg_only)
    arg = -(gxe * x0 + gye * y0)                       # e^{-i G.r0}
    re = (torch.cos(arg) * shape_ft).sum(-1) * (1.0 / area)
    im = (torch.sin(arg) * shape_ft).sum(-1) * (1.0 / area)
    return torch.complex(re, im)


def _at_zero(gx, gy):
    return ((gx == 0) & (gy == 0)).to(gx.dtype)


def eps_fourier_ellipses(gx, gy, xyrra, eps_fill, eps_bg, area,
                         small_arg_only=False):
    """eps_hat at the wavevectors (gx, gy) (real tensors of one shape): the
    background eps_bg plus ellipses (xyrra (..., nE, 5)) of eps_fill;
    returns (..., *gx.shape) complex.  The eps may be complex numbers
    (absorbing materials)."""
    S = ellipse_shape_sum(gx.reshape(-1), gy.reshape(-1), xyrra, area,
                          small_arg_only)
    S = S.reshape(S.shape[:-1] + gx.shape)
    return toeplitz_from_structure(S, _at_zero(gx, gy), eps_fill, eps_bg)


def eps_fourier_rect(gx, gy, center, widths, eps_fill, eps_bg, area):
    """eps_hat of one axis-aligned rectangle (center (x0, y0), widths
    (wx, wy)) of eps_fill in eps_bg at the wavevectors (gx, gy)."""
    x0, y0 = center
    wx, wy = widths
    shape_ft = (wx * wy * torch.sinc(gx * wx / (2 * np.pi))
                * torch.sinc(gy * wy / (2 * np.pi)))
    arg = -(gx * x0 + gy * y0)                         # e^{-i G.r0}
    S = torch.complex(torch.cos(arg) * shape_ft,
                      torch.sin(arg) * shape_ft) * (1.0 / area)
    return toeplitz_from_structure(S, _at_zero(gx, gy), eps_fill, eps_bg)


def rect_layer_toeplitz(orders, grating_period, lateral_period, center,
                        widths, eps_fill, eps_bg=1.0, *, device="cuda",
                        dtype=None):
    """(N, N) Laurent Toeplitz eps matrix of one rectangle per cell (a
    lamellar grating, or a uniform layer at full widths), built on
    ``device`` (CUDA unless ``device="cpu"``) in the complex ``dtype``
    (complex128 on the CPU, complex64 on CUDA by default); the order
    differences go up without a host sync."""
    device = cpx.resolve_device(device)
    rdt = cpx.real_dtype(cpx.complex_dtype(device, dtype))
    area = grating_period * lateral_period
    dmx, dmy = _order_differences(orders)
    gx = cpx.upload(dmx, device, rdt) * (TWO_PI / grating_period)
    gy = cpx.upload(dmy, device, rdt) * (TWO_PI / lateral_period)
    return eps_fourier_rect(gx, gy, center, widths, eps_fill, eps_bg, area)


def ellipse_structure_toeplitz(orders, grating_period, lateral_period,
                               xyrra, small_arg_only=False):
    """The wavelength- and material-independent Toeplitz structure pair
    (S (..., N, N) complex, at_zero (N, N) real) with
    E = eps_bg at_zero + (eps_pillar - eps_bg) S, for a static order set."""
    area = grating_period * lateral_period
    dmx_u, dmy_u, gather = _distinct_differences(orders)
    kw = dict(dtype=xyrra.dtype, device=xyrra.device)
    gx = cpx.to_device(dmx_u, **kw) * (TWO_PI / grating_period)
    gy = cpx.to_device(dmy_u, **kw) * (TWO_PI / lateral_period)
    S_flat = ellipse_shape_sum(gx, gy, xyrra, area, small_arg_only)
    zero_flat = _at_zero(gx, gy)
    idx = cpx.to_device(gather, None, xyrra.device)
    return S_flat[..., idx], zero_flat[idx]


def dense_difference_grid(Dx: int, Dy: int):
    """Flat grid of ALL integer order differences with |dmx| <= Dx,
    |dmy| <= Dy, flat index k = (dmx+Dx)*(2*Dy+1) + (dmy+Dy)."""
    dd_x = np.arange(-Dx, Dx + 1)
    dd_y = np.arange(-Dy, Dy + 1)
    DMX, DMY = np.meshgrid(dd_x, dd_y, indexing="ij")
    return DMX.ravel().astype(np.float64), DMY.ravel().astype(np.float64)


@trace.watch_cache
@functools.lru_cache(maxsize=8)
def dense_grid_tensors(Dx: int, Dy: int, dtype: torch.dtype,
                       device: torch.device):
    """:func:`dense_difference_grid` and its zero-difference mask as
    tensors, made once per dtype and device (callers must not write to
    them)."""
    DMX, DMY = dense_difference_grid(Dx, Dy)
    kw = dict(dtype=dtype, device=device)
    return (torch.as_tensor(DMX, **kw), torch.as_tensor(DMY, **kw),
            torch.as_tensor((DMX == 0) & (DMY == 0), **kw))


def traced_gather_idx(mx, my, Dx: int, Dy: int):
    """(N, N) flat indices into :func:`dense_difference_grid` for the
    integer order tensors mx, my (N,); raises if a difference falls
    outside the grid bounds (on CUDA the check is a device-side assert, so
    that it reads nothing back to the host)."""
    dmx = mx[:, None] - mx[None, :]
    dmy = my[:, None] - my[None, :]
    if dmx.is_cuda:
        torch._assert_async((dmx.abs().max() <= Dx) & (dmy.abs().max() <= Dy))
    else:
        max_x, max_y = int(dmx.abs().max()), int(dmy.abs().max())
        if max_x > Dx or max_y > Dy:
            raise ValueError(
                f"order differences (|dmx| <= {max_x}, |dmy| <= {max_y}) "
                f"exceed the dense grid bounds (Dx={Dx}, Dy={Dy})")
    return (dmx + Dx) * (2 * Dy + 1) + (dmy + Dy)


def ellipse_structure_toeplitz_traced(mx, my, Dx: int, Dy: int,
                                      grating_period, lateral_period,
                                      xyrra, small_arg_only=False):
    """:func:`ellipse_structure_toeplitz` with the order set given as
    integer tensors mx, my (N,): the structure factor on the dense
    difference grid, gathered by :func:`traced_gather_idx`.  Same values
    as the static path."""
    area = grating_period * lateral_period
    DMX, DMY, zero_flat = dense_grid_tensors(Dx, Dy, xyrra.dtype,
                                             xyrra.device)
    gx = DMX * (TWO_PI / grating_period)
    gy = DMY * (TWO_PI / lateral_period)
    S_flat = ellipse_shape_sum(gx, gy, xyrra, area, small_arg_only)
    idx = traced_gather_idx(mx.to(xyrra.device), my.to(xyrra.device), Dx, Dy)
    return S_flat[..., idx], zero_flat[idx]


def toeplitz_from_structure(structure, at_zero, eps_pillar, eps_bg=1.0):
    """Assemble the eps Toeplitz from a structure pair."""
    d_eps = complex(eps_pillar) - complex(eps_bg)
    return structure * d_eps + at_zero * complex(eps_bg)


def ellipse_layer_toeplitz(orders, grating_period, lateral_period, xyrra,
                           eps_pillar, eps_bg=1.0, small_arg_only=False):
    """(..., N, N) Laurent Toeplitz eps matrix of the pillar layer."""
    S, at_zero = ellipse_structure_toeplitz(orders, grating_period,
                                            lateral_period, xyrra,
                                            small_arg_only)
    return toeplitz_from_structure(S, at_zero, eps_pillar, eps_bg)
