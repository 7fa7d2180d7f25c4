"""Amplitude-database interpolation tables.

Counterpart of ``metalens_tpu/characterize.py``.  The characterize data of a
``GratingCollection`` or a ``HexGridSet`` is assembled into dense complex
grids, and :class:`AmpInterpolator` interpolates them multilinearly on the
device that holds them.  torch has complex dtypes on CUDA, so a table is one
complex tensor (complex64 on CUDA, complex128 on the CPU), where the JAX
version keeps a trailing (re, im) channel.  Grid axes and weights are
float64 on either device.

Semantics kept from the JAX package (and the reference):

* key layout ``(wavelength_nm, (ox, oy), 'x'|'y', amp_kind)``;
* a missing grid entry (order not propagating at that direction) is 0;
* collection tables use grating_period as the third axis, edge-padded by
  +-1%; hexgrid tables use the member index and keep all four amplitude
  kinds;
* queries are clamped to the grid, and a length-1 axis is a constant.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import _device
from .solver import cpx


class AmpInterpolator:
    """Multilinear interpolation of a complex grid over an N-d rectilinear
    coordinate system, on ``device`` (CUDA unless ``device="cpu"``) in the
    working complex dtype of that device (complex64 on CUDA, complex128 on
    the CPU).

    ``__call__`` with an (M, ndim) array returns (M,) host numpy complex;
    :meth:`pair` returns the (M,) complex tensor on the table's device.
    Queries are clamped to the grid (callers check ``interpolator_bounds``
    first); length-1 axes behave as constants."""

    def __init__(self, grids, values, *, device="cuda"):
        device = _device(device)
        self.grids = tuple(torch.as_tensor(np.asarray(g, dtype=np.float64),
                                           device=device) for g in grids)
        values = np.asarray(values)
        assert values.ndim == len(self.grids)
        for ax, g in enumerate(self.grids):
            assert values.shape[ax] == g.shape[0]
        self.values = torch.as_tensor(
            values, dtype=cpx.complex_dtype(device), device=device)

    def __call__(self, pts):
        return self.pair(pts).cpu().numpy()

    def pair(self, pts) -> torch.Tensor:
        """The interpolated values at ``pts`` ((M, ndim) or (ndim,)) as an
        (M,) complex tensor on the table's device, for code that stays on
        the device (the JAX version returns its (re, im) pair)."""
        pts = torch.as_tensor(pts, dtype=torch.float64,
                              device=self.values.device)
        if pts.ndim == 1:
            pts = pts[None, :]
        idxs, ws = interp_weights(self.grids, pts)
        return interp_gather(self.values[None], self.grids, idxs, ws)[0]


def interp_weights(grids, pts):
    """Per-axis (cell indices, fractional weights) of multilinear
    interpolation: ``pts`` (M, ndim) -> two length-ndim lists of (M,)
    tensors (int64 and the points' real dtype).  Many value tables can
    share one weight computation.  Degenerate (length-1) axes get index 0
    and weight 0."""
    pts = torch.as_tensor(pts)
    idxs, ws = [], []
    for ax, g in enumerate(grids):
        x = pts[:, ax].contiguous()
        if g.shape[0] == 1:
            idxs.append(torch.zeros(x.shape, dtype=torch.long,
                                    device=x.device))
            ws.append(torch.zeros_like(x))
            continue
        i = torch.clamp(torch.searchsorted(g, x, right=True) - 1,
                        0, g.shape[0] - 2)
        w = (x - g[i]) / (g[i + 1] - g[i])
        ws.append(torch.clamp(w, 0.0, 1.0))
        idxs.append(i)
    return idxs, ws


def interp_gather(values_stack, grids, idxs, ws):
    """Corner-gather half of the multilinear interpolation:
    ``values_stack`` (n_channels, *grid_shape) complex, indices and weights
    from :func:`interp_weights`.  Returns (n_channels, M) complex."""
    ndim = len(grids)
    M = idxs[0].shape[0]
    rdt = cpx.real_dtype(values_stack.dtype)
    out = torch.zeros((values_stack.shape[0], M), dtype=values_stack.dtype,
                      device=values_stack.device)
    for corner in range(2 ** ndim):
        weight = torch.ones(M, dtype=ws[0].dtype, device=ws[0].device)
        coords = []
        for ax in range(ndim):
            hi = (corner >> ax) & 1
            if grids[ax].shape[0] == 1:
                coords.append(idxs[ax])
                if hi:
                    weight = weight * 0.0
                continue
            coords.append(idxs[ax] + hi)
            weight = weight * (ws[ax] if hi else 1.0 - ws[ax])
        vals = values_stack[(slice(None),) + tuple(coords)]     # (C, M)
        out = out + weight.to(rdt)[None, :] * vals
    return out


def interp_multi(values_stack, grids, pts):
    """Multilinear interpolation of n_channels complex tables sharing one
    coordinate system: ``values_stack`` (n_channels, *grid_shape), ``pts``
    (M, ndim).  Returns (n_channels, M); the indices and weights are
    computed once for all channels."""
    idxs, ws = interp_weights(grids, pts)
    return interp_gather(values_stack, grids, idxs, ws)


def _gather_axes(grating_list):
    ux_list = sorted({e["ux"] for g in grating_list for e in g.data})
    uy_list = sorted({e["uy"] for g in grating_list for e in g.data})
    wavelengths = sorted({round(e["wavelength_in_nm"])
                          for g in grating_list for e in g.data})
    orders = sorted({(e["ox"], e["oy"]) for g in grating_list for e in g.data})
    return ux_list, uy_list, wavelengths, orders


def build_collection_interpolators(gc, *, device="cuda"):
    """(ux, uy, grating_period) tables of a GratingCollection's databases:
    forward amplitudes only, the period axis padded by 1% at both ends with
    the edge members' values.  Returns (interpolators, bounds)."""
    glist = gc.grating_list
    ux_list, uy_list, wavelengths, orders = _gather_axes(glist)
    period_list = sorted({g.grating_period for g in glist})
    lookup = {}
    for g in glist:
        for e in g.data:
            key = (round(e["wavelength_in_nm"]), e["ox"], e["oy"],
                   e["x_or_y"], e["ux"], e["uy"], g.grating_period)
            lookup[key] = e

    period_ext = np.hstack((0.99 * min(period_list), period_list,
                            1.01 * max(period_list)))
    interpolators = {}
    for wl in wavelengths:
        for (ox, oy) in orders:
            for x_or_y in ("x", "y"):
                for amp in ("ampfy", "ampfx"):
                    grid = np.zeros((len(ux_list), len(uy_list),
                                     len(period_list)), dtype=complex)
                    for i, ux in enumerate(ux_list):
                        for j, uy in enumerate(uy_list):
                            for k, p in enumerate(period_list):
                                e = lookup.get((wl, ox, oy, x_or_y, ux, uy, p))
                                if e is not None:
                                    grid[i, j, k] = e[amp]
                    ext = np.zeros((len(ux_list), len(uy_list),
                                    len(period_list) + 2), dtype=complex)
                    ext[:, :, 1:-1] = grid
                    ext[:, :, 0] = grid[:, :, 0]
                    ext[:, :, -1] = grid[:, :, -1]
                    interpolators[(wl, (ox, oy), x_or_y, amp)] = \
                        AmpInterpolator((ux_list, uy_list, period_ext), ext,
                                        device=device)
    bounds = (min(ux_list), max(ux_list), min(uy_list), max(uy_list),
              float(period_ext.min()), float(period_ext.max()))
    return interpolators, bounds


def build_hexgrid_interpolators(hgs, *, device="cuda"):
    """(ux, uy, member-index) tables of a HexGridSet's databases, all four
    amplitude kinds.  Returns (interpolators, bounds)."""
    glist = hgs.grating_list
    ux_list, uy_list, wavelengths, orders = _gather_axes(glist)
    index_list = np.arange(len(glist), dtype=float)
    interpolators = {}
    for wl in wavelengths:
        for (ox, oy) in orders:
            for x_or_y in ("x", "y"):
                for amp in ("ampfy", "ampfx", "ampry", "amprx"):
                    grid = np.zeros((len(ux_list), len(uy_list),
                                     len(index_list)), dtype=complex)
                    for k, g in enumerate(glist):
                        for e in g.data:
                            if (round(e["wavelength_in_nm"]) == wl
                                    and (e["ox"], e["oy"]) == (ox, oy)
                                    and e["x_or_y"] == x_or_y):
                                i = ux_list.index(e["ux"])
                                j = uy_list.index(e["uy"])
                                grid[i, j, k] = e[amp]
                    interpolators[(wl, (ox, oy), x_or_y, amp)] = \
                        AmpInterpolator((ux_list, uy_list, index_list), grid,
                                        device=device)
    bounds = (min(ux_list), max(ux_list), min(uy_list), max(uy_list),
              float(index_list.min()), float(index_list.max()))
    return interpolators, bounds
