"""Engine: the figure of merit and the amplitude databases of unit cells on
the port's solver.

Counterpart of the FOM and characterize parts of
``metalens_tpu/engine.py``.  PyTorch runs eagerly, so there are no cached
programs: :func:`_fom_eval` is one batched evaluation of the
multi-wavelength FOM for a batch of cell geometries, sharing the
wavelength-independent structure factor (and NV projector) across the
terms.  Both polarizations come out of one solve per term.
:func:`fom_value_and_grad` differentiates it by autograd, through the
kernels' own backward passes (``InverseFn``, ``TaylorFn``) on the card.

:func:`characterize_grating` fills a cell's amplitude database in one
batched solve over the joint (wavelength x direction) grid.

Every entry point takes ``device=`` (default ``"cuda"``, where the
hand-written kernels run; it raises when torch has no CUDA device, and
``device="cpu"`` asks for the plain PyTorch versions) and ``dtype=`` (the
complex working dtype; default complex128 on the CPU, complex64 on CUDA).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from . import trace
from .materials import resolve_indices
from .solver import basis, cpx, orders as ordmod, rcwa
from .solver.epsilon import (ellipse_structure_toeplitz_traced,
                             toeplitz_from_structure)
from .solver.fff import (normal_projector_toeplitz_traced,
                         nv_blocks_from_structure)
from .solver.fom import DEFAULT_FOM_TERMS, FomTerm, term_score
from .units import nm, pi


def _diff_g_max(g, orders) -> float:
    """Largest |G'| over the difference-order set (the Bessel argument is
    u = |G'| r)."""
    orders = np.asarray(orders)
    gx = orders[:, 0] * (2 * pi / g.grating_period)
    gy = orders[:, 1] * (2 * pi / g.lateral_period)
    return 2.0 * float(np.sqrt(gx ** 2 + gy ** 2).max())


def small_u_ok(g, orders, xyrra=None) -> bool:
    """True when every Bessel argument stays safely below the J1
    rational-fit range (|u| < 8) for this geometry (30% headroom), so the
    asymptotic branch can be skipped."""
    xy = np.asarray(xyrra if xyrra is not None else g.xyrra_list)
    r_max = float(np.abs(xy[..., 2:4]).max())
    return _diff_g_max(g, orders) * 1.3 * r_max < 7.5


def _small_u_now(small_u0: bool, g_max: float, xyrra) -> bool:
    """Re-check the small-argument decision on the concrete candidate radii
    (a batch may grow a radius past the headroom)."""
    if not small_u0:
        return False
    r_max = float(torch.as_tensor(xyrra)[..., 2:4].abs().max())
    return g_max * r_max < 7.5


def static_solve_config(g, wavelengths, numG, dtype: torch.dtype):
    """The truncated order set, the slab schedule for the working ``dtype``
    (its per-slab cap, :func:`rcwa.slab_cap`), and whether the pillar
    material is lossless (Hermitian Toeplitz -> the unpivoted inverse)."""
    orders = ordmod.select_orders(g.grating_period, g.lateral_period, numG)
    lam_min = min(wavelengths)
    eps_max = 0.0
    hermitian = True
    for lam in wavelengths:
        ng, nt = resolve_indices(g.n_glass, g.n_tio2, lam)
        eps_max = max(eps_max, abs(nt) ** 2, abs(ng) ** 2)
        if abs(complex(nt).imag) > 0:
            hermitian = False
    k0h = 2 * pi * g.cyl_height / lam_min
    n_slabs, taylor = rcwa.slab_schedule(k0h, orders, g.grating_period,
                                         g.lateral_period, lam_min, eps_max,
                                         dtype=dtype)
    return orders, n_slabs, taylor, hermitian


def static_envelope(g, period_pairs, wavelengths, numG, *, dtype):
    """Elementwise-max ``(Dx, Dy, n_slabs, taylor_terms)`` over explicit
    ``(grating_period, lateral_period)`` pairs of ``g``'s material and
    height: the static solve config that covers every listed cell, for
    ``static_override``.  Oversizing each component is accuracy-safe (a
    superset difference grid; more slabs lower the per-slab t*q; the max'd
    series covers every member's per-slab norm).  The slab cap follows the
    working ``dtype``, which is given explicitly (the JAX version reads it
    from ``jax.config``)."""
    Dx = Dy = ns = tt = 0
    for gp, lp in period_pairs:
        cell = g.copy()
        cell.grating_period, cell.lateral_period = gp, lp
        orders, n_slabs, taylor, _ = static_solve_config(cell, wavelengths,
                                                         numG, dtype)
        dx, dy = _order_bounds(orders)
        Dx, Dy = max(Dx, dx), max(Dy, dy)
        ns, tt = max(ns, n_slabs), max(tt, taylor)
    return Dx, Dy, ns, tt


def _order_bounds(orders):
    """Quantized bounds (Dx, Dy) on the order-difference ranges (rounded up
    as in the JAX engine, so both evaluate the same dense grid)."""
    o = np.asarray(orders)
    dx = int(o[:, 0].max() - o[:, 0].min())
    dy = int(o[:, 1].max() - o[:, 1].min())
    Dx = int(math.ceil((dx + 1) / 16.0) * 16)
    Dy = int(math.ceil((dy + 1) / 4.0) * 4)
    return Dx, Dy


def apply_static_override(static_override, Dx, Dy, n_slabs, taylor):
    """Validate and apply a ``(Dx, Dy, n_slabs, taylor_terms)`` envelope:
    every component must cover the member's own requirement."""
    if static_override is None:
        return Dx, Dy, n_slabs, taylor
    eDx, eDy, ens, ett = static_override
    if not (eDx >= Dx and eDy >= Dy and ens >= n_slabs and ett >= taylor):
        raise ValueError(
            f"static_override {static_override} does not cover this "
            f"member's config (Dx={Dx}, Dy={Dy}, n_slabs={n_slabs}, "
            f"taylor_terms={taylor})")
    return int(eDx), int(eDy), int(ens), int(ett)


def _fom_inputs(g, target_wavelength, numG, terms, dtype):
    """Static configuration and per-term values (python numbers) of a FOM:
    (orders, n_slabs, taylor, hermitian, target indices, inphase flags,
    (eps_p, eps_g, lam, ux, n_glass, cos_theta, weights))."""
    terms = tuple(terms) if terms is not None else DEFAULT_FOM_TERMS
    orders, n_slabs, taylor, hermitian = static_solve_config(
        g, [t.wavelength for t in terms], numG, dtype)
    angle_in_air = (g.get_angle_in_air(target_wavelength)
                    if target_wavelength is not None else None)
    tgt_idx, inph, eps_p, eps_g, lam, ux, ngs, cth, w = ([] for _ in range(9))
    for t in terms:
        ng, nt = resolve_indices(g.n_glass, g.n_tio2, t.wavelength)
        if t.target_order != 0:
            if angle_in_air is None:
                raise ValueError(
                    "target_wavelength required for deflection FOM terms")
            theta = angle_in_air
        else:
            theta = 0.0
        try:
            tgt_idx.append(ordmod.order_index(orders, t.target_order, 0))
        except ValueError:
            raise ValueError(
                f"target order ({t.target_order},0) outside the numG={numG} "
                f"truncation; increase numG") from None
        inph.append(bool(t.inphase))
        eps_p.append(complex(nt) ** 2)
        eps_g.append(complex(ng) ** 2)
        lam.append(t.wavelength)
        ux.append(math.sin(theta))
        ngs.append(float(np.real(ng)))
        cth.append(math.cos(theta))
        w.append(t.weight)
    return (orders, n_slabs, taylor, hermitian, tuple(tgt_idx), tuple(inph),
            (eps_p, eps_g, lam, ux, ngs, cth, w))


@trace.traced("engine.fom_eval")
def _fom_eval(xyrra, mx, my, i0, tgt, Lx, Ly, h, eps_p, eps_g, lam, ux,
              ng_now, cos_theta, weights, *, N, Dx, Dy, n_slabs,
              taylor_terms, inphase, small_u, fff, hermitian_eps):
    """The FOM of a batch of cell geometries ``xyrra`` (B, nE, 5) -> (B,).
    The order set comes as integer tensors (mx, my) with the dense
    difference-grid bounds (Dx, Dy); per-term values are sequences of
    python numbers."""
    rdt, dev = xyrra.dtype, xyrra.device
    cdt = cpx.to_complex(rdt)
    orders_t = torch.stack([mx, my], dim=1)
    S_struct, at_zero = ellipse_structure_toeplitz_traced(
        mx, my, Dx, Dy, Lx, Ly, xyrra, small_arg_only=small_u)
    if fff:
        P_blocks = normal_projector_toeplitz_traced(mx, my, Dx, Dy, Lx, Ly,
                                                    xyrra)
    total = 0.0
    wsum = 0.0
    zero = torch.zeros((), dtype=rdt, device=dev)
    for t in range(len(inphase)):
        E = toeplitz_from_structure(S_struct, at_zero, eps_p[t])
        M_blocks = None
        if fff:
            # shared recipe incl. the HPD-vs-pivoted solve routing
            _, M_blocks = nv_blocks_from_structure(
                S_struct, at_zero, eps_p[t], P_blocks,
                hermitian=hermitian_eps, E=E)
        ux_t = torch.full((), ux[t], dtype=rdt, device=dev)
        cy_s, cx_s = basis.incident_sp_amplitudes(ux_t, zero, "s")
        cy_p, cx_p = basis.incident_sp_amplitudes(ux_t, zero, "p")
        c = torch.zeros((2 * N, 2), dtype=cdt, device=dev)
        c[i0, 0], c[i0 + N, 0] = cy_s, cx_s
        c[i0, 1], c[i0 + N, 1] = cy_p, cx_p
        # the FOM reads transmission only: the outer conversion star is
        # applied straight to the 2-column incidence
        ampf, _, _, _ = rcwa.cell_amplitudes_with_eps(
            orders_t, E, Lx, Ly, h, eps_g[t], lam[t], ux[t], 0.0, c,
            n_slabs=n_slabs, taylor_terms=taylor_terms, M_blocks=M_blocks,
            hermitian_eps=hermitian_eps, want_reflection=False)
        idx = tgt[t]
        score = term_score(ampf[:, idx, 0], ampf[:, idx + N, 1], ng_now[t],
                           cos_theta[t], inphase[t])
        total = total + weights[t] * score
        wsum = wsum + weights[t]
    return total / wsum


_device = cpx.resolve_device


def _order_tensors(orders, device):
    o = np.asarray(orders)
    return (torch.as_tensor(o[:, 0], dtype=torch.long, device=device),
            torch.as_tensor(o[:, 1], dtype=torch.long, device=device),
            ordmod.order_index(o, 0, 0))


def fom_of_grating(g, target_wavelength=None, numG: int = 50,
                   terms: Sequence[FomTerm] | None = None,
                   taylor_terms: int | None = None, xyrra=None,
                   fff: bool = True, *, device="cuda", dtype=None) -> float:
    """Figure of merit of one Grating (the reference's ``run_lua``), with
    the normal-vector factorization on by default (S4's accuracy class);
    ``xyrra`` overrides the grating's own geometry."""
    device = _device(device)
    cdt = cpx.complex_dtype(device, dtype)
    rdt = cpx.real_dtype(cdt)
    orders, n_slabs, taylor, hermitian, tgt, inph, per_term = _fom_inputs(
        g, target_wavelength, numG, terms, cdt)
    Dx, Dy = _order_bounds(orders)
    xy = np.asarray(xyrra if xyrra is not None else g.xyrra_list)
    xy_t = torch.as_tensor(xy, dtype=rdt, device=device)[None]
    mx, my, i0 = _order_tensors(orders, device)
    val = _fom_eval(xy_t, mx, my, i0, tgt, g.grating_period,
                    g.lateral_period, g.cyl_height, *per_term,
                    N=len(orders), Dx=Dx, Dy=Dy, n_slabs=n_slabs,
                    taylor_terms=taylor_terms or taylor, inphase=inph,
                    small_u=small_u_ok(g, orders, xyrra=xyrra), fff=fff,
                    hermitian_eps=hermitian)
    return float(val[0])


def fom_value_and_grad(g, target_wavelength=None, numG: int = 50,
                       terms=None, taylor_terms: int | None = None,
                       fff: bool = True, *, device="cuda", dtype=None):
    """Return a function ``xyrra (nE, 5) -> (fom, d fom / d xyrra)``: a 0-d
    and an (nE, 5) real tensor on ``device``.  Exact shape derivatives by
    autograd through the whole solve, NV correction included; on CUDA the
    kernels run the forward and their backward passes carry the
    gradient."""
    device = _device(device)
    cdt = cpx.complex_dtype(device, dtype)
    rdt = cpx.real_dtype(cdt)
    orders, n_slabs, taylor, hermitian, tgt, inph, per_term = _fom_inputs(
        g, target_wavelength, numG, terms, cdt)
    Dx, Dy = _order_bounds(orders)
    small_u0 = small_u_ok(g, orders)
    g_max = _diff_g_max(g, orders)
    mx, my, i0 = _order_tensors(orders, device)

    def vg(xyrra):
        x = torch.as_tensor(xyrra, dtype=rdt).to(device).detach().clone()
        x.requires_grad_(True)
        fom = _fom_eval(x[None], mx, my, i0, tgt, g.grating_period,
                        g.lateral_period, g.cyl_height, *per_term,
                        N=len(orders), Dx=Dx, Dy=Dy, n_slabs=n_slabs,
                        taylor_terms=taylor_terms or taylor, inphase=inph,
                        small_u=_small_u_now(small_u0, g_max, x.detach()),
                        fff=fff, hermitian_eps=hermitian)[0]
        grad, = torch.autograd.grad(fom, x)
        return fom.detach(), grad
    return vg


def fom_batch_fn(g, target_wavelength=None, numG: int = 50, terms=None,
                 taylor_terms: int | None = None, fff: bool = True,
                 static_override=None, *, device="cuda", dtype=None):
    """Return a function ``xyrra_batch (B, nE, 5) -> FOM values (B,)``
    (a real tensor on ``device``): the FOM of B candidate geometries of the
    same cell in one batched solve -- what the derivative-free optimizers
    dispatch their probes through.  ``static_override``: optional
    ``(Dx, Dy, n_slabs, taylor_terms)`` envelope covering this cell."""
    device = _device(device)
    cdt = cpx.complex_dtype(device, dtype)
    rdt = cpx.real_dtype(cdt)
    orders, n_slabs, taylor, hermitian, tgt, inph, per_term = _fom_inputs(
        g, target_wavelength, numG, terms, cdt)
    Dx, Dy = _order_bounds(orders)
    Dx, Dy, n_slabs, taylor = apply_static_override(
        static_override, Dx, Dy, n_slabs, taylor)
    small_u0 = small_u_ok(g, orders)
    g_max = _diff_g_max(g, orders)
    mx, my, i0 = _order_tensors(orders, device)

    def run(xyrra_batch):
        xy = torch.as_tensor(xyrra_batch, dtype=rdt).to(device)
        return _fom_eval(xy, mx, my, i0, tgt, g.grating_period,
                         g.lateral_period, g.cyl_height, *per_term,
                         N=len(orders), Dx=Dx, Dy=Dy, n_slabs=n_slabs,
                         taylor_terms=taylor_terms or taylor, inphase=inph,
                         small_u=_small_u_now(small_u0, g_max, xy), fff=fff,
                         hermitian_eps=hermitian)
    return run


def fom_of_gratings(gratings, target_wavelength=None, numG: int = 100,
                    terms=None, *, device="cuda", dtype=None) -> list:
    """FOM of a list of Gratings (members may differ in period)."""
    return [fom_of_grating(g, target_wavelength=target_wavelength, numG=numG,
                           terms=terms, device=device, dtype=dtype)
            for g in gratings]


# --------------------------------------------------------------------------
# characterize
# --------------------------------------------------------------------------

def _direction_grid(ux_min, ux_max, uy_min, uy_max, u_steps):
    """The (ux, uy) directions of a sweep, in float64 on the host: the
    u_steps x u_steps grid (its centre when u_steps == 1), ux-major, inside
    the unit circle."""
    if u_steps == 1:
        ux_list = np.array([(ux_min + ux_max) / 2.0])
        uy_list = np.array([(uy_min + uy_max) / 2.0])
    else:
        ux_list = np.linspace(ux_min, ux_max, u_steps)
        uy_list = np.linspace(uy_min, uy_max, u_steps)
    UX, UY = np.meshgrid(ux_list, uy_list, indexing="ij")
    ux_grid, uy_grid = UX.ravel(), UY.ravel()
    inside = ux_grid ** 2 + uy_grid ** 2 < 1.0
    return ux_grid[inside], uy_grid[inside]


@trace.traced("characterize.sweep")
def characterize_grating(g, ux_min, ux_max, uy_min, uy_max, u_steps: int,
                         wavelength, numG: int, just_normal: bool = False,
                         convert_to_xy: bool = True,
                         include_tir: bool = False,
                         taylor_terms: int | None = None,
                         max_scan_order: int = 5, fff: bool = True, *,
                         device="cuda", dtype=None) -> list:
    """Amplitude database of one grating: the list-of-dicts schema of the
    JAX package (and the reference), one entry per (wavelength, direction,
    kept order, incident polarization), computed as one batched solve over
    the joint (wavelength x direction) grid, wavelength-major.  Both
    incident polarizations ('x' and 'y', unit amplitude in the S4 x/y
    basis) come out of one solve per cell.

    The eps blocks and E's inverse depend on the geometry and the
    wavelength, not on the direction: they are built once per wavelength
    and repeated across the directions.  Orders kept: |k_in + G| below
    k_vac (n_glass k_vac with ``include_tir``), with |ox|, |oy| <=
    ``max_scan_order``.  ``wavelength`` is a number or a list; the slab
    schedule is sized at the shortest."""
    assert convert_to_xy, "raw s/p output retired; x/y is the native basis"
    device = _device(device)
    cdt = cpx.complex_dtype(device, dtype)
    rdt = cpx.real_dtype(cdt)
    wavelengths = ([float(wavelength)] if np.ndim(wavelength) == 0
                   else list(wavelength))
    orders, n_slabs, taylor, hermitian = static_solve_config(
        g, wavelengths, numG, cdt)
    N = orders.shape[0]
    ux_grid, uy_grid = _direction_grid(ux_min, ux_max, uy_min, uy_max,
                                       u_steps)
    n_dir = len(ux_grid)

    # the joint batch, wavelength-major, on the host in float64
    eps_p_u, eps_g_u, ng_u = [], [], []
    for lam in wavelengths:
        ng, nt = resolve_indices(g.n_glass, g.n_tio2, lam)
        eps_p_u.append(complex(nt) ** 2)
        eps_g_u.append(complex(ng) ** 2)
        ng_u.append(float(np.real(ng)))
    lam_flat = np.repeat(np.asarray(wavelengths, dtype=np.float64), n_dir)
    ux_flat = np.tile(ux_grid, len(wavelengths))
    uy_flat = np.tile(uy_grid, len(wavelengths))
    ng_flat = np.repeat(ng_u, n_dir)

    xy = torch.as_tensor(np.asarray(g.xyrra_list), dtype=rdt,
                         device=device)[None]
    small_u = small_u_ok(g, orders)
    per_lam = [rcwa.build_layer_eps(orders, g.grating_period,
                                    g.lateral_period, xy, eps_p,
                                    eps_small_u=small_u, fff=fff,
                                    hermitian_eps=hermitian)
               for eps_p in eps_p_u]
    E_u = torch.cat([E for E, _ in per_lam])

    def per_cell(blocks):
        return blocks.repeat_interleave(n_dir, dim=0)

    E = per_cell(E_u)
    Einv = per_cell(rcwa.invert_eps(E_u, hermitian))
    M_blocks = (tuple(per_cell(torch.cat(m))
                      for m in zip(*(M for _, M in per_lam)))
                if fff else None)
    i0 = ordmod.order_index(orders, 0, 0)
    c = torch.zeros((2 * N, 2), dtype=cdt, device=device)
    c[i0, 0] = c[i0 + N, 1] = 1.0

    def col(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    ampf, ampr, _, _ = rcwa.cell_amplitudes_with_eps(
        orders, E, g.grating_period, g.lateral_period, g.cyl_height,
        col(np.repeat(eps_g_u, n_dir), cdt), col(lam_flat, rdt),
        col(ux_flat, rdt), col(uy_flat, rdt), c, n_slabs=n_slabs,
        taylor_terms=taylor_terms or taylor, M_blocks=M_blocks,
        hermitian_eps=hermitian, Einv=Einv)
    # (B, 2N, 2 pol) -> host complex (B, pol, 2N); pol 0 = 'y', 1 = 'x'
    ampf = ampf.transpose(1, 2).cpu().numpy()
    ampr = ampr.transpose(1, 2).cpu().numpy()

    mx = orders[:, 0].astype(float)
    my = orders[:, 1].astype(float)
    scan_ok = ((np.abs(orders[:, 0]) <= max_scan_order)
               & (np.abs(orders[:, 1]) <= max_scan_order))
    data = []
    for b in range(len(ux_flat)):
        lam = lam_flat[b]
        wavelength_in_nm = round(lam / nm)
        cutoff2 = (ng_flat[b] ** 2) if include_tir else 1.0
        Kx = ux_flat[b] + mx * lam / g.grating_period
        Ky = uy_flat[b] + my * lam / g.lateral_period
        prop = (Kx ** 2 + Ky ** 2) < cutoff2
        for i in np.nonzero(prop & scan_ok)[0]:
            for p, pol_name in enumerate(("y", "x")):
                data.append({
                    "wavelength_in_nm": float(wavelength_in_nm),
                    "x_or_y": pol_name,
                    "ux": float(ux_flat[b]), "uy": float(uy_flat[b]),
                    "ox": int(orders[i, 0]), "oy": int(orders[i, 1]),
                    "ampfy": complex(ampf[b, p, i]),
                    "ampfx": complex(ampf[b, p, i + N]),
                    "ampry": complex(ampr[b, p, i]),
                    "amprx": complex(ampr[b, p, i + N]),
                })
    if just_normal:
        # mirror the (0.001, 0.001) sample into the other three quadrants
        assert all(e["ux"] == 0.001 for e in data)
        assert all(e["uy"] == 0.001 for e in data)
        for entry in list(data):
            for ux_sign, uy_sign in [(-1, 1), (-1, -1), (1, -1)]:
                e2 = dict(entry)
                e2["ux"] *= ux_sign
                e2["uy"] *= uy_sign
                data.append(e2)
    return data
