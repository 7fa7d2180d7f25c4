"""Full-lens near-field assembly (the stitcher).

Counterpart of ``metalens_tpu/nearfield.py`` (reference
``nearfield.py:66-516``).  Reconstructs the complex E/H field just behind
the whole lens aperture from the per-unit-cell amplitude databases: every
aperture point is classified to its lens element (periphery ring and
azimuthal copy, or centre hex cell), the local incidence direction from the
source is computed, the cell's complex transmission amplitudes are
interpolated, and the transverse fields are rebuilt in the S4 x/y output
basis with the off-centre and air-propagation phases applied.

Each jitted program of the JAX package is a torch function here, run on
the device that holds the aperture and the amplitude tables (CUDA unless
``device="cpu"``):

* the point classification and the source planes stay float64 on either
  device.  In float32 the ring search, the lattice rounding and the
  air-path phase (about 3,000 rad across a 0.5 mm lens) would move points
  to other rings and lose 2e-4 rad;
* the amplitude tables, the accumulated fields and their products are in
  the working complex dtype (complex64 on CUDA, complex128 on the CPU);
* the per-order accumulation is a loop over the orders that shares one
  interpolation-weight computation and masks by multiplication, as the JAX
  version's scan does; the host reads the device only for the region
  statistics, the lookup misses and the final power.

The centre-cell lookup is the JAX package's analytic hexagonal-lattice
rounding over a dense (n1, n2) -> site table, with the reference's
nearest-site (cKDTree) semantics restored on the host for the few points
whose 4 x 4 window holds no site.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import trace, units as nu
from .characterize import interp_weights, interp_gather
from .engine import _device
from .geometry import good_fft_number
from .materials import n_glass as n_glass_table
from .solver import cpx
from .units import nm, pi, inf

# the dtype of the aperture grid, the point classification and the source
# planes, on every device
GEOMETRY_DTYPE = torch.float64


def _region_stats(mask, a0, a1, a2):
    """Masked point count and per-array min/max in one (7,) host fetch
    (the JAX version fuses them into one program for the same reason: one
    device sync per region, not seven)."""
    stack = torch.stack([a0, a1, a2])
    m = mask[None]
    mn = torch.where(m, stack, inf).amin(dim=(1, 2))
    mx = torch.where(m, stack, -inf).amax(dim=(1, 2))
    cnt = mask.sum().to(mn.dtype)
    trace.count("nearfield.host_reads")
    return torch.cat([cnt[None], mn, mx]).cpu().numpy()


def _check_bounds(stats, named_bounds):
    """The reference's explicit raises (nearfield.py:294-305): the points of
    a region must lie inside its database's interpolation bounds."""
    for i, (name, lo, hi) in enumerate(named_bounds):
        if stats[1 + i] < lo:
            raise ValueError(f"need to calculate at smaller {name}!",
                             float(stats[1 + i]), lo)
        if stats[4 + i] > hi:
            raise ValueError(f"need to calculate at bigger {name}!",
                             float(stats[4 + i]), hi)


def _accumulate_orders(values_all, all_orders, grids, pts, region_mask,
                       u1, u2, invp1, invp2, xrel, yrel, kvac, kg, ng,
                       Hxw, Hyw, acc):
    """Add every diffraction order of one region to the accumulators
    ``acc`` = (Ex, Ey, Hx, Hy), in place.

    The multilinear interpolation weights depend only on the query points,
    so they are computed once and shared by every (order, polarization,
    channel) table; then, per order: gather the four amplitude channels
    [(x,fy),(x,fx),(y,fy),(y,fx)], build the propagating-order mask and
    phase, and add the E/H contributions (reference field formulas,
    nearfield.py:313-327).  Returns the per-order counts of points where
    the order applies, as a device tensor (no host sync here)."""
    idxs, ws = interp_weights(grids, pts)
    shape = u1.shape
    cdt = values_all.dtype
    rdt = cpx.real_dtype(cdt)
    Exp, Eyp, Hxp, Hyp = acc
    weights = [(Hw, (Hw * nu.Z0)) for Hw in (Hxw, Hyw)]
    counts = []
    for (ox, oy), values4 in zip(all_orders, values_all):
        kx = kvac * u1 + ox * invp1
        ky = kvac * u2 + oy * invp2
        mask = (kx ** 2 + ky ** 2 <= kvac ** 2) & region_mask
        kz = torch.sqrt(torch.clamp(kg ** 2 - kx ** 2 - ky ** 2,
                                    min=1e-12 * kvac ** 2))
        phase = torch.polar(mask.to(kx.dtype), kx * xrel + ky * yrel).to(cdt)
        amps = interp_gather(values4, grids, idxs, ws).reshape(4, *shape)
        inv = 1.0 / (kg * kz * ng)
        c_fy_x = kx * ky * inv
        c_fy_y = -(kx * kx + kz * kz) * inv
        c_fx_x = (ky * ky + kz * kz) * inv
        c_fx_y = -(kx * ky) * inv
        for (a_fy, a_fx), (Hw, Ew) in zip((amps[0:2], amps[2:4]), weights):
            pf_fy = a_fy * phase
            pf_fx = a_fx * phase
            Exp += pf_fy * (Ew * c_fy_x).to(rdt)
            Exp += pf_fx * (Ew * c_fx_x).to(rdt)
            Eyp += pf_fy * (Ew * c_fy_y).to(rdt)
            Eyp += pf_fx * (Ew * c_fx_y).to(rdt)
            Hxp += pf_fy * Hw.to(rdt)
            Hyp += pf_fx * Hw.to(rdt)
        counts.append(mask.sum())
    return torch.stack(counts)


def _stack_order_tables(interpolators, wavelength_in_nm, all_orders, kinds):
    """(n_orders, 4, *grid) stacked complex value tables and the shared
    grids."""
    values_all = torch.stack([
        torch.stack([interpolators[(wavelength_in_nm, (ox, oy), p, a)].values
                     for p in ("x", "y") for a in kinds])
        for (ox, oy) in all_orders])
    g = interpolators[(wavelength_in_nm, all_orders[0], "x", kinds[0])].grids
    return values_all, g


def _tables_on(obj, device):
    """``obj``'s amplitude tables, which must live on ``device``."""
    tables = obj.interpolators
    on = next(iter(tables.values())).values.device
    if on.type != device.type:
        raise ValueError(f"the amplitude tables are on {on}, the stitch runs "
                         f"on {device}: build them with "
                         f"build_interpolators(device={device.type!r})")
    return tables


def _hex_site_table(lens_center_summary, pitch, device):
    """The dense (n1, n2) -> row-index table (``torch.long``, -1 where no
    site) of the hex lattice x = pitch*n2*sqrt(3)/2, y = pitch*(n1 + n2/2)
    (the lattice of :func:`metalens_tpu_torch.assembly.hexagonal_grid`)."""
    xy = np.asarray(lens_center_summary)[:, 0:2]
    n2 = np.round(2 * xy[:, 0] / (pitch * math.sqrt(3))).astype(int)
    n1 = np.round(xy[:, 1] / pitch - n2 / 2.0).astype(int)
    # verify the inversion is exact (sites really are on the lattice)
    x_back = pitch * n2 * math.sqrt(3) / 2
    y_back = pitch * (n1 + n2 / 2.0)
    assert np.abs(x_back - xy[:, 0]).max() < 1e-6 * pitch
    assert np.abs(y_back - xy[:, 1]).max() < 1e-6 * pitch
    n1_min, n2_min = int(n1.min()) - 2, int(n2.min()) - 2
    table = -np.ones((n1.max() - n1_min + 5, n2.max() - n2_min + 5),
                     dtype=np.int64)
    table[n1 - n1_min, n2 - n2_min] = np.arange(len(xy))
    return torch.as_tensor(table, device=device), n1_min, n2_min


def _nearest_center_site(x, y, table, n1_min, n2_min, pitch, site_xy):
    """Index of the nearest stored hex site for each (x, y), by analytic
    lattice rounding with a 4x4 candidate neighbourhood (in place of
    cKDTree).  Returns (index, found): ``found`` is False where NO stored
    site lies in the candidate window (the index there is a placeholder 0,
    not the global nearest); callers repair or mask those points."""
    n2f = 2 * x / (pitch * math.sqrt(3))
    n1f = y / pitch - n2f / 2.0
    n1r = torch.floor(n1f).long()
    n2r = torch.floor(n2f).long()
    best_d2 = torch.full_like(x, inf)
    best_idx = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    for di in (0, 1, -1, 2):
        for dj in (0, 1, -1, 2):
            n1c = n1r + di
            n2c = n2r + dj
            i1 = torch.clamp(n1c - n1_min, 0, table.shape[0] - 1)
            i2 = torch.clamp(n2c - n2_min, 0, table.shape[1] - 1)
            row = table[i1, i2]
            valid = (row >= 0) & (n1c - n1_min == i1) & (n2c - n2_min == i2)
            safe_row = torch.clamp(row, min=0)
            sx = site_xy[safe_row, 0]
            sy = site_xy[safe_row, 1]
            d2 = torch.where(valid, (x - sx) ** 2 + (y - sy) ** 2, inf)
            take = d2 < best_d2
            best_d2 = torch.where(take, d2, best_d2)
            best_idx = torch.where(take, safe_row, best_idx)
    return best_idx, torch.isfinite(best_d2)


def _nearest_site_brute(xm, ym, site_xy, chunk=256):
    """The true nearest site of each host point (the reference's global
    cKDTree lookup, nearfield.py:363-367), by brute force in chunks of
    ``chunk`` points."""
    out = np.empty(len(xm), dtype=np.int64)
    for s in range(0, len(xm), chunk):
        d2 = ((xm[s:s + chunk, None] - site_xy[None, :, 0]) ** 2
              + (ym[s:s + chunk, None] - site_xy[None, :, 1]) ** 2)
        out[s:s + chunk] = np.argmin(d2, axis=1)
    return out


def _tab(a, device, dtype=GEOMETRY_DTYPE):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _ring_tables(lens_periphery_summary, device):
    """The ring boundaries and the per-ring collection index, period,
    copies around the circle and centre radius, as tensors on ``device``
    (all None for a centre-only lens)."""
    if lens_periphery_summary is None:
        return None, None, None, None, None
    lps = lens_periphery_summary
    return (_tab(np.hstack((lps["r_min_list"], lps["r_max_list"][-1])),
                 device),
            _tab(lps["gratingcollection_index_here_list"], device,
                 torch.long),
            _tab(lps["grating_period_list"], device),
            _tab(lps["num_around_circle_list"], device),
            _tab(lps["r_center_list"], device))


def _geometry_planes(X, Y, ring_boundaries, gc_index_tab, period_tab,
                     napc_tab, rcen_tab, lens_max_r,
                     source_x, source_y, source_z, kvac,
                     pol_vector, H_coef, dipole_moment,
                     have_periphery, plane_wave, cdt):
    """Every point-classification and source-field plane of the stitch, in
    ``X``'s dtype (float64); the tables are tensors on ``X``'s device.

    Returns (which_gc, in_center, uxp, uyp, xp, yp, grating_period,
    lateral_period, cosr, sinr, ux, uy, eikr_periph, H_xp_weight,
    H_yp_weight, dipole_field_Hx, dipole_field_Hy, local_power_z).
    ``eikr_periph`` is the periphery air-propagation phase in ``cdt``, or
    None where it does not apply.  ``H_*p_weight`` are the periphery-frame
    simulation weights; the centre block's lab-frame weights are
    ``dipole_field_Hy`` / ``dipole_field_Hx`` (reference
    nearfield.py:237-247)."""
    lens_r = torch.sqrt(X ** 2 + Y ** 2)
    lens_phi = torch.atan2(Y, X)

    if have_periphery:
        # ring classification (reference nearfield.py:125-128)
        n_rings = period_tab.shape[0]
        which_ring = torch.searchsorted(ring_boundaries, lens_r) - 1
        in_center = which_ring == -1
        which_ring = torch.where(which_ring == n_rings, -1, which_ring)
        safe_ring = torch.clamp(which_ring, min=0)
        which_gc = torch.where(which_ring == -1, -1, gc_index_tab[safe_ring])
        grating_period = period_tab[safe_ring]
        angle_per_grating = 2 * pi / napc_tab[safe_ring]
        r_center = rcen_tab[safe_ring]
        lateral_period = r_center * angle_per_grating
        grating_rotation = (torch.round(lens_phi / angle_per_grating)
                            * angle_per_grating)
    else:
        in_center = lens_r < lens_max_r
        which_gc = torch.full(lens_r.shape, -1, dtype=torch.long,
                              device=X.device)
        grating_period = torch.ones_like(lens_r)
        lateral_period = torch.ones_like(lens_r)
        r_center = torch.zeros_like(lens_r)
        grating_rotation = torch.zeros_like(lens_r)

    if plane_wave:
        ux = torch.zeros_like(X)
        uy = torch.zeros_like(X)
        uz = torch.ones_like(X)
    else:
        dx = X - source_x
        dy = Y - source_y
        dz = 0.0 - source_z
        distance = torch.sqrt(dx ** 2 + dy ** 2 + dz ** 2)
        ux = dx / distance
        uy = dy / distance
        uz = dz / distance

    cosr, sinr = torch.cos(grating_rotation), torch.sin(grating_rotation)
    uxp = ux * cosr + uy * sinr
    uyp = -ux * sinr + uy * cosr
    xp = X * cosr + Y * sinr - r_center
    yp = -X * sinr + Y * cosr

    # source fields at the aperture (everything except the e^{ikr} phase,
    # reference nearfield.py:207-228); Lambertian uz^0.5 scaling
    if not plane_wave:
        s = H_coef * uz ** 0.5 / distance
        dipole_field_Hx = (uy * pol_vector[2] - uz * pol_vector[1]) * s
        dipole_field_Hy = (uz * pol_vector[0] - ux * pol_vector[2]) * s
        dipole_field_Hz = (ux * pol_vector[1] - uy * pol_vector[0]) * s
        dipole_field_Ex = (dipole_field_Hy * uz - dipole_field_Hz * uy) * nu.Z0
        dipole_field_Ey = (dipole_field_Hz * ux - dipole_field_Hx * uz) * nu.Z0
    else:
        one = torch.ones_like(X)
        dipole_field_Ex = pol_vector[0] * dipole_moment * one
        dipole_field_Ey = pol_vector[1] * dipole_moment * one
        dipole_field_Hx = -pol_vector[1] * dipole_moment / nu.Z0 * one
        dipole_field_Hy = pol_vector[0] * dipole_moment / nu.Z0 * one

    dipole_field_Hxp = dipole_field_Hx * cosr + dipole_field_Hy * sinr
    dipole_field_Hyp = -dipole_field_Hx * sinr + dipole_field_Hy * cosr
    # weights of the unit-amplitude 'x'/'y' simulations reproducing the
    # incident H (reference nearfield.py:237-247)
    H_xp_weight = dipole_field_Hyp
    H_yp_weight = dipole_field_Hxp

    # air propagation phase to the grating centre (reference
    # nearfield.py:333-347)
    eikr_periph = None
    if not plane_wave and have_periphery:
        air_dist = torch.sqrt((r_center * cosr - source_x) ** 2
                              + (r_center * sinr - source_y) ** 2
                              + source_z ** 2)
        eikr_periph = torch.polar(torch.ones_like(air_dist),
                                  kvac * air_dist).to(cdt)

    local_power_z = (dipole_field_Ex * dipole_field_Hy
                     - dipole_field_Ey * dipole_field_Hx)

    return (which_gc, in_center, uxp, uyp, xp, yp, grating_period,
            lateral_period, cosr, sinr, ux, uy, eikr_periph,
            H_xp_weight, H_yp_weight, dipole_field_Hx, dipole_field_Hy,
            local_power_z)


def _rotate_to_lab(Exp, Eyp, Hxp, Hyp, eikr, cosr, sinr):
    """Apply the periphery air phase and rotate the accumulated
    periphery-frame fields back to the lab frame."""
    if eikr is not None:
        Exp, Eyp, Hxp, Hyp = Exp * eikr, Eyp * eikr, Hxp * eikr, Hyp * eikr
    rdt = cpx.real_dtype(Exp.dtype)
    c, s = cosr.to(rdt), sinr.to(rdt)
    return (Exp * c - Eyp * s, Exp * s + Eyp * c,
            Hxp * c - Hyp * s, Hxp * s + Hyp * c)


def _lens_max_radius(lens_periphery_summary, lens_center_summary, hexgridset):
    """Aperture half-width of a design: outer ring edge, or the centre hex
    extent + one cell margin for a centre-only lens."""
    if lens_periphery_summary is not None:
        return lens_periphery_summary["r_max_list"][-1]
    return (np.hypot(lens_center_summary[:, 0],
                     lens_center_summary[:, 1]).max() + hexgridset.sep)


def _default_aperture_pts(wavelength, lens_max_r):
    """Default uniform aperture grid: spacing < lambda/2 (Nyquist for the
    propagating spectrum) with an FFT-friendly point count."""
    num = good_fft_number(2 * lens_max_r / (wavelength / 2.2))
    return np.linspace(-lens_max_r, lens_max_r, num=num)


@trace.traced("nearfield.build")
def build_nearfield(source_x, source_y, source_z, source_pol, wavelength,
                    lens_periphery_summary, lens_center_summary, hexgridset,
                    x_pts=None, y_pts=None,
                    dipole_moment=1e-30 * nu.C * nu.m, progress=False, *,
                    device="cuda"):
    """Near field of the whole lens on the aperture grid, on ``device``
    (CUDA unless ``device="cpu"``), where the collections' and the
    hexgrid set's amplitude tables must be.

    Source: point dipole at (source_x, source_y, source_z<0) polarized along
    ``source_pol`` in ('x','y','z'), Lambertian-weighted (uz^0.5 field
    scaling); or a normally-incident plane wave if ``source_z == -inf`` with
    ``dipole_moment`` as the E-field magnitude (reference
    ``nearfield.py:66-83``).

    Returns (Ex, Ey, Hx, Hy, x_pts, y_pts, power_passing_through_lens,
    n_glass); the fields are complex tensors of shape (len(x_pts),
    len(y_pts)) on ``device`` in its working dtype.
    ``lens_periphery_summary`` may be None for a centre-only lens."""
    assert source_z < 0
    assert source_pol in ("x", "y", "z")
    device = _device(device)
    cdt = cpx.complex_dtype(device)
    wavelength_in_nm = int(round(wavelength / nm))

    have_periphery = lens_periphery_summary is not None
    if have_periphery:
        gratingcollection_list = \
            lens_periphery_summary["gratingcollection_list"]
        lens_max_r = lens_periphery_summary["r_max_list"][-1]
        n_glass = gratingcollection_list[0].grating_list[0].n_glass
    else:
        assert lens_center_summary is not None and len(lens_center_summary) > 0
        lens_max_r = _lens_max_radius(None, lens_center_summary, hexgridset)
        n_glass = hexgridset.n_glass
        gratingcollection_list = []
    if n_glass == 0:
        n_glass = n_glass_table(wavelength_in_nm)

    if x_pts is None:
        x_pts = _default_aperture_pts(wavelength, lens_max_r)
    if y_pts is None:
        y_pts = _default_aperture_pts(wavelength, lens_max_r)
    for l in (x_pts, y_pts):
        diffs = np.diff(l)
        assert 0 < diffs[0] < wavelength / 2
        assert diffs.max() - diffs.min() <= 1e-9 * np.abs(diffs).max()

    k_glass = 2 * pi * n_glass / wavelength
    kvac = 2 * pi / wavelength

    plane_wave = source_z == -inf
    if plane_wave:
        assert source_pol != "z"
    pol_vector = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1]}[source_pol]
    H_coef = nu.c0 * (2 * pi / wavelength) ** 2 * dipole_moment / (4 * pi)
    with trace.span("nearfield.geometry"):
        X, Y = (p.contiguous() for p in torch.meshgrid(
            _tab(x_pts, device), _tab(y_pts, device), indexing="ij"))
        (which_gc, in_center, uxp, uyp, xp, yp, grating_period,
         lateral_period, cosr, sinr, ux, uy, eikr_periph, H_xp_weight,
         H_yp_weight, dipole_field_Hx, dipole_field_Hy,
         local_power_z) = _geometry_planes(
            X, Y, *_ring_tables(lens_periphery_summary, device), lens_max_r,
            source_x, source_y,
            0.0 if plane_wave else source_z, kvac, pol_vector, H_coef,
            dipole_moment, have_periphery, plane_wave, cdt)

    Exp, Eyp, Hxp, Hyp = (torch.zeros(X.shape, dtype=cdt, device=device)
                          for _ in range(4))

    # ---- periphery accumulation: one loop over the orders per collection
    with trace.span("nearfield.periphery"):
        for gc_index, gc in enumerate(gratingcollection_list):
            all_orders = sorted({(e["ox"], e["oy"]) for g in gc.grating_list
                                 for e in g.data})
            bounds = gc.interpolator_bounds
            gc_mask = which_gc == gc_index
            stats = _region_stats(gc_mask, uxp, uyp, grating_period)
            if stats[0] == 0:
                continue
            _check_bounds(stats, (("ux", bounds[0], bounds[1]),
                                  ("uy", bounds[2], bounds[3]),
                                  ("grating_period", bounds[4], bounds[5])))
            pts = torch.stack([uxp.ravel(), uyp.ravel(),
                               grating_period.ravel()], dim=1)
            values_all, grids = _stack_order_tables(
                _tables_on(gc, device), wavelength_in_nm, all_orders,
                ("ampfy", "ampfx"))
            counts = _accumulate_orders(
                values_all, all_orders, grids, pts, gc_mask, uxp, uyp,
                2 * pi / grating_period, 2 * pi / lateral_period, xp, yp,
                kvac, k_glass, n_glass, H_xp_weight, H_yp_weight,
                (Exp, Eyp, Hxp, Hyp))
            if progress:
                trace.count("nearfield.host_reads")
                for (ox, oy), cnt in zip(all_orders, counts.tolist()):
                    print(f"diffraction order ({ox},{oy}) of gc "
                          f"{gc_index}; applies at {cnt} points", flush=True)

    # periphery air phase and rotation back to the lab frame (reference
    # nearfield.py:333-347)
    Ex, Ey, Hx, Hy = _rotate_to_lab(Exp, Eyp, Hxp, Hyp, eikr_periph,
                                    cosr, sinr)
    del Exp, Eyp, Hxp, Hyp

    # ---- centre accumulation ----
    # skip the whole block (site lookup and the loop over orders) when this
    # aperture slab holds no centre points, as the periphery loop does
    with trace.span("nearfield.centre"):
        run_center = (lens_center_summary is not None
                      and len(lens_center_summary) > 0)
        if run_center:
            stats = _region_stats(in_center, ux, uy, ux)
            run_center = stats[0] > 0
        if run_center:
            summary = np.asarray(lens_center_summary)
            site_xy = _tab(summary[:, 0:2], device)
            pitch = hexgridset.sep
            table, n1_min, n2_min = _hex_site_table(summary, pitch, device)
            rows, found = _nearest_center_site(X, Y, table, n1_min, n2_min,
                                               pitch, site_xy)
            miss = torch.nonzero(in_center & ~found)
            trace.count("nearfield.host_reads")
            if len(miss):
                # a centre point whose 4x4 analytic candidate window holds
                # no stored site (possible in the seam margin near
                # lens_max_r): brute-force the few offenders on the host so
                # they get the TRUE nearest site, the reference's global
                # cKDTree lookup (reference nearfield.py:363-367), not site
                # 0 with a wrong off-centre phase
                i, j = miss[:, 0], miss[:, 1]
                trace.count("nearfield.host_reads", 2)
                rows[i, j] = torch.as_tensor(_nearest_site_brute(
                    X[i, j].cpu().numpy(), Y[i, j].cpu().numpy(),
                    summary[:, 0:2]), device=device)
            cell_center_x = site_xy[rows, 0]
            cell_center_y = site_xy[rows, 1]
            which_grating = _tab(summary[:, 2], device)[rows]

            all_orders = sorted({(e["ox"], e["oy"])
                                 for g in hexgridset.grating_list
                                 for e in g.data})
            x_period = hexgridset.grating_list[0].grating_period
            y_period = hexgridset.grating_list[0].lateral_period
            b = hexgridset.interpolator_bounds
            _check_bounds(stats, (("ux", b[0], b[1]), ("uy", b[2], b[3])))
            pts = torch.stack([ux.ravel(), uy.ravel(),
                               which_grating.ravel()], dim=1)

            Exc, Eyc, Hxc, Hyc = (torch.zeros(X.shape, dtype=cdt,
                                              device=device)
                                  for _ in range(4))
            values_all, grids = _stack_order_tables(
                _tables_on(hexgridset, device), wavelength_in_nm, all_orders,
                ("ampfy", "ampfx"))
            counts = _accumulate_orders(
                values_all, all_orders, grids, pts, in_center, ux, uy,
                2 * pi / x_period, 2 * pi / y_period, X - cell_center_x,
                Y - cell_center_y, kvac, k_glass, n_glass,
                dipole_field_Hy, dipole_field_Hx, (Exc, Eyc, Hxc, Hyc))
            if progress:
                trace.count("nearfield.host_reads")
                for (ox, oy), cnt in zip(all_orders, counts.tolist()):
                    print(f"diffraction order ({ox},{oy}) of center; "
                          f"applies at {cnt} points", flush=True)
            if source_z > -inf:
                air_dist = torch.sqrt((cell_center_x - source_x) ** 2
                                      + (cell_center_y - source_y) ** 2
                                      + source_z ** 2)
                eikr = torch.polar(torch.ones_like(air_dist),
                                   kvac * air_dist).to(cdt)
                Exc, Eyc, Hxc, Hyc = (Exc * eikr, Eyc * eikr, Hxc * eikr,
                                      Hyc * eikr)
            Ex += Exc
            Ey += Eyc
            Hx += Hxc
            Hy += Hyc
            in_lens = (which_gc != -1) | in_center
        else:
            in_lens = which_gc != -1

    power_passing_through_lens = float(
        torch.where(in_lens, local_power_z, 0.0).sum()
        * (x_pts[1] - x_pts[0]) * (y_pts[1] - y_pts[0]))
    trace.count("nearfield.host_reads")

    return Ex, Ey, Hx, Hy, x_pts, y_pts, power_passing_through_lens, n_glass


def build_nearfield_big(source_x, source_y, source_z, source_pol, wavelength,
                        lens_periphery_summary, lens_center_summary,
                        hexgridset, x_pts=None, y_pts=None,
                        dipole_moment=1e-30 * nu.C * nu.m,
                        pts_at_a_time=1e7, progress=True, *, device="cuda"):
    """Slab-chunked :func:`build_nearfield` (API parity with reference
    ``nearfield.py:482-516``): the device holds one slab of y columns at a
    time and the fields come back as host numpy complex arrays."""
    if x_pts is None or y_pts is None:
        lens_max_r = _lens_max_radius(lens_periphery_summary,
                                      lens_center_summary, hexgridset)
        if x_pts is None:
            x_pts = _default_aperture_pts(wavelength, lens_max_r)
        if y_pts is None:
            y_pts = _default_aperture_pts(wavelength, lens_max_r)
    x_pts, y_pts = np.asarray(x_pts), np.asarray(y_pts)
    # each slab needs >= 2 columns (build_nearfield derives the grid
    # spacing from consecutive points)
    y_pts_at_a_time = max(2, int(pts_at_a_time / x_pts.size))
    Ex = np.zeros((x_pts.size, y_pts.size), dtype=complex)
    Ey = np.zeros_like(Ex)
    Hx = np.zeros_like(Ex)
    Hy = np.zeros_like(Ex)
    power_passing_through_lens = 0.0
    start = 0
    n_glass = None
    while start < y_pts.size:
        end = min(start + y_pts_at_a_time, y_pts.size)
        if y_pts.size - end == 1:
            end = y_pts.size   # absorb a would-be single-column final slab
        if progress:
            print("running y-index", start, "to", end, "out of", y_pts.size,
                  flush=True)
        out = build_nearfield(source_x=source_x, source_y=source_y,
                              source_z=source_z, source_pol=source_pol,
                              wavelength=wavelength,
                              lens_periphery_summary=lens_periphery_summary,
                              lens_center_summary=lens_center_summary,
                              hexgridset=hexgridset, x_pts=x_pts,
                              y_pts=y_pts[start:end],
                              dipole_moment=dipole_moment, device=device)
        for dst, f in zip((Ex, Ey, Hx, Hy), out[:4]):
            dst[:, start:end] = f.cpu().numpy()
        power_passing_through_lens += out[6]
        n_glass = out[7]
        start = end
    return (Ex, Ey, Hx, Hy, x_pts, y_pts, power_passing_through_lens,
            n_glass)
