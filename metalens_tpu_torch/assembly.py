"""Lens assembly: glue GratingCollections (periphery) + HexGridSet (center)
into a full collimator/lens design, and expand designs into explicit
nano-pillar lists.

The port's copy of ``metalens_tpu/assembly.py`` (numpy throughout),
pointed at the port's ``GratingCollection`` and ``HexGridSet``; the
functions, their arguments and their outputs are the JAX package's, which
follows the reference ``design_collimator.py``.

Key outputs (consumed by :mod:`metalens_tpu_torch.nearfield`):

* ``lens_periphery_summary`` dict: r_center/r_min/r_max/grating_period
  arrays, the GratingCollection list, per-ring collection indices, and
  copies-around-the-circle counts (reference ``design_collimator.py:148-228``);
* ``lens_center_summary`` array [[x, y, hexgridset-index], ...];
* full ``xyrra_list`` of every pillar in the lens.
"""

from __future__ import annotations

import math

import numpy as np

from . import grating as grating_mod, trace
from .hexgrid import HexGridSet
from .units import nm, um, pi

degree = pi / 180

# Default design constants (reference ``design_collimator.py:33-54``).
PITCH = 320 * nm                 # hex-lattice nearest-neighbor separation
PERIOD = PITCH * math.sqrt(3)
CYL_HEIGHT = 550 * nm
WAVELENGTH = 580 * nm            # design wavelength (vacuum)
REFRACTIVE_INDEX = 1             # medium between the source and the lens


def target_phase(x, source_distance, wavelength=WAVELENGTH,
                 refractive_index=REFRACTIVE_INDEX):
    """Collimator target phase at radius x from the lens center: the
    conjugate of a point source at distance d (reference
    ``design_collimator.py:57-60``)."""
    k = 2 * pi * refractive_index / wavelength
    return (-k * (np.sqrt(source_distance ** 2 + np.asarray(x) ** 2)
                  - source_distance)) % (2 * pi)


def target_phase_zeros(radius, source_distance, wavelength=WAVELENGTH,
                       refractive_index=REFRACTIVE_INDEX):
    """Radii of the 2*pi phase wraps = Fresnel-zone ring boundaries
    (reference ``design_collimator.py:62-70``)."""
    ans = []
    order = 0
    k = 2 * pi * refractive_index / wavelength
    while len(ans) == 0 or ans[-1] < radius:
        x = (((2 * pi * order) / k + source_distance) ** 2
             - source_distance ** 2) ** 0.5
        ans.append(x)
        order += 1
    return ans


def hexagonal_grid(n, radius, fourfold_symmetry=True):
    """(x, y) sites of a hexagonal lattice with nearest-neighbor separation
    n inside a circle (reference ``design_collimator.py:74-118``),
    vectorized.  With fourfold_symmetry, restrict to the x,y >= 0 quadrant."""
    if fourfold_symmetry is True:
        corners = [(0, 0), (radius, 0), (0, radius), (radius, radius)]
    else:
        corners = [(radius, radius), (radius, -radius), (-radius, radius),
                   (-radius, -radius)]
    n1n2 = [(y / n - x / (n * 3 ** 0.5), 2 * x / (n * 3 ** 0.5))
            for x, y in corners]
    min_n1 = int(min(a for a, b in n1n2)) - 2
    max_n1 = int(max(a for a, b in n1n2)) + 2
    min_n2 = int(min(b for a, b in n1n2)) - 2
    max_n2 = int(max(b for a, b in n1n2)) + 2

    n1g, n2g = np.meshgrid(np.arange(min_n1, max_n1 + 1),
                           np.arange(min_n2, max_n2 + 1), indexing="ij")
    x = n * n2g * 3 ** 0.5 / 2
    y = n * (n1g + n2g / 2)
    inside = x ** 2 + y ** 2 < radius ** 2
    if fourfold_symmetry is True:
        inside &= (x >= 0) & (y >= 0)
    return np.stack([x[inside], y[inside]], axis=1)


@trace.traced("assembly.centre_picks")
def design_center(hgs, source_distance, radius, wavelength=WAVELENGTH):
    """Assign each hex site the HexGridSet index matching the target phase
    (reference ``design_collimator.py:120-137``).  Returns
    lens_center_summary [[x, y, index], ...]."""
    assert isinstance(hgs, HexGridSet)
    # Lay sites on the SET's own lattice (hgs.sep), not the module default
    # PITCH: the stitcher inverts site positions analytically against
    # hexgridset.sep (nearfield._hex_site_table), so a sep != PITCH set on
    # the PITCH lattice would be mis-spaced and fail the lattice inversion.
    xy = hexagonal_grid(hgs.sep, radius, fourfold_symmetry=False)
    if xy.shape[0] == 0:
        return np.zeros((0, 3))
    r = np.hypot(xy[:, 0], xy[:, 1])
    # +pi aligns the center's phase convention with the periphery's
    # (empirically fixed in the reference, design_collimator.py:130-135,
    # and verified there by plotting the stitched near-field phase)
    phases = (target_phase(r, source_distance, wavelength) + pi)
    idx = np.array([hgs.pick_from_phase(p) for p in phases], dtype=float)
    trace.count("assembly.centre_sites", len(idx))
    return np.column_stack([xy, idx])


@trace.traced("assembly.centre_pillars")
def make_center_xyrra_list(hgs, lens_center_summary):
    """Expand center sites to pillars (reference
    ``design_collimator.py:139-146``)."""
    assert isinstance(hgs, HexGridSet)
    if len(lens_center_summary) == 0:
        return np.zeros((0, 5))
    radii = np.array([g.xyrra_list[0, 2] for g in hgs.grating_list])
    r = radii[lens_center_summary[:, 2].astype(int)]
    return np.column_stack([lens_center_summary[:, 0],
                            lens_center_summary[:, 1], r, r,
                            np.zeros_like(r)])


@trace.traced("assembly.rings")
def design_periphery(collections, source_distance, radius,
                     wavelength=WAVELENGTH):
    """Ring layout of the lens periphery, as one vectorized pass: the
    Fresnel-zone boundaries are the 2*pi wraps of the target phase, every
    ring is the annulus between consecutive wraps, and each ring binds to
    the collection whose angle bracket contains its center.  (Same output
    contract as reference ``design_collimator.py:148-228``, which walks the
    zeros one ring at a time; the stitcher consumes these exact keys.)

    ``collections`` is [[(phi_start, phi_end), grating_collection], ...]
    with contiguous angle brackets."""
    assert len(collections) > 0
    for i in range(len(collections) - 1):
        assert collections[i][0][1] == collections[i + 1][0][0]
    assert all(x[0][0] < x[0][1] for x in collections)
    for _, gc in collections:
        assert isinstance(gc, grating_mod.GratingCollection)

    # zone boundaries from the innermost bracket edge out past the rim
    # (the outermost ring is the first whose outer edge clears `radius`)
    zeros = np.asarray(target_phase_zeros(radius + 2 * um, source_distance,
                                          wavelength))
    zeros = zeros[zeros > source_distance * math.tan(collections[0][0][0])]
    if zeros.size <= 1:
        raise ValueError("Periphery is too small for even one ring")
    inner, outer = zeros[:-1], zeros[1:]
    keep = 1 + int(np.argmax(outer > radius))   # target_phase_zeros always
    inner, outer = inner[:keep], outer[:keep]   # emits a zero past radius
    r_center = (inner + outer) / 2

    # ring -> collection: first bracket whose high edge reaches the ring
    # center's incidence angle (brackets are contiguous and sorted)
    bracket_hi = np.array([hi for (_, hi), _ in collections])
    which = np.searchsorted(bracket_hi, np.arctan2(r_center,
                                                   source_distance))
    if which.size and which[-1] >= len(collections):
        raise ValueError("radius is too big for provided collections")

    # copies around the circle: 2*pi*d / (lateral_period/tan(angle)) =
    # 2*pi*x / lateral_period(x), constant per collection by the round-lens
    # invariant
    per_collection_count = np.array(
        [int(round(2 * pi * source_distance / gc.lateral_period))
         for _, gc in collections])
    return {"gratingcollection_list": [i[1] for i in collections],
            "r_center_list": r_center,
            "r_min_list": inner,
            "r_max_list": outer,
            "grating_period_list": outer - inner,
            "gratingcollection_index_here_list": which,
            "num_around_circle_list": per_collection_count[which]}


@trace.traced("assembly.periphery_pillars")
def make_periphery_xyrra_list(lens_periphery_summary, progress=False):
    """Instantiate every periphery pillar: per ring, interpolate the unit
    cell at the ring's period, dedup pillars crossing the radial periodic
    seam, then rotate copies around the circle (reference
    ``design_collimator.py:230-271``).  The rotation fan-out is vectorized
    over (copies x pillars)."""
    num_around_circle_list = lens_periphery_summary["num_around_circle_list"]
    gratingcollection_list = lens_periphery_summary["gratingcollection_list"]
    gc_idx = lens_periphery_summary["gratingcollection_index_here_list"]
    grating_period_list = lens_periphery_summary["grating_period_list"]
    r_center_list = lens_periphery_summary["r_center_list"]
    pieces = []
    num_rings = len(num_around_circle_list)
    for i in range(num_rings):
        nc = num_around_circle_list[i]
        gc_here = gratingcollection_list[gc_idx[i]]
        grating_period = grating_period_list[i]
        xyrra_here = gc_here.get_one(grating_period=grating_period).xyrra_list
        if i != 0 and gc_idx[i] == gc_idx[i - 1]:
            # seam dedup for pillars crossing the radial periodic boundary
            xyrra_prev = gc_here.get_one(
                grating_period=grating_period_list[i - 1]).xyrra_list
            if xyrra_prev.shape == xyrra_here.shape:
                for j in range(xyrra_here.shape[0]):
                    if (xyrra_prev[j, 0] > 0.8 * grating_period
                            and xyrra_here[j, 0] < 0.2 * grating_period):
                        xyrra_here = np.delete(xyrra_here, j, axis=0)
                        break
                    if (xyrra_prev[j, 0] < 0.2 * grating_period
                            and xyrra_here[j, 0] > 0.8 * grating_period):
                        xyrra_here = np.vstack((xyrra_here,
                                                [xyrra_prev[j, :]]))
                        break
        angles = np.linspace(0, 2 * pi, num=nc, endpoint=False)
        x = xyrra_here[:, 0] + r_center_list[i]
        y = xyrra_here[:, 1]
        ca, sa = np.cos(angles)[:, None], np.sin(angles)[:, None]
        X = x[None, :] * ca - y[None, :] * sa
        Y = x[None, :] * sa + y[None, :] * ca
        RX = np.broadcast_to(xyrra_here[None, :, 2], X.shape)
        RY = np.broadcast_to(xyrra_here[None, :, 3], X.shape)
        A = angles[:, None] + xyrra_here[None, :, 4]
        pieces.append(np.stack([X, Y, RX, RY, A], axis=-1).reshape(-1, 5))
        if progress:
            print(f"ring {i + 1}/{num_rings}: {pieces[-1].shape[0]} pillars",
                  flush=True)
    return np.concatenate(pieces, axis=0) if pieces else np.zeros((0, 5))


@trace.traced("assembly.make_design")
def make_design(collections, source_distance, radius, hgs,
                make_xyrra_list=False, wavelength=WAVELENGTH):
    """Full round-lens design: periphery rings + hex center (reference
    ``design_collimator.py:273-313``).  ``collections`` may be empty for a
    center-only lens."""
    if len(collections) > 0:
        n_tio2 = hgs.n_tio2
        n_glass = hgs.n_glass
        cyl_height = hgs.cyl_height
        for _, gc in collections:
            assert gc.lens_type == "round"
            for g in gc.grating_list:
                assert g.n_tio2 == n_tio2
                assert g.n_glass == n_glass
                assert g.cyl_height == cyl_height
        lens_periphery_summary = design_periphery(collections,
                                                  source_distance, radius,
                                                  wavelength)
        if make_xyrra_list:
            periphery_xyrra_list = make_periphery_xyrra_list(
                lens_periphery_summary)
        r_for_switch = lens_periphery_summary["r_min_list"][0]
        assert r_for_switch < radius
    else:
        r_for_switch = radius
        periphery_xyrra_list = None
        lens_periphery_summary = None

    lens_center_summary = design_center(hgs, source_distance,
                                        r_for_switch - 300 * nm, wavelength)

    if make_xyrra_list:
        center_xyrra_list = make_center_xyrra_list(hgs, lens_center_summary)
        if periphery_xyrra_list is not None:
            xyrra_list = np.vstack((center_xyrra_list, periphery_xyrra_list))
        else:
            xyrra_list = center_xyrra_list
        trace.count("assembly.pillars", len(xyrra_list))
        return (lens_periphery_summary, lens_center_summary, r_for_switch,
                xyrra_list)
    return lens_periphery_summary, lens_center_summary, r_for_switch
