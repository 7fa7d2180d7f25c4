"""Scene objects ``Grating`` and ``GratingCollection`` on the port's engine.

Counterpart of ``metalens_tpu/grating.py``: ``Grating`` (constructor,
spec-roundtrip ``repr``, ``copy``, ``standardize``, ``get_angle_in_air``,
``fom``, ``characterize`` with the ``run_lua`` names, ``save``), the
fabrication constraints with :func:`validate` and :func:`resize`, and
``GratingCollection`` (members, interpolation by period, ``repr``,
``characterize``, ``build_interpolators``, ``save``), with the solves
routed to :mod:`metalens_tpu_torch.engine`.
The ``repr`` formats are the JAX package's (and the reference's), so a spec
written by either package evaluates in the other.  Everything here is
numpy.
"""

from __future__ import annotations

import math

import numpy as np

from . import geometry
from .units import nm, um, degree, pi

# fabrication constraints (reference ``grating.py:509-510``)
min_diameter = 100 * nm
min_distance = 100 * nm


class Grating:
    """One metasurface unit cell: periodic cell ``grating_period x
    lateral_period`` of TiO2 elliptical nano-pillars (height ``cyl_height``)
    on glass.

    ``xyrra_list`` rows are [x, y, semi-axis-x, semi-axis-y, ccw-rotation],
    stored in SI metres / radians; the constructor takes nm + degrees.
    ``n_glass``/``n_tio2`` equal to 0 is the use-tabulated-dispersion
    sentinel.
    """

    def __init__(self, lateral_period, cyl_height, grating_period=None,
                 target_wavelength=None, angle_in_air=None,
                 n_glass=0, n_tio2=0, xyrra_list_in_nm_deg=None, data=None):
        if grating_period is not None:
            if target_wavelength is not None or angle_in_air is not None:
                raise ValueError("give grating_period, or target_wavelength "
                                 "and angle_in_air, not both")
            self.grating_period = grating_period
        else:
            self.grating_period = target_wavelength / math.sin(angle_in_air)
        self.n_glass = n_glass
        self.n_tio2 = n_tio2
        self.lateral_period = lateral_period
        self.cyl_height = cyl_height
        self.grating_kx = 2 * pi / self.grating_period
        if xyrra_list_in_nm_deg is not None:
            xyrra = np.array(xyrra_list_in_nm_deg, dtype=np.float64, copy=True)
            xyrra[:, 0:4] *= nm
            xyrra[:, 4] *= degree
            self.xyrra_list = xyrra
        if data is not None:
            self.data = data

    def get_xyrra_list(self, units=None, replicas=None):
        """The pillar list, optionally with the periodic replicas whose
        outline enters the central cell (``replicas=True``) or the
        +-(N+1/2)-cell window (``replicas=N``), in SI or ``"nm,deg"`` /
        ``"um,deg"`` units."""
        if replicas is not None:
            N = 0 if replicas is True else replicas
            xyrra = geometry.replica_xyrra(self.xyrra_list,
                                           self.grating_period,
                                           self.lateral_period, N=N)
        else:
            xyrra = np.array(self.xyrra_list, copy=True)
        if units is None:
            return xyrra
        if units == "nm,deg":
            xyrra[:, 0:4] /= nm
        elif units == "um,deg":
            xyrra[:, 0:4] /= um
        else:
            raise ValueError("bad units specification")
        xyrra[:, 4] /= degree
        return xyrra

    @property
    def xyrra_list_in_nm_deg(self):
        return self.get_xyrra_list(units="nm,deg")

    @property
    def xyrra_list_in_um_deg(self):
        return self.get_xyrra_list(units="um,deg")

    def get_angle_in_air(self, target_wavelength):
        """Angle (in air) of light this cell deflects to normal-in-glass for
        a lens designed at target_wavelength."""
        if self.grating_period < target_wavelength:
            raise ValueError("bad inputs!", target_wavelength / nm,
                             self.grating_period / nm)
        return math.asin(target_wavelength / self.grating_period)

    def standardize(self):
        """Wrap pillars into the canonical periodic replica, in place."""
        geometry.standardize_xyrra(self.xyrra_list, self.grating_period,
                                   self.lateral_period)

    def __repr__(self):
        """Spec-roundtrip repr: evaluating the string (with ``Grating``,
        ``np`` and ``nm`` in scope) reconstructs the object."""
        xyrra_list_str = (np.array2string(self.xyrra_list_in_nm_deg,
                                          separator=",", threshold=int(1e9),
                                          max_line_width=int(1e9))
                          .replace(" ", "").replace("\n", ""))
        return ("Grating(lateral_period=" + repr(self.lateral_period / nm) + "*nm"
                + ", grating_period=" + repr(self.grating_period / nm) + "*nm"
                + ", cyl_height=" + repr(self.cyl_height / nm) + "*nm"
                + ", n_glass=" + repr(self.n_glass)
                + ", n_tio2=" + repr(self.n_tio2)
                + ", xyrra_list_in_nm_deg=np.array(" + xyrra_list_str + ")"
                + ", data=" + (repr(self.data) if hasattr(self, "data") else "None")
                + ")")

    def copy(self):
        g = Grating(lateral_period=self.lateral_period,
                    grating_period=self.grating_period,
                    cyl_height=self.cyl_height,
                    n_glass=self.n_glass, n_tio2=self.n_tio2)
        if hasattr(self, "xyrra_list"):
            g.xyrra_list = np.array(self.xyrra_list, copy=True)
        if hasattr(self, "data"):
            g.data = list(self.data)
        return g

    def fom(self, target_wavelength=None, numG=50, terms=None, *,
            device="cuda", dtype=None):
        """Figure of merit of this cell (see
        :func:`metalens_tpu_torch.engine.fom_of_grating`): ``terms`` is a
        list of :class:`~metalens_tpu_torch.solver.fom.FomTerm` (None: the
        reference default); ``target_wavelength`` sets the incidence angle
        via :meth:`get_angle_in_air`.  Runs on CUDA unless
        ``device="cpu"``."""
        from .engine import fom_of_grating
        return fom_of_grating(self, target_wavelength=target_wavelength,
                              numG=numG, terms=terms, device=device,
                              dtype=dtype)

    def save(self, path):
        """Binary persistence (see
        :mod:`metalens_tpu_torch.serialization`)."""
        from .serialization import save
        return save(self, path)

    def run_lua(self, target_wavelength=None, subfolder=None, numG=50,
                terms=None, *, device="cuda", dtype=None, **kwargs):
        """The reference's name for :meth:`fom`; with characterize keyword
        arguments it runs :meth:`characterize` instead."""
        if kwargs:
            return self.characterize(numG=numG, device=device, dtype=dtype,
                                     **kwargs)
        return self.fom(target_wavelength=target_wavelength, numG=numG,
                        terms=terms, device=device, dtype=dtype)

    def run_lua_initiate(self, target_wavelength=None, subfolder=None,
                         numG=50, terms=None, *, device="cuda", dtype=None,
                         **kwargs):
        """A deferred :meth:`run_lua` (the reference's initiate/getresult
        pair): evaluate the returned handle with :meth:`run_lua_getresult`,
        or pass it to ``characterize(process=...)``."""
        return lambda: self.run_lua(target_wavelength=target_wavelength,
                                    numG=numG, terms=terms, device=device,
                                    dtype=dtype, **kwargs)

    @staticmethod
    def run_lua_getresult(process):
        """Evaluate a handle from :meth:`run_lua_initiate`."""
        return process()

    def characterize(self, subfolder=None, process=None,
                     ux_min=None, ux_max=None, uy_min=-0.2, uy_max=0.2,
                     u_steps=3, wavelength=580 * nm, numG=100,
                     convert_to_xy=True, just_normal=False, append=False, *,
                     device="cuda", dtype=None):
        """Fill ``self.data``, the amplitude database over a grid of
        incoming directions, in one batched solve (see
        :func:`metalens_tpu_torch.engine.characterize_grating`).
        ``just_normal`` solves the (0.001, 0.001) direction and mirrors it
        into the other quadrants.  ``append=True`` keeps the entries at
        other wavelengths (an RGB database) and replaces those at the
        wavelengths of this call.  ``process``: a handle from
        :meth:`run_lua_initiate`, which runs with the initiate call's
        arguments; this call's own sweep arguments are ignored.  Runs on
        CUDA unless ``device="cpu"``."""
        from .engine import characterize_grating
        if process is not None:
            assert not append, "append is not supported via a process handle"
            return process()
        if just_normal:
            ux_min = ux_max = uy_min = uy_max = 0.001
            u_steps = 1
        else:
            if ux_min is None:
                ux_min = max(-0.99, self.get_angle_in_air(580 * nm) - 0.2)
            if ux_max is None:
                ux_max = min(0.99, self.get_angle_in_air(580 * nm) + 0.2)
        assert convert_to_xy or not just_normal
        new_data = characterize_grating(
            self, ux_min=ux_min, ux_max=ux_max, uy_min=uy_min, uy_max=uy_max,
            u_steps=u_steps, wavelength=wavelength, numG=numG,
            just_normal=just_normal, convert_to_xy=convert_to_xy,
            device=device, dtype=dtype)
        if append and hasattr(self, "data"):
            wls = ({round(float(wavelength) / nm)}
                   if np.ndim(wavelength) == 0
                   else {round(w / nm) for w in wavelength})
            self.data = [e for e in self.data
                         if round(e["wavelength_in_nm"]) not in wls] + new_data
        else:
            self.data = new_data
        return self.data


def validate(mygrating, print_details=False, similar_to=None, how_similar=None):
    """Fabricability / trust-region check (reference ``grating.py:522-599``),
    vectorized.  True iff every semi-axis is at least min_diameter/2, every
    pair of pillar outlines (and each pillar and its own y-replica) is at
    least ``min_distance`` apart under the periodic metric, and, with
    ``similar_to``, radii, position and rotation drifted by less than the
    fraction ``how_similar`` from it."""
    xyrra_list = mygrating.xyrra_list
    if xyrra_list[:, [2, 3]].min() < min_diameter / 2:
        if print_details:
            print("a diameter is too small")
        return False

    min_between, min_self = geometry.min_pairwise_outline_distance(
        xyrra_list, mygrating.grating_period, mygrating.lateral_period,
        num_points=100)
    if min_self < min_distance:
        if print_details:
            print("too close, between an ellipse and its periodic replica")
        return False
    if min_between < min_distance:
        if print_details:
            print("too close, between two ellipses")
        return False

    if similar_to is not None:
        distance_mod = geometry.distance_mod
        for i in range(xyrra_list.shape[0]):
            if max(abs(xyrra_list[i, 2:4] - similar_to[i, 2:4])
                   / similar_to[i, 2:4]) > how_similar:
                if print_details:
                    print("A radius of ellipse", i, "changed too much")
                return False
            if distance_mod(xyrra_list[i, 0], similar_to[i, 0],
                            mygrating.grating_period) \
                    > how_similar * mygrating.grating_period:
                if print_details:
                    print("x-coordinate of ellipse", i, "changed too much")
                return False
            if distance_mod(xyrra_list[i, 1], similar_to[i, 1],
                            mygrating.lateral_period) \
                    > how_similar * mygrating.lateral_period:
                if print_details:
                    print("y-coordinate of ellipse", i, "changed too much")
                return False
            if distance_mod(xyrra_list[i, 4], similar_to[i, 4],
                            2 * pi) > how_similar * (2 * pi):
                if print_details:
                    print("rotation of ellipse", i, "changed too much")
                return False
    return True


def resize(oldgrating, newgrating_shell):
    """Seed a new-periodicity cell from an old one (reference
    ``grating.py:601-648``): the direct copy if it validates, else one cut
    at the emptiest x-coordinate, else the period shrink spread over every
    gap in proportion to its removable slack (the multi-gap fallback of the
    JAX package, for boundary-packed designs)."""
    oldgrating = oldgrating.copy()
    oldgrating.standardize()
    g = newgrating_shell.copy()
    g.xyrra_list = np.array(oldgrating.xyrra_list, copy=True)
    if validate(g) is True:
        return g

    old_grating_period = oldgrating.grating_period
    new_grating_period = g.grating_period
    assert new_grating_period < old_grating_period
    assert g.lateral_period >= oldgrating.lateral_period

    # clearance of candidate cut lines to the nearest pillar outline
    try_cutting = np.linspace(-old_grating_period / 2, old_grating_period / 2,
                              num=100, endpoint=False)
    outline_x = geometry.ellipse_outlines(oldgrating.xyrra_list,
                                          num_points=80)[..., 0].ravel()
    clearance = geometry.distance_mod(try_cutting[:, None], outline_x[None, :],
                                      old_grating_period).min(axis=1)
    x_to_cut_at = try_cutting[np.argmax(clearance)]

    shift = g.xyrra_list[:, 0] > x_to_cut_at
    g.xyrra_list[shift, 0] -= (old_grating_period - new_grating_period)
    if validate(g) is True:
        return g

    # multi-gap fallback: a cut line with outline clearance c tolerates
    # removing up to 2c - min_distance; each maximal run of lines clear of
    # any outline (a gap region) contributes its best line as a cut
    delta = old_grating_period - new_grating_period
    above = clearance > min_distance / 2
    runs, start = [], None
    for i, ok in enumerate(above):
        if ok and start is None:
            start = i
        elif not ok and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:   # wraps: merge with a leading run if any
        if runs and runs[0][0] == 0:
            runs[0] = (start - len(above), runs[0][1])
        else:
            runs.append((start, len(above)))
    cuts, slacks = [], []
    for a, b in runs:
        idx = np.arange(a, b) % len(above)
        j = idx[np.argmax(clearance[idx])]
        slack = 2 * clearance[j] - min_distance
        if slack > 0:
            cuts.append(try_cutting[j])
            slacks.append(slack)
    cuts, slacks = np.asarray(cuts), np.asarray(slacks)
    if len(cuts) and slacks.sum() > delta:
        take = delta * slacks / slacks.sum()
        g.xyrra_list = np.array(oldgrating.xyrra_list, copy=True)
        shift_per_pillar = (
            (g.xyrra_list[:, 0:1] > cuts[None, :]) * take[None, :]
        ).sum(axis=1)
        g.xyrra_list[:, 0] -= shift_per_pillar
        g.standardize()
        if validate(g) is True:
            return g
    assert validate(g, print_details=True)
    return g


class GratingCollection:
    """A smoothly varying family of Gratings covering a range of deflection
    angles for one lens annulus (reference ``grating.py:920-1232``).

    ``lens_type='cyl'``: lateral_period constant across the family.
    ``lens_type='round'``: the stored ``lateral_period`` is shorthand for
    ``lateral_period / tan(angle_in_air)``, constant across the family.
    """

    def __init__(self, target_wavelength, lateral_period,
                 lens_type="cyl", grating_list=None):
        self.target_wavelength = target_wavelength
        self.lateral_period = lateral_period
        self.target_kvac = 2 * pi / target_wavelength
        self.lens_type = lens_type
        assert self.lens_type in ("cyl", "round")
        if grating_list is None:
            self.grating_list = []
        else:
            self.grating_list = grating_list
            self.sort_grating_list()
            self.check_consistency()

    def check_consistency(self):
        assert len({g.cyl_height for g in self.grating_list}) <= 1
        assert len({g.n_glass for g in self.grating_list}) <= 1
        assert len({g.n_tio2 for g in self.grating_list}) <= 1
        if self.lens_type == "cyl":
            assert all(self.lateral_period == g.lateral_period
                       for g in self.grating_list)
        else:
            wl = self.target_wavelength
            ratios = [g.lateral_period
                      / math.tan(g.get_angle_in_air(target_wavelength=wl))
                      for g in self.grating_list]
            assert (max(ratios) - min(ratios)) < 1e-7 * max(ratios)

    def sort_grating_list(self):
        self.grating_list.sort(key=lambda x: x.grating_period)

    def add_one(self, new_grating):
        self.grating_list.append(new_grating)
        self.grating_list.sort(key=lambda x: x.grating_period)
        self.check_consistency()

    def get_one(self, angle_in_air=None, grating_period=None,
                lateral_period=None):
        """A Grating at any period within (or 1% beyond) the family's range,
        linearly blending the neighbours' xyrra lists (reference
        ``grating.py:981-1047``)."""
        if grating_period is not None:
            assert angle_in_air is None and lateral_period is None
        elif angle_in_air is not None:
            assert lateral_period is None
            grating_period = self.target_wavelength / math.sin(angle_in_air)
        else:
            assert self.lens_type == "round"
            angle_in_air = math.atan(lateral_period / self.lateral_period)
            grating_period = self.target_wavelength / math.sin(angle_in_air)

        if self.lens_type == "cyl":
            lateral_period = self.lateral_period
        else:
            angle_in_air = math.asin(self.target_wavelength / grating_period)
            lateral_period = self.lateral_period * math.tan(angle_in_air)

        self.sort_grating_list()
        periods = [g.grating_period for g in self.grating_list]
        if (grating_period < periods[0] * 0.99
                or grating_period > periods[-1] * 1.01):
            xyrra_list_in_nm_deg = None
        elif grating_period > periods[-1]:
            xyrra_list_in_nm_deg = self.grating_list[-1].xyrra_list_in_nm_deg
        elif grating_period < periods[0]:
            xyrra_list_in_nm_deg = self.grating_list[0].xyrra_list_in_nm_deg
        elif grating_period in periods:
            i = periods.index(grating_period)
            xyrra_list_in_nm_deg = self.grating_list[i].xyrra_list_in_nm_deg
        else:
            i = next(j for j, p in enumerate(periods) if p > grating_period)
            p0, p1 = periods[i - 1], periods[i]
            assert p0 < grating_period < p1
            w1 = (grating_period - p0) / (p1 - p0)
            w0 = (p1 - grating_period) / (p1 - p0)
            xyrra_list_in_nm_deg = (
                w0 * self.grating_list[i - 1].xyrra_list_in_nm_deg
                + w1 * self.grating_list[i].xyrra_list_in_nm_deg)

        return Grating(lateral_period=lateral_period,
                       cyl_height=self.grating_list[0].cyl_height,
                       grating_period=grating_period,
                       n_glass=self.grating_list[0].n_glass,
                       n_tio2=self.grating_list[0].n_tio2,
                       xyrra_list_in_nm_deg=xyrra_list_in_nm_deg)

    def get_innermost(self):
        """Grating for the closest-to-lens-center edge of the family."""
        return self.grating_list[-1]

    def get_outermost(self):
        return self.grating_list[0]

    def characterize(self, wavelength, numG=100, u_steps=5,
                     just_normal=False, append=False, *, device="cuda",
                     dtype=None):
        """Fill every member's amplitude database, one batched solve per
        member, over the directions the family deflects (its angle range
        +-0.25 in ux, uy in [-0.2, 0.2]).  ``wavelength`` is a number or a
        list (one joint sweep); ``append=True`` adds wavelengths to an RGB
        database.  Runs on CUDA unless ``device="cpu"``."""
        if just_normal:
            ux_min = ux_max = uy_min = uy_max = 0.001
            u_steps = 1
        else:
            wl = self.target_wavelength
            ux_min = max(-0.99, self.get_innermost().get_angle_in_air(wl)
                         - 0.25)
            ux_max = min(0.99, self.get_outermost().get_angle_in_air(wl)
                         + 0.25)
            uy_min, uy_max = -0.2, 0.2
        for g in self.grating_list:
            g.characterize(ux_min=ux_min, ux_max=ux_max, uy_min=uy_min,
                           uy_max=uy_max, u_steps=u_steps,
                           wavelength=wavelength, numG=numG,
                           just_normal=just_normal, append=append,
                           device=device, dtype=dtype)

    def build_interpolators(self, *, device="cuda"):
        """The (ux, uy, grating_period) -> complex amplitude tables of the
        members' databases, ``self.interpolators[(wl_nm, (ox, oy),
        'x'|'y', 'ampfy'|'ampfx')]``, with the period axis padded by 1% at
        both ends (see :mod:`metalens_tpu_torch.characterize`).  The tables
        live on ``device`` (CUDA unless ``device="cpu"``)."""
        from .characterize import build_collection_interpolators
        self.interpolators, self.interpolator_bounds = \
            build_collection_interpolators(self, device=device)
        return self.interpolators

    def save(self, path):
        """Binary persistence (see
        :mod:`metalens_tpu_torch.serialization`)."""
        from .serialization import save
        return save(self, path)

    def __repr__(self):
        return ("GratingCollection("
                + "target_wavelength=" + repr(self.target_wavelength / nm) + "*nm"
                + ", lateral_period=" + repr(self.lateral_period / nm) + "*nm"
                + ", lens_type=" + repr(self.lens_type)
                + ", grating_list= " + repr(self.grating_list)
                + ")")
