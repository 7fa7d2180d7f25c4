"""Scene object ``Grating`` on the port's engine.

Counterpart of ``Grating`` in ``metalens_tpu/grating.py`` (constructor,
spec-roundtrip ``repr``, ``copy``, ``get_angle_in_air`` and ``fom``), with
the FOM routed to :mod:`metalens_tpu_torch.engine`.  The ``repr`` format is
the JAX package's (and the reference's), so a spec written by either
package evaluates in the other.
"""

from __future__ import annotations

import math

import numpy as np

from . import geometry
from .units import nm, um, degree, pi


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
            device="cpu", dtype=None):
        """Figure of merit of this cell (see
        :func:`metalens_tpu_torch.engine.fom_of_grating`): ``terms`` is a
        list of :class:`~metalens_tpu_torch.solver.fom.FomTerm` (None: the
        reference default); ``target_wavelength`` sets the incidence angle
        via :meth:`get_angle_in_air`."""
        from .engine import fom_of_grating
        return fom_of_grating(self, target_wavelength=target_wavelength,
                              numG=numG, terms=terms, device=device,
                              dtype=dtype)
