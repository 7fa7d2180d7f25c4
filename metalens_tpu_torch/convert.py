"""Carry a unit cell's parameters into the port.

The port never imports the JAX package, so a cell crosses over as plain
numbers: SI floats for the periods and the height, the index attributes
(0 = tabulated dispersion), the (nE, 5) ``xyrra`` array in metres and
radians and the amplitude database; a collection or a hexgrid set as its
own scalars and its members.
"""

from __future__ import annotations

import numpy as np

from .grating import Grating, GratingCollection
from .hexgrid import HexGridSet


def grating_from_arrays(lateral_period, grating_period, cyl_height, n_glass,
                        n_tio2, xyrra_list) -> Grating:
    """A port :class:`Grating` from SI floats and an (nE, 5) array."""
    g = Grating(lateral_period=float(lateral_period),
                grating_period=float(grating_period),
                cyl_height=float(cyl_height), n_glass=n_glass, n_tio2=n_tio2)
    g.xyrra_list = np.array(xyrra_list, dtype=np.float64, copy=True)
    return g


def grating_from_reference(g) -> Grating:
    """A port :class:`Grating` from any object with the attributes
    ``lateral_period``, ``grating_period``, ``cyl_height``, ``n_glass``,
    ``n_tio2`` and ``xyrra_list`` -- e.g. a ``metalens_tpu.Grating`` --
    with a copy of its amplitude database ``data`` where it has one."""
    out = grating_from_arrays(g.lateral_period, g.grating_period,
                              g.cyl_height, g.n_glass, g.n_tio2,
                              np.asarray(g.xyrra_list))
    if hasattr(g, "data"):
        out.data = [dict(e) for e in g.data]
    return out


def collection_from_reference(gc) -> GratingCollection:
    """A port :class:`GratingCollection` from any object with the
    attributes ``target_wavelength``, ``lateral_period``, ``lens_type`` and
    ``grating_list`` -- e.g. a ``metalens_tpu.GratingCollection`` -- each
    member carried across by :func:`grating_from_reference`."""
    return GratingCollection(
        target_wavelength=float(gc.target_wavelength),
        lateral_period=float(gc.lateral_period), lens_type=gc.lens_type,
        grating_list=[grating_from_reference(g) for g in gc.grating_list])


def hexgrid_from_reference(hgs) -> HexGridSet:
    """A port :class:`HexGridSet` from any object with the attributes
    ``sep``, ``cyl_height``, ``n_glass``, ``n_tio2`` and ``grating_list``
    (and ``x_amp_list`` once characterized) -- e.g. a
    ``metalens_tpu.hexgrid.HexGridSet`` -- each member carried across by
    :func:`grating_from_reference`."""
    return HexGridSet(
        sep=float(hgs.sep), cyl_height=float(hgs.cyl_height),
        n_glass=hgs.n_glass, n_tio2=hgs.n_tio2,
        grating_list=[grating_from_reference(g) for g in hgs.grating_list],
        x_amp_list=getattr(hgs, "x_amp_list", None))
