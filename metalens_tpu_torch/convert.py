"""Carry a unit cell's parameters into the port.

The port never imports the JAX package, so a cell crosses over as plain
numbers: SI floats for the periods and the height, the index attributes
(0 = tabulated dispersion) and the (nE, 5) ``xyrra`` array in metres and
radians.
"""

from __future__ import annotations

import numpy as np

from .grating import Grating


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
    ``n_tio2`` and ``xyrra_list`` -- e.g. a ``metalens_tpu.Grating``."""
    return grating_from_arrays(g.lateral_period, g.grating_period,
                               g.cyl_height, g.n_glass, g.n_tio2,
                               np.asarray(g.xyrra_list))
