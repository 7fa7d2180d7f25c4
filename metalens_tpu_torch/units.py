"""Units policy for metalens_tpu_torch (a copy of ``metalens_tpu/units.py``).

The reference uses the ``numericalunits`` package, which assigns *random* values
to units on import to smoke out unit bugs (reference ``grating.py:19-23``).
That is hostile to JIT caching and numerical reproducibility, so here the units
are plain SI floats: ``m = 1.0``, and every quantity is stored in SI.

API-compatible usage carries over verbatim::

    from metalens_tpu_torch.units import nm, um, degree
    Grating(lateral_period=320*nm, cyl_height=550*nm, ...)

The small set of physical constants mirrors what the reference pulls from
``numericalunits`` (``nu.c0``, ``nu.Z0``, ``nu.eps0``, ``nu.mu0``, ``nu.C``,
``nu.V`` -- see reference ``nearfield.py:213``, ``nearfield_farfield.py:183``).
"""

import math

# ----- length -----
m = 1.0
cm = 1e-2 * m
mm = 1e-3 * m
um = 1e-6 * m
nm = 1e-9 * m

# ----- time / frequency -----
s = 1.0
Hz = 1.0 / s

# ----- angles -----
pi = math.pi
degree = pi / 180.0

# ----- electromagnetic constants (SI) -----
c0 = 299792458.0 * m / s          # speed of light
mu0 = 4e-7 * pi                    # vacuum permeability [H/m]
eps0 = 1.0 / (mu0 * c0 ** 2)       # vacuum permittivity [F/m]
Z0 = mu0 * c0                      # impedance of free space [ohm]

# ----- charge / potential (for dipole moments etc.) -----
C = 1.0                            # coulomb
V = 1.0                            # volt
A = C / s                          # ampere
W = V * A                          # watt

inf = float("inf")
