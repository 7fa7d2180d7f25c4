"""Real-space field reconstruction from diffraction amplitudes.

The executable form of the reference's ``S4conventions.E_from_amplitudes``
(``S4conventions.py:204-290``) and the Lua ``print_fields`` diagnostic
(``grating.lua:352-363``): given a characterize database entry set for one
incidence direction, reconstruct E and H at arbitrary points above
(reflected + incident, z < 0) or below (transmitted, z > cyl_height) the
pillar layer.  Used for debugging phase conventions and for visual field
maps; :func:`metalens_tpu_torch.nearfield.build_nearfield` uses the same
formulas in vectorized form.  The port's copy of
``metalens_tpu/solver/fields.py``: numpy, on the port's materials tables.

z is measured from the air-pillar interface (z = 0), matching S4: reflected
amplitudes are referenced at z = 0, transmitted at z = cyl_height.
"""

from __future__ import annotations

import numpy as np

from ..units import pi
from ..materials import resolve_indices


def _xy_vectors(kx, ky, kz, n):
    """Full 3-vector x/y basis fields (reference S4conventions.py:70-103)."""
    k = n  # normalized units: |k| = n (k's passed normalized by k0)
    H_xpol = np.array([0.0, 1.0, -ky / kz])
    E_xpol = np.array([(ky ** 2 + kz ** 2) / (k * kz * n),
                       -kx * ky / (k * kz * n), -kx / (k * n)])
    H_ypol = np.array([1.0, 0.0, -kx / kz])
    E_ypol = np.array([kx * ky / (k * kz * n),
                       (-kx ** 2 - kz ** 2) / (k * kz * n), ky / (k * n)])
    return E_xpol, E_ypol, H_xpol, H_ypol


def fields_from_data(grating, data, x, y, z, x_or_y="x", wavelength=None,
                     include_incident=True):
    """(E, H) 3-vectors at point (x, y, z) reconstructed from the
    characterize database ``data`` (one incidence direction, one incident
    polarization ``x_or_y``).

    For z > cyl_height: sum of transmitted orders in glass.  For z < 0: sum
    of reflected orders in air, plus the incident x/y-basis wave if
    ``include_incident``.  Points inside the pillar layer are not supported
    (the amplitude database does not carry the near-zone modal fields).
    """
    entries = [e for e in data if e["x_or_y"] == x_or_y]
    assert entries, "no entries for this polarization"
    wl_nm = {round(e["wavelength_in_nm"]) for e in entries}
    if wavelength is None:
        assert len(wl_nm) == 1, "specify wavelength for multi-lambda data"
        wavelength = wl_nm.pop() * 1e-9
    else:
        entries = [e for e in entries
                   if round(e["wavelength_in_nm"]) == round(wavelength / 1e-9)]
        assert entries, (
            f"no entries at wavelength {round(wavelength / 1e-9)} nm "
            f"(database has {sorted(wl_nm)} nm)")
    uxs = {e["ux"] for e in entries}
    uys = {e["uy"] for e in entries}
    assert len(uxs) == 1 and len(uys) == 1, (
        "pass data filtered to a single incidence direction")
    ux, uy = uxs.pop(), uys.pop()

    ng, _ = resolve_indices(grating.n_glass, grating.n_tio2, wavelength)
    ng = float(np.real(ng))
    k0 = 2 * pi / wavelength
    if 0 < z < grating.cyl_height:
        raise ValueError(
            "point is inside the pillar layer (0 < z < cyl_height): the "
            "amplitude database does not carry the near-zone modal fields "
            "(the reference asserts the same, S4conventions.py "
            "E_from_amplitudes)")
    transmitted = z > 0
    z_ref = z - grating.cyl_height if transmitted else z
    n_med = ng if transmitted else 1.0

    E = np.zeros(3, complex)
    H = np.zeros(3, complex)
    for e in entries:
        Kx = ux + e["ox"] * wavelength / grating.grating_period
        Ky = uy + e["oy"] * wavelength / grating.lateral_period
        Kz2 = n_med ** 2 - Kx ** 2 - Ky ** 2
        if Kz2 <= 0:
            continue  # evanescent in this medium at this plane
        Kz = np.sqrt(Kz2) * (1.0 if transmitted else -1.0)
        E_x, E_y, H_x, H_y = _xy_vectors(Kx, Ky, Kz, n_med)
        a_y = e["ampfy"] if transmitted else e["ampry"]
        a_x = e["ampfx"] if transmitted else e["amprx"]
        phase = np.exp(1j * k0 * (Kx * x + Ky * y + Kz * z_ref))
        E = E + (a_y * E_y + a_x * E_x) * phase
        H = H + (a_y * H_y + a_x * H_x) * phase

    if include_incident and not transmitted:
        Kz = np.sqrt(1.0 - ux ** 2 - uy ** 2)
        E_x, E_y, H_x, H_y = _xy_vectors(ux, uy, Kz, 1.0)
        amp = {"x": (0.0, 1.0), "y": (1.0, 0.0)}[x_or_y]
        phase = np.exp(1j * k0 * (ux * x + uy * y + Kz * z))
        E = E + (amp[0] * E_y + amp[1] * E_x) * phase
        H = H + (amp[0] * H_y + amp[1] * H_x) * phase
    return E, H


def field_map(grating, data, z, x_or_y="x", n_points=40, wavelength=None):
    """E, H sampled over one unit cell at height z (the ``print_fields``
    analog).  Returns (E[nx, ny, 3], H[nx, ny, 3], xs, ys)."""
    xs = np.linspace(-grating.grating_period / 2, grating.grating_period / 2,
                     n_points, endpoint=False)
    ys = np.linspace(-grating.lateral_period / 2, grating.lateral_period / 2,
                     n_points, endpoint=False)
    E = np.zeros((n_points, n_points, 3), complex)
    H = np.zeros((n_points, n_points, 3), complex)
    for i, x in enumerate(xs):
        for j, y in enumerate(ys):
            E[i, j], H[i, j] = fields_from_data(grating, data, x, y, z,
                                                x_or_y, wavelength)
    return E, H, xs, ys
