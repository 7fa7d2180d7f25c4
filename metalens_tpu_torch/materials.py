"""Material dispersion -- the single source of truth.

The reference keeps *three hand-synced copies* of the operational 9-wavelength
index tables (``grating.py:1274-1288``, ``grating.lua:70-93``,
``grating_lumerical.lsf:53-80``) plus the full measured curves in
``refractive_index.py``.  Here there is exactly one copy of each dataset, and
both the "exact operational table" lookup (used by the solver for bit-parity
with the reference workflow) and smooth interpolation over the full measured
curves are provided.

Conventions carried over from the reference:

* ``n_glass`` / ``n_tio2`` attribute value ``0`` on a scene object is a
  sentinel meaning "use tabulated dispersion" (reference ``grating.py:107``).
* The operational tables are keyed by wavelength rounded to the nearest nm and
  raise on a wavelength that is not tabulated (reference ``grating.py:1286``,
  ``grating.lua:150``), when ``strict=True``.  With ``strict=False`` the full
  measured curves are interpolated instead, removing the reference's
  "edit three files to add a wavelength" limitation.
"""

from __future__ import annotations

import numpy as np

from ._tio2_table import TIO2_WL_NM, TIO2_N, TIO2_K
from .units import nm

# Operational tables: index vs wavelength (nm).  These are the values the
# reference solver actually uses (reference ``grating.py:1277-1285`` /
# ``grating.lua:71-92``), derived from the measured curves below.
TIO2_TABLE_NM = {
    450: 2.5, 500: 2.433, 525: 2.41, 550: 2.391, 575: 2.375,
    580: 2.372, 600: 2.362, 625: 2.351, 650: 2.341,
}
# UV-grade fused silica (Thorlabs data; reference ``refractive_index.py:194-203``
# rounded to the 3 decimals used operationally, ``grating.py:1277-1285``).
SIO2_TABLE_NM = {
    450: 1.466, 500: 1.462, 525: 1.461, 550: 1.46, 575: 1.459,
    580: 1.459, 600: 1.458, 625: 1.457, 650: 1.457,
}
# Full-precision fused-silica points (reference ``refractive_index.py:194-203``).
SIO2_POINTS_NM = {
    450: 1.46554, 500: 1.462299, 525: 1.461009, 550: 1.459883,
    575: 1.458891, 580: 1.458706, 600: 1.458009, 625: 1.457219,
    650: 1.456506,
}

_TIO2_WL = np.asarray(TIO2_WL_NM, dtype=np.float64)
_TIO2_NCPLX = np.asarray(TIO2_N, dtype=np.float64) + 1j * np.asarray(TIO2_K, np.float64)
_SIO2_WL = np.asarray(sorted(SIO2_POINTS_NM), dtype=np.float64)
_SIO2_N = np.asarray([SIO2_POINTS_NM[int(w)] for w in _SIO2_WL])


def _wavelength_to_nm(wavelength) -> float:
    """Accept either a wavelength in SI units (< 1e-3, i.e. metres) or a bare
    number interpreted as nm (mirrors the reference's ``wavelength_in_nm``
    call sites)."""
    w = float(wavelength)
    if w < 1e-3:  # given in SI metres
        return w / nm
    return w


def n_tio2(wavelength, strict: bool = True) -> float:
    """Refractive index of ALD amorphous TiO2 pillars.

    ``strict=True`` reproduces the reference's operational table lookup
    (``grating.lua:149-152``): the wavelength (rounded to nm) must be one of
    the 9 tabulated visible wavelengths.  ``strict=False`` linearly
    interpolates the full 300-1700 nm measured curve
    (``refractive_index.py:178``) and may return a complex value below 380 nm
    where TiO2 absorbs.
    """
    w = _wavelength_to_nm(wavelength)
    if strict:
        key = int(round(w))
        if key not in TIO2_TABLE_NM:
            raise ValueError(
                f"wavelength {key} nm not in operational TiO2 table; "
                f"pass strict=False to interpolate measured dispersion"
            )
        return TIO2_TABLE_NM[key]
    if not (_TIO2_WL[0] <= w <= _TIO2_WL[-1]):
        raise ValueError(f"wavelength {w} nm outside measured TiO2 range")
    val = np.interp(w, _TIO2_WL, _TIO2_NCPLX.real) + 1j * np.interp(
        w, _TIO2_WL, _TIO2_NCPLX.imag
    )
    return val if val.imag != 0 else float(val.real)


def n_glass(wavelength, strict: bool = True) -> float:
    """Refractive index of the fused-silica substrate.

    ``strict=True`` is the reference's operational lookup
    (``grating.py:1274-1288``); ``strict=False`` interpolates the Thorlabs
    curve (``refractive_index.py:194-203``).
    """
    w = _wavelength_to_nm(wavelength)
    if strict:
        key = int(round(w))
        if key not in SIO2_TABLE_NM:
            raise ValueError(
                f"bad wavelength {key!r}: not in operational glass table; "
                f"pass strict=False to interpolate"
            )
        return SIO2_TABLE_NM[key]
    if not (_SIO2_WL[0] <= w <= _SIO2_WL[-1]):
        raise ValueError(f"wavelength {w} nm outside tabulated SiO2 range")
    return float(np.interp(w, _SIO2_WL, _SIO2_N))


def resolve_indices(n_glass_attr, n_tio2_attr, wavelength, strict: bool = True):
    """Resolve the (n_glass, n_tio2) pair for a scene object, honouring the
    0-means-tabulated sentinel (reference ``grating.lua:149-161``)."""
    ng = n_glass(wavelength, strict=strict) if n_glass_attr == 0 else n_glass_attr
    nt = n_tio2(wavelength, strict=strict) if n_tio2_attr == 0 else n_tio2_attr
    return ng, nt
