"""Reciprocal-lattice order selection and k-vector bookkeeping.

The reference delegates this to S4's ``SetNumG`` / ``GetDiffractionOrder``
(``grating.lua:115``, ``grating.lua:203``).  Here the truncation is explicit:
the ``numG`` reciprocal-lattice vectors of smallest |G| (circular truncation
on the rectangular lattice, deterministic tie-break) -- chosen *statically*
per (lattice, numG) so batched solves share one compiled program.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi


def select_orders(grating_period: float, lateral_period: float, numG: int):
    """Return an (numG, 2) int array of (mx, my) orders: the numG smallest-|G|
    reciprocal vectors of the rectangular lattice, sorted by
    (|G|^2, mx, my).  The (0, 0) order is always first."""
    gx = TWO_PI / grating_period
    gy = TWO_PI / lateral_period
    # box certainly containing the numG smallest-norm vectors
    r2 = numG * gx * gy / np.pi * 4.0 + (gx ** 2 + gy ** 2)
    mx_max = int(np.ceil(np.sqrt(r2) / gx)) + 1
    my_max = int(np.ceil(np.sqrt(r2) / gy)) + 1
    mx, my = np.meshgrid(np.arange(-mx_max, mx_max + 1),
                         np.arange(-my_max, my_max + 1), indexing="ij")
    mx, my = mx.ravel(), my.ravel()
    norm2 = (mx * gx) ** 2 + (my * gy) ** 2
    idx = np.lexsort((my, mx, norm2))
    assert len(idx) >= numG, "order candidate box too small"
    sel = idx[:numG]
    orders = np.stack([mx[sel], my[sel]], axis=1).astype(np.int32)
    assert tuple(orders[0]) == (0, 0)
    return orders


def order_index(orders, ox: int, oy: int) -> int:
    """Index of diffraction order (ox, oy) in the order list (the
    ``GetDiffractionOrder`` equivalent, reference ``grating.lua:203``)."""
    hits = np.nonzero((orders[:, 0] == ox) & (orders[:, 1] == oy))[0]
    if len(hits) != 1:
        raise ValueError(f"order ({ox},{oy}) not in truncated order set")
    return int(hits[0])

