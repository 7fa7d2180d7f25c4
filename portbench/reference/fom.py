"""The reference's figure of merit of deflector cells (the published scoring
of ``grating.lua:188-229``), on the plain RCWA of :mod:`.rcwa`.

Per term (wavelength, weight, target order, in phase) the cell is lit from
air at the design angle (sin theta = design wavelength / grating period; normal
incidence for a term of order 0) in
s and in p; the target order's transmitted amplitude is read in the y block
for s (sign flipped) and the x block for p.  An in-phase term scores
|Im a| Im a, another |a|^2, each over n_glass cos theta; the term is the
s/p mean and the FOM the weighted mean over terms.  Indices come from the
configuration's own tables.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rcwa
from .rcwa import FULL


def index(table: dict, lam: float) -> float:
    return float(table[str(int(round(lam * 1e9)))])


def fom(cfg, grating_period, rows, device="cpu", dtype=torch.float64,
        prec=FULL):
    """FOM (M,) numpy array of the cells ``rows`` (M, nE, 5) of one member
    (grating period ``grating_period``) at the configuration's terms and
    design numG, in ``dtype``'s complex precision."""
    Lx, Ly, h = grating_period, cfg["lateral_period"], cfg["cyl_height"]
    orders = rcwa.select_orders(Lx, Ly, cfg["design_numG"])
    N = len(orders)
    i0 = rcwa.order_index(orders, 0, 0)
    theta = math.asin(cfg["design_wavelength"] / Lx)
    xy = torch.as_tensor(np.asarray(rows), dtype=dtype, device=device)
    total, wsum = 0.0, 0.0
    for lam, weight, order, inphase in cfg["terms"]:
        th = theta if order != 0 else 0.0
        ux = math.sin(th)
        c = np.zeros((2 * N, 2))
        c[i0, 0], c[i0 + N, 0] = rcwa.incident_sp(ux, 0.0, "s")
        c[i0, 1], c[i0 + N, 1] = rcwa.incident_sp(ux, 0.0, "p")
        ng, nt = index(cfg["n_glass"], lam), index(cfg["n_tio2"], lam)
        af, _, _, _ = rcwa.cell_amplitudes(orders, xy, Lx, Ly, h, nt ** 2,
                                           ng ** 2, lam, ux, 0.0, c,
                                           nv=cfg["nv"], prec=prec)
        t = rcwa.order_index(orders, order, 0)
        a_s, a_p = -af[:, t, 0], af[:, t + N, 1]
        if inphase:
            s_s, s_p = a_s.imag.abs() * a_s.imag, a_p.imag.abs() * a_p.imag
        else:
            s_s, s_p = a_s.abs() ** 2, a_p.abs() ** 2
        total = total + weight * (s_s + s_p) / (2 * ng * math.cos(th))
        wsum += weight
    return (total / wsum).double().cpu().numpy()
