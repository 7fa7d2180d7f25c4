"""Plain lens check of a round metalens: the benchmark's reference of the
lens cell.

Plain PyTorch and NumPy, written for this benchmark and importing nothing of
the program under test.  It follows the published design
(sbyrnes321/metalens ``design_collimator.py``, ``nearfield.py``,
``nearfield_farfield.py``):

* each member's amplitude database: the forward amplitudes of every order
  that propagates in air (|ox|, |oy| <= 5) at each direction of the member's
  sweep, from :mod:`portbench.reference.rcwa`;
* the layout: Fresnel-zone rings between the 2 pi wraps of the collimating
  phase, each bound to the bracket holding its centre's angle, copied round
  the circle; the centre's hexagonal sites, each given the member whose
  normal-incidence amplitude best matches the phase there; every pillar;
* the near field on the aperture grid: each point's ring and copy (or
  nearest centre site), the dipole's direction and fields there, the cell's
  amplitudes interpolated multilinearly over (ux, uy, period) (clamped,
  period axis padded 1% with the edge members), and the transmitted orders'
  plane waves summed with the air path's phase;
* the far field by the surface-equivalence transform (Taflove 8.15-8.25) of
  a 2-D FFT, the empty-aperture calibration x2, and the focal metrics.

Every function runs in the dtype of the fields it is given (float64 ->
complex128); the point classification and the source planes are float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rcwa

C0 = 299792458.0
Z0 = 4e-7 * math.pi * C0
TWO_PI = 2.0 * math.pi
MAX_ORDER = 5             # the databases keep |ox|, |oy| <= 5


def exact(x):
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x with each real component rounded to bfloat16 (8 mantissa bits):
    the operands of the control's stitch, one precision step below the
    program's float32."""
    if x.is_complex():
        return torch.complex(bf16(x.real), bf16(x.imag))
    return x.to(torch.bfloat16).to(x.dtype)


def key(u: float) -> int:
    """A direction cosine as a whole number of 1e-9, to match sweeps."""
    return int(round(u * 1e9))


# ----- databases -----

def grid_directions(ux_lo, ux_hi, uy_lo, uy_hi, steps):
    """The sweep's (ux, uy) directions, ux-major, inside the unit circle."""
    ux = np.linspace(ux_lo, ux_hi, steps)
    uy = np.linspace(uy_lo, uy_hi, steps)
    UX, UY = np.meshgrid(ux, uy, indexing="ij")
    UX, UY = UX.ravel(), UY.ravel()
    inside = UX ** 2 + UY ** 2 < 1.0
    return UX[inside], UY[inside]


def member_database(xyrra, Lx, Ly, h, eps_p, eps_g, lam, ux, uy, numG,
                    nv=True, prec=rcwa.FULL, dtype=torch.float64,
                    device="cpu", block=64):
    """One member's database: {(ux key, uy key, ox, oy, pol): (ampfy,
    ampfx)}, pol "x" or "y" the incident polarization, over the orders that
    propagate in air with |ox|, |oy| <= 5."""
    orders = rcwa.select_orders(Lx, Ly, numG)
    N = len(orders)
    i0 = rcwa.order_index(orders, 0, 0)
    c = np.zeros((2 * N, 2))
    c[i0, 0] = c[i0 + N, 1] = 1.0
    D = len(ux)
    xy = torch.as_tensor(np.asarray(xyrra), dtype=dtype,
                         device=device)[None].expand(D, -1, -1)
    amps = []
    for s in range(0, D, block):
        sl = slice(s, s + block)
        af, _, _, _ = rcwa.cell_amplitudes(
            orders, xy[sl], Lx, Ly, h, eps_p, eps_g, lam,
            torch.as_tensor(ux[sl], dtype=dtype, device=device),
            torch.as_tensor(uy[sl], dtype=dtype, device=device), c, nv=nv,
            prec=prec)
        amps.append(af.cpu().numpy())
    amp = np.concatenate(amps)                 # (D, 2N, pol: y, x)
    mx, my = orders[:, 0].astype(float), orders[:, 1].astype(float)
    Kx = ux[:, None] + mx[None, :] * lam / Lx
    Ky = uy[:, None] + my[None, :] * lam / Ly
    keep = ((Kx ** 2 + Ky ** 2) < 1.0) & (np.abs(orders[:, 0]) <= MAX_ORDER) \
        & (np.abs(orders[:, 1]) <= MAX_ORDER)
    db = {}
    for d, i in zip(*np.nonzero(keep)):
        for p, pol in enumerate(("y", "x")):
            db[(key(ux[d]), key(uy[d]), int(orders[i, 0]),
                int(orders[i, 1]), pol)] = (complex(amp[d, i, p]),
                                            complex(amp[d, i + N, p]))
    return db


def database_gap(got: dict, want: dict) -> float:
    """The widest amplitude gap of database ``got`` against ``want``; an
    entry that one has and the other lacks is an infinite gap."""
    if set(got) != set(want):
        return float("inf")
    worst = 0.0
    for k, (fy, fx) in want.items():
        gy, gx = got[k]
        worst = max(worst, abs(gy - fy), abs(gx - fx))
    return worst if worst == worst else float("inf")


def tabulate(dbs, pad_periods=None):
    """Complex table (orders, pol x|y, kind fy|fx, ux, uy, member) of the
    databases ``dbs`` (one per member), its axes and its order list; with
    ``pad_periods`` (the members' periods) the member axis is the period,
    padded by 1% at both ends with the edge members' values."""
    uxs = sorted({k[0] for db in dbs for k in db})
    uys = sorted({k[1] for db in dbs for k in db})
    orders = sorted({(k[2], k[3]) for db in dbs for k in db})
    T = np.zeros((len(orders), 2, 2, len(uxs), len(uys), len(dbs)),
                 dtype=complex)
    oi = {o: i for i, o in enumerate(orders)}
    xi = {u: i for i, u in enumerate(uxs)}
    yi = {u: i for i, u in enumerate(uys)}
    for m, db in enumerate(dbs):
        for (kx, ky, ox, oy, pol), (fy, fx) in db.items():
            p = 0 if pol == "x" else 1
            T[oi[(ox, oy)], p, :, xi[kx], yi[ky], m] = (fy, fx)
    if pad_periods is None:
        third = np.arange(len(dbs), dtype=float)
    else:
        T = np.concatenate([T[..., :1], T, T[..., -1:]], axis=-1)
        third = np.concatenate([[0.99 * min(pad_periods)], pad_periods,
                                [1.01 * max(pad_periods)]])
    axes = (np.array(uxs) * 1e-9, np.array(uys) * 1e-9, third)
    return T, axes, orders


class Table:
    """Clamped multilinear interpolation of a complex table over three
    axes, on ``device`` in ``cdt``."""

    def __init__(self, T, axes, orders, device, cdt):
        self.values = torch.as_tensor(T).to(device=device, dtype=cdt)
        self.axes = [torch.as_tensor(a, dtype=torch.float64, device=device)
                     for a in axes]
        self.orders = orders

    def weights(self, q):
        """Per-axis (lower index, weight of the upper) of points ``q``, a
        list of three float64 tensors."""
        out = []
        for a, x in zip(self.axes, q):
            if len(a) == 1:
                out.append((torch.zeros_like(x, dtype=torch.long),
                             torch.zeros_like(x)))
                continue
            i = torch.clamp(torch.searchsorted(a, x, right=True) - 1, 0,
                            len(a) - 2)
            w = torch.clamp((x - a[i]) / (a[i + 1] - a[i]), 0.0, 1.0)
            out.append((i, w))
        return out

    def at(self, o, wts):
        """(pol, kind, M) amplitudes of order index ``o`` at the points of
        ``wts``."""
        v = self.values[o]
        rdt = v.real.dtype
        out = 0
        for corner in range(8):
            idx, w = [], 1.0
            for ax in range(3):
                i, f = wts[ax]
                hi = (corner >> ax) & 1
                n = self.values.shape[3 + ax]
                if n == 1 and hi:
                    w = w * 0.0
                    idx.append(i)
                    continue
                idx.append(i + hi if n > 1 else i)
                w = w * (f if hi else 1.0 - f)
            out = out + v[:, :, idx[0], idx[1], idx[2]] * w.to(rdt)
        return out


# ----- layout -----

def target_phase(r, d, lam):
    k = TWO_PI / lam
    return np.mod(-k * (np.sqrt(d * d + np.asarray(r) ** 2) - d), TWO_PI)


def rings(brackets_rad, lateral_over_tan, d, radius, lam):
    """The periphery's rings: dict of arrays r_min, r_max, r_center,
    period, bracket and copies round the circle.  Ring edges are the 2 pi
    wraps of the collimating phase beyond the first bracket's inner angle,
    up to the first ring whose outer edge passes ``radius``."""
    edges, m = [], 0
    while not edges or edges[-1] < radius + 2e-6:
        edges.append(math.sqrt((m * lam + d) ** 2 - d * d))
        m += 1
    edges = np.array([e for e in edges
                      if e > d * math.tan(brackets_rad[0][0])])
    inner, outer = edges[:-1], edges[1:]
    n = 1 + int(np.nonzero(outer > radius)[0][0])
    inner, outer = inner[:n], outer[:n]
    r_center = (inner + outer) / 2
    angle = np.arctan2(r_center, d)
    bracket = np.array([next(b for b, (_, hi) in enumerate(brackets_rad)
                             if hi >= a) for a in angle])
    copies = np.array([int(round(TWO_PI * d / lateral_over_tan[b]))
                       for b in bracket])
    return {"r_min": inner, "r_max": outer, "r_center": r_center,
            "period": outer - inner, "bracket": bracket, "copies": copies}


def hex_sites(sep, R):
    """(keys (n, 2), xy (n, 2)): lattice indices (n1, n2) and positions
    x = sep n2 sqrt(3) / 2, y = sep (n1 + n2 / 2) of the hexagonal sites
    strictly inside radius R, ordered by (n1, n2)."""
    n2_max = int(R / (sep * math.sqrt(3) / 2)) + 1
    keys, xy = [], []
    for n2 in range(-n2_max, n2_max + 1):
        x = sep * n2 * math.sqrt(3) / 2
        lo = int(math.floor(-R / sep - n2 / 2)) - 1
        hi = int(math.ceil(R / sep - n2 / 2)) + 1
        for n1 in range(lo, hi + 1):
            y = sep * (n1 + n2 / 2)
            if x * x + y * y < R * R:
                keys.append((n1, n2))
                xy.append((x, y))
    keys, xy = np.array(keys).reshape(-1, 2), np.array(xy).reshape(-1, 2)
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    return keys[order], xy[order]


def site_scores(xy, x_amp, d, lam):
    """(n, members) scores Im(x_amp_k e^{-i phi}) of each site, phi the
    collimating phase at the site plus pi."""
    phi = target_phase(np.hypot(xy[:, 0], xy[:, 1]), d, lam) + math.pi
    return (np.asarray(x_amp)[None, :] * np.exp(-1j * phi)[:, None]).imag


def blend_member(periods, rows, period):
    """A collection's pillars at ``period``: the members' linear blend
    between the neighbouring periods, the edge member within 1% beyond."""
    if period < periods[0] * 0.99 or period > periods[-1] * 1.01:
        raise ValueError("period outside the collection")
    if period >= periods[-1]:
        return rows[-1].copy()
    if period <= periods[0]:
        return rows[0].copy()
    i = int(np.searchsorted(periods, period))
    if periods[i] == period:
        return rows[i].copy()
    p0, p1 = periods[i - 1], periods[i]
    return ((p1 - period) * rows[i - 1] + (period - p0) * rows[i]) \
        / (p1 - p0)


def periphery_pillars(ring, periods, rows):
    """Every periphery pillar, ring by ring, copy by copy.  ``periods`` and
    ``rows`` give each bracket's member periods (ascending) and pillar
    rows."""
    out = []
    for i in range(len(ring["period"])):
        b = ring["bracket"][i]
        gp = ring["period"][i]
        here = blend_member(periods[b], rows[b], gp)
        if i and ring["bracket"][i - 1] == b:
            prev = blend_member(periods[b], rows[b], ring["period"][i - 1])
            for j in range(len(here)):
                if prev[j, 0] > 0.8 * gp and here[j, 0] < 0.2 * gp:
                    here = np.delete(here, j, axis=0)
                    break
                if prev[j, 0] < 0.2 * gp and here[j, 0] > 0.8 * gp:
                    here = np.vstack([here, prev[j]])
                    break
        for a in np.linspace(0, TWO_PI, ring["copies"][i], endpoint=False):
            x = here[:, 0] + ring["r_center"][i]
            y = here[:, 1]
            out.append(np.stack([x * math.cos(a) - y * math.sin(a),
                                 x * math.sin(a) + y * math.cos(a),
                                 here[:, 2], here[:, 3], here[:, 4] + a], 1))
    return np.concatenate(out) if out else np.zeros((0, 5))


# ----- near field -----

def _nearest_site(X, Y, keys, xy, sep):
    """Row in ``keys`` of the nearest site of each point (X, Y)."""
    dev = X.device
    k = np.asarray(keys)
    n1_0, n2_0 = k[:, 0].min() - 3, k[:, 1].min() - 3
    grid = -np.ones((k[:, 0].max() - n1_0 + 4, k[:, 1].max() - n2_0 + 4),
                    dtype=np.int64)
    grid[k[:, 0] - n1_0, k[:, 1] - n2_0] = np.arange(len(k))
    grid = torch.as_tensor(grid, device=dev)
    sxy = torch.as_tensor(xy, dtype=torch.float64, device=dev)
    n2f = 2 * X / (sep * math.sqrt(3))
    n1f = Y / sep - n2f / 2
    b1, b2 = torch.round(n1f).long(), torch.round(n2f).long()
    best = torch.full_like(X, float("inf"))
    row = torch.zeros(X.shape, dtype=torch.long, device=dev)
    for d1 in range(-2, 3):
        for d2 in range(-2, 3):
            i1 = (b1 + d1 - n1_0).clamp(0, grid.shape[0] - 1)
            i2 = (b2 + d2 - n2_0).clamp(0, grid.shape[1] - 1)
            r = grid[i1, i2]
            ok = (r >= 0) & (i1 == b1 + d1 - n1_0) & (i2 == b2 + d2 - n2_0)
            rr = r.clamp(min=0)
            d2_ = (X - sxy[rr, 0]) ** 2 + (Y - sxy[rr, 1]) ** 2
            d2_ = torch.where(ok, d2_, float("inf"))
            take = d2_ < best
            best = torch.where(take, d2_, best)
            row = torch.where(take, rr, row)
    lost = torch.nonzero(~torch.isfinite(best)).ravel()
    for s in range(0, len(lost), 256):       # no site near: search them all
        j = lost[s:s + 256]
        dd = (X[j, None] - sxy[None, :, 0]) ** 2 \
            + (Y[j, None] - sxy[None, :, 1]) ** 2
        row[j] = torch.argmin(dd, dim=1)
    return row


def _add_orders(table, q, ux, uy, invLx, invLy, xr, yr, kvac,
                kg, ng, wx, wy, F, rnd=exact):
    """Add the transmitted orders of ``table`` at the points to the fields
    F = [Ex, Ey, Hx, Hy] (each (M,)): (ux, uy) the incidence, (xr, yr) the
    offset from the cell's centre, (wx, wy) the weights of the 'x' and 'y'
    polarized simulations (the incident H along y and x).  ``rnd`` rounds
    the operands of every product."""
    cdt = F[0].dtype
    rdt = F[0].real.dtype
    wts = table.weights(q)
    for o, (ox, oy) in enumerate(table.orders):
        kx = kvac * ux + ox * invLx
        ky = kvac * uy + oy * invLy
        on = (kx * kx + ky * ky <= kvac * kvac)
        kz = torch.sqrt(torch.clamp(kg * kg - kx * kx - ky * ky,
                                    min=1e-12 * kvac * kvac))
        ph = rnd(torch.polar(on.to(kx.dtype), kx * xr + ky * yr).to(cdt))
        a = rnd(table.at(o, wts))            # (pol x|y, kind fy|fx, M)
        den = kg * kz * ng
        cx_fy, cy_fy = kx * ky / den, -(kx * kx + kz * kz) / den
        cx_fx, cy_fx = (ky * ky + kz * kz) / den, -(kx * ky) / den
        for p, w in ((0, wx), (1, wy)):
            fy = rnd(a[p, 0] * ph)
            fx = rnd(a[p, 1] * ph)
            e = (w * Z0)
            F[0] += fy * rnd((e * cx_fy).to(rdt)) \
                + fx * rnd((e * cx_fx).to(rdt))
            F[1] += fy * rnd((e * cy_fy).to(rdt)) \
                + fx * rnd((e * cy_fx).to(rdt))
            F[2] += fy * rnd(w.to(rdt))
            F[3] += fx * rnd(w.to(rdt))


def near_field(pts, lam, d, n_glass, ring, ring_tables, site_keys, site_xy,
               site_member, hex_table, hex_periods, dipole_moment,
               cdt=torch.complex128, device="cpu", rnd=exact):
    """(Ex, Ey, Hx, Hy) on the grid pts x pts (ij order) and the power the
    lens passes, for an 'x' dipole at (0, 0, -d).  ``ring_tables`` holds
    one :class:`Table` per bracket; ``site_keys`` (n1, n2), ``site_xy`` and
    ``site_member`` (n,) the centre's sites and their members;
    ``hex_periods`` the hex cell's (x, y) periods; ``rnd`` rounds the
    operands of every product."""
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    p = torch.as_tensor(np.asarray(pts), **f64)
    X, Y = torch.meshgrid(p, p, indexing="ij")
    X, Y = X.reshape(-1), Y.reshape(-1)
    kvac = TWO_PI / lam
    kg = kvac * n_glass
    r = torch.sqrt(X * X + Y * Y)
    dist = torch.sqrt(X * X + Y * Y + d * d)
    ux, uy, uz = X / dist, Y / dist, d / dist
    s = C0 * kvac ** 2 * dipole_moment / (4 * math.pi) * torch.sqrt(uz) \
        / dist
    Hx, Hy, Hz = torch.zeros_like(X), uz * s, -uy * s
    Ex, Ey = (Hy * uz - Hz * uy) * Z0, (Hz * ux - Hx * uz) * Z0
    edges = torch.as_tensor(np.append(ring["r_min"], ring["r_max"][-1]),
                            **f64)
    k = torch.searchsorted(edges, r) - 1
    centre = k == -1
    periph = (k >= 0) & (k < len(ring["period"]))
    power = float(((Ex * Hy - Ey * Hx) * (centre | periph)).sum()
                  * (pts[1] - pts[0]) ** 2)
    F = [torch.zeros(X.shape, dtype=cdt, device=dev) for _ in range(4)]

    def tab(a, dt=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    for b, table in enumerate(ring_tables):
        j = torch.nonzero(periph & (tab(ring["bracket"], torch.long)[
            k.clamp(0, len(ring["period"]) - 1)] == b)).ravel()
        if not len(j):
            continue
        kk = k[j]
        step = TWO_PI / tab(ring["copies"])[kk]
        rot = torch.round(torch.atan2(Y[j], X[j]) / step) * step
        c, sn = torch.cos(rot), torch.sin(rot)
        rc = tab(ring["r_center"])[kk]
        gp = tab(ring["period"])[kk]
        uxp = ux[j] * c + uy[j] * sn
        uyp = -ux[j] * sn + uy[j] * c
        xp = X[j] * c + Y[j] * sn - rc
        yp = -X[j] * sn + Y[j] * c
        hxp = Hx[j] * c + Hy[j] * sn
        hyp = -Hx[j] * sn + Hy[j] * c
        G = [torch.zeros(len(j), dtype=cdt, device=dev) for _ in range(4)]
        _add_orders(table, (uxp, uyp, gp), uxp, uyp, TWO_PI / gp,
                    TWO_PI / (rc * step), xp, yp, kvac, kg, n_glass, hyp,
                    hxp, G, rnd)
        air = torch.sqrt((rc * c) ** 2 + (rc * sn) ** 2 + d * d)
        ph = rnd(torch.polar(torch.ones_like(air), kvac * air).to(cdt))
        G = [rnd(g) * ph for g in G]
        rdt = G[0].real.dtype
        c, sn = rnd(c.to(rdt)), rnd(sn.to(rdt))
        G = [rnd(g) for g in G]
        F[0][j] += G[0] * c - G[1] * sn
        F[1][j] += G[0] * sn + G[1] * c
        F[2][j] += G[2] * c - G[3] * sn
        F[3][j] += G[2] * sn + G[3] * c
    j = torch.nonzero(centre).ravel()
    if len(j) and len(site_keys):
        row = _nearest_site(X[j], Y[j], site_keys, site_xy, hex_periods[1])
        member = tab(site_member)[row]
        cx, cy = tab(site_xy[:, 0])[row], tab(site_xy[:, 1])[row]
        G = [torch.zeros(len(j), dtype=cdt, device=dev) for _ in range(4)]
        _add_orders(hex_table, (ux[j], uy[j], member), ux[j], uy[j],
                    TWO_PI / hex_periods[0], TWO_PI / hex_periods[1],
                    X[j] - cx, Y[j] - cy, kvac, kg, n_glass, Hy[j], Hx[j], G,
                    rnd)
        air = torch.sqrt(cx * cx + cy * cy + d * d)
        ph = rnd(torch.polar(torch.ones_like(air), kvac * air).to(cdt))
        for i in range(4):
            F[i][j] += rnd(G[i]) * ph
    n = len(pts)
    return [f.reshape(n, n) for f in F], power


# ----- far field -----

def far_field(fields, pts, lam, n_glass):
    """(P, ok, total, u, du): the angular power density P(ux, uy) r^2 / uz
    on the fftshifted bins (0 where the bin does not propagate, ``ok``
    where it does), its total, the bins' direction cosines in glass and
    their step."""
    Ex, Ey, Hx, Hy = (torch.fft.fft2(torch.fft.fftshift(f)) for f in fields)
    n = len(pts)
    dx = float(pts[1] - pts[0])
    dA = dx * dx
    rdt = Ex.real.dtype
    dev = Ex.device
    u = np.fft.fftfreq(n) * (lam / n_glass) / dx
    U = torch.as_tensor(u, dtype=torch.float64, device=dev)
    ux, uy = U[:, None], U[None, :]
    uz2 = 1.0 - ux * ux - uy * uy
    ok = uz2 > 0
    uz = torch.sqrt(torch.clamp(uz2, min=1e-300))
    st = torch.sqrt(ux * ux + uy * uy)
    axis = st == 0
    st1 = torch.where(axis, 1.0, st)
    ct_c = torch.where(axis, 1.0, ux * uz / st1).to(rdt)   # theta . x
    ct_s = torch.where(axis, 0.0, uy * uz / st1).to(rdt)   # theta . y
    cp_c = torch.where(axis, 1.0, ux / st1).to(rdt)
    cp_s = torch.where(axis, 0.0, uy / st1).to(rdt)
    Nx, Ny = -dA * Hy, dA * Hx
    Lx, Ly = dA * Ey, -dA * Ex
    Nt, Np = Nx * ct_c + Ny * ct_s, -Nx * cp_s + Ny * cp_c
    Lt, Lp = Lx * ct_c + Ly * ct_s, -Lx * cp_s + Ly * cp_c
    Z = Z0 / n_glass
    k = TWO_PI * n_glass / lam
    P = 2 * k * k / (32 * math.pi ** 2 * Z) * (
        (Lp + Z * Nt).abs() ** 2 + (Lt - Z * Np).abs() ** 2) / uz.to(rdt)
    P = torch.fft.fftshift(torch.where(ok, P, 0.0))
    us = np.fft.fftshift(u)
    du = float(us[1] - us[0])
    total = float(P.sum()) * du * du
    return P, torch.fft.fftshift(ok), total, us, du


def focal(P, total, us, du, power, spot_u):
    """Peak direction, transmission (total over the power the lens passes)
    and the share of the total within ``spot_u`` of the peak."""
    i, j = np.unravel_index(int(torch.argmax(P)), tuple(P.shape))
    U = torch.as_tensor(us, dtype=torch.float64, device=P.device)
    near = (U[:, None] - us[i]) ** 2 + (U[None, :] - us[j]) ** 2 \
        <= spot_u ** 2
    spot = float((P * near).sum()) * du * du
    return {"peak_ux": float(us[i]), "peak_uy": float(us[j]),
            "transmission": total / power,
            "spot_fraction": spot / total}
