"""Vectorized geometry kernels for pillar layouts.

The reference does all of this with per-point Python loops
(``grating.py:537-580`` is O(n_ellipse^2 * 100^2) scalar arithmetic and is a
documented hot spot of ``optimize()``).  Everything here is array-at-once
NumPy so a full ``validate()`` is a handful of vectorized reductions, and the
same functions are reused inside differentiable constraint penalties.
(A copy of ``metalens_tpu/geometry.py``.)

An ``xyrra`` row is ``[x_center, y_center, semi_axis_x, semi_axis_y,
rotation_ccw]`` with lengths in SI metres and angles in radians (reference
``grating.py:94-99``).
"""

from __future__ import annotations

import numpy as np

pi = np.pi


def ellipse_pts(x_center, y_center, r_x, r_y, angle, num_points: int = 80):
    """(num_points, 2) array of points on one ellipse outline, CCW.

    Same parametrization as reference ``grating.py:666-682`` but vectorized;
    also broadcasts: if the five parameters are arrays of shape ``B`` the
    result is ``(B, num_points, 2)``.
    """
    theta = np.linspace(0.0, 2 * pi, num=num_points, endpoint=False)
    x_center, y_center, r_x, r_y, angle = np.broadcast_arrays(
        *(np.asarray(v, dtype=np.float64) for v in (x_center, y_center, r_x, r_y, angle))
    )
    dx0 = r_x[..., None] * np.cos(theta)
    dy0 = r_y[..., None] * np.sin(theta)
    ca, sa = np.cos(angle)[..., None], np.sin(angle)[..., None]
    x = x_center[..., None] + dx0 * ca - dy0 * sa
    y = y_center[..., None] + dx0 * sa + dy0 * ca
    return np.stack([x, y], axis=-1)


def ellipse_outlines(xyrra_list, num_points: int = 80):
    """(n_ellipse, num_points, 2) outline points for every row of xyrra_list."""
    a = np.asarray(xyrra_list, dtype=np.float64)
    return ellipse_pts(a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4], num_points=num_points)


def distance_mod(x0, x1, period):
    """Distance between points of a 1-D periodic structure (reference
    ``grating.py:518-520``), elementwise on arrays."""
    d = np.mod(np.asarray(x0) - np.asarray(x1), period)
    return np.minimum(d, period - d)


def sq_distance_mod(x0, y0, x1, y1, x_period, y_period):
    """Squared distance under the 2-D periodic metric (reference
    ``grating.py:512-516``), elementwise on arrays."""
    dx = distance_mod(x0, x1, x_period)
    dy = distance_mod(y0, y1, y_period)
    return dx * dx + dy * dy


def min_pairwise_outline_distance(xyrra_list, x_period, y_period,
                                  num_points: int = 100):
    """Minimum outline-to-outline distance between distinct pillars (under the
    periodic metric) and between each pillar and its own y-replica.

    Returns ``(min_between, min_self_replica)`` in metres.  This is the
    vectorized replacement for the reference's quadruple loops
    (``grating.py:549-580``): one (nE*P, nE*P) distance matrix instead of
    Python-level point pairs.
    """
    a = np.asarray(xyrra_list, dtype=np.float64)
    n = a.shape[0]
    pts = ellipse_outlines(a, num_points=num_points)      # (n, P, 2)
    flat = pts.reshape(n * num_points, 2)

    # self vs own periodic replica in the (smaller) y direction, direct metric
    # (reference grating.py:549-563 assumes shapes aren't near their own
    # x-replicas, same assumption kept here)
    shifted = pts + np.array([0.0, y_period])
    d2_self = ((pts[:, :, None, :] - shifted[:, None, :, :]) ** 2).sum(-1)
    min_self = float(np.sqrt(d2_self.min())) if n > 0 else np.inf

    if n < 2:
        return np.inf, min_self

    dx = distance_mod(flat[:, None, 0], flat[None, :, 0], x_period)
    dy = distance_mod(flat[:, None, 1], flat[None, :, 1], y_period)
    d2 = dx * dx + dy * dy
    # mask out same-ellipse blocks
    eid = np.repeat(np.arange(n), num_points)
    same = eid[:, None] == eid[None, :]
    d2 = np.where(same, np.inf, d2)
    return float(np.sqrt(d2.min())), min_self


def standardize_xyrra(xyrra_list, grating_period, lateral_period):
    """Wrap each pillar into the canonical periodic replica, in place
    (reference ``grating.py:332-342``)."""
    x = xyrra_list
    x[:, 0] %= grating_period
    x[x[:, 0] > grating_period / 2, 0] -= grating_period
    x[:, 1] %= lateral_period
    x[x[:, 1] > lateral_period / 2, 1] -= lateral_period
    x[:, 4] %= 2 * pi
    x[x[:, 4] > pi, 4] -= 2 * pi
    return x


def replica_xyrra(xyrra_list, grating_period, lateral_period, N: int = 0,
                  num_points: int = 120):
    """Expand to periodic replicas whose outline enters the +-(N+1/2)-cell
    window (reference ``grating.py:142-170``): N=0 gives every ellipse that
    sticks into the central unit cell."""
    out = []
    for x, y, rx, ry, a in np.asarray(xyrra_list, dtype=np.float64):
        for tx in range(-(N + 1), N + 2):
            for ty in range(-(N + 1), N + 2):
                xc = x + tx * grating_period
                yc = y + ty * lateral_period
                pts = ellipse_pts(xc, yc, rx, ry, a, num_points=num_points)
                inside = (np.abs(pts[:, 0]) < grating_period / 2 + N * grating_period) & (
                    np.abs(pts[:, 1]) < lateral_period / 2 + N * lateral_period)
                if inside.any():
                    out.append([xc, yc, rx, ry, a])
    return np.array(out) if out else np.zeros((0, 5))


def stretch_pattern(xyrra_list_start, x_scale, y_scale):
    """Scale a pattern anisotropically (reference ``grating.py:814-818``)."""
    xyrra_list = np.array(xyrra_list_start, dtype=np.float64, copy=True)
    xyrra_list[:, [0, 2]] *= x_scale
    xyrra_list[:, [1, 3]] *= y_scale
    return xyrra_list


def good_fft_number(goal) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= goal (reference
    ``nearfield.py:30-36``); such sizes keep the aperture FFT on the fast
    path."""
    assert goal < 1e9
    goal = max(1, int(np.ceil(goal)))
    best = None
    p5 = 1
    while p5 < goal * 2:
        p35 = p5
        while p35 < goal * 2:
            # smallest power of 2 lifting p35 above goal
            p = p35
            while p < goal:
                p *= 2
            if best is None or p < best:
                best = p
            p35 *= 3
        p5 *= 5
    return int(best)
