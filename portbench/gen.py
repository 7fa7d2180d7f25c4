"""The general generator of the cells' inputs: every draw comes from one
``numpy`` generator seeded by ``--seed``, so the same seed gives the same
inputs, and every seed gives the same sizes."""

from __future__ import annotations

import math

import numpy as np


def rng(seed: int) -> np.random.Generator:
    """The cell's generator; any whole number seeds it (taken mod 2^64)."""
    return np.random.default_rng(np.random.SeedSequence(int(seed) % 2 ** 64))


def noisy_rows(g: np.random.Generator, base, batch: int, noise: float):
    """(batch, nE, 5) copies of the pillar rows ``base`` (nE, 5: x, y, rx,
    ry, angle) with normal noise of standard deviation ``noise`` on the
    centres and semi-axes."""
    base = np.asarray(base, dtype=np.float64)
    out = np.repeat(base[None], batch, axis=0)
    out[..., :4] += g.normal(0.0, noise, size=out[..., :4].shape)
    return out


def round_brackets(cfg, perturb: float, g: np.random.Generator):
    """The configuration's periphery brackets, each the published
    round-lens collection of ``bracket_members`` two-pillar members (angles
    evenly over the bracket, lateral periods scaled by tan(angle)) with
    normal noise of ``perturb`` on the pillars: a list of {"lp_over_tan",
    "members": [(period, lateral period, rows (2, 5)), ...]}, members in
    the order of their angles."""
    lam0, lp = cfg["design_wavelength"], cfg["lateral_period"]
    n = cfg["bracket_members"]
    out = []
    for lo, hi in cfg["brackets_deg"]:
        angles = np.radians(np.linspace(lo, hi, n))
        lp_over_tan = lp / math.tan(angles[len(angles) // 2])
        members = []
        for ang in angles:
            gp = lam0 / math.sin(ang)
            f = (ang - angles[0]) / (angles[-1] - angles[0] + 1e-12)
            base = np.array([[-gp / 4, 0.0, (90 + 5 * f) * 1e-9, 70e-9, 0.0],
                             [gp / 4, 0.0, 70e-9, (80 + 5 * f) * 1e-9, 0.0]])
            members.append((gp, lp_over_tan * math.tan(ang),
                            noisy_rows(g, base, 1, perturb)[0]))
        out.append({"lp_over_tan": lp_over_tan, "members": members})
    return out


def uniform(g: np.random.Generator, span, n: int):
    lo, hi = span
    return g.uniform(lo, hi, size=n)


def child_seeds(g: np.random.Generator, n: int):
    """n seeds for the program's own draws, below 2^62."""
    return [int(s) for s in g.integers(0, 2 ** 62, size=n)]


class Reservoir:
    """A uniform sample of ``k`` of the items offered (algorithm R), drawn
    from ``g``: the items the check compares, whatever the window's
    length."""

    def __init__(self, g: np.random.Generator, k: int):
        self.g, self.k = g, k
        self.items, self.seen = [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.g.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item
