"""What the cells' checks share."""

from __future__ import annotations

import torch


def propagating(Kx, Ky, eps, min_kz):
    """(B, 2N) mask of the orders that propagate in the medium eps with
    normalized |kz| >= min_kz, for both polarization blocks."""
    m = (eps - Kx * Kx - Ky * Ky) >= min_kz ** 2
    return torch.cat([m, m], dim=-1)
