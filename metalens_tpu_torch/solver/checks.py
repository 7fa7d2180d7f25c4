"""Physics invariants of a cell S-matrix: power flux and Lorentz reciprocity.

Independent checks that hold for any correct solve, whatever its method:

* energy: the power carried into glass and back into air by the scattered
  amplitudes equals the incident power for lossless pillars and falls
  short of it, by the absorbed share, for lossy ones;
* Lorentz reciprocity: with the bilinear (unconjugated) flux form of each
  side, M = [[-diag(C), diag(A)], [diag(A), diag(B)]] from that medium's
  ``we_blocks`` (A, B, C, D), and Sigma the permutation sending order G to
  -G, the S-matrix S at (ux, uy) and S' at (-ux, -uy) satisfy

      M_a s21 = (Sig s21' Sig)^T M_a      M_g s12 = (Sig s12' Sig)^T M_g
      M_g s11 = (Sig s22' Sig)^T M_a      M_a s22 = (Sig s11' Sig)^T M_g

  for the full matrices, evanescent orders and absorbing pillars included
  (the derivation is in ``tests/test_reciprocity.py``).

Every function is torch on the device of its inputs and takes a leading
batch axis, so the same checks run on CPU complex128 and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import basis
from . import orders as ordmod

RECIPROCITY = ("s21", "s12", "s11", "s22")


def negation_closed_orders(grating_period, lateral_period, target_numG: int):
    """The smallest numG >= target whose order set is closed under G -> -G,
    that order set, and the negation permutation (numpy)."""
    for numG in range(target_numG, target_numG + 64):
        orders = ordmod.select_orders(grating_period, lateral_period, numG)
        index = {(int(mx), int(my)): i for i, (mx, my) in enumerate(orders)}
        if all((-mx, -my) in index for (mx, my) in index):
            perm = np.array([index[(-int(mx), -int(my))]
                             for mx, my in orders])
            return numG, orders, perm
    raise ValueError("no negation-closed order set near the target numG")


def flux_form(Kx, Ky, eps, n):
    """The symmetric bilinear form (..., 2N, 2N) pairing amplitudes at
    (ux, uy) with amplitudes at (-ux, -uy) in a uniform medium."""
    A, B, Cb, _ = basis.we_blocks(Kx, Ky, basis.kz_norm(Kx, Ky, eps), n)
    A, B, Cb = (torch.diag_embed(x) for x in (A, B, Cb))
    return torch.cat([torch.cat([-Cb, A], dim=-1),
                      torch.cat([A, B], dim=-1)], dim=-2)


def reciprocity_residuals(S, S_neg, perm, M_air, M_glass):
    """Relative residuals (B,) of the four reciprocity identities, keyed by
    the block of S they test; ``S_neg`` is the S-matrix at (-ux, -uy) (S
    itself at normal incidence), ``perm`` the negation permutation."""
    N = len(perm)
    p2 = torch.as_tensor(np.concatenate([perm, perm + N]),
                         device=S.s11.device)
    left = {"s21": M_air, "s12": M_glass, "s11": M_glass, "s22": M_air}
    right = {"s21": M_air, "s12": M_glass, "s11": M_air, "s22": M_glass}
    mate = {"s21": "s21", "s12": "s12", "s11": "s22", "s22": "s11"}
    out = {}
    for name in RECIPROCITY:
        mapped = getattr(S_neg, mate[name])[..., p2, :][..., :, p2]
        lhs = left[name] @ getattr(S, name)
        rhs = mapped.transpose(-2, -1) @ right[name]
        out[name] = (torch.linalg.matrix_norm(lhs - rhs)
                     / torch.linalg.matrix_norm(lhs))
    return out


def incident_vector(ux, uy, pol, i0: int, N: int):
    """(B, 2N) amplitudes of a unit-E s- or p-polarized plane wave from air
    at (ux, uy) ((B,) real tensors) in the zeroth order ``i0``."""
    cy, cx = basis.incident_sp_amplitudes(ux, uy, pol)
    c = torch.zeros(ux.shape + (2 * N,), dtype=ux.dtype, device=ux.device)
    c[..., i0] = cy
    c[..., i0 + N] = cx
    return c


def order_efficiencies(S, Kx, Ky, c, eps_glass, n_glass):
    """Per-order transmitted and reflected power fractions (B, N) of the
    incident amplitudes c (B, 2N) through the cell S-matrix."""
    c = c.to(S.s11.dtype)
    ampf = (S.s11 @ c[..., None])[..., 0]
    ampr = (S.s21 @ c[..., None])[..., 0]
    kz_a = basis.kz_norm(Kx, Ky, 1.0)
    p_in = basis.order_powers(c, Kx, Ky, kz_a, 1.0).sum(-1, keepdim=True)
    p_t = basis.order_powers(ampf, Kx, Ky,
                             basis.kz_norm(Kx, Ky, eps_glass), n_glass)
    p_r = basis.backward_order_powers(ampr, Kx, Ky, kz_a, 1.0)
    return p_t / p_in, p_r / p_in
