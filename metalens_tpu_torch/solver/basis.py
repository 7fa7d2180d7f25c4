"""Plane-wave polarization bases and field <-> amplitude relations.

Counterpart of ``metalens_tpu/solver/basis.py``, with its conventions (S4's
``GetAmplitudes`` layout ``c = [c_y (N orders); c_x (N orders)]``, time
convention e^{-i w t}, forward propagation e^{+i k z}):

* transverse H of a mode with amplitudes (c_y, c_x): (hx, hy) = (c_y, c_x),
* transverse E (kz and K's normalized by k0, medium index n):
    E_xpol = [ (Ky^2+Kz^2)/(n^2 Kz),  -Kx*Ky/(n^2 Kz) ]
    E_ypol = [  Kx*Ky/(n^2 Kz),     -(Kx^2+Kz^2)/(n^2 Kz) ]

Kx, Ky are real (..., N) tensors; every per-order block is a complex
(..., N) tensor.  A medium's ``eps`` is a python number or a complex
tensor (one medium per cell), its index ``n`` a python number or a complex
tensor.
"""

from __future__ import annotations

import torch

from .cpx import csqrt_posim


def kz_norm(Kx, Ky, eps, branch_eps: float = 1e-9) -> torch.Tensor:
    """Normalized kz = sqrt(eps - Kx^2 - Ky^2) on the Im >= 0 branch, for a
    medium eps (a python number, or a complex tensor that broadcasts
    against Kx, e.g. one medium per cell as a (B, 1) column);
    ``branch_eps`` nudges the cut so lossless evanescent orders land
    exactly on +i sqrt|.|."""
    e = eps if torch.is_tensor(eps) else complex(eps)
    arg_re = e.real - Kx * Kx - Ky * Ky
    arg_im = e.imag + torch.zeros_like(Kx) + branch_eps
    return csqrt_posim(torch.complex(arg_re, arg_im))


def we_blocks(Kx, Ky, Kz, n):
    """Diagonal blocks (A, B, C, D) of the E-from-amplitude map of forward
    modes in a uniform medium of index n: ex = A c_y + B c_x,
    ey = C c_y + D c_x."""
    n2Kz = n * n * Kz
    Kz2 = Kz * Kz
    A = torch.complex(Kx * Ky, torch.zeros_like(Kx)) / n2Kz
    B = (Kz2 + Ky * Ky) / n2Kz
    D = -A
    Cb = -(Kz2 + Kx * Kx) / n2Kz
    return A, B, Cb, D


def we_inv_blocks(Kx, Ky, Kz, n):
    """Blocks of the inverse map (amplitudes from transverse E)."""
    return block_inv(we_blocks(Kx, Ky, Kz, n))


def block_compose(b1, b2):
    A1, B1, C1, D1 = b1
    A2, B2, C2, D2 = b2
    return (A1 * A2 + B1 * C2, A1 * B2 + B1 * D2,
            C1 * A2 + D1 * C2, C1 * B2 + D1 * D2)


def block_inv(b):
    A, B, Cb, D = b
    det = A * D - B * Cb
    return D / det, -B / det, -Cb / det, A / det


def block_to_dense(b) -> torch.Tensor:
    """(..., 2N, 2N) dense form of a per-order 2x2 block operator."""
    A, B, Cb, D = (torch.diag_embed(x) for x in b)
    return torch.cat([torch.cat([A, B], dim=-1),
                      torch.cat([Cb, D], dim=-1)], dim=-2)


# ----- incident amplitude vectors -----

def incident_sp_amplitudes(ux, uy, pol):
    """Amplitude (c_y, c_x) pair (real tensors) of a unit-E s- or
    p-polarized incident plane wave in air traveling (ux, uy, +uz), with
    the exact-normal special case of S4's conventions."""
    kap2 = ux * ux + uy * uy
    kap = torch.sqrt(torch.clamp(kap2, min=1e-30))
    uz = torch.sqrt(torch.clamp(1.0 - kap2, min=0.0))
    normal = kap2 < 1e-18
    one, zero = torch.ones_like(kap2), torch.zeros_like(kap2)
    if pol == "s":
        hx = torch.where(normal, -one, -ux * uz / kap)
        hy = torch.where(normal, zero, -uy * uz / kap)
    elif pol == "p":
        hx = torch.where(normal, zero, -uy / kap)
        hy = torch.where(normal, one, ux / kap)
    else:
        raise ValueError(pol)
    return hx, hy   # = (c_y, c_x)


def sp_to_xy_coefficients(ux, uy):
    """The s/p -> x/y combination coefficients (x_p, x_s, y_p, y_s) of
    incoming light in air at (ux, uy) (real tensors, on their device);
    exactly-normal incidence takes the ux -> 0+ limit along +x,
    (1, 0, 0, -1), as :func:`incident_sp_amplitudes` does."""
    kap2 = ux * ux + uy * uy
    normal = kap2 < 1e-18
    one, zero = torch.ones_like(kap2), torch.zeros_like(kap2)
    kap = torch.sqrt(torch.where(normal, one, kap2))
    uz = torch.sqrt(torch.clamp(1.0 - kap2, min=0.0))
    x_p = torch.where(normal, one, ux / kap)
    x_s = torch.where(normal, zero, -uy / (uz * kap))
    y_p = torch.where(normal, zero, -uy / kap)
    y_s = torch.where(normal, -one, -ux / (uz * kap))
    return x_p, x_s, y_p, y_s


# ----- power -----

def order_powers(c, Kx, Ky, Kz, n):
    """z-directed power flux per order (..., N) carried by amplitudes c
    (..., 2N) of forward modes in a uniform medium of index n, in S4's
    unit-impedance units: Sz_i = Re(ex hy* - ey hx*)."""
    N = Kx.shape[-1]
    cy, cx = c[..., :N], c[..., N:]
    A, B, Cb, D = we_blocks(Kx, Ky, Kz, n)
    ex = A * cy + B * cx
    ey = Cb * cy + D * cx
    sz = ex * cx.conj() - ey * cy.conj()
    return sz.real


def backward_order_powers(c, Kx, Ky, Kz, n):
    """Power per order (positive = flowing toward -z) carried by amplitudes
    c of backward modes."""
    return -order_powers(c, Kx, Ky, -Kz, n)
