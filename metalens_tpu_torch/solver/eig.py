"""Eigenmode reference solver: the independent check of the eig-free solve.

Counterpart of ``metalens_tpu/solver/eig.py``.  The production solver
(:mod:`.rcwa`) propagates through the patterned layer without an
eigensolver (thin-slab Taylor series + Redheffer doubling).  This module
solves the same problem by the classical route: complex eigendecomposition
of the layer operator FG into Bloch modes, diagonal propagation
e^{i q k0 h}, and S-matrix mode matching at both faces.

Host numpy in float64 / complex128 on purpose: general complex eig is its
job, not speed.  It shares only the Toeplitz, F and G construction and the
basis definitions with the production solver (taken from the port's
:mod:`.epsilon`, :func:`.rcwa.build_FG` and :mod:`.basis` on the CPU);
modes, propagation and matching are its own.
"""

from __future__ import annotations

import numpy as np
import torch

from . import basis
from .epsilon import ellipse_layer_toeplitz
from .rcwa import SMatrix, build_FG

TWO_PI = 2.0 * np.pi


def _f64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _we_dense(Kx, Ky, eps, n):
    """Dense (2N, 2N) E-from-amplitude map of a uniform medium (numpy)."""
    Kz = basis.kz_norm(Kx, Ky, eps)
    A, B, Cb, D = (x.numpy() for x in basis.we_blocks(Kx, Ky, Kz, n))
    return np.block([[np.diag(A), np.diag(B)], [np.diag(Cb), np.diag(D)]])


def reference_cell_smatrix(orders, xyrra, grating_period, lateral_period,
                           cyl_height, eps_pillar, eps_glass, wavelength,
                           ux, uy):
    """Air / pillars / glass S-matrix of one cell (``xyrra`` (nE, 5)) via
    eigenmodes, on the host in complex128.  Same ports and amplitude
    conventions as :func:`.rcwa.cell_smatrix`.  Returns (SMatrix of numpy
    arrays, Kx, Ky)."""
    orders = np.asarray(orders)
    N = orders.shape[0]
    Kx = ux + orders[:, 0] * (wavelength / grating_period)
    Ky = uy + orders[:, 1] * (wavelength / lateral_period)
    Kx_t, Ky_t = _f64(Kx), _f64(Ky)

    E = ellipse_layer_toeplitz(orders, grating_period, lateral_period,
                               _f64(xyrra), eps_pillar)
    Einv = torch.as_tensor(np.linalg.inv(E.numpy()))
    F, G = (M.numpy() for M in build_FG(E, Einv, Kx_t, Ky_t))

    # Bloch modes: FG w = q^2 w; q on the physical branch (Im >= 0, and +
    # real for propagating modes)
    q2, W = np.linalg.eig(F @ G)
    q = np.sqrt(q2 + 0j)
    q = np.where(q.imag < 0, -q, q)
    real_prop = (np.abs(q.imag) < 1e-9 * np.abs(q.real)) & (q.real < 0)
    q = np.where(real_prop, -q, q)
    V = (G @ W) / q[None, :]             # the modes' H fields
    lam_prop = np.exp(1j * q * TWO_PI * cyl_height / wavelength)

    # [e; h] = [[W, W], [V, -V]] [m_f; m_b] for modes and
    # [[Wu, -Wu], [I, I]] [c_f; c_b] for a uniform medium
    Wa = _we_dense(Kx_t, Ky_t, 1.0, 1.0)
    Wg = _we_dense(Kx_t, Ky_t, complex(eps_glass),
                   np.sqrt(complex(eps_glass)))
    I = np.eye(2 * N, dtype=complex)

    def iface_uniform_to_modes(Wu):
        """Transfer (c_f, c_b) -> (m_f, m_b)."""
        Wi_e = np.linalg.solve(W, Wu)
        Vi_h = np.linalg.solve(V, I)
        return (0.5 * (Wi_e + Vi_h), 0.5 * (-Wi_e + Vi_h),
                0.5 * (Wi_e - Vi_h), 0.5 * (-Wi_e - Vi_h))

    def iface_modes_to_uniform(Wu):
        """Transfer (m_f, m_b) -> (c_f, c_b)."""
        WiW = np.linalg.solve(Wu, W)
        return (0.5 * (WiW + V), 0.5 * (WiW - V), 0.5 * (-WiW + V),
                0.5 * (-WiW - V))

    def transfer_to_s(M11, M12, M21, M22):
        M22i = np.linalg.inv(M22)
        s21 = -M22i @ M21
        return (M11 + M12 @ s21, M12 @ M22i, s21, M22i)

    def star(A, B):
        X = np.linalg.solve(I - A[1] @ B[2],
                            np.concatenate([A[0], A[1] @ B[3]], axis=1))
        XA11, XA12B22 = X[:, :2 * N], X[:, 2 * N:]
        return (B[0] @ XA11, B[1] + B[0] @ XA12B22,
                A[2] + A[3] @ (B[2] @ XA11),
                A[3] @ (B[2] @ XA12B22 + B[3]))

    zero = np.zeros((2 * N, 2 * N), complex)
    S_top = transfer_to_s(*iface_uniform_to_modes(Wa))
    S_prop = (np.diag(lam_prop), zero, zero, np.diag(lam_prop))
    S_bot = transfer_to_s(*iface_modes_to_uniform(Wg))
    S = star(S_top, star(S_prop, S_bot))
    return SMatrix(*S), Kx, Ky
