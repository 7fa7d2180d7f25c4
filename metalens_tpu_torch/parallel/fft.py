"""Distributed 2-D FFT over the ranks of a mesh.

Counterpart of ``metalens_tpu/parallel/fft.py``.  The aperture field (up
to ~10^8 points for a mm-scale lens at lambda/2.2 sampling) is split by
rows over the ranks' devices.  The 2-D transform is the transpose
algorithm: a local ``torch.fft.fft`` along the columns of the local rows,
an ``all_to_all`` to column blocks, an FFT along the rows, and the exchange
back, so the aperture never leaves device memory.  The JAX package's
matmul DFT (its backend has no complex FFT) is ``torch.fft`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..farfield import _angular_power, _field, _shifted_bins, _u_lists


def fft2_sharded(mesh, axis_name="cells"):
    """Return the distributed fft2: ``x`` (this rank's contiguous block of
    rows of an (N, M) complex field, as a tensor) -> the same block of
    rows of ``fft2`` of the whole field, on the mesh's device.  N and M
    must divide over the ranks."""
    n = mesh.size

    def fft2(x):
        x = torch.as_tensor(x).to(mesh.device)
        nloc, M = x.shape
        if M % n:
            raise ValueError(f"{M} columns do not divide over {n} ranks")
        x = torch.fft.fft(x, dim=1)
        # to column blocks: block j of every rank's rows goes to rank j
        x = mesh.all_to_all(x.reshape(nloc, n, M // n).transpose(0, 1))
        x = torch.fft.fft(x.reshape(n * nloc, M // n), dim=0)
        # and back to row blocks
        x = mesh.all_to_all(x.reshape(n, nloc, M // n))
        return x.transpose(0, 1).reshape(nloc, M)

    return fft2


def farfield_sharded(mesh, Ex, Ey, Hx, Hy, xp_list, yp_list, wavelength,
                     n_glass, axis_name="cells"):
    """:func:`metalens_tpu_torch.farfield.farfield` with the aperture split
    by rows over the mesh: fftshift, the distributed fft2 and the angular
    transform of each rank's rows; the power map is all-gathered.  The
    fields are the whole aperture (tensors or host arrays; each rank takes
    its rows).  Returns what ``farfield`` returns: (P, total_P, ux, uy,
    dux, duy), P a tensor on the mesh's device."""
    xp_list = np.asarray(xp_list)
    yp_list = np.asarray(yp_list)
    dxp = xp_list[1] - xp_list[0]
    dyp = yp_list[1] - yp_list[0]
    num_x, num_y = len(xp_list), len(yp_list)
    if num_x % mesh.size or num_y % mesh.size:
        raise ValueError("pad the aperture so both axes divide over the "
                         f"{mesh.size} ranks")
    lo, hi = mesh.block(num_x)
    fft2 = fft2_sharded(mesh, axis_name)
    # the rows of fftshift(f) this rank holds: shifted row i is row
    # (i - num_x // 2) mod num_x
    rows = torch.as_tensor((np.arange(lo, hi) - num_x // 2) % num_x)

    def spectrum(f):
        if torch.is_tensor(f):
            f = f[rows.to(f.device)]
        else:
            f = np.asarray(f)[rows.numpy()]
        f = torch.roll(_field(f, mesh.device), num_y // 2, dims=1)
        return fft2(f)

    ux_list, uy_list = _u_lists(num_x, num_y, dxp, dyp, wavelength, n_glass)
    P = _angular_power(*(spectrum(f) for f in (Ex, Ey, Hx, Hy)),
                       torch.as_tensor(ux_list[lo:hi], device=mesh.device),
                       torch.as_tensor(uy_list, device=mesh.device),
                       dxp, dyp, wavelength, n_glass)
    P = torch.fft.fftshift(mesh.all_gather(P))
    ux, uy, dux, duy = _shifted_bins(ux_list, uy_list)
    total_P = float((torch.where(torch.isfinite(P), P, 0.0)
                     * dux * duy).sum())
    return P, total_P, ux, uy, dux, duy
