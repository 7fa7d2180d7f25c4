"""Near-to-far-field transform (Taflove surface equivalence).

Counterpart of ``metalens_tpu/farfield.py`` (reference
``nearfield_farfield.py:14-191``): equivalent currents J = n x H,
M = -n x E on the aperture plane, radiation vectors N, L by a 2-D FFT, and
the angular power density

    P(ux, uy) * r^2 / uz = k^2/(32 pi^2 Z) * (|Lphi + Z*Ntheta|^2
                                             + |Ltheta - Z*Nphi|^2) / uz

with the reference's calibrated x2 normalization (an empty aperture
transmits 100%).  The transform is ``torch.fft`` on the device, where the
JAX package runs a matmul DFT (its backend has no complex FFT).  The
direction cosines and the spherical basis are float64 on either device and
meet the fields in the working dtype (complex64 on CUDA, complex128 on the
CPU).  Every entry point runs on CUDA unless called with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import trace, units as nu
from .engine import _device
from .solver import cpx
from .units import pi


def _u_lists(num_x, num_y, dxp, dyp, wavelength, n_glass):
    """FFT bin -> direction cosine in glass, aliased to the principal branch
    (reference nearfield_farfield.py:35-39)."""
    ux_list = np.arange(num_x) * (wavelength / n_glass) / (dxp * num_x)
    uy_list = np.arange(num_y) * (wavelength / n_glass) / (dyp * num_y)
    ux_list[ux_list > ux_list.max() / 2] -= (wavelength / n_glass) / dxp
    uy_list[uy_list > uy_list.max() / 2] -= (wavelength / n_glass) / dyp
    return ux_list, uy_list


def _check_grids(xp_list, yp_list, wavelength):
    for l in (xp_list, yp_list):
        diffs = np.diff(l)
        assert 0 < diffs[0] < wavelength / 2
        assert diffs.max() - diffs.min() <= 1e-9 * np.abs(diffs).max()


def _field(f, device):
    """A field (tensor or host array) as a complex tensor on ``device`` in
    the device's working dtype."""
    return torch.as_tensor(f).to(device=device,
                                 dtype=cpx.complex_dtype(device))


def _shifted_bins(ux_list, uy_list):
    """The fftshifted direction cosines as a sparse meshgrid, and their
    steps."""
    ux_list = np.fft.fftshift(ux_list)
    uy_list = np.fft.fftshift(uy_list)
    dux = ux_list[1] - ux_list[0]
    duy = uy_list[1] - uy_list[0]
    ux, uy = np.meshgrid(ux_list, uy_list, indexing="ij", sparse=True)
    return ux, uy, dux, duy


def farfield_from_nearfield(fftEx, fftEy, fftHx, fftHy, xp_list, yp_list,
                            wavelength, n_glass, *, device="cuda"):
    """Angular power distribution from pre-FFT'd aperture fields (tensors
    or host complex arrays).  Returns (P_times_r2_over_uz, total_P, ux, uy,
    dux, duy) with fftshift applied, like the reference; P is a tensor on
    ``device`` (CUDA unless ``device="cpu"``)."""
    device = _device(device)
    xp_list = np.asarray(xp_list)
    yp_list = np.asarray(yp_list)
    dxp = xp_list[1] - xp_list[0]
    dyp = yp_list[1] - yp_list[0]
    num_x, num_y = len(xp_list), len(yp_list)
    fftEx, fftEy, fftHx, fftHy = (_field(f, device)
                                  for f in (fftEx, fftEy, fftHx, fftHy))
    assert fftEx.shape == fftEy.shape == fftHx.shape == fftHy.shape \
        == (num_x, num_y)
    _check_grids(xp_list, yp_list, wavelength)

    ux_list, uy_list = _u_lists(num_x, num_y, dxp, dyp, wavelength, n_glass)
    P = _angular_power(fftEx, fftEy, fftHx, fftHy,
                       torch.as_tensor(ux_list, device=device),
                       torch.as_tensor(uy_list, device=device),
                       dxp, dyp, wavelength, n_glass)
    P = torch.fft.fftshift(P)      # == the reference's roll by n // 2
    ux, uy, dux, duy = _shifted_bins(ux_list, uy_list)
    total_P = float((torch.where(torch.isfinite(P), P, 0.0)
                     * dux * duy).sum())
    return P, total_P, ux, uy, dux, duy


def _abs2(z):
    return z.real ** 2 + z.imag ** 2


def _angular_power(fftEx, fftEy, fftHx, fftHy, ux_list, uy_list,
                   dxp, dyp, wavelength, n_glass):
    """The Taflove 8.15/8.17/8.23-25 pipeline on unshifted FFT bins
    (reference ``nearfield_farfield.py:77-191``).  ``ux_list``/``uy_list``
    are float64 tensors on the fields' device; returns a real tensor in the
    fields' real dtype."""
    rdt = cpx.real_dtype(fftEx.dtype)
    ux = ux_list[:, None]
    uy = uy_list[None, :]

    # J = n x H, M = -n x E with n = +zhat; N, L = FFT * dx dy
    dA = dxp * dyp
    Nx = fftHy * (-dA)
    Ny = fftHx * dA
    Lx = fftEy * dA
    Ly = fftEx * (-dA)

    uz2 = 1.0 - ux ** 2 - uy ** 2
    uz = torch.sqrt(torch.where(uz2 < 0, torch.nan, uz2))
    sintheta = torch.sqrt(ux ** 2 + uy ** 2)
    # exact spherical basis for every off-axis bin; the on-axis bin (the only
    # place sintheta = 0 on an FFT grid) is overridden by its limit below
    s = torch.where(sintheta == 0.0, 1.0, sintheta)
    a = (ux * uz / s).to(rdt)
    b = (uy * uz / s).to(rdt)
    cphi = (ux / s).to(rdt)
    sphi = (uy / s).to(rdt)
    Ntheta = Nx * a + Ny * b
    Nphi = Nx * (-sphi) + Ny * cphi
    Ltheta = Lx * a + Ly * b
    Lphi = Lx * (-sphi) + Ly * cphi
    # on-axis limit (uy = 0, ux -> 0+): theta-hat -> x-hat, phi-hat -> y-hat
    # (reference nearfield_farfield.py:160-169)
    on_axis = (ux == 0.0) & (uy == 0.0)
    Ntheta = torch.where(on_axis, Nx, Ntheta)
    Nphi = torch.where(on_axis, Ny, Nphi)
    Ltheta = torch.where(on_axis, Lx, Ltheta)
    Lphi = torch.where(on_axis, Ly, Lphi)

    Z = nu.Z0 / n_glass
    # exact 1/uz, the reference's divide-then-mask semantics
    # (nearfield_farfield.py:183-185 divides by uz and sums finite entries
    # at :74): a grazing bin (uz == 0) yields inf and an evanescent bin
    # (uz2 < 0) yields nan, both dropped by the finite-entry sums of
    # farfield_from_nearfield and focal_metrics
    P = ((2 * pi * n_glass / wavelength) ** 2 / (32 * pi ** 2 * Z)
         * (_abs2(Lphi + Ntheta * Z) + _abs2(Ltheta - Nphi * Z))
         ) / uz.to(rdt)
    # calibration factor: empty aperture must transmit 100%
    # (reference nearfield_farfield.py:188-189)
    return P * 2


@trace.traced("farfield.farfield")
def farfield(Ex, Ey, Hx, Hy, xp_list, yp_list, wavelength, n_glass, *,
             device="cuda"):
    """fftshift + 2-D FFT of each aperture field on ``device`` (CUDA
    unless ``device="cpu"``), then the angular transform.  Accepts tensors
    or host complex arrays."""
    device = _device(device)

    def prep(f):
        return torch.fft.fft2(torch.fft.fftshift(_field(f, device)))
    return farfield_from_nearfield(prep(Ex), prep(Ey), prep(Hx), prep(Hy),
                                   xp_list, yp_list, wavelength, n_glass,
                                   device=device)


def _to_host_complex(f):
    if torch.is_tensor(f):
        return f.cpu().numpy()
    return np.asarray(f)


def farfield_big(Ex, Ey, Hx, Hy, xp_list, yp_list, wavelength, n_glass,
                 pts_at_a_time=1e7, progress=False, *, device="cuda"):
    """Slab-chunked :func:`farfield` for apertures whose fields and spectra
    should stay in host RAM -- the counterpart of the reference's uy-slab
    chunked transform (reference ``nearfield_farfield.py:45-66``, 1e7
    points per slab).  The device (CUDA unless ``device="cpu"``) holds one
    slab at a time: the separable 2-D FFT runs as an axis-1 pass over row
    slabs, then an axis-0 pass over column slabs, and the angular transform
    over row slabs.  Results equal :func:`farfield`'s up to rounding; ``P``
    comes back as a host numpy array."""
    device = _device(device)
    cdt = cpx.complex_dtype(device)
    xp_list = np.asarray(xp_list)
    yp_list = np.asarray(yp_list)
    num_x, num_y = len(xp_list), len(yp_list)
    dxp = xp_list[1] - xp_list[0]
    dyp = yp_list[1] - yp_list[0]
    _check_grids(xp_list, yp_list, wavelength)
    rows = max(1, int(pts_at_a_time // num_y))
    cols = max(1, int(pts_at_a_time // num_x))

    host_cdt = np.complex64 if cdt == torch.complex64 else np.complex128

    def fft_slab(blk, dim):
        return torch.fft.fft(torch.as_tensor(blk).to(device=device,
                                                     dtype=cdt),
                             dim=dim).cpu().numpy()

    spectra = []
    for name, f in (("Ex", Ex), ("Ey", Ey), ("Hx", Hx), ("Hy", Hy)):
        f = np.fft.fftshift(_to_host_complex(f))
        assert f.shape == (num_x, num_y)
        G = np.empty(f.shape, dtype=host_cdt)
        for s in range(0, num_x, rows):          # axis-1 FFT, row slabs
            e = min(s + rows, num_x)
            G[s:e] = fft_slab(f[s:e], 1)
            if progress:
                print(f"farfield_big: {name} axis-1 rows {s}..{e}",
                      flush=True)
        for s in range(0, num_y, cols):          # axis-0 FFT, column slabs
            e = min(s + cols, num_y)
            G[:, s:e] = fft_slab(np.ascontiguousarray(G[:, s:e]), 0)
            if progress:
                print(f"farfield_big: {name} axis-0 cols {s}..{e}",
                      flush=True)
        spectra.append(G)

    ux_list, uy_list = _u_lists(num_x, num_y, dxp, dyp, wavelength, n_glass)
    uy_dev = torch.as_tensor(uy_list, device=device)
    P = np.empty((num_x, num_y), dtype=spectra[0].real.dtype)
    for s in range(0, num_x, rows):              # angular map, row slabs
        e = min(s + rows, num_x)
        blk = _angular_power(*(torch.as_tensor(g[s:e]).to(device)
                               for g in spectra),
                             torch.as_tensor(ux_list[s:e], device=device),
                             uy_dev, dxp, dyp, wavelength, n_glass)
        P[s:e] = blk.cpu().numpy()

    P = np.fft.fftshift(P)
    ux, uy, dux, duy = _shifted_bins(ux_list, uy_list)
    total_P = float((np.where(np.isfinite(P), P, 0.0) * dux * duy).sum())
    return P, total_P, ux, uy, dux, duy


@trace.traced("farfield.focal_metrics")
def focal_metrics(P, ux, uy, dux, duy, total_P, power_through_lens,
                  spot_radius_u=None):
    """Focusing diagnostics: peak direction, encircled power within
    ``spot_radius_u`` of the peak (in direction-cosine units), and overall
    transmission total_P / power_through_lens.  ``P`` is a tensor (the
    sums run on its device) or a host array."""
    P = torch.as_tensor(P)
    Pz = torch.where(torch.isfinite(P), P, 0.0)
    flat_idx = int(torch.argmax(Pz))
    i, j = np.unravel_index(flat_idx, tuple(P.shape))
    ux_pk = float(np.asarray(ux).ravel()[i])
    uy_pk = float(np.asarray(uy).ravel()[j])
    out = {"peak_ux": ux_pk, "peak_uy": uy_pk,
           "transmission": total_P / power_through_lens}
    if spot_radius_u is not None:
        UX = np.asarray(ux).reshape(-1, 1)
        UY = np.asarray(uy).reshape(1, -1)
        mask = ((UX - ux_pk) ** 2 + (UY - uy_pk) ** 2
                <= spot_radius_u ** 2)
        out["power_in_spot"] = float(
            (torch.where(torch.as_tensor(mask, device=P.device), Pz, 0.0)
             * dux * duy).sum())
        out["spot_fraction_of_total"] = out["power_in_spot"] / max(total_P,
                                                                   1e-300)
    return out
