"""Thin-slab Taylor factors: the CUDA kernel behind ``rcwa.thin_slab_T_blocks``.

Counterpart of ``metalens_tpu/solver/pallas_taylor.py``.  For a batch of
F, G (B, n, n) and slab thickness t the factors are

    CS  = sum_k cC_k t^{2k} Y0^k            (= T11)
    SF  = [sum_k cS_k t^{2k} Y0^k] F        (T12 = i t SF)
    GS  = G [sum_k cS_k t^{2k} Y0^k]        (T21 = i t GS)
    GRF = G [sum_k cR_k t^{2k} Y0^k] F      (T22 = I + t^2 GRF)

with Y0 = F G.  The three series share Y0's powers by Paterson-Stockmeyer
chunking (:func:`_ps_split`), and t^{2k} is folded into a (B, 3, terms+1)
coefficient table (:func:`coeff_table`), so t may vary along the batch.

:func:`taylor_factors` routes by device only: a CPU tensor goes to the plain
version :func:`taylor_factors_reference` (the twin of
``pallas_taylor.xla_factors`` and ``rcwa._shared_power_polys``), a CUDA
tensor to :func:`taylor_factors_cuda`, which launches the hand-written
GEMM-with-chunk-epilogue kernel of ``csrc/taylor.cu`` once per stage and
raises on anything it does not take.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

_SIGNATURES = {
    "cgemm_ps_c64": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p],
}


def _ps_split(d: int, n_poly: int = 3):
    """Paterson-Stockmeyer chunk size s and chunk count r minimizing
    (s-1) + n_poly*(r-1) matrix products for degree d (the rule of
    ``pallas_taylor._ps_split`` and ``rcwa._shared_power_polys``)."""
    s_best, cost_best = 1, None
    for s in range(1, d + 2):
        r = -(-(d + 1) // s)
        cost = (s - 1) + n_poly * (r - 1)
        if cost_best is None or cost < cost_best:
            s_best, cost_best = s, cost
    return s_best, -(-(d + 1) // s_best)


def series_coefficients(terms: int):
    """The cos, sinc and R series coefficients (-1)^k/(2k)!,
    (-1)^k/(2k+1)! and (-1)^(k+1)/(2k+2)!, k = 0..terms."""
    ks = range(terms + 1)
    return ([(-1.0) ** k / math.factorial(2 * k) for k in ks],
            [(-1.0) ** k / math.factorial(2 * k + 1) for k in ks],
            [(-1.0) ** (k + 1) / math.factorial(2 * k + 2) for k in ks])


def coeff_table(t, terms: int, batch: int, device) -> torch.Tensor:
    """(batch, 3, terms+1) float32 table of the three series' coefficients
    with t^{2k} folded in; ``t`` is a number or a (batch,) tensor."""
    t64 = torch.as_tensor(t, dtype=torch.float64).to(device)
    t64 = t64.reshape(-1, 1).expand(batch, 1)
    tp = t64 ** (2 * torch.arange(terms + 1, device=device,
                                  dtype=torch.float64))
    coeffs = torch.tensor(series_coefficients(terms), dtype=torch.float64,
                          device=device)
    return (coeffs[None] * tp[:, None, :]).to(torch.float32).contiguous()


def shared_power_polys(Y: torch.Tensor, I: torch.Tensor, coeff_lists):
    """Several matrix polynomials sum_i c_i Y^i sharing the powers of Y, by
    Paterson-Stockmeyer chunking (twin of ``rcwa._shared_power_polys``)."""
    d = max(len(c) for c in coeff_lists) - 1
    s, _ = _ps_split(d, len(coeff_lists))
    pows = [I, Y]
    for _ in range(2, s + 1):
        pows.append(pows[-1] @ Y)
    X = pows[s]
    outs = []
    for coeffs in coeff_lists:
        chunks = []
        for j in range(0, len(coeffs), s):
            cs = coeffs[j:j + s]
            Bj = pows[0] * cs[0]
            for i in range(1, len(cs)):
                Bj = Bj + pows[i] * cs[i]
            chunks.append(Bj)
        acc = chunks[-1]
        for Bj in chunks[-2::-1]:
            acc = acc @ X + Bj
        outs.append(acc)
    return outs


def _batch_scalar(t, like: torch.Tensor):
    """t as a number, or a (B,) tensor shaped to scale a (B, n, n) batch."""
    if isinstance(t, torch.Tensor) and t.ndim > 0:
        return t.to(like.device).reshape(-1, 1, 1)
    return float(t)


def taylor_factors_reference(F: torch.Tensor, G: torch.Tensor, t,
                             terms: int):
    """The plain version (twin of ``pallas_taylor.xla_factors``): powers of
    the scaled Y = t^2 F G, then the wrapper products."""
    n = F.shape[-1]
    I = torch.eye(n, dtype=F.dtype, device=F.device)
    tt = _batch_scalar(t, F)
    Y = (F @ G) * (tt * tt)
    CS, SS, RS = shared_power_polys(Y, I, series_coefficients(terms))
    return CS, SS @ F, G @ SS, G @ (RS @ F)


def _check_cuda_matrices(F: torch.Tensor, G: torch.Tensor):
    for name, M in (("F", F), ("G", G)):
        if not M.is_cuda:
            raise ValueError(f"taylor_factors_cuda: {name} must be a CUDA "
                             f"tensor, got {M.device}")
        if M.dtype != torch.complex64:
            raise TypeError(f"taylor_factors_cuda takes complex64, "
                            f"{name} is {M.dtype}")
        if not M.is_contiguous():
            raise ValueError(f"taylor_factors_cuda: {name} is not contiguous")
        if torch.is_grad_enabled() and M.requires_grad:
            raise NotImplementedError(
                "the CUDA Taylor factors are forward-only: their backward "
                "pass is not ported yet (ROADMAP.md, queue 2)")
    if F.ndim != 3 or F.shape != G.shape or F.shape[-1] != F.shape[-2]:
        raise ValueError(f"taylor_factors_cuda needs F, G of one shape "
                         f"(B, n, n), got {tuple(F.shape)}, {tuple(G.shape)}")
    if F.device != G.device:
        raise ValueError("taylor_factors_cuda: F and G on different devices")


def taylor_factors_cuda(F: torch.Tensor, G: torch.Tensor,
                        coeffs: torch.Tensor, terms: int):
    """(CS, SF, GS, GRF) of contiguous complex64 CUDA batches F, G
    (B, n, n) with the (B, 3, terms+1) float32 coefficient table of
    :func:`coeff_table`.  Every matrix product is a launch of the
    hand-written kernel: 1 + (s-1) + 3(r-1) + 4 products plus one
    epilogue-only launch per series for the top Paterson-Stockmeyer chunk.
    Forward only."""
    _check_cuda_matrices(F, G)
    B, n, _ = F.shape
    if (coeffs.device != F.device or coeffs.dtype != torch.float32
            or tuple(coeffs.shape) != (B, 3, terms + 1)
            or not coeffs.is_contiguous()):
        raise ValueError(f"taylor_factors_cuda needs a contiguous float32 "
                         f"coefficient table of shape {(B, 3, terms + 1)} on "
                         f"{F.device}, got {coeffs.dtype} "
                         f"{tuple(coeffs.shape)} on {coeffs.device}")
    s, r = _ps_split(terms)
    nn = n * n
    csize = F.element_size()
    lib = _cuda.load("taylor", _SIGNATURES)
    pows = torch.empty((B, s, n, n), dtype=F.dtype, device=F.device)
    sP = s * nn

    def power(m):          # pointer to Y0^m inside pows (m >= 1)
        return pows.data_ptr() + (m - 1) * nn * csize

    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream

        def launch(a, sa, b, sb, c, sc, coef_off=0, n_terms=0):
            global launches
            status = lib.cgemm_ps_c64(
                a, sa, b, sb, c, sc, n, B,
                coeffs.data_ptr() if n_terms else None, 3 * (terms + 1),
                coef_off, n_terms, pows.data_ptr(), sP, stream)
            _cuda.check(status, "cgemm_ps_c64")
            launches += 1

        launch(F.data_ptr(), nn, G.data_ptr(), nn, power(1), sP)   # Y0
        for m in range(2, s + 1):
            launch(power(m - 1), sP, power(1), sP, power(m), sP)
        starts = list(range(0, terms + 1, s))
        scratch = (torch.empty_like(F), torch.empty_like(F))
        series = []
        for p in range(3):
            dst = torch.empty_like(F)
            prev = None
            for k, j in enumerate(reversed(starts)):
                out = dst if k == len(starts) - 1 else scratch[k % 2]
                off = p * (terms + 1) + j
                hi = min(s, terms + 1 - j)
                if prev is None:        # top chunk: the sum alone
                    launch(None, 0, None, 0, out.data_ptr(), nn, off, hi)
                else:                   # Horner: prev X + chunk
                    launch(prev.data_ptr(), nn, power(s), sP,
                           out.data_ptr(), nn, off, hi)
                prev = out
            series.append(dst)
        CS, SS, RS = series
        SF, GS, RF, GRF = (torch.empty_like(F) for _ in range(4))
        launch(SS.data_ptr(), nn, F.data_ptr(), nn, SF.data_ptr(), nn)
        launch(G.data_ptr(), nn, SS.data_ptr(), nn, GS.data_ptr(), nn)
        launch(RS.data_ptr(), nn, F.data_ptr(), nn, RF.data_ptr(), nn)
        launch(G.data_ptr(), nn, RF.data_ptr(), nn, GRF.data_ptr(), nn)
    return CS, SF, GS, GRF


def taylor_factors(F: torch.Tensor, G: torch.Tensor, t, terms: int):
    """(CS, SF, GS, GRF) for F, G (B, n, n) and t (a number or (B,)): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if F.is_cuda:
        coeffs = coeff_table(t, terms, F.shape[0], F.device)
        return taylor_factors_cuda(F, G, coeffs, terms)
    if F.device.type == "cpu":
        return taylor_factors_reference(F, G, t, terms)
    raise ValueError(f"no Taylor factors for device {F.device}")
