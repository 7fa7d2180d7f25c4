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
tensor through :class:`TaylorFn` to the launch plan of :func:`staged_factors`
on the hand-written kernels of ``csrc/taylor.cu``, which raise on anything
they do not take.  There is no fallback.  The gradient is :class:`TaylorFn`'s
backward, a replay of the plain version under autograd, as the JAX
package's VJP (``pallas_taylor.py:259-270``) replays ``xla_factors``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda

# launches of cgemm_ps_c64 and of ps_chunks_c64 since the last reset
# (chip_smoke.py reads and resets them)
launches = 0
chunk_launches = 0

# Paterson-Stockmeyer chunks per series that ps_chunks_c64 holds (r <= 8
# up to 160 terms)
MAX_CHUNKS = 8

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "cgemm_ps_c64": [_P, _L, _P, _L, _P, _L, _P, _L, _I, _I, _P],
    "ps_chunks_c64": [_P, _L, _I, _P, _I, _I, _I, _P, _L, _I, _I, _P],
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


def coeff_table(t, terms: int, batch: int, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(batch, 3, terms+1) table of the three series' coefficients with
    t^{2k} folded in (float32, what the chunk kernel reads, unless ``dtype``
    says otherwise); ``t`` is a number or a (batch,) tensor."""
    t64 = torch.as_tensor(t, dtype=torch.float64).to(device)
    t64 = t64.reshape(-1, 1).expand(batch, 1)
    tp = t64 ** (2 * torch.arange(terms + 1, device=device,
                                  dtype=torch.float64))
    coeffs = torch.tensor(series_coefficients(terms), dtype=torch.float64,
                          device=device)
    return (coeffs[None] * tp[:, None, :]).to(dtype).contiguous()


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


def _check_cuda_matrices(F: torch.Tensor, G: torch.Tensor, terms: int):
    for name, M in (("F", F), ("G", G)):
        if not M.is_cuda:
            raise ValueError(f"taylor_factors_cuda: {name} must be a CUDA "
                             f"tensor, got {M.device}")
        if M.dtype != torch.complex64:
            raise TypeError(f"taylor_factors_cuda takes complex64, "
                            f"{name} is {M.dtype}")
        if not M.is_contiguous():
            raise ValueError(f"taylor_factors_cuda: {name} is not contiguous")
    if F.ndim != 3 or F.shape != G.shape or F.shape[-1] != F.shape[-2]:
        raise ValueError(f"taylor_factors_cuda needs F, G of one shape "
                         f"(B, n, n), got {tuple(F.shape)}, {tuple(G.shape)}")
    if F.device != G.device:
        raise ValueError("taylor_factors_cuda: F and G on different devices")
    if _ps_split(terms)[1] > MAX_CHUNKS:
        raise ValueError(f"taylor_factors_cuda supports at most "
                         f"{MAX_CHUNKS} Paterson-Stockmeyer chunks per "
                         f"series (160 terms), got {terms} terms")


def staged_factors(F: torch.Tensor, G: torch.Tensor, coeffs: torch.Tensor,
                   terms: int, gemm, chunk_sums):
    """(CS, SF, GS, GRF) by the kernels' launch plan, on the two primitives
    of :func:`gemm_cuda` and :func:`chunk_sums_cuda` (or their plain
    versions :func:`gemm_reference` and :func:`chunk_sums_reference`).
    Products: 1 + (s-1) for Y0's powers, 3(r-1) Horner steps (each adds one
    chunk in its epilogue; the top chunk is the start), 4 wrapper
    products; and one chunk pass."""
    B, n, _ = F.shape
    s, r = _ps_split(terms)
    pows = F.new_empty((B, s, n, n))
    gemm(F, G, pows[:, 0])
    for m in range(1, s):
        gemm(pows[:, m - 1], pows[:, 0], pows[:, m])
    chunks = F.new_empty((B, 3, r, n, n))
    chunk_sums(pows, coeffs, terms, s, r, chunks)
    X = pows[:, s - 1]
    scratch = (torch.empty_like(F), torch.empty_like(F))
    series = []
    for p in range(3):
        acc = chunks[:, p, r - 1]
        for j in range(r - 2, -1, -1):
            out = torch.empty_like(F) if j == 0 else scratch[j % 2]
            gemm(acc, X, out, chunks[:, p, j])
            acc = out
        series.append(acc)
    CS, SS, RS = series
    SF, GS, RF, GRF = (torch.empty_like(F) for _ in range(4))
    gemm(SS, F, SF)
    gemm(G, SS, GS)
    gemm(RS, F, RF)
    gemm(G, RF, GRF)
    return CS.contiguous(), SF, GS, GRF


def gemm_reference(A, B, out, D=None):
    """The plain version of ``cgemm_ps_c64``: out = A B (+ D)."""
    out.copy_(A @ B if D is None else A @ B + D)


def chunk_sums_reference(pows, coeffs, terms, s, r, out):
    """The plain version of ``ps_chunks_c64``: the 3 r Paterson-Stockmeyer
    chunks out[:, p, j] = sum_{m < s, js+m <= terms} coeffs[:, p, js+m]
    Y0^m from the powers pows[:, m-1] = Y0^m (Y0^0 = I)."""
    P = [torch.eye(pows.shape[-1], dtype=pows.dtype, device=pows.device)]
    P += [pows[:, m - 1] for m in range(1, s)]
    for p in range(3):
        for j in range(r):
            out[:, p, j] = sum(coeffs[:, p, j * s + m, None, None] * P[m]
                               for m in range(s) if j * s + m <= terms)


def _batch_stride(M: torch.Tensor) -> int:
    """Batch stride of a (B, n, n) view whose matrices are row-major."""
    n = M.shape[-1]
    if M.ndim != 3 or M.stride()[1:] != (n, 1):
        raise ValueError(f"needs row-major (B, n, n) matrices, got shape "
                         f"{tuple(M.shape)} strides {M.stride()}")
    return M.stride(0)


def gemm_cuda(A: torch.Tensor, B: torch.Tensor, out: torch.Tensor,
              D: torch.Tensor | None = None):
    """out = A B (+ D) for complex64 CUDA (batch, n, n) views with
    row-major matrices (any batch stride; out aliases none of the others):
    one launch of ``cgemm_ps_c64``."""
    global launches
    views = (A, B, out) if D is None else (A, B, out, D)
    if not out.is_cuda or any(M.shape != out.shape or M.device != out.device
                              or M.dtype != torch.complex64 for M in views):
        raise ValueError("gemm_cuda needs complex64 views of one shape on "
                         "one CUDA device")
    lib = _cuda.load("taylor", _SIGNATURES)
    with torch.cuda.device(out.device):
        status = lib.cgemm_ps_c64(
            A.data_ptr(), _batch_stride(A), B.data_ptr(), _batch_stride(B),
            None if D is None else D.data_ptr(),
            0 if D is None else _batch_stride(D), out.data_ptr(),
            _batch_stride(out), out.shape[-1], out.shape[0],
            torch.cuda.current_stream(out.device).cuda_stream)
    _cuda.check(status, "cgemm_ps_c64")
    launches += 1


def _check_coeffs(coeffs: torch.Tensor, batch: int, terms: int, device):
    if (coeffs.device != device or coeffs.dtype != torch.float32
            or tuple(coeffs.shape) != (batch, 3, terms + 1)
            or not coeffs.is_contiguous()):
        raise ValueError(f"needs a contiguous float32 coefficient table of "
                         f"shape {(batch, 3, terms + 1)} on {device}, got "
                         f"{coeffs.dtype} {tuple(coeffs.shape)} on "
                         f"{coeffs.device}")


def chunk_sums_cuda(pows: torch.Tensor, coeffs: torch.Tensor, terms: int,
                    s: int, r: int, out: torch.Tensor):
    """:func:`chunk_sums_reference` for contiguous complex64 CUDA powers
    (batch, s, n, n) and chunks (batch, 3, r, n, n) with the float32 table
    of :func:`coeff_table`: one launch of ``ps_chunks_c64``."""
    global chunk_launches
    B, n = pows.shape[0], pows.shape[-1]
    if (not pows.is_cuda or out.device != pows.device
            or pows.dtype != torch.complex64 or out.dtype != torch.complex64
            or tuple(pows.shape) != (B, s, n, n)
            or tuple(out.shape) != (B, 3, r, n, n)
            or not (pows.is_contiguous() and out.is_contiguous())
            or not 1 <= r <= MAX_CHUNKS or (r - 1) * s > terms):
        raise ValueError(f"chunk_sums_cuda: powers {pows.dtype} "
                         f"{tuple(pows.shape)} on {pows.device}, chunks "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}, "
                         f"s = {s}, r = {r}, terms = {terms}")
    _check_coeffs(coeffs, B, terms, pows.device)
    lib = _cuda.load("taylor", _SIGNATURES)
    with torch.cuda.device(out.device):
        status = lib.ps_chunks_c64(
            pows.data_ptr(), pows.stride(0), s, coeffs.data_ptr(),
            coeffs.stride(0), terms, r, out.data_ptr(), out.stride(0), n, B,
            torch.cuda.current_stream(out.device).cuda_stream)
    _cuda.check(status, "ps_chunks_c64")
    chunk_launches += 1


def taylor_factors_cuda(F: torch.Tensor, G: torch.Tensor,
                        coeffs: torch.Tensor, terms: int):
    """(CS, SF, GS, GRF) of contiguous complex64 CUDA batches F, G
    (B, n, n) with the (B, 3, terms+1) float32 coefficient table of
    :func:`coeff_table`: the plan of :func:`staged_factors` on the
    hand-written kernels.  Forward only: a gradient goes through
    :class:`TaylorFn` (:func:`taylor_factors`)."""
    _check_cuda_matrices(F, G, terms)
    if torch.is_grad_enabled() and (F.requires_grad or G.requires_grad):
        raise NotImplementedError(
            "taylor_factors_cuda is forward-only: take the gradient through "
            "taylor_factors() (TaylorFn)")
    _check_coeffs(coeffs, F.shape[0], terms, F.device)
    return staged_factors(F, G, coeffs, terms, gemm_cuda, chunk_sums_cuda)


class TaylorFn(torch.autograd.Function):
    """(CS, SF, GS, GRF) by :func:`staged_factors` on the given primitives
    (``gemm_cuda`` and ``chunk_sums_cuda`` on the card, or their plain
    versions), with the gradient of :func:`taylor_factors_reference`: the
    backward replays the plain version under autograd and pulls the four
    cotangents back to F and G.  The replay is the design of the gradient,
    not a fallback: the forward never leaves the given primitives.  t is
    the slab thickness, not a design variable; its gradient is None."""

    @staticmethod
    def forward(ctx, F, G, t, terms, gemm, chunk_sums):
        coeffs = coeff_table(t, terms, F.shape[0], F.device,
                             dtype=F.real.dtype)
        ctx.save_for_backward(F, G)
        ctx.t, ctx.terms = t, terms
        return staged_factors(F, G, coeffs, terms, gemm, chunk_sums)

    @staticmethod
    def backward(ctx, *cotangents):
        F, G = ctx.saved_tensors
        with torch.enable_grad():
            F_, G_ = F.detach().requires_grad_(), G.detach().requires_grad_()
            outs = taylor_factors_reference(F_, G_, ctx.t, ctx.terms)
            gF, gG = torch.autograd.grad(outs, (F_, G_), cotangents)
        return gF, gG, None, None, None, None


def taylor_factors(F: torch.Tensor, G: torch.Tensor, t, terms: int):
    """(CS, SF, GS, GRF) for F, G (B, n, n) and t (a number or (B,)): the
    kernels (under :class:`TaylorFn`) for CUDA tensors, the plain version
    for CPU tensors."""
    if F.is_cuda:
        _check_cuda_matrices(F, G, terms)
        return TaylorFn.apply(F, G, t, terms, gemm_cuda, chunk_sums_cuda)
    if F.device.type == "cpu":
        return taylor_factors_reference(F, G, t, terms)
    raise ValueError(f"no Taylor factors for device {F.device}")
