"""Batched complex inverse: the CUDA kernel behind :func:`cpx.solve`.

Counterpart of ``metalens_tpu/solver/pallas_inv.py``.  The TPU kernel
(``_inv_kernel``) inverts well-conditioned complex matrices by unpivoted
2x2 block recursion down to a Gauss-Jordan base; ``csrc/cinv.cu`` runs the
same unpivoted elimination, one thread block per matrix (see the note at
the top of that file).  The TPU-only machinery -- padding to sublane-aligned
sizes, interleave groups, the ``custom_vmap`` rule -- has no job here.

:func:`inv` routes by device only: a CPU tensor goes to the plain version
:func:`inv_reference` (``torch.linalg.inv``), a CUDA tensor to the kernel,
which raises on anything it does not take.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda

MAX_N = 256

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

_SIGNATURES = {
    "cinv_c64": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p],
}


def inv_reference(A: torch.Tensor) -> torch.Tensor:
    """The plain version: pivoted LU inverse of every matrix of the batch."""
    return torch.linalg.inv(A)


def inv_cuda(A: torch.Tensor) -> torch.Tensor:
    """Inverse of each (n, n) complex64 matrix of a contiguous CUDA batch
    (..., n, n), n <= 256, by the hand-written kernel.  Forward only."""
    global launches
    if not A.is_cuda:
        raise ValueError(f"inv_cuda needs a CUDA tensor, got {A.device}")
    if A.dtype != torch.complex64:
        raise TypeError(f"inv_cuda takes complex64, got {A.dtype}")
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"inv_cuda needs square matrices, got {tuple(A.shape)}")
    n = A.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"inv_cuda supports n <= {MAX_N}, got n = {n}")
    if not A.is_contiguous():
        raise ValueError("inv_cuda needs a contiguous tensor")
    if torch.is_grad_enabled() and A.requires_grad:
        raise NotImplementedError(
            "the CUDA inverse is forward-only: its backward pass is not "
            "ported yet (ROADMAP.md, queue 2)")
    out = torch.empty_like(A)
    batch = A.numel() // (n * n)
    lib = _cuda.load("cinv", _SIGNATURES)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        status = lib.cinv_c64(A.data_ptr(), out.data_ptr(), n, batch, stream)
    _cuda.check(status, "cinv_c64")
    launches += 1
    return out


def inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of every matrix of the batch: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if A.is_cuda:
        return inv_cuda(A)
    if A.device.type == "cpu":
        return inv_reference(A)
    raise ValueError(f"no inverse for device {A.device}")
