"""Batched complex inverse: the CUDA kernel behind :func:`cpx.solve`.

Counterpart of ``metalens_tpu/solver/pallas_inv.py``.  The TPU kernel
(``_inv_kernel``) inverts well-conditioned complex matrices by unpivoted
2x2 block recursion down to a Gauss-Jordan base; ``csrc/cinv.cu`` runs the
same unpivoted elimination, blocked in panels of pivots: one thread block
per matrix with the working copy in registers for n <= 128, a thread-block
cluster per matrix with the copy split across the blocks' shared memory
above (see the note at the top of that file).  The TPU-only machinery -- padding to sublane-aligned
sizes, interleave groups, the ``custom_vmap`` rule -- has no job here.

:func:`inv` routes by device only: a CPU tensor goes to the plain version
:func:`inv_reference` (``torch.linalg.inv``, which has its own autograd), a
CUDA tensor through :class:`InverseFn` to the kernel, which raises on
anything it does not take.  There is no fallback.  The gradient is
:class:`InverseFn`'s backward: two matrix products on the saved inverse, as
the JAX package's VJP (``pallas_inv.py:351-365``) is two XLA products
outside the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda

MAX_N = 256
REGISTER_MAX_N = 128      # cinv.cu's register route; clusters above

# kernel launches since the last reset, in all and by route (chip_smoke.py
# reads and resets them)
launches = 0
route_launches = {"registers": 0, "cluster": 0}

_SIGNATURES = {
    "cinv_c64": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p],
}


def inv_reference(A: torch.Tensor) -> torch.Tensor:
    """The plain version: pivoted LU inverse of every matrix of the batch."""
    return torch.linalg.inv(A)


def inv_cuda(A: torch.Tensor) -> torch.Tensor:
    """Inverse of each (n, n) complex64 matrix of a contiguous CUDA batch
    (..., n, n), n <= 256, by the hand-written kernel.  Forward only: a
    gradient goes through :class:`InverseFn` (:func:`inv`)."""
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
            "inv_cuda is forward-only: take the gradient through inv() "
            "(InverseFn)")
    out = torch.empty_like(A)
    batch = A.numel() // (n * n)
    lib = _cuda.load("cinv", _SIGNATURES)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        status = lib.cinv_c64(A.data_ptr(), out.data_ptr(), n, batch, stream)
    _cuda.check(status, "cinv_c64")
    launches += 1
    route_launches["cluster" if n > REGISTER_MAX_N else "registers"] += 1
    return out


class InverseFn(torch.autograd.Function):
    """W = A^-1 by the given forward routine (``inv_cuda`` on the card, or
    the plain :func:`inv_reference`), with the gradient of the inverse:
    grad_A = -W^H grad_W W^H.  That is torch's conjugate-Wirtinger
    convention, the adjoint of dW = -W dA W; the JAX formula differs by its
    complex cotangent convention."""

    @staticmethod
    def forward(ctx, A, inverse):
        W = inverse(A)
        ctx.save_for_backward(W)
        return W

    @staticmethod
    def backward(ctx, grad_W):
        W, = ctx.saved_tensors
        Wh = W.mH
        return -torch.matmul(torch.matmul(Wh, grad_W), Wh), None


def inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of every matrix of the batch: the kernel (under
    :class:`InverseFn`) for a CUDA tensor, the plain version for a CPU
    tensor."""
    if A.is_cuda:
        return InverseFn.apply(A, inv_cuda)
    if A.device.type == "cpu":
        return inv_reference(A)
    raise ValueError(f"no inverse for device {A.device}")
