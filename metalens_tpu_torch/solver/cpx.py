"""Dtype policy, complex helpers and the routing of the dense solves.

torch has complex dtypes on the CPU and on CUDA, so the JAX package's
real-pair layer (``metalens_tpu/solver/cpx.py``'s ``C`` with Karatsuba
matmuls) has no counterpart here: the port computes on complex tensors.

Dtype policy, in one place: complex128 on the CPU (parity with the JAX
package in float64), complex64 on CUDA (where the kernels run; complex128 on
CUDA is refused by the kernels).

Every hot-path dense solve goes through :func:`solve`, the explicit inverse
applied by a matrix product (``pallas_inv.solve_pallas``'s contract): the
inverse is the CUDA kernel for a CUDA tensor and ``torch.linalg.inv`` for a
CPU tensor (:mod:`.inv`).  It needs well-conditioned leading blocks;
:func:`solve_embed` is the pivoted solve for matrices outside that contract
(absorbing eps).
"""

from __future__ import annotations

import torch

from .. import trace
from . import inv as _inv


def complex_dtype(device, dtype=None) -> torch.dtype:
    """The working complex dtype: ``dtype`` if given (complex64 or
    complex128), else complex128 on the CPU and complex64 on CUDA."""
    device = torch.device(device)
    if dtype is None:
        return torch.complex64 if device.type == "cuda" else torch.complex128
    if dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"working dtype must be complex64 or complex128, "
                        f"got {dtype}")
    return dtype


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for; CUDA must exist when it is
    asked for (the default), so that no call silently runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the entry points run on the GPU "
                           "by default; pass device='cpu' for the plain "
                           "PyTorch versions")
    return device


def _count_upload(t: torch.Tensor) -> None:
    trace.count("rcwa.h2d_copies")
    trace.count("rcwa.h2d_bytes", t.nbytes)


def to_device(src, dtype, device) -> torch.Tensor:
    """``src`` (an array, a list, a number or a tensor) as a tensor of
    ``dtype`` (None: its own) on ``device``.  The cell solve's copies of
    host data go through this function or :func:`upload`, which count each
    copy to a CUDA device in the trace registry as ``rcwa.h2d_copies`` and
    ``rcwa.h2d_bytes``."""
    t = torch.as_tensor(src, dtype=dtype, device=device)
    if t.is_cuda and not (torch.is_tensor(src) and src.is_cuda):
        _count_upload(t)
    return t


def upload(array, device, dtype: torch.dtype) -> torch.Tensor:
    """A host array on ``device``: on CUDA through pinned memory and a
    non-blocking copy, so the upload does not synchronize the stream."""
    t = torch.as_tensor(array, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    t = t.pin_memory().to(device, non_blocking=True)
    _count_upload(t)
    return t


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype matching a complex (or real) working dtype."""
    return {torch.complex64: torch.float32, torch.complex128: torch.float64,
            torch.float32: torch.float32, torch.float64: torch.float64}[dtype]


def to_complex(dtype: torch.dtype) -> torch.dtype:
    return {torch.float32: torch.complex64, torch.float64: torch.complex128,
            torch.complex64: torch.complex64,
            torch.complex128: torch.complex128}[dtype]


def eye(n: int, like: torch.Tensor) -> torch.Tensor:
    """n x n complex identity in ``like``'s complex dtype and device."""
    return torch.eye(n, dtype=to_complex(like.dtype), device=like.device)


def scalar(z, like: torch.Tensor) -> torch.Tensor:
    """A python number (or 0-d tensor) as a 0-d complex tensor in
    ``like``'s complex dtype and device; a number is filled in on the
    device (no upload, so no host sync on CUDA)."""
    cdt = to_complex(like.dtype)
    if torch.is_tensor(z):
        return z.to(device=like.device, dtype=cdt)
    return torch.full((), complex(z), dtype=cdt, device=like.device)


def csqrt_posim(c: torch.Tensor) -> torch.Tensor:
    """Square root on the Im >= 0 branch: +sqrt for real positive input,
    +i sqrt|.| for real negative (evanescent decay along +z).  Same formula
    as ``metalens_tpu/solver/cpx.py:csqrt_posim``."""
    re, im = c.real, c.imag
    r = torch.sqrt(re * re + im * im)
    out_re = torch.sqrt(torch.clamp((r + re) / 2, min=0.0))
    out_im = torch.sqrt(torch.clamp((r - re) / 2, min=0.0))
    out_re = torch.where(im < 0, -out_re, out_re)
    return torch.complex(out_re, out_im)


def inverse(A: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batch of well-conditioned complex matrices,
    routed by device (see :mod:`.inv`): ``solve(A, I)`` without the
    product by the identity."""
    return _inv.inv(A.contiguous())


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for a batch of well-conditioned complex A as
    inv(A) @ B."""
    return inverse(A) @ B


def solve_embed(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pivoted LU solve for general complex A (absorbing eps, where the
    unpivoted contract of :func:`solve` does not hold)."""
    return torch.linalg.solve(A, B)
