"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card.  CUDA kernels have no CPU mode, so every test here needs an
NVIDIA GPU and skips without one.  The GPU machine has no JAX: this file
imports only torch and the port, and runs there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from metalens_tpu_torch.solver import inv, orders as ordmod, rcwa, taylor

NM = 1e-9
LX, LY, LAM, H = 1200 * NM, 320 * NM, 580 * NM, 550 * NM
NT, NG = 2.372, 1.459
BASE = np.array([[-215 * NM, 2 * NM, 144 * NM, 111 * NM, 0.0],
                 [196 * NM, -8 * NM, 100 * NM, 130 * NM, 0.1]])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _hot_path_calls(device, module, name, numG=25):
    """Arguments of every call of module.name during one port cell solve
    (NV on, complex64 on the card)."""
    seen = []
    orig = getattr(module, name)

    def spy(*args):
        seen.append(args)
        return orig(*args)

    orders = ordmod.select_orders(LX, LY, numG)
    ns, terms = rcwa.slab_schedule(2 * np.pi * H / LAM, orders, LX, LY, LAM,
                                   NT ** 2, dtype=torch.float32)
    i0 = ordmod.order_index(orders, 0, 0)
    c = torch.zeros(2 * numG, 2)
    c[i0, 0] = c[i0 + numG, 1] = 1.0
    xy = torch.as_tensor(BASE[None], dtype=torch.float32, device=device)
    setattr(module, name, spy)
    try:
        rcwa.cell_amplitudes(orders, xy, LX, LY, H, NT ** 2, NG ** 2, LAM,
                             0.38, 0.1, c, n_slabs=ns, taylor_terms=terms,
                             fff=True)
    finally:
        setattr(module, name, orig)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 25, 100, 169, 170, 200, 256])
def test_inverse_kernel_random(cuda_device, n):
    """Both shared-memory (n <= 169) and global-memory variants."""
    gen = torch.Generator().manual_seed(n)
    noise = torch.view_as_complex(torch.randn(3, n, n, 2, generator=gen))
    A = (torch.eye(n) + 0.4 * noise / math.sqrt(n)).to(torch.complex64)
    A = A.to(cuda_device)
    before = inv.launches
    W = inv.inv(A)
    assert inv.launches == before + 1
    eye = torch.eye(n, dtype=A.dtype, device=cuda_device)
    assert (W @ A - eye).abs().max().item() < 5e-5


@pytest.mark.cuda
def test_inverse_kernel_on_hot_path_matrices(cuda_device):
    calls = _hot_path_calls(cuda_device, inv, "inv")
    assert len(calls) >= 5
    for (A,) in calls:
        W = inv.inv_cuda(A)
        R = inv.inv_reference(A)
        assert ((W - R).abs().max() / R.abs().max()).item() < 1e-4


@pytest.mark.cuda
def test_inverse_kernel_refuses(cuda_device):
    A = torch.eye(4, dtype=torch.complex128, device=cuda_device)[None]
    with pytest.raises(TypeError):
        inv.inv(A)
    with pytest.raises(ValueError, match="256"):
        inv.inv_cuda(torch.eye(257, dtype=torch.complex64,
                               device=cuda_device)[None])
    with pytest.raises(ValueError, match="contiguous"):
        inv.inv_cuda(torch.eye(8, dtype=torch.complex64,
                               device=cuda_device)[None].mT.expand(2, 8, 8))
    A = torch.eye(4, dtype=torch.complex64, device=cuda_device)[None]
    with pytest.raises(NotImplementedError):
        inv.inv_cuda(A.requires_grad_())


@pytest.mark.cuda
@pytest.mark.parametrize("n,terms", [(100, 20), (37, 8), (200, 24)])
def test_taylor_kernel_random_batched_t(cuda_device, n, terms):
    gen = torch.Generator().manual_seed(n)
    F = 0.35 * torch.view_as_complex(torch.randn(4, n, n, 2, generator=gen))
    G = 0.35 * torch.view_as_complex(torch.randn(4, n, n, 2, generator=gen))
    F = F.to(torch.complex64).to(cuda_device)
    G = G.to(torch.complex64).to(cuda_device)
    t = torch.tensor([0.3, 0.5, 0.7, 0.9])
    before = taylor.launches
    got = taylor.taylor_factors(F, G, t, terms)
    assert taylor.launches > before
    want = taylor.taylor_factors_reference(F, G, t.to(cuda_device), terms)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 2e-5


@pytest.mark.cuda
def test_taylor_kernel_on_hot_path_matrices(cuda_device):
    (F, G, t, terms), = _hot_path_calls(cuda_device, taylor,
                                        "taylor_factors")
    got = taylor.taylor_factors(F, G, t, terms)
    want = taylor.taylor_factors_reference(F, G, t, terms)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 2e-5
    with pytest.raises(TypeError):
        taylor.taylor_factors(F.to(torch.complex128), G.to(torch.complex128),
                              t, terms)
