"""Port parity of the thin-slab Taylor factors (metalens_tpu_torch.solver.
taylor against metalens_tpu.solver.pallas_taylor): the plain version
against the XLA formulation at float64 and against the Pallas kernel (in
interpret mode) at float32, and the CPU routing (the CUDA kernel itself is
held to the plain version in tests/test_torch_cuda.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from metalens_tpu.solver import cpx as jcpx, pallas_taylor as jpt
from metalens_tpu_torch import _cuda, trace
from metalens_tpu_torch.solver import taylor as ttay

torch.set_num_threads(1)


def _rand_fg(rng, B, n, scale=0.35):
    F = (rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))) * scale
    G = (rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))) * scale
    return F, G


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n,terms,t", [(40, 12, 1.37), (24, 20, 0.6)])
def test_reference_matches_xla_factors_f64(n, terms, t):
    rng = np.random.default_rng(0)
    F, G = _rand_fg(rng, 2, n)
    got = ttay.taylor_factors(torch.as_tensor(F), torch.as_tensor(G), t, terms)
    for b in range(2):
        want = jpt.xla_factors(jcpx.from_np(F[b]), jcpx.from_np(G[b]), t,
                               terms)
        for g, w in zip(got, want):
            assert g.dtype == torch.complex128
            assert _rel(g[b].numpy(), jcpx.to_np(w)) < 1e-10


def test_reference_matches_pallas_interpret_f32_batched_t():
    """complex64 plain version vs the TPU kernel (interpret mode), with t
    varying along the batch as in joint wavelength-direction batches."""
    rng = np.random.default_rng(1)
    n, terms = 40, 12
    F, G = _rand_fg(rng, 3, n)
    F, G = F.astype(np.complex64), G.astype(np.complex64)
    ts = np.array([0.7, 1.1, 1.4], np.float32)
    got = ttay.taylor_factors(torch.as_tensor(F), torch.as_tensor(G),
                              torch.as_tensor(ts), terms)
    want = jax.jit(jax.vmap(
        lambda f, g, t: jpt.taylor_factors(f, g, t, terms, True)))(
        jcpx.from_np(F), jcpx.from_np(G), jnp.asarray(ts))
    for b in range(3):
        for g, w in zip(got, want):
            assert g.dtype == torch.complex64
            assert _rel(g[b].numpy(), jcpx.to_np(w)[b]) < 2e-5


def test_ps_split_and_coeff_table():
    assert ttay._ps_split(20) == jpt._ps_split(20) == (7, 3)
    assert ttay._ps_split(24) == jpt._ps_split(24)
    t = np.array([0.3, 0.9])
    table = ttay.coeff_table(torch.as_tensor(t), 12, 2, "cpu")
    assert table.dtype == torch.float32 and table.shape == (2, 3, 13)
    for b in range(2):
        np.testing.assert_allclose(table[b].numpy(),
                                   np.asarray(jpt._coeff_table(t[b], 12)),
                                   rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("terms", [2, 8, 20])
def test_kernel_launch_plan_matches_reference(terms):
    """The CUDA path's staging (powers, one chunk pass, Horner steps that
    each add one chunk, wrapper products) on the plain versions of its two
    kernels, against the plain version of the whole; terms = 2 has a single
    chunk per series."""
    rng = np.random.default_rng(3)
    F, G = (torch.as_tensor(M) for M in _rand_fg(rng, 2, 6))
    t = torch.tensor([0.4, 0.8], dtype=torch.float64)
    coeffs = ttay.coeff_table(t, terms, 2, "cpu").double()
    got = ttay.staged_factors(F, G, coeffs, terms, ttay.gemm_reference,
                               ttay.chunk_sums_reference)
    want = ttay.taylor_factors_reference(F, G, t, terms)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        # the table holds float32 coefficients
        assert _rel(g.numpy(), w.numpy()) < 1e-6


def test_cpu_routing_launches_no_kernel():
    """On the CPU the wrapper takes the plain version because the tensor
    lies on the CPU: no library is built or loaded, the count stays 0, and
    the kernel entry refuses a CPU tensor."""
    rng = np.random.default_rng(2)
    F, G = _rand_fg(rng, 1, 8)
    with trace.collect():
        ttay.taylor_factors(torch.as_tensor(F), torch.as_tensor(G), 0.5, 8)
        counted = trace.snapshot()["counters"]
    assert "taylor.gemm_launches" not in counted
    assert "taylor.chunk_launches" not in counted
    assert "taylor" not in _cuda._loaded
    coeffs = ttay.coeff_table(0.5, 8, 1, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ttay.taylor_factors_cuda(torch.as_tensor(F).to(torch.complex64),
                                 torch.as_tensor(G).to(torch.complex64),
                                 coeffs, 8)
