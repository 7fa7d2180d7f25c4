"""Port parity of the batched complex inverse (metalens_tpu_torch.solver.
inv against metalens_tpu's cpx.inv_blockrec and the Pallas kernel in
interpret mode) on matrices captured from the JAX hot path, and the CPU
routing (the CUDA kernel itself is held to the plain version in
tests/test_torch_cuda.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from metalens_tpu.solver import cpx as jcpx, orders as jord, rcwa as jrcwa
from metalens_tpu.solver.pallas_inv import inv_pallas
from metalens_tpu.units import nm
from metalens_tpu_torch import _cuda
from metalens_tpu_torch.solver import cpx as tcpx, inv as tinv

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def captured(request):
    """The matrices of every solve cell_amplitudes issues at numG = 25
    (NV on): the E and <<1/eps>> inverses at N and the slab, doubling and
    conversion-star solves at 2N.  The solve runs jitted (one compile
    instead of an eager dispatch per op); a debug callback records each
    matrix as it is solved."""
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mats = []
    orig = jcpx.solve

    def record(re, im):
        mats.append(np.asarray(re) + 1j * np.asarray(im))

    def capturing(A, B):
        jax.debug.callback(record, A.re, A.im)
        return orig(A, B)

    mp.setattr(jcpx, "solve", capturing)
    LX, LY, LAM, H = 1200 * nm, 320 * nm, 580 * nm, 550 * nm
    orders = jord.select_orders(LX, LY, 25)
    ns, taylor = jrcwa.slab_schedule(2 * np.pi * H / LAM, orders, LX, LY,
                                     LAM, 2.372 ** 2, target=16.5)
    xyrra = jnp.asarray(np.asarray(
        [[-215., 2., 144., 111., 0.], [196., -8., 100., 130., 0.1]])
        * [nm, nm, nm, nm, 1.0])
    i0 = jord.order_index(orders, 0, 0)
    c = np.zeros((50, 2))
    c[i0, 0] = c[i0 + 25, 1] = 1.0
    ampf = jax.jit(lambda x: jrcwa.cell_amplitudes(
        orders, x, LX, LY, H, 2.372 ** 2, 1.459 ** 2, LAM, 0.38, 0.1,
        jnp.asarray(c), n_slabs=ns, taylor_terms=taylor, fff=True)[0].re)
    np.asarray(ampf(xyrra))
    jax.effects_barrier()
    mp.undo()
    assert len(mats) >= 5
    return mats


def test_reference_matches_blockrec_f64(captured):
    blockrec = jax.jit(jcpx.inv_blockrec)
    for A in captured:
        got = tinv.inv(torch.as_tensor(A)[None])[0].numpy()
        want = jcpx.to_np(blockrec(jcpx.from_np(A)))
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-10


def test_reference_matches_pallas_interpret_f32(captured):
    """At 2N, the size of five of the seven solves of an NV cell (one
    matrix: interpret mode is slow)."""
    n = 2 * min(a.shape[0] for a in captured)
    A = next(a for a in captured if a.shape[0] == n)
    A32 = A.astype(np.complex64)
    got = tinv.inv(torch.as_tensor(A32)[None])[0].numpy()
    want = jcpx.to_np(inv_pallas(jcpx.from_np(A32), True))
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-5


def test_solve_routes_cpu_to_reference():
    rng = np.random.default_rng(0)
    n = 30
    A = (np.eye(n) + 0.4 * (rng.normal(size=(2, n, n))
                            + 1j * rng.normal(size=(2, n, n))) / np.sqrt(n))
    Bm = rng.normal(size=(2, n, 3)) + 1j * rng.normal(size=(2, n, 3))
    before = tinv.launches
    X = tcpx.solve(torch.as_tensor(A), torch.as_tensor(Bm)).numpy()
    assert tinv.launches == before and "cinv" not in _cuda._loaded
    np.testing.assert_allclose(A @ X, Bm, atol=1e-12)
    with pytest.raises(ValueError, match="CUDA"):
        tinv.inv_cuda(torch.as_tensor(A).to(torch.complex64))
