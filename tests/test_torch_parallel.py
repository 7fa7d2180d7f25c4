"""The port's sharded paths (metalens_tpu_torch.parallel) on a 2-rank gloo
world on the CPU, in float64.

One world runs all six paths once (``dryrun.dryrun_multichip(2,
device="cpu")``: two ranks started by spawn, a file store under the test's
temporary directory, a timeout on every collective and a deadline on the
whole run).  Each path is held to the port's own unsharded call in this
process, which has no process group: the step to a one-rank mesh, the
characterize sweep to ``characterize_grating`` per member, the stitch to
``build_nearfield``, the fft2 to ``torch.fft.fft2``, the far field to
``farfield`` and the member design to each member alone through the fused
chain.  The JAX package's sharded step and fft2 are held to the world on
two of the conftest's virtual CPU devices; the other paths reach JAX
through the port's unsharded functions, which the other port test files
hold to it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalens_tpu import parallel as jpar
from metalens_tpu.solver import cpx as jcpx
from metalens_tpu_torch import optimize2_fused, optimize_fused, parallel
from metalens_tpu_torch.engine import (_fom_inputs, _order_bounds,
                                       characterize_grating,
                                       fom_value_and_grad)
from metalens_tpu_torch.nearfield import build_nearfield
from metalens_tpu_torch.parallel import dryrun
from metalens_tpu_torch.solver import orders as ordmod, rcwa

# the package exports the function farfield under the module's name
tff = importlib.import_module("metalens_tpu_torch.farfield")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return dryrun.dryrun_multichip(
        2, device="cpu", workdir=tmp_path_factory.mktemp("world"),
        timeout=240)


@pytest.fixture(scope="module")
def one():
    """This process's mesh: no process group, one rank."""
    return parallel.make_mesh(device="cpu")


@pytest.fixture(scope="module")
def sweep():
    p = dryrun._tiny_problem(numG=9, B=8)
    return p, dryrun.sweep_inputs(p)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _grazing_margin(p, args):
    """Smallest |n^2 - |k_par|^2| over the kept orders, terms and cells, for
    n = 1 (air) and n_glass: how close an order comes to grazing."""
    xyrra, Lx, Ly, _, _, eps_g, lam, ux, *_ = args
    o = p["orders"]
    worst = np.inf
    for b in range(len(xyrra)):
        for t in range(len(lam)):
            k2 = ((ux[b, t] + o[:, 0] * lam[t] / Lx[b]) ** 2
                  + (o[:, 1] * lam[t] / Ly[b]) ** 2)
            for n2 in (1.0, eps_g[t].real):
                worst = min(worst, np.abs(n2 - k2).min())
    return worst


def test_sweep_matches_one_rank(world, one, sweep):
    p, (tgt, inph, args) = sweep
    step = parallel.sharded_fom_and_grad(one, p["orders"], p["n_slabs"],
                                         tgt, inph, taylor_terms=p["taylor"])
    fom, grad = step(*args)
    assert grad.dtype == torch.float64 and grad.shape == (8, 2, 5)
    assert abs(world["sweep_fom"] - fom.item()) <= 1e-12 * abs(fom.item())
    assert _rel(world["sweep_grad"], grad.numpy()) <= 1e-12
    g = world["sweep_grad"]
    update = args[0] + 0.1e-9 * g / np.abs(g).max()
    fom2, _ = step(update, *args[1:])
    assert abs(world["sweep_fom2"] - fom2.item()) <= 1e-12 * abs(fom2.item())
    assert world["sweep_fom2"] > world["sweep_fom"]


def test_sweep_takes_device_tables(one, sweep):
    """The inputs as tensors (a loop's device tables) give the arrays'
    results; a table changed in place is read again."""
    p, (tgt, inph, args) = sweep
    step = parallel.sharded_fom_and_grad(one, p["orders"], p["n_slabs"],
                                         tgt, inph, taylor_terms=p["taylor"])
    targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    for a, b in zip(step(*args), step(*targs)):
        assert torch.equal(a, b)
    targs[1][:] = targs[1].flip(0)            # swap the two periods
    flipped = (args[0], args[1][::-1].copy()) + args[2:]
    for a, b in zip(step(*flipped), step(*targs)):
        assert torch.equal(a, b)


def test_sweep_matches_fom_value_and_grad(one):
    """Two cells at one period with the default terms (two wavelengths,
    orders -1 and 0, their own incidences and weights): the one-rank step
    against ``fom_value_and_grad`` cell by cell."""
    g = dryrun.characterize_members()[0]
    xy = np.stack([g.xyrra_list, g.xyrra_list * [1, 1, 1.02, 0.98, 1]])
    orders, n_s, n_t, _, tgt, inph, per_term = _fom_inputs(
        g, dryrun.LAM, 9, None, torch.complex128)
    eps_p, eps_g, lam, ux, ng, cth, w = per_term
    step = parallel.sharded_fom_and_grad(one, orders, n_s, tgt, inph,
                                         taylor_terms=n_t)
    fom, grad = step(xy, [g.grating_period] * 2, [g.lateral_period] * 2,
                     g.cyl_height, eps_p, eps_g, lam, [ux] * 2, ng,
                     [cth] * 2, w)
    vg = fom_value_and_grad(g, dryrun.LAM, 9, device="cpu")
    ref = [vg(x) for x in xy]
    want = sum(f.item() for f, _ in ref) / 2
    assert len(tgt) == 2 and abs(fom.item() - want) <= 1e-10 * abs(want)
    assert _rel(grad.numpy(), np.stack([gr.numpy() / 2
                                        for _, gr in ref])) <= 1e-10


def test_sweep_matches_jax(world, sweep):
    p, (tgt, inph, args) = sweep
    assert len(set(args[1])) == 2                    # two periods
    assert _grazing_margin(p, args) >= 1e-3
    mesh = jpar.make_mesh(devices=jax.devices()[:2])
    fn = jpar.sharded_fom_and_grad(mesh, p["orders"], p["n_slabs"], tgt,
                                   inph, taylor_terms=p["taylor"])
    xyrra, Lx, Ly, h, eps_p, eps_g, lam, ux, ng, cth, w = args
    fom, grad = fn(jnp.asarray(xyrra), jnp.asarray(Lx), jnp.asarray(Ly), h,
                   jcpx.from_np(eps_p), jcpx.from_np(eps_g),
                   jnp.asarray(lam), jnp.asarray(ux), jnp.asarray(ng),
                   jnp.asarray(cth), jnp.asarray(w))
    assert abs(world["sweep_fom"] - float(fom)) <= 1e-10 * abs(float(fom))
    assert _rel(world["sweep_grad"], np.asarray(grad)) <= 1e-10


@pytest.fixture(scope="module")
def char_data():
    """``characterize_grating`` of each of the dry run's two members."""
    return [characterize_grating(g, wavelength=dryrun.LAM,
                                 numG=dryrun.CHAR_NUMG, device="cpu",
                                 **dryrun.CHAR_DIRECTIONS)
            for g in dryrun.characterize_members()]


def test_characterize_matches_characterize_grating(world, char_data):
    """Two periods in one batch, each on its own order set."""
    members = dryrun.characterize_members()
    ampf, ampr = world["char_ampf"], world["char_ampr"]
    numG = dryrun.CHAR_NUMG
    sets = [ordmod.select_orders(g.grating_period, g.lateral_period, numG)
            for g in members]
    assert not np.array_equal(*sets)
    _, _, _, _, _, _, _, ux, uy = dryrun.characterize_inputs(members)
    n_checked = 0
    for m, (data, orders) in enumerate(zip(char_data, sets)):
        for e in data:
            b = next(b for b in range(m, len(ux), 2)
                     if ux[b] == e["ux"] and uy[b] == e["uy"])
            i = ordmod.order_index(orders, e["ox"], e["oy"])
            p = 0 if e["x_or_y"] == "y" else 1
            got = (ampf[b, p, i], ampf[b, p, i + numG], ampr[b, p, i],
                   ampr[b, p, i + numG])
            want = (e["ampfy"], e["ampfx"], e["ampry"], e["amprx"])
            assert np.abs(np.subtract(got, want)).max() <= 1e-12
            n_checked += 1
    assert n_checked > 50


def test_characterize_on_shared_orders(world, one, char_data):
    """The JAX package's form: one order set and slab schedule for both
    periods.  The world against one rank on every cell, and the first
    period's cells against ``characterize_grating`` there."""
    members = dryrun.characterize_members()
    orders, n_slabs, taylor = dryrun.characterize_shared_config(
        torch.complex128)
    cin = dryrun.characterize_inputs(members)
    ampf, ampr = parallel.sharded_characterize_amps(
        one, orders, n_slabs, taylor_terms=taylor)(*cin)
    assert ampf.shape == (len(cin[0]), 2, 2 * dryrun.CHAR_NUMG)
    assert _rel(world["char_shared_ampf"], ampf.numpy()) <= 1e-12
    assert _rel(world["char_shared_ampr"], ampr.numpy()) <= 1e-12
    assert not np.array_equal(world["char_shared_ampf"][1::2],
                              world["char_ampf"][1::2])
    ux, uy, N = cin[7], cin[8], len(orders)
    for e in char_data[0]:
        b = next(b for b in range(0, len(ux), 2)
                 if ux[b] == e["ux"] and uy[b] == e["uy"])
        i = ordmod.order_index(orders, e["ox"], e["oy"])
        p = 0 if e["x_or_y"] == "y" else 1
        got = (world["char_shared_ampf"][b, p, i],
               world["char_shared_ampf"][b, p, i + N],
               world["char_shared_ampr"][b, p, i],
               world["char_shared_ampr"][b, p, i + N])
        want = (e["ampfy"], e["ampfx"], e["ampry"], e["amprx"])
        assert np.abs(np.subtract(got, want)).max() <= 1e-12


@pytest.fixture(scope="module")
def stitched():
    lps, lcs, hgs, pts = dryrun.tiny_lens("cpu")
    return pts, build_nearfield(0.0, 0.0, -10e-6, "x", dryrun.LAM, lps, lcs,
                                hgs, pts, pts, dipole_moment=1e-30,
                                device="cpu")


def test_stitch_matches_build_nearfield(world, stitched):
    _, ref = stitched
    for got, want in zip(world["nf_fields"], ref[:4]):
        assert np.abs(got - want.numpy()).max() <= \
            1e-12 * np.abs(want.numpy()).max()
    assert abs(world["nf_power"] - ref[6]) <= 1e-12 * ref[6]


def test_fft2_matches_torch(world):
    want = torch.fft.fft2(torch.as_tensor(dryrun.fft_field())).numpy()
    assert _rel(world["fft_out"], want) <= 1e-12


def test_fft2_matches_jax(world):
    mesh = jpar.make_mesh(devices=jax.devices()[:2])
    got = jcpx.to_np(jpar.fft2_sharded(mesh)(
        jcpx.from_np(dryrun.fft_field())))
    assert _rel(world["fft_out"], got) <= 1e-12


def test_farfield_matches_farfield(world, stitched):
    pts, ref = stitched
    P, total, *_ = tff.farfield(*world["nf_fields"], pts, pts, dryrun.LAM,
                                ref[7], device="cpu")
    P = P.numpy()
    fin = np.isfinite(P)
    assert (np.isfinite(world["ff_P"]) == fin).all()
    assert _rel(world["ff_P"][fin], P[fin]) <= 1e-12
    assert abs(world["ff_total"] - total) <= 1e-12 * total


def test_design_matches_each_member_alone(world):
    """Each member alone: optimize_fused(seed=i), then
    optimize2_fused(seed=i + 1) with the dry run's attempts, both to a
    stall.  The members share one static configuration, so the world maxed
    nothing across its ranks; the chain standardizes its member between
    the two stages, which moves a negative coordinate by rounding only."""
    members, terms = dryrun.design_members(2)
    configs = set()
    for g in members:
        o, ns, tt, *_ = _fom_inputs(g, dryrun.LAM, dryrun.DESIGN_NUMG,
                                    terms, torch.complex128)
        configs.add(_order_bounds(o) + (ns, tt))
    assert len(configs) == 1
    caps = dryrun.DESIGN_CAPS
    for i, g in enumerate(members):
        kw = dict(numG=dryrun.DESIGN_NUMG, terms=terms, verbose=False,
                  similar_to=g.xyrra_list, how_similar=caps["how_similar"],
                  device="cpu")
        g1 = optimize_fused(g, dryrun.LAM, seed=i, **kw)
        g2 = optimize2_fused(g1, dryrun.LAM, attempts=caps["attempts"],
                             seed=i + 1, **kw)
        assert not np.array_equal(g2.xyrra_list, g.xyrra_list)
        np.testing.assert_allclose(g2.xyrra_list, world["design_xyrra"][i],
                                   rtol=1e-12, atol=1e-21)


def test_one_rank_mesh_and_distributed_helpers(one):
    assert (one.rank, one.size, one.shape) == (0, 1, {"cells": 1})
    assert one.device == torch.device("cpu") and one.block(6) == (0, 6)
    z = torch.randn(3, 2, dtype=torch.complex128)
    assert torch.equal(one.all_gather(z), z) and torch.equal(
        one.all_to_all(z[None])[0], z)
    assert torch.equal(one.all_reduce(z), z) and one.any(True)
    assert one.all_gather_object({"a": 1}) == [{"a": 1}]
    parallel.init_distributed()                # one process: a no-op
    assert not torch.distributed.is_initialized()
    assert parallel.host_slice(8) == (0, 8)
    parallel.multihost_barrier()
    tree = {"a": np.arange(3.0), "b": [np.ones(2), 1.5]}
    for fn in (parallel.global_batch_from_host_shards,
               parallel.replicate_to_mesh):
        out = fn(one, tree)
        assert torch.equal(out["a"], torch.arange(3.0, dtype=torch.float64))
        assert out["b"][1].item() == 1.5
    with pytest.raises(ValueError):
        parallel.make_mesh(shape=(2,), device="cpu")
    with pytest.raises(ValueError):
        parallel.make_mesh(devices=["cpu", "cpu"])
    assert parallel.__all__ == jpar.__all__


def test_entry_forward_matches_the_full_smatrix():
    fn, (xy, ux) = dryrun.entry(device="cpu")
    fom = fn(xy, ux)
    assert fom.shape == (4,) and torch.isfinite(fom).all()
    p = dryrun._tiny_problem(numG=25, B=4)
    o = p["orders"]
    N, i0 = len(o), ordmod.order_index(o, 0, 0)
    im1 = ordmod.order_index(o, -1, 0)
    for b in range(4):
        S, _, _ = rcwa.cell_smatrix(
            o, xy[b:b + 1], dryrun.LX, dryrun.LY, dryrun.H, dryrun.NT ** 2,
            dryrun.NG ** 2, dryrun.LAM, ux[b:b + 1], 0.0,
            n_slabs=p["n_slabs"], taylor_terms=p["taylor"], fff=True)
        # incidence (ux > 0, 0): s is (c_y, c_x) = (-uz, 0), p is (0, 1)
        uz = torch.sqrt(1 - ux[b] ** 2)
        amp_s = S.s11[0, im1, i0] * uz
        amp_p = S.s11[0, im1 + N, i0 + N]
        want = ((amp_s.imag.abs() * amp_s.imag + amp_p.imag.abs()
                 * amp_p.imag) / (dryrun.NG * uz) / 2)
        assert abs(fom[b].item() - want.item()) <= 1e-12


def test_dryrun_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--ranks", "1"])           # the command line's default
