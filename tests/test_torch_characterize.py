"""Port parity of the amplitude databases (metalens_tpu_torch against
metalens_tpu at float64 on the CPU): characterize_grating through
GratingCollection.characterize (a joint 450/580 nm sweep, then 650 nm
appended), the just_normal HexGridSet sweep with its phase library and
repr, both interpolation-table functions and their weight/gather halves,
npz files across the two packages, and the per-cell wavelength path of the
cell solve.  One JAX run per configuration is shared by a module fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalens_tpu import Grating as JGrating, GratingCollection as JCollection
from metalens_tpu import characterize as jchar
from metalens_tpu import serialization as jser
from metalens_tpu.hexgrid import HexGridSet as JHexGridSet
from metalens_tpu.units import nm
from metalens_tpu_torch import HexGridSet as THexGridSet, engine as tengine
from metalens_tpu_torch import characterize as tchar
from metalens_tpu_torch import serialization as tser
from metalens_tpu_torch.convert import (collection_from_reference,
                                        grating_from_reference,
                                        hexgrid_from_reference)
from metalens_tpu_torch.solver import orders as tord, rcwa as trcwa

torch.set_num_threads(1)

# Periods and incidences where the two packages agree to 1e-13: no kept
# order comes within 6e-3 of the air light cone.  At other periods
# (1100 nm at 650 nm, 1400 nm at 580 nm) the two packages differ by up to
# 1e-9: there the JAX package's unpivoted inverse on the CPU and LAPACK's
# pivoted one round differently, and the S-matrix assembly amplifies it.
PERIODS_NM = (1250.0, 1350.0)
NUMG = 16
NUMG_HEX = 12
AMPS = ("ampfy", "ampfx", "ampry", "amprx")
KEYS = ("wavelength_in_nm", "x_or_y", "ux", "uy", "ox", "oy") + AMPS


def _jax_collection():
    gs = [JGrating(lateral_period=320 * nm, cyl_height=550 * nm,
                   grating_period=gp * nm,
                   xyrra_list_in_nm_deg=np.array(
                       [[gp / 10, 0., 100., 90., 0.],
                        [-gp / 4, 5., 110., 80., 10.]]))
          for gp in PERIODS_NM]
    return JCollection(target_wavelength=580 * nm, lateral_period=320 * nm,
                       lens_type="cyl", grating_list=gs)


@pytest.fixture(scope="module")
def collections():
    """One 2-member collection characterized by each package: 450 and
    580 nm in one joint sweep, then 650 nm appended."""
    jgc = _jax_collection()
    tgc = collection_from_reference(jgc)
    for gc, kw in ((jgc, {}), (tgc, {"device": "cpu"})):
        gc.characterize([450 * nm, 580 * nm], numG=NUMG, u_steps=2, **kw)
        gc.characterize(650 * nm, numG=NUMG, u_steps=2, append=True, **kw)
    return jgc, tgc


@pytest.fixture(scope="module")
def hexgrids():
    """A 3-entry HexGridSet characterized by each package (just_normal).
    Its members are the constructor's cells with the second pillar moved
    1.5 nm off its hexagonal site.  On the exact site some raster points
    of the NV normal field lie exactly on the bisector between the two
    pillars, so the nearest-pillar choice there is decided by rounding:
    the JAX package's jitted projector differs from its own eager
    evaluation by 7.4e-4 on these cells, and the port agrees with the
    eager one to 3e-14."""
    default = JHexGridSet(sep=320 * nm, cyl_height=550 * nm, num_entries=3)
    assert repr(THexGridSet(sep=320 * nm, cyl_height=550 * nm,
                            num_entries=3)) == repr(default)
    members = []
    for g in default.grating_list:
        g = g.copy()
        g.xyrra_list[1, :2] += [1.3 * nm, -0.7 * nm]
        members.append(g)
    jh = JHexGridSet(sep=320 * nm, cyl_height=550 * nm,
                     grating_list=members)
    th = hexgrid_from_reference(jh)
    assert repr(th) == repr(jh)
    jh.characterize(wavelength=580 * nm, numG=NUMG_HEX, just_normal=True)
    th.characterize(wavelength=580 * nm, numG=NUMG_HEX, just_normal=True,
                    device="cpu")
    return jh, th


def _assert_same_database(want, got, tol):
    assert len(got) == len(want)
    worst = 0.0
    for a, b in zip(want, got):
        assert list(b) == list(a)
        for k in KEYS[:6]:
            assert b[k] == a[k] and type(b[k]) is type(a[k]), (k, a, b)
        for k in AMPS:
            assert type(b[k]) is complex
            worst = max(worst, abs(b[k] - a[k]))
    assert worst < tol, worst


def test_collection_characterize_matches_jax(collections):
    jgc, tgc = collections
    for jg, tg in zip(jgc.grating_list, tgc.grating_list):
        assert {e["wavelength_in_nm"] for e in tg.data} == {450., 580., 650.}
        _assert_same_database(jg.data, tg.data, 1e-10)
        orders = tord.select_orders(tg.grating_period, tg.lateral_period,
                                    NUMG)
        for e in tg.data:     # every kept order clear of the light cone
            lam = e["wavelength_in_nm"] * nm
            k = np.hypot(e["ux"] + e["ox"] * lam / tg.grating_period,
                         e["uy"] + e["oy"] * lam / tg.lateral_period)
            assert abs(k - 1.0) > 1e-3
            assert (e["ox"], e["oy"]) in set(map(tuple, orders.tolist()))


def test_characterize_entry_points_agree(collections):
    """The engine call, Grating.characterize, the process handle of
    run_lua_initiate and run_lua_getresult give the same database."""
    _, tgc = collections
    tg = tgc.grating_list[0].copy()
    kw = dict(ux_min=0.3, ux_max=0.5, uy_min=-0.1, uy_max=0.1, u_steps=2,
              wavelength=580 * nm, numG=8)
    direct = tengine.characterize_grating(tg, device="cpu", **kw)
    assert tg.characterize(device="cpu", **kw) == direct == tg.data
    h = tg.run_lua_initiate(numG=8, device="cpu", **{
        k: v for k, v in kw.items() if k != "numG"})
    tg.data = []
    assert tg.characterize(process=h) == direct == tg.data
    assert tg.run_lua_getresult(h) == direct
    assert tg.run_lua(numG=8, device="cpu", **{
        k: v for k, v in kw.items() if k != "numG"}) == direct


def test_hexgrid_matches_jax(hexgrids):
    jh, th = hexgrids
    for jg, tg in zip(jh.grating_list, th.grating_list):
        _assert_same_database(jg.data, tg.data, 1e-10)
    assert th.x_amp_list.dtype == jh.x_amp_list.dtype
    np.testing.assert_allclose(th.x_amp_list, jh.x_amp_list, rtol=0,
                               atol=1e-10)
    for phi in np.linspace(-np.pi, np.pi, 41):
        assert th.pick_from_phase(phi) == jh.pick_from_phase(phi)
    # the repr format, on the same state
    assert repr(hexgrid_from_reference(jh)) == repr(jh)
    with pytest.raises(ValueError, match="characterize"):
        THexGridSet(sep=320 * nm, cyl_height=550 * nm,
                    num_entries=3).pick_from_phase(0.0)


def _random_points(bounds, rng, m=200):
    lo, hi = np.array(bounds[0::2]), np.array(bounds[1::2])
    span = np.where(hi > lo, hi - lo, 0.1)    # a length-1 axis: off it too
    # in bounds, plus a margin on each side that the clamping must handle
    return lo - 0.05 * span + rng.random((m, len(lo))) * 1.1 * span


def _one_direction(jgc):
    """The collection with each member's database cut to its first
    direction: length-1 ux and uy axes."""
    first = (jgc.grating_list[0].data[0]["ux"],
             jgc.grating_list[0].data[0]["uy"])
    members = []
    for g in jgc.grating_list:
        g = g.copy()
        g.data = [e for e in g.data if (e["ux"], e["uy"]) == first]
        members.append(g)
    return JCollection(target_wavelength=jgc.target_wavelength,
                       lateral_period=jgc.lateral_period, lens_type="cyl",
                       grating_list=members)


@pytest.mark.parametrize("kind", ["collection", "collection_one_direction",
                                  "hexgrid"])
def test_interpolator_tables_match_jax(collections, hexgrids, kind):
    """Both table functions on the JAX package's own data dicts, against
    the JAX ones: the same keys, bounds, axes and tables; the same values at
    random points (some beyond the bounds, and off a length-1 axis) for a
    few keys, each table of its own; and the stored entries at the grid
    nodes."""
    if kind.startswith("collection"):
        jobj = collections[0]
        if kind == "collection_one_direction":
            jobj = _one_direction(jobj)
        tobj = collection_from_reference(jobj)
        jint, jb = jchar.build_collection_interpolators(jobj)
        tint, tb = tobj.build_interpolators(device="cpu"), \
            tobj.interpolator_bounds
    else:
        jobj = hexgrids[0]
        tobj = hexgrid_from_reference(jobj)
        jint, jb = jchar.build_hexgrid_interpolators(jobj)
        tint, tb = tobj.build_interpolators(device="cpu"), \
            tobj.interpolator_bounds
    assert tb == jb and list(tint) == list(jint)
    rng = np.random.default_rng(3)
    pts = _random_points(jb, rng)
    # AmpInterpolator.__call__ of the JAX package, compiled once for all keys
    jax_interp = jax.jit(lambda v, g, p: jchar.interp_multi(v[None], g, p))
    for i, key in enumerate(jint):
        f, jf = tint[key], jint[key]
        assert f.values.dtype == torch.complex128
        for a, b in zip(f.grids, jf.grids):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jv = np.asarray(jf.values)
        np.testing.assert_array_equal(f.values.numpy(),
                                      jv[..., 0] + 1j * jv[..., 1])
        nodes = np.stack(np.meshgrid(*[g.numpy() for g in f.grids],
                                     indexing="ij"), -1).reshape(-1, 3)
        np.testing.assert_allclose(f(nodes), f.values.numpy().ravel(),
                                   rtol=0, atol=1e-15)
        if i % max(1, len(jint) // 4) == 0:
            got = f(pts)
            assert isinstance(got, np.ndarray) and got.shape == (len(pts),)
            want = jax_interp(jf.values, jf.grids, jnp.asarray(pts))
            np.testing.assert_allclose(
                got, np.asarray(want.re[0]) + 1j * np.asarray(want.im[0]),
                rtol=0, atol=1e-12)
            assert f.on_device(pts[0]).shape == (1,)


def test_interp_weights_and_gather_match_jax():
    """The weight and gather halves on random grids with a degenerate
    axis, against the JAX functions; the gather's (re, im) channel of the
    JAX version is the complex value here."""
    rng = np.random.default_rng(5)
    grids = [np.sort(rng.random(4)), np.array([0.25]),
             np.cumsum(rng.random(3) + 0.1)]
    vals = (rng.normal(size=(2, 4, 1, 3))
            + 1j * rng.normal(size=(2, 4, 1, 3)))
    pts = np.stack([rng.random(50) * 1.4 - 0.2, rng.random(50) * 9.0,
                    rng.random(50) * 2.5], axis=1)
    jgrids = [jnp.asarray(g) for g in grids]
    tgrids = [torch.as_tensor(g) for g in grids]
    ji, jw = jax.jit(jchar.interp_weights)(jgrids, jnp.asarray(pts))
    ti, tw = tchar.interp_weights(tgrids, torch.as_tensor(pts))
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-15)
    jv = jnp.asarray(np.stack([vals.real, vals.imag], axis=-1))
    want = jax.jit(jchar.interp_gather)(jv, jgrids, ji, jw)
    got = tchar.interp_gather(torch.as_tensor(vals), tgrids, ti, tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.re)
                               + 1j * np.asarray(want.im), rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        tchar.interp_multi(torch.as_tensor(vals), tgrids,
                           torch.as_tensor(pts)).numpy(), got.numpy(),
        rtol=0, atol=0)
    f = tchar.AmpInterpolator((np.array([0.5]), np.array([0.0, 1.0])),
                              np.array([[1 + 1j, 3 + 3j]]), device="cpu")
    assert abs(f(np.array([[123.0, 0.5]]))[0] - (2 + 2j)) < 1e-12


@pytest.mark.parametrize("kind", ["collection", "hexgrid"])
def test_npz_across_packages(collections, hexgrids, tmp_path, kind):
    """A database saved by one package loads in the other, unchanged."""
    jobj, tobj = collections if kind == "collection" else hexgrids
    for save, load, obj in ((tser.save, jser.load, tobj),
                            (jser.save, tser.load, jobj)):
        back = load(save(obj, str(tmp_path / f"{kind}-{id(obj)}")))
        assert type(back).__name__ == type(obj).__name__
        assert repr(back) == repr(obj)
        for a, b in zip(obj.grating_list, back.grating_list):
            assert b.data == a.data
            np.testing.assert_array_equal(b.xyrra_list, a.xyrra_list)
        if kind == "hexgrid":
            np.testing.assert_array_equal(back.x_amp_list, obj.x_amp_list)
    g = grating_from_reference(jobj.grating_list[0])
    assert g.data == jobj.grating_list[0].data
    assert tser.load(g.save(str(tmp_path / "g"))).data == g.data


def test_cell_solve_takes_a_wavelength_per_cell():
    """cell_amplitudes_with_eps with (B,) wavelengths and glass
    permittivities equals the per-wavelength calls; a number gives what a
    constant (B,) tensor gives, and a given Einv what the solve's own
    inverse gives."""
    lp, gp, h = 320 * nm, 1250 * nm, 550 * nm
    orders = tord.select_orders(gp, lp, 10)
    i0 = tord.order_index(orders, 0, 0)
    c = torch.zeros(20, 2, dtype=torch.complex128)
    c[i0, 0] = c[i0 + 10, 1] = 1.0
    xy = torch.tensor([[[125e-9, 0., 100e-9, 90e-9, 0.]]],
                      dtype=torch.float64)
    E, M = trcwa.build_layer_eps(orders, gp, lp, xy, 2.4 ** 2, fff=True)
    lams = [450 * nm, 580 * nm, 650 * nm]
    eps_g = [1.47 ** 2, 1.46 ** 2, 1.455 ** 2]
    ux, uy = 0.31, -0.07
    kw = dict(n_slabs=4, taylor_terms=16, M_blocks=M)
    one = [trcwa.cell_amplitudes_with_eps(orders, E, gp, lp, h, eg, lam, ux,
                                          uy, c, **kw)[:2]
           for lam, eg in zip(lams, eps_g)]
    rep = [x.expand(3, -1, -1) for x in (E,) + M]
    Einv = trcwa.invert_eps(E).expand(3, -1, -1)
    for einv in (None, Einv):
        af, ar, _, _ = trcwa.cell_amplitudes_with_eps(
            orders, rep[0], gp, lp, h,
            torch.tensor(eps_g, dtype=torch.complex128),
            torch.tensor(lams, dtype=torch.float64), ux, uy, c, n_slabs=4,
            taylor_terms=16, M_blocks=tuple(rep[1:]), Einv=einv)
        for b, (f1, r1) in enumerate(one):
            assert (af[b] - f1[0]).abs().max() < 1e-12
            assert (ar[b] - r1[0]).abs().max() < 1e-12
    scalar = trcwa.cell_amplitudes_with_eps(orders, E, gp, lp, h, eps_g[1],
                                            lams[1], ux, uy, c, **kw)
    tensor = trcwa.cell_amplitudes_with_eps(
        orders, E, gp, lp, h, torch.tensor([eps_g[1]], dtype=torch.complex128),
        torch.tensor([lams[1]], dtype=torch.float64), ux, uy, c, **kw)
    for a, b in zip(scalar[:2], tensor[:2]):
        assert (a - b).abs().max() < 1e-12


def test_database_entry_points_default_to_cuda(monkeypatch, collections,
                                                hexgrids):
    """Called without device=, characterize and the interpolators run on
    CUDA: where torch has no CUDA device they raise instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tgc, th = collections[1], hexgrids[1]
    tg = tgc.grating_list[0]
    calls = (
        lambda: tengine.characterize_grating(tg, 0.1, 0.2, 0.0, 0.0, 2,
                                             580 * nm, 8),
        lambda: tg.copy().characterize(numG=8),
        lambda: tgc.characterize(580 * nm, numG=8),
        lambda: tgc.build_interpolators(),
        lambda: THexGridSet(sep=320 * nm, cyl_height=550 * nm,
                            num_entries=2).characterize(numG=8),
        lambda: th.build_interpolators(),
        lambda: tchar.AmpInterpolator([[0.0, 1.0]], [1j, 2j]),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
