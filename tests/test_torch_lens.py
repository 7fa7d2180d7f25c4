"""Port parity of the lens check (metalens_tpu_torch against metalens_tpu
at float64 on the CPU): assembly, the real-space field reconstruction, the
near-field stitch and the far field with its focal metrics, plus the
JAX-free oracles of the JAX package's own near- and far-field tests.

The databases are characterized once, by the port on the CPU at small
numG, and written with the port's ``save``; the JAX package reads the same
npz files with its ``load``, so both packages stitch identical databases
and no JAX characterize program is compiled."""

import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import metalens_tpu
from metalens_tpu import assembly as jasm, farfield as jff, nearfield as jnf
from metalens_tpu.solver import cpx as jcpx, fields as jfields
from metalens_tpu_torch import (Grating, GratingCollection, HexGridSet,
                                assembly as tasm, nearfield as tnf,
                                units as nu)
from metalens_tpu_torch.solver import fields as tfields

# the package exports the function farfield under the module's name
tff = importlib.import_module("metalens_tpu_torch.farfield")

torch.set_num_threads(1)

nm, um, degree = 1e-9, 1e-6, math.pi / 180
LAM = 580 * nm
NG = 1.459
NUMG = 10
D = 10 * um                       # source distance
RADIUS = 5.5 * um
BRACKET = (15.0 * degree, 32.0 * degree)
N_AP = 48                         # aperture points per side


def _round_collection(lo, hi, n_members=3):
    """A round-lens collection over [lo, hi] with simple two-pillar cells
    (``tests/test_full_lens.py::make_round_collection``, in the port)."""
    angles = np.linspace(lo, hi, n_members)
    lp_over_tan = 320 * nm / math.tan(angles[len(angles) // 2])
    gs = []
    for ang in angles:
        gp = LAM / math.sin(ang)
        frac = (ang - angles[0]) / (angles[-1] - angles[0])
        gs.append(Grating(
            lateral_period=lp_over_tan * math.tan(ang), cyl_height=550 * nm,
            grating_period=gp, xyrra_list_in_nm_deg=np.array(
                [[-gp / nm / 4, 0.0, 90.0 + 5 * frac, 70.0, 0.0],
                 [gp / nm / 4, 0.0, 70.0, 80.0 + 5 * frac, 0.0]])))
    return GratingCollection(target_wavelength=LAM,
                             lateral_period=lp_over_tan, lens_type="round",
                             grating_list=gs)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 3-member round collection and a 3-entry HexGridSet (second pillar
    1.5 nm off its tie site, as in tests/test_torch_characterize.py),
    characterized by the port at numG = 10, u_steps = 2, and the same
    databases loaded by the JAX package; interpolators built in both."""
    tgc = _round_collection(*BRACKET)
    tgc.characterize(LAM, numG=NUMG, u_steps=2, device="cpu")
    hgs = HexGridSet(sep=320 * nm, cyl_height=550 * nm, num_entries=3)
    for g in hgs.grating_list:
        g.xyrra_list[1, :2] += [1.3 * nm, -0.7 * nm]
    hgs.characterize(wavelength=LAM, numG=NUMG, just_normal=False,
                     u_steps=2, device="cpu")
    d = tmp_path_factory.mktemp("lens")
    jgc = metalens_tpu.load(tgc.save(d / "gc.npz"))
    jhgs = metalens_tpu.load(hgs.save(d / "hgs.npz"))
    for obj in (tgc, hgs):
        obj.build_interpolators(device="cpu")
    for obj in (jgc, jhgs):
        obj.build_interpolators()
    return {"jax": (jgc, jhgs), "torch": (tgc, hgs)}


def _designs(dbs, make_xyrra_list=False):
    out = {}
    for pkg, asm in (("jax", jasm), ("torch", tasm)):
        gc, hgs = dbs[pkg]
        out[pkg] = asm.make_design([[BRACKET, gc]], D, RADIUS, hgs,
                                   make_xyrra_list=make_xyrra_list)
    return out


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and want.size
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_target_phase_and_hex_grids_match_jax():
    r = np.linspace(0, 40 * um, 301)
    _close(tasm.target_phase(r, D), jasm.target_phase(r, D))
    _close(tasm.target_phase_zeros(20 * um, D, 450 * nm),
           jasm.target_phase_zeros(20 * um, D, 450 * nm))
    for fourfold in (True, False):
        _close(tasm.hexagonal_grid(320 * nm, 2.3 * um, fourfold),
               jasm.hexagonal_grid(320 * nm, 2.3 * um, fourfold))


def test_design_periphery_matches_jax(dbs):
    lps = {pkg: asm.design_periphery([[BRACKET, dbs[pkg][0]]], D, RADIUS)
           for pkg, asm in (("jax", jasm), ("torch", tasm))}
    assert lps["torch"]["gratingcollection_list"] == [dbs["torch"][0]]
    assert set(lps["torch"]) == set(lps["jax"])
    for k, v in lps["jax"].items():
        if k != "gratingcollection_list":
            _close(lps["torch"][k], v)
    assert len(lps["torch"]["r_center_list"]) == 2


def test_make_design_matches_jax(dbs):
    out = _designs(dbs, make_xyrra_list=True)
    (jlps, jlcs, jr, jxy), (tlps, tlcs, tr, txy) = out["jax"], out["torch"]
    assert tr == jr and len(tlcs) > 300
    np.testing.assert_array_equal(tlcs[:, 2], jlcs[:, 2])   # member indices
    _close(tlcs, jlcs)
    _close(txy, jxy)
    _close(tasm.make_center_xyrra_list(dbs["torch"][1], tlcs),
           jasm.make_center_xyrra_list(dbs["jax"][1], jlcs))
    _close(tasm.make_periphery_xyrra_list(tlps),
           jasm.make_periphery_xyrra_list(jlps))


@pytest.mark.parametrize("pol", ["x", "y"])
def test_fields_from_data_matches_jax(dbs, pol):
    tg, jg = dbs["torch"][0].grating_list[1], dbs["jax"][0].grating_list[1]
    ux0, uy0 = tg.data[0]["ux"], tg.data[0]["uy"]
    one = [e for e in tg.data if (e["ux"], e["uy"]) == (ux0, uy0)]
    for z in (-0.3 * um, tg.cyl_height + 0.4 * um):
        for x, y in ((0.0, 0.0), (0.21 * um, -0.05 * um)):
            got = tfields.fields_from_data(tg, one, x, y, z, pol)
            want = jfields.fields_from_data(jg, one, x, y, z, pol)
            for a, b in zip(got, want):
                _close(a, b)
    got = tfields.field_map(tg, one, -0.2 * um, pol, n_points=5)
    want = jfields.field_map(jg, one, -0.2 * um, pol, n_points=5)
    for a, b in zip(got, want):
        _close(a, b)
    with pytest.raises(ValueError, match="inside the pillar layer"):
        tfields.fields_from_data(tg, one, 0.0, 0.0, tg.cyl_height / 2, pol)


def test_hex_site_lookup_matches_bruteforce(dbs):
    """The analytic lookup against numpy brute force inside the centre
    (tests/test_nearfield.py:31), a query far from every site reports a
    miss (:98), and the stitch repairs a patch of misses to the true
    nearest site whatever the order of the sites (:118)."""
    hgs = dbs["torch"][1]
    summary = _designs(dbs)["torch"][1]
    sep = hgs.sep
    table, n1_min, n2_min = tnf._hex_site_table(summary, sep, "cpu")
    site_xy = torch.as_tensor(summary[:, 0:2])
    pts = np.random.default_rng(3).uniform(-3.5e-6, 3.5e-6, size=(900, 2))
    r_valid = np.hypot(summary[:, 0], summary[:, 1]).max() + sep
    pts = pts[np.hypot(pts[:, 0], pts[:, 1]) < r_valid][:500]
    rows, found = tnf._nearest_center_site(
        torch.as_tensor(pts[:, 0]), torch.as_tensor(pts[:, 1]), table,
        n1_min, n2_min, sep, site_xy)
    assert bool(found.all())
    d_all = ((pts[:, None, :] - summary[None, :, 0:2]) ** 2).sum(-1)
    np.testing.assert_allclose(
        np.sqrt(d_all[np.arange(len(pts)), rows.numpy()]),
        np.sqrt(d_all.min(axis=1)), atol=1e-12)

    sparse = summary[summary[:, 0] < -0.5e-6]
    table, n1_min, n2_min = tnf._hex_site_table(sparse, sep, "cpu")
    rows, found = tnf._nearest_center_site(
        torch.tensor([2.0e-6, sparse[0, 0]]),
        torch.tensor([2.0e-6, sparse[0, 1]]), table, n1_min, n2_min, sep,
        torch.as_tensor(sparse[:, 0:2]))
    assert found.tolist() == [False, True] and int(rows[1]) == 0

    x_pts = np.linspace(1.2e-6, 1.9e-6, 8)
    y_pts = np.linspace(-0.3e-6, 0.3e-6, 8)
    X, Y = np.meshgrid(x_pts, y_pts, indexing="ij")
    _, found = tnf._nearest_center_site(
        torch.as_tensor(X), torch.as_tensor(Y), table, n1_min, n2_min, sep,
        torch.as_tensor(sparse[:, 0:2]))
    assert not bool(found.any())          # the patch needs the repair
    kw = dict(source_x=0.0, source_y=0.0, source_z=-np.inf, source_pol="x",
              wavelength=LAM, lens_periphery_summary=None, hexgridset=hgs,
              x_pts=x_pts, y_pts=y_pts, dipole_moment=1.0, device="cpu")
    Ex_a = tnf.build_nearfield(lens_center_summary=sparse, **kw)[0]
    Ex_b = tnf.build_nearfield(lens_center_summary=sparse[::-1].copy(),
                               **kw)[0]
    assert bool(torch.isfinite(Ex_a).all()) and Ex_a.abs().max() > 0
    np.testing.assert_allclose(Ex_a.numpy(), Ex_b.numpy(), atol=1e-15)


LENSES = {
    # periphery + centre, an 'x' dipole at the design distance
    "periphery_dipole": dict(source_z=-D, source_pol="x",
                             dipole_moment=1e-30),
    # centre only, a normally incident plane wave
    "center_plane_wave": dict(source_z=-np.inf, source_pol="y",
                              dipole_moment=1.0),
}


@pytest.fixture(scope="module")
def stitched(dbs):
    """Both packages' near fields of each lens of LENSES on a 48 x 48
    aperture."""
    designs = _designs(dbs)
    out = {}
    for case, kw in LENSES.items():
        out[case] = {}
        for pkg, nf in (("jax", jnf), ("torch", tnf)):
            lps, lcs, _ = designs[pkg]
            if case == "center_plane_wave":
                lps = None
            half = (tnf._lens_max_radius(lps, lcs, dbs[pkg][1])
                    if lps is None else 6.3 * um)
            pts = np.linspace(-half, half, N_AP)
            extra = {"device": "cpu"} if pkg == "torch" else {}
            out[case][pkg] = nf.build_nearfield(
                0.0, 0.0, kw["source_z"], kw["source_pol"], LAM, lps, lcs,
                dbs[pkg][1], pts, pts, dipole_moment=kw["dipole_moment"],
                **extra)
    return out


@pytest.mark.parametrize("case", sorted(LENSES))
def test_build_nearfield_matches_jax(stitched, case):
    jout, tout = stitched[case]["jax"], stitched[case]["torch"]
    for name, t, j in zip(("Ex", "Ey", "Hx", "Hy"), tout[:4], jout[:4]):
        assert t.dtype == torch.complex128 and t.shape == (N_AP, N_AP)
        want = jcpx.to_np(j)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(t.numpy() - want).max() <= 1e-10 * scale, name
    assert tout[6] > 0
    assert abs(tout[6] - jout[6]) <= 1e-12 * abs(jout[6])
    assert tout[7] == jout[7]


@pytest.mark.parametrize("case", sorted(LENSES))
def test_farfield_and_focal_metrics_match_jax(stitched, case):
    jout, tout = stitched[case]["jax"], stitched[case]["torch"]
    xs, ys, ng = tout[4], tout[5], tout[7]
    tP, ttot, tux, tuy, tdux, tduy = tff.farfield(*tout[:4], xs, ys, LAM, ng,
                                                  device="cpu")
    jP, jtot, jux, juy, jdux, jduy = jff.farfield(*jout[:4], xs, ys, LAM, ng)
    jP = np.asarray(jP)
    assert tP.dtype == torch.float64
    fin = np.isfinite(jP)
    assert (np.isfinite(tP.numpy()) == fin).all()
    assert np.abs(tP.numpy()[fin] - jP[fin]).max() <= 1e-9 * jP[fin].max()
    _close(tux, jux)
    _close(tuy, juy)
    assert (tdux, tduy) == (jdux, jduy)
    assert abs(ttot - jtot) <= 1e-10 * abs(jtot)
    tm = tff.focal_metrics(tP, tux, tuy, tdux, tduy, ttot, tout[6],
                           spot_radius_u=0.15)
    jm = jff.focal_metrics(jP, jux, juy, jdux, jduy, jtot, jout[6],
                           spot_radius_u=0.15)
    assert (tm["peak_ux"], tm["peak_uy"]) == (jm["peak_ux"], jm["peak_uy"])
    for k in ("transmission", "spot_fraction_of_total"):
        assert abs(tm[k] - jm[k]) <= 1e-10, k
    assert 0 < tm["transmission"] <= 1


@pytest.mark.parametrize("y_points", [48, 50])
def test_build_nearfield_big_matches_single_call(dbs, y_points):
    """Slabs of 7 columns; 50 % 7 == 1 makes a single-column tail, which
    joins the slab before it (tests/test_nearfield.py:184)."""
    hgs = dbs["torch"][1]
    summary = _designs(dbs)["torch"][1]
    kw = dict(source_x=0.0, source_y=0.0, source_z=-25 * um,
              source_pol="y", wavelength=LAM, lens_periphery_summary=None,
              lens_center_summary=summary, hexgridset=hgs,
              x_pts=np.linspace(-2e-6, 2e-6, 48),
              y_pts=np.linspace(-2e-6, 2e-6, y_points), device="cpu")
    one = tnf.build_nearfield(**kw)
    big = tnf.build_nearfield_big(pts_at_a_time=48 * 7, progress=False, **kw)
    for a, b in zip(one[:4], big[:4]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-12)
    assert abs(one[6] - big[6]) < 1e-9 * abs(one[6])


def _plane_wave(n_pts, spacing, ux0=0.0):
    """A unit-E x-polarized plane wave in glass at direction cosine ux0 on
    the aperture plane (tests/test_farfield.py)."""
    xs = (np.arange(n_pts) - n_pts / 2) * spacing
    X, _ = np.meshgrid(xs, xs, indexing="ij")
    uz0 = np.sqrt(1 - ux0 ** 2)
    Ex = np.exp(1j * 2 * np.pi * NG / LAM * ux0 * X)
    zero = np.zeros_like(Ex)
    return Ex, zero, zero, NG / nu.Z0 * uz0 * Ex, xs, xs


@pytest.mark.parametrize("ux0", [0.0, 0.3])
def test_plane_wave_transmits_all_and_peaks_at_its_direction(ux0):
    """ux0 = 0 is the empty-aperture calibration (100%, the x2 factor);
    a tilted wave peaks at its direction and keeps its projected power."""
    n_pts, spacing = 192, LAM / 2.2
    Ex, Ey, Hx, Hy, xs, ys = _plane_wave(n_pts, spacing, ux0)
    P, total_P, ux, uy, dux, duy = tff.farfield(Ex, Ey, Hx, Hy, xs, ys, LAM,
                                                NG, device="cpu")
    power_in = (n_pts * spacing) ** 2 * NG / nu.Z0 * np.sqrt(1 - ux0 ** 2)
    assert abs(total_P / power_in - 1.0) < (1e-3 if ux0 == 0 else 2e-2)
    m = tff.focal_metrics(P, ux, uy, dux, duy, total_P, power_in)
    assert abs(m["peak_ux"] - ux0) < 2 * dux and abs(m["peak_uy"]) < 2 * duy


def _J(order, x):
    """Bessel J0/J1 by their integral representation (~1e-9 here)."""
    tau = np.linspace(0.0, np.pi, 4001)
    f = np.cos(order * tau[None, :] - np.outer(x, np.sin(tau)))
    return (f[:, :-1] + f[:, 1:]).sum(1) / 2 * (tau[1] - tau[0]) / np.pi


def test_circular_aperture_matches_airy_pattern():
    """A uniformly lit disk follows [2 J1(v)/v]^2 times the obliquity
    factor (1+uz)^2/uz, and its encircled energy 1 - J0^2 - J1^2
    (tests/test_farfield.py:183)."""
    n_pts, spacing = 256, LAM / 2.2
    xs = (np.arange(n_pts) - n_pts / 2) * spacing
    a = 12.0 * spacing
    sub = (np.arange(4) - 1.5) / 4 * spacing
    cover = np.zeros((n_pts, n_pts))
    for dx in sub:
        for dy in sub:
            X, Y = np.meshgrid(xs + dx, xs + dy, indexing="ij")
            cover += (X ** 2 + Y ** 2 < a ** 2) / 16.0
    Ex = cover.astype(complex)
    zero = np.zeros_like(Ex)
    P, _, ux, uy, _, _ = tff.farfield(Ex, zero, zero, NG / nu.Z0 * Ex, xs,
                                      xs, LAM, NG, device="cpu")
    Pz = np.where(np.isfinite(P.numpy()), P.numpy(), 0.0)
    s = np.broadcast_to(np.sqrt(ux ** 2 + uy ** 2), Pz.shape)
    kg_a = 2 * np.pi * NG / LAM * a
    v1 = 3.8317059702
    s1 = v1 / kg_a

    def encircled(v):
        return 1.0 - _J(0, [v])[0] ** 2 - _J(1, [v])[0] ** 2

    ratio = Pz[s < s1].sum() / Pz[s < 3.3 * s1].sum()
    assert abs(ratio - encircled(v1) / encircled(3.3 * v1)) < 0.01
    sel = (s > 0) & (s < 3.3 * s1)
    v = kg_a * s[sel]
    uz = np.sqrt(1 - s[sel] ** 2)
    i0, j0 = np.unravel_index(np.argmin(s), Pz.shape)
    airy = (2 * _J(1, v) / v) ** 2 * (1 + uz) ** 2 / uz * (Pz[i0, j0] / 4.0)
    assert np.linalg.norm(Pz[sel] - airy) / np.linalg.norm(airy) < 0.01


def test_high_na_grazing_bins():
    """Exact 1/uz (tests/test_farfield.py:138): with constant spectra the
    transform is analytic; a grazing bin (uz = 0) gives inf, an evanescent
    one (|u| > 1) nan, and the finite-entry sums drop both."""
    uz_probe = 1e-3
    ux_list = torch.tensor([0.0, 0.3, np.sqrt(1 - uz_probe ** 2), 1.0, 1.04],
                           dtype=torch.float64)
    uy_list = torch.zeros(1, dtype=torch.float64)
    h = NG / nu.Z0
    one = torch.ones((5, 1), dtype=torch.complex128)
    zero = torch.zeros_like(one)
    dxp = dyp = float(LAM / 2.2)
    P = tff._angular_power(one, zero, zero, one * h, ux_list, uy_list, dxp,
                           dyp, LAM, NG).numpy()
    Z = nu.Z0 / NG
    kg = 2 * np.pi * NG / LAM
    uz = np.sqrt(np.maximum(1 - ux_list.numpy() ** 2, 0.0))
    expect = (2 * kg ** 2 / (32 * np.pi ** 2 * Z) * (dxp * dyp) ** 2
              * (1 + Z * h * uz) ** 2 / np.where(uz == 0, np.nan, uz))
    np.testing.assert_allclose(P[:3, 0], expect[:3], rtol=1e-6)
    assert np.isposinf(P[3, 0]) and np.isnan(P[4, 0])
    tot = tff.focal_metrics(P, ux_list.numpy(), uy_list.numpy(), 1.0, 1.0,
                            1.0, 1.0, spot_radius_u=2.0)["power_in_spot"]
    assert np.isfinite(tot) and tot == pytest.approx(P[:3, 0].sum())


def test_farfield_big_matches_farfield():
    """The slab-chunked transform on a non-square aperture with partial
    slabs on both axes (tests/test_farfield.py:60)."""
    rng = np.random.default_rng(3)
    num_x, num_y, spacing = 48, 36, LAM / 2.2
    xs = (np.arange(num_x) - num_x / 2) * spacing
    ys = (np.arange(num_y) - num_y / 2) * spacing
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    phase = np.exp(1j * 2 * np.pi * NG / LAM
                   * (0.25 * X + 0.1 * Y - 0.002 * (X ** 2 + Y ** 2)
                      / spacing))

    def fld():
        return phase * (1 + 0.1 * (rng.standard_normal((num_x, num_y))
                                   + 1j * rng.standard_normal((num_x,
                                                               num_y))))
    fields = (fld(), 0.3 * fld(), -0.2 * NG / nu.Z0 * fld(),
              NG / nu.Z0 * fld())
    P0, tot0, ux0, uy0, dux0, duy0 = tff.farfield(*fields, xs, ys, LAM, NG,
                                                  device="cpu")
    P1, tot1, ux1, uy1, dux1, duy1 = tff.farfield_big(
        *fields, xs, ys, LAM, NG, pts_at_a_time=500, device="cpu")
    assert isinstance(P1, np.ndarray)
    np.testing.assert_array_equal(ux1, ux0)
    np.testing.assert_array_equal(uy1, uy0)
    assert (dux1, duy1) == (dux0, duy0)
    P0 = P0.numpy()
    both = np.isfinite(P0)
    assert (np.isfinite(P1) == both).all()
    assert np.abs(P1[both] - P0[both]).max() < 1e-10 * np.abs(P0[both]).max()
    assert abs(tot1 - tot0) < 1e-10 * abs(tot0)


@pytest.mark.parametrize("call", ["build_nearfield", "farfield",
                                  "farfield_big", "build_interpolators"])
def test_lens_check_runs_on_cuda_by_default(dbs, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    gc, hgs = dbs["torch"]
    field = np.ones((4, 4), complex)
    xs = np.arange(4) * 0.2 * um
    calls = {
        "build_nearfield": lambda: tnf.build_nearfield(
            0.0, 0.0, -np.inf, "x", LAM, None, _designs(dbs)["torch"][1],
            hgs),
        "farfield": lambda: tff.farfield(field, field, field, field, xs, xs,
                                         LAM, NG),
        "farfield_big": lambda: tff.farfield_big(field, field, field, field,
                                                 xs, xs, LAM, NG),
        "build_interpolators": lambda: gc.build_interpolators()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[call]()


def test_stitch_refuses_tables_on_another_device(dbs, monkeypatch):
    hgs = dbs["torch"][1]
    summary = _designs(dbs)["torch"][1]
    monkeypatch.setitem(hgs.interpolators, next(iter(hgs.interpolators)),
                        SimpleNamespace(values=torch.empty(1, device="meta")))
    with pytest.raises(ValueError, match="build_interpolators"):
        tnf.build_nearfield(0.0, 0.0, -np.inf, "x", LAM, None, summary, hgs,
                            device="cpu")


def test_jax_side_sees_the_same_databases(dbs):
    """The npz route carries the port's databases to the JAX package
    unchanged, so the comparisons above hold the stitch alone."""
    for t, j in zip(dbs["torch"], dbs["jax"]):
        for tg, jg in zip(t.grating_list, j.grating_list):
            assert tg.data == jg.data
    np.testing.assert_array_equal(dbs["torch"][1].x_amp_list,
                                  dbs["jax"][1].x_amp_list)
    for key, t in dbs["torch"][1].interpolators.items():
        j = np.asarray(dbs["jax"][1].interpolators[key].values)
        np.testing.assert_array_equal(t.values.numpy(),
                                      j[..., 0] + 1j * j[..., 1])
