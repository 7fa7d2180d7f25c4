"""The port's remaining scene methods and plots against the JAX package.

Job files (``Grating.write``, ``read_job_files``,
``GratingCollection.export_to_lumerical``) must carry the JAX package's
bytes; ``show_efficiencies`` must give the members' own FOMs; the plots of
``viz`` must draw from the port's CPU tensors.  The databases come from one
module fixture characterized by the port on the CPU at small numG, so no
JAX program is compiled.
"""

import importlib
import math
import os

import numpy as np
import pytest
import torch

import metalens_tpu
from metalens_tpu import grating as jgrating, viz as jviz
from metalens_tpu_torch import Grating, GratingCollection, HexGridSet, viz
from metalens_tpu_torch.grating import read_job_files

tff = importlib.import_module("metalens_tpu_torch.farfield")

torch.set_num_threads(1)

nm, degree = 1e-9, math.pi / 180
LAM = 580 * nm
NUMG = 9
SPEC = dict(lateral_period=320 * nm, cyl_height=550 * nm,
            grating_period=1200 * nm,
            xyrra_list_in_nm_deg=np.array([[-215., 2., 120., 90., 10.],
                                           [196., -8., 100., 102., 6.]]))


@pytest.fixture(scope="module")
def scene():
    """A two-member cyl collection characterized at numG = 9, u_steps = 2,
    and a three-entry HexGridSet characterized at normal incidence, both by
    the port on the CPU."""
    g1 = Grating(**SPEC)
    g2 = g1.copy()
    g2.grating_period = 1250 * nm
    gc = GratingCollection(target_wavelength=LAM, lateral_period=320 * nm,
                           lens_type="cyl", grating_list=[g1, g2])
    gc.characterize(LAM, numG=NUMG, u_steps=2, device="cpu")
    hgs = HexGridSet(sep=320 * nm, cyl_height=550 * nm, num_entries=3)
    hgs.characterize(wavelength=LAM, numG=NUMG, just_normal=True,
                     device="cpu")
    return gc, hgs


@pytest.fixture
def plt():
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    yield plt
    plt.close("all")


def _tree(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


WRITE_CASES = {
    "fom": dict(angle_in_air=0.5, numG=30),
    "fom_replicas_indexed": dict(angle_in_air=0.4, index=3, replicas=True),
    "characterize": dict(ux_min=0.1, ux_max=0.6, uy_min=-0.2, uy_max=0.2,
                         u_steps=3, wavelength=580 * nm, numG=25, index=0),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_matches_jax_and_reads_back(tmp_path, case):
    kw = WRITE_CASES[case]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    Grating(**SPEC).write(str(ours), **kw)
    metalens_tpu.Grating(**SPEC).write(str(theirs), **kw)
    assert _tree(ours) == _tree(theirs)
    index = kw.get("index")
    for directory in (ours, theirs):
        g, info = read_job_files(str(directory), index=index)
        jg, jinfo = jgrating.read_job_files(str(directory), index=index)
        assert isinstance(g, Grating)
        assert repr(g) == repr(jg) and info == jinfo
        assert info["mode"] == ("fom" if "angle_in_air" in kw
                                else "characterize")


@pytest.mark.parametrize("select", [None, "angle", "period"])
def test_export_to_lumerical_matches_jax(tmp_path, scene, select):
    """The same files as JAX's, and the one-past-the-end pair removed."""
    gc, _ = scene
    jgc = metalens_tpu.GratingCollection(
        target_wavelength=LAM, lateral_period=320 * nm, lens_type="cyl",
        grating_list=[metalens_tpu.Grating(**{**SPEC, "grating_period": p})
                      for p in (1200 * nm, 1250 * nm)])
    kw = {None: {}, "angle": dict(angle_in_air=math.asin(LAM / (1220 * nm))),
          "period": dict(grating_period=1230 * nm)}[select]
    trees = []
    for name, coll in (("port", gc), ("jax", jgc)):
        d = tmp_path / name
        d.mkdir()
        end = 1 if select else 2
        for stale in (f"grating_setup{end}.txt",
                      f"grating_xyrra_list{end}.txt"):
            (d / stale).write_text("stale\n")
        coll.export_to_lumerical(directory=str(d), **kw)
        trees.append(_tree(d))
    assert trees[0] == trees[1]
    assert len(trees[0]) == (2 if select else 4)
    assert trees[0]["grating_setup0.txt"].split()[0] == b"1"


def test_show_efficiencies_equals_member_foms(scene, plt):
    gc, _ = scene
    out = gc.show_efficiencies(numG=NUMG, plot=False, device="cpu")
    want = [g.fom(target_wavelength=LAM, numG=NUMG, device="cpu")
            for g in gc.grating_list]
    assert [f for _, f in out] == want
    assert [a for a, _ in out] == [g.get_angle_in_air(LAM)
                                   for g in gc.grating_list]
    n_figs = len(plt.get_fignums())
    gc.show_efficiencies(numG=NUMG, plot=True, device="cpu")
    assert len(plt.get_fignums()) == n_figs + 1


def test_eps_map_matches_jax():
    for wl in (450 * nm, 580 * nm):
        ours = viz.eps_map(Grating(**SPEC), wavelength=wl, n_points=31)
        theirs = jviz.eps_map(metalens_tpu.Grating(**SPEC), wavelength=wl,
                              n_points=31)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_cell_and_database_plots(scene, plt):
    import matplotlib.patches as mp
    gc, hgs = scene
    g = gc.grating_list[0]
    kids = g.show_config().gca().get_children()
    assert sum(isinstance(k, mp.Ellipse) for k in kids) >= 2
    assert sum(isinstance(k, mp.Rectangle) for k in kids) >= 1
    assert viz.plot_eps(g, wavelength=LAM, n_points=31) is not None
    assert viz.show_characterization(g, my_order=(0, 0), my_pol="x",
                                     my_wavelength=580,
                                     which_amp="ampfx") is not None
    fig = hgs.show_properties()
    assert len(fig.axes) == 2
    assert len(viz.plot_round_lateral_period(150e-6, 3427)) == 2


def test_field_plots_take_cpu_tensors(plt):
    """plot_farfield on the port's far field (a CPU tensor) of a tilted
    plane wave, plot_nearfield on a complex tensor in each kind."""
    ng = 1.459
    n_pts, spacing = 64, LAM / 2.2
    xs = (np.arange(n_pts) - n_pts / 2) * spacing
    X, _ = np.meshgrid(xs, xs, indexing="ij")
    Ex = np.exp(1j * 2 * np.pi * ng / LAM * 0.3 * X)
    Hy = ng / 376.730313668 * np.sqrt(1 - 0.3 ** 2) * Ex
    zero = np.zeros_like(Ex)
    P, _, ux, uy, _, _ = tff.farfield(Ex, zero, zero, Hy, xs, xs, LAM, ng,
                                      device="cpu")
    assert torch.is_tensor(P)
    assert viz.plot_farfield(P, ux, uy, n_glass=ng, title="t") is not None
    E = torch.as_tensor(Ex[:24, :24])
    x = torch.as_tensor(xs[:24])
    for kind in ("phase", "abs", "power"):
        assert viz.plot_nearfield(E, x, x, kind=kind, title=kind) is not None
    with pytest.raises(ValueError):
        viz.plot_nearfield(E, x, x, kind="bogus")


def test_collection_graphs_write_frames(tmp_path, monkeypatch, scene, plt):
    gc, _ = scene
    monkeypatch.chdir(tmp_path)
    gif = str(tmp_path / "anim.gif")
    frames = gc.show_graphs(with_efficiencies=True, anim_filename=gif,
                            numG=NUMG, device="cpu")
    assert frames == ["grating_collection0.png", "grating_collection1.png"]
    assert all((tmp_path / f).stat().st_size > 0 for f in frames)
    assert os.path.getsize(gif) > 0
