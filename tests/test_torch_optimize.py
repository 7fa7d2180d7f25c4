"""The port's scene pieces and host optimizers against the JAX package at
float64 on the CPU: validate, resize, GratingCollection, the constraint
penalty, seeded optimize / optimize2 runs, optimize_gradient's iterates
(optax's Adam on the JAX side), fom_value_and_grad on the same compiled
JAX program, and one vary_angle member."""

import importlib
import math

import numpy as np
import jax
import pytest
import torch

import metalens_tpu.optimize as jopt
from metalens_tpu import engine as jengine
from metalens_tpu.grating import (Grating as JGrating,
                                  GratingCollection as JCollection,
                                  resize as jresize, validate as jvalidate)
from metalens_tpu.solver.fom import FomTerm as JFomTerm
from metalens_tpu.units import nm, degree
from metalens_tpu_torch import (Grating as TGrating, GratingCollection,
                                engine as tengine)
from metalens_tpu_torch import optimize as _exported_optimize
from metalens_tpu_torch.convert import (collection_from_reference,
                                        grating_from_reference)
from metalens_tpu_torch.grating import resize as tresize, \
    validate as tvalidate
from metalens_tpu_torch.optimize import (constraint_penalty, optimize,
                                         optimize2, optimize_gradient,
                                         vary_angle)
from metalens_tpu_torch.solver.fom import FomTerm as TFomTerm

# the module itself: the package exports the function ``optimize`` under
# the module's name, as the JAX package does
topt_module = importlib.import_module("metalens_tpu_torch.optimize")

torch.set_num_threads(1)

NUMG = 15
LAM = 580 * nm
# the bench cell's periods and height, two rotated pillars inside the
# fabrication constraints (each clears its own y-replica by >= 110 nm)
XY_NM_DEG = np.array([[-215., 2., 144., 105., 0.], [196., -8., 100., 102., 6.]])
TERMS = [(580 * nm, 1.0, -1, True), (450 * nm, 0.5, 0, False)]
GRADIENT_STEPS = 5
# the gradient parity cell: the bench cell's pillars, rotated
GRAD_XY_NM_DEG = np.array([[-215., 2., 144., 111., 0.],
                           [196., -8., 100., 130., 6.]])


def _jax_grating(xy=XY_NM_DEG, grating_period=1200 * nm, lateral_period=320 * nm):
    return JGrating(lateral_period=lateral_period,
                    grating_period=grating_period, cyl_height=550 * nm,
                    xyrra_list_in_nm_deg=xy)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.array(x, dtype=np.float64)


def _recording_vg(module, store, mp):
    """Record every geometry passed to the value-and-grad function that
    ``module`` builds (the optimizer's iterates)."""
    orig = module.fom_value_and_grad

    def factory(*args, **kwargs):
        vg = orig(*args, **kwargs)

        def recorded(xyrra):
            store.append(_as_np(xyrra))
            return vg(xyrra)
        return recorded
    mp.setattr(module, "fom_value_and_grad", factory)


def _assert_same_xyrra(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got[..., :4] - want[..., :4]).max() <= 1e-15      # metres
    assert np.abs(got[..., 4] - want[..., 4]).max() <= 1e-12        # radians


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's seeded optimizer runs, sharing its compiled FOM
    programs: optimize under a 3% trust region, optimize2 with 40
    attempts, optimize_gradient's iterates, one vary_angle member."""
    jg = _jax_grating()
    terms = [JFomTerm(*t) for t in TERMS]
    out = {"start": jg}
    out["optimize"] = jopt.optimize(
        jg, LAM, similar_to=jg.xyrra_list.copy(), how_similar=0.03,
        numG=NUMG, terms=terms, verbose=False, rng=np.random.default_rng(0))
    out["optimize2"] = jopt.optimize2(
        jg, LAM, attempts=40, numG=NUMG, terms=terms, verbose=False,
        rng=np.random.default_rng(1))
    iterates = []
    with pytest.MonkeyPatch.context() as mp:
        _recording_vg(jopt, iterates, mp)
        out["gradient"] = jopt.optimize_gradient(
            jg, LAM, steps=GRADIENT_STEPS, numG=NUMG, terms=terms,
            verbose=False)
    out["gradient_iterates"] = iterates
    out["vary_end"] = 0.985 * jg.get_angle_in_air(LAM)
    out["vary"] = jopt.vary_angle(
        jg, out["vary_end"], "cyl", LAM, numG=NUMG, terms=terms,
        optimize2_attempts=20, verbose=False, rng=np.random.default_rng(2))
    out["vary_gradient"] = jopt.vary_angle(
        jg, out["vary_end"], "cyl", LAM, numG=NUMG, terms=terms,
        use_gradient=True, gradient_steps=3, optimize2_attempts=10,
        verbose=False, rng=np.random.default_rng(4))
    return out


CASES = {
    "feasible": (XY_NM_DEG, None, None),
    "radius_too_small": (np.array([[0., 0., 49., 100., 0.]]), None, None),
    "pillars_too_close": (np.array([[0., 0., 100., 100., 0.],
                                    [290., 0., 100., 100., 0.]]), None, None),
    "own_y_replica": (np.array([[0., 0., 150., 115., 0.]]), None, None),
    "radius_drift": (XY_NM_DEG * [1, 1, 1.04, 1, 1], XY_NM_DEG, 0.03),
    "x_drift": (XY_NM_DEG + [[0, 0, 0, 0, 0], [-40, 0, 0, 0, 0]],
                XY_NM_DEG, 0.03),
    # a whole period back is no drift under the periodic metric
    "x_wraps": (XY_NM_DEG + [[1200, 0, 0, 0, 0], [-1190, 0, 0, 0, 0]],
                XY_NM_DEG, 0.03),
    "rotation_drift": (XY_NM_DEG + [[0, 0, 0, 0, 11], [0, 0, 0, 0, 0]],
                       XY_NM_DEG, 0.03),
    "inside_trust_region": (XY_NM_DEG + [[3, -2, 1, -1, 2], [-1, 1, 2, 2, -3]],
                            XY_NM_DEG, 0.03),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_validate_matches_jax(case, capsys):
    xy, similar, how = CASES[case]
    jg = _jax_grating(xy)
    tg = grating_from_reference(jg)
    sim = None if similar is None else _jax_grating(similar).xyrra_list
    want = jvalidate(jg, print_details=True, similar_to=sim, how_similar=how)
    jax_said = capsys.readouterr().out
    got = tvalidate(tg, print_details=True, similar_to=sim, how_similar=how)
    assert got is want
    assert capsys.readouterr().out == jax_said
    assert want is (case in ("feasible", "inside_trust_region", "x_wraps"))


RESIZE_CASES = {
    # direct copy validates
    "direct": (np.array([[-300., 0., 120., 90., 0.]]), 1200, 1212),
    # one cut at the emptiest x
    "one_cut": (np.array([[-350., 0., 120., 90., 0.],
                          [100., 10., 80., 110., 5.]]), 1200, 1150),
    # three equal gaps: only the multi-gap fallback absorbs the shrink
    "multi_gap": (np.array([[-320., 0., 80., 80., 0.], [0., 0., 80., 80., 0.],
                            [320., 0., 80., 80., 0.]]), 960, 840),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_matches_jax(case):
    xy, old_period, new_period = RESIZE_CASES[case]
    jold = _jax_grating(xy, old_period * nm, 330 * nm)
    jshell = _jax_grating(np.zeros((0, 5)), new_period * nm, 330 * nm)
    want = jresize(jold, jshell)
    got = tresize(grating_from_reference(jold),
                  grating_from_reference(jshell))
    assert isinstance(got, TGrating) and tvalidate(got)
    assert got.grating_period == want.grating_period == new_period * nm
    np.testing.assert_allclose(got.xyrra_list, want.xyrra_list, rtol=0,
                               atol=1e-21)
    assert repr(got) == repr(want)


def _jax_collection(lens_type):
    # round: lateral_period / tan(angle_in_air) is the family's constant
    # (python floats: a numpy scalar's repr differs)
    ratio = 320 * nm / math.tan(math.asin(LAM / (1200 * nm)))

    def lateral(p):
        if lens_type == "cyl":
            return 320 * nm
        return ratio * math.tan(math.asin(LAM / p))
    members = [_jax_grating(XY_NM_DEG * [1, 1, s, s, 1], p * nm,
                            lateral(p * nm))
               for s, p in ((1.0, 1200), (0.97, 1260), (0.95, 1330))]
    lateral = 320 * nm if lens_type == "cyl" else ratio
    # unsorted on purpose: the constructor sorts by period
    return JCollection(target_wavelength=LAM, lateral_period=lateral,
                       lens_type=lens_type,
                       grating_list=[members[2], members[0], members[1]])


@pytest.mark.parametrize("lens_type", ["cyl", "round"])
def test_collection_get_one_and_repr_match_jax(lens_type):
    jgc = _jax_collection(lens_type)
    tgc = collection_from_reference(jgc)
    assert isinstance(tgc, GratingCollection)
    assert repr(tgc) == repr(jgc)
    assert repr(tgc.get_innermost()) == repr(jgc.get_innermost())
    assert repr(tgc.get_outermost()) == repr(jgc.get_outermost())
    queries = [dict(grating_period=p * nm)
               for p in (1200, 1230, 1260, 1300, 1340, 1190)]
    queries.append(dict(angle_in_air=27 * degree))
    if lens_type == "round":
        queries.append(dict(lateral_period=300 * nm))
    for q in queries:
        want, got = jgc.get_one(**q), tgc.get_one(**q)
        assert isinstance(got, TGrating)
        assert got.grating_period == want.grating_period
        assert got.lateral_period == want.lateral_period
        np.testing.assert_allclose(got.xyrra_list, want.xyrra_list, rtol=0,
                                   atol=1e-12 * nm)
    # outside the family's +-1% range there is no geometry to blend
    assert not hasattr(tgc.get_one(grating_period=1500 * nm), "xyrra_list")
    env = {"Grating": TGrating, "GratingCollection": GratingCollection,
           "np": np, "nm": nm}
    back = eval(repr(jgc), env)
    assert isinstance(back, GratingCollection) and repr(back) == repr(jgc)
    extra = tgc.get_one(grating_period=1230 * nm)
    jgc.add_one(_jax_grating(extra.xyrra_list_in_nm_deg, 1230 * nm,
                             extra.lateral_period))
    tgc.add_one(extra)
    assert repr(tgc) == repr(jgc)


@pytest.mark.parametrize("similar", [False, True])
def test_constraint_penalty_matches_jax(similar):
    """An infeasible geometry (a thin pillar, overlapping outlines, a drift
    past the trust region): value and gradient against
    jax.value_and_grad of the JAX penalty."""
    xy = _jax_grating(np.array([[-215., 2., 45., 105., 0.],
                                [-80., -8., 100., 120., 6.]])).xyrra_list
    sim = _jax_grating(XY_NM_DEG).xyrra_list if similar else None
    args = (1200 * nm, 320 * nm, 50 * nm, 100 * nm, sim,
            0.03 if similar else None)
    want_v, want_g = jax.jit(jax.value_and_grad(jopt.constraint_penalty),
                             static_argnums=(1, 2, 3, 4, 6))(xy, *args)
    x = torch.tensor(xy, requires_grad=True)
    got_v = constraint_penalty(x, *args)
    got_g, = torch.autograd.grad(got_v, x)
    assert got_v.dtype == got_g.dtype == torch.float64
    assert abs(got_v.item() - float(want_v)) <= 1e-12 * abs(float(want_v))
    want_g = np.asarray(want_g)
    assert np.isfinite(got_g.numpy()).all()
    assert np.abs(got_g.numpy() - want_g).max() <= 1e-12 * np.abs(want_g).max()
    # zero on feasible geometry
    inside = torch.tensor(_jax_grating(XY_NM_DEG).xyrra_list)
    assert constraint_penalty(inside, *args[:4]).item() == 0.0


@pytest.mark.parametrize("lens_type,end_factor", [("cyl", 0.9),
                                                  ("round", 1.1)])
def test_continuation_static_envelope_matches_jax(lens_type, end_factor):
    """The envelope over every rung of a continuation (periods from the
    same get_one arithmetic); in complex128 the float64 slab cap, which the
    JAX package takes from its x64 flag, and more slabs in complex64."""
    jg = _jax_grating()
    end = end_factor * jg.get_angle_in_air(LAM)
    want = jopt.continuation_static_envelope(
        jg, end, lens_type, LAM, numG=NUMG, terms=[JFomTerm(*t) for t in TERMS])
    tg = grating_from_reference(jg)
    terms = [TFomTerm(*t) for t in TERMS]
    got = topt_module.continuation_static_envelope(
        tg, end, lens_type, LAM, numG=NUMG, terms=terms, device="cpu")
    assert got == tuple(want)
    f32 = topt_module.continuation_static_envelope(
        tg, end, lens_type, LAM, numG=NUMG, terms=terms, device="cpu",
        dtype=torch.complex64)
    assert f32[:2] == got[:2] and f32[2] > got[2]


def test_optimize_matches_jax(jax_runs):
    jg = jax_runs["start"]
    tg = grating_from_reference(jg)
    got = optimize(tg, LAM, similar_to=jg.xyrra_list.copy(),
                   how_similar=0.03, numG=NUMG,
                   terms=[TFomTerm(*t) for t in TERMS], verbose=False,
                   rng=np.random.default_rng(0), device="cpu")
    want = jax_runs["optimize"]
    _assert_same_xyrra(got.xyrra_list, want.xyrra_list)
    assert np.abs(want.xyrra_list - jg.xyrra_list).max() > 1 * nm
    np.testing.assert_array_equal(tg.xyrra_list, jg.xyrra_list)  # a copy


def test_optimize2_matches_jax(jax_runs):
    jg = jax_runs["start"]
    before = topt_module.probe_batches
    got = optimize2(grating_from_reference(jg), LAM, attempts=40, numG=NUMG,
                    terms=[TFomTerm(*t) for t in TERMS], verbose=False,
                    rng=np.random.default_rng(1), device="cpu")
    want = jax_runs["optimize2"]
    _assert_same_xyrra(got.xyrra_list, want.xyrra_list)
    assert np.abs(want.xyrra_list - jg.xyrra_list).max() > 0
    assert topt_module.probe_batches > before


def test_optimize_gradient_iterates_match_jax(jax_runs, monkeypatch):
    jg = jax_runs["start"]
    iterates = []
    _recording_vg(topt_module, iterates, monkeypatch)
    got = optimize_gradient(grating_from_reference(jg), LAM,
                            steps=GRADIENT_STEPS, numG=NUMG,
                            terms=[TFomTerm(*t) for t in TERMS],
                            verbose=False, device="cpu")
    want = jax_runs["gradient_iterates"]
    assert len(iterates) == len(want) == GRADIENT_STEPS + 1
    for x_got, x_want in zip(iterates, want):
        _assert_same_xyrra(x_got, x_want)
    _assert_same_xyrra(got.xyrra_list, jax_runs["gradient"].xyrra_list)
    assert np.abs(want[-1] - want[0])[:, :4].min() > 0.1 * nm


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """The JAX engine's FOM and gradient of the two-pillar cell, and a
    second geometry, from one compiled value-and-grad program (the one
    optimize_gradient compiled in ``jax_runs``)."""
    jg = JGrating(lateral_period=320 * nm, grating_period=1200 * nm,
                  cyl_height=550 * nm, xyrra_list_in_nm_deg=GRAD_XY_NM_DEG)
    vg = jengine.fom_value_and_grad(jg, 580 * nm, NUMG,
                                    [JFomTerm(*t) for t in TERMS])
    step = np.array([[1, -2, 3, 0, 0], [-2, 1, 0, 2, 0]]) * nm
    step[:, 4] = [0.01, -0.02]          # radians
    out = []
    for xy in (jg.xyrra_list, jg.xyrra_list + step):
        f, g = vg(xy)
        out.append((xy, float(f), np.asarray(g)))
    return jg, out


def test_fom_value_and_grad_matches_jax(jax_value_and_grad):
    jg, cases = jax_value_and_grad
    tg = grating_from_reference(jg)
    vg = tengine.fom_value_and_grad(tg, 580 * nm, NUMG,
                                    [TFomTerm(*t) for t in TERMS],
                                    device="cpu")
    for xy, want_f, want_g in cases:
        fom, grad = vg(xy)
        assert fom.ndim == 0 and fom.dtype == torch.float64
        assert grad.shape == (2, 5) and grad.dtype == torch.float64
        assert abs(fom.item() - want_f) < 1e-10
        scale = np.abs(want_g).max()
        assert np.abs(grad.numpy() - want_g).max() < 1e-7 * scale
        # no gradient component is zero by symmetry in this cell
        assert np.abs(want_g).min() > 1e-12 * scale
    # the value agrees with the FOM entry point
    assert abs(vg(tg.xyrra_list)[0].item()
               - tengine.fom_of_grating(tg, 580 * nm, NUMG,
                                        [TFomTerm(*t) for t in TERMS],
                                        device="cpu")) < 1e-13


@pytest.mark.parametrize("route", ["derivative_free", "gradient"])
def test_vary_angle_member_matches_jax(jax_runs, route):
    jg = jax_runs["start"]
    kw = (dict(optimize2_attempts=20, rng=np.random.default_rng(2))
          if route == "derivative_free" else
          dict(use_gradient=True, gradient_steps=3, optimize2_attempts=10,
               rng=np.random.default_rng(4)))
    got = vary_angle(grating_from_reference(jg), jax_runs["vary_end"], "cyl",
                     LAM, numG=NUMG, terms=[TFomTerm(*t) for t in TERMS],
                     verbose=False, device="cpu", **kw)
    want = jax_runs["vary" if route == "derivative_free" else "vary_gradient"]
    assert isinstance(got, GratingCollection) and len(got.grating_list) == 2
    assert repr(got) == repr(want)
    # the member moved away from its seed (the start, copied by resize)
    assert np.abs(got.grating_list[1].xyrra_list - jg.xyrra_list).max() > 0


def test_entry_points_default_to_cuda(monkeypatch):
    """Called without device=, the design loop runs on CUDA: where torch has
    no CUDA device every entry point raises instead of running on the
    CPU.  use_fused is not ported yet and says so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tg = grating_from_reference(_jax_grating())
    assert _exported_optimize is optimize
    calls = (
        lambda: tengine.fom_value_and_grad(tg, LAM, NUMG),
        lambda: optimize(tg, LAM, numG=NUMG, verbose=False),
        lambda: optimize2(tg, LAM, attempts=1, numG=NUMG, verbose=False),
        lambda: optimize_gradient(tg, LAM, steps=1, numG=NUMG,
                                  verbose=False),
        lambda: vary_angle(tg, 0.9 * tg.get_angle_in_air(LAM), "cyl", LAM,
                           numG=NUMG, verbose=False),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vary_angle(tg, 0.9 * tg.get_angle_in_air(LAM), "cyl", LAM,
                   use_fused=True, device="cpu")
