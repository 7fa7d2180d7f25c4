"""The port's fused design loop against the JAX package at float64 on the
CPU: ``feasible_traced`` against JAX's and against ``validate``,
``_ratchet_scan`` on hand-made sequences, the coordinate-descent and
random-perturbation loops (``_cd_run``, ``_rp_run``) with an analytic FOM
and JAX's draws injected, one real-FOM ``optimize_fused`` ->
``optimize2_fused`` run against the JAX package round by round, and the
port-only behaviour: reproducibility per seed, ``optimize_multistart``,
``vary_angle(use_fused=True)``, ``min_gap`` and the exports.

``torch.Generator`` cannot reproduce ``jax.random``, so every parity case
injects the JAX package's draw sequence (:class:`JaxDraws`) in place of the
port's draw source.  The starts are asymmetric (two pillars,
unequal semi-axes, a nonzero angle), so no probe ties the current FOM by
symmetry and rounding cannot pick a different accepted direction."""

import importlib
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from metalens_tpu.grating import Grating as JGrating
from metalens_tpu.solver.fom import FomTerm as JFomTerm
from metalens_tpu.units import degree, nm
import metalens_tpu_torch
from metalens_tpu_torch import validate, vary_angle
from metalens_tpu_torch.convert import grating_from_reference
from metalens_tpu_torch.grating import min_diameter, min_distance
from metalens_tpu_torch.solver.fom import FomTerm as TFomTerm

# the modules themselves: both packages export the function
# ``optimize_fused`` under the module's name
jfused = importlib.import_module("metalens_tpu.optimize_fused")
tfused = importlib.import_module("metalens_tpu_torch.optimize_fused")

torch.set_num_threads(1)

LAM = 580 * nm
# 25 deg, away from grazing orders: the kept orders' |Kx| are 0.42 and
# 0.85 (air) and 1.27 (glass); numG = 3 is the smallest set holding (-1, 0)
ANGLE = 25 * degree
NUMG = 3
XY_NM_DEG = np.array([[-300., 0., 110., 90., 0.], [250., 40., 80., 70., 10.]])


def _jax_grating(xy=XY_NM_DEG):
    return JGrating(lateral_period=320 * nm, cyl_height=550 * nm,
                    target_wavelength=LAM, angle_in_air=ANGLE,
                    xyrra_list_in_nm_deg=xy)


def _grating(xy=XY_NM_DEG):
    return grating_from_reference(_jax_grating(xy))


class JaxDraws:
    """The JAX package's draw sequence from ``jax.random.PRNGKey(seed)``:
    ``key, k1 = jax.random.split(key)`` per round, then a permutation or a
    uniform draw in [-1, 1) from k1 (``_cd_run`` / ``_rp_run``)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def _k1(self):
        self.key, k1 = jax.random.split(self.key)
        return k1

    def permutation(self, n):
        return torch.as_tensor(np.array(jax.random.permutation(self._k1(),
                                                               n)))

    def uniform(self, shape):
        return torch.as_tensor(np.array(jax.random.uniform(
            self._k1(), shape, jnp.float64, -1.0, 1.0)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------------------
# feasibility
# --------------------------------------------------------------------------

def _perturbations(n=200):
    """Normal perturbations as in the JAX package's own test
    (tests/test_optimize_fused.py), at scales from 1 to 40 nm (0.2 to
    8 deg): half around the start, half around a copy whose second pillar
    sits about 100 nm from the first, so that the radius, pair-clearance,
    self-replica and drift thresholds each decide some of them."""
    rng = np.random.default_rng(0)
    sim = _jax_grating().xyrra_list
    close = sim.copy()
    close[1, 0] = -10 * nm
    scale = np.geomspace(1.0, 40.0, n // 2)[:, None, None]
    xs = []
    for base in (sim, close):
        x = base + rng.normal(0.0, 1.0, scale.shape[:1] + sim.shape) \
            * scale * nm
        x[..., 4] = base[:, 4] + (rng.normal(0.0, 1.0, x.shape[:2])
                                  * scale[:, :, 0] * 0.2 * degree)
        xs.append(x)
    return sim, np.concatenate(xs)


_JAX_FEASIBLE = []


def _jax_feasible(xs, sim, how_similar, margin):
    """JAX's feasible_traced over a batch of 200, jitted once per module;
    the trust region and the margin are inputs (how_similar=inf is the
    unconstrained check: every drift bound holds)."""
    if not _JAX_FEASIBLE:
        g = _grating()
        args = (g.grating_period, g.lateral_period, min_diameter / 2,
                min_distance)
        _JAX_FEASIBLE.append(jax.jit(jax.vmap(
            lambda x, sim, hs, margin: jfused.feasible_traced(
                x, *args, sim=sim, how_similar=hs, margin=margin),
            (0, None, None, None))))
    padded = np.concatenate([xs, np.repeat(xs[:1], 200 - len(xs), 0)])
    return np.asarray(_JAX_FEASIBLE[0](padded, sim, how_similar,
                                       margin))[:len(xs)]


def _host_validate(xs, sim, how_similar):
    g = _grating()
    out = []
    for x in xs:
        g.xyrra_list = x
        out.append(validate(g, similar_to=sim, how_similar=how_similar))
    return out


@pytest.mark.parametrize("margin,how_similar", [(0.0, 0.05), (1e-5, 0.05),
                                                (0.0, None)])
def test_feasible_traced_matches_jax_and_validate(margin, how_similar):
    """Exact agreement with JAX's feasible_traced on 200 perturbations, and
    with the port's validate where no margin tightens the thresholds."""
    sim, xs = _perturbations()
    g = _grating()
    args = (g.grating_period, g.lateral_period, min_diameter / 2,
            min_distance)
    want = _jax_feasible(xs, sim, np.inf if how_similar is None
                         else how_similar, margin)
    if how_similar is None:
        sim = None
    got = tfused.feasible_traced(
        torch.as_tensor(xs), *args,
        sim=None if sim is None else torch.as_tensor(sim),
        how_similar=how_similar, margin=margin)
    assert got.dtype == torch.bool and got.shape == (len(xs),)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.9       # both outcomes well represented
    if margin == 0.0:
        np.testing.assert_array_equal(got.numpy(),
                                      _host_validate(xs, sim, how_similar))


def test_feasible_traced_boundary_exact_step():
    """24 x 0.3 deg is the 2% x 360 deg trust radius: without a margin the
    device check is the host's exact complement whichever way float64
    rounds the boundary step; with margin=1e-5 that step is refused and the
    step before it kept, in both packages."""
    sim = _jax_grating().xyrra_list
    g = _grating()
    steps = np.zeros((2,) + sim.shape)
    steps[:, 0, 4] = [23, 24]
    xs = sim + steps * 0.3 * degree
    args = (g.grating_period, g.lateral_period, min_diameter / 2,
            min_distance)
    for margin in (0.0, 1e-5):
        want = _jax_feasible(xs, sim, 0.02, margin).tolist()
        got = tfused.feasible_traced(torch.as_tensor(xs), *args,
                                     sim=torch.as_tensor(sim),
                                     how_similar=0.02, margin=margin).tolist()
        assert got == want
        if margin == 0.0:
            assert got == _host_validate(xs, sim, 0.02) and got[0]
        else:
            assert got == [True, False]


# --------------------------------------------------------------------------
# the ratchet
# --------------------------------------------------------------------------

RATCHET_CASES = {
    # f1, walk FOMs (steps 2..10), walk feasibility
    "all_up": (0.5, [0.51, 0.52, 0.53, 0.54, 0.55, 0.56, 0.57, 0.58, 0.59],
               [1] * 9),
    "ties_advance": (0.5, [0.5, 0.5, 0.6, 0.6, 0.59, 0.7, 0.8, 0.9, 1.0],
                     [1] * 9),
    "first_drops": (0.5, [0.49, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9],
                    [1] * 9),
    # an infeasible step ends the walk even if later steps are feasible
    "infeasible_gap": (0.5, [0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4],
                       [1, 1, 0, 1, 1, 1, 1, 1, 1]),
    "none_feasible": (0.5, [0.6] * 9, [0] * 9),
}


@pytest.mark.parametrize("case", sorted(RATCHET_CASES))
def test_ratchet_scan_matches_jax(case):
    f1, wfoms, wfeas = RATCHET_CASES[case]
    want_f, want_k = jax.jit(jfused._ratchet_scan)(
        jnp.float64(f1), jnp.asarray(wfoms), jnp.asarray(wfeas, bool))
    got_f, got_k = tfused._ratchet_scan(
        torch.tensor(f1, dtype=torch.float64),
        torch.tensor(wfoms, dtype=torch.float64),
        torch.tensor(wfeas, dtype=torch.bool))
    assert got_f.item() == float(want_f) and got_k.item() == int(want_k)


# --------------------------------------------------------------------------
# the loops with an analytic FOM
# --------------------------------------------------------------------------

# a smooth FOM without ties: per-coordinate sines (lengths in nm, the angle
# in degrees) and a coupling term
_A = np.random.default_rng(1).uniform(0.5, 1.5, (3, 2, 5))
_SCALE = np.array([nm, nm, nm, nm, degree])


def _smooth(x, lib):
    u = x / lib.asarray(_SCALE)
    a, b, c = (lib.asarray(v) for v in _A)
    sep = lib.sin(u * (0.07 * b) + 3 * c) * a
    return (sep.sum((-2, -1))
            + 0.3 * lib.sin((u * (0.01 * b)).sum((-2, -1)) + 0.2))


def _fake_jax_fom(x, *args, **kwargs):
    return _smooth(x, jnp)


def _fake_torch_fom(x, *args, **kwargs):
    return _smooth(x, torch)


def _analytic_inputs():
    """The loops' inputs for the analytic FOM: the start, its 5% trust
    region and the fabrication floors (the order and per-term inputs are
    unused placeholders)."""
    g = _grating()
    x0 = g.xyrra_list
    cell = (g.grating_period, g.lateral_period, g.cyl_height)
    trust = (x0, 0.05, min_diameter / 2, min_distance)
    return x0, trust, cell


# N, Dx, Dy, n_slabs, taylor_terms, inphase, fff, hermitian_eps, nE: unused
# by the analytic FOM
_CONFIG = (NUMG, 16, 4, 1, 8, (True,), True, True, 2)


_JAX_PROGRAMS = {}


def _jax_program(name, *static):
    """JAX's loop body jitted once per module and static configuration."""
    key = (name,) + static
    if key not in _JAX_PROGRAMS:
        _JAX_PROGRAMS[key] = jax.jit(getattr(jfused, name)(*_CONFIG,
                                                           *static))
    return _JAX_PROGRAMS[key]


def _jax_cd(seed, max_rounds):
    x0, (sim, hs, min_r, gap), cell = _analytic_inputs()
    prog = _jax_program("_cd_run", max_rounds, 10)
    x, key, total = jnp.asarray(x0), jax.random.PRNGKey(seed), 0
    placeholders = (jnp.zeros(1), jnp.zeros(1), 0, jnp.zeros(1, jnp.int32))
    while True:
        x, fom, stalled, rounds, key = prog(
            x, jnp.asarray(sim), jnp.float64(hs), jnp.float64(min_r),
            jnp.float64(gap), key, *placeholders, *cell)
        total += int(rounds)
        if bool(stalled):
            return np.asarray(x), float(fom), total


def _torch_cd(seed, max_rounds):
    x0, (sim, hs, min_r, gap), cell = _analytic_inputs()
    run = tfused._cd_run(*_CONFIG, max_rounds, 10)
    x, draws, total = torch.as_tensor(x0), JaxDraws(seed), 0
    placeholders = (torch.zeros(1), torch.zeros(1), 0, (0,))
    while True:
        x, fom, stalled, rounds = run(x, torch.as_tensor(sim),
                                      torch.tensor(hs, dtype=torch.float64),
                                      min_r, gap, draws, *placeholders,
                                      *cell)
        total += rounds
        if stalled:
            return x.numpy(), fom.item(), total


@pytest.fixture
def analytic_fom(monkeypatch):
    # the JAX loop bodies are jitted here directly, never through the
    # lru_cached _cd_program / _rp_program that the JAX package's own tests
    # share in this process
    monkeypatch.setattr(jfused, "_fom_eval", _fake_jax_fom)
    monkeypatch.setattr(tfused, "_fom_eval", _fake_torch_fom)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_cd_run_matches_jax_analytic(analytic_fom, seed):
    """The coordinate-descent loop with JAX's permutations: x, the FOM and
    the round count to 1e-12 (the loop stalls by itself), and, for the
    first seed, a run split into dispatches of 2 rounds equals one of 64,
    in both packages."""
    x0 = _analytic_inputs()[0]
    runs = {}
    for max_rounds in ((64, 2) if seed == 0 else (64,)):
        want_x, want_f, want_r = _jax_cd(seed, max_rounds)
        got_x, got_f, got_r = _torch_cd(seed, max_rounds)
        assert got_r == want_r > 3
        assert _rel(got_x, want_x) <= 1e-12
        assert abs(got_f - want_f) <= 1e-12 * abs(want_f)
        runs[max_rounds] = (want_x, want_f, got_x, got_f)
    if 2 in runs:
        np.testing.assert_array_equal(runs[2][0], runs[64][0])
        np.testing.assert_array_equal(runs[2][2], runs[64][2])
    assert runs[64][3] > _smooth(x0, np)
    assert _rel(runs[64][2], x0) > 1e-3        # it moved


@pytest.mark.parametrize("seed", [0, 5])
def test_rp_run_matches_jax_analytic(analytic_fom, seed):
    """The random-perturbation loop with JAX's uniform draws: x, the FOM
    and the attempt count to 1e-12."""
    x0, (sim, hs, min_r, gap), cell = _analytic_inputs()
    ceiling = np.empty_like(x0)
    ceiling[:, :4] = 1 * nm
    ceiling[:, 4] = 0.1 * degree
    ceiling /= x0.size
    attempts = 20
    prog = _jax_program("_rp_run", 10)
    want_x, want_f, want_t = prog(
        jnp.asarray(x0), jnp.asarray(sim), jnp.float64(hs),
        jnp.float64(min_r), jnp.float64(gap), jax.random.PRNGKey(seed),
        jnp.int32(attempts), jnp.asarray(ceiling), jnp.zeros(1),
        jnp.zeros(1), 0, jnp.zeros(1, jnp.int32), *cell)
    run = tfused._rp_run(*_CONFIG, 10)
    got_x, got_f, got_t, accepted = run(
        torch.as_tensor(x0), torch.as_tensor(sim),
        torch.tensor(hs, dtype=torch.float64), min_r, gap, JaxDraws(seed),
        attempts, torch.as_tensor(ceiling), torch.zeros(1), torch.zeros(1),
        0, (0,), *cell)
    assert got_t == int(want_t) == attempts
    assert _rel(got_x.numpy(), want_x) <= 1e-12
    assert abs(got_f.item() - float(want_f)) <= 1e-12 * abs(float(want_f))
    assert 0 < accepted.item() < attempts
    assert got_f.item() > _smooth(x0, np)


# --------------------------------------------------------------------------
# one real-FOM run of the slice, round by round
# --------------------------------------------------------------------------

TERMS = [(LAM, 1.0, -1, True)]
# a 1% trust region: the coordinate descent stalls after about a dozen
# rounds
HOW_SIMILAR = 0.01
RP_ATTEMPTS = 8
CD_SEED, RP_SEED = 4, 5


def _round_spies(mp, module, trace, split_key):
    """Record every coordinate-descent dispatch's result and split each
    random-perturbation run into one-attempt calls, recording each.  The
    JAX programs (``split_key``) take a key, the port's runs a stateful
    draw source."""
    cd_name, rp_name = (("_cd_program", "_rp_program") if split_key
                        else ("_cd_run", "_rp_run"))
    cd_orig, rp_orig = getattr(module, cd_name), getattr(module, rp_name)

    def cd(*config):
        prog = cd_orig(*config)

        def rec(*args):
            out = prog(*args)
            trace["cd"].append((np.asarray(out[0], np.float64),
                                float(out[1]), bool(out[2]), int(out[3])))
            return out
        return rec

    def rp(*config):
        prog = rp_orig(*config)

        def rec(x, sim, hs, min_r, gap, key, attempts, *rest):
            for _ in range(int(attempts)):
                out = prog(x, sim, hs, min_r, gap, key,
                           jnp.int32(1) if split_key else 1, *rest)
                if split_key:       # the key the one-attempt call used
                    key, _ = jax.random.split(key)
                x, fom = out[0], out[1]
                trace["rp"].append((np.asarray(x, np.float64), float(fom)))
            return out[:2] + (attempts,) + out[3:]
        return rec

    mp.setattr(module, cd_name, cd)
    mp.setattr(module, rp_name, rp)


@pytest.fixture(scope="module")
def slice_runs():
    """optimize_fused (one round per dispatch) then optimize2_fused (split
    into one-attempt calls) from the same start in both packages, recording
    each round; the port with JAX's draws injected.  The port's unsplit
    optimize2_fused from the same point rides along."""
    jg = _jax_grating()
    sim = jg.xyrra_list.copy()
    kw = dict(similar_to=sim, how_similar=HOW_SIMILAR, numG=NUMG,
              verbose=False)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        trace = {"cd": [], "rp": []}
        _round_spies(mp, jfused, trace, split_key=True)
        j_cd = jfused.optimize_fused(jg, LAM, terms=[JFomTerm(*TERMS[0])],
                                     seed=CD_SEED, max_rounds_per_dispatch=1,
                                     **kw)
        j_rp = jfused.optimize2_fused(j_cd, LAM, attempts=RP_ATTEMPTS,
                                      terms=[JFomTerm(*TERMS[0])],
                                      seed=RP_SEED, **kw)
        out["jax"] = (trace, j_cd, j_rp)
    tterms = [TFomTerm(*TERMS[0])]
    with pytest.MonkeyPatch.context() as mp:
        # the port's draw source replaced by JAX's sequence for each seed
        mp.setattr(tfused, "TorchDraws",
                   lambda seed, device, dtype: JaxDraws(seed))
        trace = {"cd": [], "rp": []}
        with pytest.MonkeyPatch.context() as spies:
            _round_spies(spies, tfused, trace, split_key=False)
            t_cd = tfused.optimize_fused(
                grating_from_reference(jg), LAM, terms=tterms, seed=CD_SEED,
                max_rounds_per_dispatch=1, device="cpu", **kw)
            t_rp = tfused.optimize2_fused(t_cd, LAM, attempts=RP_ATTEMPTS,
                                          terms=tterms, seed=RP_SEED,
                                          device="cpu", **kw)
        out["port"] = (trace, t_cd, t_rp)
        out["port_unsplit_rp"] = tfused.optimize2_fused(
            t_cd, LAM, attempts=RP_ATTEMPTS, terms=tterms, seed=RP_SEED,
            device="cpu", **kw)
    return out


def _moves(xs, x0):
    """Each round's accepted move as (flat coordinate, signed unit steps),
    or None when the round accepted nothing."""
    unit = np.array([nm] * 4 + [0.3 * degree])
    moves, prev = [], x0
    for x in xs:
        d = (x - prev) / unit
        nz = np.flatnonzero(np.abs(d) > 0.5)
        assert len(nz) <= 1
        moves.append(None if not len(nz) else
                     (int(nz[0]), int(round(d.flat[nz[0]]))))
        prev = x
    return moves


def test_optimize_fused_rounds_match_jax(slice_runs):
    """The same accepted direction and step count in every round, the same
    stall, and each round's geometry and FOM within 1e-9 and 1e-10."""
    (jt, _, _), (tt, _, _) = slice_runs["jax"], slice_runs["port"]
    x0 = _jax_grating().xyrra_list
    assert len(tt["cd"]) == len(jt["cd"]) >= 4
    assert [r[2:] for r in tt["cd"]] == [r[2:] for r in jt["cd"]]
    assert [r[3] for r in jt["cd"]] == [1] * len(jt["cd"])
    assert jt["cd"][-1][2] and not any(r[2] for r in jt["cd"][:-1])
    want = _moves([r[0] for r in jt["cd"]], x0)
    assert _moves([r[0] for r in tt["cd"]], x0) == want
    assert want[-1] is None and None not in want[:-1]
    assert max(abs(m[1]) for m in want[:-1]) > 1     # a walk went on
    for (gx, gf, _, _), (wx, wf, _, _) in zip(tt["cd"], jt["cd"]):
        assert _rel(gx, wx) <= 1e-9
        assert abs(gf - wf) <= 1e-10


def test_optimize2_fused_attempts_match_jax(slice_runs):
    """Every attempt's geometry within 1e-9 and FOM within 1e-10: the same
    attempts accepted, with the same steps kept."""
    (jt, _, _), (tt, _, _) = slice_runs["jax"], slice_runs["port"]
    assert len(tt["rp"]) == len(jt["rp"]) == RP_ATTEMPTS
    accepted = []
    prev = slice_runs["jax"][1].xyrra_list
    for (gx, gf), (wx, wf) in zip(tt["rp"], jt["rp"]):
        assert _rel(gx, wx) <= 1e-9
        assert abs(gf - wf) <= 1e-10
        accepted.append(bool(np.abs(wx - prev).max() > 0))
        prev = wx
    assert 0 < sum(accepted) < RP_ATTEMPTS


def test_fused_slice_end_point_matches_jax(slice_runs):
    """The standardized, re-validated results of both entry points: xyrra
    within 1e-9 relative, and the port's unsplit optimize2_fused equals the
    split one."""
    (_, j_cd, j_rp), (_, t_cd, t_rp) = slice_runs["jax"], slice_runs["port"]
    assert _rel(t_cd.xyrra_list, j_cd.xyrra_list) <= 1e-9
    assert _rel(t_rp.xyrra_list, j_rp.xyrra_list) <= 1e-9
    assert validate(t_rp, similar_to=_jax_grating().xyrra_list,
                    how_similar=HOW_SIMILAR)
    unsplit = slice_runs["port_unsplit_rp"]
    assert _rel(unsplit.xyrra_list, t_rp.xyrra_list) <= 1e-12
    f0 = _grating().fom(LAM, NUMG, [TFomTerm(*TERMS[0])], device="cpu")
    f1 = t_rp.fom(LAM, NUMG, [TFomTerm(*TERMS[0])], device="cpu")
    assert f1 > f0


# --------------------------------------------------------------------------
# port-only behaviour (no JAX program)
# --------------------------------------------------------------------------

# a tight trust region: the radii cannot move a whole nm, so a member
# stalls after a few rounds
TIGHT = 0.004


def _port_kw(**extra):
    return dict(target_wavelength=LAM, similar_to=_grating().xyrra_list,
                how_similar=TIGHT, numG=NUMG, terms=[TFomTerm(*TERMS[0])],
                verbose=False, device="cpu", **extra)


def test_fused_runs_reproduce_per_seed():
    """Seeded runs are identical (the draws come from a torch.Generator on
    the working device), and the start is left untouched."""
    g = _grating()
    start = g.xyrra_list.copy()
    runs = []
    for _ in range(2):
        a = tfused.optimize_fused(g, seed=2, **_port_kw())
        runs.append((a, tfused.optimize2_fused(a, attempts=4, seed=3,
                                               **_port_kw())))
    for (a1, b1), (a2, b2) in [runs]:
        np.testing.assert_array_equal(a1.xyrra_list, a2.xyrra_list)
        np.testing.assert_array_equal(b1.xyrra_list, b2.xyrra_list)
    assert np.abs(runs[0][1].xyrra_list - start).max() > 0
    np.testing.assert_array_equal(g.xyrra_list, start)


def test_optimize_multistart_best_of_k_and_accept_gate():
    """The best of k is the best of its chains, rescored by Grating.fom;
    restart i is the chain seeded seed + 2i, seed + 2i + 1; a gate that
    refuses restart 0 makes restart 1 the best, and a gate that refuses
    every restart raises."""
    g = _grating()
    kw = _port_kw(attempts=3, seed=7)
    best, foms = tfused.optimize_multistart(g, k=2, **kw)
    assert len(foms) == 2
    fom_kw = dict(numG=NUMG, terms=[TFomTerm(*TERMS[0])], device="cpu")
    assert best.fom(LAM, **fom_kw) == max(foms)
    chain = tfused.optimize_fused(g, seed=9, **_port_kw())
    chain = tfused.optimize2_fused(chain, attempts=3, seed=10, **_port_kw())
    assert chain.fom(LAM, **fom_kw) == foms[1]
    seen = []
    gated, foms2 = tfused.optimize_multistart(
        g, k=2, accept=lambda gg: seen.append(gg) or len(seen) > 1, **kw)
    assert foms2 == foms and len(seen) == 2
    np.testing.assert_array_equal(gated.xyrra_list, chain.xyrra_list)
    with pytest.raises(ValueError, match="accept gate"):
        tfused.optimize_multistart(g, k=1, accept=lambda gg: False, **kw)


def test_vary_angle_use_fused():
    """A fused continuation member is the fused chain from its resized
    seed, with the seeds drawn from rng and the ladder's static envelope;
    a seeded continuation reproduces, and use_gradient is exclusive."""
    from metalens_tpu_torch.engine import static_envelope
    from metalens_tpu_torch.grating import resize
    from metalens_tpu_torch.optimize import (_continuation_ladder,
                                             _init_collection)
    g = _grating()
    # one new member: the end angle between the first and second rung
    rungs = [math.atan(1.05 ** k * math.tan(ANGLE)) for k in (1, 2)]
    kw = dict(numG=NUMG, terms=[TFomTerm(*TERMS[0])], use_fused=True,
              optimize2_attempts=2, verbose=False, change_each_step=1.05,
              similarity_each_step=TIGHT, device="cpu")
    members = []
    for _ in range(2):
        gc = vary_angle(g, sum(rungs) / 2, "round", LAM,
                        rng=np.random.default_rng(5), **kw)
        assert len(gc.grating_list) == 2
        members.append(gc.grating_list[0])     # sorted: the new member
    np.testing.assert_array_equal(members[0].xyrra_list,
                                  members[1].xyrra_list)
    gc0 = _init_collection(g, "round", LAM)
    seed_g = resize(g, gc0.get_one(lateral_period=g.lateral_period * 1.05))
    env = static_envelope(g, _continuation_ladder(gc0, sum(rungs) / 2, 1.05),
                          [LAM], NUMG, dtype=torch.complex128)
    rng = np.random.default_rng(5)
    seeds = [int(rng.integers(2 ** 31)) for _ in range(2)]
    direct = dict(_port_kw(), similar_to=seed_g.xyrra_list,
                  static_override=env)
    want = tfused.optimize_fused(seed_g, seed=seeds[0], **direct)
    want = tfused.optimize2_fused(want, attempts=2, seed=seeds[1], **direct)
    np.testing.assert_array_equal(members[0].xyrra_list, want.xyrra_list)
    assert np.abs(want.xyrra_list - seed_g.xyrra_list).max() > 0
    with pytest.raises(ValueError, match="exclusive"):
        vary_angle(g, sum(rungs) / 2, "round", LAM, use_gradient=True,
                   **kw)


def test_min_gap_floor_holds():
    """An inflated clearance floor the start satisfies holds for the
    result; a floor the start violates leaves it where it was."""
    g = _grating()
    mg = 1.3 * min_distance       # the start clears 140 nm
    out = tfused.optimize_fused(g, seed=1, min_gap=mg, **_port_kw())
    assert bool(tfused.feasible_traced(
        torch.as_tensor(out.xyrra_list), out.grating_period,
        out.lateral_period, min_diameter / 2, mg))
    assert validate(out) and np.abs(out.xyrra_list - g.xyrra_list).max() > 0
    stuck = tfused.optimize_fused(g, seed=1, min_gap=g.lateral_period,
                                  **_port_kw())
    g.standardize()
    np.testing.assert_array_equal(stuck.xyrra_list, g.xyrra_list)


def test_exports_and_cuda_default(monkeypatch):
    """The package exports the three functions (``optimize_fused`` under
    its module's name); without device= they run on CUDA, so where torch
    has no CUDA device each raises instead of running on the CPU."""
    assert metalens_tpu_torch.optimize_fused is tfused.optimize_fused
    assert metalens_tpu_torch.optimize2_fused is tfused.optimize2_fused
    assert (metalens_tpu_torch.optimize_multistart
            is tfused.optimize_multistart)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _grating()
    for call in (lambda: tfused.optimize_fused(g, LAM, numG=NUMG),
                 lambda: tfused.optimize2_fused(g, LAM, numG=NUMG),
                 lambda: tfused.optimize_multistart(g, k=1,
                                                    target_wavelength=LAM,
                                                    numG=NUMG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
