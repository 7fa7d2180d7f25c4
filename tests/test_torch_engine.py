"""Port parity of the FOM entry points (metalens_tpu_torch.engine against
metalens_tpu.engine at float64), with the cell carried across by
convert.grating_from_reference, and the Grating repr round trip across
the two packages."""

import numpy as np
import pytest
import torch

from metalens_tpu import engine as jengine
from metalens_tpu.grating import Grating as JGrating
from metalens_tpu.solver.fom import DEFAULT_FOM_TERMS as JDEFAULT, \
    FomTerm as JFomTerm
from metalens_tpu.units import nm
from metalens_tpu_torch import Grating as TGrating, engine as tengine
from metalens_tpu_torch.convert import grating_from_arrays, \
    grating_from_reference
from metalens_tpu_torch.solver.fom import DEFAULT_FOM_TERMS as TDEFAULT, \
    FomTerm as TFomTerm

torch.set_num_threads(2)

NUMG = 15
XY_NM_DEG = np.array([[-215., 2., 144., 111., 0.], [196., -8., 100., 130., 6.]])
TERMS = [(580 * nm, 1.0, -1, True), (450 * nm, 0.5, 0, False)]


def _jax_grating():
    return JGrating(lateral_period=320 * nm, grating_period=1200 * nm,
                    cyl_height=550 * nm, xyrra_list_in_nm_deg=XY_NM_DEG)


@pytest.fixture(scope="module")
def jax_foms():
    """The JAX engine's FOM of the cell (row 0) and of two perturbed
    copies, from one compiled batch program that both parity tests share,
    with an in-phase and a power-only term."""
    jg = _jax_grating()
    rng = np.random.default_rng(0)
    batch = np.stack([jg.xyrra_list] + [
        jg.xyrra_list + rng.normal(scale=3 * nm, size=jg.xyrra_list.shape)
        * [1, 1, 1, 1, 0] for _ in range(2)])
    want = np.asarray(jengine.fom_batch_fn(
        jg, 580 * nm, NUMG, [JFomTerm(*t) for t in TERMS])(batch))
    return jg, batch, want


def test_fom_of_grating_matches_jax(jax_foms):
    jg, _, want = jax_foms
    tg = grating_from_reference(jg)
    terms = [TFomTerm(*t) for t in TERMS]
    got = tengine.fom_of_grating(tg, target_wavelength=580 * nm, numG=NUMG,
                                 terms=terms)
    assert abs(got - want[0]) < 1e-10
    assert got == tg.fom(target_wavelength=580 * nm, numG=NUMG, terms=terms)
    assert tengine.fom_of_gratings([tg, tg.copy()], 580 * nm, NUMG,
                                   terms) == [got, got]
    fields = ("wavelength", "weight", "target_order", "inphase")
    assert [[getattr(t, f) for f in fields] for t in TDEFAULT] \
        == [[getattr(t, f) for f in fields] for t in JDEFAULT]


def test_fom_batch_fn_matches_jax(jax_foms):
    jg, batch, want = jax_foms
    tg = grating_from_arrays(jg.lateral_period, jg.grating_period,
                             jg.cyl_height, jg.n_glass, jg.n_tio2,
                             jg.xyrra_list)
    got = tengine.fom_batch_fn(tg, 580 * nm, NUMG,
                               [TFomTerm(*t) for t in TERMS])(batch)
    assert got.dtype == torch.float64 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_fom_errors_match_reference_behaviour():
    tg = grating_from_reference(_jax_grating())
    with pytest.raises(ValueError, match="target_wavelength"):
        tg.fom(numG=NUMG)
    with pytest.raises(ValueError, match="outside"):
        tg.fom(target_wavelength=580 * nm, numG=1)


def test_repr_round_trip_across_packages():
    jg = _jax_grating()
    tg = TGrating(lateral_period=320 * nm, grating_period=1200 * nm,
                  cyl_height=550 * nm, xyrra_list_in_nm_deg=XY_NM_DEG)
    assert repr(tg) == repr(jg)
    env = {"np": np, "nm": nm}
    back_t = eval(repr(jg), dict(env, Grating=TGrating))
    back_j = eval(repr(tg), dict(env, Grating=JGrating))
    for g in (back_t, back_j):
        assert g.grating_period == jg.grating_period
        assert g.lateral_period == jg.lateral_period
        assert g.cyl_height == jg.cyl_height
        np.testing.assert_allclose(g.xyrra_list, jg.xyrra_list, rtol=1e-15)
    assert tg.get_angle_in_air(580 * nm) == jg.get_angle_in_air(580 * nm)
    c = tg.copy()
    assert repr(c) == repr(tg) and c.xyrra_list is not tg.xyrra_list
    for units in (None, "nm,deg", "um,deg"):
        for replicas in (None, True):
            np.testing.assert_allclose(
                tg.get_xyrra_list(units, replicas),
                jg.get_xyrra_list(units, replicas), rtol=1e-15)
