"""The plain reference against the port, at a tiny size in complex128.

The two agree to the accuracy of the port's J1 (a rational fit with an
absolute error near 1e-8; the reference takes the exact J1), about 1e-7 in
an amplitude; every other step is exact to float64 rounding."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import fom as rfom
from portbench.reference import rcwa as ref

TOL_AMP = 1e-6
TOL_FOM = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("numG,nv", [(9, True), (16, True), (16, False)])
def test_cell_amplitudes_match_the_port(numG, nv):
    from metalens_tpu_torch.solver import orders, rcwa
    cfg = harness.Cell("solve.deflector.b1024").config
    Lx, Ly = cfg["grating_period"], cfg["lateral_period"]
    o = orders.select_orders(Lx, Ly, numG)
    assert (o == ref.select_orders(Lx, Ly, numG)).all()
    rng = np.random.default_rng(3)
    xy = torch.as_tensor(np.asarray(cfg["xyrra"])[None].repeat(3, 0)
                         + rng.normal(0, 2e-9, (3, 2, 5)) * [1, 1, 1, 1, 0])
    ux = torch.tensor([0.36, 0.42, 0.51], dtype=torch.float64)
    uy = torch.tensor([0.0, 0.05, -0.1], dtype=torch.float64)
    ns, tt = rcwa.slab_schedule(2 * math.pi * cfg["cyl_height"]
                                / cfg["wavelength"], o, Lx, Ly,
                                cfg["wavelength"], cfg["n_pillar"] ** 2,
                                dtype=torch.complex128)
    i0 = ref.order_index(o, 0, 0)
    c = np.zeros((2 * numG, 2))
    c[i0, 0] = c[i0 + numG, 1] = 1.0
    args = (xy, Lx, Ly, cfg["cyl_height"], cfg["n_pillar"] ** 2,
            cfg["n_glass"] ** 2, cfg["wavelength"], ux, uy, c)
    af, ar, _, _ = rcwa.cell_amplitudes(o, *args, n_slabs=ns,
                                        taylor_terms=tt, fff=nv)
    bf, br, _, _ = ref.cell_amplitudes(o, *args, nv=nv)
    assert bf.dtype == torch.complex128
    assert float((af - bf).abs().max()) < TOL_AMP
    assert float((ar - br).abs().max()) < TOL_AMP


def test_fom_matches_the_port():
    from metalens_tpu_torch import Grating, validate
    from metalens_tpu_torch.solver.fom import FomTerm
    cell = harness.Cell("design.ns2_member.rp40")
    cfg = dict(cell.config, design_numG=9)
    g = cell.driver().seed_member(Grating, validate, cfg, 19.7, 5)
    terms = [FomTerm(*t) for t in cfg["terms"]]
    port = g.fom(cfg["design_wavelength"], numG=9, terms=terms,
                 device="cpu")
    mine = rfom.fom(cfg, g.grating_period, g.xyrra_list[None])[0]
    assert abs(port - mine) < TOL_FOM


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12)], dtype=torch.float32)
    # ties to even at bit 13: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    want = [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -1.0]
    assert ref.round_tf32(x).tolist() == want
