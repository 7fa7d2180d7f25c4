"""The port's trace registry (``metalens_tpu_torch.trace``): nothing is
recorded with tracing off; under a profiler or ``collect()`` the spans nest
with their parents and self time, the ``span:`` ranges reach the profiler,
and the layers' spans and counters read what the layers did (CPU, small
shapes)."""

from __future__ import annotations

import math
import re
import sys
import threading

import numpy as np
import torch

import chip_smoke
from metalens_tpu_torch import trace
from metalens_tpu_torch.assembly import make_design
from metalens_tpu_torch.grating import Grating, GratingCollection
from metalens_tpu_torch.hexgrid import HexGridSet
from metalens_tpu_torch.optimize_fused import optimize2_fused
from metalens_tpu_torch.solver import orders as ordmod, rcwa
from metalens_tpu_torch.units import degree, nm

LAM = 580 * nm
LX, LY, H = 1200 * nm, 320 * nm, 550 * nm
XY_NM_DEG = np.array([[-300., 0., 110., 90., 0.], [250., 40., 80., 70., 10.]])
EMPTY = {"spans": {}, "counters": {}, "caches": {}}


def _solve():
    """One small NV cell solve on the CPU from host inputs."""
    orders = ordmod.select_orders(LX, LY, 9)
    xy = torch.as_tensor(XY_NM_DEG * [nm, nm, nm, nm, degree])[None]
    c = np.zeros((2 * len(orders), 2))
    i0 = ordmod.order_index(orders, 0, 0)
    c[i0, 0] = c[i0 + len(orders), 1] = 1.0
    return rcwa.cell_amplitudes(orders, xy, LX, LY, H, 2.372 ** 2,
                                1.459 ** 2, LAM, 0.4, 0.0, c, n_slabs=4,
                                taylor_terms=12, fff=True)


def test_off_records_nothing():
    trace.reset()
    assert not trace.enabled()
    first = trace.span("a.b")
    assert trace.span("c.d") is first
    with first:
        trace.count("a.n")
    _solve()
    assert trace.snapshot() == EMPTY


def test_profiler_turns_it_on():
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        with trace.span("t.outer"):
            with trace.span("t.inner"):
                sum(range(20000))
            trace.count("t.items", 3)
    assert not trace.enabled()
    snap = trace.snapshot()
    outer, inner = snap["spans"]["t.outer"], snap["spans"]["t.inner"]
    assert outer["count"] == inner["count"] == 1
    # the inner span is the outer's child: its time leaves the outer's
    # self time, and it holds none itself
    assert inner["self_ms"] == inner["host_ms"]
    assert 0 <= outer["self_ms"]
    assert math.isclose(outer["host_ms"] - outer["self_ms"],
                        inner["host_ms"], rel_tol=1e-9, abs_tol=1e-9)
    assert inner["device_ms"] is None   # no CUDA here
    assert snap["counters"] == {"t.items": 3}
    names = {e.name for e in prof.events()}
    assert {"span:t.outer", "span:t.inner"} <= names


def test_collect_resets_and_chip_smoke_counters():
    trace.reset()
    with trace.collect():
        trace.count("inv.launches.cluster", 2)
        trace.count("inv.launches.registers")
        trace.count("taylor.gemm_launches", 5)
        assert chip_smoke.launch_counts() == {"cinv": 3, "taylor": 5,
                                              "taylor_chunks": 0}
        assert chip_smoke.route_counts() == {"registers": 1, "cluster": 2}
        chip_smoke.reset_counts()
        assert chip_smoke.launch_counts() == {"cinv": 0, "taylor": 0,
                                              "taylor_chunks": 0}
        trace.count("x.y")
    with trace.collect():
        assert trace.snapshot() == EMPTY
    assert not trace.enabled()


def test_counts_and_spans_from_threads():
    """Counters lose no update and spans nest per thread when several
    threads record at once."""
    def work():
        for _ in range(500):
            with trace.span("t.thread"):
                trace.count("t.n")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.collect():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            snap = trace.snapshot()
            assert snap["counters"] == {"t.n": 4000}
            spans = snap["spans"]["t.thread"]
            # no span counted as a child of another thread's span
            assert spans["count"] == 4000
            assert spans["self_ms"] == spans["host_ms"]
    finally:
        sys.setswitchinterval(old)


def test_make_design_spans():
    angles = np.linspace(15, 32, 3) * degree
    lpt = LY / math.tan(angles[1])
    gs = [Grating(lateral_period=lpt * math.tan(a), cyl_height=H,
                  grating_period=LAM / math.sin(a),
                  xyrra_list_in_nm_deg=[[-580 / math.sin(a) / 4, 0, 90, 70, 0],
                                        [580 / math.sin(a) / 4, 0, 70, 80, 0]])
          for a in angles]
    gc = GratingCollection(LAM, lpt, "round", gs)
    hgs = HexGridSet(sep=LY, cyl_height=H, num_entries=3,
                     x_amp_list=np.exp(2j * np.pi * np.arange(3) / 3))
    with trace.collect():
        lps, lcs, _, xyrra = make_design([[(angles[0], angles[-1]), gc]],
                                         10e-6, 5.5e-6, hgs,
                                         make_xyrra_list=True)
        snap = trace.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    subs = ("assembly.rings", "assembly.periphery_pillars",
            "assembly.centre_picks", "assembly.centre_pillars")
    assert set(spans) == {"assembly.make_design", *subs}
    top = spans["assembly.make_design"]
    # each sub-span runs once inside make_design and holds no span: their
    # host time is what make_design's self time leaves out
    for name in subs:
        assert spans[name]["count"] == 1
        assert spans[name]["self_ms"] == spans[name]["host_ms"]
    assert math.isclose(top["host_ms"] - top["self_ms"],
                        sum(spans[n]["host_ms"] for n in subs),
                        rel_tol=1e-9, abs_tol=1e-9)
    assert top["self_ms"] >= 0
    assert counters == {"assembly.centre_sites": len(lcs),
                        "assembly.pillars": len(xyrra)}
    assert len(lcs) > 0 and len(lps["r_center_list"]) > 0


def test_fused_counters(capsys):
    g = Grating(lateral_period=LY, cyl_height=H, target_wavelength=LAM,
                angle_in_air=25 * degree, xyrra_list_in_nm_deg=XY_NM_DEG)
    with trace.collect():
        optimize2_fused(g, LAM, attempts=3, numG=3, device="cpu")
        snap = trace.snapshot()
    accepted = int(re.search(r"\((\d+) accepted\)",
                             capsys.readouterr().out).group(1))
    c = snap["counters"]
    assert c["fused.attempts"] == 3 and c["fused.accepted"] == accepted
    assert c["fused.host_reads"] == 3
    spans = snap["spans"]
    assert spans["fused.call"]["count"] == 1
    assert spans["fused.attempt"]["count"] == 3
    # the start's FOM and one batch per attempt
    assert spans["engine.fom_eval"]["count"] == 4
    assert spans["fused.feasible"]["count"] == 3


def test_cell_solve_on_the_cpu_uploads_nothing():
    with trace.collect():
        _solve()
        snap = trace.snapshot()
    assert "rcwa.h2d_copies" not in snap["counters"]
    for name in ("rcwa.eps", "rcwa.solve"):
        assert snap["spans"][name]["count"] == 1
        assert snap["spans"][name]["device_ms"] is None
    assert all(set(v) == {"hits", "misses"} for v in snap["caches"].values())
    assert "fff._raster_and_basis" in snap["caches"]
