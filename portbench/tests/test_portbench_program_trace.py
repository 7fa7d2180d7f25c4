"""The readers of the program's spans and counters
(``metrics_pending/``): each on a snapshot made by hand, on a stretch in
which its layer did not run and on a program without the registry; then on
the CPU, installed into a copy of the benchmark, in traced runs of the
cells they are for."""

from __future__ import annotations

import json
import shutil

import pytest

from portbench import harness, runner

PENDING = harness.HERE / "metrics_pending"


def _snap(spans=None, counters=None):
    full = {}
    for name, vals in (spans or {}).items():
        full[name] = {"count": 1, "host_ms": 0.0, "self_ms": 0.0,
                      "device_ms": None, **vals}
    return {"spans": full, "counters": dict(counters or {}), "caches": {}}


def _reader(name):
    return harness.load_module(PENDING / f"{name}.py",
                               "portbench_pending_" + name.replace(".", "_"))


# (reader, snapshot, traced units, expected value)
CASES = [
    ("centre_picks_ms.lens",
     _snap({"assembly.centre_picks": {"host_ms": 1500.0}}), 3, 500.0),
    ("periphery_pillars_ms.lens",
     _snap({"assembly.periphery_pillars": {"host_ms": 60.0}}), 3, 20.0),
    ("stitch_centre_ms.lens",
     _snap({"nearfield.centre": {"device_ms": 90.0}}), 3, 30.0),
    ("stitch_host_reads.lens",
     _snap({"nearfield.build": {"count": 3}},
           {"nearfield.host_reads": 21}), 3, 7.0),
    ("fom_issue_ms.design",
     _snap({"engine.fom_eval": {"host_ms": 82.0}, "fused.call": {}},
           {"fused.attempts": 40}), 1, 2.05),
    ("host_reads_per_call.design",
     _snap({"fused.call": {"count": 2}}, {"fused.host_reads": 6}), 2, 3.0),
    ("eps_front_ms.solve",
     _snap({"rcwa.eps": {"device_ms": 31.0}}), 10, 3.1),
    ("h2d_copies_per_batch.solve",
     _snap({"rcwa.solve": {"count": 10}}, {"rcwa.h2d_copies": 100}), 10,
     10.0),
]


@pytest.mark.parametrize("name, snap, units, want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_on_a_snapshot(name, snap, units, want):
    mod = _reader(name)
    assert mod.SOURCE in ("program_span", "program_counter")
    assert mod.read({"program_trace": snap, "units": units}) == \
        pytest.approx(want)
    assert mod.read({"program_trace": _snap(), "units": units}) is None
    assert mod.read({"program_trace": None, "units": units}) is None


def test_counters_read_zero_where_the_layer_ran():
    mod = _reader("h2d_copies_per_batch.solve")
    assert mod.read({"program_trace": _snap({"rcwa.solve": {}}),
                     "units": 10}) == 0.0


def test_pending_readers_are_not_listed_yet():
    """The readers wait outside ``metrics/``: no cell lists them, so the
    benchmark's files and BENCHMARK.json are as they were."""
    listed = {n for p in (harness.HERE / "workloads").glob("*.json")
              for n in json.loads(p.read_text()).get("per_layer", [])}
    pending = {p.name[:-3] for p in PENDING.glob("*.py")}
    assert len(pending) == len(CASES) and not pending & listed
    assert not any((harness.HERE / "metrics" / f"{n}.py").exists()
                   for n in pending)


@pytest.mark.parametrize("cell, always", [
    ("solve.deflector.b1024", {"h2d_copies_per_batch.solve"}),
    ("design.ns2_member.rp40", {"fom_issue_ms.design",
                                "host_reads_per_call.design"}),
    ("lens.ns2_580", {"centre_picks_ms.lens", "periphery_pillars_ms.lens",
                      "stitch_host_reads.lens"})])
def test_readers_in_a_traced_run(tiny, cell, always):
    """Installed into a copy (moved into ``metrics/`` and listed by the
    cell), the readers report in a traced run on the CPU; those of CUDA
    events read nothing there."""
    c = tiny(cell)
    mine = sorted(n for n, *_ in CASES if n.endswith(cell.split(".")[0]))
    for n in mine:
        shutil.copy(PENDING / f"{n}.py", c.base / "metrics" / f"{n}.py")
    path = c.base / "workloads" / f"{cell}.json"
    w = json.loads(path.read_text())
    w["per_layer"] += mine
    path.write_text(json.dumps(w))
    from metalens_tpu_torch import trace
    trace.reset()               # a run is a process of its own
    res = runner.execute(harness.Cell(cell, base=c.base), 11, 0.05, 1,
                         device="cpu")
    assert res["correct"]
    got = {n for n in mine if n in res["metrics"]}
    assert got == always
    assert all(res["metrics"][n]["value"] >= 0 for n in got)
