"""The harness finds everything by name from its files, and a cell, a
configuration or a metric is added by adding files."""

from __future__ import annotations

import ast
import json

import pytest

from portbench import gen_benchmark, harness, runner

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_is_built_from_the_files():
    bench = gen_benchmark.build()
    assert gen_benchmark.problems(bench) == []
    on_disk = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert on_disk == bench


@pytest.mark.parametrize("name", ["solve.deflector.b1024",
                                  "design.ns2_member.rp40", "lens.ns2_580",
                                  "db4.ns2_rgb"])
def test_cells_found_by_name(name):
    cell = harness.Cell(name)
    assert cell.config["name"] == cell.workload["config"]
    driver = cell.driver()
    assert callable(driver.execute if cell.chips > 1 else driver.check)
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) == 2
    layers = cell.per_layer()
    assert layers and all(mod.MOVES in e2e for _, mod in layers)


def test_unknown_cell():
    with pytest.raises(KeyError):
        harness.Cell("no.such.cell")


def test_a_cell_config_and_metric_added_by_files(tiny, tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    each a new file: the cell reports the end-to-end and per-layer metrics
    already there that its own file lists, and the new one, and the
    generator lists them, with no file that was there edited."""
    cell = tiny("solve.deflector.b1024")
    base = cell.base
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = dict(cell.config, name="deflector_thin", cyl_height=3e-07)
    (base / "configs/deflector_thin.json").write_text(json.dumps(cfg))
    (base / "traffic/b2_wide.json").write_text(json.dumps(
        dict(cell.traffic, batch=2, ux=[0.2, 0.6])))
    (base / "workloads/solve.thin.b2.json").write_text(json.dumps({
        "name": "solve.thin.b2", "config": "deflector_thin",
        "traffic": "b2_wide", "chips": 1, "why": "a throwaway cell",
        "end_to_end": ["solves_per_s"],
        "per_layer": ["units_traced.thin", "device_idle_pct.solve"],
        "check": cell.workload["check"]}))
    (base / "metrics/units_traced.thin.py").write_text(
        'UNIT, BETTER, SOURCE = "units", "higher", "host_clock"\n'
        'LAYER = "cell solve"\nMOVES = "solves_per_s"\n\n\n'
        'def read(ctx):\n    return float(ctx["units"])\n')
    new = harness.Cell("solve.thin.b2", base=base)
    res = runner.execute(new, 7, 0.05, 0, device="cpu")
    assert res["correct"]
    assert set(res["metrics"]) == {"setup_s", "solves_per_s"}
    assert res["metrics"]["solves_per_s"]["value"] > 0
    res = runner.execute(new, 7, 0.05, 1, device="cpu")
    assert res["correct"] and res["metrics"]["units_traced.thin"]["value"] \
        == 2.0
    assert set(res["metrics"]) <= {"units_traced.thin",
                                   "device_idle_pct.solve"}
    bench = gen_benchmark.build(base)
    assert gen_benchmark.problems(bench) == []
    assert "deflector_thin" in {c["name"] for c in bench["configs"]}
    assert "solve.thin.b2" in {w["name"] for w in bench["workloads"]}
    metrics = {m["name"]: m for m in bench["end_to_end"]
               + bench["per_layer"]}
    for name in ("solves_per_s", "units_traced.thin",
                 "device_idle_pct.solve"):
        assert "solve.thin.b2" in metrics[name]["workloads"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_cell_lists_only_metrics_that_exist(tiny):
    cell = tiny("solve.deflector.b1024")
    path = cell.base / "workloads/solve.deflector.b1024.json"
    w = json.loads(path.read_text())
    path.write_text(json.dumps(dict(w, per_layer=["no_such.metric"])))
    with pytest.raises(KeyError):
        harness.Cell("solve.deflector.b1024", base=cell.base).per_layer()


def test_result_line_keys(tiny, capsys):
    cell = tiny("solve.deflector.b1024")
    for trace in (0, 1):
        res = runner.execute(cell, 2 ** 33 + 5, 0.05, trace, device="cpu")
        runner.report(res)
        out, err = capsys.readouterr()
        line = json.loads(out.strip().splitlines()[-1])
        keys = list(line)
        assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
        assert ("breakdown" in keys) == bool(trace)
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"])
        else:
            assert set(line["metrics"]) == {"setup_s", "solves_per_s"}
        assert err.strip().splitlines()[-1].startswith("check amp_err: ")


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["metalens_tpu_torch", "metalens_tpu_torch.solver", "jaxtyping",
            "jax_plugins", "numpy", "flaxen"]
    assert harness.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "metalens_tpu", "metalens_tpu.solver"]
    assert harness.forbidden_modules(mods + bad) == sorted(bad)


def test_run_exits_without_a_card(monkeypatch, capsys):
    import torch
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "solve.deflector.b1024", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"metalens_tpu_torch", "metalens_tpu", "jax",
                           "jaxlib", "flax"}, path


def test_no_benchmark_file_imports_jax():
    for path in harness.HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"metalens_tpu", "jax", "jaxlib", "flax"}, path
