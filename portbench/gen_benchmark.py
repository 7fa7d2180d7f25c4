#!/usr/bin/env python3
"""Writes ``BENCHMARK.json`` at the root of the checkout from the
benchmark's own files, and checks it against them.

    python3 portbench/gen_benchmark.py          # write
    python3 portbench/gen_benchmark.py --check  # exit 1 if it differs

Sources: ``settings.json`` (command, paths, run_seconds),
``configs/*.json``, ``workloads/*.json``, ``end_to_end/*.json`` and
``metrics/*.py``.  Each metric's ``workloads`` are the cells whose files
list it.  A cell, a configuration or a metric is added by adding its file
and running this script.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import NAME, metric_module  # noqa: E402

UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _load(path):
    with open(path) as f:
        return json.load(f)


def build(base: Path = HERE) -> dict:
    settings = _load(base / "settings.json")
    rel = base.name
    configs = []
    for p in sorted((base / "configs").glob("*.json")):
        c = _load(p)
        configs.append({"name": c["name"], "source": c["source"],
                        "file": f"{rel}/configs/{p.name}",
                        "reduced": c["reduced"], "why": c["why"]})
    workloads, cells = [], []
    for p in sorted((base / "workloads").glob("*.json")):
        w = _load(p)
        cells.append(w)
        workloads.append({k: w[k] for k in
                          ("name", "config", "traffic", "chips", "why")})

    def listing(key, name):
        return [w["name"] for w in cells if name in w.get(key, [])]
    e2e = []
    for p in sorted((base / "end_to_end").glob("*.json")):
        m = _load(p)
        e = {k: m[k] for k in ("name", "unit", "better", "bound", "source")}
        if not m.get("every_cell"):
            e["workloads"] = listing("end_to_end", m["name"])
        e2e.append(e)
    per_layer = []
    for p in sorted((base / "metrics").glob("*.py")):
        name = p.name[:-3]
        mod = metric_module(base, name)
        per_layer.append({"name": name, "unit": mod.UNIT,
                          "better": mod.BETTER, "source": mod.SOURCE,
                          "layer": mod.LAYER, "moves": mod.MOVES,
                          "workloads": listing("per_layer", name)})
    return {"command": settings["command"], "paths": settings["paths"],
            "run_seconds": settings["run_seconds"], "configs": configs,
            "workloads": workloads, "end_to_end": e2e,
            "per_layer": per_layer}


def problems(bench: dict) -> list:
    """What in ``bench`` breaks the contract's rules on names, units,
    references between entries and counts (empty when none)."""
    out = []
    names = {}
    cfgs = {c["name"] for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            if not NAME.match(e["name"]):
                out.append(f"{kind}: bad name {e['name']!r}")
            if e["name"] in names.get(kind, set()):
                out.append(f"{kind}: {e['name']} twice")
            names.setdefault(kind, set()).add(e["name"])
            for k in ("why", "layer", "source"):
                v = e.get(k)
                if isinstance(v, str) and not (1 <= len(v) <= 200) or \
                        isinstance(v, str) and ("\n" in v or "\t" in v):
                    out.append(f"{e['name']}: {k} is not one line of 1-200")
    for w in bench["workloads"]:
        if w["config"] not in cfgs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips must be 1 or 4")
        if not NAME.match(w["traffic"]):
            out.append(f"{w['name']}: bad traffic name")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    if len(set(pairs)) != len(pairs):
        out.append("a (config, traffic) pair appears twice")
    used = {w["config"] for w in bench["workloads"]}
    for c in cfgs - used:
        out.append(f"config {c} used by no cell")
    if sum(w["chips"] == 4 for w in bench["workloads"]) > \
            max(1, len(bench["workloads"]) // 4):
        out.append("too many four-chip cells")
    if "setup_s" not in e2e or e2e["setup_s"]["bound"] > 0.25:
        out.append("setup_s missing or its bound above 0.25")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better must be lower or higher")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: bad source {m['source']}")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']}: unknown cell {c}")
        if m.get("workloads") == []:
            out.append(f"{m['name']}: reported by no cell")
    for m in bench["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: end-to-end source must be host_clock "
                       f"or device_trace")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound outside 0.01-0.25")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']}")
            continue
        target = e2e[m["moves"]]
        for c in m.get("workloads", []):
            if "workloads" in target and c not in target["workloads"]:
                out.append(f"{m['name']}: cell {c} does not report "
                           f"{m['moves']}")
    for c in cells:
        reported = [m for m in bench["end_to_end"]
                    if "workloads" not in m or c in m["workloads"]]
        if len(reported) < 2:
            out.append(f"{c}: needs setup_s and another end-to-end metric")
        if not any(c in m.get("workloads", [c]) for m in bench["per_layer"]):
            out.append(f"{c}: no per-layer metric")
    if not 1 <= bench["run_seconds"] <= 51:
        out.append("run_seconds outside 1-51")
    if len(json.dumps(bench)) > 64 * 1024:
        out.append("larger than 64 KiB")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--check", action="store_true")
    args = p.parse_args(argv)
    bench = build()
    bad = problems(bench)
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    text = json.dumps(bench, indent=1) + "\n"
    target = ROOT / "BENCHMARK.json"
    if args.check:
        same = target.exists() and target.read_text() == text
        print("BENCHMARK.json " + ("matches" if same else "differs"))
        return 0 if same else 1
    target.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
