"""The harness: finds a cell's files by name, runs its set-up, window, trace
and check, and builds the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``)
and the metrics it reports: its end-to-end metrics (``end_to_end/<metric>
.json``; those marked ``every_cell`` besides) and its per-layer metrics
(``metrics/<metric>.py``).  The traffic names its driver
(``drivers/<driver>.py``).  So a cell that reports metrics already there is
one new file.  Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "metalens_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(base: Path, name: str):
    """The reader of the per-layer metric ``name``."""
    return load_module(base / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


class Cell:
    """Everything the benchmark's files say about one cell."""

    def __init__(self, name: str, base: Path = HERE):
        self.base = base
        self.name = name
        path = base / "workloads" / f"{name}.json"
        if not NAME.match(name) or not path.exists():
            raise KeyError(f"no cell {name!r} ({path} missing)")
        self.workload = load_json(path)
        self.config = load_json(base / "configs"
                                / f"{self.workload['config']}.json")
        self.traffic = load_json(base / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.base / "drivers" / f"{name}.py",
                           f"portbench_driver_{name}")

    def _listed(self, key: str, part: str, suffix: str) -> list:
        names = list(self.workload.get(key, []))
        for n in names:
            if not NAME.match(n) or not (self.base / part
                                         / f"{n}{suffix}").exists():
                raise KeyError(f"cell {self.name}: no {key} metric {n!r}")
        return names

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports: those its file lists
        under ``end_to_end``, and those marked ``every_cell``."""
        listed = set(self._listed("end_to_end", "end_to_end", ".json"))
        out = []
        for p in sorted((self.base / "end_to_end").glob("*.json")):
            m = load_json(p)
            if m.get("every_cell") or m["name"] in listed:
                out.append(m)
        return out

    def per_layer(self) -> list:
        """(name, module) of each per-layer metric this cell's file lists
        under ``per_layer``."""
        return [(name, metric_module(self.base, name))
                for name in sorted(self._listed("per_layer", "metrics",
                                                ".py"))]


class Spans:
    """Named spans from the harness's own files around calls into the
    program's layers: CUDA-event and host-clock milliseconds per span, and a
    ``torch.profiler.record_function`` range so that a trace names what the
    host was doing."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda
        self.events = {}
        self.host = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        torch = self.torch
        ev = None
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        with torch.profiler.record_function("span:" + name):
            yield
        self.host.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)
        if ev is not None:
            ev[1].record()
            self.events.setdefault(name, []).append(ev)

    def host_ms(self, name: str) -> list:
        """Host-clock milliseconds of each recorded span ``name``."""
        return list(self.host.get(name, []))

    def device_ms(self, name: str) -> list:
        """CUDA-event milliseconds of each recorded span ``name`` (the
        caller has synchronized)."""
        return [a.elapsed_time(b) for a, b in self.events.get(name, [])]


def trace_summary(prof, torch, window_s: float) -> dict:
    """Device operations of a profiled window: busy seconds (the union of
    the operations' intervals), count, device seconds by name, the longest
    idle gaps labelled by the innermost harness span over them."""
    events = prof.events()
    dev, spans = [], []
    for e in events:
        if e.name.startswith("span:"):    # a harness span, either side
            spans.append((e.time_range.start, e.time_range.end, e.name[5:]))
        elif e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            # a user annotation (such as "nccl:all_gather") only labels the
            # device time of the kernels under it
            dev.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    by_name = {}
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s

    def label(a, b):
        mid = (a + b) / 2
        inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        if not inside:
            return "host outside the spans"
        return "host in " + min(inside, key=lambda sp: sp[1] - sp[0])[2]

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "ops": len(dev),
        "by_name": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[f"{label(a, b)} (gap {i + 1})", (b - a) * 1e-6]
                      for i, (a, b) in enumerate(longest)],
    }


def kernel_seconds(summary: dict, needles) -> float | None:
    """Device seconds of the operations whose name holds one of
    ``needles``; None where no such operation ran."""
    hits = [s for n, s in summary["by_name"].items()
            if any(k in n for k in needles)]
    return sum(hits) if hits else None
