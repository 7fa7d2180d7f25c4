"""Helpers of the benchmark's CPU tests: a copy of the benchmark's data and
drivers in a temporary directory, shrunk to a size a test can hold."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

PARTS = ("configs", "workloads", "traffic", "drivers", "metrics",
         "end_to_end")

# each cell at a size a CPU test holds: batches, attempts, numG and grids
# cut (the solve cell keeps its numG)
TINY = {
    "solve.deflector.b1024": {
        "config": {"numG": 50},
        "traffic": {"batch": 8, "pool": 2, "trace_units": 2},
        "check": {"batches": 2}},
    "design.ns2_member.rp40": {
        "config": {"design_numG": 9},
        "traffic": {"attempts": 12},
        "check": {"calls": 2}},
    "lens.ns2_580": {
        "config": {"characterize_numG": 9, "u_steps": 2, "hex_entries": 4,
                   "radius": 12e-6, "source_distance": 20e-6},
        "traffic": {"aperture_pts": 96, "trace_units": 1},
        "check": {}},
    "db4.ns2_rgb": {
        "config": {"characterize_numG": 9, "u_steps": 2},
        "traffic": {},
        "check": {"calls": 2}},
}


def copy_benchmark(dest: Path) -> Path:
    for part in PARTS:
        shutil.copytree(harness.HERE / part, dest / part)
    shutil.copy(harness.HERE / "settings.json", dest / "settings.json")
    return dest


def shrink(base: Path, name: str, extra=None) -> harness.Cell:
    """The cell ``name`` in the copy at ``base``, its files rewritten at
    the TINY size (and ``extra``, a dict of the same form)."""
    cell = harness.Cell(name, base=base)
    for over in (TINY[name], extra or {}):
        for part, path in (("config", f"configs/{cell.workload['config']}"),
                           ("traffic", f"traffic/{cell.workload['traffic']}"),
                           ("check", f"workloads/{name}")):
            if part not in over:
                continue
            p = base / f"{path}.json"
            d = json.loads(p.read_text())
            (d["check"] if part == "check" else d).update(over[part])
            p.write_text(json.dumps(d))
    return harness.Cell(name, base=base)


@pytest.fixture
def tiny(tmp_path):
    import torch
    torch.set_num_threads(1)
    base = copy_benchmark(tmp_path / "portbench")

    def make(name, extra=None):
        return shrink(base, name, extra)
    return make


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels, which have no CPU mode")
    return torch.device("cuda")
