#!/usr/bin/env python3
"""Readings for a cell's limits: the program's compared numbers and its
control's, over many seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--device cuda] [--out file.jsonl]

For each seed: the cell's set-up, a window of ``--seconds``, the check
(the program's reading), then the control -- the plain reference put in
the program's place one precision step below the configuration's -- held
to the same check (the control's reading).  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness, runner
    from portbench.run import cache_env
    cache_env()
    import torch
    cell = harness.Cell(args.workload)
    driver = cell.driver()
    out = open(args.out, "a") if args.out else None
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell.chips > 1:
        # one world for every seed; rank 0 reads the program and the control
        results = driver.execute(cell, seeds[0], args.seconds, 0,
                                 time.perf_counter(), device=args.device,
                                 seeds=seeds, control=True)
        for seed, res in zip(seeds, results):
            line = {"workload": args.workload, "seed": seed,
                    "program": {c["name"]: c["value"]
                                for c in res["checks"]},
                    "control": res["control"], "failed": res["failed"]}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
        return 0
    for seed in seeds:
        t0 = time.perf_counter()
        state = driver.setup(cell, seed, args.device)
        spans = harness.Spans(torch, args.device == "cuda")
        units, _ = runner.window(driver, state, spans, args.seconds)
        driver.release(state)
        program, _, failed = driver.check(state)
        ctrl = driver.control(state)
        line = {"workload": args.workload, "seed": seed, "units": units,
                "program": {c["name"]: c["value"] for c in program},
                "control": {c["name"]: c["value"] for c in ctrl},
                "failed": failed, "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del state
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
