#!/usr/bin/env python3
"""Runs of one cell, each a process of its own, and the spread of each
metric: for setting and checking the bounds of ``BENCHMARK.json``.

    python3 portbench/spread.py --workload <cell> --seeds 1,2,3,4,5,6 \
        --sets 2 --seconds 10 [--trace 0] [--out runs.jsonl]

Each set runs the same seeds in order.  For each set and metric it prints
the median and the spread, the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) as a share of the
median.  Every run's result line goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(HERE / "run.py"), "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            rec = {"workload": args.workload, "set": k, "seed": seed,
                   "rc": proc.returncode,
                   "wall_s": time.perf_counter() - t0,
                   "result": json.loads(lines[-1]) if proc.returncode == 0
                   and lines else None,
                   "stderr_tail": proc.stderr[-2000:]}
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            res = rec["result"]
            print(json.dumps({"set": k, "seed": seed, "rc": proc.returncode,
                              "wall_s": round(rec["wall_s"], 1),
                              "correct": res and res["correct"],
                              "metrics": res and {m: v["value"] for m, v in
                                                  res["metrics"].items()},
                              "checks": res and {c["name"]: c["value"] for c in
                                                 res["checks"]}}),
                  flush=True)
            runs.append(res)
        sets.append(runs)
    for k, runs in enumerate(sets):
        ok = [r for r in runs if r]
        for m in (ok[0]["metrics"] if ok else {}):
            vals = [r["metrics"][m]["value"] for r in ok if m in r["metrics"]]
            if len(vals) >= 3:
                print(f"set {k} {m}: median {statistics.median(vals)!r} "
                      f"spread {spread(vals)!r} n {len(vals)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
