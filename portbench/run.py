#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's inputs from ``--seed`` and warms up every shape it
uses; the window then repeats the cell's unit of work for ``--seconds``;
``--trace 1`` profiles a short stretch after the window and reports the
cell's per-layer metrics instead of its end-to-end ones.  After the window
the outputs are checked against the plain reference (``reference/``), and
the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and, traced,
``breakdown``), and last ``checks``, each compared number beside its
limit.  The same numbers close standard error.

Exit codes: 0 with a result; 3 without a CUDA device (or with fewer than
the cell asks for); 4 if JAX or the JAX package was loaded; 2 for a bad
argument or an unknown cell.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    transformers-style libraries kept off JAX."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness, runner
    try:
        cell = harness.Cell(args.workload)
    except KeyError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)      # one process, few threads: a steadier host
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"torch sees {seen}", file=sys.stderr)
        return 3
    result = runner.execute(cell, args.seed, args.seconds, args.trace,
                            device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    runner.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
