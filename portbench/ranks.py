"""Cells on several chips: one process per card in a torch.distributed world.

:func:`spawn` starts ``world`` processes (spawned, so each imports afresh)
that rendezvous through a file store in a fresh directory under
``TMPDIR``; each runs :func:`rank_main`, which loads the cell's driver by
path and calls its ``rank_run(ctx)``.  Rank 0 returns its result through a
JSON file in that directory.  NCCL on CUDA (``NCCL_SOCKET_IFNAME=lo`` unless
set: the ranks share one host), gloo on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path


def rank_main(rank, world, base, cell_name, args, device, store, out_path):
    root = str(Path(base).resolve().parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch
    torch.set_num_threads(1)
    from portbench import harness
    from portbench.run import cache_env
    from metalens_tpu_torch import parallel
    cache_env(Path(root))
    cell = harness.Cell(cell_name, base=Path(base))
    driver = cell.driver()
    if device == "cuda":
        torch.cuda.set_device(rank)
    parallel.init_distributed(f"file://{store}", world, rank,
                              device=device, timeout=600)
    mesh = parallel.global_mesh(device=device)
    try:
        result = driver.rank_run(cell, mesh, **args)
        bad = harness.forbidden_modules()
        if bad:
            raise RuntimeError(f"rank {rank} loaded {', '.join(bad)}")
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(result, f)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(cell, world: int, args: dict, device: str = "cuda",
          timeout: float = 900.0):
    """Run the cell's ``rank_run`` on ``world`` ranks; rank 0's result."""
    import torch.multiprocessing as mp
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp(prefix="portbench_world_")
    try:
        out_path = os.path.join(tmp, "result.json")
        store = os.path.join(tmp, "store")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, str(cell.base), cell.name, args,
                                   device, store, out_path))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(30)
        codes = [p.exitcode for p in procs]
        if alive or any(codes) or not os.path.exists(out_path):
            raise RuntimeError(f"ranks ended with {codes}"
                               + (" (timed out)" if alive else ""))
        with open(out_path) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
