"""Multi-process (multi-host) scale-out for sweep workloads.

Counterpart of ``metalens_tpu/parallel/distributed.py``.  The reference
scales past one machine by launching more interpreter processes, each over
a hand-split range of cells (reference ``grating.py:30-35, 1173-1184``).
The JAX package wires hosts into one SPMD runtime with
``jax.distributed``; the port runs one process per device and wires them
with ``torch.distributed``: NCCL between cards, gloo between CPU
processes.  Nothing here discovers a cluster: the caller (or a launcher
such as ``torchrun``, through its environment) gives the coordinator's
address, the world size and the rank.

A single process is the degenerate case of the same API: every function
here is a no-op or an identity without a process group.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from .mesh import _local_rank, make_mesh


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, *,
                     device="cuda", timeout=None):
    """Join the process group (idempotent; a no-op for a single process).

    ``coordinator_address``: ``"host:port"`` of rank 0 (a TCP store), a
    ``"file://..."`` path every process can reach (a file store, no
    network), or ``"env://"`` for a launcher's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.  ``num_processes`` and
    ``process_id`` are the world size and this process's rank (None with
    ``env://``).  The backend is NCCL when ``device`` is CUDA, on the card
    ``local_device_ids[0]`` (default: the launcher's ``LOCAL_RANK``, else
    the rank modulo the host's cards), and gloo on the CPU.  ``timeout``
    (seconds) bounds every collective, so a lost rank fails instead of
    hanging."""
    if _initialized():
        return
    if coordinator_address is None and num_processes in (None, 1):
        return
    if coordinator_address is None:
        raise ValueError("coordinator_address is required for "
                         f"{num_processes} processes")
    dev = torch.device(device)
    if dev.type == "cuda":
        card = (local_device_ids[0] if local_device_ids
                else dev.index if dev.index is not None
                else _local_rank(process_id or 0))
        torch.cuda.set_device(card)
        backend = "nccl"
    else:
        backend = "gloo"
    init_method = (coordinator_address
                   if coordinator_address.startswith(("tcp://", "file://",
                                                      "env://"))
                   else f"tcp://{coordinator_address}")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes if num_processes
                            else -1, rank=-1 if process_id is None
                            else process_id, **kwargs)


def global_mesh(axis_names=("cells",), shape=None, *, device="cuda"):
    """The mesh over every process of the default group (after
    :func:`init_distributed`; a one-rank mesh without one)."""
    return make_mesh(shape=shape, axis_names=axis_names, device=device)


def _on_device(mesh, tree):
    """Every array leaf of a pytree (dicts, lists, tuples) as a tensor on
    the mesh's device."""
    if isinstance(tree, dict):
        return {k: _on_device(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(mesh, v) for v in tree)
    return torch.as_tensor(np.asarray(tree)).to(mesh.device)


def global_batch_from_host_shards(mesh, host_local_batch, axis_name="cells"):
    """This rank's shard of a global batch, on its device.

    ``host_local_batch`` is a pytree (dicts, lists, tuples) of arrays
    holding this process's cells (leading axis = local batch).  In the JAX
    package the shards become one global array; here each rank keeps its
    own shard, which it computes on, and nothing is gathered."""
    return _on_device(mesh, host_local_batch)


def replicate_to_mesh(mesh, pytree):
    """Host-identical values (scalars, per-term tables) as tensors on this
    rank's device.  Every process must pass the same values (the SPMD
    contract)."""
    return _on_device(mesh, pytree)


def host_slice(total: int, axis_size: int = None):
    """This process's contiguous [start, stop) range of a global batch of
    ``total`` items -- the reference's hand-split ``worker_number`` ranges
    (``grating.py:1173-1184``) taken from the rank and the world size: the
    block :meth:`Mesh.block` gives this rank.  ``total`` must divide
    evenly over the processes."""
    return make_mesh(device="cpu").block(total)


def multihost_barrier(name: str = "metalens_sync"):
    """Block until every process reaches this point (no-op for one
    process).  ``name`` is kept for the JAX signature; torch's barrier is
    unnamed."""
    if _initialized() and dist.get_world_size() > 1:
        dist.barrier()
