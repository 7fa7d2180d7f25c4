"""The port's device mesh: one process per device under torch.distributed.

Counterpart of ``metalens_tpu/parallel/mesh.py``.  A JAX mesh is one
program over many devices; on GPUs the idiom is one process per card, so
the port's mesh is what one process needs to take its part in a sharded
path: its rank, the world size, the process group and its own device.  A
process with no process group gets a one-rank mesh whose collectives are
identities, so every sharded path also runs alone; in a process group,
even of one rank, every collective goes through the backend.

The mesh is a small dataclass, not ``torch.distributed.device_mesh.
DeviceMesh``: a DeviceMesh needs an initialized default process group, so
it cannot stand for the one-rank mesh of a process without one, and the
sharded paths use one axis only.

The collectives below run on the mesh's device: NCCL takes CUDA tensors,
gloo CPU tensors.  Complex tensors travel as ``torch.view_as_real`` pairs
on both backends (NCCL's handling of complex tensors is not gloo's).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import trace
from ..engine import _device


@dataclass(frozen=True)
class Mesh:
    """This process's part of a 1-D mesh: ``rank`` of ``size`` in ``group``
    (None: the default group), computing on ``device``.  Without
    ``distributed`` (no process group; then ``size == 1``) the collectives
    are identities."""
    rank: int
    size: int
    device: torch.device
    group: object = None
    axis_names: tuple = ("cells",)
    distributed: bool = False

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``: the first
        axis carries every rank."""
        return {name: (self.size if i == 0 else 1)
                for i, name in enumerate(self.axis_names)}

    def block(self, total: int) -> tuple:
        """This rank's contiguous [start, stop) block of ``total`` items,
        which must divide evenly over the ranks."""
        if total % self.size:
            raise ValueError(f"{total} items do not divide over "
                             f"{self.size} ranks")
        per = total // self.size
        return self.rank * per, (self.rank + 1) * per

    # ---- collectives (identities without a process group) ----

    @trace.traced("parallel.all_reduce")
    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """Elementwise sum (or ``op``) of ``t`` over the ranks, as a new
        tensor on the mesh's device."""
        t = t.detach().to(self.device).clone()
        if self.distributed:
            dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=self.group)
        return t

    def any(self, flag: bool) -> bool:
        """True when ``flag`` is True on any rank."""
        t = torch.tensor([float(flag)], device=self.device)
        return bool(self.all_reduce(t, dist.ReduceOp.MAX)[0] > 0)

    @trace.traced("parallel.all_gather")
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape on every rank) concatenated along
        dim 0 in rank order."""
        t = t.detach().to(self.device).contiguous()
        if not self.distributed:
            return t
        wire = torch.view_as_real(t) if t.is_complex() else t
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire.contiguous(), group=self.group)
        out = torch.cat(parts)
        return torch.view_as_complex(out) if t.is_complex() else out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of shape (size, ...): block j goes to rank j; returns the
        blocks received, block i from rank i."""
        t = t.contiguous()
        if not self.distributed:
            return t
        wire = torch.view_as_real(t).contiguous() if t.is_complex() else t
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group)
        return torch.view_as_complex(out) if t.is_complex() else out

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        if not self.distributed:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def _local_rank(rank: int) -> int:
    """The card of this process on its host: the launcher's ``LOCAL_RANK``
    when set, else the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def make_mesh(shape=None, axis_names=("cells",), devices=None, *,
              device="cuda", group=None) -> Mesh:
    """This process's mesh over the ranks of ``group`` (default: the
    default process group; a process without one gets a one-rank mesh).

    ``shape=None`` puts every rank on the first axis; any other shape must
    be that one (the sharded paths use one axis).  ``devices``: one device
    per rank, of which this rank takes its own; otherwise ``device``:
    ``"cuda"`` (the default) is ``cuda:{local rank}``, ``"cpu"`` the CPU, a
    device with an index that device."""
    distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        if group is not None:
            raise ValueError("a process group was given, but torch."
                             "distributed is not initialized")
        rank, size = 0, 1
    axis_names = tuple(axis_names)
    want = (size,) + (1,) * (len(axis_names) - 1)
    if shape is not None and tuple(shape) != want:
        raise ValueError(f"mesh shape {tuple(shape)}: the port's mesh puts "
                         f"all {size} ranks on the first axis, {want}")
    if devices is not None:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        dev = _device(devices[rank])
    else:
        dev = _device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", _local_rank(rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, size=size, device=dev, group=group,
                axis_names=axis_names, distributed=distributed)


def default_mesh(axis_name="cells", *, device="cuda") -> Mesh:
    return make_mesh(axis_names=(axis_name,), device=device)
