"""Multi-device execution of the port: one process per device under
torch.distributed.

Counterpart of ``metalens_tpu/parallel``.  The reference's only
parallelism is OS-process fan-out over independent S4 solves (reference
``grating.py:1062-1072, 1173-1184``).  The JAX package runs one SPMD
program over a device mesh; on GPUs each card gets a process, and the
processes meet in collectives (NCCL on cards, gloo on the CPU):

* the solve batch axis (cells x angles x wavelengths) is split over the
  ranks, gradients and FOM means combined by all-reduce and all-gather
  (:mod:`.sweep`);
* the full-lens aperture is split by rows over the ranks' devices: the
  stitch runs per block (:mod:`.nearfield`), and the near-to-far-field
  FFT is a transpose-based distributed 2-D FFT with all-to-all
  (:mod:`.fft`);
* independent fused-optimizer members run one per rank (:mod:`.design`);
* processes on many hosts join one group through :mod:`.distributed`.

:mod:`.dryrun` drives all six paths over an n-rank world.
"""

from .mesh import make_mesh, default_mesh
from .sweep import sharded_fom_and_grad, sharded_characterize_amps
from .fft import fft2_sharded, farfield_sharded
from .nearfield import build_nearfield_sharded
from .design import sharded_member_optimize
from .distributed import (init_distributed, global_mesh,
                          global_batch_from_host_shards, replicate_to_mesh,
                          host_slice, multihost_barrier)

__all__ = ["make_mesh", "default_mesh", "sharded_fom_and_grad",
           "sharded_characterize_amps", "fft2_sharded", "farfield_sharded",
           "build_nearfield_sharded", "sharded_member_optimize",
           "init_distributed", "global_mesh",
           "global_batch_from_host_shards", "replicate_to_mesh",
           "host_slice", "multihost_barrier"]
