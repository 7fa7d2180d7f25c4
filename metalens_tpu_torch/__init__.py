"""metalens_tpu_torch -- the PyTorch/CUDA port of :mod:`metalens_tpu`.

The unit-cell RCWA solve, the figure of merit and its shape gradient, the
design loop (the host optimizers and ``vary_angle``), the amplitude
databases (characterize, the interpolators, ``HexGridSet``, npz save and
load) and the lens check (assembly, the near-field stitch, the far field
and its focal metrics) run here in PyTorch, with
the two TPU kernels of the JAX package (``solver/pallas_taylor.py``,
``solver/pallas_inv.py``) replaced by hand-written CUDA kernels for Hopper
(``csrc/``).  The package imports ``torch`` and never ``jax``; the JAX
package stays the reference it is tested against.

Device and dtype are explicit at every entry point: complex128 is the
default on the CPU (parity with the JAX package in float64), complex64 on
CUDA, where the kernels run.
"""


from .grating import (Grating, GratingCollection, validate,  # noqa: F401
                      resize, min_diameter, min_distance)
from .solver.fom import FomTerm, DEFAULT_FOM_TERMS  # noqa: F401
from .engine import fom_value_and_grad  # noqa: F401
from .optimize import (optimize, optimize2, optimize_gradient,  # noqa: F401
                       vary_angle)
from .hexgrid import HexGridSet  # noqa: F401
from .serialization import save, load  # noqa: F401
from .assembly import make_design  # noqa: F401
from .nearfield import build_nearfield  # noqa: F401
# the function ``farfield`` takes the package attribute of the module of
# the same name: reach the module by ``from metalens_tpu_torch.farfield
# import ...`` or importlib
from .farfield import farfield, focal_metrics  # noqa: F401
