"""metalens_tpu_torch -- the PyTorch/CUDA port of :mod:`metalens_tpu`.

The unit-cell RCWA solve and the figure of merit run here in PyTorch, with
the two TPU kernels of the JAX package (``solver/pallas_taylor.py``,
``solver/pallas_inv.py``) replaced by hand-written CUDA kernels for Hopper
(``csrc/``).  The package imports ``torch`` and never ``jax``; the JAX
package stays the reference it is tested against.

Device and dtype are explicit at every entry point: complex128 is the
default on the CPU (parity with the JAX package in float64), complex64 on
CUDA, where the kernels run.
"""


from .grating import Grating  # noqa: F401,E402
from .solver.fom import FomTerm, DEFAULT_FOM_TERMS  # noqa: F401,E402
