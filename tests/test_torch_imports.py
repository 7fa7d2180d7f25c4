"""The port imports torch and never jax."""

import subprocess
import sys


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import metalens_tpu_torch, metalens_tpu_torch.engine, "
        "metalens_tpu_torch.convert, metalens_tpu_torch.grating, "
        "metalens_tpu_torch.optimize, metalens_tpu_torch.characterize, "
        "metalens_tpu_torch.hexgrid, metalens_tpu_torch.serialization, "
        "metalens_tpu_torch.assembly, metalens_tpu_torch.nearfield, "
        "metalens_tpu_torch.farfield\n"
        "from metalens_tpu_torch.solver import basis, cpx, epsilon, fff, "
        "fields, fom, inv, orders, rcwa, special, taylor\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'metalens_tpu.')))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
