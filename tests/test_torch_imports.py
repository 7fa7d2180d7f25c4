"""The port imports torch and never jax."""

import subprocess
import sys


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import metalens_tpu_torch, metalens_tpu_torch.engine, "
        "metalens_tpu_torch.convert\n"
        "from metalens_tpu_torch.solver import basis, cpx, epsilon, fff, "
        "fom, inv, orders, rcwa, special, taylor\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'metalens_tpu.')))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
