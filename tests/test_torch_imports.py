"""The port imports torch and never jax, and has every public name of the
JAX package but its TPU machinery."""

import ast
import os
import subprocess
import sys

import metalens_tpu
import metalens_tpu_torch


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        "import metalens_tpu_torch, metalens_tpu_torch.engine, "
        "metalens_tpu_torch.convert, metalens_tpu_torch.grating, "
        "metalens_tpu_torch.optimize, metalens_tpu_torch.characterize, "
        "metalens_tpu_torch.hexgrid, metalens_tpu_torch.serialization, "
        "metalens_tpu_torch.assembly, metalens_tpu_torch.nearfield, "
        "metalens_tpu_torch.farfield, metalens_tpu_torch.export, "
        "metalens_tpu_torch.viz, "
        "metalens_tpu_torch.examples.collimator_demo\n"
        "importlib.import_module('metalens_tpu_torch.optimize_fused')\n"
        "from metalens_tpu_torch.parallel import design, distributed, "
        "dryrun, fft, mesh, nearfield, sweep\n"
        "from metalens_tpu_torch.solver import basis, checks, cpx, eig, "
        "epsilon, fff, fields, fom, inv, orders, rcwa, special, taylor\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'metalens_tpu.')))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The JAX package's TPU machinery, which the port leaves behind (ROADMAP.md
# "What the port leaves behind"): the real-pair complex layer and its solve
# variants (torch has complex dtypes and batched solves on CUDA), the
# matmul DFT (torch.fft), the Pallas wrappers (the CUDA kernels of csrc/
# take their place), the XLA compile cache and the fused loop's padding to
# one compiled program per probe batch.
LEFT_BEHIND_MODULES = ("solver.dft", "solver.pallas_inv",
                       "solver.pallas_taylor")
LEFT_BEHIND = {
    "engine:enable_compilation_cache", "optimize_fused:FUSED_PROBE_BATCH",
    "solver.cpx:C", "solver.cpx:MATMUL_PRECISION",
    "solver.cpx:SOLVE_PRECISION", "solver.cpx:USE_PALLAS_SOLVE",
    "solver.cpx:abs2", "solver.cpx:adjoint", "solver.cpx:cabs",
    "solver.cpx:cho_solve_hermitian", "solver.cpx:cho_solve_hermitian_embed",
    "solver.cpx:cho_solve_hermitian_matmul",
    "solver.cpx:cho_solve_hermitian_schur", "solver.cpx:concatenate",
    "solver.cpx:diag", "solver.cpx:exp", "solver.cpx:expi",
    "solver.cpx:from_np", "solver.cpx:inv_blockrec",
    "solver.cpx:inv_blockrec_hermitian", "solver.cpx:matmul",
    "solver.cpx:promote", "solver.cpx:qr_solve", "solver.cpx:solve_matmul",
    "solver.cpx:solve_schur", "solver.cpx:stack", "solver.cpx:to_np",
    "solver.cpx:where", "solver.cpx:zeros"}


def public_names(package):
    """``module:name`` and ``module:Class.method`` for every public
    top-level def, class and assignment of a package's modules (and
    ``__version__`` / ``__all__``), read from the source by ``ast``."""
    root = os.path.dirname(package.__file__)
    names = set()
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            mod = "" if mod == "__init__" else mod.removesuffix(".__init__")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                    if node.name.startswith("_"):
                        continue
                    names.add(f"{mod}:{node.name}")
                    if isinstance(node, ast.ClassDef):
                        names.update(
                            f"{mod}:{node.name}.{m.name}" for m in node.body
                            if isinstance(m, ast.FunctionDef)
                            and not m.name.startswith("_"))
                elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    names.update(
                        f"{mod}:{t.id}" for t in targets
                        if isinstance(t, ast.Name)
                        and (not t.id.startswith("_")
                             or t.id in ("__version__", "__all__")))
    return names


def test_port_has_every_public_name():
    """Every public top-level name and method of metalens_tpu exists in
    metalens_tpu_torch (same module, same name), but the TPU machinery."""
    jax_names = public_names(metalens_tpu)
    assert LEFT_BEHIND <= jax_names
    port_names = public_names(metalens_tpu_torch)
    missing = sorted(
        n for n in jax_names - port_names - LEFT_BEHIND
        if not n.startswith(LEFT_BEHIND_MODULES)
        and not n.startswith("solver.cpx:C."))
    assert not missing, missing
    assert metalens_tpu_torch.__version__ == metalens_tpu.__version__
    assert metalens_tpu_torch.__all__ == metalens_tpu.__all__
