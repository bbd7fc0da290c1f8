"""The port runs without JAX: importing it must not import ``jax`` or the
JAX package ``quemb_tpu``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "quemb_tpu_torch",
    "quemb_tpu_torch.api",
    "quemb_tpu_torch.chem.scf",
    "quemb_tpu_torch.matching.beopt",
    "quemb_tpu_torch.matching.cphf",
    "quemb_tpu_torch.matching.numerical_jac",
    "quemb_tpu_torch.matching.optqn",
    "quemb_tpu_torch.ops.df",
    "quemb_tpu_torch.ops.eri_transform",
    "quemb_tpu_torch.ops.screened_df",
    "quemb_tpu_torch.ops.sparse_df",
    "quemb_tpu_torch.solvers.dispatch",
    "quemb_tpu_torch.solvers.fci",
    "quemb_tpu_torch.solvers.mp2",
)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quemb_tpu'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'quemb_tpu.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
