"""The port runs without JAX: importing it must not import ``jax`` or the
JAX package ``quemb_tpu``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "quemb_tpu_torch",
    "quemb_tpu_torch.api",
    "quemb_tpu_torch.config",
    "quemb_tpu_torch.embed.energy",
    "quemb_tpu_torch.entry",
    "quemb_tpu_torch.chem.ecp",
    "quemb_tpu_torch.chem.integrals",
    "quemb_tpu_torch.chem.mole",
    "quemb_tpu_torch.chem.scf",
    "quemb_tpu_torch.chem.sph",
    "quemb_tpu_torch.fragment.autogen",
    "quemb_tpu_torch.fragment.graphgen",
    "quemb_tpu_torch.kbe",
    "quemb_tpu_torch.kbe.cell",
    "quemb_tpu_torch.kbe.df",
    "quemb_tpu_torch.kbe.exact4c",
    "quemb_tpu_torch.kbe.fragment",
    "quemb_tpu_torch.kbe.lo",
    "quemb_tpu_torch.kbe.pbc_int",
    "quemb_tpu_torch.kbe.pbe",
    "quemb_tpu_torch.kbe.pfrag",
    "quemb_tpu_torch.kbe.scf",
    "quemb_tpu_torch.kbe.wannier",
    "quemb_tpu_torch.lo.iao",
    "quemb_tpu_torch.lo.jacobi",
    "quemb_tpu_torch.matching.beopt",
    "quemb_tpu_torch.matching.cphf",
    "quemb_tpu_torch.matching.numerical_jac",
    "quemb_tpu_torch.matching.optqn",
    "quemb_tpu_torch.mf_interfaces",
    "quemb_tpu_torch.misc",
    "quemb_tpu_torch.native",
    "quemb_tpu_torch.native.eri_native",
    "quemb_tpu_torch.ops.df",
    "quemb_tpu_torch.ops.eri_transform",
    "quemb_tpu_torch.ops.screened_df",
    "quemb_tpu_torch.ops.sparse_df",
    "quemb_tpu_torch.parallel.mesh",
    "quemb_tpu_torch.scanner",
    "quemb_tpu_torch.solvers.ccsd",
    "quemb_tpu_torch.solvers.ccsd_mat",
    "quemb_tpu_torch.solvers.ccsd_relaxed",
    "quemb_tpu_torch.solvers.dispatch",
    "quemb_tpu_torch.solvers.dmrg",
    "quemb_tpu_torch.solvers.fci",
    "quemb_tpu_torch.solvers.mp2",
    "quemb_tpu_torch.solvers.rccsd",
    "quemb_tpu_torch.solvers.sci",
    "quemb_tpu_torch.solvers.uccsd",
    "quemb_tpu_torch.ube",
    "quemb_tpu_torch.utils.device",
    "quemb_tpu_torch.utils.geometry",
    "quemb_tpu_torch.utils.helper",
    "quemb_tpu_torch.utils.io",
    "quemb_tpu_torch.utils.profiling",
    "quemb_tpu_torch.utils.scratch",
)


def _walk():
    """Every module of the port, from its files."""
    pkg = os.path.join(ROOT, "quemb_tpu_torch")
    for base, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(base, f), ROOT)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == "__init__":
                    parts.pop()
                yield ".".join(parts), os.path.join(base, f)


def test_every_module_is_listed_and_names_no_jax():
    """The list above covers the new host modules, and no source file of
    the port (nor chip_smoke.py or tools/profile_port.py) imports jax or
    the JAX package."""
    import re

    walked = dict(_walk())
    assert set(MODULES) <= set(walked)
    for m in ("native", "native.eri_native", "config", "utils.geometry",
              "chem.integrals", "chem.sph", "lo.iao", "lo.jacobi",
              "solvers.sci", "solvers.dmrg", "solvers.ccsd_mat",
              "solvers.ccsd_relaxed", "solvers.uccsd", "ube", "chem.ecp",
              "fragment.autogen", "fragment.graphgen", "misc",
              "mf_interfaces", "scanner", "utils.helper", "utils.io",
              "utils.profiling", "utils.scratch", "embed.energy", "kbe",
              "kbe.cell", "kbe.df", "kbe.exact4c", "kbe.fragment", "kbe.lo",
              "kbe.pbc_int", "kbe.pbe", "kbe.pfrag", "kbe.scf",
              "kbe.wannier", "parallel.mesh", "entry"):
        assert f"quemb_tpu_torch.{m}" in MODULES
    bad = re.compile(
        r"^\s*(import|from)\s+(jax|quemb_tpu)(\.|\s|$)", re.MULTILINE
    )
    walked["chip_smoke"] = os.path.join(ROOT, "chip_smoke.py")
    walked["profile_port"] = os.path.join(ROOT, "tools", "profile_port.py")
    for name, path in walked.items():
        with open(path) as fh:
            assert not bad.search(fh.read()), name


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quemb_tpu'] = None\n"
        "import importlib\n"
        f"for m in {tuple(m for m, _ in _walk())!r}:\n"
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
