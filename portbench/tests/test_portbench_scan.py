"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "quemb_tpu"}


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "quemb_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "dataclasses", "numpy",
                                       "torch", "portbench"}


def test_scan_sees_whole_names():
    """``quemb_tpu_torch`` begins with ``quemb_tpu`` but is another name."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.py"
        p.write_text("import quemb_tpu_torch.api\nfrom quemb_tpu import x\n")
        assert top_level_imports(p) == {"quemb_tpu_torch", "quemb_tpu"}
