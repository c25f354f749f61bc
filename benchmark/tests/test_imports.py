"""No module of the benchmark imports JAX or the JAX package, and the
reference and the frame generator import nothing of the program.  Import
names are compared by their top-level name, whole: the port's package
name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "cartslam_tpu"}
NOT_IN_REFERENCE = NEVER | {"cartslam_tpu_torch"}


def imported_top_names(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_there_are_modules_to_walk():
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_imports(path):
    rel = path.relative_to(BENCH)
    banned = NOT_IN_REFERENCE if rel.parts[0] in ("reference", "data") else NEVER
    assert not imported_top_names(path) & banned


def test_the_walk_sees_a_dotted_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom cartslam_tpu.ops import stereo\n"
                 "import cartslam_tpu_torch\n")
    assert imported_top_names(f) == {"jax", "cartslam_tpu", "cartslam_tpu_torch"}
