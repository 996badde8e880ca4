"""No module of the benchmark imports JAX, Flax or the JAX package, and
the reference imports nothing of the program under test either.  Each
import's top-level name is compared whole: the port's name begins with
the JAX package's."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "sparsefusion_tpu"}
PROGRAM = "sparsefusion_tpu_torch"


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_side(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_names_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import sparsefusion_tpu_torch.models\n"
                   "from sparsefusion_tpu.nn import unet\n")
    assert top_level_imports(src) == {PROGRAM, "sparsefusion_tpu"}
