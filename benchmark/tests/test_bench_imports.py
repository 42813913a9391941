"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under ``benchmark/``, and nothing of the program in the references.  Names
are compared by their whole top-level part (``ggrs_tpu_torch`` is not
``ggrs_tpu``)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ggrs_tpu"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "_cache" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


REFERENCE = sorted((BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "collections", "functools", "math",
                                       "types", "typing", "torch"}


def test_the_program_is_not_the_jax_package():
    """The port's top-level name starts with the JAX package's; the run's
    check must not take one for the other."""
    import ggrs_tpu_torch  # noqa: F401

    from benchmark import harness

    assert harness.forbidden_modules() == []
