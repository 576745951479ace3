"""Nothing under perfbench/ imports JAX or the JAX package, by whole
top-level name; the reference imports nothing of the program either."""
import ast
from pathlib import Path

import pytest

from perfbench import run

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_program_free_reference(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(ROOT).parts:
        assert "repro_torch" not in names


def test_forbidden_modules_compares_whole_names():
    assert run.forbidden_modules(["repro_torch.models", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                  "flaxen"]) == ["jax", "jaxlib", "repro"]
