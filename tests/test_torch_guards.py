"""Guards of the PyTorch port: it and its scripts for the card import
neither JAX nor the JAX package, and its copies of the JAX-free
middleware stay equal to their originals up to the package name in
import lines."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MIDDLEWARE = [
    "core/__init__.py", "core/task.py", "core/resources.py", "core/policy.py",
    "core/request.py", "core/prefix.py", "core/events.py", "core/router.py",
    "core/autoscale.py", "core/service.py", "core/middleware.py",
    "backends/base.py", "backends/local.py", "serving/qos.py",
]
_FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py", ROOT / "bench_flash.py",
     ROOT / "profile_engine.py", ROOT / "profile_train.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launcher_import_loads_no_jax(launcher):
    code = (f"import sys, repro_torch.launch.{launcher}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _rewrite(text):
    return "".join(
        re.sub(r"\brepro\.", "repro_torch.", line)
        if re.match(r"\s*(from|import)\s", line) else line
        for line in text.splitlines(keepends=True))


@pytest.mark.parametrize("rel", MIDDLEWARE)
def test_middleware_copy_equals_original(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == _rewrite(original)
