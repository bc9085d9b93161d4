"""The port stands alone: no JAX and nothing of the reference package.

Every module of ``src/repro_torch`` and ``chip_smoke.py`` is parsed for
imports of ``jax`` or ``repro`` (``repro_torch`` itself is a different name
and allowed), and the whole package, plus the launcher's ``--help``, is
imported in a fresh interpreter where ``jax`` and ``repro`` cannot load.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    script = f"""
import pkgutil, runpy, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(mod.name)
sys.argv = ["serve", "--help"]
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
print("isolated-ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated-ok" in proc.stdout and "--task" in proc.stdout
