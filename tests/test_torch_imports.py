"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "deepseek_tpu_torch"
# the port's scripts and worker processes that stand beside the package
STANDALONE = [PKG.parent / "scripts" / "torch_launch_multihost.py",
              PKG.parent / "tests" / "torch_multihost_worker.py"]
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    for p in PKG.rglob("*.py"))


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + STANDALONE,
                         ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_jax_package(path):
    for mod in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "deepseek_tpu", "flax"), \
            f"{path.relative_to(PKG.parent)} imports {mod}"


def test_importing_the_port_leaves_jax_out():
    """Run in a fresh interpreter: tests/conftest.py has imported JAX here."""
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepseek_tpu')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
