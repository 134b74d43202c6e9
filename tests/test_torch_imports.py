"""The port imports neither JAX nor anything of the JAX package.

An AST walk over every module of ``incubator_mxnet_tpu_torch`` (and over
``chip_smoke.py``) finds each import, absolute or relative, and resolves
relative ones against the module's package; a fresh interpreter that
imports the port must end with neither ``jax`` nor ``incubator_mxnet_tpu``
in ``sys.modules``.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "incubator_mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


def _imports(path: Path):
    """Absolute names of every module `path` imports."""
    # the package a module (or an __init__) resolves relative imports in
    package = list(path.relative_to(ROOT).with_suffix("").parts)[:-1]
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                up = node.level - 1
                if up > len(package):
                    names.append("<beyond the repository root>")
                    continue
                base = package[:len(package) - up]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            names.append(mod)
            names.extend(f"{mod}.{a.name}" for a in node.names)
    return names


def _bad(name):
    return (name.startswith("<") or any(
        name == f or name.startswith(f + ".") for f in FORBIDDEN))


def _files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_walk_finds_the_package_and_resolves_relative_imports():
    files = _files()
    assert len(files) > 15 and (PKG / "serving" / "frozen.py") in files
    for new in (PKG / "autograd.py", PKG / "optimizer" / "__init__.py",
                PKG / "gluon" / "trainer.py", PKG / "gluon" / "loss.py",
                PKG / "models" / "transformer_lm.py"):
        assert new in files, new
    names = _imports(PKG / "serving" / "frozen.py")
    assert "incubator_mxnet_tpu_torch.profiler" in names
    assert "incubator_mxnet_tpu_torch.serving.errors" in names


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package_import(path):
    bad = [n for n in _imports(path) if _bad(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_fresh_import_loads_no_jax():
    code = ("import json, sys, incubator_mxnet_tpu_torch, "
            "incubator_mxnet_tpu_torch.serving, "
            "incubator_mxnet_tpu_torch.models.bert, "
            "incubator_mxnet_tpu_torch.models.transformer_lm, "
            "incubator_mxnet_tpu_torch.gluon.trainer, "
            "incubator_mxnet_tpu_torch.gluon.loss, "
            "incubator_mxnet_tpu_torch.optimizer, "
            "incubator_mxnet_tpu_torch.autograd; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'incubator_mxnet_tpu'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
