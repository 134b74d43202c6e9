"""The port imports neither JAX nor anything of the JAX package, its
entry points need a card unless given ``cpu()``, and no module of it draws
from torch's global RNG.

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
    for new in (PKG / "autograd.py", PKG / "random.py",
                PKG / "optimizer" / "__init__.py",
                PKG / "gluon" / "trainer.py", PKG / "gluon" / "loss.py",
                PKG / "models" / "transformer_lm.py",
                PKG / "models" / "resnet.py",
                PKG / "ops" / "cuda" / "conv_bn_relu.py"):
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
            "incubator_mxnet_tpu_torch.models.resnet, "
            "incubator_mxnet_tpu_torch.ops.cuda.conv_bn_relu, "
            "incubator_mxnet_tpu_torch.gluon.trainer, "
            "incubator_mxnet_tpu_torch.gluon.loss, "
            "incubator_mxnet_tpu_torch.optimizer, "
            "incubator_mxnet_tpu_torch.autograd, "
            "incubator_mxnet_tpu_torch.random; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'incubator_mxnet_tpu'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


ENTRY_POINTS = ["get_bert_model", "BERTForPretrain", "transformer_lm_small",
                "resnet50_v1", "resnet18_v2", "get_resnet",
                "resnet50_v1_bnrelu", "FrozenModel", "nd.array", "nd.zeros",
                "nd.random.uniform", "nd.NDArray"]
# built on the CPU as well (the full-size ones are built by their tests)
SMALL = ("transformer_lm_small", "resnet18_v2", "resnet50_v1_bnrelu",
         "FrozenModel", "nd.array", "nd.zeros", "nd.random.uniform",
         "nd.NDArray")


def _make(name, **kw):
    """Call the public constructor `name`, which places a model or a
    snapshot on a device, with `kw`."""
    import torch

    import chip_smoke
    from incubator_mxnet_tpu_torch import models, nd
    from incubator_mxnet_tpu_torch.serving import FrozenModel
    if name == "nd.array":
        return nd.array([1.0, 2.0], **kw)
    if name == "nd.NDArray":
        return nd.NDArray([1.0, 2.0], **kw)
    if name == "nd.zeros":
        return nd.zeros((2, 3), **kw)
    if name == "nd.random.uniform":
        return nd.random.uniform(shape=(2,), **kw)
    if name == "get_bert_model":
        return models.get_bert_model("bert_12_768_12", vocab_size=50, **kw)
    if name == "BERTForPretrain":
        return models.BERTForPretrain(models.get_bert_model(
            "bert_12_768_12", vocab_size=50, use_pooler=True, **kw), 50)
    if name == "transformer_lm_small":
        return models.transformer_lm_small(50, **kw)
    if name == "get_resnet":
        return models.get_resnet(1, 18, classes=10, **kw)
    if name == "resnet50_v1_bnrelu":
        return chip_smoke.resnet50_v1_bnrelu(
            classes=10, layers=(1, 1, 1, 1), channels=(8, 16, 32, 64, 128),
            **kw)
    if name == "FrozenModel":
        return FrozenModel(torch.nn.Linear(3, 2), input_shape=(3,),
                           batch_buckets=(1,), **kw)
    return getattr(models, name)(classes=10, **kw)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_need_a_card_unless_given_cpu(name):
    import torch

    from incubator_mxnet_tpu_torch import cpu
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context resolves")
    with pytest.raises(RuntimeError, match="ctx=cpu"):
        _make(name)
    if name in SMALL:
        built = _make(name, ctx=cpu())
        if name.startswith("nd."):
            assert built.context == cpu()
            return
        module = built if isinstance(built, torch.nn.Module) else \
            built._module
        assert all(p.device.type == "cpu" for p in module.parameters())


# torch functions that draw from torch's global RNG unless given a
# generator=, tensor methods that do the same, and the calls that seed or
# draw from it with no generator to give
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
               "randn_like", "randint_like", "normal", "bernoulli",
               "multinomial", "poisson"}
METHOD_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                "exponential_", "geometric_", "cauchy_", "log_normal_",
                "bernoulli"}
GLOBAL_RNG = {"torch.manual_seed", "torch.seed", "torch.initial_seed",
              "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
              "torch.cuda.seed", "torch.cuda.seed_all",
              "torch.random.manual_seed", "torch.random.seed",
              "torch.set_rng_state", "torch.cuda.set_rng_state",
              "torch.dropout", "torch.nn.functional.dropout", "F.dropout",
              "torch.nn.functional.dropout1d",
              "torch.nn.functional.dropout2d",
              "torch.nn.functional.dropout3d", "F.dropout1d", "F.dropout2d",
              "F.dropout3d", "F.alpha_dropout", "torch.nn.Dropout",
              "nn.Dropout"}


def _dotted(node):
    """``a.b.c`` of a Name/Attribute chain, or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id] + parts[::-1])


def _global_draws(path: Path):
    """Each call in `path` that seeds or draws from torch's global RNG:
    (line, what)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        given = any(k.arg == "generator" for k in node.keywords)
        if name in GLOBAL_RNG:
            bad.append((node.lineno, name))
        elif (name and name.startswith("torch.")
              and name.rsplit(".", 1)[1] in TORCH_DRAWS and not given):
            bad.append((node.lineno, name))
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in METHOD_DRAWS and not given
              and not (name or "").startswith("torch.")):
            bad.append((node.lineno, f".{node.func.attr}()"))
    return bad


def test_the_scan_finds_global_draws(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import torch\nfrom torch.nn import functional as F\n"
                   "torch.manual_seed(0)\nx = torch.rand(3)\n"
                   "y = torch.randn(3, generator=g)\nx.normal_(0, 1)\n"
                   "x.uniform_(generator=g)\nF.dropout(x, 0.1)\n"
                   "g.manual_seed(1)\n")
    assert [what for _, what in _global_draws(src)] == [
        "torch.manual_seed", "torch.rand", ".normal_()", "F.dropout"]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_draw_from_the_global_rng(path):
    bad = _global_draws(path)
    assert not bad, f"{path.relative_to(ROOT)} draws from torch's global " \
                    f"RNG at {bad}"
