"""The port's TransformerLM at head dim 256 against the JAX package's, and
the flash kernels each dtype and head dim takes on the card.

A small TransformerLM with heads of 256 (2 layers, 512 units, 2 heads,
FFN 512, vocab 97) gets random numpy weights on the JAX side; they are
carried into the port with ``convert.load_jax_params``. The JAX side runs
its Pallas flash kernels in interpret mode (``MXTPU_PALLAS=force``); the
port's CPU tensors take the kernels' plain versions at D = 256, forward and
backward. Logits, loss and every gradient are compared in f32 (the
tolerances of test_torch_transformer_lm.py) and in bf16 (the bounds of
test_torch_bf16.py: each side's bf16 result against the port's f32 one).
On the card the same model shape is chip_smoke's train_lm_d256_bf16
(Gemma-2B's 8 heads of 256 at d_model 2048), where the kernels themselves
run.
"""
import ast
import copy
import inspect

import numpy as np
import pytest
import torch

import chip_smoke
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.transformer_lm import TransformerLM as JaxLM
from incubator_mxnet_tpu.models.transformer_lm import lm_loss as jax_lm_loss
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_loss
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

from test_torch_bf16 import close, f32, jax_random
from test_torch_transformer_lm import TOL

VOCAB = 97
CFG = dict(num_layers=2, units=512, hidden_size=512, num_heads=2,
           max_length=32)


def lm_step(net, x):
    with autograd.record():
        logits = net(x)
        loss = lm_loss(logits, x)
    autograd.backward(loss)
    return logits, loss, {n: p.grad for n, p in net.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_at_head_dim_256_matches_jax(monkeypatch, dtype):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    assert CFG["units"] // CFG["num_heads"] == 256
    assert fa.kernel_head_dim(256) == 256
    jnet = JaxLM(VOCAB, **CFG)
    jnet.initialize(init=mx.init.Normal(0.02))
    arrays = jax_random(jnet, 0, 0.05)
    tnet = load_jax_params(TransformerLM(VOCAB, **CFG), arrays)
    x = np.random.RandomState(1).randint(0, VOCAB, (3, 24)).astype(np.int32)
    xj, xt = nd.array(x, dtype="int32"), torch.from_numpy(x)
    truth = lm_step(copy.deepcopy(tnet), xt) if dtype == "bfloat16" else None
    if dtype == "bfloat16":
        jnet.cast("bfloat16")
        tnet.to(torch.bfloat16)
    with jautograd.record():
        jlogits = jnet(xj)
        jloss = jax_lm_loss(jlogits, xj)
    jloss.backward()
    fa.reset_counts()
    tlogits, tloss, tgrads = lm_step(tnet, xt)
    # one flash forward, dQ and dK/dV a layer, on the plain route
    assert (fa.plain_calls, fa.dq_plain_calls, fa.dkv_plain_calls) == \
        (2, 2, 2)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (0, 0, 0)
    assert tlogits.shape == (3, 24, VOCAB)
    assert tlogits.dtype == getattr(torch, dtype)
    jp = jnet._collect_params_with_prefix()
    assert sorted(tgrads) == sorted(jp)
    if dtype == "float32":
        np.testing.assert_allclose(f32(tlogits), f32(jlogits), **TOL)
        np.testing.assert_allclose(f32(tloss), f32(jloss), **TOL)
        for name, g in tgrads.items():
            want = f32(jp[name].grad())
            np.testing.assert_allclose(
                f32(g), want, rtol=1e-4,
                atol=1e-4 * max(1.0, np.abs(want).max()), err_msg=name)
        return
    t_logits, t_loss, t_grads = truth
    close("logits", f32(tlogits), f32(jlogits), f32(t_logits))
    close("per-token loss", f32(tloss), f32(jloss), f32(t_loss))
    for name, g in tgrads.items():
        assert g.dtype == torch.bfloat16, name
        close(name, f32(g), f32(jp[name].grad()), f32(t_grads[name]))


KINDS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", KINDS)
def test_flash_kernel_name_pins_each_route(kind, dtype, d):
    """The traced name chip_smoke holds a launch to: in f32 the FMA kernel
    at head dims 64 and 128, and at 256 the split-TF32 forward, dQ and
    dK/dV; in bf16 and f16 the wgmma kernel at every head dim, dQ at 256
    included."""
    name = chip_smoke.flash_kernel_name(kind, dtype, d)
    t = {"float32": "float", "bfloat16": "__nv_bfloat16",
         "float16": "__half"}[dtype]
    if dtype != "float32":
        form = "wgmma_"
    elif d == 256:
        form = "tf32x3_"
    else:
        form = ""
    assert name == f"{kind}_{form}kernel<{t}"
    # the kernel-kind lookup credits the launch to its wrapper's count
    kinds = dict(zip(KINDS, ("flash_attention", "flash_bwd_dq",
                             "flash_bwd_dkv")))
    assert chip_smoke._kernel_kind(f"void {name}, {d}>(...)") == kinds[kind]


def test_the_d256_phase_is_gemma_2b_attention_at_four_layers():
    cfg = chip_smoke.LM_D256
    assert cfg == dict(units=2048, num_heads=8, hidden_size=16384,
                       num_layers=4)
    assert fa.kernel_head_dim(cfg["units"] // cfg["num_heads"]) == 256
    assert "lm_d256_b8_l512_causal" in chip_smoke.D256_CASES
    shape = {c[0]: c[1:6] for c in chip_smoke.flash_cases()}
    b, s = chip_smoke.LM["batch"], chip_smoke.LM["seq"]
    assert shape["lm_d256_b8_l512_causal"] == (b, cfg["num_heads"], s, s, 256)
    assert "lm_d256_b8_l512_causal" in {
        c[0] for c in chip_smoke.flash_bwd_cases()}


def _phases():
    """The phases chip_smoke.main drives, in order: (name, function name,
    {keyword: value or name}, names of the ** arguments)."""
    tree = ast.parse(inspect.getsource(chip_smoke.main))
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "phase"):
            kw = {k.arg: (k.value.value if isinstance(k.value, ast.Constant)
                          else ast.unparse(k.value))
                  for k in node.keywords if k.arg}
            star = [ast.unparse(k.value) for k in node.keywords
                    if k.arg is None]
            out.append((node.args[0].value, node.args[1].id, kw, star,
                        node.lineno))
    return sorted(out, key=lambda p: p[4])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_d256_phases_train_gemma_attention_in_each_dtype(dtype):
    """train_lm_d256_bf16 and (after it) train_lm_d256_f32 run
    train_lm_fused at LM_D256 in their dtype: the f32 one puts the f32 flash
    kernels at head dim 256 (the split-TF32 dQ and dK/dV) on a path."""
    label = {"bfloat16": "train_lm_d256_bf16",
             "float32": "train_lm_d256_f32"}[dtype]
    phases = {p[0]: p for p in _phases()}
    name, fn, kw, star, line = phases[label]
    assert fn == "train_lm_fused"
    assert kw == {"dtype": dtype, "label": label}
    assert star == ["LM_D256"]
    assert phases["train_lm_d256_bf16"][4] <= line
