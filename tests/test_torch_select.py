"""The port's attention at any head dim, against the JAX package's.

The flash-attention kernels take head dims 64 and 128 (``HEAD_DIMS``); the
JAX package pads any head dim to 128 lanes and runs its Pallas kernel. So the
port's differentiable entry point pads q, k and v with zeros on D up to a
head dim the kernels take, keeps the scale of the true head dim, and slices
the output back, and the selection rule does not look at the head dim. The
padding does not depend on the device: on the CPU the kernels' plain versions
see the same padded tensors as the kernels would on the card.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import profiler
from incubator_mxnet_tpu_torch.ops import _raw, select
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

_SELECTED = "ops/kernel.selected.flash_attention"
_REJECTED = "ops/kernel.rejected.flash_attention"


@pytest.mark.parametrize("masked,dropout,ok", [
    (False, False, True), (True, False, False), (False, True, False),
    (True, True, False)])
def test_flash_rule_rejects_masks_and_dropout_only(masked, dropout, ok):
    profiler.reset_counters()
    mask = torch.ones(1, 1, 4, 4, dtype=torch.bool) if masked else None
    assert select.flash_attention(mask, dropout) is ok
    c = profiler.counters()
    assert (c.get(_SELECTED, 0), c.get(_REJECTED, 0)) == (
        (1, 0) if ok else (0, 1))


@pytest.mark.parametrize("d,dp", [(4, 64), (16, 64), (32, 64), (64, 64),
                                  (96, 128), (128, 128), (160, 160)])
def test_kernel_head_dim_is_the_least_that_holds_d(d, dp):
    assert fa.kernel_head_dim(d) == dp


def _spy(monkeypatch, name, seen):
    """Record the head dim each call of ``fa.<name>`` is handed."""
    real = getattr(fa, name)

    def spy(q, *args, **kw):
        seen.append(q.shape[-1])
        return real(q, *args, **kw)
    monkeypatch.setattr(fa, name, spy)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,head_dim", [(4, 16), (2, 32), (2, 96)])
def test_attention_at_any_head_dim_matches_jax(monkeypatch, heads, head_dim,
                                               causal):
    """Forward and the gradients of q, k and v against jax.vjp of the JAX
    package's multi-head attention with its Pallas kernel selected
    (interpret mode), from the same numpy inputs; the kernels' entry points
    are handed the padded head dim."""
    import jax
    import jax.numpy as jnp
    from incubator_mxnet_tpu.ops import _raw as jraw
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    rng = np.random.RandomState(head_dim + causal)
    units = heads * head_dim
    q, k, v, do = (rng.randn(2, 12, units).astype(np.float32)
                   for _ in range(4))
    ref, vjp = jax.vjp(lambda q, k, v: jraw.multihead_attention(
        q, k, v, heads, causal=causal), *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))

    seen = {name: [] for name in ("flash_attention_fwd",
                                  "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")}
    for name, s in seen.items():
        _spy(monkeypatch, name, s)
    profiler.reset_counters()
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = _raw.multihead_attention(*leaves, heads, causal=causal)
    out.backward(torch.from_numpy(do))
    assert profiler.counters().get(_SELECTED, 0) == 1
    dp = fa.kernel_head_dim(head_dim)
    assert seen == {name: [dp] for name in seen}
    assert out.shape == (2, 12, units)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    for name, leaf, g in zip("qkv", leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4, err_msg=f"d{name}")
