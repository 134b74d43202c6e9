"""Head dims 129-256 (ROADMAP C5): the port's attention against the JAX
package's at D = 192 and 256.

On the card the flash kernels take D = 64, 128 and 256, and above 256 any
multiple of 64 (the wide kernels, C5b; tests/test_torch_flash_wide.py);
the differentiable entry point pads 129-255 with zeros up to 256 (keeping
the true head dim's scale) and slices the output and the gradients back,
as it pads smaller head dims. On the CPU the wrappers run their plain versions on the same
padded tensors; the Pallas kernels run in interpret mode, forward and
``jax.vjp``, on the same numpy inputs. The CUDA instances themselves are
held against the plain versions on the card by ``chip_smoke.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops.pallas import flash_attention as jax_flash
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
# f32: sums in other orders; bf16: the bound of the kernels' CPU tests;
# f16: test_torch_float16's (one f16 unit and a little)
_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=3e-2, atol=3e-2),
        "float16": dict(rtol=2 ** -10, atol=2e-3)}


def _both(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(_TORCH[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("d,dp", [(129, 256), (160, 256), (192, 256),
                                  (255, 256), (256, 256), (257, 320),
                                  (512, 512)])
def test_kernel_head_dim_pads_129_to_256_and_above_to_multiples_of_64(d, dp):
    assert fa.kernel_head_dim(d) == dp
    assert 256 in fa.HEAD_DIMS and max(fa.HEAD_DIMS) == 256


@pytest.mark.parametrize("d,ok", [(320, True), (512, True), (300, False)])
def test_kernel_args_take_a_padded_head_dim_above_256(d, ok):
    """Above 256 the wide kernels take a multiple of 64 (C5b, closed): the
    check the wrappers make before a launch passes D = 320 and 512 on
    tensors that claim a CUDA device, and still refuses an unpadded 300."""
    def fake(length):
        return types.SimpleNamespace(
            device=torch.device("cuda", 0), dtype=torch.float32,
            shape=(1, 2, length, d), stride=lambda i: 1)
    if ok:
        assert fa._kernel_args(fake(32), fake(40), fake(40)) == (
            1, 2, 32, 40, d)
    else:
        with pytest.raises(ValueError, match="takes head dims"):
            fa._kernel_args(fake(32), fake(32), fake(32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [192, 256])
def test_attention_at_head_dims_192_and_256_matches_pallas(d, causal, dtype):
    """Forward and dQ, dK, dV through the Function against the Pallas
    forward and ``jax.vjp`` in interpret mode; the plain versions are
    handed D = 256 (192 padded), each once."""
    rng = np.random.RandomState(d + causal)
    lq, lk = (24, 40) if causal else (32, 32)
    q, k, v, do = (rng.randn(1, 2, n, d).astype(np.float32)
                   for n in (lq, lk, lk, lq))
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _both(a, dtype) for a in (q, k, v, do))
    out_j, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=8, block_k=8, interpret=True),
        qj, kj, vj)
    grads_j = vjp(doj)

    seen = []
    real = fa.flash_attention_fwd

    def spy(q, *a, **kw):
        seen.append(q.shape[-1])
        return real(q, *a, **kw)
    fa.reset_counts()
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    try:
        fa.flash_attention_fwd = spy
        out = fa.flash_attention(*leaves, causal=causal)
    finally:
        fa.flash_attention_fwd = real
    out.backward(dot)
    assert seen == [256]
    assert (fa.plain_calls, fa.dq_plain_calls, fa.dkv_plain_calls) == (
        1, 1, 1)
    assert out.shape == qt.shape and out.dtype == _TORCH[dtype]
    np.testing.assert_allclose(_f32(out), _f32(out_j), **_TOL[dtype])
    for name, leaf, g in zip("qkv", leaves, grads_j):
        assert leaf.grad.shape == leaf.shape
        np.testing.assert_allclose(_f32(leaf.grad), _f32(g),
                                   err_msg=f"d{name}", **_TOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_dq_at_head_dim_256_matches_pallas_dq_kernel_on_ragged_tiles(dtype):
    """The plain dQ that the card holds ``flash_bwd_dq_wgmma_kernel<T, 256>``
    to, against ``_dq_kernel`` through ``jax.vjp`` in interpret mode, causal
    at lq = lk = 130: two 64-row tiles and two ragged rows, which the
    kernel's last query tile and last key tile mask. dS is rounded to the
    input dtype before dS K on both sides."""
    rng = np.random.RandomState(130)
    b, h, n, d = 1, 2, 130, 256
    q, k, v, do = (rng.randn(b, h, n, d).astype(np.float32)
                   for _ in range(4))
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _both(a, dtype) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=True, block_q=64, block_k=64, interpret=True),
        qj, kj, vj)
    dq_j = vjp(doj)[0]
    out, lse = fa.flash_attention_ref(qt, kt, vt, causal=True)
    delta = fa._delta(dot, out)
    fa.reset_counts()
    dq = fa.flash_attention_bwd_dq(qt, kt, vt, dot, lse, delta, causal=True)
    assert (fa.dq_plain_calls, fa.dq_launches) == (1, 0)
    assert dq.shape == qt.shape and dq.dtype == _TORCH[dtype]
    ref = fa.flash_attention_bwd_dq_ref(qt, kt, vt, dot, lse, delta,
                                        causal=True)
    assert torch.equal(dq, ref)
    # the two ragged rows see every key up to theirs: their dQ is not zero
    assert bool((dq[:, :, 128:].float().abs().sum(-1) > 0).all())
    np.testing.assert_allclose(_f32(dq), _f32(dq_j), **_TOL[dtype])
