"""Plain functions on tensors: the subset of ``incubator_mxnet_tpu/ops/
_raw.py`` that serving BERT and training the causal LM need.

Matrix products stay ``torch`` calls (cuBLAS on the card), as the JAX
package leaves them to XLA. Attention and layer norm go through the
selection rules of ``select`` to the ``torch.autograd.Function``s of
``cuda``, whose forward and backward run the hand-written kernels on the
card. Everything here is differentiable by autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import select as _sel
from .cuda import flash_attention as _fa
from .cuda import layer_norm as _ln

__all__ = ["fully_connected", "normalize_ids", "embedding", "gelu", "tanh",
           "activation", "dropout", "layer_norm", "softmax_cross_entropy",
           "multihead_attention"]


def fully_connected(x, weight, bias=None, flatten=True):
    """FullyConnected: weight layout (units, in_units); ``flatten`` collapses
    the trailing dims of x first."""
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


def normalize_ids(ids, input_dim: int):
    """The embedding id policy: float carriers are rounded half to even
    (``rint``, not truncated), integer carriers cast to int32, and every id
    clamped into ``[0, input_dim)``."""
    if ids.is_floating_point():
        ids = torch.round(ids)
    return ids.to(torch.int32).clamp(0, input_dim - 1)


def embedding(ids, weight):
    """Rows of `weight` (vocab, units) looked up by `ids` under
    :func:`normalize_ids`."""
    return F.embedding(normalize_ids(ids, weight.shape[0]), weight)


def gelu(x, approximate=False):
    """GELU; the erf form unless `approximate` (then the tanh form)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda a: gelu(a, approximate=True),
    "erf_gelu": gelu,
}


def activation(x, act_type):
    """The named activation (the JAX package's table: ``"gelu"`` is the
    tanh form, ``"erf_gelu"`` the erf form)."""
    try:
        return _ACTIVATIONS[act_type](x)
    except KeyError:
        raise ValueError(f"unknown activation {act_type!r}; "
                         f"known: {sorted(_ACTIVATIONS)}") from None


def dropout(x, rate, training, generator=None):
    """Inverted dropout; the identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm with f32 statistics. A last-axis call with 1-D gamma goes
    to the layer-norm Function (kernel forward on the card, plain version
    on the CPU, closed-form backward on both)."""
    if _sel.layer_norm(x, gamma, axis):
        return _ln.layer_norm(x, gamma, beta, eps)
    xf = x.float()
    mean = xf.mean(axis, keepdim=True)
    var = xf.var(axis, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[axis % x.ndim] = x.shape[axis % x.ndim]
    y = y * gamma.float().reshape(shape) + beta.float().reshape(shape)
    return y.to(x.dtype)


def softmax_cross_entropy(logits, labels, axis=-1, sparse_label=True):
    """Cross entropy of softmax(`logits`) over `axis`, log-softmax in f32:
    against int class ids (``sparse_label``; float ids are truncated, as
    ``astype(int32)`` does) or against a distribution of the logits'
    shape. Returns f32 with `axis` removed."""
    logp = F.log_softmax(logits.float(), dim=axis)
    if sparse_label:
        lab = labels.to(torch.int64).unsqueeze(axis)
        return -torch.gather(logp, axis, lab).squeeze(axis)
    return -(labels * logp).sum(axis)


def multihead_attention(q, k, v, num_heads, mask=None, dropout_rate=0.0,
                        training=False, scale=None, causal=False,
                        generator=None):
    """Multi-head attention on projected (B, L, D) inputs: split heads,
    scaled dot product, merge heads.

    Without a mask, and without attention dropout in training, the call
    goes to the flash-attention Function, whose kernels read the heads
    through strides and write them back as (B, L, H, D): the split and the
    merge are views, not copies, forward and backward. Otherwise the plain
    masked-softmax path runs (`mask` broadcasts against (B, H, Lq, Lk); True
    keeps a score)."""
    b, lq, d = q.shape
    lk = k.shape[1]
    hd = d // num_heads
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)

    def split(x, length):
        return x.reshape(b, length, num_heads, hd).transpose(1, 2)

    if _sel.flash_attention(mask, dropout_rate > 0.0 and training):
        out = _fa.flash_attention(split(q, lq), split(k, lk), split(v, lk),
                                  causal=causal, scale=scale)
        return out.transpose(1, 2).reshape(b, lq, d)

    qh, kh, vh = split(q, lq), split(k, lk), split(v, lk)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        if lq > lk:
            raise ValueError("causal attention with more queries than keys "
                             "is undefined (use an explicit mask)")
        tri = torch.ones((lq, lk), dtype=torch.bool,
                         device=q.device).tril(lk - lq)
        mask = tri if mask is None else mask & tri
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e9)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    w = dropout(w, dropout_rate, training, generator)
    out = torch.einsum("bhqk,bhkd->bhqd", w, vh)
    return out.transpose(1, 2).reshape(b, lq, d)
