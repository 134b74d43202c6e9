"""Plain functions on tensors: the subset of ``incubator_mxnet_tpu/ops/
_raw.py`` that serving BERT, training the causal LM and training and serving
ResNet need.

Matrix products and convolutions stay ``torch`` calls (cuBLAS and cuDNN on
the card), as the JAX package leaves them to XLA. Attention, layer norm,
the BatchNorm+act tail and the fused conv+BN+act go through the selection
rules of ``select`` to the ``torch.autograd.Function``s of ``cuda``, whose
forward runs the hand-written kernels on the card. Everything here is
differentiable by autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from . import select as _sel
from .cuda import conv_bn_relu as _cbr
from .cuda import flash_attention as _fa
from .cuda import layer_norm as _ln

__all__ = ["OOR_POLICIES", "fully_connected", "normalize_ids", "embedding",
           "gelu", "tanh", "relu", "activation", "dropout", "conv", "pooling",
           "batch_norm", "conv_bn_relu", "layer_norm", "softmax_cross_entropy",
           "multihead_attention"]


def fully_connected(x, weight, bias=None, flatten=True):
    """FullyConnected: weight layout (units, in_units); ``flatten`` collapses
    the trailing dims of x first."""
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


OOR_POLICIES = ("clip", "error")


def normalize_ids(ids, input_dim: int, policy: str = "clip"):
    """The embedding id policy: float carriers are rounded half to even
    (``rint``, not truncated), integer carriers cast to int32, and every id
    clamped into ``[0, input_dim)``. Under ``policy="error"`` an id outside
    that range raises ``ValueError`` instead, where the ids can be read
    (not inside a CUDA graph capture, where they are clamped), as the JAX
    package raises on concrete arrays and clamps inside a trace."""
    if policy not in OOR_POLICIES:
        raise ValueError(f"oor_policy must be one of {OOR_POLICIES}, got "
                         f"{policy!r}")
    if ids.is_floating_point():
        ids = torch.round(ids)
    ids = ids.to(torch.int32)
    if policy == "error" and not (ids.is_cuda and
                                  torch.cuda.is_current_stream_capturing()):
        n_oor = int(((ids < 0) | (ids >= input_dim)).sum())
        if n_oor:
            raise ValueError(f"embedding lookup: {n_oor} id(s) outside "
                             f"[0, {input_dim}) under oor_policy='error'")
    return ids.clamp(0, input_dim - 1)


class _Embedding(torch.autograd.Function):
    """``F.embedding`` with a backward that sums each row's gradients in
    one fixed order, as the JAX package's scatter-add does, into an f32
    (f64 for f64) table cast once to the weight's dtype: on a card
    ``index_put_(..., accumulate=True)``, which sorts the ids first; on
    the CPU ``index_add_``, which walks them in order (the CPU's
    ``index_put_`` accumulates in parallel). ``F.embedding``'s own CUDA
    backward adds a much-repeated row's gradients in an order that
    changes from call to call (BERT's two-row token-type table, GPT-2's
    periodic ids), so two runs from one seed could part in their last
    bits."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.table = (weight.shape, weight.dtype)
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        shape, dtype = ctx.table
        acc = torch.promote_types(dtype, torch.float32)
        table = torch.zeros(shape, dtype=acc, device=grad.device)
        ids = ids.reshape(-1).long()
        grad = grad.reshape(-1, shape[1]).to(acc)
        if grad.device.type == "cuda":
            table.index_put_((ids,), grad, accumulate=True)
        else:
            table.index_add_(0, ids, grad)
        return None, table.to(dtype)


def embedding(ids, weight, oor_policy="clip"):
    """Rows of `weight` (vocab, units) looked up by `ids` under
    :func:`normalize_ids` with `oor_policy`; the weight's gradient sums in
    a fixed order (:class:`_Embedding`)."""
    return _Embedding.apply(normalize_ids(ids, weight.shape[0], oor_policy),
                            weight)


def gelu(x, approximate=False):
    """GELU; the erf form unless `approximate` (then the tanh form)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


def relu(x):
    return torch.relu(x)


_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": lambda a: torch.clamp(a, 0.0, 6.0),
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


def dropout(x, rate, training, generator=None, axes=()):
    """Inverted dropout; the identity outside training or at rate 0. `axes`
    are broadcast axes: one mask is shared along them. The uniforms come
    from `generator`, by default :func:`random.generator` of x's device."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    for a in axes:
        shape[a] = 1
    if generator is None:
        generator = _random.generator(x.device)
    u = torch.rand(shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def _channels_last(layout, ndim):
    return (len(layout) == ndim and layout[0] == "N"
            and layout.endswith("C"))


def conv(x, weight, bias=None, stride=None, pad=None, dilate=None,
         num_group=1, layout="NCHW"):
    """2-D convolution: `weight` is OIHW for NCHW, HWIO for NHWC (the JAX
    package's conventions). NHWC runs ``F.conv2d`` on channels-last views
    and returns NHWC (``cuda.conv_bn_relu.conv_nhwc``)."""
    if x.ndim != 4:
        raise ValueError(f"conv takes 4-D input (2-D convolution), got "
                         f"{x.ndim}-D")
    stride = tuple(stride or (1, 1))
    pad = tuple(pad or (0, 0))
    dilate = tuple(dilate or (1, 1))
    if layout == "NHWC":
        y = _cbr.conv_nhwc(x, weight, stride, pad, dilate, num_group)
        return y if bias is None else y + bias
    if layout != "NCHW":
        raise ValueError(f"unsupported conv layout {layout!r}")
    return F.conv2d(x, weight, bias, stride, pad, dilate, num_group)


def pooling(x, pool_type="max", kernel=(2, 2), stride=None, pad=None,
            global_pool=False, layout="NCHW", ceil_mode=False):
    """2-D max pooling with MXNet's padding (padded cells never win; with
    ``ceil_mode`` the last partial window is kept), and global max or
    average pooling. NCHW or NHWC; the result keeps the layout."""
    if x.ndim != 4:
        raise ValueError(f"pooling takes 4-D input, got {x.ndim}-D")
    cl = _channels_last(layout, x.ndim)
    sp = (1, 2) if cl else (2, 3)
    if global_pool:
        if pool_type == "max":
            return x.amax(dim=sp, keepdim=True)
        if pool_type == "avg":
            return x.mean(dim=sp, keepdim=True)
        raise ValueError(f"unsupported global pool_type {pool_type!r}")
    if pool_type != "max":
        raise ValueError(f"unsupported pool_type {pool_type!r} (max, or "
                         f"global max/avg)")
    kernel = tuple(kernel)
    stride = tuple(stride or kernel)
    pad = tuple(pad or (0, 0))
    xc = x.permute(0, 3, 1, 2) if cl else x
    hi = [0, 0]
    if ceil_mode:
        for i in range(2):
            rem = (xc.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            hi[i] = stride[i] - rem if rem else 0
    if any(hi) or any(2 * p > k for p, k in zip(pad, kernel)):
        low = (torch.finfo(x.dtype).min if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        xc = F.pad(xc, (pad[1], pad[1] + hi[1], pad[0], pad[0] + hi[0]),
                   value=low)
        pad = (0, 0)
    y = F.max_pool2d(xc, kernel, stride, pad)
    return y.permute(0, 2, 3, 1).contiguous() if cl else y


def batch_norm(x, gamma, beta, moving_mean, moving_var, axis=1, eps=1e-5,
               momentum=0.9, training=True, use_global_stats=False,
               fix_gamma=False, act=None):
    """BatchNorm; returns ``(y, new_moving_mean, new_moving_var)``, the
    caller keeps the state. In training mode the batch mean and biased
    variance normalize, and the moving statistics become ``momentum * old
    + (1 - momentum) * batch``; otherwise the moving statistics normalize.

    ``act`` fuses a trailing activation (BatchNormReLU): on a channels-last
    call the statistics fold into a per-channel scale and shift (autograd
    follows them back into x) and the normalize+affine+act tail runs in one
    pass through :func:`cuda.conv_bn_relu.scale_shift_act`; otherwise the
    activation follows the plain chain."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    ax = axis % x.ndim
    red = tuple(i for i in range(x.ndim) if i != ax)
    bshape = [1] * x.ndim
    bshape[ax] = x.shape[ax]
    if training and not use_global_stats:
        mean = x.mean(dim=red)
        var = x.var(dim=red, correction=0)
        new_mm = momentum * moving_mean + (1 - momentum) * mean.detach()
        new_mv = momentum * moving_var + (1 - momentum) * var.detach()
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    if act is not None and _sel.scale_shift_act(x, axis, act=act):
        scale, shift = _cbr.fold_bn(gamma, beta, mean, var, eps)
        return _cbr.scale_shift_act(x, scale, shift, act), new_mm, new_mv
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    y = (x - mean.reshape(bshape).to(x.dtype)) * inv.reshape(bshape)
    y = (y * gamma.reshape(bshape).to(x.dtype)
         + beta.reshape(bshape).to(x.dtype))
    if act is not None:
        y = activation(y, act)
    return y, new_mm, new_mv


def conv_bn_relu(x, weight, gamma, beta, moving_mean, moving_var, eps=1e-5,
                 stride=None, pad=None, dilate=None, num_group=1,
                 layout="NHWC", act="relu", training=False):
    """Fused conv + BatchNorm + activation. A qualifying call (predict mode,
    NHWC, ungrouped, undilated: ``select.conv_bn_relu``) runs
    :func:`cuda.conv_bn_relu.conv_bn_relu`: a 1x1/stride-1/unpadded conv as
    one GEMM with the epilogue fused, any other geometry as conv + the
    scale/shift/act kernel. Anything else is the unfused conv ->
    :func:`batch_norm` chain with the same semantics. Returns y only: the
    moving statistics are read, never written."""
    stride = tuple(stride or (1, 1))
    pad = tuple(pad or (0, 0))
    if (not training and x.ndim == 4
            and _sel.conv_bn_relu(x, weight, stride, pad, dilate, num_group,
                                  layout, training, act=act)):
        return _cbr.conv_bn_relu(x, weight, gamma, beta, moving_mean,
                                 moving_var, eps=eps, stride=stride, pad=pad,
                                 act=act)
    y = conv(x, weight, None, stride=stride, pad=pad, dilate=dilate,
             num_group=num_group, layout=layout)
    caxis = -1 if _channels_last(layout, x.ndim) else 1
    y, _, _ = batch_norm(y, gamma, beta, moving_mean, moving_var, axis=caxis,
                         eps=eps, training=training, act=act)
    return y


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
    """Cross entropy of softmax(`logits`) over `axis`, the log-softmax in
    f32 inside: against int class ids (``sparse_label``; float ids are
    truncated, as ``astype(int32)`` does) or against a distribution of the
    logits' shape. Returns the logits' dtype with `axis` removed, as the
    JAX package does (bf16 logits give a bf16 loss)."""
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype,
                                                       torch.float32)),
                         dim=axis)
    if sparse_label:
        lab = labels.to(torch.int64).unsqueeze(axis)
        loss = -torch.gather(logp, axis, lab).squeeze(axis)
    else:
        loss = -(labels * logp).sum(axis)
    return loss.to(logits.dtype)


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
    keeps a score), whose weight dropout draws from `generator` (by default
    :func:`random.generator` of the inputs' device)."""
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
