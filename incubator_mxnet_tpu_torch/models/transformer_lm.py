"""Decoder-only transformer language model with KV-cache generation
(counterpart of ``incubator_mxnet_tpu/models/transformer_lm.py``).

Same structure and parameter names as the JAX package, so weights carry
across by name (``convert.load_jax_params``): ``embedding.weight``,
``pos_embedding.weight``, ``layer{i}.attention.qkv.weight``, ...,
``ln_f.gamma``; the tied head (the default) adds no ``head.*`` parameter.

- Training runs one causal pass per layer: the fused (D, 3D) QKV GEMM and
  the causal flash-attention Function, whose forward and backward kernels
  read the heads out of the QKV views through strides.
- Pre-LN blocks and a final LN; 2 * layers + 1 layer norms per forward.
- Generation: a prefill through the causal flash path fills per-layer KV
  caches of a fixed ``max_length``; each decode step masks the cache
  positions past the current one, so it takes the plain masked attention
  path, as in the JAX package.

The sequence-parallel ``ring=`` cores are not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from .. import autograd, ops
from ..context import as_context
from ..gluon import nn as gnn
from ..gluon.block import HybridBlock
from ..gluon.loss import SoftmaxCrossEntropyLoss
from .bert import MultiHeadAttentionCell, PositionwiseFFN

__all__ = ["TransformerLM", "TransformerLMCell", "CausalSelfAttention",
           "transformer_lm_small", "transformer_lm_base", "lm_loss"]


class CausalSelfAttention(MultiHeadAttentionCell):
    """The fused-QKV attention cell with causal masking and a KV-cache
    decode path."""

    def forward(self, x, mask=None):
        if mask is not None:
            raise ValueError("causal attention builds its own mask")
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = ops.multihead_attention(q, k, v, self._num_heads,
                                      dropout_rate=self._dropout,
                                      training=autograd.is_training(),
                                      causal=True)
        return self.proj(out)

    def forward_step(self, x_t, k_cache, v_cache, pos, pos_mask):
        """One decode step: x_t (B, 1, D) already layer-normed; caches
        (B, max_length, D), written in place at `pos`; pos_mask
        (1, 1, 1, max_length) marks the positions <= pos. Returns
        ``(out (B, 1, D), k_cache, v_cache)``."""
        q, k_t, v_t = self.qkv(x_t).chunk(3, dim=-1)
        k_cache[:, pos:pos + 1] = k_t
        v_cache[:, pos:pos + 1] = v_t
        out = ops.multihead_attention(q, k_cache, v_cache, self._num_heads,
                                      mask=pos_mask)
        return self.proj(out), k_cache, v_cache

    def project_kv(self, x_t):
        """K and V of prefill tokens (B, L, D): two (B, L, D)."""
        _, k, v = self.qkv(x_t).chunk(3, dim=-1)
        return k, v


class TransformerLMCell(HybridBlock):
    """Pre-LN decoder block: LN -> causal MHA -> residual, LN -> FFN ->
    residual."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0):
        super().__init__()
        self.attention = CausalSelfAttention(units, num_heads, dropout)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout)
        self.dropout = gnn.Dropout(dropout)
        self.ln1 = gnn.LayerNorm(in_channels=units)
        self.ln2 = gnn.LayerNorm(in_channels=units)

    def forward(self, x):
        x = x + self.dropout(self.attention(self.ln1(x)))
        return x + self.ffn(self.ln2(x))

    def forward_step(self, x_t, k_cache, v_cache, pos, pos_mask):
        a, k_cache, v_cache = self.attention.forward_step(
            self.ln1(x_t), k_cache, v_cache, pos, pos_mask)
        x_t = x_t + a
        return x_t + self.ffn(self.ln2(x_t)), k_cache, v_cache


class TransformerLM(HybridBlock):
    """Token and learned position embeddings, N pre-LN causal blocks, a
    final LN and a vocabulary head (tied to the embedding by default).

    ``forward(inputs)``: (B, L) token ids -> (B, L, vocab) logits.
    ``generate(...)``: greedy or temperature sampling with KV caches."""

    def __init__(self, vocab_size, num_layers=2, units=128, hidden_size=512,
                 num_heads=4, max_length=512, dropout=0.0, tie_weights=True):
        super().__init__()
        self._units = units
        self._max_length = max_length
        self._vocab_size = vocab_size
        self._tie = tie_weights
        self.embedding = gnn.Embedding(vocab_size, units)
        self.pos_embedding = gnn.Embedding(max_length, units)
        # registered as layer0, layer1, ... (the JAX package's names); the
        # list is a plain attribute, so it adds no "layers.*" names
        self.layers = []
        for i in range(num_layers):
            cell = TransformerLMCell(units, hidden_size, num_heads, dropout)
            self.add_module(f"layer{i}", cell)
            self.layers.append(cell)
        self.ln_f = gnn.LayerNorm(in_channels=units)
        if not tie_weights:
            self.head = gnn.Dense(vocab_size, flatten=False, in_units=units)
        self.dropout = gnn.Dropout(dropout)

    def _logits(self, h):
        if self._tie:
            return F.linear(h, self.embedding.weight)
        return self.head(h)

    def _embed(self, inputs, position_offset=0):
        length = inputs.shape[1]
        if position_offset + length > self._max_length:
            raise ValueError(f"sequence length {position_offset + length} "
                             f"exceeds max_length {self._max_length}")
        pos = torch.arange(position_offset, position_offset + length,
                           device=inputs.device)
        h = (self.embedding(inputs) * float(math.sqrt(self._units))
             + self.pos_embedding(pos))
        return self.dropout(h)

    def forward(self, inputs):
        h = self._embed(inputs)
        for layer in self.layers:
            h = layer(h)
        return self._logits(self.ln_f(h))

    # -- KV-cache generation ---------------------------------------------
    def init_cache(self, batch_size):
        """Per-layer (k, v) caches, (B, max_length, D) zeros."""
        w = self.embedding.weight
        return [tuple(torch.zeros((batch_size, self._max_length,
                                   self._units), dtype=w.dtype,
                                  device=w.device) for _ in range(2))
                for _ in self.layers]

    def _write_cache(self, caches, h_stack, start):
        """Project K and V for positions [start, start + L) of each layer's
        input activations h_stack[i] and write them into the caches."""
        new = []
        for (k_c, v_c), layer, h in zip(caches, self.layers, h_stack):
            k_t, v_t = layer.attention.project_kv(layer.ln1(h))
            k_c[:, start:start + h.shape[1]] = k_t
            v_c[:, start:start + h.shape[1]] = v_t
            new.append((k_c, v_c))
        return new

    def _step_with_cache(self, token, pos, caches):
        """Decode one token at `pos` given caches filled for [0, pos).
        Returns ``(logits (B, vocab), caches)``."""
        h = self._embed(token, position_offset=pos)
        mask = (torch.arange(self._max_length, device=token.device)
                <= pos).reshape(1, 1, 1, self._max_length)
        for i, layer in enumerate(self.layers):
            k_c, v_c = caches[i]
            h, k_c, v_c = layer.forward_step(h, k_c, v_c, pos, mask)
            caches[i] = (k_c, v_c)
        return self._logits(self.ln_f(h))[:, 0], caches

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens, temperature=0.0, seed=None):
        """Continue `prompt` (B, Lp) by `max_new_tokens` tokens: greedy
        argmax at temperature 0, else samples of softmax(logits / T) drawn
        with ``numpy.random.RandomState(seed)``. The prefill is one causal
        pass that fills the caches; each further token is one decode step.
        Returns (B, Lp + max_new_tokens) ids on the model's device, in the
        prompt's dtype."""
        device = self.embedding.weight.device
        prompt = torch.as_tensor(prompt, device=device)
        b, lp = prompt.shape
        if lp + max_new_tokens > self._max_length:
            raise ValueError("prompt + max_new_tokens exceeds max_length")
        rng = np.random.RandomState(seed)

        # prefill: one causal pass, keeping each layer's input activations
        # so that the caches hold exactly what forward_step's attention sees
        h = self._embed(prompt)
        h_stack = []
        for layer in self.layers:
            h_stack.append(h)
            h = layer(h)
        logits_last = self._logits(self.ln_f(h))[:, -1]
        caches = self._write_cache(self.init_cache(b), h_stack, 0)

        out = [prompt]
        for i in range(max_new_tokens):
            if temperature > 0.0:
                p = torch.softmax(logits_last.float() / temperature,
                                  dim=-1).cpu().numpy()
                p = p / p.sum(-1, keepdims=True)  # an exact simplex
                nxt = np.array([rng.choice(self._vocab_size, p=p[j])
                                for j in range(b)], np.int64)
            else:
                nxt = logits_last.float().cpu().numpy().argmax(-1)
            tok = torch.as_tensor(nxt[:, None], device=device)
            out.append(tok.to(prompt.dtype))
            if i == max_new_tokens - 1:
                break
            logits_last, caches = self._step_with_cache(tok, lp + i, caches)
        return torch.cat(out, dim=1)


def _build(vocab_size, ctx, seed, sigma, defaults, kwargs):
    device = as_context(ctx).device        # raises without a card
    for k, v in defaults.items():
        kwargs.setdefault(k, v)
    net = TransformerLM(vocab_size, **kwargs)
    gnn.init_params(net, sigma=sigma, seed=seed)
    return net.to(device)


def transformer_lm_small(vocab_size=10000, ctx=None, seed=0, sigma=0.02,
                         **kwargs):
    """4-layer, 256-unit causal LM on `ctx` (default ``gpu(0)``; raises
    without a card unless ``ctx=cpu()``), weights drawn by
    :func:`gluon.nn.init_params` from `seed`."""
    return _build(vocab_size, ctx, seed, sigma,
                  dict(num_layers=4, units=256, hidden_size=1024,
                       num_heads=4), kwargs)


def transformer_lm_base(vocab_size=50257, ctx=None, seed=0, sigma=0.02,
                        **kwargs):
    """12-layer, 768-unit causal LM (GPT-2-base widths), as
    :func:`transformer_lm_small`."""
    return _build(vocab_size, ctx, seed, sigma,
                  dict(num_layers=12, units=768, hidden_size=3072,
                       num_heads=12, max_length=1024), kwargs)


def lm_loss(logits, targets):
    """Shifted causal-LM loss: per-position cross entropy of logits[:, :-1]
    against targets[:, 1:], shape (B * (L - 1),), the gluon loss convention
    (``autograd.backward`` of it backpropagates the sum)."""
    v = logits.shape[-1]
    return SoftmaxCrossEntropyLoss()(logits[:, :-1].reshape(-1, v),
                                     targets[:, 1:].reshape(-1))
