"""BERT encoder (counterpart of ``incubator_mxnet_tpu/models/bert.py``).

Same structure, parameter names and block kinds (each a ``HybridBlock``)
as the JAX package, so weights carry across by name
(``convert.load_jax_params``) and ``hybridize()`` serves a forward from
CUDA graphs; the shapes are explicit, as in the JAX package:

- the QKV projection is one (3D, D) Dense, split into three views;
- attention without a mask runs the flash-attention kernel, which reads the
  heads out of the QKV views through strides; with a ``valid_length`` mask
  it takes the plain masked-softmax path;
- post-LN (BERT's default) or pre-LN cells; 25 layer norms for 12 layers;
- ``BERTForPretrain`` puts GluonNLP's MLM and NSP heads on a BERTModel
  (one more layer norm, ``mlm_ln``), and ``BERTPretrainLoss`` is their
  loss. Training-mode dropout draws from the seeded generator of the
  device (``random``).

The sequence-parallel ``ring=`` cores are not ported.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from .. import autograd, ops
from ..context import as_context
from ..gluon import nn as gnn
from ..gluon.block import HybridBlock
from ..gluon.loss import Loss

__all__ = ["BERTModel", "BERTEncoder", "BERTEncoderCell", "PositionwiseFFN",
           "MultiHeadAttentionCell", "BERTForPretrain", "BERTPretrainLoss",
           "get_bert_model", "bert_12_768_12"]


class MultiHeadAttentionCell(HybridBlock):
    """Self-attention with a fused QKV projection."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} must divide by num_heads "
                             f"{num_heads}")
        self._num_heads = num_heads
        self._dropout = dropout
        self.qkv = gnn.Dense(3 * units, flatten=False, in_units=units,
                             use_bias=use_bias)
        self.proj = gnn.Dense(units, flatten=False, in_units=units,
                              use_bias=use_bias)

    def forward(self, x, mask=None):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = ops.multihead_attention(q, k, v, self._num_heads, mask,
                                      self._dropout,
                                      training=autograd.is_training())
        return self.proj(out)


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu"):
        super().__init__()
        self.ffn_1 = gnn.Dense(hidden_size, flatten=False, in_units=units)
        self.activation = (gnn.GELU() if activation == "gelu"
                           else gnn.Activation(activation))
        self.ffn_2 = gnn.Dense(units, flatten=False, in_units=hidden_size)
        self.dropout = gnn.Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.ffn_2(self.activation(self.ffn_1(x))))


class BERTEncoderCell(HybridBlock):
    """MHA + Add&LN, FFN + Add&LN; ``pre_norm=True`` gives the pre-LN
    variant."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=False, layer_norm_eps=1e-12):
        super().__init__()
        self._pre_norm = pre_norm
        self.attention = MultiHeadAttentionCell(units, num_heads, dropout)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout)
        self.dropout = gnn.Dropout(dropout)
        self.ln1 = gnn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ln2 = gnn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)

    def forward(self, x, mask=None):
        if self._pre_norm:
            x = x + self.dropout(self.attention(self.ln1(x), mask))
            return x + self.ffn(self.ln2(x))
        x = self.ln1(x + self.dropout(self.attention(x, mask)))
        return self.ln2(x + self.ffn(x))


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 max_length=512, dropout=0.0, pre_norm=False,
                 layer_norm_eps=1e-12):
        super().__init__()
        self.position_weight = self.params.get(
            "position_weight", shape=(max_length, units), init="normal")
        self.dropout = gnn.Dropout(dropout)
        self.ln = gnn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.cells = gnn.HybridSequential()
        for _ in range(num_layers):
            self.cells.add(BERTEncoderCell(units, hidden_size, num_heads,
                                           dropout, pre_norm, layer_norm_eps))

    def forward(self, x, mask=None):
        x = x + self.position_weight[:x.shape[1]][None, :, :]
        x = self.dropout(self.ln(x))
        for cell in self.cells:
            x = cell(x, mask)
        return x


def _length_mask(valid_length, seq_len):
    """(B,) valid lengths -> (B, 1, 1, L) boolean attention mask."""
    ar = torch.arange(seq_len, device=valid_length.device)
    return (ar[None, :] < valid_length.to(torch.int32)[:, None])[:, None,
                                                                 None, :]


class BERTModel(HybridBlock):
    """Embeddings + encoder + pooler.

    ``forward(inputs, token_types=None, valid_length=None)`` returns
    ``(sequence_output (B, L, D), pooled_output (B, D))``, or the sequence
    output alone without a pooler."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, max_length=512, vocab_size=30522,
                 token_type_vocab_size=2, dropout=0.1, pre_norm=False,
                 use_pooler=True, layer_norm_eps=1e-12):
        super().__init__()
        self.word_embed = gnn.Embedding(vocab_size, units)
        self.token_type_embed = gnn.Embedding(token_type_vocab_size, units)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   max_length, dropout, pre_norm,
                                   layer_norm_eps)
        self.pooler = (gnn.Dense(units, flatten=False, in_units=units,
                                 activation="tanh") if use_pooler else None)

    def forward(self, inputs, token_types=None, valid_length=None):
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        mask = None
        if valid_length is not None:
            mask = _length_mask(valid_length, inputs.shape[1])
        seq = self.encoder(x, mask)
        if self.pooler is None:
            return seq
        return seq, self.pooler(seq[:, 0, :])


class BERTForPretrain(HybridBlock):
    """MLM + NSP heads on a BERTModel (GluonNLP's pretraining script).

    ``forward(inputs, token_types, valid_length, masked_positions)`` returns
    ``(mlm_scores (B, M, V), nsp_scores (B, 2))``: the sequence output at
    the masked positions (float or int, truncated to int) through a Dense,
    the tanh form of GELU and ``mlm_ln``, then the decoder tied to
    ``bert.word_embed.weight`` plus ``mlm_bias``; the NSP classifier reads
    the pooled output. The heads' two weights are drawn normal(0, 0.02)
    from a generator seeded with 0, their biases and ``mlm_bias`` are
    zeros (as :func:`gluon.nn.init_params` makes them), and the heads go
    on `bert`'s device and dtype."""

    def __init__(self, bert: BERTModel, vocab_size):
        super().__init__()
        if bert.pooler is None:
            raise ValueError("BERTForPretrain needs a BERTModel built with "
                             "use_pooler=True (the NSP head reads the pooled "
                             "[CLS] output)")
        self.bert = bert
        w = bert.word_embed.weight
        units = w.shape[1]
        self.mlm_transform = gnn.Dense(units, flatten=False, in_units=units)
        self.mlm_ln = gnn.LayerNorm(epsilon=1e-12, in_channels=units)
        self.mlm_bias = self.params.get("mlm_bias", shape=(vocab_size,),
                                        init="zeros")
        self.nsp_classifier = gnn.Dense(2, in_units=units)
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in (self.mlm_transform.weight, self.nsp_classifier.weight):
                p.normal_(0.0, 0.02, generator=g)
        self.to(device=w.device, dtype=w.dtype)

    def forward(self, inputs, token_types, valid_length, masked_positions):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        pos = masked_positions.to(torch.int64)[:, :, None]
        h = torch.take_along_dim(seq, pos, dim=1)
        h = self.mlm_ln(ops.gelu(self.mlm_transform(h), approximate=True))
        mlm = F.linear(h, self.bert.word_embed.weight, self.mlm_bias)
        return mlm, self.nsp_classifier(pooled)


class BERTPretrainLoss(Loss):
    """The MLM cross entropy over the masked positions, the positions
    labelled -1 ignored and the sum divided by ``max(count, 1)``, plus the
    NSP cross entropy's mean; both log-softmaxes in f32. A 0-d f32
    loss."""

    def forward(self, mlm_scores, nsp_scores, masked_labels, nsp_labels,
                sample_weight=None):
        valid = masked_labels >= 0
        labels = masked_labels.clamp_min(0).to(torch.int64)
        logp = F.log_softmax(mlm_scores.float(), dim=-1)
        nll = -logp.gather(-1, labels[..., None])[..., 0]
        mlm_loss = (torch.where(valid, nll, 0.0).sum()
                    / valid.sum().clamp_min(1))
        nlogp = F.log_softmax(nsp_scores.float(), dim=-1)
        nsp_loss = -nlogp.gather(
            -1, nsp_labels.to(torch.int64)[:, None]).mean()
        return mlm_loss + nsp_loss


_BERT_CONFIGS = {
    # name: (num_layers, units, hidden_size, num_heads)
    "bert_12_768_12": (12, 768, 3072, 12),     # BERT-base
    "bert_24_1024_16": (24, 1024, 4096, 16),   # BERT-large
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   max_length=512, dropout=0.1, pre_norm=False,
                   use_pooler=True, ctx=None, seed=0, sigma=0.02, **kwargs):
    """A named BERT in eval mode on `ctx` (default ``gpu(0)``; raises
    without a card unless ``ctx=cpu()``), its weights drawn by
    :func:`gluon.nn.init_params` from `seed`."""
    device = as_context(ctx).device
    num_layers, units, hidden, heads = _BERT_CONFIGS[model_name]
    net = BERTModel(num_layers, units, hidden, heads, max_length, vocab_size,
                    dropout=dropout, pre_norm=pre_norm, use_pooler=use_pooler,
                    **kwargs)
    gnn.init_params(net, sigma=sigma, seed=seed)
    return net.to(device).eval()


def bert_12_768_12(**kwargs):
    return get_bert_model("bert_12_768_12", **kwargs)
