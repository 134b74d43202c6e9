"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of incubator_mxnet_tpu.

A second package beside the JAX one, with the same names where they help a
reader find the counterpart. It imports torch, numpy and the standard
library only. Two slices are ported:

- serving BERT: ``models.get_bert_model`` → ``serving.FrozenModel`` →
  ``serving.DynamicBatcher`` → ``serving.ModelServer``;
- training the causal LM: ``models.transformer_lm_base`` →
  ``autograd.record()`` → ``models.lm_loss`` → ``autograd.backward`` →
  ``gluon.Trainer(net, "adam").step(batch_size)`` → ``generate``.

Both run hand-written CUDA kernels (``ops.cuda``): the flash-attention
forward and its dQ and dK/dV backward, and the layer-norm forward. Entry
points default to ``gpu(0)`` and raise without a card unless given
``ctx=cpu()``. Mixed precision: ``amp`` (loss scaling), the optimizers'
``multi_precision`` masters, ``module.to(torch.bfloat16)`` as the JAX
package's ``cast``, and ``FrozenModel(compute_dtype="bfloat16")``.
"""
from . import (amp, autograd, context, convert, gluon, models, ops,
               optimizer, profiler, serving)
from .context import Context, cpu, gpu, tpu

__all__ = ["amp", "autograd", "context", "convert", "gluon", "models", "ops",
           "optimizer", "profiler", "serving", "Context", "cpu", "gpu", "tpu"]
