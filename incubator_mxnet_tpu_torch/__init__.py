"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of incubator_mxnet_tpu.

A second package beside the JAX one, with the same names where they help a
reader find the counterpart. It imports torch, numpy and the standard
library only. Its first slice serves BERT: ``models.get_bert_model`` →
``serving.FrozenModel`` → ``serving.DynamicBatcher`` →
``serving.ModelServer``, with hand-written CUDA kernels for flash attention
and layer norm (``ops.cuda``). Entry points default to ``gpu(0)`` and raise
without a card unless given ``ctx=cpu()``.
"""
from . import context, convert, gluon, models, ops, profiler, serving
from .context import Context, cpu, gpu, tpu

__all__ = ["context", "convert", "gluon", "models", "ops", "profiler",
           "serving", "Context", "cpu", "gpu", "tpu"]
