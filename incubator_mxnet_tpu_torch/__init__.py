"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of incubator_mxnet_tpu.

A second package beside the JAX one, with the same names where they help a
reader find the counterpart. It imports torch, numpy and the standard
library only. Ported:

- serving BERT and ResNet: ``models.get_bert_model`` (or a ResNet) →
  ``serving.FrozenModel`` (one CUDA graph a bucket) →
  ``serving.DynamicBatcher`` → ``serving.ModelServer``;
- training, eagerly: ``models.transformer_lm_base`` → ``autograd.record()``
  → ``models.lm_loss`` → ``autograd.backward`` →
  ``gluon.Trainer(net, "adam").step(batch_size)`` → ``generate``, with
  ``Trainer.save_states``/``load_states``;
- training as one program a step: ``parallel.FusedTrainStep(net, loss_fn,
  optimizer)`` (forward, backward and update as one CUDA graph) and
  ``TrainLoop(...).fit(data, steps=)`` (chunks of k steps, the lr of each
  computed on the device from ``lr_scheduler``'s closed forms);
- BERT pretraining: ``models.BERTForPretrain(models.bert_12_768_12(
  use_pooler=True, dropout=0.1), 30522)`` → ``autograd.record()`` →
  ``models.BERTPretrainLoss`` (MLM + NSP) → ``autograd.backward`` →
  ``gluon.Trainer(net, "adamw").step(batch_size)``;
- ``optimizer``: all sixteen rules of the JAX package and the schedulers
  of ``lr_scheduler``;
- ``random``: ``random.seed(n)`` seeds one ``torch.Generator`` per
  device (and Python's and numpy's generators); every draw of the port
  (dropout's masks, SGLD's noise) comes from ``random.generator(device)``,
  never from torch's global RNG, and a captured training step draws
  fresh masks on every replay.

- ``nd`` (``ndarray``): MXNet's array, ``NDArray``, one
  ``torch.Tensor`` inside, with the JAX package's functions,
  ``nd.random`` and ``nd.linalg``. Gluon blocks, ``autograd``, the
  metrics and the fused step take NDArrays and answer in kind
  (``Parameter.data()`` is one); tensors pass through as tensors.
  ``with cpu():`` (or ``ctx=cpu()``) puts arrays on the CPU.

- Gluon the MXNet way: ``gluon.Parameter``/``ParameterDict``,
  ``gluon.Block``/``HybridBlock`` (``torch.nn.Module`` subclasses with
  MXNet's names, deferred shapes completed by the first call,
  ``collect_params``, ``initialize(init.Xavier(), ctx)``,
  ``hybridize()`` (one CUDA graph per input signature outside
  ``record()``), ``save_parameters``/``load_parameters`` in the JAX
  package's file), ``init`` (``initializer``) and ``metric``.

The paths run hand-written CUDA kernels (``ops.cuda``): the
flash-attention forward and its dQ and dK/dV backward, the layer-norm
forward, the scale/shift/act pass and the fused 1x1-conv GEMM. Entry
points default to ``gpu(0)`` and raise without a card unless given
``ctx=cpu()``. Mixed precision: ``amp`` (loss scaling), the optimizers'
``multi_precision`` masters, ``module.to(torch.bfloat16)`` as the JAX
package's ``cast``, and ``FrozenModel(compute_dtype="bfloat16")``.
"""
from . import (amp, autograd, context, convert, gluon, initializer, metric,
               models, ndarray, ops, optimizer, parallel, profiler, random,
               serving, trainloop)
from .context import (Context, cpu, current_context, gpu, num_gpus,
                      num_tpus, tpu)
from .ndarray import NDArray
from .optimizer import lr_scheduler
from .trainloop import TrainLoop

init = initializer
nd = ndarray

__all__ = ["amp", "autograd", "context", "convert", "gluon", "init",
           "initializer", "metric", "models", "ops",
           "optimizer", "parallel", "profiler", "random", "serving",
           "trainloop",
           "lr_scheduler", "TrainLoop", "Context", "cpu", "gpu", "tpu",
           "nd", "ndarray", "NDArray", "current_context", "num_gpus",
           "num_tpus"]
