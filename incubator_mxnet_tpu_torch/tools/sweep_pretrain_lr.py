#!/usr/bin/env python3
"""The loss curve of BERT-base pretraining under a few AdamW recipes, on
one card.

    python3 incubator_mxnet_tpu_torch/tools/sweep_pretrain_lr.py

The batch and model of ``chip_smoke.train_bert_pretrain`` (BERTForPretrain
on bert_12_768_12 with dropout 0.1, Normal(0.02) weights from
``numpy.random.RandomState(0)``, one fixed 32 x 128 batch with 20 masked
positions a sequence), f32, ``random.seed(0)`` before each run, 30
Trainer("adamw", wd 0.01) steps under a CosineScheduler, for each
(learning rate, warm-up steps, dropout) of ``RECIPES``: the JAX package's
example recipe (lr 1e-3, 3 warm-up steps), BERT's published pretraining
learning rate (1e-4), and a few between. It prints each run's losses and
then one JSON line of them all (also ``chiprun_out/sweep_pretrain_lr/
sweep.json``).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# (label, learning rate, warm-up steps, dropout)
RECIPES = [("example", 1e-3, 3, 0.1), ("example, no dropout", 1e-3, 3, 0.0),
           ("example, 10 warm-up steps", 1e-3, 10, 0.1),
           ("lr 3e-4", 3e-4, 3, 0.1), ("lr 5e-4, 10 warm-up steps", 5e-4,
                                       10, 0.1),
           ("BERT's lr 1e-4", 1e-4, 3, 0.1)]


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sweep_pretrain_lr: no CUDA device")
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch import (autograd, gluon, gpu,
                                           lr_scheduler, random)
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.gluon import nn as gnn
    from incubator_mxnet_tpu_torch.models import (BERTForPretrain,
                                                  BERTPretrainLoss,
                                                  bert_12_768_12)
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_name_and_limit()
    print(card, flush=True)
    _build.build(("layer_norm",))
    cfg = cs.BERT_PRETRAIN
    net = BERTForPretrain(bert_12_768_12(
        vocab_size=cfg["vocab_size"], max_length=cfg["max_length"],
        use_pooler=True, ctx=gpu(0)), cfg["vocab_size"])
    arrays = cs.normal_arrays(net, seed=0)
    device = next(net.parameters()).device
    ids, tt, vl, pos, labels, nsp = (torch.from_numpy(a).to(device)
                                     for a in cs.pretrain_batch(cfg))
    loss_fn = BERTPretrainLoss()
    out = {"card": card, "runs": []}
    for label, lr, warmup, dropout in RECIPES:
        load_jax_params(net, arrays)
        for m in net.modules():
            if isinstance(m, gnn.Dropout):
                m._rate = dropout
            elif hasattr(m, "_dropout"):        # attention-weight dropout
                m._dropout = dropout
        trainer = gluon.Trainer(net, "adamw", {
            "learning_rate": lr, "wd": cfg["wd"],
            "lr_scheduler": lr_scheduler.CosineScheduler(
                cfg["steps"], base_lr=lr, warmup_steps=warmup)})
        random.seed(0)
        losses = []
        for _ in range(cfg["steps"]):
            with autograd.record():
                loss = loss_fn(*net(ids, tt, vl, pos), labels, nsp)
            autograd.backward(loss)
            trainer.step(cfg["batch"])
            losses.append(float(loss.detach()))
        run = {"label": label, "lr": lr, "warmup": warmup,
               "dropout": dropout, "losses": losses,
               "halved": losses[-1] < 0.5 * losses[0]}
        out["runs"].append(run)
        print(f"{label}: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    dest = ROOT / "chiprun_out" / "sweep_pretrain_lr"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / "sweep.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
