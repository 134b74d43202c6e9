#!/usr/bin/env python3
"""Drive the PyTorch port (incubator_mxnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and the CUDA version;
2. builds the hand-written CUDA kernels from ops/cuda/csrc with nvcc, one
   process per source, in parallel;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and a few more, and times the kernel,
   the plain version and one PyTorch library call that computes the same
   function, warm: device time from torch.profiler (`*_ms`, the numbers of
   the JSON line) and CUDA events around back-to-back calls (`*_wall_ms`,
   which include the host's launch cost). The kernels: the flash-attention
   forward, its dQ and dK/dV backward, the layer-norm forward, the
   scale/shift/act pass and the fused 1x1-conv GEMM with the BatchNorm
   epilogue and its split-K reduce: the SIMT GEMM (f32, and bf16 that
   TMA cannot describe) and the bf16 GEMM on the tensor cores (wgmma fed
   by TMA), each call on the route mm_route gives it (the flash forward
   and its two backward kernels run on the FMA units in f32 and on the
   tensor cores, wgmma fed by TMA, in bf16 and f16, at head dim 256 too,
   where the f32 forward, dQ and dK/dV run on the tensor cores by split
   TF32;
   held there at (4, 8, 512, 512, 256) causal and not, with kv_len cut
   mid-tile, with 130 rows (two ragged ones past two tiles), at the shape
   of train_lm_d256_bf16 and train_lm_d256_f32 and at head dim 192
   through the padding Function, each called twice for the same bits and
   traced: no launch of head dim 256 reaches an FMA kernel; in f32 the
   kernels and the plain version are also held
   against the plain version in float64, each kernel to F64_FACTOR times
   the plain version's error; the backward's delta = rowsum(dO * O) is
   timed beside the whole backward there; above head dim 256 the wide
   kernels, flash_fwd_wide_wgmma_kernel, flash_bwd_dq_wide_wgmma_kernel
   and flash_bwd_dkv_wide_wgmma_kernel (bf16, f16, wgmma fed by TMA; no
   launch is traced to an FMA kernel), flash_fwd_wide_tf32x3_kernel,
   flash_bwd_dq_wide_tf32x3_kernel and flash_bwd_dkv_wide_tf32x3_kernel
   (f32, split TF32) (flash_wide, the first phase: D = 512 at
   L = 512 causal and not, D = 320 ragged with lq < lk and kv_len < lk,
   D = 320 at 129 rows (bh * lq on every remainder mod 4, C11), D = 1024,
   the train_lm_d512 shape, D = 257 through the padding
   Function; O, lse, dQ, dK and dV against the plain version, in f32 also
   against float64 to WIDE_F64_FACTOR, twice for the same bits, traced,
   and timed against SDPA, whose backend is named)); in bf16 the SIMT
   kernel is timed beside the wgmma one at every shape of a forward. The
   GEMM is also run under forced splits of K against the plain version,
   and twice per case to show that two calls give the same bits, as are
   the flash forward and the flash backward's two kernels at the
   training shape, and the layer norm at every case of layer_norm_cases()
   with gamma and beta in f32 and in bf16 (the persistent kernel reads
   either as it is: a bf16 ops.layer_norm call must launch that kernel
   and nothing else);
4. serves BERT-base (bert_12_768_12, seq 128, random weights from
   numpy.random.RandomState(0) carried in through convert.load_jax_params)
   through FrozenModel -> DynamicBatcher -> ModelServer: FrozenModel
   captures one CUDA graph a bucket (1..32) and every request is a replay;
   16 HTTP clients send 4 requests each; every answer is checked against a
   direct predict_batch of its batch and against an all-plain forward,
   every bucket's replay against the frozen module's eager forward, the
   graphs against one a bucket (serving.compiles, .compiled_buckets), and
   the kernel launch counts against the pre-capture forwards and the
   replays (warm-ups and batches);
5. trains GPT-2-base (transformer_lm_base: 12 x 768, FFN 3072, 12 heads,
   vocab 50257, tied head, dropout 0) at batch 8 x seq 512 in f32 through
   autograd.record -> lm_loss -> autograd.backward -> Trainer("adam").step
   on period-16 token sequences: one step's loss and every gradient are
   held against an all-plain step from the same weights, the launch counts
   against 12 flash forward, 12 dQ, 12 dK/dV and 25 layer-norm launches per
   step, the loss after 30 steps against half of the first; then
   generate() continues a 32-token prompt by 16 tokens, which must continue
   the period;
6. trains ResNet-50 v1 written with BatchNormReLU and ops.ConvBNReLU
   (resnet50_v1_bnrelu: NHWC, 224 x 224, batch 128, f32, Normal(0.02)
   weights) on one fixed batch through autograd.record ->
   SoftmaxCrossEntropyLoss -> autograd.backward -> Trainer("sgd",
   momentum 0.9, wd 1e-4): step 0's loss, gradients and new moving
   statistics against an all-plain step, 33 scale/shift/act launches a
   step, the loss after 30 steps against half of the first. cuDNN runs
   deterministic algorithms in this phase, so the network it leaves, and
   every serving check made on it, is the same in every run;
7. serves the trained network through FrozenModel -> DynamicBatcher
   (buckets 1..32, one CUDA graph each; 8 threads submit 8 images each, in
   process): every answer against a direct predict_batch of its batch and
   an all-plain forward, every bucket's replay against the eager forward,
   one graph a bucket, 23 scale/shift/act and 30 GEMM launches per
   forward (pre-capture or replayed: the SIMT kernel in f32, the wgmma
   kernel in bf16, and no other GEMM kernel) and a split-K reduce for each
   GEMM whose plan splits K at the forward's bucket, and the zoo resnet50_v1
   with the same weights against the network; the BatchNorm folds' time
   (as a graph of their own) against a bucket-1 replay's device time;
8. runs each of the four paths again in bf16, from the same weights, by
   the port's mixed-precision recipes, each right after its f32 twin:
   BERT-base frozen with compute_dtype="bfloat16" (int32 ids pass
   uncast; float32 answers; ids 257 and 258 must answer unlike 256 and
   256) and served over HTTP; GPT-2-base by amp's recipe (amp.init, the
   module cast to bf16, Adam with multi_precision=True, amp.init_trainer
   with a DynamicLossScaler, amp.scale_loss), every trainer.step under
   torch.cuda.set_sync_debug_mode("error"), which raises on any host
   sync; ResNet-50 cast to bf16 on bf16 images with SGD and
   multi_precision=True (no scaler); and the f32-trained ResNet-50 frozen
   with compute_dtype="bfloat16" on float32 images. Each bf16 phase
   checks what its f32 twin checks, against an all-plain bf16 run of the
   same weights within 2e-2 of the largest value (BF16_TOL; BERT's
   answers BERT_BF16_TOL), its answers
   against the f32 phase's (BF16_VS_F32 of their norm), and that every
   kernel of ours in its profiler trace is the bf16 instance and no GEMM
   or conv kernel runs in f32 (half_only), and that every flash kernel in
   a bf16 trace is the wgmma one (a GPT-2 step: 12 forward, 12 dQ and 12
   dK/dV launches, no other). A bf16 tolerance that fails
   is logged and collected (expect), and the run fails at the end;
9. trains through the fused step, each step one CUDA graph (forward,
   backward and update captured once, then replayed): GPT-2-base in f32
   and in bf16 (module cast, Adam with f32 masters, no loss scaler)
   through TrainLoop(net, lm_loss, adam, chunk=5).fit(..., steps=30)
   under a CosineScheduler (3 warmup steps) whose lr the step computes on
   the card from its own count, and ResNet-50 (resnet50_v1_bnrelu, bf16,
   bench.py's SGD recipe with multi_precision) through
   FusedTrainStep.__call__ for 30 steps with cuDNN deterministic. Each
   checks one capture, the launches per step that the replays credit
   (plus the capture's warm-up forward and backward) with no plain call,
   every replay under set_sync_debug_mode("error"), the first steps
   against the same steps run op by op (eager_steps: GPT-2's first five
   losses within 1e-4 in f32 and BF16_TOL in bf16; ResNet's losses and
   moving statistics after three steps within BF16_TOL, the statistics
   moving at every replay), the loss going down (GPT-2: halved), and
   GPT-2's lr at steps 1, 3 and 30 against the host schedule; it reports
   the step, device and stream time, the idle share, the flash kernels'
   device time a step and the peak memory. Then train_lm_d256_bf16, the
   same bf16 phase at Gemma-2B's attention shape (d_model 2048, 8 heads of
   256, FFN 16384, 4 of its 18 layers; LM_D256): the head-dim-256 flash
   kernels on a training step, 4 forward, dQ and dK/dV launches a step;
   and train_lm_d256_f32, the same step in f32 with TF32 off for every
   GEMM (the split-TF32 dQ and dK/dV on a path), its trace held to those
   kernels; then train_lm_d512_bf16 and train_lm_d512_f32, the same two
   at LM_D512 (4 heads of 512, 2 layers): the wide flash kernels of head
   dims above 256 on a training step, 2 forward, dQ and dK/dV launches a
   step, its trace held to them.
   The eager GPT-2 phases also write the Trainer's states with
   save_states, load them into a fresh Trainer on a copy of the net, and
   hold one more step of each against the other;
10. right after the bf16 GPT-2 phase, pretrains BERT-base (MLM + NSP:
   BERTForPretrain(bert_12_768_12(use_pooler=True, dropout=0.1)), vocab
   30522, one fixed batch of 32 x 128 with valid lengths in [64, 128] and
   20 masked positions a sequence) through random.seed(0) ->
   autograd.record -> BERTPretrainLoss -> autograd.backward ->
   Trainer("adamw", lr 1e-4, wd 0.01, CosineScheduler over 30 steps with
   3 warm-up steps).step(32) for 30 steps, in f32 and then in bf16 by
   GPT-2's amp recipe: step 0's loss and every gradient against an
   all-plain step from the same seed (the same dropout masks), 26
   layer-norm launches and 12 flash rejections a step (the valid_length
   mask and attention dropout keep attention on the plain path, as in the
   JAX package) and no plain call, half_only on the bf16 trace (its
   gradients within BERT_PRETRAIN_BF16_TOL and no farther from the f32
   step's than the all-plain bf16 step's), the loss
   halved, a second run from random.seed(0) giving the same first three
   losses bit for bit, the step's times and memory, and one
   Trainer("sgld", lr 1e-4) step under sync debug "error" whose
   standardised noise on word_embed.weight must be N(0, 1) within 1e-3;
   then dropout inside a captured step: GPT-2's width at 2 layers with
   dropout 0.1 through FusedTrainStep (Adam at lr 0): five replays give
   five different losses, random.seed(7) then three replays, twice, the
   same three losses bit for bit, one capture, no host sync;
11. runs three paths in float16, by the port's f16 recipes, each right
   after its bf16 twin: BERT-base cast with .to(torch.float16), frozen
   with compute_dtype=None and served in process through DynamicBatcher
   (8 threads x 4 requests; serve_bert_f16); GPT-2-base trained by amp's
   f16 recipe (amp.init("float16"), the module cast, Adam with f32 masters
   under a CosineScheduler, a DynamicLossScaler from 2**16, each step
   under sync debug "error"; train_lm_f16): step 0 under a static scale
   of 2**10 against an all-plain f16 step and no farther from the f32
   step than it, the loss halved in 30 steps, the skipped steps and the
   final scale, and one step at scale 2**30 skipped with every weight
   bit for bit and the scale halved; and the trained ResNet-50 cast to
   f16, frozen with dtype="float16" (serve_resnet's f16 run). Each holds
   its answers against the f32 phase's, its launches per forward or
   step with no plain call, and a trace of f16 instances only
   (half_only); the kernel checks of step 3 run every kernel in f16 too,
   at the bf16 bounds. Then the space-to-depth stem (resnet_s2d): the
   zoo resnet50_v1(stem_s2d=True) loads the standard zoo network's state
   dict (the trained weights), its f32 forward and step-0 stem gradient
   match the standard stem's, both frozen in bf16 agree, and it trains
   10 bf16 steps through FusedTrainStep; and last a frozen
   Dropout(mode="always") module on the card (frozen_dropout_always):
   one fixed mask, call after call, as the JAX FrozenModel's PRNGKey(0)
   gives, the device's generator untouched;
12. exercises the rest of autograd in f32 (autograd_api): at GPT-2-base's
   width (8 x 512) grad(loss, params) against the .grad that backward
   writes from the same graph, grad leaving .grad untouched; pause()
   inside record() giving no graph; BERT pretraining's dropout-0.1
   forward under record() + predict_mode() equal to its eval forward;
   MXNet's sigmoid as a user autograd.Function between two 2048-wide
   Dense layers against torch.sigmoid; a gradient penalty ||df/dx||^2
   through a 4096-wide MLP with LayerNorm at batch 256 with
   create_graph=True against the same computation in float64 on the CPU;
   and a second derivative through the flash attention raising;
13. runs ResNet-50 v1 the MXNet way, through NDArrays (gluon_resnet): the
   zoo network from get_resnet(1, 50) with deferred shapes (as the JAX
   zoo's), initialize(init.Xavier(gaussian, in, 2), ctx=gpu(0)) and a
   first forward on a seeded batch of 128 (nd.array(..., ctx=gpu(0)))
   that completes them (every weight's std within 5% of
   sqrt(2 / fan_in), gammas ones, betas zeros, read from p.data()),
   hybridize(), Trainer(collect_params(), "sgd") for 30 eager steps under
   record() with loss.backward() and trainer.step (the loss halved;
   metric.Accuracy, TopKAccuracy(5) and CrossEntropy, given NDArrays,
   equal to numpy's every step, accuracy rising), grad_req="add" over two
   half batches against one full batch (1e-5 of each p.grad()'s largest),
   save_parameters and a fresh net's load_parameters(ctx=gpu(0)),
   hybridized: one CUDA graph a batch signature (32 and 8, two rounds),
   replays within 1e-6 of the trained net's eager forward, set_data of an
   NDArray reaching the next replay, and cast("bfloat16") within 2e-2 of
   the f32 norm (cuDNN deterministic in this phase); then BERT-base
   hybridized at 8 x 128 in predict mode, given NDArray ids and types:
   one capture, NDArray replays within 1e-6 of the eager forward, 12
   flash-forward and 25 layer-norm launches a replay, the eager forward
   and the replay timed;
14. runs the nd API on the card (nd_api): MXNet's minimal flow, linear
   regression on nd.random.uniform(shape=(4096, 1024), ctx=gpu(0)) by
   attach_grad, record(), nd.dot and w[:] = w - lr * w.grad, the loss
   halved in its steps; every case of the CPU parity table
   (tests/nd_parity_cases.py) on the card against the port on the CPU
   (f32 within ND_RTOL, integers and booleans exact, the same dtypes and
   shapes, every answer on the card); the funnel's cost an op against the
   same torch op; nd.save then nd.load on the card, and nd.waitall();
15. prints one JSON line with a record per kernel (f32 at its main path's
   shape, bf16 and f16 beside it, launches on the f32 and bf16 paths;
   then each f16 instance that an f16 path runs, with its launches on the
   three f16 paths; each flash row's head-dim-256 numbers under "d256";
   an entry for each bf16 and each f32 flash instance at head dim 256,
   with its launches on train_lm_d256_bf16 or train_lm_d256_f32, and for
   each bf16 and each f32 wide kernel, with its launches on
   train_lm_d512_bf16 or train_lm_d512_f32 and its f16 instance's
   numbers beside the bf16 one),
   then, as the last line, {"ok": true, "device": {...}}.

Any failure exits non-zero. Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result. The whole log and a
detailed record are written to chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA's data sheet): dense tensor-core bf16,
# f32 outside the tensor cores, HBM3 bandwidth; and dense TF32, which the
# split-TF32 kernels (the f32 flash forward, dQ and dK/dV at head dim 256)
# run three times an f32 product on ("tf32x3": their bound is 3 x flops at
# this rate)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# the 16-bit dtypes, by the template type in their kernels' names: each
# kernel row has one template for both (rows 2-4 and 6 on the tensor
# cores' wgmma)
HALF_TYPES = {"bfloat16": "__nv_bfloat16", "float16": "__half"}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# the bf16 phases' tolerance checks: a failure is logged and collected, so
# that one run reports every one of them, and main() fails on any before it
# prints a result
FAILED = []


def expect(cond, msg):
    if not cond:
        FAILED.append(msg)
        log(f"FAILED: {msg}")


# the full log and a detailed record; the tail of stdout carries the result
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
_log_file = None


def log(*a):
    print(*a, flush=True)
    if _log_file is not None:
        print(*a, file=_log_file, flush=True)


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, iters=50):
    """Mean time per call of `fn` on the stream over `iters` back-to-back
    calls (CUDA events, after one warm-up call). Where the host takes longer
    to launch a call than the card to run it, this is the host's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the kernel_counts() entry -> the _kernel_kind() of the kernel it counts;
# "flash_fwd" counts both forward kernels of row 2 (flash_fwd_kernel in f32,
# flash_fwd_wgmma_kernel in bf16), one kind; so do "flash_bwd_dq" (row 3:
# flash_bwd_dq_kernel, flash_bwd_dq_wgmma_kernel) and "flash_bwd_dkv"
# (row 4)
_COUNT_KIND = {"flash_fwd": "flash_attention", "flash_bwd_dq": "flash_bwd_dq",
               "flash_bwd_dkv": "flash_bwd_dkv", "layer_norm": "layer_norm",
               "scale_shift_act": "scale_shift_act",
               "mm_epilogue": "mm_epilogue", "mm_wgmma": "mm_wgmma",
               "mm_splitk_reduce": "mm_splitk_reduce"}
# the one key of device_ms's times where no whole trace came back
STREAM_KEY = "(stream time: every trace short)"
# profiler traces taken by device_ms and traced_flash, those short, the
# times where the stream time stood in, and the short traces written out
TRACES = {"taken": 0, "short": 0, "stream_time": 0, "written": 0}
# the most short traces written to OUT_DIR / "short_traces"
SHORT_WRITTEN = 12
# each trace makes one call of its own first, then launches a spin kernel
# of this many clock cycles (about 2 ms on the H100) as a mark, and reads
# only the device events that start after the mark ends: in some runs the
# profiler drops every device event that ends before a trace's first CUDA
# graph launch returns (the input's copy and the first 8 kernels of a
# replayed ResNet forward), the same ones in every retake, and neither a
# host wait nor a kernel at the trace's start stops it (PERF.md §6)
MARK_CYCLES = 4_000_000
MARK_KERNEL = "spin_kernel"
# a device event of a trace as device_ms and traced_flash read it: its
# name, the times it ran and its device time in µs (key_averages' names)
Traced = collections.namedtuple("Traced",
                                "key count self_device_time_total")


def _trace(calls, iters=1):
    """One profiler trace of `iters` calls of `calls`, after one call of
    its own and the mark (MARK_CYCLES), counted in TRACES. Returns the
    profiler, the device events that start after the mark ends summed by
    name ([Traced], None where the mark did not come back) and the
    launches that the wrappers counted in the `iters` calls
    ({_COUNT_KIND kind: launches})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        calls()
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        before = kernel_counts()
        for _ in range(iters):
            calls()
        torch.cuda.synchronize()
        after = kernel_counts()
    TRACES["taken"] += 1
    launched = {_COUNT_KIND[k]: after[k][0] - before[k][0] for k in after}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    marks = [e.end_ns() for e in events if MARK_KERNEL in e.name()]
    if len(marks) != 1:
        return prof, None, launched
    sums = {}
    for e in events:
        if e.start_ns() >= marks[0]:
            n, ns = sums.get(e.name(), (0, 0))
            sums[e.name()] = (n + 1, ns + e.end_ns() - e.start_ns())
    return prof, [Traced(k, n, ns / 1e3) for k, (n, ns) in sums.items()], \
        launched


def _write_short(prof, why, iters, launched):
    """Writes a short trace's events (device events and the host's CUDA
    calls: name, start and length in ns from the first, correlation id) to
    OUT_DIR / "short_traces", the first SHORT_WRITTEN of a run, for the
    question of what the profiler drops (PERF.md §7)."""
    from torch.autograd import DeviceType
    if TRACES["written"] >= SHORT_WRITTEN:
        return
    TRACES["written"] += 1
    events = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in events), default=0)
    names, rows = {}, {"device": [], "calls": []}
    for e in events:
        side = "device" if e.device_type() == DeviceType.CUDA else "calls"
        rows[side].append([names.setdefault(e.name(), len(names)),
                           e.start_ns() - t0, e.end_ns() - e.start_ns(),
                           e.correlation_id()])
    out = OUT_DIR / "short_traces"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{TRACES['written']:02d}.json").write_text(json.dumps(
        {"why": why, "iters": iters, "launched": launched,
         "names": list(names), **rows}))


def _short(events, iters, launched):
    """Why a trace's device events do not hold all the traced calls' work,
    or "" where they do. Each kernel of ours must appear exactly as often
    as its wrapper counted launches (`launched`: kind -> launches). Where
    the calls launched none of ours, every kernel or copy must appear a
    whole multiple of `iters` times (each call launches the same work);
    where they did (a model's forward or step), the other kernels are not
    held to that: such a call need not launch the same library kernels
    every time."""
    if not events:
        return "no device events"
    seen, odd = {}, []
    for e in events:
        kind = _kernel_kind(e.key)
        if kind in launched:
            seen[kind] = seen.get(kind, 0) + e.count
        elif e.count % iters:
            odd.append(f"{e.key[:40]} x{e.count}")
    wrong = {kind: (seen.get(kind, 0), n) for kind, n in launched.items()
             if seen.get(kind, 0) != n}
    if wrong:
        return f"ours (traced, launched) {wrong}"
    if odd and not any(launched.values()):
        return f"not a multiple of {iters}: {odd[:3]}"
    return ""


def device_ms(fn, iters=20, tries=4):
    """Kernel time on the card per call of `fn`: the profiler's device time
    of every kernel (and copy) the calls launched, summed, over `iters`.
    Only a whole trace (:func:`_short`) is read. The profiler on the H100
    now and then returns one with events missing, or none at all; such a
    trace is counted in TRACES and taken again. After `tries` short traces
    the calls' stream time (:func:`time_ms`, which holds the host's launch
    time) stands in, under the one key STREAM_KEY. Each trace reads only
    the calls after its own first one (:func:`_trace`); a short trace
    whose kernels of ours fall short is written out (:func:`_write_short`).
    Returns (total ms, {kernel name: ms})."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        prof, events, launched = _trace(fn, iters)
        if events is None:
            TRACES["short"] += 1
            log("device_ms: short trace (no mark), taken again")
            continue
        events = [e for e in events if e.self_device_time_total > 0]
        why = _short(events, iters, launched)
        if not why:
            per = {}
            for e in events:
                per[e.key] = (per.get(e.key, 0.0)
                              + e.self_device_time_total / iters / 1e3)
            return sum(per.values()), per
        TRACES["short"] += 1
        if why.startswith("ours"):
            _write_short(prof, why, iters, launched)
        log(f"device_ms: short trace ({sum(e.count for e in events)} "
            f"device events; {why}), taken again")
    TRACES["stream_time"] += 1
    ms = time_ms(fn, iters)
    log(f"device_ms: {tries} short traces, stream time {ms:.4f} ms stands "
        f"in")
    return ms, {STREAM_KEY: ms}


def measure(kernel, plain, library=None):
    """Device time (profiler) and stream time (events) of the kernel's
    wrapper, its plain version and the library call (None where no one
    PyTorch call computes the same function)."""
    out = {"library_ms": None, "library_wall_ms": None}
    for name, fn in (("kernel", kernel), ("plain", plain),
                     ("library", library)):
        if fn is None:
            continue
        out[f"{name}_ms"], per = device_ms(fn)
        out[f"{name}_wall_ms"] = time_ms(fn)
        out[f"{name}_timer"] = ("stream" if STREAM_KEY in per else
                                "profiler")
        out[f"{name}_names"] = sorted(per)
    return out


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def fmt_times(r):
    lib = ("none" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} (wall {r['library_wall_ms']:.4f})")
    return (f"kernel_ms {r['kernel_ms']:.4f} (wall {r['kernel_wall_ms']:.4f})"
            f" plain_ms {r['plain_ms']:.4f} library_ms {lib} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_cases():
    """(name, B, H, lq, lk, D, causal, layout, kv_len). "qkv" views q, k, v
    out of one (B, L, 3*H*D) projection, as multi-head attention hands them
    over; "bhld" is contiguous (B, H, L, D). bert_b1, bert_b8 and bert_b32
    are BERT's serving buckets, lm_b8_l512_causal the LM's training shape;
    lq160_lk200_causal holds the heavy-first block order with an odd number
    of query tiles (3 of 64 rows) and a causal offset of 40, which is no
    multiple of a tile; d128_lq96_lk224_causal does the same at D = 128
    (two column boxes a tile on the bf16 kernel), and
    kv_len100_l192_causal cuts the keys mid-tile under the causal mask, on
    QKV views. The d256 cases are head dim 256 (C5; f32 on
    flash_fwd_tf32x3_kernel, bf16 and f16 on flash_fwd_wgmma_kernel): the
    whole
    of one wave and more at L = 512, kv_len cut mid-tile under the causal
    mask on QKV views, and lm_d256_b8_l512_causal the shape that
    train_lm_d256_bf16 (Gemma-2B's 8 heads of 256) gives the kernels."""
    return [
        ("bert_b8", 8, 12, 128, 128, 64, False, "qkv", None),
        ("bert_b1", 1, 12, 128, 128, 64, False, "qkv", None),
        ("bert_b32", 32, 12, 128, 128, 64, False, "qkv", None),
        ("bert_b8_causal", 8, 12, 128, 128, 64, True, "qkv", None),
        ("lm_b8_l512_causal", 8, 12, 512, 512, 64, True, "qkv", None),
        ("l512", 2, 12, 512, 512, 64, False, "bhld", None),
        ("l512_causal", 2, 12, 512, 512, 64, True, "bhld", None),
        ("decode_lq1_lk128", 8, 12, 1, 128, 64, True, "bhld", None),
        ("unaligned_l100", 8, 12, 100, 100, 64, False, "qkv", None),
        ("unaligned_l100_causal", 8, 12, 100, 100, 64, True, "qkv", None),
        ("lq160_lk200_causal", 2, 12, 160, 200, 64, True, "bhld", None),
        ("kv_len77_l128", 2, 12, 128, 128, 64, False, "bhld", 77),
        ("kv_len0_no_key", 2, 4, 64, 64, 64, True, "bhld", 0),
        ("d128_l256", 2, 8, 256, 256, 128, False, "bhld", None),
        ("d128_l256_causal", 2, 8, 256, 256, 128, True, "bhld", None),
        ("d128_lq96_lk224_causal", 2, 8, 96, 224, 128, True, "bhld", None),
        ("kv_len100_l192_causal", 2, 12, 192, 192, 64, True, "qkv", 100),
        ("d256_l512", 4, 8, 512, 512, 256, False, "bhld", None),
        ("d256_l512_causal", 4, 8, 512, 512, 256, True, "bhld", None),
        ("d256_kv_len100_l192_causal", 2, 8, 192, 192, 256, True, "qkv",
         100),
        ("lm_d256_b8_l512_causal", 8, 8, 512, 512, 256, True, "qkv", None),
    ]


# the cases whose records the kernels line carries at head dim 256, timed
# and called twice; the last is train_lm_d256_bf16's shape
D256_CASES = ("d256_l512", "d256_l512_causal", "lm_d256_b8_l512_causal")


def flash_kernel_name(kind, dtype, d):
    """The start of the traced name of the `kind` kernel ("flash_fwd",
    "flash_bwd_dq" or "flash_bwd_dkv") that a call in `dtype` at head dim
    `d` launches: above 256 the split-TF32 wide form of every kind in f32
    and the wide wgmma form of every kind in bf16 and f16; up to 256 the
    wgmma form in bf16 and f16; in f32 the FMA form, but the split-TF32 one
    at head dim 256."""
    if d > 256:
        form = "wide_wgmma_" if dtype in HALF_TYPES else "wide_tf32x3_"
        return f"{kind}_{form}kernel<{HALF_TYPES.get(dtype, 'float')}"
    if dtype in HALF_TYPES:
        return f"{kind}_wgmma_kernel<{HALF_TYPES[dtype]}"
    if d == 256:
        return f"{kind}_tf32x3_kernel<float"
    return f"{kind}_kernel<float"


# the flash kernels against their plain versions: f32 sums in other orders;
# bf16 and f16 outputs round once from f32 on both sides (f16 keeps 11
# significant bits to bf16's 8, so its bound is no looser)
FLASH_TOLS = (("float32", 1e-4), ("bfloat16", 2e-2), ("float16", 2e-2))


def make_qkv(b, h, lq, lk, d, layout, dtype, gen):
    import torch
    if layout == "qkv":
        qkv = torch.randn(b, lq, 3 * h * d, generator=gen, device="cuda")
        q, k, v = qkv.to(dtype).chunk(3, dim=-1)
        return [t.reshape(b, lq, h, d).transpose(1, 2) for t in (q, k, v)]
    return [torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype)
            for n in (lq, lk, lk)]


def lse_err(lse, ref):
    """max |lse - plain| over the rows that see a key (the others are -inf
    in both, which torch.allclose holds equal)."""
    seen = ref.isfinite()
    return max_err(lse[seen], ref[seen]) if bool(seen.any()) else 0.0


FLASH_KINDS = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")


def traced_flash(fn, what, tries=4):
    """The flash kernels one call of `fn` launches, as the profiler traces
    them: {kernel name: times it ran}. A trace whose flash kernels do not
    add up, kind by kind, to the launches the wrappers counted is taken
    again; after `tries` of them the check fails."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        _, events, launched = _trace(fn)
        launched = {k: n for k, n in launched.items() if k in FLASH_KINDS}
        got = {e.key: e.count for e in events or ()
               if _kernel_kind(e.key) in FLASH_KINDS}
        if events is not None and all(
                sum(n for k, n in got.items() if _kernel_kind(k) == kind)
                == launched.get(kind, 0) for kind in FLASH_KINDS):
            return got
        TRACES["short"] += 1
        log(f"traced_flash: short trace ({got} against {launched}), taken "
            f"again")
    raise SmokeError(f"{what}: no whole profiler trace of the flash kernels "
                     f"in {tries} tries")


def hold_routes(fn, dtype, kinds, what, d=256):
    """At head dim 256 (or `d`, above it): every launch of one call of
    `fn` of each kind in `kinds` (the _COUNT_KIND kinds it launches) is
    the kernel that flash_kernel_name gives, counted by traced name: at
    256 in bf16 and f16 the wgmma kernels, in f32 the split-TF32 ones, and
    none reaches an FMA kernel's D = 256 instance; above 256 the wide
    kernels of the dtype, and none is an FMA wide kernel
    (`<kind>_wide_kernel<`). Returns {name: launches}."""
    t = HALF_TYPES.get(dtype, "float")
    got = traced_flash(fn, what)
    for kind in kinds:
        count = {"flash_attention": "flash_fwd"}.get(kind, kind)
        want = flash_kernel_name(count, dtype, d) + (
            ", 256>" if d == 256 else ">")
        fma = (f"{count}_wide_kernel<" if d > 256 else
               f"{count}_kernel<{t}, 256>")
        names = {n: c for n, c in got.items() if _kernel_kind(n) == kind}
        check(names and all(want in n for n in names)
              and not any(fma in n for n in names),
              f"{what}: {kind} traced as {names}, not {want} alone")
    log(f"{what}: traced " + ", ".join(f"{n[:60]} x{c}"
                                       for n, c in got.items()))
    return got


def check_flash(records):
    """The forward kernels against their plain version in every case, f32
    (flash_fwd_kernel; at head dim 256 flash_fwd_tf32x3_kernel, split TF32
    on the tensor cores) and bf16 and f16 (flash_fwd_wgmma_kernel, on the
    tensor cores), timed against the bound and SDPA's forward; two calls
    compared bit for bit in every bf16 and f16 case and at the training
    shapes in f32; the profiler's trace of each timed call names the
    kernel of its dtype, and at head dim 256 every launch is traced to it;
    in f32 at head dims 256 and 192 O and lse are also held against the
    plain version in float64 (f64_fwd_errs)."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, h, lq, lk, d, causal, layout, kv_len in flash_cases():
        for dtype, tol in FLASH_TOLS:
            tdt = getattr(torch, dtype)
            q, k, v = make_qkv(b, h, lq, lk, d, layout, tdt, gen)
            scale = 1.0 / math.sqrt(d)
            kw = dict(causal=causal, scale=scale, kv_len=kv_len)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw)
            err, l_err = max_err(out, ref), lse_err(lse, ref_lse)
            ok = (torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
                  and torch.allclose(lse, ref_lse, rtol=tol, atol=tol))
            check(ok, f"flash {name} {dtype}: max |O - plain| {err}, "
                      f"max |lse - plain| {l_err} over tolerance {tol}")
            if kv_len == 0:
                check(int(torch.count_nonzero(out)) == 0
                      and bool(torch.isneginf(lse).all()),
                      f"flash {name}: rows without keys gave output")
            traced = wide = None
            if d == 256:
                traced = hold_routes(
                    lambda: fa.flash_attention_fwd(q, k, v, **kw), dtype,
                    ("flash_attention",), f"flash {name} {dtype}")
            if d == 256 and dtype == "float32":
                wide = f64_fwd_errs((q, k, v), kw, (out, lse),
                                    (ref, ref_lse), f"flash {name} {dtype}")
            if (name in ("lm_b8_l512_causal",) + D256_CASES
                    or dtype != "float32"):
                # no atomics, a fixed order of every sum: the same bits
                again = fa.flash_attention_fwd(q, k, v, **kw)
                torch.cuda.synchronize()
                check(torch.equal(out, again[0]) and torch.equal(
                    lse, again[1]), f"flash {name} {dtype}: two calls gave "
                                    f"different bits")
            if (causal and lq != lk) or (kv_len is not None and kv_len < lk):
                mask = fa._mask(lq, lk, lk if kv_len is None else kv_len,
                                causal, q.device)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=mask, scale=scale)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=causal, scale=scale)
            times = measure(
                lambda: fa.flash_attention_fwd(q, k, v, **kw),
                lambda: fa.flash_attention_ref(q, k, v, **kw),
                lib)
            if times["kernel_timer"] == "profiler":
                want = flash_kernel_name("flash_fwd", dtype, d)
                fwd = [n for n in times["kernel_names"]
                       if _kernel_kind(n) == "flash_attention"]
                check(fwd and all(want in n for n in fwd),
                      f"flash {name} {dtype}: traced {fwd}, not {want}")
            pairs = visible_pairs(lq, lk, causal, kv_len)
            flops = 4.0 * b * h * pairs * d
            elt = q.element_size()
            nbytes = (b * h * (2 * lq + 2 * lk) * d * elt + b * h * lq * 4)
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            fma = {}
            if dtype == "float32" and d == 256:
                # split TF32: three TF32 products an f32 one, under the
                # FMA units' bound
                fma = dict(bound_fma_ms=bound_ms, f64=wide)
                bound_ms, bound_by = bound(flops, nbytes, "tf32x3")
            rec = dict(kernel="flash_attention_fwd", case=name,
                       shape=[b, h, lq, lk, d], causal=causal, layout=layout,
                       kv_len=kv_len, dtype=dtype, tol=tol, max_abs_err=err,
                       lse_max_abs_err=l_err, bound_ms=bound_ms,
                       bound_by=bound_by, pairs=pairs, traced=traced,
                       **fma, **times)
            if name == "bert_b8":
                # what the autograd.Function adds on the host per call,
                # as the serving path calls it
                with torch.inference_mode():
                    rec["function_wall_ms"] = time_ms(
                        lambda: fa.flash_attention(q, k, v, causal=causal,
                                                   scale=scale))
            records.append(rec)
            log(f"flash {name:22s} {dtype:8s} err {err:.2e} lse_err "
                f"{l_err:.2e} " + fmt_times(rec))
        if name == "lm_b8_l512_causal":
            log(f"flash {name}: two calls bit-identical in f32, bf16 and "
                f"f16")
    log("flash: two calls bit-identical in every bf16 and f16 case")

    # head dims the kernels do not take: the Function pads them with zeros
    # (32 to 64; 192 to 256, C5) and launches the kernel; held against the
    # plain version at the true head dim
    for b, h, l, d in PADDED_CASES:
        for dtype, tol in FLASH_TOLS:
            q, k, v = make_qkv(b, h, l, l, d, "qkv", getattr(torch, dtype),
                               gen)
            before = fa.launches
            with torch.no_grad():
                out = fa.flash_attention(q, k, v, causal=True)
                again = fa.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            ref, _ = fa.flash_attention_ref(q, k, v, causal=True)
            err = max_err(out, ref)
            check(fa.launches == before + 2 and out.shape == ref.shape,
                  f"flash d{d} {dtype}: the padded call did not launch the "
                  f"kernel")
            check(torch.equal(out, again),
                  f"flash d{d} {dtype}: two calls gave different bits")
            traced = wide = None
            if fa.kernel_head_dim(d) == 256:
                with torch.no_grad():
                    traced = hold_routes(
                        lambda: fa.flash_attention(q, k, v, causal=True),
                        dtype, ("flash_attention",),
                        f"flash d{d}_padded {dtype}")
            if fa.kernel_head_dim(d) == 256 and dtype == "float32":
                wide = f64_fwd_errs((q, k, v), dict(causal=True), (out,),
                                    (ref,), f"flash d{d}_padded {dtype}")
            check(torch.allclose(out.float(), ref.float(), rtol=tol,
                                 atol=tol),
                  f"flash d{d} {dtype}: max |O - plain| {err} over "
                  f"tolerance {tol}")
            records.append(dict(kernel="flash_attention_fwd",
                                case=f"d{d}_padded", shape=[b, h, l, l, d],
                                causal=True, layout="qkv", dtype=dtype,
                                tol=tol, max_abs_err=err, traced=traced,
                                f64=wide))
            log(f"flash d{d}_padded (head dim {d} run at "
                f"{fa.kernel_head_dim(d)}) {dtype:8s} err {err:.2e}")


# (B, H, L, D) of the padded calls through the Function, causal, on QKV
# views: D = 32 runs at 64, D = 192 at 256
PADDED_CASES = ((8, 12, 128, 32), (2, 8, 128, 192))


def flash_bwd_cases():
    """(name, B, H, lq, lk, D, causal, layout, kv_len). The first is the
    training path's: GPT-2-base at batch 8, seq 512, causal, q, k and v cut
    out of one QKV projection. lq160_lk200_causal holds the kernels' heavy-
    first block order: an odd number of query tiles (3 of 64 rows, 5 of 32)
    and a causal offset of 40, which is no multiple of a tile.
    lq130_lk200_causal puts a head's lse and delta rows at bh * 130, off
    the 16-byte boundary that the dK/dV kernel's TMA boxes start on (it
    starts them at the multiple of 4 below). The d256
    cases are head dim 256 (C5), timed like the training shape (but
    d256_kv_len100_l192_causal and d256_l130_causal, whose two calls are
    compared all the same); d256_l130_causal ends in two ragged rows past
    two 64-row tiles, which the last tile of each kernel masks."""
    return [
        ("lm_b8_l512_causal", 8, 12, 512, 512, 64, True, "qkv", None),
        ("noncausal_l128", 8, 12, 128, 128, 64, False, "qkv", None),
        ("unaligned_l100", 8, 12, 100, 100, 64, False, "qkv", None),
        ("unaligned_l100_causal", 8, 12, 100, 100, 64, True, "qkv", None),
        ("d128_l256_causal", 2, 8, 256, 256, 128, True, "bhld", None),
        ("lq100_lk300_causal", 2, 12, 100, 300, 64, True, "bhld", None),
        ("kv_len77_l128", 2, 12, 128, 128, 64, False, "bhld", 77),
        ("kv_len0_no_key", 2, 4, 64, 64, 64, True, "bhld", 0),
        ("lq160_lk200_causal", 2, 12, 160, 200, 64, True, "bhld", None),
        ("lq130_lk200_causal", 2, 12, 130, 200, 64, True, "qkv", None),
        ("d256_l512", 4, 8, 512, 512, 256, False, "bhld", None),
        ("d256_l512_causal", 4, 8, 512, 512, 256, True, "bhld", None),
        ("d256_kv_len100_l192_causal", 2, 8, 192, 192, 256, True, "qkv",
         100),
        ("d256_l130_causal", 2, 8, 130, 130, 256, True, "bhld", None),
        ("lm_d256_b8_l512_causal", 8, 8, 512, 512, 256, True, "qkv", None),
    ]


# the split-TF32 kernels (f32 at head dim 256) against the plain version
# in float64: each kernel's largest error at most this many times the f32
# plain version's own. The dropped small.small term and the small parts'
# rounding are near 2^-21 of a product, against f32's 2^-24.
F64_FACTOR = 8.0


def f64_errs(args, kw, got, plain, what, factor=F64_FACTOR):
    """dQ, dK and dV of the kernels (`got`, by name) and of the f32 plain
    version (`plain`) against the plain version run in float64 on the same
    inputs (q, k, v, dO, lse and delta widened, which is exact); each
    kernel's largest error must be at most F64_FACTOR times the f32 plain
    version's largest (`factor` times: the wide kernels' WIDE_F64_FACTOR).
    Returns both errors by gradient."""
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    wide = [t.double() for t in args]
    want = {"dq": fa.flash_attention_bwd_dq_ref(*wide, **kw)}
    want["dk"], want["dv"] = fa.flash_attention_bwd_dkv_ref(*wide, **kw)
    errs = {g: {"kernel": float((got[g].double() - w).abs().max()),
                "plain_f32": float((plain[g].double() - w).abs().max())}
            for g, w in want.items()}
    for kernel, gn in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
        k_err = max(errs[g]["kernel"] for g in gn)
        p_err = max(errs[g]["plain_f32"] for g in gn)
        check(k_err <= factor * p_err,
              f"{what}: the {kernel} kernel's largest error against float64 "
              f"{k_err} is over {factor} x the f32 plain version's "
              f"{p_err}")
    log(f"{what}: against float64, kernel / f32 plain: " + ", ".join(
        f"{g} {e['kernel']:.2e} / {e['plain_f32']:.2e}"
        for g, e in errs.items()))
    return errs


def f64_fwd_errs(qkv, kw, got, plain, what, factor=F64_FACTOR):
    """The forward's O (and lse, where `got` has it) from the kernel
    (`got`) and from the f32 plain version (`plain`) against the plain
    version run in float64 on the same q, k, v (widened, which is exact),
    at the head dim the call was given (the padding Function's 192 too);
    each kernel error at most `factor` (F64_FACTOR) times the f32 plain
    version's.
    The lse is compared over the rows that see a key. Returns both errors
    by output."""
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    want = fa.flash_attention_ref(*(t.double() for t in qkv), **kw)
    seen = want[1].isfinite()
    errs = {}
    for name, g, p, w in zip(("o", "lse"), got, plain, want):
        if name == "lse":
            g, p, w = g[seen], p[seen], w[seen]
        errs[name] = {"kernel": float((g.double() - w).abs().max()),
                      "plain_f32": float((p.double() - w).abs().max())}
        check(errs[name]["kernel"] <= factor * errs[name]["plain_f32"],
              f"{what}: the forward kernel's largest {name} error against "
              f"float64 {errs[name]['kernel']} is over {factor} x the f32"
              f" plain version's {errs[name]['plain_f32']}")
    log(f"{what}: against float64, kernel / f32 plain: " + ", ".join(
        f"{n} {e['kernel']:.2e} / {e['plain_f32']:.2e}"
        for n, e in errs.items()))
    return errs


def visible_pairs(lq, lk, causal, kv_len):
    """(query, key) pairs the masks let through."""
    kv_lim = lk if kv_len is None else kv_len
    if not causal:
        return lq * kv_lim
    return sum(max(0, min(kv_lim, r + lk - lq + 1)) for r in range(lq))


def check_flash_bwd(records):
    """The dQ and dK/dV kernels (f32: flash_bwd_dq_kernel and
    flash_bwd_dkv_kernel; bf16 and f16: flash_bwd_dq_wgmma_kernel and
    flash_bwd_dkv_wgmma_kernel) against their plain versions, from the
    same q, k, v, dO, lse and delta; at the training shape, two calls of
    each kernel compared bit for bit, the traced kernels' names held to
    the dtype's, and the kernels timed against SDPA's backward
    (torch.autograd.grad of scaled_dot_product_attention)."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, b, h, lq, lk, d, causal, layout, kv_len in flash_bwd_cases():
        for dtype, tol in FLASH_TOLS:
            tdt = getattr(torch, dtype)
            q, k, v = make_qkv(b, h, lq, lk, d, layout, tdt, gen)
            scale = 1.0 / math.sqrt(d)
            kw = dict(causal=causal, scale=scale, kv_len=kv_len)
            out, lse = fa.flash_attention_ref(q, k, v, **kw)
            # dO as autograd hands it over: (B, H, L, D) views of (B, L, H, D)
            do = torch.randn(b, lq, h, d, generator=gen, device="cuda").to(
                tdt).permute(0, 2, 1, 3)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, delta)
            dq = fa.flash_attention_bwd_dq(*args, **kw)
            dk, dv = fa.flash_attention_bwd_dkv(*args, **kw)
            torch.cuda.synchronize()
            ref_dq = fa.flash_attention_bwd_dq_ref(*args, **kw)
            ref_dk, ref_dv = fa.flash_attention_bwd_dkv_ref(*args, **kw)
            errs = {}
            for g, ref, gname in ((dq, ref_dq, "dq"), (dk, ref_dk, "dk"),
                                  (dv, ref_dv, "dv")):
                errs[gname] = max_err(g, ref)
                check(bool(torch.isfinite(g.float()).all()),
                      f"flash bwd {name} {dtype}: non-finite {gname}")
                check(torch.allclose(g.float(), ref.float(), rtol=tol,
                                     atol=tol),
                      f"flash bwd {name} {dtype}: max |{gname} - plain| "
                      f"{errs[gname]} over tolerance {tol}")
            if kv_len == 0:
                check(all(int(torch.count_nonzero(g)) == 0
                          for g in (dq, dk, dv)),
                      f"flash bwd {name}: rows without keys gave gradients")
            pairs = visible_pairs(lq, lk, causal, kv_len)
            elt = q.element_size()
            # each input read once, each output written once: the kernels
            # read q, k, v, dO, lse and delta; the whole backward reads out
            # in place of delta
            qkvdo = b * h * (2 * lq + 2 * lk) * d * elt
            rows = b * h * lq * 4
            rec = dict(case=name, shape=[b, h, lq, lk, d], causal=causal,
                       kv_len=kv_len, layout=layout, dtype=dtype, tol=tol)
            if name == "lm_b8_l512_causal" or d == 256:
                # no atomics, a fixed order of every sum: the same bits
                # from a second call
                again = (fa.flash_attention_bwd_dq(*args, **kw),
                         *fa.flash_attention_bwd_dkv(*args, **kw))
                torch.cuda.synchronize()
                for g, g2, gname in zip((dq, dk, dv), again,
                                        ("dq", "dk", "dv")):
                    check(torch.equal(g, g2), f"flash bwd {name} {dtype}: "
                                              f"two calls gave different "
                                              f"{gname}")
            if d == 256:
                rec["traced"] = hold_routes(
                    lambda: (fa.flash_attention_bwd_dq(*args, **kw),
                             fa.flash_attention_bwd_dkv(*args, **kw)),
                    dtype, ("flash_bwd_dq", "flash_bwd_dkv"),
                    f"flash bwd {name} {dtype}")
            if d == 256 and dtype == "float32":
                rec["f64"] = f64_errs(
                    args, kw, {"dq": dq, "dk": dk, "dv": dv},
                    {"dq": ref_dq, "dk": ref_dk, "dv": ref_dv},
                    f"flash bwd {name} {dtype}")
            if name not in ("lm_b8_l512_causal",) + D256_CASES:
                for kernel, gn in (("flash_attention_bwd_dq", ("dq",)),
                                   ("flash_attention_bwd_dkv", ("dk", "dv"))):
                    records.append(dict(rec, kernel=kernel, max_abs_err=max(
                        errs[g] for g in gn)))
                log(f"flash bwd {name:22s} {dtype:8s} err dq {errs['dq']:.2e}"
                    f" dk {errs['dk']:.2e} dv {errs['dv']:.2e}")
                continue
            # the training shapes: times against the bounds and SDPA
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                   scale=scale)
            library = lambda: torch.autograd.grad(  # noqa: E731
                o_lib, leaves, do, retain_graph=True)
            for kernel, fn, plain, flops, nbytes, gn in (
                    ("flash_attention_bwd_dq",
                     lambda: fa.flash_attention_bwd_dq(*args, **kw),
                     lambda: fa.flash_attention_bwd_dq_ref(*args, **kw),
                     6.0 * b * h * pairs * d,
                     qkvdo + 2 * rows + b * h * lq * d * elt, ("dq",)),
                    ("flash_attention_bwd_dkv",
                     lambda: fa.flash_attention_bwd_dkv(*args, **kw),
                     lambda: fa.flash_attention_bwd_dkv_ref(*args, **kw),
                     8.0 * b * h * pairs * d,
                     qkvdo + 2 * rows + 2 * b * h * lk * d * elt,
                     ("dk", "dv")),
                    ("flash_attention_bwd_whole",
                     lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                    **kw),
                     lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse,
                                                        do, **kw),
                     10.0 * b * h * pairs * d,
                     qkvdo + rows + b * h * (2 * lq + 2 * lk) * d * elt,
                     ("dq", "dk", "dv"))):
                times = measure(fn, plain, library)
                if times["kernel_timer"] == "profiler":
                    kinds = {"flash_attention_bwd_dq": ("flash_bwd_dq",),
                             "flash_attention_bwd_dkv": ("flash_bwd_dkv",)}
                    for kind in kinds.get(kernel, ("flash_bwd_dq",
                                                   "flash_bwd_dkv")):
                        want = flash_kernel_name(kind, dtype, d)
                        got = [n for n in times["kernel_names"]
                               if _kernel_kind(n) == kind]
                        check(got and all(want in n for n in got),
                              f"{kernel} {dtype}: traced {got}, not {want}")
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                fma = {}
                if dtype == "float32" and d == 256:
                    # the split-TF32 kernels: the least time is three TF32
                    # products an f32 one, under the FMA units' bound
                    fma["bound_fma_ms"] = bound_ms
                    bound_ms, bound_by = bound(flops, nbytes, "tf32x3")
                r = dict(rec, kernel=kernel, max_abs_err=max(
                    errs[g] for g in gn), bound_ms=bound_ms,
                    bound_by=bound_by, flops=flops, pairs=pairs,
                    library="torch.autograd.grad of "
                            "scaled_dot_product_attention (dq, dk, dv)",
                    **fma, **times)
                records.append(r)
                log(f"{kernel:26s} {name} {dtype:8s} err "
                    f"{r['max_abs_err']:.2e} " + fmt_times(r))
            ratio = r["kernel_ms"] / r["library_ms"]
            if d == 256:
                # delta = rowsum(dO * O): the PyTorch ops of the whole
                # backward beside its two kernels
                r["delta_ms"] = device_ms(lambda: fa._delta(do, out))[0]
                r["delta_wall_ms"] = time_ms(lambda: fa._delta(do, out))
                log(f"flash bwd {name} {dtype}: delta's PyTorch ops "
                    f"{r['delta_ms']:.4f} ms (wall {r['delta_wall_ms']:.4f})"
                    f" of the whole backward's {r['kernel_ms']:.4f}")
            log(f"flash bwd {name} {dtype}: two calls bit-identical; whole "
                f"backward / SDPA's {ratio:.3f}; SDPA's backward launches "
                f"{r['library_names']}")

    # head dims the kernels do not take, through autograd: the Function
    # pads q, k, v and dO with zeros (32 to 64, 192 to 256), launches both
    # kernels and slices dQ, dK and dV back; held against the plain
    # backward at the true head dim
    for (b, h, l, d), (dtype, tol) in itertools.product(PADDED_CASES,
                                                        FLASH_TOLS):
        tdt = getattr(torch, dtype)
        q, k, v = make_qkv(b, h, l, l, d, "qkv", tdt, gen)
        do = torch.randn(b, h, l, d, generator=gen, device="cuda").to(tdt)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = (fa.dq_launches, fa.dkv_launches)
        grad = lambda: torch.autograd.grad(  # noqa: E731
            fa.flash_attention(*leaves, causal=True), leaves, do)
        got = grad()
        torch.cuda.synchronize()
        out, lse = fa.flash_attention_ref(q, k, v, causal=True)
        want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
        check((fa.dq_launches, fa.dkv_launches)
              == (before[0] + 1, before[1] + 1),
              f"flash bwd d{d} {dtype}: the padded call did not launch both "
              f"kernels")
        errs = {}
        for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
            errs[gname] = max_err(g, w)
            check(g.shape == w.shape and torch.allclose(
                g.float(), w.float(), rtol=tol, atol=tol),
                f"flash bwd d{d} {dtype}: max |{gname} - plain| "
                f"{errs[gname]} over tolerance {tol}")
        # two calls, the same bits
        check(all(torch.equal(g, g2) for g, g2 in zip(got, grad())),
              f"flash bwd d{d} {dtype}: two calls gave different bits")
        traced = wide = None
        if fa.kernel_head_dim(d) == 256:
            traced = hold_routes(grad, dtype, ("flash_attention",
                                               "flash_bwd_dq",
                                               "flash_bwd_dkv"),
                                 f"flash bwd d{d}_padded {dtype}")
        if fa.kernel_head_dim(d) == 256 and dtype == "float32":
            # the kernels on the zero-padded inputs that the Function
            # hands them, against float64 on the same inputs
            pq, pk, pv, pdo = (fa._pad(t, 256) for t in (q, k, v, do))
            kw = dict(causal=True, scale=1.0 / math.sqrt(d))
            pout, plse = fa.flash_attention_ref(pq, pk, pv, **kw)
            args = (pq, pk, pv, pdo, plse, fa._delta(pdo, pout))
            kernels = {"dq": fa.flash_attention_bwd_dq(*args, **kw)}
            kernels["dk"], kernels["dv"] = fa.flash_attention_bwd_dkv(
                *args, **kw)
            plain = {"dq": fa.flash_attention_bwd_dq_ref(*args, **kw)}
            plain["dk"], plain["dv"] = fa.flash_attention_bwd_dkv_ref(
                *args, **kw)
            wide = f64_errs(args, kw, kernels, plain,
                            f"flash bwd d{d}_padded {dtype}")
        for kernel, gn in (("flash_attention_bwd_dq", ("dq",)),
                           ("flash_attention_bwd_dkv", ("dk", "dv"))):
            records.append(dict(
                kernel=kernel, case=f"d{d}_padded", shape=[b, h, l, l, d],
                causal=True, layout="qkv", dtype=dtype, tol=tol,
                max_abs_err=max(errs[g] for g in gn), traced=traced,
                f64=wide))
        log(f"flash bwd d{d}_padded (head dim {d} run at "
            f"{fa.kernel_head_dim(d)}) {dtype:8s} err dq {errs['dq']:.2e} "
            f"dk {errs['dk']:.2e} dv {errs['dv']:.2e}")

    # dO with a zero stride on D, as autograd hands over an expanded
    # gradient: the wrapper copies it to a unit stride and does not raise;
    # in bf16 and f16 also a zero stride on the heads, which TMA does not
    # take: the wrapper copies it
    for dtype, tol, shape in (("float32", 1e-4, (2, 4, 64, 1)),
                              ("bfloat16", 2e-2, (2, 1, 64, 64)),
                              ("float16", 2e-2, (2, 1, 64, 64))):
        tdt = getattr(torch, dtype)
        q, k, v = make_qkv(2, 4, 64, 64, 64, "bhld", tdt, gen)
        out, lse = fa.flash_attention_ref(q, k, v, causal=True)
        do = torch.randn(*shape, generator=gen, device="cuda").to(
            tdt).expand(2, 4, 64, 64)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
        want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
        err = max(max_err(g, w) for g, w in zip(got, want))
        check(all(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)
                  for g, w in zip(got, want)),
              f"flash bwd {dtype} with an expanded dO: max err {err} over "
              f"tolerance {tol}")
        log(f"flash bwd expanded dO ({dtype}, stride 0 on "
            f"{'D' if shape[3] == 1 else 'H'}): err {err:.2e}")


# ---------------------------------------------------------------------------
# head dims above 256 (C5b): the wide kernels
# ---------------------------------------------------------------------------

def wide_cases():
    """(name, B, H, lq, lk, D, causal, layout, kv_len) at head dims above
    256, where every dtype runs the wide kernels
    (the forward's in csrc/flash_attention.cu, dQ's and dK/dV's in
    csrc/flash_attention_wide.cu): D = 512 at L = 512, full and causal; a
    ragged causal case at D = 320 with fewer queries than keys (200 of 300,
    a causal offset of 100, no multiple of a tile) and the keys cut at 250,
    mid-tile; D = 320 causal at 129 rows (two tiles and a ragged row), so
    that bh * lq falls on every remainder mod 4 and the 16-bit dK/dV's lse
    and delta boxes start below a head's first row (C11);
    D = 384 (a last chunk of O of 128 columns) likewise ragged;
    D = 384 with kv_len 0, where no row sees a key; D = 1024 at L = 128;
    and lm_d512_b8_l512_causal, the shape that train_lm_d512_bf16 and
    train_lm_d512_f32 give the kernels (4 heads of 512 at LM's batch and
    sequence, q, k and v cut out of one QKV projection)."""
    return [
        ("d512_l512", 2, 4, 512, 512, 512, False, "bhld", None),
        ("d512_l512_causal", 2, 4, 512, 512, 512, True, "bhld", None),
        ("d320_lq200_lk300_causal_kv250", 2, 4, 200, 300, 320, True, "bhld",
         250),
        ("d320_l129_causal", 1, 4, 129, 129, 320, True, "bhld", None),
        ("d384_lq100_lk160_causal_kv130", 1, 4, 100, 160, 384, True, "bhld",
         130),
        ("d384_kv_len0_no_key", 1, 2, 64, 64, 384, True, "bhld", 0),
        ("d1024_l128", 1, 2, 128, 128, 1024, False, "bhld", None),
        ("lm_d512_b8_l512_causal", 8, 4, 512, 512, 512, True, "qkv", None),
    ]


# the cases timed against the plain version and SDPA: the kernels line's
# shapes
WIDE_TIMED = ("d512_l512", "lm_d512_b8_l512_causal")
# f32 at head dims above 256: each wide kernel's largest error against the
# plain version in float64 at most this many times the f32 plain version's
# own (the forward, dQ and dK/dV all run split TF32 on the tensor cores;
# each 64-wide piece of S and of dP, and each 16 keys (queries) of P V,
# dS K, P^T dO and dS^T Q, summed apart and folded in with f32 rounding)
WIDE_F64_FACTOR = 2.0
# (B, H, L, D) of the padded call through the Function, causal, on QKV
# views: D = 257 runs at 320
WIDE_PADDED = (2, 4, 256, 257)


def sdpa_backend(names):
    """The backend scaled_dot_product_attention took, from the kernel names
    of its trace: "flash" (FlashAttention-2), "efficient" (the
    memory-efficient CUTLASS kernels, fmha_*), "cudnn", or "math" (the
    plain ops: GEMMs and a softmax)."""
    low = " ".join(names).lower()
    if "flash" in low:
        return "flash"
    if "fmha" in low or "efficient" in low:
        return "efficient"
    if "cudnn" in low:
        return "cudnn"
    return "math"


def flash_wide(records):
    """The wide kernels (flash_fwd_wide_wgmma_kernel,
    flash_bwd_dq_wide_wgmma_kernel and flash_bwd_dkv_wide_wgmma_kernel
    <__nv_bfloat16> and <__half>, flash_fwd_wide_tf32x3_kernel,
    flash_bwd_dq_wide_tf32x3_kernel and flash_bwd_dkv_wide_tf32x3_kernel
    <float>)
    against their plain versions in every case of wide_cases(), f32, bf16
    and f16: O and lse, then dQ, dK and dV from the plain forward's lse
    and delta, within FLASH_TOLS (the bounds of the other flash checks);
    two calls of each give the same bits; every launch is traced to the
    wide kernel of its dtype; in f32 each output is also held against the
    plain version in float64, at most WIDE_F64_FACTOR times the f32 plain
    version's error. At WIDE_TIMED each kernel is timed against its bound,
    its plain version and SDPA (the forward, or torch.autograd.grad of it
    for dQ and dK/dV), whose backend is named. Then D = 257 through
    flash_attention, padded to 320: one launch of each kernel, against the
    plain version at the true head dim, the same bits twice, traced, and in
    f32 the kernels on the padded inputs against float64."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(4)
    kinds = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")
    for name, b, h, lq, lk, d, causal, layout, kv_len in wide_cases():
        for dtype, tol in FLASH_TOLS:
            tdt = getattr(torch, dtype)
            what = f"flash wide {name} {dtype}"
            q, k, v = make_qkv(b, h, lq, lk, d, layout, tdt, gen)
            # dO as autograd hands it over: (B, H, L, D) views of (B, L, H, D)
            do = torch.randn(b, lq, h, d, generator=gen, device="cuda").to(
                tdt).permute(0, 2, 1, 3)
            kw = dict(causal=causal, scale=1.0 / math.sqrt(d), kv_len=kv_len)
            ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw)
            args = (q, k, v, do, ref_lse, fa._delta(do, ref))

            def run():
                return (*fa.flash_attention_fwd(q, k, v, **kw),
                        fa.flash_attention_bwd_dq(*args, **kw),
                        *fa.flash_attention_bwd_dkv(*args, **kw))
            got = dict(zip(("o", "lse", "dq", "dk", "dv"), run()))
            again = run()
            torch.cuda.synchronize()
            want = {"o": ref, "lse": ref_lse,
                    "dq": fa.flash_attention_bwd_dq_ref(*args, **kw)}
            want["dk"], want["dv"] = fa.flash_attention_bwd_dkv_ref(*args,
                                                                    **kw)
            errs = {}
            for g in ("o", "dq", "dk", "dv"):
                errs[g] = max_err(got[g], want[g])
                check(bool(torch.isfinite(got[g].float()).all())
                      and torch.allclose(got[g].float(), want[g].float(),
                                         rtol=tol, atol=tol),
                      f"{what}: max |{g} - plain| {errs[g]} over tolerance "
                      f"{tol}")
            errs["lse"] = lse_err(got["lse"], ref_lse)
            check(torch.equal(got["lse"].isfinite(), ref_lse.isfinite())
                  and torch.allclose(got["lse"], ref_lse, rtol=tol, atol=tol),
                  f"{what}: max |lse - plain| {errs['lse']} over tolerance "
                  f"{tol}")
            # no atomics, a fixed order of every sum: the same bits
            check(all(torch.equal(a, b2) for a, b2 in zip(got.values(),
                                                          again)),
                  f"{what}: two calls gave different bits")
            if kv_len == 0:
                check(not any(int(torch.count_nonzero(got[g]))
                              for g in ("o", "dq", "dk", "dv"))
                      and bool(torch.isneginf(got["lse"]).all()),
                      f"{what}: rows without keys gave output")
            traced = hold_routes(run, dtype, kinds, what, d)
            f64 = None
            # (with no key seen there is no error to weigh: all exact zeros)
            if dtype == "float32" and kv_len != 0:
                f64 = f64_fwd_errs((q, k, v), kw, (got["o"], got["lse"]),
                                   (ref, ref_lse), what, WIDE_F64_FACTOR)
                f64.update(f64_errs(
                    args, kw, got, want, what, WIDE_F64_FACTOR))
            rec = dict(case=name, shape=[b, h, lq, lk, d], causal=causal,
                       layout=layout, kv_len=kv_len, dtype=dtype, tol=tol,
                       traced=traced, f64=f64)
            by_kernel = (("flash_attention_fwd", ("o", "lse")),
                         ("flash_attention_bwd_dq", ("dq",)),
                         ("flash_attention_bwd_dkv", ("dk", "dv")))
            log(f"{what}: err " + " ".join(f"{g} {e:.2e}"
                                           for g, e in errs.items()))
            if name not in WIDE_TIMED:
                records.extend(dict(rec, kernel=kernel, max_abs_err=max(
                    errs[g] for g in gn)) for kernel, gn in by_kernel)
                continue
            # times against the bounds, the plain versions and SDPA
            pairs = visible_pairs(lq, lk, causal, kv_len)
            elt = q.element_size()
            # each input read once, each output written once: the forward
            # reads q, k, v and writes O (as many bytes as dO) and lse
            qkvdo = b * h * (2 * lq + 2 * lk) * d * elt
            rows = b * h * lq * 4
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                   scale=kw["scale"])
            for (kernel, gn), fn, plain, lib, flops, nbytes in zip(
                    by_kernel,
                    (lambda: fa.flash_attention_fwd(q, k, v, **kw),
                     lambda: fa.flash_attention_bwd_dq(*args, **kw),
                     lambda: fa.flash_attention_bwd_dkv(*args, **kw)),
                    (lambda: fa.flash_attention_ref(q, k, v, **kw),
                     lambda: fa.flash_attention_bwd_dq_ref(*args, **kw),
                     lambda: fa.flash_attention_bwd_dkv_ref(*args, **kw)),
                    (lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, scale=kw["scale"]),
                     lambda: torch.autograd.grad(o_lib, leaves, do,
                                                 retain_graph=True),
                     lambda: torch.autograd.grad(o_lib, leaves, do,
                                                 retain_graph=True)),
                    (4.0 * b * h * pairs * d, 6.0 * b * h * pairs * d,
                     8.0 * b * h * pairs * d),
                    (qkvdo + rows,
                     qkvdo + 2 * rows + b * h * lq * d * elt,
                     qkvdo + 2 * rows + 2 * b * h * lk * d * elt)):
                times = measure(fn, plain, lib)
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                fma = {}
                if dtype == "float32":
                    # split TF32's bound, the FMA units' beside it
                    fma["bound_fma_ms"] = bound_ms
                    bound_ms, bound_by = bound(flops, nbytes, "tf32x3")
                r = dict(rec, kernel=kernel, max_abs_err=max(
                    errs[g] for g in gn), bound_ms=bound_ms,
                    bound_by=bound_by, flops=flops, pairs=pairs,
                    library=("scaled_dot_product_attention"
                             if kernel == "flash_attention_fwd" else
                             "torch.autograd.grad of "
                             "scaled_dot_product_attention (dq, dk, dv)"),
                    sdpa_backend=sdpa_backend(times["library_names"]),
                    **fma, **times)
                records.append(r)
                log(f"{kernel:26s} {name} {dtype:8s} err "
                    f"{r['max_abs_err']:.2e} " + fmt_times(r)
                    + f" sdpa {r['sdpa_backend']}")
            del leaves, o_lib

    # D = 257 through the Function: padded to 320, the kernels' plain
    # versions at the true head dim beside them
    b, h, l, d = WIDE_PADDED
    dp = fa.kernel_head_dim(d)
    for dtype, tol in FLASH_TOLS:
        tdt = getattr(torch, dtype)
        what = f"flash wide d{d}_padded {dtype}"
        q, k, v = make_qkv(b, h, l, l, d, "qkv", tdt, gen)
        do = torch.randn(b, h, l, d, generator=gen, device="cuda").to(tdt)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def run():
            out = fa.flash_attention(*leaves, causal=True)
            return (out.detach(), *torch.autograd.grad(out, leaves, do))
        before = kernel_counts()
        got = run()
        torch.cuda.synchronize()
        after = kernel_counts()
        check(all(after[kd][0] == before[kd][0] + 1 for kd in
                  ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
              f"{what}: the padded call did not launch each kernel once")
        ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=True)
        want = (ref, *fa.flash_attention_bwd_ref(q, k, v, ref, ref_lse, do,
                                                 causal=True))
        errs = {}
        for g, w, gname in zip(got, want, ("o", "dq", "dk", "dv")):
            errs[gname] = max_err(g, w)
            check(g.shape == w.shape and torch.allclose(
                g.float(), w.float(), rtol=tol, atol=tol),
                f"{what}: max |{gname} - plain| {errs[gname]} over "
                f"tolerance {tol}")
        check(all(torch.equal(a, b2) for a, b2 in zip(got, run())),
              f"{what}: two calls gave different bits")
        traced = hold_routes(run, dtype, kinds, what, dp)
        f64 = None
        if dtype == "float32":
            # the kernels on the zero-padded inputs the Function hands them
            pq, pk, pv, pdo = (fa._pad(t, dp) for t in (q, k, v, do))
            kw = dict(causal=True, scale=1.0 / math.sqrt(d))
            pout, plse = fa.flash_attention_ref(pq, pk, pv, **kw)
            args = (pq, pk, pv, pdo, plse, fa._delta(pdo, pout))
            kern = {"dq": fa.flash_attention_bwd_dq(*args, **kw)}
            kern["dk"], kern["dv"] = fa.flash_attention_bwd_dkv(*args, **kw)
            plain = {"dq": fa.flash_attention_bwd_dq_ref(*args, **kw)}
            plain["dk"], plain["dv"] = fa.flash_attention_bwd_dkv_ref(
                *args, **kw)
            f64 = f64_fwd_errs((pq, pk, pv), kw,
                               fa.flash_attention_fwd(pq, pk, pv, **kw),
                               (pout, plse), what, WIDE_F64_FACTOR)
            f64.update(f64_errs(args, kw, kern, plain, what,
                                WIDE_F64_FACTOR))
        for kernel, gn in (("flash_attention_fwd", ("o",)),
                           ("flash_attention_bwd_dq", ("dq",)),
                           ("flash_attention_bwd_dkv", ("dk", "dv"))):
            records.append(dict(
                kernel=kernel, case=f"d{d}_padded", shape=[b, h, l, l, d],
                causal=True, layout="qkv", dtype=dtype, tol=tol,
                max_abs_err=max(errs[g] for g in gn), traced=traced,
                f64=f64))
        log(f"{what} (run at {dp}): err " + " ".join(
            f"{g} {e:.2e}" for g, e in errs.items()))


def layer_norm_cases():
    """(name, rows, D, dtype) of the layer-norm checks and A/Bs, each shape
    in f32 and bf16 (check_layer_norm runs each in f16 too). D = 768 at the main paths' row counts: GPT-2's generate (8
    rows), BERT's serving buckets 1, 8, 16 and 32 (128, 1024, 2048 and
    4096 rows; 4096 is also a GPT-2-base training step's 8 x 512 and a
    BERT pretraining step's 32 x 128) and the MLM head's 640 rows (32 x
    20 masked positions). Then
    wider rows at 4096: D = 1024 and 2048 (4 and 8 vectors a lane in bf16;
    at 2048 gamma and beta are staged in shared memory, and f32 rows that
    wide take the block kernel), D = 1000 (the last vector of a row falls
    on some lanes only) and D = 1001, a width of no whole 16-byte vectors,
    which takes the block kernel."""
    shapes = [("rows8", 8, 768), ("rows128", 128, 768),
              ("rows640", 640, 768),
              ("rows1024", 1024, 768), ("rows2048", 2048, 768),
              ("rows4096", 4096, 768), ("rows4096_d1024", 4096, 1024),
              ("rows4096_d2048", 4096, 2048),
              ("rows4096_d1000", 4096, 1000),
              ("rows4096_d1001", 4096, 1001)]
    return [(name, rows, d, dtype) for name, rows, d in shapes
            for dtype in ("float32", "bfloat16")]


def check_layer_norm(records):
    """The layer-norm kernel against its plain version at every case of
    layer_norm_cases() and at each of its shapes in f16, f32 within 1e-5
    and bf16 and f16 within 2e-2, at
    BERT's eps (1e-12) and GPT-2's (1e-5), with gamma and beta in f32, bf16
    and f16; two calls compared bit for bit in each. With eps 1e-12 and
    gamma and beta in x's dtype (the main paths': f32 parameters on the f32
    paths, bf16 ones under amp and compute_dtype="bfloat16", f16 ones in a
    module cast to f16) it is timed against its bound and F.layer_norm, and
    a bf16 or f16 ops.layer_norm call, as the models make it, must launch
    one kernel, the layer norm's: no cast of gamma or beta."""
    import torch
    from incubator_mxnet_tpu_torch import ops
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = layer_norm_cases()
    for case, rows, d, dtype in cases + [
            (c, r, d, "float16") for c, r, d, dt in cases if dt == "bfloat16"]:
        tol = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}[dtype]
        x = (torch.randn(rows, d, generator=gen, device="cuda") * 2
             + 0.5).to(getattr(torch, dtype))
        g32 = torch.randn(d, generator=gen, device="cuda")
        b32 = torch.randn(d, generator=gen, device="cuda")
        errs = {}
        for eps in (1e-12, 1e-5):
            for pdtype in ("float32", "bfloat16", "float16"):
                g, b = (t.to(getattr(torch, pdtype)) for t in (g32, b32))
                y = ln.layer_norm_fwd(x, g, b, eps)
                again = ln.layer_norm_fwd(x, g, b, eps)
                torch.cuda.synchronize()
                ref = ln.layer_norm_ref(x, g, b, eps)
                err = max_err(y, ref)
                what = (f"layer_norm {case} eps {eps} {dtype} gamma and "
                        f"beta {pdtype}")
                check(torch.allclose(y.float(), ref.float(), rtol=tol,
                                     atol=tol),
                      f"{what}: max |y - plain| {err} over tolerance {tol}")
                # a row is one warp's, summed in a fixed order
                check(torch.equal(y, again),
                      f"{what}: two calls gave different bits")
                errs[f"{eps:.0e} {pdtype}"] = err
                rec = dict(kernel="layer_norm_fwd", case=case,
                           shape=[rows, d], eps=eps, dtype=dtype,
                           param_dtype=pdtype, tol=tol, max_abs_err=err)
                if eps == 1e-12 and pdtype == dtype:
                    _time_layer_norm(rec, ln, x, g, b, eps)
                    if dtype != "float32":
                        with torch.inference_mode():
                            _, per = device_ms(lambda: ops.layer_norm(
                                x, g, b, eps=eps))
                        check([_kernel_kind(n) for n in per]
                              == ["layer_norm"],
                              f"a {dtype} ops.layer_norm call at {case} "
                              f"launched {sorted(per)}, not one layer-norm "
                              f"kernel")
                        rec["ops_call_kernels"] = sorted(per)
                    log(f"layer_norm {case:15s} {dtype:8s} err {err:.2e} "
                        + fmt_times(rec))
                records.append(rec)
        log(f"layer_norm {case:15s} {dtype:8s} max |y - plain| by eps and "
            f"gamma/beta dtype {errs}; two calls bit-identical")


def _time_layer_norm(rec, ln, x, g, b, eps):
    """Times of the kernel, its plain version and F.layer_norm on (x, g,
    b), and the bound, into `rec`."""
    import torch
    import torch.nn.functional as F
    rows, d = x.shape
    rec.update(measure(
        lambda: ln.layer_norm_fwd(x, g, b, eps),
        lambda: ln.layer_norm_ref(x, g, b, eps),
        lambda: F.layer_norm(x, (d,), g, b, eps)))
    nbytes = 2 * rows * d * x.element_size() + 2 * d * g.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(8.0 * rows * d, nbytes,
                                             rec["dtype"])
    with torch.inference_mode():
        rec["function_wall_ms"] = time_ms(
            lambda: ln.layer_norm(x, g, b, eps))


def ssa_cases():
    """(name, rows, C): ResNet-50's BatchNormReLU inputs in training at
    batch 128 and 224 x 224 (the stem, then one per stage), and shapes the
    vector path cannot take (C = 3, C = 70)."""
    return [("stem_b128", 128 * 112 * 112, 64),
            ("stage1_b128", 128 * 56 * 56, 64),
            ("stage2_b128", 128 * 28 * 28, 128),
            ("stage3_b128", 128 * 14 * 14, 256),
            ("stage4_b128", 128 * 7 * 7, 512),
            ("unaligned_c3", 100, 3),
            ("unaligned_c70", 1000, 70)]


# launches of each training shape in one ResNet-50 step (the stem, then
# two BatchNormReLUs in each block of [3, 4, 6, 3])
SSA_PER_STEP = {"stem_b128": 1, "stage1_b128": 6, "stage2_b128": 8,
                "stage3_b128": 12, "stage4_b128": 6}


def check_scale_shift_act(records):
    """The scale/shift/act kernel against its plain version at every case,
    act and dtype, and a case whose pointer is not 16-byte aligned; the
    training shapes with relu timed against the bound (bytes), the plain
    version and torch.addcmul + relu_."""
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    gen = torch.Generator(device="cuda").manual_seed(4)
    # f32: the kernel rounds the product and the sum separately, as the
    # plain version's two operations do; bf16 and f16: the f32 result
    # rounds once
    tols = {"float32": 1e-6, "bfloat16": 1e-2, "float16": 1e-2}
    for name, rows, c in ssa_cases():
        for dtype, tol in tols.items():
            tdt = getattr(torch, dtype)
            x = (2.0 * torch.randn(rows, c, generator=gen, device="cuda")
                 + 0.5).to(tdt)
            s = torch.rand(c, generator=gen, device="cuda") + 0.5
            b = torch.randn(c, generator=gen, device="cuda")
            for act in ("relu", "relu6", None):
                y = cbr.scale_shift_act_fwd(x, s, b, act)
                torch.cuda.synchronize()
                ref = cbr.scale_shift_act_ref(x, s, b, act)
                err = max_err(y, ref)
                check(torch.allclose(y.float(), ref.float(), rtol=tol,
                                     atol=tol),
                      f"scale_shift_act {name} {dtype} {act}: max |y - "
                      f"plain| {err} over tolerance {tol}")
                rec = dict(kernel="scale_shift_act", case=name,
                           shape=[rows, c], act=act, dtype=dtype, tol=tol,
                           max_abs_err=err)
                if act == "relu" and name in SSA_PER_STEP:
                    sl, bl = s.to(tdt), b.to(tdt)
                    rec.update(measure(
                        lambda: cbr.scale_shift_act_fwd(x, s, b, "relu"),
                        lambda: cbr.scale_shift_act_ref(x, s, b, "relu"),
                        lambda: torch.addcmul(bl, x, sl).relu_()))
                    nbytes = 2 * rows * c * x.element_size() + 2 * c * 4
                    rec["bound_ms"], rec["bound_by"] = bound(
                        3.0 * rows * c, nbytes, dtype)
                    rec["library"] = "torch.addcmul(shift, x, scale).relu_()"
                    log(f"scale_shift_act {name:13s} {dtype:8s} err "
                        f"{err:.2e} " + fmt_times(rec))
                records.append(rec)
        log(f"scale_shift_act {name:13s} ({rows} x {c}): relu, relu6, none "
            f"in f32, bf16 and f16 agree with the plain version")
    # a pointer 4 bytes past 16-byte alignment: the one-element path
    for dtype, tol in tols.items():
        buf = torch.randn(257 * 64 + 1, generator=gen, device="cuda").to(
            getattr(torch, dtype))
        x = buf[1:].view(257, 64)
        s = torch.rand(64, generator=gen, device="cuda") + 0.5
        b = torch.randn(64, generator=gen, device="cuda")
        err = max_err(cbr.scale_shift_act_fwd(x, s, b, "relu6"),
                      cbr.scale_shift_act_ref(x, s, b, "relu6"))
        check(err <= tol, f"scale_shift_act unaligned pointer {dtype}: "
                          f"{err}")
        records.append(dict(kernel="scale_shift_act",
                            case="unaligned_pointer", shape=[257, 64],
                            act="relu6", dtype=dtype, tol=tol,
                            max_abs_err=err))
    log("scale_shift_act unaligned pointer: agrees in f32, bf16 and f16")


def mm_cases():
    """(name, M, K, N, act, launches per forward, bucket): every distinct
    1x1/stride-1 conv of ResNet-50 at bucket 32 and 224 x 224 (M = 32 x H x
    W pixels, K in, N out channels), stage 3's and 4's first conv at bucket
    4 (the smoke's average batch, where the plan splits K), one of no
    aligned dimension (the SIMT route in bf16 too) and one whose K is a
    multiple of 8 but not of the wgmma kernel's 64."""
    return [("s1_conv1_first", 32 * 56 * 56, 64, 64, "relu", 1, 32),
            ("s1_conv3_ds", 32 * 56 * 56, 64, 256, None, 4, 32),
            ("s1_conv1", 32 * 56 * 56, 256, 64, "relu", 2, 32),
            ("s2_conv3", 32 * 28 * 28, 128, 512, None, 4, 32),
            ("s2_conv1", 32 * 28 * 28, 512, 128, "relu", 3, 32),
            ("s3_conv3", 32 * 14 * 14, 256, 1024, None, 6, 32),
            ("s3_conv1", 32 * 14 * 14, 1024, 256, "relu", 5, 32),
            ("s4_conv3", 32 * 7 * 7, 512, 2048, None, 3, 32),
            ("s4_conv1", 32 * 7 * 7, 2048, 512, "relu", 2, 32),
            ("s3_conv1_b4", 4 * 14 * 14, 1024, 256, "relu", 5, 4),
            ("s4_conv1_b4", 4 * 7 * 7, 2048, 512, "relu", 2, 4),
            ("unaligned_100x70x30", 100, 70, 30, "relu6", 0, 0),
            ("k72_100x72x40", 100, 72, 40, "relu", 0, 0)]


def mm_inputs(m, k, n, dtype, gen):
    import torch
    tdt = getattr(torch, dtype)
    x = torch.randn(m, k, generator=gen, device="cuda").to(tdt)
    w = (torch.randn(k, n, generator=gen, device="cuda")
         / math.sqrt(k)).to(tdt)
    s = torch.rand(n, generator=gen, device="cuda") + 0.5
    b = torch.randn(n, generator=gen, device="cuda")
    return x, w, s, b


def plan_name(plan):
    (bm, bn), split = plan
    return f"{bm}x{bn}/{split}"


# f32: sums of K products in another order than cuBLAS's; bf16 and f16:
# the f32 sums round once to the type on both sides, one unit apart at most
MM_TOLS = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}


# the launch counter of each GEMM route
ROUTE_COUNT = {"simt": "mm_epilogue", "wgmma": "mm_wgmma"}


def gemm_launches(before, after):
    """GEMM launches between two kernel_counts() readings, by route."""
    return {r: after[c][0] - before[c][0] for r, c in ROUTE_COUNT.items()}


def check_mm_epilogue(records):
    """The fused 1x1-conv GEMM against its plain version (TF32 off) at
    every case in f32, bf16 and f16, under mm_plan's plan and on mm_route's
    route (bf16 and f16 at every ResNet shape: the wgmma kernel; the
    unaligned case: the SIMT kernel); two calls must give the same bits.
    The per-forward shapes are timed against their bound (operations in
    f32, bytes in bf16 and f16), the plain version and
    torch._addmm_activation(shift, x, w * scale) (torch.addmm where there
    is no activation); in bf16 and f16 the SIMT kernel is held and timed
    there too, forced through its route under its own plan, so that the
    two kernels stand side by side."""
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, m, k, n, act, per_fwd, bucket in mm_cases():
        for dtype, tol in MM_TOLS.items():
            tdt = getattr(torch, dtype)
            x, w, s, b = mm_inputs(m, k, n, dtype, gen)
            route, plan = cbr._route_plan(x, w)
            check(route == ("wgmma" if dtype in HALF_TYPES and k % 8 == 0
                            and n % 8 == 0 else "simt"),
                  f"mm_epilogue {name} {dtype}: route {route}")
            acts = (act,) if per_fwd else ("relu", "relu6", None)
            for a in acts:
                before = kernel_counts()
                y = cbr.mm_epilogue(x, w, s, b, a)
                again = cbr.mm_epilogue(x, w, s, b, a)
                torch.cuda.synchronize()
                launched = gemm_launches(before, kernel_counts())
                check(launched == {r: 2 * (r == route) for r in launched},
                      f"mm_epilogue {name} {dtype}: launched {launched} "
                      f"on route {route}")
                check(torch.equal(y, again),
                      f"mm_epilogue {name} {dtype} {a}: two calls differ")
                ref = cbr.mm_epilogue_ref(x, w, s, b, a)
                err = max_err(y, ref)
                check(torch.allclose(y.float(), ref.float(), rtol=tol,
                                     atol=tol),
                      f"mm_epilogue {name} {dtype} {a}: max |y - plain| "
                      f"{err} over tolerance {tol}")
            rec = dict(kernel=("mm_epilogue_wgmma" if route == "wgmma"
                               else "mm_epilogue"),
                       case=name, shape=[m, k, n], act=act, dtype=dtype,
                       tol=tol, max_abs_err=err, per_forward=per_fwd,
                       bucket=bucket, route=route, plan=plan_name(plan),
                       bit_identical=True)
            if per_fwd:
                ws, bl = (w.float() * s).to(tdt), b.to(tdt)
                lib = ((lambda: torch._addmm_activation(bl, x, ws))
                       if act == "relu" else (lambda: torch.addmm(bl, x, ws)))
                rec.update(measure(
                    lambda: cbr.mm_epilogue(x, w, s, b, act),
                    lambda: cbr.mm_epilogue_ref(x, w, s, b, act), lib))
                elt = x.element_size()
                nbytes = (m * k + k * n + m * n) * elt + 2 * n * 4
                rec["flops"] = 2.0 * m * n * k
                rec["bound_ms"], rec["bound_by"] = bound(rec["flops"],
                                                         nbytes, dtype)
                rec["tflops"] = rec["flops"] / rec["kernel_ms"] / 1e9
                rec["library"] = ("torch._addmm_activation(shift, x, w * "
                                  "scale)" if act == "relu" else
                                  "torch.addmm(shift, x, w * scale)")
                if route == "wgmma":
                    rec.update(simt_beside(cbr, x, w, s, b, act, tol,
                                           f"{name} {dtype}"))
                log(f"mm_epilogue {name:19s} {dtype:8s} {route:5s} "
                    f"{rec['plan']:11s} err {err:.2e} {rec['tflops']:.1f} "
                    f"TFLOP/s " + fmt_times(rec)
                    + (f" simt_ms {rec['simt_ms']:.4f} ({rec['simt_plan']})"
                       if "simt_ms" in rec else ""))
            else:
                log(f"mm_epilogue {name} {dtype} {route} {rec['plan']}: "
                    f"relu, relu6, none agree with the plain version (err "
                    f"{err:.2e}), two calls bit-identical")
            records.append(rec)


def simt_beside(cbr, x, w, s, b, act, tol, what):
    """The SIMT kernel at a shape the wgmma kernel takes: forced through
    its route under its own plan, held against the plain version (and
    twice for the same bits) and timed, as "simt_*" fields."""
    import torch
    m, k = x.shape
    plan = cbr._simt_plan(m, w.shape[1], k, x.dtype)

    def simt():
        return cbr._mm_epilogue_with_plan(x, w, s, b, act, plan,
                                          route="simt")
    before = kernel_counts()
    y, again = simt(), simt()
    torch.cuda.synchronize()
    launched = gemm_launches(before, kernel_counts())
    check(launched == {"simt": 2, "wgmma": 0},
          f"mm_epilogue {what} forced simt: launched {launched}")
    check(torch.equal(y, again), f"mm_epilogue {what} simt: two calls "
                                 f"differ")
    err = max_err(y, cbr.mm_epilogue_ref(x, w, s, b, act))
    check(err <= tol, f"mm_epilogue {what} simt: max |y - plain| {err} over "
                      f"tolerance {tol}")
    ms, per = device_ms(simt)
    return {"simt_plan": plan_name(plan), "simt_max_abs_err": err,
            "simt_ms": ms, "simt_wall_ms": time_ms(simt),
            "simt_timer": "stream" if STREAM_KEY in per else "profiler"}


def check_mm_plans(records):
    """A split of 1, 2 and 4 forced onto each of the route's tiles (the
    SIMT kernel's one, the wgmma kernel's two) at a shape of no aligned
    dimension (the SIMT kernel in both dtypes), a small aligned one (N =
    96: a column tail in either wgmma tile), one with K a multiple of 8
    but not of 64 (N = 40: the 128-wide tile's second column box lies
    wholly past N) and stage 4's first conv at bucket 32 (an M tail of 32
    rows), in f32, bf16 and f16 and for each act, against the plain
    version, each twice for the same bits; then the reduce kernel alone against its
    plain version (f32 sums in the same order: equal bits expected), timed
    at s4_conv1_b4's plan. The first two shapes' outputs stay under 4 and
    are held within the tolerance absolutely; the last two, with values
    past 4 (K = 2048), where one bf16 unit is 0.031, by check_mm_epilogue's
    rule: within the tolerance of the value's size (rtol = atol)."""
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    gen = torch.Generator(device="cuda").manual_seed(6)
    for name, m, k, n, relative in (
            ("unaligned_100x70x30", 100, 70, 30, False),
            ("small_300x256x96", 300, 256, 96, False),
            ("k72_100x72x40", 100, 72, 40, True),
            ("s4_conv1_1568x2048x512", 1568, 2048, 512, True)):
        for dtype, tol in MM_TOLS.items():
            x, w, s, b = mm_inputs(m, k, n, dtype, gen)
            route, _ = cbr._route_plan(x, w)
            tiles = cbr.MM_WGMMA_TILES if route == "wgmma" else (cbr.MM_TILE,)
            worst = 0.0
            for tile, split in ((t, sp) for t in tiles for sp in (1, 2, 4)):
                plan = (tile, split)
                for a in ("relu", "relu6", None):
                    before = kernel_counts()
                    y = cbr._mm_epilogue_with_plan(x, w, s, b, a, plan)
                    again = cbr._mm_epilogue_with_plan(x, w, s, b, a, plan)
                    torch.cuda.synchronize()
                    launched = gemm_launches(before, kernel_counts())
                    check(launched[route] == 2 and sum(launched.values())
                          == 2, f"mm_epilogue {name} {dtype} plan "
                                f"{plan_name(plan)}: launched {launched}")
                    check(torch.equal(y, again),
                          f"mm_epilogue {name} {dtype} plan "
                          f"{plan_name(plan)} {a}: two calls differ")
                    ref = cbr.mm_epilogue_ref(x, w, s, b, a)
                    err = max_err(y, ref)
                    check(torch.allclose(y.float(), ref.float(), rtol=tol,
                                         atol=tol) if relative
                          else err <= tol,
                          f"mm_epilogue {name} {dtype} plan "
                          f"{plan_name(plan)} {a}: max |y - plain| "
                          f"{err} over tolerance {tol}")
                    worst = max(worst, err)
            records.append(dict(kernel=("mm_epilogue_wgmma" if route ==
                                        "wgmma" else "mm_epilogue"),
                                case=name + "_plans", shape=[m, k, n],
                                act=None, dtype=dtype, tol=tol,
                                max_abs_err=worst, route=route,
                                plans=f"{tiles} x split 1, 2, 4"))
            log(f"mm_epilogue {name} {dtype} {route} {tiles}: split 1, 2, "
                f"4 x relu, relu6, none within {tol} (worst {worst:.2e}), "
                f"bit-identical twice")
    # f32: the kernel and the plain version add the same f32 values in
    # the same order and round the epilogue's product and sum alike. The
    # bucket-4 cases take their plan's split, as serving gives it
    tols = {"float32": 1e-6, "bfloat16": 1e-2, "float16": 1e-2}
    for name, split, m, n in (
            ("s4_conv1_b4", cbr.mm_plan(196, 512, 2048, torch.float32)[1],
             196, 512),
            ("s3_conv1_b4", cbr.mm_plan(784, 256, 1024, torch.float32)[1],
             784, 256),
            ("unaligned_100x30", 3, 100, 30)):
        part = torch.randn(split, m, n, generator=gen, device="cuda")
        s = torch.rand(n, generator=gen, device="cuda") + 0.5
        b = torch.randn(n, generator=gen, device="cuda")
        for dtype, tol in tols.items():
            tdt = getattr(torch, dtype)
            for a in ("relu", "relu6", None):
                y = cbr.mm_splitk_reduce(part, s, b, a, tdt)
                torch.cuda.synchronize()
                err = max_err(y, cbr.mm_splitk_reduce_ref(part, s, b, a,
                                                          tdt))
                check(err <= tol, f"mm_splitk_reduce {name} {dtype} {a}: "
                                  f"{err} over tolerance {tol}")
            rec = dict(kernel="mm_splitk_reduce", case=name,
                       shape=[split, m, n], act="relu", dtype=dtype,
                       tol=tol, max_abs_err=err)
            if name == "s4_conv1_b4":
                rec.update(measure(
                    lambda: cbr.mm_splitk_reduce(part, s, b, "relu", tdt),
                    lambda: cbr.mm_splitk_reduce_ref(part, s, b, "relu",
                                                     tdt)))
                nbytes = (split * m * n * 4 + m * n * tdt.itemsize
                          + 2 * n * 4)
                rec["bound_ms"], rec["bound_by"] = bound(
                    (split + 2.0) * m * n, nbytes, dtype)
                log(f"mm_splitk_reduce {name} {dtype} err {err:.2e} "
                    + fmt_times(rec))
            records.append(rec)
        log(f"mm_splitk_reduce {name} ({split} x {m} x {n}): relu, relu6, "
            f"none in f32, bf16 and f16 agree with the plain version")


# ---------------------------------------------------------------------------
# the slice: BERT-base served over HTTP
# ---------------------------------------------------------------------------

N_CLIENTS, PER_CLIENT, SEQ = 16, 4, 128


def normal_arrays(net, seed=0, sigma=0.02):
    """Weights by the JAX package's Normal(0.02) name rules, from numpy:
    gamma ones, beta and every *bias (BERT's mlm_bias too) zeros,
    everything else normal(0, 0.02); the
    moving statistics (buffers) zeros for the mean, ones for the
    variance."""
    import numpy as np
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in net.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(p.shape)
        if leaf == "gamma":
            arrays[name] = np.ones(shape, np.float32)
        elif leaf == "beta" or leaf.endswith("bias"):
            arrays[name] = np.zeros(shape, np.float32)
        else:
            arrays[name] = rng.normal(0.0, sigma, shape).astype(np.float32)
    for name, b in net.named_buffers():
        fill = np.ones if name.endswith("running_var") else np.zeros
        arrays[name] = fill(tuple(b.shape), np.float32)
    return arrays


def kernel_counts():
    """(launches, plain calls) of every kernel's wrapper; a CUDA graph's
    replay counts the launches its capture made."""
    from incubator_mxnet_tpu_torch.ops.cuda import launch_counts
    return launch_counts()


def reset_kernel_counts():
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
    fa.reset_counts()
    ln.reset_counts()
    cbr.reset_counts()


def rejections():
    """Selection decisions that turned a call away from its kernel, by
    kernel (``ops/kernel.rejected.*`` counters since the last reset)."""
    from incubator_mxnet_tpu_torch import profiler
    return {k.rsplit(".", 1)[1]: v for k, v in profiler.counters().items()
            if k.startswith("ops/kernel.rejected.") and v}


@contextlib.contextmanager
def all_plain():
    """The models' attention, layer norm, scale/shift/act and fused conv
    through the plain versions (differentiable by autograd), with no kernel
    launched: the reference the kernels' path is held against on the
    card."""
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln

    def plain_fa(q, k, v, causal=False, scale=None, kv_len=None):
        return fa.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                      kv_len=kv_len)[0]

    def plain_cbr(x, weight, gamma, beta, mean, var, eps=1e-5,
                  stride=(1, 1), pad=(0, 0), act="relu"):
        scale, shift = cbr.fold_bn(gamma, beta, mean, var, eps)
        return cbr.conv_bn_ref(x, weight, scale, shift, stride, pad, act)

    before = kernel_counts()
    with mock.patch.object(fa, "flash_attention", plain_fa), \
            mock.patch.object(ln, "layer_norm", ln.layer_norm_ref), \
            mock.patch.object(cbr, "scale_shift_act",
                              cbr.scale_shift_act_ref), \
            mock.patch.object(cbr, "conv_bn_relu", plain_cbr):
        yield
    check(kernel_counts() == before, "the all-plain run launched a kernel")


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


# the flash kernels' forms, as their names carry them ("wide_": an FMA
# kernel above head dim 256, which none is now: hold_routes fails on one)
FLASH_FORMS = ("", "wgmma_", "tf32x3_", "wide_", "wide_wgmma_",
               "wide_tf32x3_")


def _kernel_kind(name):
    for kind, count in (("flash_attention", "flash_fwd"),
                        ("flash_bwd_dq", "flash_bwd_dq"),
                        ("flash_bwd_dkv", "flash_bwd_dkv")):
        if any(f"{count}_{form}kernel" in name for form in FLASH_FORMS):
            return kind
    if "ln_rows_kernel" in name or "ln_block_kernel" in name:
        return "layer_norm"
    if "ssa_kernel" in name:
        return "scale_shift_act"
    if "mm_epilogue_kernel" in name:
        return "mm_epilogue"
    if "mm_wgmma_kernel" in name:
        return "mm_wgmma"
    if "mm_splitk_reduce_kernel" in name:
        return "mm_splitk_reduce"
    low = name.lower()
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad",
                              "implicit")):
        return "conv"
    if any(s in low for s in ("gemm", "sm90", "cutlass", "cublas", "xmma",
                              "nvjet")):
        return "matmul"
    if "reduce_kernel" in low:
        return "reductions"
    return "other"


# a GEMM or conv kernel whose name carries one of these computes in bf16:
# cuDNN's and CUTLASS's "bf16", the template type "__nv_bfloat16" or
# "BFloat16", and cuBLAS's nvjet kernels, whose first letter after
# "nvjet_" is the inputs' type ("t" bf16, "h" f16, "s" f32); in f16, once
# every "bf16" is taken out of the name: cuDNN's and CUTLASS's "f16" or
# "fp16", the type "__half" or "Half", and nvjet's "h"
HALF_MARKS = {"bfloat16": ("bf16", "bfloat16", "nvjet_t"),
              "float16": ("f16", "fp16", "half", "nvjet_h")}
# helpers that cuDNN launches beside a conv and that compute no product:
# init_device_workspace_kernel zero-fills a split-K conv's workspace
NOT_PRODUCTS = ("init_device_workspace",)


def _in_half(name, dtype):
    """Whether a GEMM or conv kernel's name marks it as computing in the
    16-bit `dtype` (HALF_MARKS)."""
    low = name.lower()
    if dtype == "float16":
        low = low.replace("bf16", "").replace("bfloat16", "")
    return any(m in low for m in HALF_MARKS[dtype])


def flash_names(names):
    """The flash kernels among a trace's kernel names, by count key."""
    return {key: [n[:120] for n in names if _kernel_kind(n) == kind]
            for key, kind in (("flash_fwd", "flash_attention"),
                              ("flash_bwd_dq", "flash_bwd_dq"),
                              ("flash_bwd_dkv", "flash_bwd_dkv"))}


def half_only(names, what, dtype="bfloat16"):
    """In a bf16 or f16 phase, from the kernel names of a whole profiler
    trace: every kernel of ours is its instance of `dtype` (the template
    type is in the name), and every GEMM or conv kernel computes in
    `dtype`. Returns the counts and the names that broke either rule."""
    if STREAM_KEY in names:
        expect(False, f"{what}: no whole profiler trace to read the kernel "
                      f"names from")
        return {"checked": False}
    ours = [n for n in names if _kernel_kind(n) in _COUNT_KIND.values()]
    gemm = [n for n in names if _kernel_kind(n) in ("matmul", "conv")
            and not any(h in n for h in NOT_PRODUCTS)]
    wrong = ([n for n in ours if f"<{HALF_TYPES[dtype]}" not in n]
             + [n for n in gemm if not _in_half(n, dtype)])
    expect(ours and not wrong,
           f"{what}: kernels not in {dtype} (or none of ours traced): "
           f"{[n[:90] for n in wrong]}")
    flash = flash_names(ours)
    return {"checked": True, "dtype": dtype, "ours": len(ours),
            "gemm_or_conv": len(gemm),
            "not_" + dtype: [n[:120] for n in wrong], **flash}


def wgmma_forward_traced(check_result, what):
    """A 16-bit attention path's trace (``half_only``'s result) holds the
    wgmma flash forward, and no other forward (no SIMT one): with the
    launch count checks (12 a forward or step, each traced launch matched
    to a counted one by ``_short``) every forward launch of the path was
    the wgmma kernel."""
    fwd = check_result.get("flash_fwd") or []
    expect(check_result.get("checked") and fwd and all(
        "flash_fwd_wgmma_kernel" in n for n in fwd),
        f"{what}: no wgmma flash forward in the trace ({fwd})")
    return fwd


def flash_backward_traced(check_result, what, d=64,
                          kinds=("flash_bwd_dq", "flash_bwd_dkv")):
    """A training step's trace (``half_only``'s result in 16 bits, or
    ``_breakdown``'s "flash_check") holds the dQ and dK/dV kernels (and
    with `kinds` the forward's too) of head dim `d` that
    ``flash_kernel_name`` gives for its dtype (16 bits: the wgmma ones;
    f32: the FMA ones, at 256 the split-TF32 ones), and no other: with
    the launch count checks (one of each a layer and step, each traced
    launch matched to a counted one by ``_short``) every launch of those
    kinds in the step was that kernel. Returns {kind: kernel names}."""
    got = {}
    for kind in kinds:
        names = check_result.get(kind) or []
        want = flash_kernel_name(
            kind, check_result.get("dtype", "bfloat16"), d)
        expect(check_result.get("checked") and names and all(
            want in n for n in names),
            f"{what}: {kind} kernels in the trace {names}, not {want}")
        got[kind] = names
    return got


def _by_kind(per):
    """{kernel name: ms} summed by kind of kernel."""
    kinds = {}
    for name, ms in per.items():
        kinds[_kernel_kind(name)] = kinds.get(_kernel_kind(name), 0.0) + ms
    return kinds


def _breakdown(fn, half_what=None, dtype="bfloat16"):
    """Where one call of `fn` spends the card's time: profiler device time
    by kind of kernel, against the stream time of the same call (events);
    their difference is the card's idle share. With `half_what` (a bf16 or
    f16 phase's label) the trace's kernels are also held to
    :func:`half_only` for `dtype`. "flash_check" lists the trace's flash
    kernels by kind, for :func:`flash_backward_traced`."""
    total, per = device_ms(fn, iters=5)
    wall = time_ms(fn, iters=5)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    out = {"stream_ms": wall, "device_ms": total,
           "idle_share": 1.0 - total / wall if wall > 0 else None,
           "timer": "stream" if STREAM_KEY in per else "profiler",
           "by_kind_ms": _by_kind(per),
           "top_kernels_ms": [[n[:80], ms] for n, ms in top],
           "flash_check": dict(flash_names(per),
                               checked=STREAM_KEY not in per, dtype=dtype)}
    if half_what:
        out["half_check"] = half_only(sorted(per), half_what, dtype)
    return out


def forward_breakdown(fm, ids, b, half_what=None, dtype="bfloat16"):
    """One forward of bucket `b` as served (a replay of the bucket's CUDA
    graph, its upload included) and, labelled "eager", the frozen module's
    forward run op by op on the same input. device_ms holds a replay's
    trace to our kernels' launches as the replay credited them; where
    every trace of the replays came back short, the replay's numbers are
    its stream time and the eager forward's trace is the one that splits
    the time by kernel. With `half_what` the replay's kernels are held to
    :func:`half_only` for `dtype`."""
    x = ids[:b]
    out = {"replay": _breakdown(
        lambda: fm.run_raw(x),
        half_what and f"{half_what} bucket {b} replay", dtype),
        "eager": _breakdown(lambda: fm.run_eager(x))}
    if out["replay"]["timer"] == "stream":
        log(f"forward_breakdown: no whole profiler trace of a bucket-{b} "
            f"replay; its kernels are split from the eager forward's trace")
    return out


def plain_by_batch(fm, x_all, batches):
    """The frozen module's all-plain eager forward (no kernel) of each
    served batch (`batches`: lists of request indices), padded to the
    bucket it was served at, so that every library call runs at the shape
    the served replay ran it: {request index: [its outputs]}. The bf16
    phases hold their answers against it (in bf16 a GEMM of another M may
    sum in another order and round differently)."""
    import numpy as np
    out = {}
    with all_plain():
        for order in batches:
            x = x_all[order]
            pad = fm.bucket_for(len(order)) - len(order)
            if pad:
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:],
                                                x.dtype)])
            outs = [o.cpu().numpy() for o in fm.run_eager(x)]
            for row, i in enumerate(order):
                out[i] = [o[row] for o in outs]
    return out


def check_replays(fm, x_all, what):
    """Every bucket's replay against the frozen module's eager forward on
    the same input: each output within 1e-6 of its largest value. Returns
    (the worst error over that largest value, whether every output was
    bit-identical)."""
    import numpy as np
    worst, identical = 0.0, True
    for b in fm.buckets:
        x = x_all[:b]
        got = fm.predict_batch(x)
        want = [o.cpu().numpy() for o in fm.run_eager(x)]
        for g, w in zip(got, want):
            scale = float(np.abs(w).max())
            err = float(np.abs(g - w).max())
            check(np.isfinite(g).all() and err <= 1e-6 * scale,
                  f"{what}: bucket {b}'s replay vs its eager forward {err} "
                  f"(largest {scale})")
            worst = max(worst, err / max(scale, 1e-30))
            identical = identical and np.array_equal(g, w)
    log(f"{what}: every bucket's replay vs its eager forward: worst "
        f"{worst:.2e} of the largest output, "
        f"{'bit-identical' if identical else 'not bit-identical'}")
    return worst, identical


def graph_counts(fm):
    """(serving.compiles, serving.compiled_buckets), each checked to be
    one graph a bucket."""
    from incubator_mxnet_tpu_torch import profiler
    c = profiler.counters()
    got = (c.get("serving/serving.compiles"),
           c.get("serving/serving.compiled_buckets"))
    n = len(fm.buckets)
    check(got == (n, n), f"serving.compiles, serving.compiled_buckets "
                         f"{got} != one graph for each of {n} buckets")
    return got


def exec_ms_by_bucket(fm, x_all, what):
    """Median ``exec_ms`` of five direct predict_batch calls a bucket."""
    out = {}
    for b in fm.buckets:
        samples = []
        for _ in range(5):
            t = {}
            fm.predict_batch(x_all[:b], timings=t)
            samples.append(t["exec_ms"])
        out[b] = sorted(samples)[len(samples) // 2]
    log(f"{what}: exec_ms by bucket " + ", ".join(
        f"{b}: {ms:.3f}" for b, ms in out.items()))
    return out


def batcher_clients(batcher, xs, n_threads, per_thread):
    """`n_threads` threads, in process, each submit `per_thread` samples of
    `xs` to the started `batcher` (thread c the samples c * per_thread +
    j) and wait for each answer; the batcher is stopped after. Returns
    (results, errors, seconds): results[i] is (the answer's outputs, its
    batch_id, batch_index and batch_size, its latency in ms)."""
    results = [None] * (n_threads * per_thread)
    errors = []

    def client(c):
        try:
            for j in range(per_thread):
                i = c * per_thread + j
                t = time.perf_counter()
                req = batcher.submit(xs[i])
                out = req.wait(600)
                results[i] = (out, req.batch_id, req.batch_index,
                              req.batch_size,
                              (time.perf_counter() - t) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        seconds = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "clients hung")
    finally:
        batcher.stop()
    return results, errors, seconds


# bf16 against all-plain bf16 (and the card's kernels against the plain
# versions): 2e-2 of the largest value, as the bf16 kernel checks hold
BF16_TOL = 2e-2
# BERT's served answers against all-plain bf16: the flash and layer-norm
# kernels round their bf16 outputs from f32 sums taken in other orders
# than the plain versions', one unit apart in some elements, and twelve
# layers carry that on. Two runs measured 9.375e-2 at a largest value of
# 4.97: three bf16 units at that magnitude, just under 2e-2 of it; this
# allows six
BERT_BF16_TOL = 4e-2
# bf16 answers against the f32 path's, same weights: the Frobenius norm of
# the difference within this share of the f32 answers' (bf16 keeps 8
# significant bits and every layer carries a rounding on). Measured 1.30%
# (BERT, four runs) and 1.04%, 3.09%, 2.67%, 1.30% and 4.52% (ResNet-50
# while its 30 f32 steps ran cuDNN's default weight gradients, whose sums
# change order from run to run: its largest predict logit was 9.8 in one
# run and 307 in the next). With deterministic cuDNN in that phase the
# served network is the same in every run: 1.24% in two runs
BF16_VS_F32 = 0.05
# the zoo resnet50_v1 in bf16 against the network's bf16 predict logits,
# same weights, by norm: the zoo's BatchNorm rounds its affine in bf16
# four times a value (x - mean among them, which loses the bits x shares
# with a moving mean that is large against the standard deviation), the
# fused epilogue once in f32. While the network was trained anew in each run
# it measured from 1.84% to 3.59%, and once 5.006%; with deterministic
# cuDNN in the f32 training phase it is the same in every run: 1.92% in
# two runs
ZOO_BF16_NORM = 0.05


def rel_norm(a, b):
    """||a - b|| / ||b|| (Frobenius), in f64 on the host."""
    import numpy as np
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def serve_bert(detail, dtype="float32", ref=None):
    """BERT-base frozen and served over HTTP. In bf16 the same f32 weights
    are frozen with ``compute_dtype="bfloat16"`` (int32 ids pass uncast,
    answers come back in float32). `ref`: a dict that the f32 phase fills
    with its served answers and the bf16 phase holds its answers against.
    Returns the summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models.bert import get_bert_model
    from incubator_mxnet_tpu_torch.serving import FrozenModel, ModelServer

    bf16 = dtype == "bfloat16"
    what = "serving bf16" if bf16 else "serving"
    t0 = time.perf_counter()
    net = get_bert_model("bert_12_768_12", vocab_size=30522, max_length=512,
                         use_pooler=True, ctx=gpu(0))
    load_jax_params(net, normal_arrays(net, seed=0))
    log(f"bert_12_768_12 built on {next(net.parameters()).device} with "
        f"{sum(p.numel() for p in net.parameters())} parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = np.random.RandomState(1).randint(
        0, 30522, (N_CLIENTS * PER_CLIENT, SEQ)).astype(np.int32)

    # --- the main path: counts at zero just before, read just after ---
    reset_kernel_counts()
    profiler.reset_counters()
    t_freeze = time.perf_counter()
    fm = FrozenModel(net, input_shape=(SEQ,), dtype="int32",
                     compute_dtype=dtype)
    freeze_s = time.perf_counter() - t_freeze
    srv = ModelServer(fm, max_delay_ms=5.0, queue_limit=256,
                      default_timeout_ms=60000.0)
    host, port = srv.start()
    url = f"http://{host}:{port}"
    results = [None] * len(ids)
    errors = []

    def client(c):
        try:
            for j in range(PER_CLIENT):
                i = c * PER_CLIENT + j
                t = time.perf_counter()
                code, doc = post(url + "/predict", {"data": ids[i].tolist()})
                results[i] = (code, doc, (time.perf_counter() - t) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        t_serve = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        serve_s = time.perf_counter() - t_serve
        check(not any(t.is_alive() for t in threads), "clients hung")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = (r.status, json.loads(r.read())["status"])
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.stop()
    every = kernel_counts()
    counts = {"flash": every["flash_fwd"], "layer_norm": every["layer_norm"]}
    executed = profiler.counters()["serving/serving.executed_batches"]
    compiles, compiled = graph_counts(fm)
    # --- end of the main path ---

    check(not errors, f"client errors: {errors}")
    check(health == (200, "ok"), f"/healthz answered {health}")
    codes = [r[0] for r in results]
    check(codes == [200] * len(ids), f"status codes {codes}")
    batches = stats["serving.batches"]
    warmups = stats["serving.warmup_runs"]
    check(executed == warmups + batches == len(fm.buckets) + batches,
          f"executed {executed} != {warmups} warm-ups + {batches} batches")
    # a bucket's eager forward before its capture launches the kernels;
    # every replay (warm-up or batch) credits the captured launches
    forwards = compiles + executed
    check(counts["flash"] == (12 * forwards, 0),
          f"{what}: flash launches {counts['flash']} != 12 x ({compiles} "
          f"pre-capture forwards + {executed} replays)")
    check(counts["layer_norm"] == (25 * forwards, 0),
          f"{what}: layer_norm launches {counts['layer_norm']} != 25 x "
          f"({compiles} + {executed})")
    others = {k: v for k, v in every.items()
              if k not in ("flash_fwd", "layer_norm") and v != (0, 0)}
    check(not others, f"{what}: other kernels ran: {others}")
    log(f"{what}: {len(ids)} requests: {batches} batches + {warmups} "
        f"warm-ups as replays of {compiled} graphs, frozen in "
        f"{freeze_s:.2f} s; flash launches {counts['flash'][0]} "
        f"(12/forward), layer_norm launches {counts['layer_norm'][0]} "
        f"(25/forward) over {compiles} pre-capture forwards + {executed} "
        f"replays")

    served = []
    for code, doc, _ in results:
        seq, pooled = (np.asarray(o, np.float32) for o in doc["output"])
        check(seq.shape == (SEQ, 768) and pooled.shape == (768,),
              f"output shapes {seq.shape}, {pooled.shape}")
        check(np.isfinite(seq).all() and np.isfinite(pooled).all(),
              "non-finite output")
        served.append((seq, pooled))

    # every served row against a direct predict_batch of its batch
    by_batch = {}
    for i, (_, doc, _) in enumerate(results):
        by_batch.setdefault(doc["batch_id"], {})[doc["batch_index"]] = i
    err_direct, orders = 0.0, []
    for bid, members in by_batch.items():
        n = len(members)
        check(sorted(members) == list(range(n)) and all(
            results[i][1]["batch_size"] == n for i in members.values()),
            f"batch {bid} is not whole: {members}")
        order = [members[j] for j in range(n)]
        orders.append(order)
        seq_d, pooled_d = fm.predict_batch(ids[order])
        check(seq_d.dtype == pooled_d.dtype == np.float32,
              f"{what}: answers in {seq_d.dtype}, not float32")
        for row, i in enumerate(order):
            err_direct = max(err_direct,
                             float(np.abs(served[i][0] - seq_d[row]).max()),
                             float(np.abs(served[i][1] - pooled_d[row]).max()))
    check(err_direct <= 1e-4, f"served vs direct predict_batch {err_direct}")

    # every served row against an all-plain forward on the card: in bf16
    # the frozen module's eager forward (bf16 weights) of the same batch
    err_plain, largest = 0.0, 0.0
    if bf16:
        plain = plain_by_batch(fm, ids, orders)
        for i, (seq, pooled) in enumerate(served):
            seq_p, pooled_p = plain[i]
            largest = max(largest, float(np.abs(seq_p).max()),
                          float(np.abs(pooled_p).max()))
            err_plain = max(err_plain, float(np.abs(seq - seq_p).max()),
                            float(np.abs(pooled - pooled_p).max()))
    else:
        with all_plain(), torch.inference_mode():
            for s in range(0, len(ids), 32):
                seq_p, pooled_p = net(torch.from_numpy(ids[s:s + 32]).cuda())
                seq_p, pooled_p = seq_p.cpu().numpy(), pooled_p.cpu().numpy()
                for r in range(len(seq_p)):
                    err_plain = max(
                        err_plain,
                        float(np.abs(served[s + r][0] - seq_p[r]).max()),
                        float(np.abs(served[s + r][1] - pooled_p[r]).max()))
    vs_f32 = None
    if bf16:
        expect(err_plain <= BERT_BF16_TOL * largest,
               f"{what}: served vs all-plain bf16 {err_plain} (largest "
               f"{largest})")
        if ref is not None:
            vs_f32 = max(rel_norm(np.stack([a[k] for a in served]),
                                  np.stack([a[k] for a in ref["bert"]]))
                         for k in (0, 1))
            expect(vs_f32 <= BF16_VS_F32,
                   f"{what}: bf16 answers vs f32 answers {vs_f32} of their "
                   f"norm")
        # ids above 256 stay ids: 257 and 258 are not 256 and 256
        a, b = ids[:1].copy(), ids[:1].copy()
        a[0, :2], b[0, :2] = (257, 258), (256, 256)
        apart = float(np.abs(fm.predict_batch(a)[0][0, :2]
                             - fm.predict_batch(b)[0][0, :2]).max())
        expect(apart > 1e-3, f"{what}: ids 257, 258 answered as 256, 256 "
                             f"(max difference {apart})")
        log(f"{what}: served vs all-plain bf16 {err_plain:.3e} (largest "
            f"{largest:.2f}); vs the f32 answers {vs_f32} of their norm; "
            f"ids 257, 258 vs 256, 256 apart by {apart:.3f}")
    else:
        check(err_plain <= 2e-3, f"served vs all-plain forward {err_plain}")
        if ref is not None:
            ref["bert"] = served

    replay_err, replay_identical = check_replays(fm, ids, what)
    # device time of each bucket, direct predict_batch with the sync split
    exec_ms = exec_ms_by_bucket(fm, ids, what)
    breakdown = {b: forward_breakdown(fm, ids, b, bf16 and what)
                 for b in (1, 16)}
    if bf16:
        for b, br in breakdown.items():
            fwd = wgmma_forward_traced(br["replay"]["half_check"],
                                       f"{what} bucket {b} replay")
            log(f"{what}: bucket {b} replay's trace: flash forward kernels "
                f"{fwd}, 12 launches a forward")
    # the host's cost of one answer: numpy -> JSON on the server, and back
    # on the client
    t = time.perf_counter()
    body = json.dumps({"output": [served[0][0].tolist(),
                                  served[0][1].tolist()]})
    encode_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    json.loads(body)
    decode_ms = (time.perf_counter() - t) * 1e3
    lat = sorted(r[2] for r in results)
    summary = {
        "dtype": dtype, "requests": len(ids), "ok": codes.count(200),
        "clients": N_CLIENTS, "per_client": PER_CLIENT,
        "requests_per_s": len(ids) / serve_s,
        "client_p50_ms": lat[len(lat) // 2],
        "client_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "client_max_ms": lat[-1],
        "server_p50_ms": stats.get("p50_ms"),
        "server_p99_ms": stats.get("p99_ms"),
        "batches": batches, "mean_batch": len(ids) / batches,
        "executed_batches": executed, "freeze_s": freeze_s,
        "compiles": compiles, "compiled_buckets": compiled,
        "replay_vs_eager_worst": replay_err,
        "replay_bit_identical": replay_identical,
        "flash_launches": counts["flash"][0],
        "layer_norm_launches": counts["layer_norm"][0],
        "launches": {k: v[0] for k, v in every.items()},
        "max_err_vs_direct": err_direct, "max_err_vs_plain": err_plain,
        "largest_plain": largest, "vs_f32_rel_norm": vs_f32,
        "exec_ms_by_bucket": exec_ms,
        "batch_ms_by_bucket": {
            k.rsplit(".b", 1)[1]: v["p50"] for k, v in stats.items()
            if k.startswith("serving.exec_ms.b")},
        "response_bytes": len(body), "json_encode_ms": encode_ms,
        "json_decode_ms": decode_ms, "forward_breakdown": breakdown,
    }
    detail["serving_bf16" if bf16 else "serving"] = summary
    log(f"{what}: " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# the slice: GPT-2-base trained through autograd and Trainer("adam")
# ---------------------------------------------------------------------------

# GPT-2-base at bench.py's full-width configuration; the rehearsal on a CPU
# cuts depth and widths through train_lm's arguments
LM = dict(vocab_size=50257, batch=8, seq=512, period=16, steps=30, lr=1e-3,
          prompt=32, new_tokens=16)
# Gemma-2B's width, query heads, head dim and per-branch FFN width (Gemma
# Team, "Gemma: Open Models Based on Gemini Research and Technology",
# arXiv:2403.08295, Table 1: d_model 2048, 8 heads of 256, FFN 16384), its
# 18 layers cut to 4 for the run's time, in the port's TransformerLM (one
# K/V head a query head and GPT-2's blocks, where Gemma-2B has MQA, RoPE,
# RMSNorm and GeGLU: it stands for the attention shape only); trained at
# LM's batch, sequence, vocabulary and lr by train_lm_fused
LM_D256 = dict(units=2048, num_heads=8, hidden_size=16384, num_layers=4)
# LM_D256's width and FFN with 4 heads of 512 (head dims above 256 run the
# wide kernels in every dtype; no model the repository names has them) at
# 2 layers, trained by train_lm_fused at LM's batch and sequence
LM_D512 = dict(LM_D256, num_heads=4, num_layers=2)
# every gradient of the kernels' step within this share of the largest
# gradient of its parameter in the all-plain step (f32 sums in other orders
# through 12 layers)
GRAD_RTOL = 1e-3


def lm_tokens(batch, seq, vocab, period, seed=3):
    """Periodic rows: one period of ids from RandomState(seed), row r
    shifted by r positions. Returns (ids (batch, seq) int64, the period)."""
    import numpy as np
    base = np.random.RandomState(seed).randint(0, vocab, period)
    rows = [base[(np.arange(seq) + r) % period] for r in range(batch)]
    return np.stack(rows).astype(np.int64), base


def grad_errs(params, plain, truth=None):
    """Per parameter: (max |g - plain|, max |plain|, ||g - plain|| /
    ||plain||), and where `truth` (the f32 all-plain step's gradients, on
    the host) is given, the two bf16 steps' distances to it, ||g - truth||
    / ||truth|| and ||plain - truth|| / ||truth||."""
    import torch
    out = {}
    for n, p in params.items():
        g, ref = p.grad.float(), plain.pop(n).float()
        row = [float((g - ref).abs().max()), float(ref.abs().max()),
               float(torch.linalg.vector_norm(g - ref)
                     / max(float(torch.linalg.vector_norm(ref)), 1e-30))]
        if truth is not None:
            t = truth[n].to(g.device)
            tn = max(float(torch.linalg.vector_norm(t)), 1e-30)
            row += [float(torch.linalg.vector_norm(g - t)) / tn,
                    float(torch.linalg.vector_norm(ref - t)) / tn]
        out[n] = tuple(row)
    return out


def worst_of(errs):
    """The entry of `errs` ({name: (err, scale, ...)}) of the largest
    err / scale: (name, err, scale)."""
    n = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-30))
    return n, errs[n][0], errs[n][1]


def check_bf16_grads(grad_err, what, tol=BF16_TOL, dt="bf16"):
    """The bf16 (or, `dt` "f16", f16) step-0 gradients against the
    all-plain step's in the same dtype: every one within `tol` of its
    parameter's largest all-plain gradient; the distances of both to the
    f32 step are logged beside it."""
    worst = worst_of(grad_err)
    expect(all(e == e and e <= tol * scale
               for e, scale, *_ in grad_err.values()),
           f"{what}: step 0 gradients vs all-plain {dt}: {worst[0]} off "
           f"by {worst[1]} against its largest {worst[2]}")
    norm = max(grad_err, key=lambda k: grad_err[k][2])
    log(f"{what}: step 0 gradients vs all-plain {dt}: worst {worst[0]} "
        f"{worst[1]:.3e} of {worst[2]:.3e}; worst norm {norm} "
        f"{grad_err[norm][2]:.3e}")
    if all(len(v) == 5 for v in grad_err.values()):
        far = max(grad_err, key=lambda k: grad_err[k][3])
        log(f"{what}: distance to the f32 step, kernels' {dt} / all-plain "
            f"{dt}: farthest {far} {grad_err[far][3]:.3e} / "
            f"{grad_err[far][4]:.3e}")
    return worst


def train_lm(detail, cfg=LM, dtype="float32", ref=None, **model_kw):
    """GPT-2-base trained through autograd and Trainer("adam"). In bf16 by
    amp's own recipe: ``amp.init()``, the module cast to bf16, Adam with
    ``multi_precision=True`` (f32 masters), ``amp.init_trainer`` with a
    DynamicLossScaler (its state on the card) and ``amp.scale_loss``; every
    ``trainer.step`` runs under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises on any host sync. `ref`: a dict that the f32 phase fills
    with its all-plain step-0 gradients (on the host) and the bf16 phase
    measures its own against. Returns the summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import amp, autograd, gluon, gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import lm_loss, transformer_lm_base

    bf16 = dtype == "bfloat16"
    what = "training bf16" if bf16 else "training"
    b, seq, steps, period = cfg["batch"], cfg["seq"], cfg["steps"], \
        cfg["period"]
    t0 = time.perf_counter()
    net = transformer_lm_base(cfg["vocab_size"], ctx=gpu(0), **model_kw)
    load_jax_params(net, normal_arrays(net, seed=0))
    n_layers = len(net.layers)
    n_params = sum(p.numel() for p in net.parameters())
    log(f"transformer_lm_base built on {next(net.parameters()).device}: "
        f"{n_layers} layers, {n_params} parameters, "
        f"{time.perf_counter() - t0:.1f} s")
    ids, base = lm_tokens(b, seq, cfg["vocab_size"], period)
    x = torch.from_numpy(ids).to(next(net.parameters()).device)
    opt = {"learning_rate": cfg["lr"]}
    if bf16:
        amp.init()
        net.to(getattr(torch, amp.target_dtype()))
        opt["multi_precision"] = True
    trainer = gluon.Trainer(net, "adam", opt)
    if bf16:
        amp.init_trainer(trainer, amp.DynamicLossScaler())
    params = dict(net.named_parameters())

    def forward():
        with autograd.record():
            return lm_loss(net(x), x)

    def backward(loss):
        if not bf16:
            autograd.backward(loss)
            return
        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)

    def step():
        if not bf16:
            trainer.step(b)
            return
        torch.cuda.set_sync_debug_mode("error")
        try:
            trainer.step(b)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    # the all-plain step from the same weights, for step 0's gradients (in
    # bf16 scaled by the same initial loss scale)
    with all_plain():
        loss_plain = forward()
        backward(loss_plain)
    loss_plain = float(loss_plain.detach().float().mean())
    plain_grads = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    if ref is not None and not bf16:
        ref["lm_grads"] = {n: g.cpu() for n, g in plain_grads.items()}
    truth = None
    if bf16 and ref is not None and "lm_grads" in ref:
        # the f32 step's gradients, times the loss scale of step 0
        scale = trainer._amp_loss_scaler.loss_scale
        truth = {n: g * scale for n, g in ref["lm_grads"].items()}

    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the peak counts it too
    start_bytes = torch.cuda.memory_allocated()
    reset_kernel_counts()
    profiler.reset_counters()
    losses, phases, grad_err = [], [], {}
    for i in range(steps):
        t_a = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        backward(loss)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        if i == 0:
            grad_err = grad_errs(params, plain_grads, truth)
            torch.cuda.synchronize()
        t_d = time.perf_counter()
        step()
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        losses.append(float(loss.detach().float().mean()))
        phases.append((t_b - t_a, t_c - t_b, t_e - t_d))
    counts = kernel_counts()
    trainer_steps = profiler.counters().get("mxtpu/trainer.steps")
    peak_bytes = torch.cuda.max_memory_allocated()
    # --- end of the main path ---

    per_step = {"flash_fwd": n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers, "layer_norm": 2 * n_layers + 1}
    for kind in counts:
        n = per_step.get(kind, 0)
        check(counts[kind] == (n * steps, 0),
              f"{what}: {kind} (launches, plain calls) {counts[kind]} != "
              f"({n} x {steps} steps, 0)")
    check(trainer_steps == steps, f"trainer.steps {trainer_steps} != {steps}")
    log(f"{what}: {steps} steps: launches per step " + ", ".join(
        f"{k} {counts[k][0] // steps}" for k in per_step) + ", plain calls 0")
    loss_err = abs(losses[0] - loss_plain)
    if bf16:
        expect(loss_err <= BF16_TOL * loss_plain,
               f"{what}: step 0 loss {losses[0]} vs all-plain {loss_plain}")
        worst = check_bf16_grads(grad_err, what)
        scaler = trainer._amp_loss_scaler
        log(f"{what}: {steps} steps under sync debug mode 'error', no host "
            f"sync; loss scale {scaler.loss_scale}, clean steps "
            f"{int(scaler._unskipped_dev)}")
    else:
        check(loss_err <= 1e-4 * loss_plain,
              f"step 0 loss {losses[0]} vs all-plain {loss_plain}")
        worst = worst_of(grad_err)
        check(all(np.isfinite(e) and e <= GRAD_RTOL * scale
                  for e, scale, *_ in grad_err.values()),
              f"step 0 gradients vs all-plain: {worst[0]} off by "
              f"{worst[1]} against its largest {worst[2]}")
    log(f"{what}: step 0 vs all-plain: loss {losses[0]:.6f} vs "
        f"{loss_plain:.6f}; worst gradient {worst[0]}: max diff "
        f"{worst[1]:.3e} of its largest {worst[2]:.3e}")
    check(all(np.isfinite(losses)), f"{what}: non-finite loss: {losses}")
    (expect if bf16 else check)(
        losses[-1] < 0.5 * losses[0],
        f"{what}: loss {losses[0]} -> {losses[-1]} after {steps} steps: not "
        f"below half")
    log(f"{what}: losses: " + " ".join(f"{v:.4f}" for v in losses))

    # the host time autograd.backward spends finding the leaves whose
    # gradients it overwrites (grad_req="write"), on a step's graph
    probe = forward()
    walks = []
    for _ in range(5):
        t = time.perf_counter()
        n_leaves = len(autograd._reached_leaves([probe]))
        walks.append((time.perf_counter() - t) * 1e3)
    walk_ms = sorted(walks)[2]
    del probe
    log(f"{what}: backward's walk to its {n_leaves} leaves: {walk_ms:.3f} "
        f"ms (median of 5)")
    states_check = save_load_check(net, trainer, x, b, opt, what)

    # generation: the prefill runs the causal flash kernel, one per layer;
    # the decode steps mask the cache and take the plain path
    prompt = x[:2, :cfg["prompt"]]
    new = cfg["new_tokens"]
    reset_kernel_counts()
    out = net.generate(prompt, new)
    gen_counts = kernel_counts()["flash_fwd"]
    check(gen_counts == (n_layers, 0),
          f"generate: flash launches {gen_counts} != ({n_layers}, 0)")
    want = np.stack([base[(np.arange(cfg["prompt"], cfg["prompt"] + new) + r)
                          % period] for r in range(2)])
    got = out[:, cfg["prompt"]:].cpu().numpy()
    (expect if bf16 else check)(
        np.array_equal(got, want),
        f"{what}: generate did not continue the period: {got.tolist()} vs "
        f"{want.tolist()}")
    with torch.no_grad():
        logits = net(prompt)[:, -1].float()
        with all_plain():
            logits_plain = net(prompt)[:, -1].float()
    prefill_err = float((logits - logits_plain).abs().max())
    logit_scale = float(logits_plain.abs().max())
    (expect if bf16 else check)(
        prefill_err <= (BF16_TOL if bf16 else 1e-4) * max(1.0, logit_scale),
        f"{what}: prefill logits vs all-plain: {prefill_err} (largest "
        f"{logit_scale})")
    log(f"{what}: generate: {new} tokens continue the period for both "
        f"prompts; prefill flash launches {gen_counts[0]}; prefill logits vs "
        f"all-plain {prefill_err:.2e} (largest {logit_scale:.2f})")

    # where one step's time goes on the card (it trains on: steps 31+)
    def train_step():
        loss = forward()
        backward(loss)
        trainer.step(b)

    dev_total, per = device_ms(train_step, iters=3)
    stream = time_ms(train_step, iters=3)
    kinds = _by_kind(per)
    bf16_check = half_only(sorted(per), f"{what} step") if bf16 else None
    if bf16:
        fwd = wgmma_forward_traced(bf16_check, f"{what} step")
        bwd = flash_backward_traced(bf16_check, f"{what} step")
        log(f"{what}: the step's trace: flash forward kernels {fwd}, "
            f"{per_step['flash_fwd']} launches a step; dQ kernels "
            f"{bwd['flash_bwd_dq']}, dK/dV kernels {bwd['flash_bwd_dkv']}, "
            f"{per_step['flash_bwd_dq']} and {per_step['flash_bwd_dkv']} "
            f"launches a step")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    timed = phases[2:] or phases
    med = [sorted(p[i] for p in timed)[len(timed) // 2] * 1e3
           for i in range(3)]
    step_ms = sorted(sum(p) for p in timed)[len(timed) // 2] * 1e3
    tokens = b * seq
    model_flops = 6.0 * n_params * tokens
    summary = {
        "config": dict(cfg, layers=n_layers, units=net._units,
                       params=n_params, dtype=dtype, tf32=False,
                       multi_precision=bf16,
                       loss_scaler="dynamic" if bf16 else None),
        "losses": losses, "loss_plain_step0": loss_plain,
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_step": per_step,
        "step0_grad_worst": list(worst),
        "step0_grad_worst_norm": max(e[2] for e in grad_err.values()),
        "step_ms_median": step_ms, "forward_ms_median": med[0],
        "backward_ms_median": med[1], "optimizer_ms_median": med[2],
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_memory_bytes": peak_bytes,
        "memory_at_start_bytes": start_bytes,
        "step_device_ms": dev_total, "step_stream_ms": stream,
        "idle_share": 1.0 - dev_total / stream if stream > 0 else None,
        "step_by_kind_ms": kinds,
        "matmul_tflops": (model_flops / (kinds["matmul"] / 1e3) / 1e12
                          if kinds.get("matmul") else None),
        "top_kernels_ms": [[n[:80], ms] for n, ms in top],
        "bf16_check": bf16_check, "backward_leaf_walk_ms": walk_ms,
        "generated": got.tolist(), "prefill_logit_err": prefill_err,
        "save_load_states": states_check,
    }
    if bf16:
        summary["loss_scale"] = trainer._amp_loss_scaler.loss_scale
        if truth is not None:
            summary["step0_grad_vs_f32"] = {
                "kernels": max(e[3] for e in grad_err.values()),
                "plain": max(e[4] for e in grad_err.values())}
    detail["training_bf16" if bf16 else "training"] = summary
    log(f"{what}: " + json.dumps({k: v for k, v in summary.items()
                                   if k not in ("losses", "generated")}))
    return summary


def save_load_check(net, trainer, x, b, opt, what):
    """The optimizer's states through a file and back: ``save_states`` of
    `trainer` (the JAX package's format), ``load_states`` into a fresh
    Trainer on a copy of `net` (in bf16 with a dynamic scaler at the same
    scale), then one more step of each on `x`: the states load onto the
    card, and the two losses after that step agree (f32 1e-5, bf16
    BF16_TOL, relative). The file goes into OUT_DIR and is deleted."""
    import copy

    import torch
    from incubator_mxnet_tpu_torch import amp, autograd, gluon
    from incubator_mxnet_tpu_torch.models import lm_loss

    bf16 = next(net.parameters()).dtype == torch.bfloat16
    twin = copy.deepcopy(net)
    twin_trainer = gluon.Trainer(twin, "adam", opt)
    if bf16:
        amp.init_trainer(twin_trainer, amp.DynamicLossScaler(
            init_scale=trainer._amp_loss_scaler.loss_scale))
    path = OUT_DIR / "trainer_states.pkl"
    t0 = time.perf_counter()
    try:
        trainer.save_states(path)
        size = path.stat().st_size
        twin_trainer.load_states(path)
    finally:
        path.unlink(missing_ok=True)
    trip_s = time.perf_counter() - t0
    on_card = {s.device.type for st in twin_trainer._states for s in st}
    check(on_card == {x.device.type} and twin_trainer.optimizer.num_update
          == trainer.optimizer.num_update,
          f"{what}: loaded states on {on_card}, num_update "
          f"{twin_trainer.optimizer.num_update} != "
          f"{trainer.optimizer.num_update}")

    def one_step(m, tr):
        with autograd.record():
            loss = lm_loss(m(x), x)
        if bf16:
            with amp.scale_loss(loss, tr) as scaled:
                autograd.backward(scaled)
        else:
            autograd.backward(loss)
        tr.step(b)
        with torch.no_grad():
            return float(lm_loss(m(x), x).float().mean())

    after = [one_step(net, trainer), one_step(twin, twin_trainer)]
    del twin, twin_trainer
    err = abs(after[1] - after[0]) / max(abs(after[0]), 1e-30)
    (expect if bf16 else check)(
        err <= (BF16_TOL if bf16 else 1e-5),
        f"{what}: one step after load_states: loss {after[1]} vs the "
        f"original trainer's {after[0]}")
    log(f"{what}: save_states/load_states ({size} bytes, {trip_s:.1f} s): "
        f"states on the card; the loss after one more step {after[1]:.6g} "
        f"vs {after[0]:.6g} (rel {err:.2e})")
    return {"bytes": size, "seconds": trip_s, "loss_after": after,
            "rel_err": err}


# ---------------------------------------------------------------------------
# the fused step: forward, backward and update as one CUDA graph
# ---------------------------------------------------------------------------

# TrainLoop's chunk in the fused GPT-2 phase, and its schedule's warmup
FUSED_CHUNK, FUSED_WARMUP = 5, 3


def step0_vs_all_plain(net, loss_fn, x, y, what):
    """Step 0 of an f32 training loop through the kernels, op by op from
    `net`'s weights (the forward in training mode, then
    ``torch.autograd.backward`` of the mean loss), against the same step
    all-plain (:func:`all_plain`): the loss within 1e-4 of the plain one
    and every gradient within GRAD_RTOL of its plain version's largest
    value, as ``train_lm`` holds its first step. Leaves the gradients
    None and the weights as they were; returns the loss and the worst
    gradient."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import autograd

    params = {n: p for n, p in net.named_parameters() if p.requires_grad}

    def run():
        for p in params.values():
            p.grad = None
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        torch.autograd.backward(loss)
        return float(loss.detach())

    with all_plain():
        loss_plain = run()
    plain_grads = {n: p.grad for n, p in params.items()}
    loss = run()
    grad_err = grad_errs(params, plain_grads)
    for p in params.values():
        p.grad = None
    worst = worst_of(grad_err)
    check(abs(loss - loss_plain) <= 1e-4 * loss_plain,
          f"{what}: step 0 loss {loss} vs all-plain {loss_plain}")
    check(all(np.isfinite(e) and e <= GRAD_RTOL * scale
              for e, scale, *_ in grad_err.values()),
          f"{what}: step 0 gradients vs all-plain: {worst[0]} off by "
          f"{worst[1]} against its largest {worst[2]}")
    log(f"{what}: step 0 vs all-plain: loss {loss:.6f} vs {loss_plain:.6f};"
        f" worst gradient {worst[0]}: max diff {worst[1]:.3e} of its "
        f"largest {worst[2]:.3e}")
    return {"loss": loss, "loss_plain": loss_plain, "worst_grad": worst}


def eager_steps(net, loss_fn, opt, x, y, n):
    """`n` steps of the plain loop a captured step is held against, op by
    op from `net`'s weights: the forward in training mode,
    ``torch.autograd.backward`` of the mean loss, then ``update_fused``
    with the host schedule's lr and the count as Python numbers. Returns
    the losses (host floats)."""
    import torch
    from incubator_mxnet_tpu_torch import autograd, optimizer

    params = [p for p in net.parameters() if p.requires_grad]
    ones = [1.0] * len(params)
    states = optimizer.pack_states(
        [opt.create_state_multi_precision(i, p)
         for i, p in enumerate(params)])
    losses = []
    for t in range(1, n + 1):
        opt.num_update = t
        for p in params:
            p.grad = None
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        torch.autograd.backward(loss)
        opt.update_fused(params, [p.grad for p in params], states,
                         opt.learning_rate, opt.wd, t, ones, ones)
        losses.append(float(loss.detach().float()))
    for p in params:
        p.grad = None
    return losses


@contextlib.contextmanager
def no_host_sync():
    """``torch.cuda.set_sync_debug_mode("error")`` inside: any host sync
    raises."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def guard_replays(step, record):
    """Wrap `step.run_k` (until ``del step.run_k``): each call first builds
    the step for its inputs (a capture runs outside the guard), then
    replays under :func:`no_host_sync`, timed from a synchronize to a
    synchronize; `record` gets (ms, the lrs the k steps used)."""
    import torch
    run_k = step.run_k

    def guarded(xs, ys):
        step.ensure_built(xs[0], ys[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_host_sync():
            out = run_k(xs, ys)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t0) * 1e3, step.last_lrs))
        return out
    step.run_k = guarded


def train_lm_fused(detail, cfg=LM, dtype="float32", ref=None, label=None,
                   **model_kw):
    """GPT-2-base (or, with `model_kw`, transformer_lm_base at other
    widths, under `label`) trained through ``TrainLoop(net, lm_loss, adam,
    chunk=5).fit(..., steps=30)``: each step one replay of one CUDA graph,
    its lr computed on the card from its count by the CosineScheduler's
    closed form (warmup 3 steps from lr / 10). In bf16 the module is cast
    to bf16 and Adam keeps f32 masters (no loss scaler, as the JAX fused
    step has none). Checks one capture, the launches per step credited by
    the replays (plus the capture's warm-up forward and backward), no host
    sync in any replay, in f32 step 0 against the all-plain step
    (``step0_vs_all_plain``), the first chunk's losses against the same
    five steps run op by op (``eager_steps``), the loss halved, the lrs the
    program used, the flash kernels the step's trace names; reports the
    flash kernels' device ms a step against the step's. Returns the
    summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import (TrainLoop, gpu, lr_scheduler,
                                           optimizer, profiler)
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import lm_loss, transformer_lm_base
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

    bf16 = dtype == "bfloat16"
    what = label or ("fused training bf16" if bf16 else "fused training")
    b, seq, steps, k = cfg["batch"], cfg["seq"], cfg["steps"], FUSED_CHUNK
    ids, _ = lm_tokens(b, seq, cfg["vocab_size"], cfg["period"])

    def build():
        net = transformer_lm_base(cfg["vocab_size"], ctx=gpu(0), **model_kw)
        load_jax_params(net, normal_arrays(net, seed=0))
        if bf16:
            net.to(torch.bfloat16)
        sched = lr_scheduler.CosineScheduler(
            max_update=steps, base_lr=cfg["lr"], warmup_steps=FUSED_WARMUP,
            warmup_begin_lr=cfg["lr"] / 10)
        return net, optimizer.create("adam", learning_rate=cfg["lr"],
                                     lr_scheduler=sched,
                                     multi_precision=bf16)

    net, opt = build()
    n_layers = len(net.layers)
    head_dim = net._units // net.layers[0].attention._num_heads
    x = torch.from_numpy(ids).to(next(net.parameters()).device)
    step0 = None if bf16 else step0_vs_all_plain(net, lm_loss, x, x, what)
    eager = eager_steps(net, lm_loss, opt, x, x, k)
    del net, opt
    torch.cuda.empty_cache()

    net, opt = build()
    loop = TrainLoop(net, lm_loss, opt, chunk=k)
    record = []
    guard_replays(loop.step, record)
    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the peak counts it too
    start_bytes = torch.cuda.memory_allocated()
    reset_kernel_counts()
    profiler.reset_counters()
    t0 = time.perf_counter()
    losses = loop.fit([(ids, ids)], steps=steps)
    fit_s = time.perf_counter() - t0
    counts = kernel_counts()
    c = profiler.counters()
    peak_bytes = torch.cuda.max_memory_allocated()
    # --- end of the main path ---

    per_step = {"flash_fwd": n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers, "layer_norm": 2 * n_layers + 1}
    captures = c.get("mxtpu/fused_step.captures")
    check(captures == 1, f"{what}: fused_step.captures {captures} != 1")
    for kind in counts:
        n = per_step.get(kind, 0)
        check(counts[kind] == (n * (steps + 1), 0),
              f"{what}: {kind} (launches, plain calls) {counts[kind]} != "
              f"({n} x ({steps} replays + the capture's warm-up), 0)")
    check(loop.num_update == steps == opt.num_update
          and c.get("trainloop/trainloop.steps") == steps,
          f"{what}: num_update {opt.num_update}, trainloop.steps "
          f"{c.get('trainloop/trainloop.steps')} != {steps}")
    check(loop.in_program_lr and c.get("trainloop/trainloop.in_program_lr"),
          f"{what}: the lr was not computed in the program")
    log(f"{what}: {steps} steps in {steps // k} chunks, one capture; "
        f"launches per step " + ", ".join(
            f"{kd} {n}" for kd, n in per_step.items())
        + f" ({steps} replays + the warm-up), plain calls 0; every replay "
          f"under sync debug mode 'error'")
    check(losses.shape == (steps,) and np.isfinite(losses).all(),
          f"{what}: losses {losses}")
    first = [float(v) for v in losses[:k]]
    errs = [abs(a - e) / max(abs(e), 1e-30) for a, e in zip(first, eager)]
    (expect if bf16 else check)(
        max(errs) <= (BF16_TOL if bf16 else 1e-4),
        f"{what}: the first chunk's losses {first} vs the eager loop's "
        f"{eager}")
    (expect if bf16 else check)(
        losses[-1] < 0.5 * losses[0],
        f"{what}: loss {losses[0]} -> {losses[-1]} after {steps} steps: not "
        f"below half")
    sched = lr_scheduler.CosineScheduler(
        max_update=steps, base_lr=cfg["lr"], warmup_steps=FUSED_WARMUP,
        warmup_begin_lr=cfg["lr"] / 10)
    lrs = torch.cat([r[1] for r in record]).cpu().numpy()
    lr_at = {t: (float(lrs[t - 1]), sched(t)) for t in (1, 3, steps)}
    check(all(abs(a - h) <= 1e-6 * max(h, 1e-12) for a, h in lr_at.values()),
          f"{what}: the program's lr against CosineScheduler: {lr_at}")
    log(f"{what}: first chunk vs the eager loop: " + ", ".join(
        f"{a:.6f}/{e:.6f}" for a, e in zip(first, eager))
        + f" (worst rel {max(errs):.2e}); lr at steps 1, 3, {steps}: "
        + ", ".join(f"{a:.6g} (host {h:.6g})" for a, h in lr_at.values()))
    log(f"{what}: losses: " + " ".join(f"{v:.4f}" for v in losses))

    # where a step's time goes (it trains on past the schedule's end)
    del loop.step.run_k
    chunk_ms = [r[0] for r in record]
    timed = sorted(chunk_ms[1:])
    step_ms = timed[len(timed) // 2] / k
    xs = torch.from_numpy(np.stack([ids] * k)).to(x.device)
    bd = _breakdown(lambda: loop.run_chunk(xs, xs),
                    f"{what} chunk" if bf16 else None, dtype)
    if bf16 and fa.kernel_head_dim(head_dim) <= 256:
        wgmma_forward_traced(bd["half_check"], f"{what} chunk")
    flash_traced = flash_backward_traced(
        bd["flash_check"], f"{what} chunk", fa.kernel_head_dim(head_dim),
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    flash_ms = {kd: bd["by_kind_ms"].get(kd, 0.0) / k for kd in FLASH_KINDS}
    step_device_ms = bd["device_ms"] / k
    log(f"{what}: flash kernels a step (device ms) " + ", ".join(
        f"{kd} {v:.4f}" for kd, v in flash_ms.items())
        + f"; {sum(flash_ms.values()):.4f} of the step's {step_device_ms:.3f}"
        f" ({sum(flash_ms.values()) / step_device_ms:.2%})")
    summary = {
        "config": dict({**cfg, **model_kw}, layers=n_layers,
                       units=net._units, dtype=dtype, chunk=k,
                       schedule="cosine", warmup=FUSED_WARMUP,
                       multi_precision=bf16, loss_scaler=None,
                       head_dim=head_dim),
        "losses": losses.tolist(), "eager_first_chunk": eager,
        "first_chunk_rel_err": max(errs), "step0_vs_all_plain": step0,
        "captures": captures,
        "launches": {kd: v[0] for kd, v in counts.items()},
        "launches_per_step": per_step, "lr_at": lr_at,
        "chunk_ms": chunk_ms, "step_ms_median": step_ms,
        "tokens_per_s": b * seq / (step_ms / 1e3), "fit_s": fit_s,
        "peak_memory_bytes": peak_bytes,
        "memory_at_start_bytes": start_bytes,
        "step_device_ms": step_device_ms,
        "step_stream_ms": bd["stream_ms"] / k,
        "flash_ms_per_step": flash_ms,
        "flash_share_of_device": sum(flash_ms.values()) / step_device_ms,
        "idle_share": bd["idle_share"], "timer": bd["timer"],
        "step_by_kind_ms": {kd: v / k for kd, v in bd["by_kind_ms"].items()},
        "top_kernels_ms": [[n, v / k] for n, v in bd["top_kernels_ms"]],
        "bf16_check": bd.get("half_check"),
        "flash_backward_traced": flash_traced,
    }
    detail[label or ("fused_training_bf16" if bf16 else "fused_training")] = \
        summary
    log(f"{what}: " + json.dumps({kd: v for kd, v in summary.items()
                                   if kd not in ("losses", "chunk_ms")}))
    return summary


# ---------------------------------------------------------------------------
# BERT-base pretraining (MLM + NSP), and dropout inside a captured step
# ---------------------------------------------------------------------------

# BERT's phase-1 pretraining batch: 32 sequences of 128 with 20 masked
# positions each (max_predictions_per_seq), the AdamW recipe of the JAX
# package's examples/bert_pretrain_toy.py (wd 0.01, a CosineScheduler with
# 3 warm-up steps) at BERT's published pretraining learning rate, 1e-4;
# then one SGLD step. At the example's lr of 1e-3 the 12 post-LN layers
# diverge at the warm-up's end (the loss jumps to 13-17) and settle at
# ln 640 + ln 2 = 7.15, the batch's label marginal, for 60 steps; at 1e-4
# the loss falls from 11.13 to 5.14 in 30 steps
# (incubator_mxnet_tpu_torch/tools/sweep_pretrain_lr.py)
BERT_PRETRAIN = dict(vocab_size=30522, max_length=512, batch=32, seq=128,
                     masked=20, min_valid=64, steps=30, lr=1e-4, wd=0.01,
                     warmup=3, dropout=0.1, repeat=3, sgld_lr=1e-4)
# the bf16 pretraining step's gradients against the all-plain bf16 step's,
# as BERT_BF16_TOL holds BERT's served answers: the twelve post-LN layer
# norms round bf16 outputs from f32 sums taken in other orders than the
# plain versions', and dropout and twelve layers carry the flipped units
# on. Measured 2.2% (cells.1.ffn.ffn_2.weight: 6.81 at a largest of 310),
# while the kernels' gradients stand nearer the f32 step's than the
# all-plain bf16 ones do (worst norm 2.45% against 3.01%), which the phase
# checks too
BERT_PRETRAIN_BF16_TOL = 4e-2
# the standardised SGLD noise of word_embed.weight (23.4M values): |mean|
# and |std - 1| under these (5 and 7 sigma at that count)
SGLD_TOL = 1e-3


def pretrain_batch(cfg, seed=5):
    """One fixed pretraining batch from RandomState(seed): ids, token types
    (the second segment from half the valid length on), valid lengths in
    [min_valid, seq], `masked` distinct positions inside each valid length,
    their labels and the NSP labels; int64 numpy arrays."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b, seq, m, v = cfg["batch"], cfg["seq"], cfg["masked"], \
        cfg["vocab_size"]
    vl = rng.randint(cfg["min_valid"], seq + 1, b)
    ids = rng.randint(0, v, (b, seq))
    tt = (np.arange(seq)[None, :] >= (vl // 2)[:, None]).astype(np.int64)
    pos = np.stack([rng.choice(n, m, replace=False) for n in vl])
    labels = rng.randint(0, v, (b, m))
    nsp = rng.randint(0, 2, b)
    return [a.astype(np.int64) for a in (ids, tt, vl, pos, labels, nsp)]


def sgld_check(net, forward, b, lr, what):
    """One ``Trainer("sgld")`` step on `net` under sync debug "error":
    ``(w_new - w_expected) / sqrt(lr)`` of ``bert.word_embed.weight``,
    where w_expected is the step without its noise, must be N(0, 1):
    |mean| and |std - 1| within SGLD_TOL. Returns the numbers."""
    import torch
    from incubator_mxnet_tpu_torch import autograd, gluon
    trainer = gluon.Trainer(net, "sgld", {"learning_rate": lr})
    autograd.backward(forward())
    w = net.bert.word_embed.weight
    w0, g = w.detach().float().clone(), w.grad.detach().float().clone()
    torch.cuda.synchronize()
    with no_host_sync():
        trainer.step(b)
    expected = w0 - lr / 2 * (g * (1.0 / b))
    z = (w.detach().float() - expected) / math.sqrt(lr)
    mean, std = float(z.mean()), float(z.std())
    check(abs(mean) < SGLD_TOL and abs(std - 1.0) < SGLD_TOL,
          f"{what}: SGLD's standardised noise over {z.numel()} values: mean "
          f"{mean}, std {std} (bounds {SGLD_TOL})")
    log(f"{what}: one SGLD step (lr {lr}) under sync debug mode 'error': "
        f"standardised noise of word_embed.weight ({z.numel()} values) "
        f"mean {mean:.3e}, std {std:.6f}")
    return {"values": z.numel(), "mean": mean, "std": std, "lr": lr}


def train_bert_pretrain(detail, cfg=BERT_PRETRAIN, dtype="float32",
                        ref=None):
    """BERT-base pretraining: ``BERTForPretrain(bert_12_768_12(use_pooler=
    True, dropout=0.1))`` through ``random.seed(0)`` → ``autograd.record``
    → ``BERTPretrainLoss`` → ``autograd.backward`` →
    ``Trainer("adamw").step(batch)`` under a CosineScheduler, 30 steps on
    one batch. In bf16 by GPT-2's amp recipe (module cast, f32 masters, a
    DynamicLossScaler, every ``trainer.step`` under sync debug "error").
    Checks step 0's loss and gradients against an all-plain step with the
    same seed (so the same dropout masks), 26 layer-norm launches and 12
    flash rejections a step with no plain call, the loss halved, the first
    losses of a second run from ``random.seed(0)`` bit for bit, and then
    one SGLD step's noise (``sgld_check``). `ref`: the f32 phase's
    all-plain gradients, for the bf16 phase. Returns the summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import (amp, autograd, gluon, gpu,
                                           lr_scheduler, profiler, random)
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import (BERTForPretrain,
                                                  BERTPretrainLoss,
                                                  bert_12_768_12)

    bf16 = dtype == "bfloat16"
    what = "bert pretraining bf16" if bf16 else "bert pretraining"
    b, steps = cfg["batch"], cfg["steps"]
    t0 = time.perf_counter()
    net = BERTForPretrain(bert_12_768_12(
        vocab_size=cfg["vocab_size"], max_length=cfg["max_length"],
        use_pooler=True, dropout=cfg["dropout"], ctx=gpu(0)),
        cfg["vocab_size"])
    load_jax_params(net, normal_arrays(net, seed=0))
    if bf16:
        amp.init()
        net.to(getattr(torch, amp.target_dtype()))
    device = next(net.parameters()).device
    start_weights = {n: p.detach().clone()
                     for n, p in net.named_parameters()}
    n_layers = len(net.bert.encoder.cells)
    n_params = sum(p.numel() for p in net.parameters())
    log(f"BERTForPretrain(bert_12_768_12) built on {device}: {n_layers} "
        f"layers, {n_params} parameters, {time.perf_counter() - t0:.1f} s")
    ids, tt, vl, pos, labels, nsp = (torch.from_numpy(a).to(device)
                                     for a in pretrain_batch(cfg))
    loss_fn = BERTPretrainLoss()
    params = dict(net.named_parameters())

    def make_trainer():
        sched = lr_scheduler.CosineScheduler(
            steps, base_lr=cfg["lr"], warmup_steps=cfg["warmup"])
        trainer = gluon.Trainer(net, "adamw", {
            "learning_rate": cfg["lr"], "wd": cfg["wd"],
            "lr_scheduler": sched, "multi_precision": bf16})
        if bf16:
            amp.init_trainer(trainer, amp.DynamicLossScaler())
        return trainer

    trainer = make_trainer()

    def forward():
        with autograd.record():
            mlm, ns = net(ids, tt, vl, pos)
            return loss_fn(mlm, ns, labels, nsp)

    def backward(loss):
        if not bf16:
            autograd.backward(loss)
            return
        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)

    def step():
        if not bf16:
            trainer.step(b)
            return
        with no_host_sync():
            trainer.step(b)

    # the all-plain step from the same weights and the same seed: the same
    # dropout masks (in bf16 scaled by the same initial loss scale)
    random.seed(0)
    with all_plain():
        loss_plain = forward()
        backward(loss_plain)
    loss_plain = float(loss_plain.detach().float())
    plain_grads = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    if ref is not None and not bf16:
        ref["bert_pretrain_grads"] = {n: g.cpu()
                                      for n, g in plain_grads.items()}
    truth = None
    if bf16 and ref is not None and "bert_pretrain_grads" in ref:
        scale = trainer._amp_loss_scaler.loss_scale
        truth = {n: g * scale for n, g in ref["bert_pretrain_grads"].items()}

    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    reset_kernel_counts()
    profiler.reset_counters()
    random.seed(0)
    losses, phases, grad_err = [], [], {}
    for i in range(steps):
        t_a = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        backward(loss)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        if i == 0:
            grad_err = grad_errs(params, plain_grads, truth)
            torch.cuda.synchronize()
        t_d = time.perf_counter()
        step()
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        losses.append(float(loss.detach().float()))
        phases.append((t_b - t_a, t_c - t_b, t_e - t_d))
    counts = kernel_counts()
    rejected = rejections()
    trainer_steps = profiler.counters().get("mxtpu/trainer.steps")
    peak_bytes = torch.cuda.max_memory_allocated()
    # --- end of the main path ---

    # the embedding's layer norm, two a cell and mlm_ln; attention with a
    # valid_length mask and dropout takes the plain path in both packages
    per_step = {"layer_norm": 2 * n_layers + 2}
    for kind in counts:
        n = per_step.get(kind, 0)
        check(counts[kind] == (n * steps, 0),
              f"{what}: {kind} (launches, plain calls) {counts[kind]} != "
              f"({n} x {steps} steps, 0)")
    check(rejected == {"flash_attention": n_layers * steps},
          f"{what}: selection rejections {rejected} != flash_attention "
          f"{n_layers} x {steps} steps")
    check(trainer_steps == steps, f"trainer.steps {trainer_steps} != {steps}")
    log(f"{what}: {steps} steps: layer-norm launches per step "
        f"{counts['layer_norm'][0] // steps}, flash rejections per step "
        f"{rejected['flash_attention'] // steps}, no other kernel, plain "
        f"calls 0")
    loss_err = abs(losses[0] - loss_plain)
    if bf16:
        expect(loss_err <= BF16_TOL * loss_plain,
               f"{what}: step 0 loss {losses[0]} vs all-plain {loss_plain}")
        worst = check_bf16_grads(grad_err, what, BERT_PRETRAIN_BF16_TOL)
        if truth is not None:
            # no farther from the f32 step than the all-plain bf16 step
            near = [max(e[i] for e in grad_err.values()) for i in (3, 4)]
            expect(near[0] <= near[1],
                   f"{what}: step 0 gradients' worst distance to the f32 "
                   f"step {near[0]}, the all-plain bf16 step's {near[1]}")
    else:
        check(loss_err <= 1e-4 * loss_plain,
              f"{what}: step 0 loss {losses[0]} vs all-plain {loss_plain}")
        worst = worst_of(grad_err)
        check(all(np.isfinite(e) and e <= GRAD_RTOL * scale
                  for e, scale, *_ in grad_err.values()),
              f"{what}: step 0 gradients vs all-plain: {worst[0]} off by "
              f"{worst[1]} against its largest {worst[2]}")
    log(f"{what}: step 0 vs all-plain with the same seed: loss "
        f"{losses[0]:.6f} vs {loss_plain:.6f}; worst gradient {worst[0]}: "
        f"max diff {worst[1]:.3e} of its largest {worst[2]:.3e}")
    check(all(np.isfinite(losses)), f"{what}: non-finite loss: {losses}")
    (expect if bf16 else check)(
        losses[-1] < 0.5 * losses[0],
        f"{what}: loss {losses[0]} -> {losses[-1]} after {steps} steps: not "
        f"below half")
    log(f"{what}: losses: " + " ".join(f"{v:.4f}" for v in losses))

    # where one step's time goes on the card (it trains on past step 30)
    def train_step():
        backward(forward())
        trainer.step(b)

    dev_total, per = device_ms(train_step, iters=3)
    stream = time_ms(train_step, iters=3)
    kinds = _by_kind(per)
    bf16_check = half_only(sorted(per), f"{what} step") if bf16 else None
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    sgld = sgld_check(net, forward, b, cfg["sgld_lr"], what)

    # a second run from the same weights and random.seed(0): the same
    # masks, so the same losses, bit for bit
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(start_weights[n])
    del start_weights
    trainer = make_trainer()
    random.seed(0)
    again = []
    for _ in range(cfg["repeat"]):
        loss = forward()
        backward(loss)
        step()
        again.append(float(loss.detach().float()))
    check(again == losses[:cfg["repeat"]],
          f"{what}: a second run from random.seed(0) gave losses {again}, "
          f"not {losses[:cfg['repeat']]}")
    log(f"{what}: a second run from random.seed(0): the first "
        f"{cfg['repeat']} losses bit for bit ({again})")

    timed = phases[2:] or phases
    med = [sorted(p[i] for p in timed)[len(timed) // 2] * 1e3
           for i in range(3)]
    step_ms = sorted(sum(p) for p in timed)[len(timed) // 2] * 1e3
    tokens = b * cfg["seq"]
    summary = {
        "config": dict(cfg, layers=n_layers, params=n_params, dtype=dtype,
                       tf32=False, multi_precision=bf16,
                       loss_scaler="dynamic" if bf16 else None),
        "losses": losses, "loss_plain_step0": loss_plain,
        "repeat_losses": again,
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_step": per_step, "rejections": rejected,
        "step0_grad_worst": list(worst),
        "step0_grad_worst_norm": max(e[2] for e in grad_err.values()),
        "step_ms_median": step_ms, "forward_ms_median": med[0],
        "backward_ms_median": med[1], "optimizer_ms_median": med[2],
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_memory_bytes": peak_bytes,
        "memory_at_start_bytes": start_bytes,
        "step_device_ms": dev_total, "step_stream_ms": stream,
        "idle_share": 1.0 - dev_total / stream if stream > 0 else None,
        "step_by_kind_ms": kinds,
        "top_kernels_ms": [[n[:80], ms] for n, ms in top],
        "bf16_check": bf16_check, "sgld": sgld,
    }
    if bf16:
        summary["loss_scale"] = trainer._amp_loss_scaler.loss_scale
        if truth is not None:
            summary["step0_grad_vs_f32"] = {
                "kernels": max(e[3] for e in grad_err.values()),
                "plain": max(e[4] for e in grad_err.values())}
    detail["bert_pretrain_bf16" if bf16 else "bert_pretrain"] = summary
    log(f"{what}: " + json.dumps({k: v for k, v in summary.items()
                                   if k not in ("losses",)}))
    return summary


def fused_dropout(detail, cfg=LM, layers=2, replays=5, repeat=3):
    """Dropout inside a captured step: GPT-2-base's width at `layers`
    layers with dropout 0.1 through ``FusedTrainStep`` with Adam at lr 0
    (the weights stay), one batch. `replays` replays must give as many
    different losses (fresh masks each), and ``random.seed(7)`` then
    `repeat` replays, done twice, the same losses bit for bit; one
    capture, every replay under sync debug "error", 2 * layers + 1
    layer-norm launches a step and no other. Returns the summary."""
    import torch
    from incubator_mxnet_tpu_torch import gpu, optimizer, profiler, random
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import lm_loss, transformer_lm_base
    from incubator_mxnet_tpu_torch.parallel import FusedTrainStep

    what = "fused dropout"
    net = transformer_lm_base(cfg["vocab_size"], ctx=gpu(0),
                              num_layers=layers, dropout=0.1)
    load_jax_params(net, normal_arrays(net, seed=0))
    ids, _ = lm_tokens(cfg["batch"], cfg["seq"], cfg["vocab_size"],
                       cfg["period"])
    x = torch.from_numpy(ids).to(next(net.parameters()).device)
    step = FusedTrainStep(net, lm_loss,
                          optimizer.create("adam", learning_rate=0.0))
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    reset_kernel_counts()
    profiler.reset_counters()
    step.ensure_built(x, x)
    torch.cuda.synchronize()
    with no_host_sync():
        fresh = [step(x, x) for _ in range(replays)]
        runs = []
        for _ in range(2):
            random.seed(7)
            runs.append([step(x, x) for _ in range(repeat)])
    torch.cuda.synchronize()
    counts = kernel_counts()
    captures = profiler.counters().get("mxtpu/fused_step.captures")
    fresh = [float(v) for v in fresh]
    runs = [[float(v) for v in r] for r in runs]
    n_steps = replays + 2 * repeat
    per_step = {"layer_norm": 2 * layers + 1}
    check(captures == 1 and len(step._graphs) == 1,
          f"{what}: {captures} captures, {len(step._graphs)} graphs")
    for kind in counts:
        n = per_step.get(kind, 0)
        check(counts[kind] == (n * (n_steps + 1), 0),
              f"{what}: {kind} (launches, plain calls) {counts[kind]} != "
              f"({n} x ({n_steps} replays + the warm-up), 0)")
    check(len(set(fresh)) == replays,
          f"{what}: {replays} replays gave losses {fresh}: not all "
          f"different (a mask frozen into the graph)")
    check(runs[0] == runs[1],
          f"{what}: random.seed(7) then {repeat} replays, twice: {runs}")
    check(all(torch.equal(p, before[n]) for n, p in net.named_parameters()),
          f"{what}: the weights moved at lr 0")
    log(f"{what}: one capture; {replays} replays, losses " + ", ".join(
        f"{v:.7f}" for v in fresh) + f"; random.seed(7) then {repeat} "
        f"replays, twice: {runs[0]} both times; layer-norm launches "
        f"{counts['layer_norm'][0]} ({per_step['layer_norm']} x {n_steps} "
        f"replays + the warm-up); every replay under sync debug mode "
        f"'error'")
    summary = {"config": dict(layers=layers, units=net._units, dropout=0.1,
                              batch=cfg["batch"], seq=cfg["seq"]),
               "captures": captures, "fresh_losses": fresh,
               "reseeded_losses": runs,
               "launches": {k: v[0] for k, v in counts.items()},
               "launches_per_step": per_step}
    detail["fused_dropout"] = summary
    return summary


# ---------------------------------------------------------------------------
# the slice: ResNet-50 v1 written with BatchNormReLU and ops.ConvBNReLU
# ---------------------------------------------------------------------------

def resnet50_v1_bnrelu(classes=1000, layers=(3, 4, 6, 3),
                       channels=(64, 256, 512, 1024, 2048), ctx=None):
    """ResNet-50 v1 (NHWC) as its user writes it with the two fused pieces
    of the API: the structure of ``models.resnet50_v1`` (stem conv 7x7/2
    pad 3, max pool 3/2/1, bottleneck stages with the stride on the first
    1x1, global average pool, flatten, Dense), with every conv and its
    BatchNorm one ``ConvBN`` block of children ``conv`` and ``bn``. ``bn``
    is ``BatchNormReLU`` where ResNet v1 has a ReLU after the BN, and
    ``BatchNorm`` on the third conv of a block and on the downsample.

    Inside ``autograd.record()`` a ConvBN returns ``bn(conv(x))``: the batch
    statistics normalize and update, and each BatchNormReLU runs the
    scale/shift/act kernel. Outside, it returns ``ops.ConvBNReLU`` with the
    moving statistics: 1x1/stride-1 convs run whole in the GEMM kernel,
    the others as cuDNN conv + the scale/shift/act kernel. Parameters are
    zero (gamma and running_var one) until ``load_jax_params`` or
    ``gluon.nn.init_params``; the module lands on `ctx` (default
    ``gpu(0)``)."""
    from torch import nn as tnn

    from incubator_mxnet_tpu_torch import autograd, ops
    from incubator_mxnet_tpu_torch.context import as_context
    from incubator_mxnet_tpu_torch.gluon import nn

    class ConvBN(tnn.Module):
        def __init__(self, ch, kernel, stride, pad, in_ch, relu):
            super().__init__()
            self.conv = nn.Conv2D(ch, kernel, strides=stride, padding=pad,
                                  use_bias=False, layout="NHWC",
                                  in_channels=in_ch)
            self.bn = (nn.BatchNormReLU if relu else nn.BatchNorm)(
                axis=-1, in_channels=ch)
            self._act = "relu" if relu else None

        def forward(self, x):
            if autograd.is_training():
                return self.bn(self.conv(x))
            return ops.ConvBNReLU(
                x, self.conv.weight, self.bn.gamma, self.bn.beta,
                self.bn.running_mean, self.bn.running_var, eps=self.bn._eps,
                stride=self.conv._stride, pad=self.conv._pad,
                act_type=self._act)

    class Bottleneck(tnn.Module):
        def __init__(self, ch, stride, downsample, in_ch):
            super().__init__()
            mid = ch // 4
            self.body = nn.HybridSequential()
            self.body.add(ConvBN(mid, 1, stride, 0, in_ch, True),
                          ConvBN(mid, 3, 1, 1, mid, True),
                          ConvBN(ch, 1, 1, 0, mid, False))
            self.downsample = (ConvBN(ch, 1, stride, 0, in_ch, False)
                               if downsample else None)

        def forward(self, x):
            residual = x if self.downsample is None else self.downsample(x)
            return ops.relu(self.body(x) + residual)

    class ResNet50BNReLU(tnn.Module):
        def __init__(self):
            super().__init__()
            self.features = nn.HybridSequential()
            self.features.add(ConvBN(channels[0], 7, 2, 3, 3, True),
                              nn.MaxPool2D(3, 2, 1, layout="NHWC"))
            in_ch = channels[0]
            for i, n in enumerate(layers):
                stride = 1 if i == 0 else 2
                stage = nn.HybridSequential()
                stage.add(Bottleneck(channels[i + 1], stride,
                                     channels[i + 1] != in_ch or stride != 1,
                                     in_ch))
                for _ in range(n - 1):
                    stage.add(Bottleneck(channels[i + 1], 1, False,
                                         channels[i + 1]))
                in_ch = channels[i + 1]
                self.features.add(stage)
            self.features.add(nn.GlobalAvgPool2D(layout="NHWC"),
                              nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_ch)

        def forward(self, x):
            return self.output(self.features(x))

    device = as_context(ctx).device        # raises without a card
    return ResNet50BNReLU().to(device)


def bnrelu_launches(layers=(3, 4, 6, 3)):
    """Kernel launches of one forward of :func:`resnet50_v1_bnrelu`:
    (scale_shift_act, mm_epilogue) in training mode and in predict mode.
    Training: the stem and two BatchNormReLUs a block. Predict: the GEMM
    kernel takes every 1x1/stride-1 conv (each block's third conv, the
    first conv of every block but a strided stage's first, and stage 1's
    downsample, which widens the channels); the scale/shift/act kernel the stem, every
    3x3 conv and the strided 1x1 convs of stages 2-4 (first conv and
    downsample)."""
    blocks = sum(layers)
    strided = len(layers) - 1
    train = (1 + 2 * blocks, 0)
    predict = (1 + blocks + 2 * strided,
               blocks + (blocks - strided) + 1)
    return {"train": train, "predict": predict}


def bnrelu_gemm_shapes(layers=(3, 4, 6, 3),
                       channels=(64, 256, 512, 1024, 2048), image=224):
    """(pixels per image, K, N) of every conv that one predict forward of
    :func:`resnet50_v1_bnrelu` runs in the GEMM kernel, in order: a block's
    first conv where its stride is 1, its third, and stage 1's
    downsample."""
    side = ((image - 1) // 2 + 1 - 1) // 2 + 1   # stem /2, max pool /2
    shapes = []
    in_ch = channels[0]
    for i, blocks in enumerate(layers):
        ch = channels[i + 1]
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            out = (side - 1) // stride + 1
            if stride == 1:
                shapes.append((side * side, in_ch, ch // 4))
            shapes.append((out * out, ch // 4, ch))
            if j == 0 and stride == 1 and ch != in_ch:
                shapes.append((side * side, in_ch, ch))
            side, in_ch = out, ch
    return shapes


def reduces_per_forward(bucket, layers, channels, image, dtype="float32"):
    """Launches of the split-K reduce kernel in one predict forward of
    `bucket` images in `dtype`: the GEMMs whose plan splits K."""
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    tdt = getattr(torch, dtype)
    return sum(cbr.mm_plan(bucket * pix, n, k, tdt)[1] > 1
               for pix, k, n in bnrelu_gemm_shapes(layers, channels, image))


def zoo_name(name):
    """The ``models.resnet50_v1`` name of a :func:`resnet50_v1_bnrelu`
    parameter or buffer: ConvBN ``k`` of a block is the zoo's body
    ``3k`` (conv) and ``3k + 1`` (BatchNorm); the stem's conv and BN are
    features 0 and 1, so the stages move up by two."""
    parts = name.split(".")
    if parts[0] == "output":
        return name
    leaf = parts[-1]
    which = parts[-2]                         # "conv" or "bn"
    if parts[1] == "0":                       # the stem
        return f"features.{0 if which == 'conv' else 1}.{leaf}"
    stage, block = int(parts[1]) + 2, parts[2]
    if parts[3] == "body":
        k = 3 * int(parts[4]) + (0 if which == "conv" else 1)
        return f"features.{stage}.{block}.body.{k}.{leaf}"
    return (f"features.{stage}.{block}.downsample."
            f"{0 if which == 'conv' else 1}.{leaf}")


# ResNet-50 at bench.py's configuration (batch 128, 224 x 224, NHWC, SGD
# with momentum 0.9 and wd 1e-4), in f32; the rehearsal on a CPU cuts
# widths, depth and sizes through train_resnet's arguments. bench.py's lr
# 0.1 overshoots on one fixed batch from Normal(0.02) weights: the loss
# jumps above 8 in the first steps and stalls near uniform (0.1 to 1.0 on
# the card); 0.01 descends without a jump
RESNET = dict(batch=128, image=224, classes=1000, steps=30, lr=0.01,
              momentum=0.9, wd=1e-4, serve_threads=8, serve_per_thread=8,
              buckets=(1, 2, 4, 8, 16, 32))


def train_resnet(detail, cfg=RESNET, dtype="float32", ref=None, **net_kw):
    """ResNet-50 v1 (resnet50_v1_bnrelu) trained on one fixed batch through
    autograd.record -> SoftmaxCrossEntropyLoss -> autograd.backward ->
    Trainer("sgd", momentum, wd). In bf16 by ``bench.py``'s recipe: the
    module cast to bf16 (BatchNorm's moving statistics too), bf16 images,
    SGD with ``multi_precision=True``, no loss scaler. `ref`: a dict that
    the f32 phase fills with its all-plain step-0 gradients (on the host)
    and the bf16 phase measures its own against. Returns (summary, the
    trained net)."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import autograd, gluon, gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params

    bf16 = dtype == "bfloat16"
    what = "resnet training bf16" if bf16 else "resnet training"
    tdt = getattr(torch, dtype)
    b, steps, hw = cfg["batch"], cfg["steps"], cfg["image"]
    t0 = time.perf_counter()
    net = resnet50_v1_bnrelu(classes=cfg["classes"], ctx=gpu(0), **net_kw)
    load_jax_params(net, normal_arrays(net, seed=0))
    n_params = sum(p.numel() for p in net.parameters())
    layers = net_kw.get("layers", (3, 4, 6, 3))
    per_fwd = bnrelu_launches(layers)
    log(f"resnet50_v1_bnrelu built on {next(net.parameters()).device}: "
        f"{n_params} parameters, {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(4)
    device = next(net.parameters()).device
    x = torch.from_numpy(rng.standard_normal((b, hw, hw, 3)).astype(
        np.float32)).to(device).to(tdt)
    y = torch.from_numpy(rng.randint(0, cfg["classes"], b)).to(device)
    opt = {"learning_rate": cfg["lr"], "momentum": cfg["momentum"],
           "wd": cfg["wd"]}
    if bf16:
        net.to(tdt)
        opt["multi_precision"] = True
    trainer = gluon.Trainer(net, "sgd", opt)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = dict(net.named_parameters())
    buffers = dict(net.named_buffers())

    def forward():
        with autograd.record():
            return loss_fn(net(x), y)

    # the all-plain step from the same weights and moving statistics: its
    # loss, gradients and new moving statistics are step 0's reference
    stats0 = {n: t.clone() for n, t in buffers.items()}
    with all_plain():
        loss_plain = forward()
        autograd.backward(loss_plain)
    loss_plain = float(loss_plain.detach().float().mean())
    plain_grads = {n: p.grad for n, p in params.items()}
    plain_stats = {n: t.clone() for n, t in buffers.items()}
    with torch.no_grad():
        for n, t in buffers.items():
            t.copy_(stats0[n])
    for p in params.values():
        p.grad = None
    if ref is not None and not bf16:
        ref["resnet_grads"] = {n: g.cpu() for n, g in plain_grads.items()}
    truth = ref.get("resnet_grads") if bf16 and ref is not None else None

    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the peak counts it too
    start_bytes = torch.cuda.memory_allocated()
    reset_kernel_counts()
    profiler.reset_counters()
    losses, phases, grad_err, stat_err = [], [], {}, {}
    for step in range(steps):
        t_a = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        autograd.backward(loss)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        if step == 0:
            grad_err = grad_errs(params, plain_grads, truth)
            for n, t in buffers.items():
                stat_err[n] = (
                    float((t.float() - plain_stats[n].float()).abs().max()),
                    float(plain_stats[n].float().abs().max()))
            torch.cuda.synchronize()
        t_d = time.perf_counter()
        trainer.step(b)
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        losses.append(float(loss.detach().float().mean()))
        phases.append((t_b - t_a, t_c - t_b, t_e - t_d))
    counts = kernel_counts()
    turned_away = rejections()
    trainer_steps = profiler.counters().get("mxtpu/trainer.steps")
    peak_bytes = torch.cuda.max_memory_allocated()
    # --- end of the main path ---

    ssa, mm = per_fwd["train"]
    check(counts["scale_shift_act"] == (ssa * steps, 0),
          f"{what}: scale_shift_act (launches, plain calls) "
          f"{counts['scale_shift_act']} != ({ssa} x {steps} steps, 0)")
    others = {k: v for k, v in counts.items()
              if k != "scale_shift_act" and v != (0, 0)}
    check(mm == 0 and not others,
          f"{what}: other kernels ran (none should in training): {others}")
    check(not turned_away, f"{what}: kernel selections rejected "
                           f"{turned_away}")
    check(trainer_steps == steps, f"trainer.steps {trainer_steps} != {steps}")
    log(f"{what}: {steps} steps: scale_shift_act launches "
        f"{counts['scale_shift_act'][0]} ({ssa} a step), plain calls 0, "
        f"rejections 0")
    loss_err = abs(losses[0] - loss_plain)
    worst_stat = worst_of(stat_err)
    if bf16:
        expect(loss_err <= BF16_TOL * loss_plain,
               f"{what}: step 0 loss {losses[0]} vs all-plain {loss_plain}")
        worst = check_bf16_grads(grad_err, what)
        expect(all(e == e and e <= BF16_TOL * max(scale, 1.0)
                   for e, scale in stat_err.values()),
               f"{what}: step 0 moving statistics vs all-plain bf16: "
               f"{worst_stat}")
        check(all(t.dtype == tdt for t in buffers.values()),
              f"{what}: moving statistics not in bf16")
    else:
        check(loss_err <= 1e-4 * loss_plain,
              f"step 0 loss {losses[0]} vs all-plain {loss_plain}")
        worst = worst_of(grad_err)
        check(all(np.isfinite(e) and e <= GRAD_RTOL * scale
                  for e, scale, *_ in grad_err.values()),
              f"step 0 gradients vs all-plain: {worst[0]} off by {worst[1]} "
              f"against its largest {worst[2]}")
        check(all(np.isfinite(e) and e <= 1e-5 * max(scale, 1.0)
                  for e, scale in stat_err.values()),
              f"step 0 moving statistics vs all-plain: {worst_stat}")
    log(f"{what}: step 0 vs all-plain: loss {losses[0]:.6f} vs "
        f"{loss_plain:.6f}; worst gradient {worst[0]}: {worst[1]:.3e} of "
        f"{worst[2]:.3e}; worst moving statistic {worst_stat[0]}: "
        f"{worst_stat[1]:.3e} of {worst_stat[2]:.3e}")
    log(f"{what}: losses: " + " ".join(f"{v:.4f}" for v in losses))
    check(all(np.isfinite(losses)), f"{what}: non-finite loss: {losses}")
    (expect if bf16 else check)(
        losses[-1] < 0.5 * losses[0],
        f"{what}: loss {losses[0]} -> {losses[-1]} after {steps} steps: not "
        f"below half")

    # where one step's time goes on the card (it trains on: steps 31+)
    def train_step():
        loss = forward()
        autograd.backward(loss)
        trainer.step(b)

    dev_total, per = device_ms(train_step, iters=3)
    stream = time_ms(train_step, iters=3)
    kinds = _by_kind(per)
    bf16_check = half_only(sorted(per), f"{what} step") if bf16 else None
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    timed = phases[2:] or phases
    med = [sorted(p[i] for p in timed)[len(timed) // 2] * 1e3
           for i in range(3)]
    step_ms = sorted(sum(p) for p in timed)[len(timed) // 2] * 1e3
    summary = {
        "config": dict(cfg, layers=list(layers), params=n_params,
                       dtype=dtype, tf32=False, layout="NHWC",
                       multi_precision=bf16),
        "losses": losses, "loss_plain_step0": loss_plain,
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_step": {"scale_shift_act": ssa, "mm_epilogue": mm},
        "step0_grad_worst": list(worst),
        "step0_grad_worst_norm": max(e[2] for e in grad_err.values()),
        "step0_moving_stat_worst": list(worst_stat),
        "step_ms_median": step_ms, "forward_ms_median": med[0],
        "backward_ms_median": med[1], "optimizer_ms_median": med[2],
        "images_per_s": b / (step_ms / 1e3),
        "peak_memory_bytes": peak_bytes,
        "memory_at_start_bytes": start_bytes,
        "step_device_ms": dev_total, "step_stream_ms": stream,
        "idle_share": 1.0 - dev_total / stream if stream > 0 else None,
        "step_by_kind_ms": kinds,
        "top_kernels_ms": [[n[:80], ms] for n, ms in top],
        "bf16_check": bf16_check,
    }
    if truth is not None:
        summary["step0_grad_vs_f32"] = {
            "kernels": max(e[3] for e in grad_err.values()),
            "plain": max(e[4] for e in grad_err.values())}
    detail["resnet_training_bf16" if bf16 else "resnet_training"] = summary
    log(f"{what}: " + json.dumps(
        {k: v for k, v in summary.items() if k != "losses"}))
    return summary, net


def train_resnet_fused(detail, cfg=RESNET, ref_steps=3, **net_kw):
    """ResNet-50 (resnet50_v1_bnrelu) in bf16 trained on one fixed batch
    through ``FusedTrainStep(net, SoftmaxCrossEntropyLoss(), sgd)`` with
    bench.py's recipe (momentum 0.9, wd 1e-4, multi_precision, no
    scaler), ``__call__`` 30 times, each step one replay under
    :func:`no_host_sync`. Checks one capture, 33 scale/shift/act launches
    a step (replays plus the capture's warm-up) and no other kernel, the
    moving statistics moving at each of the first replays, the loss and
    the moving statistics after `ref_steps` steps against the same steps
    run op by op (``eager_steps``), and the loss going down. Returns the
    summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import gluon, gpu, optimizer, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.parallel import FusedTrainStep

    what = "resnet fused training bf16"
    b, steps, hw = cfg["batch"], cfg["steps"], cfg["image"]
    layers = net_kw.get("layers", (3, 4, 6, 3))
    ssa = bnrelu_launches(layers)["train"][0]
    rng = np.random.RandomState(4)
    x_host = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    y_host = rng.randint(0, cfg["classes"], b)

    def build():
        net = resnet50_v1_bnrelu(classes=cfg["classes"], ctx=gpu(0), **net_kw)
        load_jax_params(net, normal_arrays(net, seed=0))
        net.to(torch.bfloat16)
        return net, optimizer.create(
            "sgd", learning_rate=cfg["lr"], momentum=cfg["momentum"],
            wd=cfg["wd"], multi_precision=True)

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net, opt = build()
    device = next(net.parameters()).device
    x = torch.from_numpy(x_host).to(device).to(torch.bfloat16)
    y = torch.from_numpy(y_host).to(device)
    eager = eager_steps(net, loss_fn, opt, x, y, ref_steps)
    eager_stats = {n: t.float().cpu() for n, t in net.named_buffers()}
    del net, opt
    torch.cuda.empty_cache()

    net, opt = build()
    step = FusedTrainStep(net, loss_fn, opt)
    buffers = dict(net.named_buffers())
    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the peak counts it too
    start_bytes = torch.cuda.memory_allocated()
    reset_kernel_counts()
    profiler.reset_counters()
    step.ensure_built(x, y)
    losses, step_ms, stats = [], [], [{n: t.clone()
                                       for n, t in buffers.items()}]
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_host_sync():
            losses.append(step(x, y))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i < ref_steps:
            stats.append({n: t.clone() for n, t in buffers.items()})
    counts = kernel_counts()
    c = profiler.counters()
    peak_bytes = torch.cuda.max_memory_allocated()
    # --- end of the main path ---

    captures = c.get("mxtpu/fused_step.captures")
    check(captures == 1, f"{what}: fused_step.captures {captures} != 1")
    check(counts["scale_shift_act"] == (ssa * (steps + 1), 0),
          f"{what}: scale_shift_act (launches, plain calls) "
          f"{counts['scale_shift_act']} != ({ssa} x ({steps} replays + the "
          f"capture's warm-up), 0)")
    others = {kd: v for kd, v in counts.items()
              if kd != "scale_shift_act" and v != (0, 0)}
    check(not others, f"{what}: other kernels ran: {others}")
    check(opt.num_update == steps, f"{what}: num_update {opt.num_update}")
    moved = [all(not torch.equal(stats[i + 1][n], stats[i][n])
                 for n in buffers) for i in range(ref_steps)]
    check(all(moved), f"{what}: moving statistics moved at the first "
                      f"replays: {moved}")
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"{what}: loss {losses[0]} -> {losses[-1]}: not down")
    loss_err = max(abs(float(a) - e) / max(abs(e), 1e-30)
                   for a, e in zip(losses[:ref_steps], eager))
    expect(loss_err <= BF16_TOL,
           f"{what}: the first {ref_steps} losses {losses[:ref_steps]} vs "
           f"the eager loop's {eager}")
    stat_err = {n: (float((stats[ref_steps][n].float().cpu()
                           - eager_stats[n]).abs().max()),
                    float(eager_stats[n].abs().max())) for n in buffers}
    worst_stat = worst_of(stat_err)
    expect(all(e <= BF16_TOL * max(scale, 1.0)
               for e, scale in stat_err.values()),
           f"{what}: moving statistics after {ref_steps} steps vs the eager "
           f"loop: {worst_stat}")
    log(f"{what}: {steps} steps, one capture, scale_shift_act {ssa} a step "
        f"({steps} replays + the warm-up), plain calls 0, no host sync; "
        f"the moving statistics moved at each of the first {ref_steps} "
        f"replays; after {ref_steps} steps vs the eager loop: losses worst "
        f"rel {loss_err:.2e}, moving statistic {worst_stat[0]} "
        f"{worst_stat[1]:.3e} of {worst_stat[2]:.3e}")
    log(f"{what}: losses: " + " ".join(f"{v:.4f}" for v in losses))

    timed = sorted(step_ms[2:])
    med = timed[len(timed) // 2]
    bd = _breakdown(lambda: step(x, y), f"{what} step")
    summary = {
        "config": dict(cfg, layers=list(layers), dtype="bfloat16",
                       multi_precision=True, layout="NHWC", loss_scaler=None),
        "losses": losses.tolist(), "eager_losses": eager,
        "loss_rel_err": loss_err, "moving_stat_worst": list(worst_stat),
        "captures": captures,
        "launches": {kd: v[0] for kd, v in counts.items()},
        "launches_per_step": {"scale_shift_act": ssa},
        "step_ms": step_ms, "step_ms_median": med,
        "images_per_s": b / (med / 1e3), "peak_memory_bytes": peak_bytes,
        "memory_at_start_bytes": start_bytes,
        "step_device_ms": bd["device_ms"], "step_stream_ms": bd["stream_ms"],
        "idle_share": bd["idle_share"], "timer": bd["timer"],
        "step_by_kind_ms": bd["by_kind_ms"],
        "top_kernels_ms": bd["top_kernels_ms"],
        "bf16_check": bd.get("half_check"),
    }
    detail["resnet_fused_training_bf16"] = summary
    log(f"{what}: " + json.dumps({kd: v for kd, v in summary.items()
                                   if kd not in ("losses", "step_ms")}))
    return summary


def fold_bn_ms(net):
    """Time of the BatchNorm folds (``fold_bn``: five small ops on each
    conv's channel vectors, one fold for each ConvBN block) that one
    predict forward of `net` makes, as they run inside a served graph:
    captured into a CUDA graph of their own and replayed back to back,
    timed by CUDA events (:func:`time_ms`). Not from the profiler: its
    traces of these 265 tiny kernels come back without the first few,
    which device_ms's count check refuses every time."""
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    bns = [m.bn for m in net.modules()
           if hasattr(m, "conv") and hasattr(m, "bn")]

    def folds():
        for bn in bns:
            cbr.fold_bn(bn.gamma, bn.beta, bn.running_mean, bn.running_var,
                        bn._eps)

    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode():
        folds()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            folds()
    return {"folds": len(bns), "graph_ms": time_ms(graph.replay)}


def serve_resnet(detail, net, cfg=RESNET, dtype="float32", ref=None,
                 **net_kw):
    """The trained network frozen and served: FrozenModel -> DynamicBatcher,
    `serve_threads` threads of `serve_per_thread` images each, in process.
    Every answer is held against a direct predict_batch of its batch and an
    all-plain forward; the zoo resnet50_v1 with the same weights against
    the network's predict logits. In bf16 the same (f32) network is frozen
    with ``compute_dtype="bfloat16"``: float32 images, cast to bf16 inside
    each bucket's graph, and float32 answers. In f16 a copy of the network
    cast to f16 (``.to(torch.float16)``, the JAX ``cast("float16")``) is
    frozen with ``compute_dtype=None`` and serves float16 images, its
    answers in float16. `ref`: a dict that the f32 phase fills with its
    answers and the 16-bit phases hold their own against."""
    import copy

    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import resnet
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    from incubator_mxnet_tpu_torch.serving import DynamicBatcher, FrozenModel

    bf16, f16 = dtype == "bfloat16", dtype == "float16"
    half = bf16 or f16
    what = "resnet serving" + {"bfloat16": " bf16", "float16": " f16"}.get(
        dtype, "")
    hw = cfg["image"]
    layers = net_kw.get("layers", (3, 4, 6, 3))
    n_threads, per_thread = cfg["serve_threads"], cfg["serve_per_thread"]
    # f16 requests are f16 images: the same ones, rounded
    imgs = np.random.RandomState(5).standard_normal(
        (n_threads * per_thread, hw, hw, 3)).astype(np.float16 if f16
                                                    else np.float32)
    ssa, mm = bnrelu_launches(layers)["predict"]
    channels = net_kw.get("channels", (64, 256, 512, 1024, 2048))
    check(len(bnrelu_gemm_shapes(layers, channels, hw)) == mm,
          "bnrelu_gemm_shapes disagrees with bnrelu_launches")
    reduces = {bk: reduces_per_forward(bk, layers, channels, hw, dtype)
               for bk in cfg["buckets"]}

    # --- the main path: counts at zero just before, read just after ---
    reset_kernel_counts()
    profiler.reset_counters()
    t_freeze = time.perf_counter()
    if f16:
        fm = FrozenModel(copy.deepcopy(net).to(torch.float16),
                         input_shape=(hw, hw, 3), dtype="float16",
                         batch_buckets=cfg["buckets"])
    else:
        fm = FrozenModel(net, input_shape=(hw, hw, 3), dtype="float32",
                         batch_buckets=cfg["buckets"], compute_dtype=dtype)
    freeze_s = time.perf_counter() - t_freeze
    batcher = DynamicBatcher(fm, max_delay_ms=5.0, queue_limit=256,
                             default_timeout_ms=60000.0).start()
    results, errors, serve_s = batcher_clients(batcher, imgs, n_threads,
                                               per_thread)
    counts = kernel_counts()
    turned_away = rejections()
    copies = cbr.nhwc_copies
    stats = DynamicBatcher.stats()
    executed = profiler.counters()["serving/serving.executed_batches"]
    compiles, compiled = graph_counts(fm)
    # --- end of the main path ---

    check(not errors, f"client errors: {errors}")
    results = [(r[0][0].astype(np.float32),) + r[1:] for r in results]
    batches = stats["serving.batches"]
    check(executed == len(fm.buckets) + batches,
          f"executed {executed} != {len(fm.buckets)} warm-ups + {batches}")
    # a bucket's eager forward before its capture launches the kernels;
    # every replay (warm-up or batch) credits the captured launches. The
    # GEMMs run the wgmma kernel in bf16 and f16 and the SIMT kernel in f32
    # (the other route's count is held to zero below)
    forwards = compiles + executed
    gemm = "mm_wgmma" if half else "mm_epilogue"
    check(counts["scale_shift_act"] == (ssa * forwards, 0),
          f"{what}: scale_shift_act {counts['scale_shift_act']} != "
          f"({ssa} x ({compiles} pre-capture forwards + {executed} "
          f"replays), 0)")
    check(counts[gemm] == (mm * forwards, 0),
          f"{what}: {gemm} {counts[gemm]} != ({mm} x "
          f"({compiles} + {executed}), 0)")
    # the split-K pass: each bucket's pre-capture forward and warm-up, and
    # each batch's bucket
    sizes = {r[1]: r[3] for r in results if r is not None}
    want = (2 * sum(reduces.values())
            + sum(reduces[fm.bucket_for(sz)] for sz in sizes.values()))
    check(counts["mm_splitk_reduce"] == (want, 0),
          f"{what}: mm_splitk_reduce {counts['mm_splitk_reduce']} != "
          f"({want}, 0) (per forward by bucket {reduces})")
    check(want > 0 or net_kw, "serving: no GEMM split K, so the reduce "
                              "kernel never ran on the main path")
    check(not turned_away, f"{what}: kernel selections rejected "
                           f"{turned_away}")
    others = {k: v for k, v in counts.items() if k not in (
        "scale_shift_act", gemm, "mm_splitk_reduce") and v != (0, 0)}
    check(not others, f"{what}: other kernels ran: {others}")
    log(f"{what}: served {len(imgs)} images: {batches} batches + {len(fm.buckets)} "
        f"warm-ups as replays of {compiled} graphs, frozen in {freeze_s:.2f}"
        f" s; scale_shift_act {counts['scale_shift_act'][0]} ({ssa}/"
        f"forward), {gemm} {counts[gemm][0]} ({mm}/forward), "
        f"mm_splitk_reduce {counts['mm_splitk_reduce'][0]} (by bucket "
        f"{reduces}) over {compiles} pre-capture forwards + {executed} "
        f"replays, rejections 0, NHWC copies {copies} (eager forwards only)")

    classes = cfg["classes"]
    for out, *_ in results:
        check(out.shape == (classes,) and np.isfinite(out).all(),
              f"served output of shape {out.shape} or not finite")
    # every answer against a direct predict_batch of its batch
    by_batch = {}
    for i, r in enumerate(results):
        by_batch.setdefault(r[1], {})[r[2]] = i
    err_direct, orders = 0.0, []
    for bid, members in by_batch.items():
        n = len(members)
        check(sorted(members) == list(range(n)) and all(
            results[i][3] == n for i in members.values()),
            f"batch {bid} is not whole: {members}")
        order = [members[j] for j in range(n)]
        orders.append(order)
        (direct,) = fm.predict_batch(imgs[order])
        direct = direct.astype(np.float32)
        for row, i in enumerate(order):
            err_direct = max(err_direct,
                             float(np.abs(results[i][0] - direct[row]).max()))
    served = np.stack([r[0] for r in results])
    scale = float(np.abs(served).max())
    check(err_direct <= 1e-5 * max(1.0, scale),
          f"served vs direct predict_batch {err_direct} (largest {scale})")
    # every answer against an all-plain predict forward on the card: in
    # bf16 and f16 the frozen module's eager forward (16-bit weights) of
    # the same batch
    device = next(net.parameters()).device
    if half:
        by_req = plain_by_batch(fm, imgs, orders)
        plain = np.stack([by_req[i][0] for i in range(len(imgs))]).astype(
            np.float32)
    else:
        with all_plain(), torch.inference_mode():
            plain = np.concatenate([
                net(torch.from_numpy(imgs[s:s + 32]).to(device)).cpu().numpy()
                for s in range(0, len(imgs), 32)])
    err_plain = float(np.abs(served - plain).max())
    tol = BF16_TOL if half else 1e-3
    (expect if half else check)(
        err_plain <= tol * max(1.0, scale),
        f"{what}: served vs all-plain forward {err_plain} (largest {scale})")
    # the zoo resnet50_v1, same weights by name, BatchNorm + relu unfused
    state = {zoo_name(k): t.detach().cpu().numpy()
             for k, t in list(net.named_parameters())
             + list(net.named_buffers())}
    if net_kw:          # a cut rehearsal: the zoo class at its widths
        zoo = resnet.ResNetV1(resnet.BottleneckV1, list(layers),
                              list(net_kw["channels"]),
                              classes=classes).to(device)
    else:
        zoo = resnet.resnet50_v1(classes=classes, ctx=gpu(0))
    load_jax_params(zoo, state)
    zx = torch.from_numpy(imgs[:8]).to(device)
    if half:
        zoo.to(getattr(torch, dtype))
        zx = zx.to(getattr(torch, dtype))
    with torch.inference_mode():
        z = zoo(zx).float().cpu().numpy()
    err_zoo = float(np.abs(z - served[:8]).max())
    zoo_norm = rel_norm(z, served[:8])
    if half:
        # the zoo's BatchNorm computes its affine in bf16 or f16 (four
        # roundings a value, as the JAX package's batch_norm does), the
        # network's fused epilogue in f32 with one: they are held by norm
        expect(zoo_norm <= ZOO_BF16_NORM,
               f"{what}: zoo resnet50_v1 vs the network's predict logits "
               f"{zoo_norm} of their norm (max {err_zoo})")
    else:
        check(err_zoo <= tol * max(1.0, scale),
              f"{what}: zoo resnet50_v1 vs the network's predict logits "
              f"{err_zoo}")
    vs_f32 = None
    if not half and ref is not None:
        ref["resnet"] = served
    if half and ref is not None and "resnet" in ref:
        vs_f32 = rel_norm(served, ref["resnet"])
        expect(vs_f32 <= BF16_VS_F32,
               f"{what}: {dtype} answers vs f32 answers {vs_f32} of their "
               f"norm")
    log(f"{what}: served answers vs direct predict_batch {err_direct:.2e}, "
        f"vs all-plain {err_plain:.2e}, zoo resnet50_v1 vs network "
        f"{err_zoo:.2e} ({zoo_norm:.2e} of the norm; largest logit "
        f"{scale:.2f}); vs the f32 answers {vs_f32} of their norm")

    replay_err, replay_identical = check_replays(fm, imgs, what)
    exec_ms = exec_ms_by_bucket(fm, imgs, what)
    big = fm.buckets[-1]
    breakdown = {bk: forward_breakdown(fm, imgs, bk, half and what, dtype)
                 for bk in (fm.buckets[0], big)}
    # the folds of the frozen module: from bf16 moving statistics in bf16
    fold = fold_bn_ms(fm._module)
    small = breakdown[fm.buckets[0]]["replay"]
    log(f"{what}: the BatchNorm folds of one forward ({fold['folds']}"
        f" ConvBNReLU calls) {fold['graph_ms']:.4f} ms as a graph of their "
        f"own, {fold['graph_ms'] / small['device_ms']:.1%} of a bucket-"
        f"{fm.buckets[0]} replay's {small['device_ms']:.4f} ms of device "
        f"time")
    lat = sorted(r[4] for r in results)
    summary = {
        "dtype": dtype, "images": len(imgs), "threads": n_threads,
        "per_thread": per_thread, "images_per_s": len(imgs) / serve_s,
        "latency_p50_ms": lat[len(lat) // 2], "latency_max_ms": lat[-1],
        "batches": batches, "mean_batch": len(imgs) / batches,
        "executed_batches": executed, "freeze_s": freeze_s,
        "compiles": compiles, "compiled_buckets": compiled,
        "replay_vs_eager_worst": replay_err,
        "replay_bit_identical": replay_identical, "bn_fold": fold,
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_forward": {"scale_shift_act": ssa, gemm: mm,
                                 "mm_splitk_reduce_by_bucket": reduces},
        "nhwc_copies": copies,
        "max_err_vs_direct": err_direct, "max_err_vs_plain": err_plain,
        "max_err_zoo": err_zoo, "zoo_rel_norm": zoo_norm,
        "largest_logit": scale,
        "vs_f32_rel_norm": vs_f32,
        "exec_ms_by_bucket": exec_ms,
        "forward_breakdown": breakdown,
    }
    detail["resnet_serving" + {"bfloat16": "_bf16", "float16": "_f16"}.get(
        dtype, "")] = summary
    log(f"{what}: " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# float16: BERT-base and ResNet-50 served, GPT-2-base trained (the f16
# ResNet-50 phase is serve_resnet's dtype="float16"); the space-to-depth
# stem; dropout in a frozen forward
# ---------------------------------------------------------------------------

# The f16 phases' bounds are the bf16 phases' of the same checks (f16 keeps
# 11 significant bits to bf16's 8, so none is looser): BF16_TOL against the
# all-plain f16 run (BERT's answers BERT_BF16_TOL), BF16_VS_F32 against the
# f32 answers, ZOO_BF16_NORM for the zoo network.
# GPT-2's step-0 comparison runs under this static loss scale, at which
# neither the kernels' step nor the all-plain one overflows f16. On the
# card (NVIDIA H100 80GB HBM3) the step-0 gradients of GPT-2-base on this
# batch overflow f16 at every scale above 2**5 (the largest unscaled value
# of the backward lies between 1023 and 2047: the dynamic scaler skipped
# steps 0-10, backing off from 2**16 to 2**5 with the weights unchanged),
# so 2**10 gave NaN distances on both sides; 2**4 leaves one halving of
# room
F16_STEP0_SCALE = 2.0 ** 4
# The kernels' f16 step-0 gradients against the all-plain f16 ones, each by
# its worst relative distance (norm) to the f32 step: the kernels round P
# and dS to f16 where the Pallas kernels do, the all-plain autograd path
# rounds dP at its casts, and every GEMM rounds alike on both sides. On an
# H100 both were farthest on pos_embedding.weight, at 9.495e-4 and
# 9.490e-4 (5e-4 of each other): the two sit at one distance up to the
# rounding noise, and which is nearer is a coin toss. The kernels' may be
# farther by this share of the all-plain one's, 20 times that gap
F16_NEAR_SLACK = 1e-2
# the dynamic loss scaler's first scale (amp.DynamicLossScaler's default)
# and the one forced onto a step to overflow it
F16_INIT_SCALE, F16_OVERFLOW_SCALE = 2.0 ** 16, 2.0 ** 30


def serve_bert_f16(detail, ref=None, n_threads=8, per_thread=4):
    """BERT-base served in float16, as the JAX package serves a
    ``cast("float16")`` block: the f32 phase's weights, the module cast with
    ``.to(torch.float16)`` and frozen with ``compute_dtype=None`` (int32
    ids, buckets 1..32, one CUDA graph each), served in process through
    DynamicBatcher, `n_threads` threads of `per_thread` requests. Checks
    every answer against predict_batch of its batch, against the frozen
    module's all-plain f16 forward and against the f32 phase's answers
    (`ref`); each bucket's replay against its eager forward; 12
    flash-forward and 25 layer-norm launches a forward, no plain call, no
    other kernel and no rejected selection; and a bucket-16 replay's trace
    (the f16 instances only, every GEMM in f16, the wgmma flash forward).
    Returns the summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models.bert import get_bert_model
    from incubator_mxnet_tpu_torch.serving import DynamicBatcher, FrozenModel

    what = "serving f16"
    net = get_bert_model("bert_12_768_12", vocab_size=30522, max_length=512,
                         use_pooler=True, ctx=gpu(0))
    load_jax_params(net, normal_arrays(net, seed=0))
    net.to(torch.float16)
    units = net.word_embed.weight.shape[1]
    n = n_threads * per_thread
    # the f32 phase's first n requests
    ids = np.random.RandomState(1).randint(
        0, 30522, (N_CLIENTS * PER_CLIENT, SEQ)).astype(np.int32)[:n]

    # --- the main path: counts at zero just before, read just after ---
    reset_kernel_counts()
    profiler.reset_counters()
    t_freeze = time.perf_counter()
    fm = FrozenModel(net, input_shape=(SEQ,), dtype="int32")
    freeze_s = time.perf_counter() - t_freeze
    batcher = DynamicBatcher(fm, max_delay_ms=5.0, queue_limit=256,
                             default_timeout_ms=60000.0).start()
    results, errors, serve_s = batcher_clients(batcher, ids, n_threads,
                                               per_thread)
    every = kernel_counts()
    turned_away = rejections()
    stats = DynamicBatcher.stats()
    executed = profiler.counters()["serving/serving.executed_batches"]
    compiles, compiled = graph_counts(fm)
    # --- end of the main path ---

    check(not errors, f"{what}: client errors: {errors}")
    batches = stats["serving.batches"]
    check(executed == len(fm.buckets) + batches,
          f"{what}: executed {executed} != {len(fm.buckets)} warm-ups + "
          f"{batches} batches")
    forwards = compiles + executed
    check(every["flash_fwd"] == (12 * forwards, 0),
          f"{what}: flash launches {every['flash_fwd']} != 12 x "
          f"({compiles} pre-capture forwards + {executed} replays)")
    check(every["layer_norm"] == (25 * forwards, 0),
          f"{what}: layer_norm launches {every['layer_norm']} != 25 x "
          f"({compiles} + {executed})")
    others = {k: v for k, v in every.items()
              if k not in ("flash_fwd", "layer_norm") and v != (0, 0)}
    check(not others, f"{what}: other kernels ran: {others}")
    check(not turned_away, f"{what}: kernel selections rejected "
                           f"{turned_away}")
    log(f"{what}: {n} requests: {batches} batches + {len(fm.buckets)} "
        f"warm-ups as replays of {compiled} graphs, frozen in "
        f"{freeze_s:.2f} s; flash launches {every['flash_fwd'][0]} "
        f"(12/forward), layer_norm launches {every['layer_norm'][0]} "
        f"(25/forward), no plain call, no rejection")

    served = []
    for (seq, pooled), *_ in results:
        check(seq.dtype == pooled.dtype == np.float16
              and seq.shape == (SEQ, units) and pooled.shape == (units,),
              f"{what}: answers {seq.dtype} {seq.shape}, {pooled.shape}")
        check(np.isfinite(seq).all() and np.isfinite(pooled).all(),
              f"{what}: non-finite output")
        served.append((seq.astype(np.float32), pooled.astype(np.float32)))
    by_batch = {}
    for i, r in enumerate(results):
        by_batch.setdefault(r[1], {})[r[2]] = i
    err_direct, orders = 0.0, []
    for bid, members in by_batch.items():
        k = len(members)
        check(sorted(members) == list(range(k)) and all(
            results[i][3] == k for i in members.values()),
            f"{what}: batch {bid} is not whole: {members}")
        order = [members[j] for j in range(k)]
        orders.append(order)
        direct = fm.predict_batch(ids[order])
        for row, i in enumerate(order):
            for o in (0, 1):
                err_direct = max(err_direct, float(np.abs(
                    served[i][o] - direct[o][row].astype(np.float32)).max()))
    check(err_direct <= 1e-4, f"{what}: served vs direct predict_batch "
                              f"{err_direct}")
    plain = plain_by_batch(fm, ids, orders)
    err_plain, largest = 0.0, 0.0
    for i, (seq, pooled) in enumerate(served):
        for got, want in ((seq, plain[i][0]), (pooled, plain[i][1])):
            want = want.astype(np.float32)
            largest = max(largest, float(np.abs(want).max()))
            err_plain = max(err_plain, float(np.abs(got - want).max()))
    expect(err_plain <= BERT_BF16_TOL * largest,
           f"{what}: served vs all-plain f16 {err_plain} (largest "
           f"{largest})")
    vs_f32 = None
    if ref is not None and "bert" in ref:
        vs_f32 = max(rel_norm(np.stack([a[k] for a in served]),
                              np.stack([a[k] for a in ref["bert"][:n]]))
                     for k in (0, 1))
        expect(vs_f32 <= BF16_VS_F32,
               f"{what}: f16 answers vs f32 answers {vs_f32} of their norm")
    log(f"{what}: served vs direct predict_batch {err_direct:.2e}, vs "
        f"all-plain f16 {err_plain:.3e} (largest {largest:.2f}); vs the f32 "
        f"answers {vs_f32} of their norm")
    replay_err, replay_identical = check_replays(fm, ids, what)
    br = forward_breakdown(fm, ids, 16, what, "float16")
    fwd = wgmma_forward_traced(br["replay"]["half_check"],
                               f"{what} bucket 16 replay")
    log(f"{what}: bucket 16 replay's trace: flash forward kernels {fwd}")
    lat = sorted(r[4] for r in results)
    summary = {
        "dtype": "float16", "requests": n, "threads": n_threads,
        "per_thread": per_thread, "requests_per_s": n / serve_s,
        "latency_p50_ms": lat[len(lat) // 2], "latency_max_ms": lat[-1],
        "batches": batches, "mean_batch": n / batches,
        "executed_batches": executed, "freeze_s": freeze_s,
        "compiles": compiles, "compiled_buckets": compiled,
        "replay_vs_eager_worst": replay_err,
        "replay_bit_identical": replay_identical,
        "launches": {k: v[0] for k, v in every.items()},
        "max_err_vs_direct": err_direct, "max_err_vs_plain": err_plain,
        "largest_plain": largest, "vs_f32_rel_norm": vs_f32,
        "forward_breakdown_b16": br,
    }
    detail["serving_f16"] = summary
    log(f"{what}: " + json.dumps(summary))
    return summary


def train_lm_f16(detail, cfg=LM, ref=None, **model_kw):
    """GPT-2-base trained in float16 by MXNet's mixed-precision recipe for
    GPUs: ``amp.init("float16")``, the module cast to f16, Adam with f32
    masters (``multi_precision``) under a CosineScheduler (3 warm-up
    steps), ``amp.init_trainer`` with a ``DynamicLossScaler(2**16)`` and
    ``amp.scale_loss``; every ``trainer.step`` under sync debug "error".
    The step is the eager Trainer's: the fused step (FusedTrainStep,
    TrainLoop) takes no loss scaler in either package, and f16 needs one.
    Checks step 0's loss and gradients, under a static scale of
    F16_STEP0_SCALE, against an all-plain f16 step from the same weights
    and no farther from the f32 step's (`ref`) than the all-plain ones (up
    to F16_NEAR_SLACK); 12
    flash-forward, 12 dQ, 12 dK/dV and 25 layer-norm launches a step and no
    plain call; the loss halved in 30 steps (the skipped steps and the
    final scale reported); one step forced to overflow (scale
    F16_OVERFLOW_SCALE) skipped with every weight unchanged bit for bit
    and the scale halved; and a step's trace (the f16 instances only, no
    GEMM in f32, the wgmma flash kernels). Returns the summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import (amp, autograd, gluon, gpu,
                                           lr_scheduler, profiler)
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import lm_loss, transformer_lm_base

    what = "training f16"
    b, seq, steps = cfg["batch"], cfg["seq"], cfg["steps"]
    net = transformer_lm_base(cfg["vocab_size"], ctx=gpu(0), **model_kw)
    load_jax_params(net, normal_arrays(net, seed=0))
    n_layers = len(net.layers)
    ids, _ = lm_tokens(b, seq, cfg["vocab_size"], cfg["period"])
    x = torch.from_numpy(ids).to(next(net.parameters()).device)
    amp.init("float16")
    net.to(getattr(torch, amp.target_dtype()))
    params = dict(net.named_parameters())

    def forward():
        with autograd.record():
            return lm_loss(net(x), x)

    def backward(loss, trainer):
        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)

    def make_trainer(scaler, sched=None):
        opt = {"learning_rate": cfg["lr"], "multi_precision": True}
        if sched is not None:
            opt["lr_scheduler"] = sched
        return amp.init_trainer(gluon.Trainer(net, "adam", opt), scaler)

    # step 0 under a static scale, all-plain then the kernels' path
    probe = make_trainer(amp.LossScaler(F16_STEP0_SCALE))
    with all_plain():
        loss_plain = forward()
        backward(loss_plain, probe)
    loss_plain = float(loss_plain.detach().float().mean())
    plain_grads = {k: p.grad for k, p in params.items()}
    for p in params.values():
        p.grad = None
    loss0 = forward()
    backward(loss0, probe)
    loss0 = float(loss0.detach().float().mean())
    truth = None
    if ref is not None and "lm_grads" in ref:
        truth = {k: g * F16_STEP0_SCALE for k, g in ref["lm_grads"].items()}
    grad_err = grad_errs(params, plain_grads, truth)
    for p in params.values():
        p.grad = None
    del probe, plain_grads, truth

    sched = lr_scheduler.CosineScheduler(
        max_update=steps, base_lr=cfg["lr"], warmup_steps=FUSED_WARMUP,
        warmup_begin_lr=cfg["lr"] / 10)
    scaler = amp.DynamicLossScaler(init_scale=F16_INIT_SCALE)
    trainer = make_trainer(scaler, sched)

    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    reset_kernel_counts()
    profiler.reset_counters()
    losses, scales, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = forward()
        backward(loss, trainer)
        with no_host_sync():
            trainer.step(b)
        losses.append(loss.detach().float().mean())
        scales.append(scaler._scale_dev.clone())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernel_counts()
    trainer_steps = profiler.counters().get("mxtpu/trainer.steps")
    # --- end of the main path ---

    losses = [float(v) for v in losses]
    scales = [float(v) for v in scales]
    before = [F16_INIT_SCALE] + scales[:-1]
    skipped = [i for i, (a, s) in enumerate(zip(before, scales)) if s < a]
    per_step = {"flash_fwd": n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers, "layer_norm": 2 * n_layers + 1}
    for kind in counts:
        k = per_step.get(kind, 0)
        check(counts[kind] == (k * steps, 0),
              f"{what}: {kind} (launches, plain calls) {counts[kind]} != "
              f"({k} x {steps} steps, 0)")
    check(trainer_steps == steps, f"{what}: trainer.steps {trainer_steps} "
                                  f"!= {steps}")
    check(all(np.isfinite(losses)), f"{what}: non-finite loss: {losses}")
    expect(abs(loss0 - loss_plain) <= BF16_TOL * loss_plain,
           f"{what}: step 0 loss {loss0} vs all-plain {loss_plain}")
    worst = check_bf16_grads(grad_err, what, dt="f16")
    near = None
    if all(len(v) == 5 for v in grad_err.values()):
        # no farther from the f32 step than the all-plain f16 step, up to
        # the rounding noise between the two (F16_NEAR_SLACK)
        near = [max(e[i] for e in grad_err.values()) for i in (3, 4)]
        expect(near[0] <= near[1] * (1.0 + F16_NEAR_SLACK),
               f"{what}: step 0 gradients' worst distance to the f32 step "
               f"{near[0]}, the all-plain f16 step's {near[1]}")
    expect(losses[-1] < 0.5 * losses[0],
           f"{what}: loss {losses[0]} -> {losses[-1]} after {steps} steps: "
           f"not below half")
    log(f"{what}: {steps} steps: launches per step " + ", ".join(
        f"{k} {counts[k][0] // steps}" for k in per_step)
        + f", plain calls 0; step 0 vs all-plain at scale "
          f"{F16_STEP0_SCALE:g}: loss {loss0:.6f} vs {loss_plain:.6f}, "
          f"distance to the f32 step (kernels, all-plain) {near}; skipped "
          f"steps {skipped}, final scale {scales[-1]:g}")
    log(f"{what}: losses: " + " ".join(f"{v:.4f}" for v in losses))

    # one step forced to overflow: skipped, the weights bit for bit, the
    # scale halved
    kept = {k: p.detach().clone() for k, p in params.items()}
    scaler.loss_scale = F16_OVERFLOW_SCALE
    loss = forward()
    backward(loss, trainer)
    with no_host_sync():
        trainer.step(b)
    moved = [k for k, p in params.items() if not torch.equal(p, kept[k])]
    after = scaler.loss_scale
    check(not moved and after == F16_OVERFLOW_SCALE / 2,
          f"{what}: a step at scale {F16_OVERFLOW_SCALE:g} moved {moved[:3]} "
          f"({len(moved)} weights) and left the scale at {after:g}")
    log(f"{what}: a step at scale {F16_OVERFLOW_SCALE:g} overflowed and was "
        f"skipped: every weight bit for bit, the scale backed off to "
        f"{after:g}")
    del kept

    def train_step():
        backward(forward(), trainer)
        trainer.step(b)

    dev_total, per = device_ms(train_step, iters=3)
    stream = time_ms(train_step, iters=3)
    half_check = half_only(sorted(per), f"{what} step", "float16")
    fwd = wgmma_forward_traced(half_check, f"{what} step")
    bwd = flash_backward_traced(half_check, f"{what} step")
    log(f"{what}: the step's trace: flash forward {fwd}, dQ "
        f"{bwd['flash_bwd_dq']}, dK/dV {bwd['flash_bwd_dkv']}")
    amp.init()          # the package's default target dtype again
    timed = sorted(times[2:] or times)
    step_ms = timed[len(timed) // 2]
    summary = {
        "config": dict(cfg, layers=n_layers, units=net._units,
                       dtype="float16", multi_precision=True,
                       loss_scaler="dynamic", init_scale=F16_INIT_SCALE,
                       schedule="cosine", warmup=FUSED_WARMUP),
        "losses": losses, "loss_plain_step0": loss_plain,
        "loss_step0": loss0, "step0_scale": F16_STEP0_SCALE,
        "step0_grad_worst": list(worst), "step0_grad_vs_f32": near,
        "skipped_steps": skipped, "final_scale": scales[-1],
        "overflow_step": {"scale": F16_OVERFLOW_SCALE, "moved": len(moved),
                          "scale_after": after},
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_step": per_step, "step_ms_median": step_ms,
        "tokens_per_s": b * seq / (step_ms / 1e3),
        "step_device_ms": dev_total, "step_stream_ms": stream,
        "idle_share": 1.0 - dev_total / stream if stream > 0 else None,
        "step_by_kind_ms": _by_kind(per), "half_check": half_check,
    }
    detail["training_f16"] = summary
    log(f"{what}: " + json.dumps({k: v for k, v in summary.items()
                                   if k != "losses"}))
    return summary


# The s2d network's step-0 stem-weight gradient against the standard
# network's, by norm. The stems alone agree to about 7e-7 of their largest
# (forward and weight gradient, held at 1e-5 and 1e-4 by resnet_s2d), and
# the standard network run twice gives the same gradient; but a trained
# ResNet-50 in training mode turns rounding-sized differences of the stem
# output into ReLU masks that flip somewhere in its 49 later layers, and
# each flip moves the gradient. On an H100 the two networks' gradients
# differed by 0.80% of the norm (0.68% of the largest element) at batch
# 32, and the standard network against itself with its stem output moved
# by 2**-24 N(0, 1), relative (half an f32 unit), by about as much:
# resnet_s2d measures both. This allows 2.5 times the first
S2D_GRAD_NORM = 2e-2


def resnet_s2d(detail, net, cfg=RESNET, steps=10, **net_kw):
    """The zoo ResNet-50 with the space-to-depth stem (``resnet50_v1(
    stem_s2d=True)``) against the zoo's standard stem, both carrying the
    trained network's weights (`net`, :func:`resnet50_v1_bnrelu`, by
    :func:`zoo_name`): the standard network's state dict loads into the s2d
    one as it is (the same names and shapes); the two stems alone on the
    path's 32 images, in f32 (TF32 off): the forward within 1e-5 and the
    weight gradient of sum(y * cot) within 1e-4 of their largest (the JAX
    package's rule for the stem); the networks' f32 forward within 1e-4 of
    the largest logit, and step 0's loss within 1e-6 and stem-weight
    gradient within S2D_GRAD_NORM of the standard one's (by norm: see
    there); the two frozen in bf16 (``compute_dtype="bfloat16"``, buckets
    1, 8, 32) within BF16_TOL of the largest logit at every bucket; then
    `steps` bf16 SGD steps of the s2d network through FusedTrainStep (one
    capture), the loss falling. Returns the summary."""
    import copy

    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import autograd, gluon, gpu, optimizer
    from incubator_mxnet_tpu_torch import profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import resnet
    from incubator_mxnet_tpu_torch.parallel import FusedTrainStep
    from incubator_mxnet_tpu_torch.serving import FrozenModel

    what = "resnet s2d stem"
    classes, hw, batch = cfg["classes"], cfg["image"], 32
    layers = net_kw.get("layers", (3, 4, 6, 3))
    channels = net_kw.get("channels", (64, 256, 512, 1024, 2048))
    device = next(net.parameters()).device
    state = {zoo_name(k): t.detach().cpu().numpy()
             for k, t in list(net.named_parameters())
             + list(net.named_buffers())}

    def zoo(stem_s2d):
        if net_kw:      # a cut rehearsal: the zoo class at its widths
            z = resnet.ResNetV1(resnet.BottleneckV1, list(layers),
                                list(channels), classes=classes,
                                stem_s2d=stem_s2d)
            return z.to(device)
        return resnet.resnet50_v1(classes=classes, stem_s2d=stem_s2d,
                                  ctx=gpu(0))

    std = load_jax_params(zoo(False), state)
    s2d = zoo(True)
    s2d.load_state_dict(std.state_dict())
    check(isinstance(s2d.features[0], resnet.SpaceToDepthStem)
          and torch.equal(s2d.features[0].weight, std.features[0].weight),
          f"{what}: the standard stem's state dict did not load")
    imgs = np.random.RandomState(7).standard_normal(
        (batch, hw, hw, 3)).astype(np.float32)
    x = torch.from_numpy(imgs).to(device)
    with torch.inference_mode():
        y_std, y_s2d = std(x), s2d(x)
    scale = float(y_std.abs().max())
    err = float((y_s2d - y_std).abs().max())
    check(bool(torch.isfinite(y_s2d).all()) and err <= 1e-4 * max(1.0, scale),
          f"{what}: f32 forward vs the standard stem {err} (largest logit "
          f"{scale})")
    # the stems alone, forward and weight gradient
    cot = torch.from_numpy(np.random.RandomState(9).standard_normal(
        tuple(std.features[0](x[:1]).shape[1:])).astype(np.float32)).to(
            device)
    stem = []
    for m in (std, s2d):
        w = m.features[0].weight
        w.grad = None
        y = m.features[0](x)
        (y * cot).sum().backward()
        stem.append((y.detach(), w.grad.clone()))
        w.grad = None
    stem_err = [float((b_ - a).abs().max()) / float(a.abs().max())
                for a, b_ in zip(stem[0], stem[1])]
    check(stem_err[0] <= 1e-5 and stem_err[1] <= 1e-4,
          f"{what}: the stems alone, forward and weight gradient off by "
          f"{stem_err} of their largest")
    # step 0's loss and stem-weight gradient, f32, training mode, with the
    # masks of the network's ReLU layers; then the standard network with
    # its stem output moved by half an f32 unit of noise (see
    # S2D_GRAD_NORM)
    labels = torch.from_numpy(np.random.RandomState(8).randint(
        0, classes, batch)).to(device)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    noise = torch.randn(tuple(stem[0][0].shape), device=device,
                        generator=torch.Generator(device=device).manual_seed(
                            3)) * 2.0 ** -24

    def step0(m, moved=False):
        masks = []
        hooks = [a.register_forward_hook(
            lambda mod, inp, out: masks.append(out > 0))
            for a in m.modules() if isinstance(a, gluon.nn.Activation)]
        if moved:
            hooks.append(m.features[0].register_forward_hook(
                lambda mod, inp, out: out * (1.0 + noise)))
        m.features[0].weight.grad = None
        with autograd.record():
            loss = loss_fn(m(x), labels).mean()
        autograd.backward(loss)
        for h in hooks:
            h.remove()
        return float(loss), m.features[0].weight.grad.clone(), masks

    stats = {k: b.clone() for k, b in std.named_buffers()}
    (l_std, g_std, m_std), (l_s2d, g_s2d, m_s2d), (_, g_ctl, m_ctl) = (
        step0(std), step0(s2d), step0(std, moved=True))
    with torch.no_grad():      # the moving statistics as they were
        for m in (std, s2d):
            for k, b in m.named_buffers():
                b.copy_(stats[k])

    def apart(g, masks):
        return (float(torch.linalg.vector_norm(g - g_std)
                      / torch.linalg.vector_norm(g_std)),
                sum(int((a != b).sum()) for a, b in zip(masks, m_std)))
    (g_norm, flips), (ctl_norm, ctl_flips) = (apart(g_s2d, m_s2d),
                                              apart(g_ctl, m_ctl))
    g_scale = float(g_std.abs().max())
    g_err = float((g_s2d - g_std).abs().max())
    losses0 = [l_std, l_s2d]
    check(abs(l_s2d - l_std) <= 1e-6 * abs(l_std)
          and g_norm <= S2D_GRAD_NORM,
          f"{what}: step 0 loss {losses0} and stem-weight gradient vs the "
          f"standard stem's {g_norm} of its norm (max {g_err} of "
          f"{g_scale}; {flips} ReLU mask elements flipped)")
    log(f"{what}: the standard stem's state dict loads as it is; the stems "
        f"alone: forward and weight gradient off by {stem_err[0]:.2e} and "
        f"{stem_err[1]:.2e} of their largest; f32 forward of {batch} images "
        f"vs the standard stem {err:.2e} (largest logit {scale:.2f}); step "
        f"0 losses {losses0}, stem-weight gradient {g_norm:.2e} of its norm "
        f"(max {g_err:.2e} of {g_scale:.2e}) with {flips} ReLU mask "
        f"elements flipped; the standard network with its stem output "
        f"moved by 2**-24 N(0, 1): {ctl_norm:.2e} of the norm, {ctl_flips} "
        f"flipped")
    # both frozen in bf16
    profiler.reset_counters()
    buckets = (1, 8, 32)
    frozen = [FrozenModel(m, input_shape=(hw, hw, 3), dtype="float32",
                          batch_buckets=buckets, compute_dtype="bfloat16")
              for m in (std, s2d)]
    bf16_err, bf16_scale = {}, 0.0
    for bk in buckets:
        a, b_ = (fm.predict_batch(imgs[:bk])[0] for fm in frozen)
        bf16_scale = max(bf16_scale, float(np.abs(a).max()))
        bf16_err[bk] = float(np.abs(b_ - a).max())
        check(np.isfinite(b_).all(), f"{what}: non-finite bf16 answers")
    worst = max(bf16_err.values())
    expect(worst <= BF16_TOL * max(1.0, bf16_scale),
           f"{what}: bf16 frozen vs the standard stem's by bucket {bf16_err} "
           f"(largest {bf16_scale})")
    compiles = profiler.counters().get("serving/serving.compiles")
    check(compiles == 2 * len(buckets),
          f"{what}: {compiles} captures for two models of {len(buckets)} "
          f"buckets")
    log(f"{what}: frozen in bf16 at buckets {buckets}: vs the standard "
        f"stem's answers by bucket {bf16_err} (largest {bf16_scale:.2f})")
    del frozen
    # the s2d network trained in bf16 through the fused step
    s2d_bf16 = copy.deepcopy(s2d).to(torch.bfloat16)
    del std, s2d
    step = FusedTrainStep(s2d_bf16, loss_fn, optimizer.create(
        "sgd", learning_rate=cfg["lr"], momentum=0.9, wd=1e-4,
        multi_precision=True))
    profiler.reset_counters()
    xb = x.to(torch.bfloat16)
    losses = [step(xb, labels) for _ in range(steps)]
    losses = [float(v) for v in losses]
    captures = profiler.counters().get("mxtpu/fused_step.captures")
    check(captures == 1, f"{what}: {captures} fused-step captures")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{what}: bf16 fused-step losses {losses}: not falling")
    log(f"{what}: {steps} bf16 SGD steps through FusedTrainStep, one "
        f"capture: losses " + " ".join(f"{v:.4f}" for v in losses))
    summary = {"batch": batch, "stem_alone_rel_err": stem_err,
               "f32_forward_err": err, "largest_logit": scale,
               "step0_losses": losses0, "step0_stem_grad_err": g_err,
               "step0_stem_grad_largest": g_scale,
               "step0_stem_grad_rel_norm": g_norm,
               "relu_mask_flips": flips,
               "control_moved_stem_rel_norm": ctl_norm,
               "control_relu_mask_flips": ctl_flips,
               "bf16_frozen_err_by_bucket": bf16_err,
               "bf16_largest": bf16_scale, "fused_bf16_losses": losses,
               "captures": captures}
    detail["resnet_s2d"] = summary
    return summary


def frozen_dropout_always(detail, units=(1024, 4096, 1024)):
    """A frozen forward that draws (C9): two Dense layers around
    ``Dropout(0.5, mode="always")``, weights from numpy, frozen on the card
    (buckets 1, 8, 32). The JAX FrozenModel passes ``PRNGKey(0)`` on every
    call, so the mask is fixed: one capture a bucket, two calls of a bucket
    the same bits, every replay within 1e-6 of the largest output of its
    eager forward (run_eager, the generator set back to its seed), the
    answers unlike the rate-0 module's, and the device's own generator
    (``random.generator``) unchanged. Returns the summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import gluon, gpu, profiler, random
    from incubator_mxnet_tpu_torch.serving import FrozenModel

    what = "frozen dropout always"
    d_in, hidden, d_out = units
    buckets = (1, 8, 32)

    def module(rate):
        rng = np.random.RandomState(11)
        m = torch.nn.Sequential(torch.nn.Linear(d_in, hidden),
                                gluon.nn.Dropout(rate, mode="always"),
                                torch.nn.ReLU(), torch.nn.Linear(hidden, d_out))
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(rng.normal(
                    0.0, 0.05, tuple(p.shape)).astype(np.float32)))
        return m

    xs = np.random.RandomState(12).standard_normal(
        (buckets[-1], d_in)).astype(np.float32)
    gen = random.generator(gpu(0))
    state = gen.get_state()
    profiler.reset_counters()
    fm = FrozenModel(module(0.5), input_shape=(d_in,), dtype="float32",
                     batch_buckets=buckets, ctx=gpu(0))
    compiles, compiled = graph_counts(fm)
    same = all(np.array_equal(fm.predict_batch(xs[:b])[0],
                              fm.predict_batch(xs[:b])[0]) for b in buckets)
    check(same, f"{what}: two calls of a bucket gave different bits")
    replay_err, replay_identical = check_replays(fm, xs, what)
    rate0 = FrozenModel(module(0.0), input_shape=(d_in,), dtype="float32",
                        batch_buckets=buckets, ctx=gpu(0))
    apart = float(np.abs(fm.predict_batch(xs)[0]
                         - rate0.predict_batch(xs)[0]).max())
    check(apart > 1e-3, f"{what}: the answers are the rate-0 module's "
                        f"(max difference {apart})")
    check(torch.equal(gen.get_state(), state),
          f"{what}: the device's generator moved")
    log(f"{what}: {compiles} captures for {len(buckets)} buckets; two calls "
        f"a bucket bit-identical; replays vs eager {replay_err:.2e} "
        f"({'bit-identical' if replay_identical else 'not bit-identical'}); "
        f"vs rate 0 apart by {apart:.3f}; random.generator(gpu(0)) "
        f"unchanged")
    summary = {"buckets": list(buckets), "compiles": compiles,
               "compiled_buckets": compiled,
               "replay_vs_eager_worst": replay_err,
               "replay_bit_identical": replay_identical,
               "vs_rate0_max_diff": apart}
    detail["frozen_dropout_always"] = summary
    return summary


GLUON_RESNET = dict(batch=128, image=224, classes=1000, steps=30, lr=0.01,
                    momentum=0.9, wd=1e-4, grad_add_batch=64, serve=(32, 8),
                    bert_batch=8, bert_replays=5)
# MXNet's image-classification recipe: Xavier, gaussian, fan-in, magnitude 2
XAVIER = dict(rnd_type="gaussian", factor_type="in", magnitude=2)
# a drawn weight's std against sqrt(2 / fan_in) (_fans): one draw of at
# least 9408 values (the stem) misses by under 1% three sigmas out
XAVIER_TOL = 0.05
# a replay against the eager forward, of the largest output
REPLAY_TOL = 1e-6
# ResNet-50 cast to bf16 against its f32 answers, of their norm
GLUON_BF16_NORM = 2e-2


def jax_deferred(name):
    """Whether the JAX zoo's ResNet v1 defers the parameter `name` (a
    structural name): the stem conv (models/resnet.py:194-196), every
    BatchNorm (`_bn`, :79) and the inner convs of each block (`_conv`
    without in_channels, :21-23)."""
    leaf = name.rsplit(".", 1)[-1]
    return (name == "features.0.weight"
            or leaf in ("gamma", "beta", "running_mean", "running_var")
            or name.endswith(("body.3.weight", "body.6.weight")))


# grad_req="add" over two half batches against one full batch, of each
# gradient's largest, held in f64: in f32 cuDNN's weight gradients of a
# batch and of its halves sum in other orders and parted by 8.3e-5 of the
# largest (conv2d_51weight, batch 128, cuDNN deterministic), which says
# nothing of the accumulation
GRAD_ADD_TOL = 1e-5


def _grads(net, loss_fn, batches, req):
    """Every trained parameter's gradient (``p.grad()``, as a tensor) after
    backwards over `batches` ((x, y) NDArray pairs) in predict mode with
    grad_req `req`, from None."""
    import torch
    from incubator_mxnet_tpu_torch import autograd
    params = net.collect_params()
    trained = [p for p in params.values() if p.grad_req != "null"]
    for p in trained:
        p.data().torch().grad = None
    params.setattr("grad_req", req)
    with autograd.record(train_mode=False):
        for xb, yb in batches:
            loss_fn(net(xb), yb).backward()
    params.setattr("grad_req", "write")
    out = {p.name: p.grad().torch().clone() for p in trained}
    for p in trained:
        p.data().torch().grad = None
    torch.cuda.synchronize()
    return out


def nd_err(got, want):
    """max |got - want| / max |want| of two NDArrays."""
    return max_err(got.torch(), want.torch()) / max(
        float(want.torch().abs().max()), 1e-30)


def _worst_gap(got, want):
    """(name, max |got - want| / max |want|) of the worst parameter."""
    worst = (None, 0.0)
    for n, w in want.items():
        off = float((got[n] - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30)
        if off > worst[1]:
            worst = (n, off)
    return worst


def grad_add_check(net, loss_fn, x, y):
    """grad_req="add" on a copy of `net` cast to f64, over the two halves
    of (x, y), against one backward of the whole batch (in f32, cuDNN sums
    the two batch sizes in other orders). Returns the worst gap."""
    import copy
    import torch
    h = x.shape[0] // 2
    net64 = copy.deepcopy(net).cast("float64")
    x = x.astype("float64")
    halves = [(x[:h], y[:h]), (x[h:], y[h:])]
    gap = _worst_gap(_grads(net64, loss_fn, halves, "add"),
                     _grads(net64, loss_fn, [(x, y)], "write"))
    del net64
    torch.cuda.empty_cache()
    return gap


def gluon_resnet(detail, cfg=GLUON_RESNET, layers=None, channels=None,
                 bert_config="bert_12_768_12"):
    """ResNet-50 v1 the MXNet way, through NDArrays (the zoo network, plain
    BatchNorm + ReLU, NHWC, f32, TF32 off; batches ``nd.array(...,
    ctx=gpu(0))``, the network, the loss and the metrics given NDArrays,
    ``p.data()`` and ``p.grad()`` read as NDArrays): ``get_resnet(1, 50)``
    with deferred shapes ->
    ``initialize(init.Xavier(gaussian, in, 2), ctx=gpu(0))`` -> a first
    forward that completes them -> ``hybridize()`` -> ``Trainer(
    collect_params(), "sgd")`` for `steps` eager steps under ``record()``
    (``loss.backward()``, ``trainer.step``) with ``metric.Accuracy``,
    ``TopKAccuracy(5)`` and ``CrossEntropy`` against numpy ->
    ``grad_req="add"`` over two half batches against one
    full batch -> ``save_parameters`` -> a fresh net's ``load_parameters
    (ctx=gpu(0))``, hybridized, replaying at the `serve` batches in predict
    mode against the trained net's eager forward, ``set_data`` reaching the
    next replay -> ``cast("bfloat16")``; then BERT-base hybridized in
    predict mode, given NDArray ids and types, its replays against its
    eager forward, with their flash-attention and layer-norm launches
    counted, and its eager and replayed forwards timed. `layers` and
    `channels` cut the ResNet (a rehearsal); `bert_config` names the BERT.
    Returns the summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import (autograd, gluon, gpu, init,
                                           metric, nd, random)
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.gluon.block import NameManager
    from incubator_mxnet_tpu_torch.initializer import _fans
    from incubator_mxnet_tpu_torch.models import resnet
    from incubator_mxnet_tpu_torch.models.bert import get_bert_model

    what = "gluon resnet"
    b, steps, hw, classes = (cfg["batch"], cfg["steps"], cfg["image"],
                             cfg["classes"])

    def build():
        if layers is None:
            return resnet.get_resnet(1, 50, classes=classes)
        return resnet.ResNetV1(resnet.BottleneckV1, list(layers),
                               list(channels), classes=classes).to(
                                   gpu(0).device)

    # 1. deferred shapes, as the JAX package's net shows them
    NameManager.reset()
    net = build()
    params = net._collect_params_with_prefix()
    deferred = sorted(n for n, p in params.items() if 0 in p.shape)
    want = sorted(n for n in params if jax_deferred(n))
    check(deferred == want and len(deferred) > 0,
          f"{what}: deferred {len(deferred)} parameters, the JAX package "
          f"{len(want)}: {sorted(set(deferred) ^ set(want))[:6]}")
    log(f"{what}: get_resnet(1, 50): {len(params)} parameters, "
        f"{len(deferred)} with deferred shapes (0s), as the JAX zoo's")

    # 2. initialize, then the first forward completes every shape
    rng = np.random.RandomState(6)
    x = nd.array(rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
                 ctx=gpu(0))
    y = nd.array(rng.randint(0, classes, b), ctx=gpu(0))
    random.seed(0)
    net.initialize(init.Xavier(**XAVIER), ctx=gpu(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with autograd.pause():
        net(x)
    nd.waitall()
    first_forward_s = time.perf_counter() - t0
    check(not any(0 in p.shape for p in params.values())
          and all(p.data().context == gpu(0) for p in params.values()),
          f"{what}: shapes left deferred or off the card after the first "
          f"forward")
    worst_std = (None, 0.0)
    for n, p in params.items():
        t = p.data()
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "weight":
            want_std = math.sqrt(2.0 / _fans(tuple(t.shape), "in"))
            # the sample std (n - 1), as torch's std, which this check
            # read before it read NDArrays
            m = t.size
            std = float(t.astype("float64").std().asscalar()) * math.sqrt(
                m / (m - 1))
            off = abs(std / want_std - 1.0)
            if off > worst_std[1]:
                worst_std = (n, off)
        elif leaf == "gamma":
            check(bool(nd.all(t == 1)), f"{what}: {n} not ones")
        elif leaf == "beta":
            check(bool(nd.all(t == 0)), f"{what}: {n} not zeros")
    check(worst_std[1] <= XAVIER_TOL,
          f"{what}: weight std {worst_std[0]} {worst_std[1]:.3%} off "
          f"sqrt(2 / fan_in)")
    log(f"{what}: the first forward (batch {b}) completed every shape in "
        f"{first_forward_s:.3f} s; weight stds within {worst_std[1]:.3%} of "
        f"sqrt(2 / fan_in) (worst {worst_std[0]}); gammas ones, betas "
        f"zeros")

    # 3. hybridize, then eager training steps with the metrics
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": cfg["lr"], "momentum": cfg["momentum"],
        "wd": cfg["wd"]})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    acc, top5, ce = metric.Accuracy(), metric.TopKAccuracy(5), \
        metric.CrossEntropy()
    sums = np.zeros(3)
    losses, step_s, accs = [], [], []
    lab = y.asnumpy()
    for step in range(steps):
        nd.waitall()
        t_a = time.perf_counter()
        with autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        trainer.step(b)
        nd.waitall()
        step_s.append(time.perf_counter() - t_a)
        check(isinstance(out, nd.NDArray) and isinstance(loss, nd.NDArray),
              f"{what}: net(x) and the loss answered {type(out)} and "
              f"{type(loss)} to NDArrays")
        losses.append(float(loss.mean().asscalar()))
        probs = nd.softmax(out.astype("float32"))
        for m in (acc, top5, ce):
            m.update([y], [probs])
        p = probs.asnumpy().astype(np.float64)
        sums += [(p.argmax(-1) == lab).sum(),
                 sum(l in t for l, t in zip(
                     lab, np.argsort(-p, -1, kind="stable")[:, :5])),
                 (-np.log(p[np.arange(b), lab] + 1e-12)).sum()]
        got = [acc.get()[1], top5.get()[1], ce.get()[1]]
        check(np.allclose(got, sums / (b * (step + 1)), rtol=1e-6, atol=0),
              f"{what}: step {step} metrics {got} vs numpy "
              f"{list(sums / (b * (step + 1)))}")
        accs.append(float((p.argmax(-1) == lab).mean()))
    log(f"{what}: losses: " + " ".join(f"{v:.4f}" for v in losses))
    log(f"{what}: batch accuracy " + " ".join(f"{a:.3f}" for a in accs)
        + f"; metrics {acc.get()}, {top5.get()}, {ce.get()} equal numpy's")
    check(all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0],
          f"{what}: loss {losses[0]} -> {losses[-1]} after {steps} steps: "
          f"not below half")
    check(accs[-1] > accs[0], f"{what}: accuracy {accs[0]} -> {accs[-1]} "
                              f"did not rise")
    timed = sorted(step_s[2:] or step_s)
    step_ms = timed[len(timed) // 2] * 1e3

    # 4. grad_req="add": two half batches against one full batch (the
    # first grad_add_batch images: the f64 copy's activations fit beside
    # the f32 net's)
    nb = cfg["grad_add_batch"]
    worst_add = grad_add_check(net, loss_fn, x[:nb], y[:nb])
    check(worst_add[1] <= GRAD_ADD_TOL,
          f"{what}: grad_req='add' over two halves vs the full batch (f64): "
          f"{worst_add[0]} {worst_add[1]:.3e} of its largest")
    log(f"{what}: grad_req='add' over two half batches of {nb // 2} equals "
        f"one batch of {nb} within {worst_add[1]:.3e} of each gradient's "
        f"largest in f64 (worst {worst_add[0]})")

    # 5. save, reload into a fresh net, replay hybridized in predict mode
    path = OUT_DIR / "gluon_resnet.params"
    net.save_parameters(str(path))
    net.hybridize(False)
    xs = {n: x[:n].copy() for n in cfg["serve"]}
    with autograd.pause():
        eager = {n: net(xs[n]) for n in cfg["serve"]}
    del trainer
    fresh = build()
    fresh.load_parameters(str(path), ctx=gpu(0))
    path.unlink()
    fresh.hybridize()
    errs = {}
    with autograd.pause():
        for rnd in range(2):
            for n in cfg["serve"]:
                got = fresh(xs[n])
                errs[n] = nd_err(got, eager[n])
            check(fresh.captures == len(cfg["serve"]),
                  f"{what}: {fresh.captures} captures after round {rnd}, "
                  f"not one a signature ({len(cfg['serve'])})")
    check(all(e <= REPLAY_TOL for e in errs.values()),
          f"{what}: reloaded replays vs the trained net's eager forward "
          f"{errs} over {REPLAY_TOL} of the largest")
    # the trained net (the same weights) runs eagerly beside the replays:
    # hybridize(False) would drop the fresh net's graphs
    n32, n8 = cfg["serve"][0], cfg["serve"][-1]
    with autograd.pause():
        hybrid_ms = time_ms(lambda: fresh(xs[n32]), iters=20)
        eager_ms = time_ms(lambda: net(xs[n32]), iters=20)
        before = fresh(xs[n8])
        for m in (fresh, net):
            w = m.collect_params()[m.output.prefix + "weight"]
            w.set_data(w.data() * 0.5)
        after = fresh(xs[n8])
        want_after = net(xs[n8])
    set_err = nd_err(after, want_after)
    check(bool(nd.any(before != after)) and set_err <= REPLAY_TOL
          and fresh.captures == len(cfg["serve"]),
          f"{what}: set_data did not reach the next replay (err {set_err}, "
          f"captures {fresh.captures})")
    log(f"{what}: reloaded from save_parameters, hybridized: "
        f"{fresh.captures} captures for batches {list(cfg['serve'])} over "
        f"two rounds; replays vs the trained net's eager forward "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } of the largest; "
        f"set_data reached the next replay ({set_err:.2e})")

    # 6. cast to bf16, hybridized, against the f32 answer of its weights
    with autograd.pause():
        f32_out = fresh(xs[n32])
    fresh.cast("bfloat16")
    with autograd.pause():
        half_out = fresh(xs[n32].astype("bfloat16"))
    bf16_norm = rel_norm(half_out.asnumpy(), f32_out.asnumpy())
    expect(bf16_norm <= GLUON_BF16_NORM,
           f"{what}: bf16 cast vs f32 {bf16_norm:.4f} of the norm over "
           f"{GLUON_BF16_NORM}")
    log(f"{what}: cast('bfloat16') hybridized: {bf16_norm:.4%} of the f32 "
        f"norm (bound {GLUON_BF16_NORM}), captures {fresh.captures}")
    del fresh, net, eager
    gc.collect()
    torch.cuda.empty_cache()

    # 7. BERT-base hybridized in predict mode: its kernels inside a graph
    bert = get_bert_model(bert_config, vocab_size=30522, max_length=512,
                          use_pooler=True, ctx=gpu(0))
    load_jax_params(bert, normal_arrays(bert, seed=0))
    n_cells = len(bert.encoder.cells)
    ids = nd.array(np.random.RandomState(7).randint(
        0, 30522, (cfg["bert_batch"], SEQ)).astype(np.int32), ctx=gpu(0))
    types = nd.zeros_like(ids)
    with autograd.pause():
        seq_e, pooled_e = bert(ids, types)
        bert_eager_ms = time_ms(lambda: bert(ids, types), iters=10)
        bert.hybridize()
        bert(ids, types)             # the capture
        # --- the main path: counts at zero just before, read just after ---
        reset_kernel_counts()
        outs = [bert(ids, types) for _ in range(cfg["bert_replays"])]
        nd.waitall()
        counts = kernel_counts()
        # --- end of the main path ---
        bert_replay_ms = time_ms(lambda: bert(ids, types), iters=10)
    r = cfg["bert_replays"]
    check(counts["flash_fwd"] == (n_cells * r, 0)
          and counts["layer_norm"] == ((2 * n_cells + 1) * r, 0),
          f"{what}: BERT replays launched flash {counts['flash_fwd']}"
          f" and layer norm {counts['layer_norm']}, not "
          f"{n_cells} and {2 * n_cells + 1} a replay")
    bert_err = max(max(nd_err(s_, seq_e), nd_err(p_, pooled_e))
                   for s_, p_ in outs)
    check(all(isinstance(o, nd.NDArray) for pair in outs for o in pair),
          f"{what}: BERT answered {type(outs[0][0])} to NDArrays")
    check(bert_err <= REPLAY_TOL and bert.captures == 1,
          f"{what}: BERT replays vs eager {bert_err} over {REPLAY_TOL} "
          f"(captures {bert.captures})")
    log(f"{what}: {bert_config} hybridized at {cfg['bert_batch']} x {SEQ}: "
        f"one capture, {r} replays within {bert_err:.2e} of the eager "
        f"forward, {counts['flash_fwd'][0] // r} flash-forward and "
        f"{counts['layer_norm'][0] // r} layer-norm launches a replay; "
        f"eager forward {bert_eager_ms:.3f} ms, replay {bert_replay_ms:.3f} "
        f"ms")
    del bert, outs
    card = gpu_name_and_limit()
    summary = {
        "config": dict(cfg, layers=list(layers or (3, 4, 6, 3)),
                       dtype="float32", tf32=False, layout="NHWC",
                       init=dict(XAVIER), network="zoo resnet50_v1"),
        "card": card,
        "deferred_params": len(deferred), "params": len(params),
        "first_forward_s": first_forward_s,
        "xavier_worst_std_off": list(worst_std),
        "losses": losses, "batch_accuracy": accs,
        "metrics": {m.get()[0]: m.get()[1] for m in (acc, top5, ce)},
        "step_ms_median": step_ms, "images_per_s": b / (step_ms / 1e3),
        "grad_add_worst_f64": list(worst_add),
        "replay_errs": errs, "set_data_err": set_err,
        "hybrid_forward_ms_b32": hybrid_ms, "eager_forward_ms_b32": eager_ms,
        "bf16_cast_norm": bf16_norm, "bert_replay_err": bert_err,
        "bert_eager_forward_ms": bert_eager_ms,
        "bert_replay_ms": bert_replay_ms, "through": "NDArray",
        "launches": {"flash_fwd": counts["flash_fwd"][0],
                     "layer_norm": counts["layer_norm"][0]},
    }
    detail["gluon_resnet"] = summary
    log(f"{what}: eager step {step_ms:.2f} ms ({b / (step_ms / 1e3):.1f} "
        f"images/s); batch {n32} forward hybridized {hybrid_ms:.3f} ms, "
        f"eager {eager_ms:.3f} ms; first forward {first_forward_s:.3f} s "
        f"({card})")
    return summary


# ---------------------------------------------------------------------------
# the rest of autograd (A.5b): grad, pause, predict_mode, a user Function,
# a gradient penalty, and a second derivative through attention
# ---------------------------------------------------------------------------

# grad against backward, predict_mode against the eval forward, a user
# Function against torch.sigmoid: within this share of each largest value
AUTOGRAD_TOL = 1e-6
# the gradient penalty on the card (f32, TF32 off) against the CPU in
# float64: each gradient's distance, relative to its norm
PENALTY_RTOL = 1e-4
# the penalty's MLP: Dense(4096, tanh) -> LayerNorm -> Dense(1), batch 256;
# the user Function's net: Dense(2048) -> sigmoid -> Dense(2048), batch 256
PENALTY = dict(units=4096, batch=256)
FUNCTION_NET = dict(units=2048, batch=256)


class MXSigmoid:
    """MXNet's documented custom Function (python/mxnet/autograd.py):
    sigmoid, its forward saving y for its backward. Made an
    ``autograd.Function`` subclass by :func:`mx_sigmoid`, which imports the
    port."""

    def forward(self, x):
        import torch
        y = 1 / (1 + torch.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self.saved_tensors
        return dy * y * (1 - y)


def mx_sigmoid():
    from incubator_mxnet_tpu_torch import autograd
    return type("sigmoid", (MXSigmoid, autograd.Function), {})()


def autograd_api(detail, cfg=LM):
    """The rest of the port's autograd on the card, in f32: (1) GPT-2-base
    at 8 x 512: ``grad(loss, params)`` against the ``.grad`` that
    ``backward`` writes from the same graph (AUTOGRAD_TOL of each
    parameter's largest), ``grad`` leaving every ``.grad`` None, the
    launches of the two (12 flash forwards, 24 dQ and dK/dV, 25 layer
    norms, no plain call); (2) ``pause()`` inside ``record()``: flags off,
    an LM forward with no graph; (3) BERT pretraining's forward (dropout
    0.1) under ``record()`` + ``predict_mode()`` against its eval forward
    (AUTOGRAD_TOL), and in training mode unlike it; (4) MXNet's sigmoid as
    a user ``Function`` between two 2048-wide Dense layers: the gradients
    against the same net with ``torch.sigmoid`` (AUTOGRAD_TOL); (5) a
    gradient penalty, ||df/dx||^2 with ``create_graph=True`` through a
    4096-wide MLP with LayerNorm (its kernel forward, its closed-form
    backward recorded) at batch 256, backpropagated: every gradient
    against the same computation on the CPU in float64 (PENALTY_RTOL);
    (6) a second derivative through the flash attention at head dims 64
    and 512 raises (the Function is once differentiable), as ``jax.grad``
    of ``jax.grad`` through the Pallas kernels does. Returns the summary,
    with (1)'s launches."""
    import copy

    import torch
    from incubator_mxnet_tpu_torch import autograd, gluon, gpu
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import (BERTForPretrain,
                                                  bert_12_768_12, lm_loss,
                                                  transformer_lm_base)
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

    what = "autograd_api"
    summary = {}
    # (1) grad against backward, one graph
    net = transformer_lm_base(cfg["vocab_size"], ctx=gpu(0))
    load_jax_params(net, normal_arrays(net, seed=0))
    device = next(net.parameters()).device
    ids, _ = lm_tokens(cfg["batch"], cfg["seq"], cfg["vocab_size"],
                       cfg["period"])
    x = torch.from_numpy(ids).to(device)
    params = {n: p for n, p in net.named_parameters() if p.requires_grad}
    for p in params.values():
        p.grad = None
    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    with autograd.record():
        loss = lm_loss(net(x), x).mean()
    grads = autograd.grad(loss, list(params.values()), retain_graph=True)
    untouched = all(p.grad is None for p in params.values())
    autograd.backward(loss)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = kernel_counts()
    # --- end of the main path ---
    check(untouched, f"{what}: grad wrote a .grad")
    per_run = {"flash_fwd": 12, "flash_bwd_dq": 24, "flash_bwd_dkv": 24,
               "layer_norm": 25}
    for kind, n in counts.items():
        check(n == (per_run.get(kind, 0), 0),
              f"{what}: {kind} (launches, plain calls) {n} != "
              f"({per_run.get(kind, 0)}, 0): a forward, then grad's "
              f"backward and backward's")
    errs = {n: (float((g - p.grad).abs().max()), float(p.grad.abs().max()))
            for (n, p), g in zip(params.items(), grads)}
    worst = worst_of(errs)
    check(all(e <= AUTOGRAD_TOL * sc for e, sc in errs.values()),
          f"{what}: grad against backward: {worst[0]} off by {worst[1]} of "
          f"its largest {worst[2]}")
    log(f"{what}: GPT-2-base grad(loss, {len(params)} params) against "
        f"backward's .grad: worst {worst[0]} {worst[1]:.3e} of "
        f"{worst[2]:.3e}; .grad untouched by grad; launches "
        + ", ".join(f"{k} {v[0]}" for k, v in counts.items() if v[0])
        + f"; {step_s * 1e3:.1f} ms forward, grad and backward")
    summary.update(grad_vs_backward=worst, grad_launches={
        k: v[0] for k, v in counts.items()}, grad_step_ms=step_s * 1e3)

    # (2) pause() inside record()
    with autograd.record():
        with autograd.pause():
            inner = (autograd.is_recording(), autograd.is_training(),
                     torch.is_grad_enabled())
            paused = net(x[:1, :64])
        outer = (autograd.is_recording(), autograd.is_training(),
                 torch.is_grad_enabled())
    check(inner == (False, False, False) and outer == (True, True, True)
          and paused.grad_fn is None and not paused.requires_grad,
          f"{what}: pause() inside record(): flags {inner} then {outer}, "
          f"output grad_fn {paused.grad_fn}")
    log(f"{what}: pause() inside record(): no recording, no training, no "
        f"graph on the output; record's flags back after")
    for p in params.values():
        p.grad = None
    del net, params, grads, loss, paused
    gc.collect()
    torch.cuda.empty_cache()

    # (3) predict_mode() inside record(): BERT pretraining, dropout 0.1
    pcfg = BERT_PRETRAIN
    bert = BERTForPretrain(bert_12_768_12(
        vocab_size=pcfg["vocab_size"], max_length=pcfg["max_length"],
        use_pooler=True, dropout=pcfg["dropout"], ctx=gpu(0)),
        pcfg["vocab_size"])
    load_jax_params(bert, normal_arrays(bert, seed=0))
    ids, tt, vl, pos, _, _ = (torch.from_numpy(a).to(device)
                              for a in pretrain_batch(pcfg))
    with torch.no_grad():
        eval_out = bert(ids, tt, vl, pos)
    with autograd.record():
        with autograd.predict_mode():
            pm_out = bert(ids, tt, vl, pos)
        train_out = bert(ids, tt, vl, pos)
    pm_gap = max(float((a.detach() - e).abs().max()) / float(e.abs().max())
                 for a, e in zip(pm_out, eval_out))
    train_gap = max(float((a.detach() - e).abs().max())
                    / float(e.abs().max())
                    for a, e in zip(train_out, eval_out))
    check(pm_gap <= AUTOGRAD_TOL and pm_out[0].requires_grad,
          f"{what}: BERT pretraining under record() + predict_mode() "
          f"{pm_gap} of the largest off its eval forward")
    check(train_gap > 1e-3, f"{what}: BERT pretraining in training mode "
                            f"only {train_gap} off its eval forward: no "
                            f"dropout")
    log(f"{what}: BERT pretraining (dropout {pcfg['dropout']}) under "
        f"record() + predict_mode(): {pm_gap:.3e} of the largest off the "
        f"eval forward, recorded; training mode {train_gap:.3e} off")
    summary.update(predict_mode_gap=pm_gap, train_mode_gap=train_gap)
    del bert, eval_out, pm_out, train_out
    gc.collect()
    torch.cuda.empty_cache()

    # (4) a user Function between two Dense layers
    u, nb = FUNCTION_NET["units"], FUNCTION_NET["batch"]
    dense = gluon.nn.HybridSequential(gluon.nn.Dense(u, in_units=u),
                                      gluon.nn.Dense(u, in_units=u))
    load_jax_params(dense, normal_arrays(dense, seed=1, sigma=0.05))
    dense.to(device)
    gen = torch.Generator(device="cuda").manual_seed(6)
    xs = torch.randn(nb, u, generator=gen, device="cuda")
    dparams = dict(dense.named_parameters())

    def function_grads(act):
        for p in dparams.values():
            p.grad = None
        with autograd.record():
            y = dense[1](act(dense[0](xs)))
        autograd.backward((y * y).mean())
        return {n: p.grad.clone() for n, p in dparams.items()}
    user = function_grads(lambda t: mx_sigmoid()(t))
    builtin = function_grads(torch.sigmoid)
    ferrs = {n: (float((user[n] - builtin[n]).abs().max()),
                 float(builtin[n].abs().max())) for n in user}
    fworst = worst_of(ferrs)
    check(all(e <= AUTOGRAD_TOL * sc for e, sc in ferrs.values()),
          f"{what}: the user sigmoid's gradients against torch.sigmoid's: "
          f"{fworst[0]} off by {fworst[1]} of its largest {fworst[2]}")
    log(f"{what}: MXNet's sigmoid as a user Function between two "
        f"{u}-wide Dense layers, batch {nb}: gradients against "
        f"torch.sigmoid's, worst {fworst[0]} {fworst[1]:.3e} of "
        f"{fworst[2]:.3e}")
    summary["function_vs_sigmoid"] = fworst
    del dense, dparams, xs, user, builtin

    # (5) a gradient penalty through LayerNorm, on the card and in float64
    u, nb = PENALTY["units"], PENALTY["batch"]
    mlp = gluon.nn.HybridSequential(
        gluon.nn.Dense(u, activation="tanh", in_units=u),
        gluon.nn.LayerNorm(in_channels=u), gluon.nn.Dense(1, in_units=u))
    arrays = normal_arrays(mlp, seed=2, sigma=1.0 / math.sqrt(u))
    gen = torch.Generator().manual_seed(7)
    x64 = torch.randn(nb, u, generator=gen, dtype=torch.float64)
    arrays = {n: a + 0.1 * torch.randn(a.shape, generator=gen).numpy()
              if n.endswith(("gamma", "beta", "bias")) else a
              for n, a in arrays.items()}
    load_jax_params(mlp, arrays)
    mlp64 = copy.deepcopy(mlp).to(torch.float64)
    mlp.to(device)

    def penalty(model, xin):
        leaf = xin.clone().requires_grad_()
        for p in model.parameters():
            p.grad = None
        with autograd.record():
            f = model(leaf).sum()
            gx = autograd.grad(f, leaf, create_graph=True)
            h = (gx * gx).sum()
        autograd.backward(h)
        return h.detach(), {n: p.grad for n, p in model.named_parameters()}
    reset_kernel_counts()
    h_card, g_card = penalty(mlp, x64.float().to(device))
    torch.cuda.synchronize()
    ln_launches = kernel_counts()["layer_norm"]
    h_cpu, g_cpu = penalty(mlp64, x64)
    check(ln_launches == (1, 0), f"{what}: the penalty's layer norm "
                                 f"(launches, plain calls) {ln_launches}")
    # the last bias does not reach df/dx: no gradient on either side
    unreached = sorted(n for n, g in g_cpu.items() if g is None)
    check(all(g_card[n] is None for n in unreached),
          f"{what}: the penalty reached {unreached} on the card only")
    gaps = {n: float(torch.linalg.vector_norm(g_card[n].cpu().double()
                                              - g_cpu[n])
                     / torch.linalg.vector_norm(g_cpu[n]))
            for n in g_cpu if n not in unreached}
    gaps["penalty"] = abs(float(h_card) - float(h_cpu)) / abs(float(h_cpu))
    far = max(gaps, key=gaps.get)
    check(all(v <= PENALTY_RTOL for v in gaps.values()),
          f"{what}: the gradient penalty on the card against float64 on the "
          f"CPU: {far} {gaps[far]} relative")
    log(f"{what}: gradient penalty ||df/dx||^2 through Dense({u}, tanh), "
        f"LayerNorm, Dense(1) at batch {nb}, create_graph=True: the card "
        f"(f32, layer-norm kernel forward) against float64 on the CPU, "
        f"farthest {far} {gaps[far]:.3e} relative (penalty "
        f"{float(h_cpu):.6e})")
    summary.update(penalty_gaps=gaps, penalty=float(h_cpu))
    del mlp, mlp64, g_card, g_cpu

    # (6) a second derivative through attention raises, never a zero
    raised = {}
    for d in (64, 512):
        q, k, v = (torch.randn(1, 2, 64, d, generator=gen).to(device)
                   for _ in range(3))
        leaf = q.requires_grad_()
        before = fa.launches, fa.dq_launches
        with autograd.record():
            o = fa.flash_attention(leaf, k, v, causal=True)
            g = autograd.grad((o * o).sum(), leaf, create_graph=True)
            pen = (g * g).sum()
        check((fa.launches, fa.dq_launches) == (before[0] + 1,
                                                before[1] + 1),
              f"{what}: attention at D = {d} did not run its kernels")
        try:
            autograd.backward(pen)
        except RuntimeError as e:
            raised[d] = str(e).splitlines()[0][:120]
        check(d in raised and "once_differentiable" in raised[d],
              f"{what}: a second derivative through attention at D = {d} "
              f"did not raise (q.grad {leaf.grad})")
    log(f"{what}: a second derivative through attention raises at D = 64 "
        f"and 512: {raised[512]}")
    summary["attention_second_derivative"] = raised
    summary["launches"] = summary["grad_launches"]
    detail["autograd_api"] = summary
    return summary


# ---------------------------------------------------------------------------
# the nd API on the card: MXNet's minimal flow, the CPU parity table, and
# nd.save / nd.load
# ---------------------------------------------------------------------------

# a parity case's f32 answer on the card against the port's on the CPU:
# within ND_RTOL of each value, and ND_ATOL for values that cross zero
ND_RTOL, ND_ATOL = 1e-5, 1e-6
# the minimal flow: x of (4096, 1024) uniform draws, y = x . w_true with
# w_true uniform too, `steps` steps of lr; its losses against the same
# descent written in torch on the card
ND_FLOW = dict(rows=4096, cols=1024, steps=10, lr=1e-3)
ND_FLOW_RTOL = 1e-4


def _parity_cases():
    """tests/nd_parity_cases.py: the table the CPU tests hold against the
    JAX package (numpy only)."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import nd_parity_cases
    finally:
        sys.path.pop(0)
    return nd_parity_cases


def _nd_outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def nd_api(detail, flow=ND_FLOW):
    """The nd API on the card: the minimal flow, every parity case on the
    card against the CPU, the funnel's cost an op, nd.save / nd.load and
    nd.waitall(). Returns the summary."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import autograd, cpu, gpu, nd, random
    what = "nd_api"
    summary = {}

    # (1) the minimal flow: linear regression by attach_grad and record
    random.seed(0)
    n, d, lr = flow["rows"], flow["cols"], flow["lr"]
    x = nd.random.uniform(shape=(n, d), ctx=gpu(0))
    w_true = nd.random.uniform(shape=(d,), ctx=gpu(0))
    y = nd.dot(x, w_true)
    w = nd.zeros((d,), ctx=gpu(0))
    w.attach_grad()
    losses = []
    nd.waitall()
    t0 = time.perf_counter()
    for _ in range(flow["steps"]):
        with autograd.record():
            loss = ((nd.dot(x, w) - y) ** 2).mean()
        loss.backward()
        w[:] = w - lr * w.grad
        losses.append(loss.asscalar())
    flow_ms = (time.perf_counter() - t0) * 1e3 / flow["steps"]
    xt, yt = x.torch(), y.torch()
    wt, plain = torch.zeros(d, device=xt.device), []
    for _ in range(flow["steps"]):
        r = xt @ wt - yt
        plain.append(float((r * r).mean()))
        wt = wt - lr * (2.0 / n) * (xt.T @ r)
    flow_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    check(losses[-1] <= 0.5 * losses[0]
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"{what}: the minimal flow's loss went {losses}, not halved")
    check(flow_err <= ND_FLOW_RTOL,
          f"{what}: the minimal flow's losses {losses} are {flow_err:.2e} "
          f"off the same descent in torch {plain}")
    t = w.torch()
    check(t.is_leaf and t.requires_grad and w.context == gpu(0),
          f"{what}: w left the card or stopped being a leaf that takes a "
          f"gradient ({w.context}, leaf {t.is_leaf})")
    log(f"{what}: minimal flow on ({n}, {d}): loss {losses[0]:.4g} -> "
        f"{losses[-1]:.4g} in {flow['steps']} steps, within "
        f"{flow_err:.2e} of the same descent in torch; {flow_ms:.3f} ms a "
        f"step with the host's read of the loss")
    summary.update(flow_losses=losses, flow_err=flow_err,
                   flow_step_ms=flow_ms)
    del x, y, w, xt, yt, wt

    # (2) the parity table: the card against the port on the CPU
    cases = _parity_cases()
    host = cases.inputs()
    worst, checked = (None, 0.0), 0
    for name, fn in cases.CASES.items():
        with gpu(0):
            got = _nd_outs(fn(nd, cases.Arrays(nd, host)))
        with cpu():
            want = _nd_outs(fn(nd, cases.Arrays(nd, host)))
        check(len(got) == len(want), f"{what}: {name} gave {len(got)} "
              f"outputs on the card, {len(want)} on the CPU")
        for g, c in zip(got, want):
            check(g.context == gpu(0) and g.dtype == c.dtype
                  and g.shape == c.shape,
                  f"{what}: {name} answered {g.dtype} {g.shape} on "
                  f"{g.context}, not {c.dtype} {c.shape} on the card")
            gv, cv = g.asnumpy(), c.asnumpy()
            if np.issubdtype(cv.dtype, np.floating):
                ok = np.allclose(gv, cv, rtol=ND_RTOL, atol=ND_ATOL,
                                 equal_nan=True)
                fin = np.isfinite(cv) & (cv != 0)
                rel = (float(np.max(np.abs(gv[fin] - cv[fin])
                                    / np.abs(cv[fin]))) if fin.any()
                       else 0.0)
                if rel > worst[1]:
                    worst = (name, rel)
            else:
                ok = np.array_equal(gv, cv)
            if not ok:
                raise SmokeError(
                    f"{what}: {name} on the card is off the CPU's answer: "
                    f"{gv.ravel()[:8]} against {cv.ravel()[:8]}")
            checked += 1
    log(f"{what}: {len(cases.CASES)} parity cases, {checked} arrays, on "
        f"the card equal to the port on the CPU (f32 within {ND_RTOL} "
        f"relative, worst {worst[1]:.2e} in {worst[0]}; integers and "
        f"booleans exact)")
    summary.update(parity_cases=len(cases.CASES), parity_arrays=checked,
                   parity_worst=worst)

    # (3) the funnel's cost: one nd op against the same torch op (host
    # bound at this size, so the times are the host's)
    a = nd.array(host["a"], ctx=gpu(0))
    b = nd.array(host["b"], ctx=gpu(0))
    at, bt = a.torch(), b.torch()
    nd_us = time_ms(lambda: a + b, iters=2000) * 1e3
    torch_us = time_ms(lambda: at + bt, iters=2000) * 1e3
    log(f"{what}: a + b on (3, 4): {nd_us:.2f} us as NDArrays, "
        f"{torch_us:.2f} us as tensors")
    summary.update(add_us_ndarray=nd_us, add_us_tensor=torch_us)

    # (4) nd.save then nd.load on the card, in the three forms
    path = OUT_DIR / "nd_api.nd"
    f32 = nd.array(host["t3"], ctx=gpu(0))
    i32 = nd.array(host["i"], ctx=gpu(0))
    for form, data in (("single", f32), ("list", [f32, i32]),
                       ("dict", {"w": f32, "ids": i32})):
        nd.save(str(path), data)
        back = nd.load(str(path), ctx=gpu(0))
        with gpu(0):
            scoped = nd.load(str(path))
        for got in (back, scoped):
            if form == "dict":
                check(list(got) == list(data),
                      f"{what}: nd.load gave keys {list(got)}")
                pairs = [(got[k], data[k]) for k in data]
            else:
                pairs = list(zip(got, data)) if form == "list" else [
                    (got, data)]
            check(type(got) is type(data) and all(
                g.context == gpu(0) and g.dtype == v.dtype
                and np.array_equal(g.asnumpy(), v.asnumpy())
                for g, v in pairs),
                f"{what}: nd.load of a saved {form} is not what was saved")
    path.unlink()
    nd.waitall()
    log(f"{what}: nd.save / nd.load on the card in the three forms, and "
        f"nd.waitall()")
    detail["nd_api"] = summary
    return summary


def kernel_line(records, paths):
    """The {"kernels": [...]} record: each kernel at its main path's shape,
    f32, with its bf16 numbers at the same shape beside them (under
    "bf16"), and its launches on each main path, f32 and bf16 (`paths`:
    path name -> its summary, whose "launches" holds every kernel's count;
    a bf16 path's name ends in "_bf16", an f16 path's in "_f16"), and its
    f16 instance's numbers at the same shape (under "f16"). Then an entry
    of its own for the f16 instance of each kernel function that an f16
    path runs (the "_f16" entries: their numbers at the same shapes, their
    launches on the f16 paths, which the other entries do not count; the
    SIMT GEMM's f16 instance, which no f16 path runs, stands under
    mm_epilogue's "f16"). The wgmma GEMM runs in bf16 only among the
    others:
    its entry's numbers are bf16, and the SIMT GEMM's bf16 numbers are
    those of its forced runs beside it. Rows 2, 3 and 4 have one entry a
    kernel: the f32 kernel (flash_fwd_kernel, flash_bwd_dq_kernel,
    flash_bwd_dkv_kernel) with the f32 paths' launches, the bf16 one
    (flash_fwd_wgmma_kernel, flash_bwd_dq_wgmma_kernel,
    flash_bwd_dkv_wgmma_kernel, the "_wgmma" entries) with the bf16
    paths' (one count, "flash_fwd", "flash_bwd_dq" or "flash_bwd_dkv",
    holds both kernels of a row: each path runs one dtype)."""
    def pick(kernel, case, dtype="float32"):
        return next(r for r in records if r["kernel"] == kernel
                    and r["case"] == case and r["dtype"] == dtype
                    and r.get("eps", 1e-12) == 1e-12
                    and r.get("act", "relu") in ("relu", None)
                    and "kernel_ms" in r)

    records = records + [
        dict(x, kernel="mm_epilogue", route="simt",
             max_abs_err=x["simt_max_abs_err"], kernel_ms=x["simt_ms"],
             kernel_wall_ms=x["simt_wall_ms"], plan=x["simt_plan"])
        for x in records if "simt_ms" in x]
    csrc = "incubator_mxnet_tpu_torch/ops/cuda/csrc/"
    pallas = "incubator_mxnet_tpu/ops/pallas/"
    line = []
    for name, count, case, source, replaces, dtype in (
            ("flash_attention_fwd", "flash_fwd", "bert_b8",
             "flash_attention.cu", "flash_attention.py:109", "float32"),
            ("flash_attention_fwd_wgmma", "flash_fwd", "bert_b8",
             "flash_attention.cu", "flash_attention.py:109", "bfloat16"),
            ("flash_attention_bwd_dq", "flash_bwd_dq", "lm_b8_l512_causal",
             "flash_attention_bwd.cu", "flash_attention.py:237", "float32"),
            ("flash_attention_bwd_dkv", "flash_bwd_dkv", "lm_b8_l512_causal",
             "flash_attention_bwd.cu", "flash_attention.py:254", "float32"),
            ("flash_attention_bwd_dq_wgmma", "flash_bwd_dq",
             "lm_b8_l512_causal", "flash_attention_bwd.cu",
             "flash_attention.py:237", "bfloat16"),
            ("flash_attention_bwd_dkv_wgmma", "flash_bwd_dkv",
             "lm_b8_l512_causal", "flash_attention_bwd.cu",
             "flash_attention.py:254", "bfloat16"),
            ("layer_norm_fwd", "layer_norm", "rows1024", "layer_norm.cu",
             "layer_norm.py:44", "float32"),
            ("scale_shift_act", "scale_shift_act", "stem_b128",
             "conv_bn_relu.cu", "conv_bn_relu.py:75", "float32"),
            ("mm_epilogue", "mm_epilogue", "s2_conv3", "conv_bn_relu.cu",
             "conv_bn_relu.py:190", "float32"),
            ("mm_epilogue_wgmma", "mm_wgmma", "s2_conv3", "mm_wgmma.cu",
             "conv_bn_relu.py:190", "bfloat16"),
            ("mm_splitk_reduce", "mm_splitk_reduce", "s4_conv1_b4",
             "conv_bn_relu.cu", "conv_bn_relu.py:190", "float32")):
        flash = name.startswith("flash_attention")
        kernel = name.replace("_wgmma", "") if flash else name
        r = pick(kernel, case, dtype)
        worst = max(x["max_abs_err"] for x in records
                    if x["kernel"] == kernel and x["dtype"] == dtype)
        launches = {path: s["launches"].get(count, 0)
                    for path, s in paths.items()
                    if not path.endswith("_f16")}
        if flash:
            # train_lm_d256_*'s launches are its D = 256 instances',
            # train_lm_d512_*'s the wide kernels'
            launches = {path: n for path, n in launches.items()
                        if path.endswith("_bf16") == (dtype == "bfloat16")
                        and "_d256" not in path and "_d512" not in path}
        r16 = pick(kernel, case, "bfloat16")
        entry = {
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": pallas + replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "launches_by_dtype": {
                "float32": sum(n for p, n in launches.items()
                               if not p.endswith("_bf16")),
                "bfloat16": sum(n for p, n in launches.items()
                                if p.endswith("_bf16"))},
            "max_abs_err": r["max_abs_err"],
            ("max_abs_err_f32_all" if dtype == "float32" else
             "max_abs_err_bf16_all"): worst,
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timer": r["kernel_timer"],
            "wall_ms": r["kernel_wall_ms"],
            "function_wall_ms": r.get("function_wall_ms"),
            "library_wall_ms": r["library_wall_ms"], "case": case,
            "shape": r["shape"], "dtype": dtype,
            "bf16": {k: r16[k] for k in (
                "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "kernel_wall_ms")}}
        if flash:
            # the other kernel of the row has its own entry
            del entry["bf16"]
            entry["d256"] = d256_numbers(pick, kernel, dtype)
        else:
            # the f16 instance's numbers at the same shape (the SIMT GEMM's
            # f16 instance has no entry of its own: no f16 path runs it)
            r16 = pick(kernel, case, "float16")
            entry["f16"] = {k: r16[k] for k in (
                "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "kernel_wall_ms")}
        if kernel == "layer_norm_fwd":
            # BERT's bucket 32, a GPT-2 or BERT pretraining step, and the
            # MLM head's rows, beside bucket 8
            keys = ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")
            for case in ("rows4096", "rows640"):
                entry[case] = {k: pick(kernel, case)[k] for k in keys}
                entry["bf16"][case] = {
                    k: pick(kernel, case, "bfloat16")[k] for k in keys}
        if kernel == "flash_attention_fwd":
            lm = pick(kernel, "lm_b8_l512_causal", dtype)
            entry["lm_b8_l512_causal"] = {k: lm[k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}
        if name in ("mm_epilogue", "mm_epilogue_wgmma"):
            entry["plan"] = r["plan"]
            entry["tflops"] = r["tflops"]
            if name == "mm_epilogue_wgmma":
                entry["simt_ms"] = r["simt_ms"]
            entry["bucket4"] = {
                x["case"]: {k: x[k] for k in (
                    "plan", "kernel_ms", "plain_ms", "library_ms",
                    "bound_ms", "tflops")}
                for x in records if x["kernel"] == name
                and x["dtype"] == dtype and x.get("bucket") == 4}
        if name in ("scale_shift_act", "mm_epilogue", "mm_epilogue_wgmma"):
            # the kernel's device time over the shapes of one training step
            # (row 5) or one bucket-32 forward (row 6), f32 and bf16
            per = (SSA_PER_STEP if name == "scale_shift_act" else
                   {c[0]: c[5] for c in mm_cases() if c[6] == 32})
            keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
            for dt in (("bfloat16",) if name == "mm_epilogue_wgmma" else
                       ("float32", "bfloat16")):
                rows = [x for x in records if x["kernel"] == name
                        and x["dtype"] == dt and x["case"] in per
                        and "kernel_ms" in x]
                entry["per_step_or_forward_" + dt] = {
                    k: sum(per[x["case"]] * x[k] for x in rows)
                    for k in keys + (("simt_ms",) if name ==
                                     "mm_epilogue_wgmma" else ())}
        line.append(entry)
    line += d256_entries(records, paths, pick)
    line += wide_entries(records, paths, pick)
    line += f16_entries(records, paths, pick)
    return line


def d256_entries(records, paths, pick):
    """The kernels line's entry of each flash instance at head dim 256 that
    train_lm_d256_bf16 or train_lm_d256_f32 runs, each at that path's
    shape, with its launches on that path, which the other flash entries
    do not count: in bf16 the three on the tensor cores by wgmma
    (flash_fwd_wgmma_kernel, flash_bwd_dq_wgmma_kernel and
    flash_bwd_dkv_wgmma_kernel <__nv_bfloat16, 256>), their f16
    instances' numbers beside them (under "f16"); in f32 the split-TF32
    forward, dQ and dK/dV (flash_fwd_tf32x3_kernel,
    flash_bwd_dq_tf32x3_kernel and flash_bwd_dkv_tf32x3_kernel <float,
    256>), with the FMA units' bound beside the split-TF32 one and, by
    case, their errors against float64 (under "d256")."""
    csrc = "incubator_mxnet_tpu_torch/ops/cuda/csrc/"
    pallas = "incubator_mxnet_tpu/ops/pallas/"
    case = "lm_d256_b8_l512_causal"
    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "kernel_wall_ms")
    out = []
    for dtype, suffix in (("bfloat16", "_bf16"), ("float32", "_f32")):
        for kernel, count, source, replaces in (
                ("flash_attention_fwd", "flash_fwd", "flash_attention.cu",
                 "flash_attention.py:109"),
                ("flash_attention_bwd_dq", "flash_bwd_dq",
                 "flash_attention_bwd.cu", "flash_attention.py:237"),
                ("flash_attention_bwd_dkv", "flash_bwd_dkv",
                 "flash_attention_bwd.cu", "flash_attention.py:254")):
            r = pick(kernel, case, dtype)
            instance = flash_kernel_name(count, dtype, 256) + ", 256>"
            form = next((f for f in ("_wgmma", "_tf32x3")
                         if f[1:] + "_kernel" in instance), "")
            launches = {path: s["launches"].get(count, 0)
                        for path, s in paths.items()
                        if "_d256" in path and path.endswith(suffix)}
            entry = {
                "name": kernel + form + "_d256", "route": "cuda",
                "source": csrc + source, "replaces": pallas + replaces,
                "instance": instance, "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": r["max_abs_err"],
                "max_abs_err_d256_all": max(
                    x["max_abs_err"] for x in records
                    if x["kernel"] == kernel and x["dtype"] == dtype
                    and x["shape"][4] in (192, 256)),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "timer": r["kernel_timer"],
                "wall_ms": r["kernel_wall_ms"],
                "library_wall_ms": r["library_wall_ms"], "case": case,
                "shape": r["shape"], "dtype": dtype,
                "d256": d256_numbers(pick, kernel, dtype)}
            if dtype == "bfloat16":
                r16 = pick(kernel, case, "float16")
                entry["f16"] = {k: r16[k] for k in keys}
            if "bound_fma_ms" in r:
                entry["bound_fma_ms"] = r["bound_fma_ms"]
            out.append(entry)
    return out


def wide_entries(records, paths, pick):
    """The kernels line's entry of each wide flash kernel (head dims above
    256: the forward's in csrc/flash_attention.cu, dQ's and dK/dV's in
    csrc/flash_attention_wide.cu) that train_lm_d512_bf16 or
    train_lm_d512_f32 runs, at that path's shape, with its launches on
    that path, which the other flash entries do not count: in bf16
    flash_fwd_wide_wgmma_kernel, flash_bwd_dq_wide_wgmma_kernel and
    flash_bwd_dkv_wide_wgmma_kernel <__nv_bfloat16>, their f16 instances'
    numbers beside them (under "f16": no f16 path has a head dim above
    256); in f32 flash_fwd_wide_tf32x3_kernel,
    flash_bwd_dq_wide_tf32x3_kernel and flash_bwd_dkv_wide_tf32x3_kernel
    <float>, with the FMA units' bound beside the split-TF32 one and the
    errors against float64. Each carries its numbers at (2, 4, 512, 512,
    512) under "d512_l512" and the backend SDPA took."""
    csrc = "incubator_mxnet_tpu_torch/ops/cuda/csrc/"
    pallas = "incubator_mxnet_tpu/ops/pallas/"
    case = "lm_d512_b8_l512_causal"
    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "sdpa_backend", "kernel_wall_ms")
    out = []
    for dtype, suffix in (("bfloat16", "_bf16"), ("float32", "_f32")):
        for kernel, count, replaces, source in (
                ("flash_attention_fwd", "flash_fwd", "flash_attention.py:109",
                 "flash_attention.cu"),
                ("flash_attention_bwd_dq", "flash_bwd_dq",
                 "flash_attention.py:237", "flash_attention_wide.cu"),
                ("flash_attention_bwd_dkv", "flash_bwd_dkv",
                 "flash_attention.py:254", "flash_attention_wide.cu")):
            r = pick(kernel, case, dtype)
            launches = {path: s["launches"].get(count, 0)
                        for path, s in paths.items()
                        if "_d512" in path and path.endswith(suffix)}
            entry = {
                "name": kernel + "_wide" + suffix, "route": "cuda",
                "source": csrc + source,
                "replaces": pallas + replaces,
                "instance": flash_kernel_name(count, dtype, 512) + ">",
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": r["max_abs_err"],
                "max_abs_err_wide_all": max(
                    x["max_abs_err"] for x in records
                    if x["kernel"] == kernel and x["dtype"] == dtype
                    and x["shape"][4] > 256),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "sdpa_backend": r["sdpa_backend"],
                "timer": r["kernel_timer"], "wall_ms": r["kernel_wall_ms"],
                "library_wall_ms": r["library_wall_ms"], "case": case,
                "shape": r["shape"], "dtype": dtype,
                "d512_l512": {k: pick(kernel, "d512_l512", dtype)[k]
                              for k in keys}}
            if dtype == "bfloat16":
                entry["f16"] = {k: pick(kernel, case, "float16")[k]
                                for k in keys}
                entry["f16"]["d512_l512"] = {
                    k: pick(kernel, "d512_l512", "float16")[k] for k in keys}
            else:
                entry["bound_fma_ms"] = r["bound_fma_ms"]
                entry["f64"] = r["f64"]
            out.append(entry)
    return out


def d256_numbers(pick, kernel, dtype):
    """A flash kernel row's numbers at head dim 256 in `dtype` (C5), by
    case, with the kernel that runs there (``flash_kernel_name``: f32 the
    split-TF32 ones; bf16 and f16 the wgmma ones)."""
    kind = {"flash_attention_fwd": "flash_fwd",
            "flash_attention_bwd_dq": "flash_bwd_dq",
            "flash_attention_bwd_dkv": "flash_bwd_dkv"}[kernel]
    out = {}
    for case in D256_CASES:
        r = pick(kernel, case, dtype)
        out[case] = dict({k: r[k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")},
            kernel=flash_kernel_name(kind, dtype, 256) + ", 256>")
        for k in ("bound_fma_ms", "f64"):
            if k in r:
                out[case][k] = r[k]
    return out


def f16_entries(records, paths, pick):
    """The kernels line's entry of each f16 instance (``<__half>``) that an
    f16 path runs: the kernel at its main path's shape in f16, and its
    launches on the f16 paths (serve_bert_f16, train_lm_f16,
    serve_resnet_f16)."""
    csrc = "incubator_mxnet_tpu_torch/ops/cuda/csrc/"
    pallas = "incubator_mxnet_tpu/ops/pallas/"
    out = []
    for name, kernel, count, case, source, replaces in (
            ("flash_attention_fwd_wgmma_f16", "flash_attention_fwd",
             "flash_fwd", "bert_b8", "flash_attention.cu",
             "flash_attention.py:109"),
            ("flash_attention_bwd_dq_wgmma_f16", "flash_attention_bwd_dq",
             "flash_bwd_dq", "lm_b8_l512_causal", "flash_attention_bwd.cu",
             "flash_attention.py:237"),
            ("flash_attention_bwd_dkv_wgmma_f16", "flash_attention_bwd_dkv",
             "flash_bwd_dkv", "lm_b8_l512_causal", "flash_attention_bwd.cu",
             "flash_attention.py:254"),
            ("layer_norm_fwd_f16", "layer_norm_fwd", "layer_norm",
             "rows1024", "layer_norm.cu", "layer_norm.py:44"),
            ("scale_shift_act_f16", "scale_shift_act", "scale_shift_act",
             "stem_b128", "conv_bn_relu.cu", "conv_bn_relu.py:75"),
            ("mm_epilogue_wgmma_f16", "mm_epilogue_wgmma", "mm_wgmma",
             "s2_conv3", "mm_wgmma.cu", "conv_bn_relu.py:190"),
            ("mm_splitk_reduce_f16", "mm_splitk_reduce", "mm_splitk_reduce",
             "s4_conv1_b4", "conv_bn_relu.cu", "conv_bn_relu.py:190")):
        r = pick(kernel, case, "float16")
        launches = {path: s["launches"].get(count, 0)
                    for path, s in paths.items() if path.endswith("_f16")}
        entry = {
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": pallas + replaces, "instance": "<__half>",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_f16_all": max(
                x["max_abs_err"] for x in records if x["kernel"] == kernel
                and x["dtype"] == "float16"),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timer": r["kernel_timer"],
            "wall_ms": r["kernel_wall_ms"],
            "library_wall_ms": r["library_wall_ms"], "case": case,
            "shape": r["shape"], "dtype": "float16"}
        keys = ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")
        if kernel == "flash_attention_fwd":
            lm = pick(kernel, "lm_b8_l512_causal", "float16")
            entry["lm_b8_l512_causal"] = {k: lm[k] for k in keys}
        if kernel.startswith("flash_attention"):
            entry["d256"] = d256_numbers(pick, kernel, "float16")
        if kernel == "layer_norm_fwd":
            for c in ("rows4096", "rows640"):
                entry[c] = {k: pick(kernel, c, "float16")[k] for k in keys}
        if kernel in ("scale_shift_act", "mm_epilogue_wgmma"):
            per = (SSA_PER_STEP if kernel == "scale_shift_act" else
                   {c[0]: c[5] for c in mm_cases() if c[6] == 32})
            rows = [x for x in records if x["kernel"] == kernel
                    and x["dtype"] == "float16" and x["case"] in per
                    and "kernel_ms" in x]
            entry["per_step_or_forward_float16"] = {
                k: sum(per[x["case"]] * x[k] for x in rows)
                for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        out.append(entry)
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has nothing to run without one", file=sys.stderr)
        return 2
    if not (ROOT / "incubator_mxnet_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run from a checkout of the repository (the "
              "incubator_mxnet_tpu_torch package is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from incubator_mxnet_tpu_torch.ops.cuda import _build

    global _log_file
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _log_file = open(OUT_DIR / "log.txt", "w")

    t_start = time.perf_counter()
    card = gpu_name_and_limit()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    detail = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"build: {json.dumps(seconds)} ({time.perf_counter() - t0:.1f} s "
        f"wall, one nvcc per source in parallel)")
    for name, text in _build.logs().items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry")):
                log(f"  ptxas {name}: {line.strip()}")
    detail["build_s"] = seconds

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32 off for matmul and cuDNN: the f32 references run in full f32")

    records = []
    check_flash(records)
    check_flash_bwd(records)
    check_layer_norm(records)
    check_scale_shift_act(records)
    check_mm_epilogue(records)
    check_mm_plans(records)
    detail["kernels"] = records
    # each main path in f32, then in bf16 from the same weights: `ref`
    # carries the f32 answers and step-0 gradients to the bf16 phase
    ref, paths, phase_s = {}, {}, {}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        # what the phase left in reference cycles (a stopped server holds
        # its frozen model so) is freed here, not by a collection that
        # falls in a later phase
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    # head dims above 256: the wide kernels against their plain versions
    phase("flash_wide", flash_wide, records)
    paths["serve_bert"] = phase("serve_bert", serve_bert, detail, ref=ref)
    paths["serve_bert_bf16"] = phase("serve_bert_bf16", serve_bert, detail,
                                     "bfloat16", ref)
    paths["serve_bert_f16"] = phase("serve_bert_f16", serve_bert_f16,
                                    detail, ref)
    paths["train_lm"] = phase("train_lm", train_lm, detail, ref=ref)
    paths["train_lm_bf16"] = phase("train_lm_bf16", train_lm, detail,
                                   dtype="bfloat16", ref=ref)
    paths["train_lm_f16"] = phase("train_lm_f16", train_lm_f16, detail,
                                  ref=ref)
    ref.pop("lm_grads", None)
    paths["train_bert_pretrain"] = phase("train_bert_pretrain",
                                         train_bert_pretrain, detail, ref=ref)
    paths["train_bert_pretrain_bf16"] = phase(
        "train_bert_pretrain_bf16", train_bert_pretrain, detail,
        dtype="bfloat16", ref=ref)
    ref.pop("bert_pretrain_grads", None)
    phase("fused_dropout", fused_dropout, detail)
    # the network the serving phases freeze is trained here: cuDNN's
    # default weight-gradient algorithms sum in an order that changes from
    # run to run, and so would the served weights and the bf16 gaps
    # measured on them (ZOO_BF16_NORM, BF16_VS_F32)
    torch.backends.cudnn.deterministic = True
    paths["train_resnet"], net = phase("train_resnet", train_resnet, detail,
                                       ref=ref)
    torch.backends.cudnn.deterministic = False
    paths["serve_resnet"] = phase("serve_resnet", serve_resnet, detail, net,
                                  ref=ref)
    paths["serve_resnet_bf16"] = phase("serve_resnet_bf16", serve_resnet,
                                       detail, net, dtype="bfloat16",
                                       ref=ref)
    paths["serve_resnet_f16"] = phase("serve_resnet_f16", serve_resnet,
                                      detail, net, dtype="float16", ref=ref)
    phase("resnet_s2d", resnet_s2d, detail, net)
    del net
    paths["train_resnet_bf16"], _ = phase(
        "train_resnet_bf16", train_resnet, detail, dtype="bfloat16", ref=ref)
    # the fused step: GPT-2-base through TrainLoop in f32 and bf16, then
    # ResNet-50 through FusedTrainStep in bf16, with cuDNN deterministic so
    # that it and its eager reference pick the same algorithms
    paths["train_lm_fused"] = phase("train_lm_fused", train_lm_fused, detail)
    paths["train_lm_fused_bf16"] = phase("train_lm_fused_bf16",
                                         train_lm_fused, detail,
                                         dtype="bfloat16")
    # the head-dim-256 flash kernels on a training step: Gemma-2B's
    # attention shape at 4 of its 18 layers
    paths["train_lm_d256_bf16"] = phase(
        "train_lm_d256_bf16", train_lm_fused, detail, dtype="bfloat16",
        label="train_lm_d256_bf16", **LM_D256)
    # the same step in f32 (TF32 off for every GEMM): the f32 flash kernels
    # at head dim 256, dQ and dK/dV on the tensor cores by split TF32
    paths["train_lm_d256_f32"] = phase(
        "train_lm_d256_f32", train_lm_fused, detail, dtype="float32",
        label="train_lm_d256_f32", **LM_D256)
    # head dims above 256 (4 heads of 512 at LM_D256's width): the wide
    # flash kernels on a training step, in bf16 and in f32
    paths["train_lm_d512_bf16"] = phase(
        "train_lm_d512_bf16", train_lm_fused, detail, dtype="bfloat16",
        label="train_lm_d512_bf16", **LM_D512)
    paths["train_lm_d512_f32"] = phase(
        "train_lm_d512_f32", train_lm_fused, detail, dtype="float32",
        label="train_lm_d512_f32", **LM_D512)
    # the rest of autograd: grad, pause, predict_mode, a user Function, a
    # gradient penalty, a second derivative through attention
    paths["autograd_api"] = phase("autograd_api", autograd_api, detail)
    torch.backends.cudnn.deterministic = True
    paths["train_resnet_fused_bf16"] = phase(
        "train_resnet_fused_bf16", train_resnet_fused, detail)
    torch.backends.cudnn.deterministic = False
    # the Gluon core: ResNet-50 built, initialized, trained, saved and
    # reloaded the MXNet way, then BERT-base hybridized; cuDNN
    # deterministic, so that the grad_req="add" gap (two half batches
    # against one full batch, summed in other orders) is the same in
    # every run
    torch.backends.cudnn.deterministic = True
    paths["gluon_resnet"] = phase("gluon_resnet", gluon_resnet, detail)
    torch.backends.cudnn.deterministic = False
    phase("frozen_dropout_always", frozen_dropout_always, detail)
    phase("nd_api", nd_api, detail)
    detail["phase_s"] = phase_s
    detail["total_s"] = time.perf_counter() - t_start
    log(f"all phases: {detail['total_s']:.1f} s since start, of the 1200 s "
        f"a chip check allows this script (the build included)")
    line = kernel_line(records, paths)
    detail["profiler_traces"] = TRACES
    log(f"profiler traces: {TRACES['taken']} taken, {TRACES['short']} short "
        f"and taken again, {TRACES['stream_time']} times read from the "
        f"stream instead, {TRACES['written']} written to "
        f"{OUT_DIR / 'short_traces'}")
    detail["failed"] = FAILED
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "detail.json").write_text(json.dumps(detail, indent=1))
    (OUT_DIR / "kernels.json").write_text(json.dumps(line, indent=1))
    check(not FAILED, f"{len(FAILED)} bf16 or f16 checks failed: {FAILED}")
    log(gpu_name_and_limit())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
