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
   epilogue and its split-K reduce. The GEMM is also run under forced
   splits of K against the plain version, and twice per case to show
   that two calls give the same bits, as are the flash backward's two
   kernels at the training shape;
4. serves BERT-base (bert_12_768_12, seq 128, random weights from
   numpy.random.RandomState(0) carried in through convert.load_jax_params)
   through FrozenModel -> DynamicBatcher -> ModelServer: 16 HTTP clients
   send 4 requests each; every answer is checked against a direct
   predict_batch of its batch and against an all-plain forward, and the
   kernel launch counts are checked against the executed batches;
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
   step, the loss after 30 steps against half of the first;
7. serves the trained network through FrozenModel -> DynamicBatcher
   (buckets 1..32; 8 threads submit 8 images each, in process): every
   answer against a direct predict_batch of its batch and an all-plain
   forward, 23 scale/shift/act and 30 GEMM launches per executed batch
   and a split-K reduce for each GEMM whose plan splits K at the batch's
   bucket, and the zoo resnet50_v1 with the same weights against the
   network;
8. prints one JSON line with a record per kernel, then, as the last line,
   {"ok": true, "device": {...}}.

Any failure exits non-zero. Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result. The whole log and a
detailed record are written to chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import contextlib
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
# f32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


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


# the kernel_counts() entry -> the _kernel_kind() of the kernel it counts
_COUNT_KIND = {"flash_fwd": "flash_attention", "flash_bwd_dq": "flash_bwd_dq",
               "flash_bwd_dkv": "flash_bwd_dkv", "layer_norm": "layer_norm",
               "scale_shift_act": "scale_shift_act",
               "mm_epilogue": "mm_epilogue",
               "mm_splitk_reduce": "mm_splitk_reduce"}
# the one key of device_ms's times where no whole trace came back
STREAM_KEY = "(stream time: every trace short)"
# profiler traces taken by device_ms, those short, and the times where the
# stream time stood in
TRACES = {"taken": 0, "short": 0, "stream_time": 0}


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
    time) stands in, under the one key STREAM_KEY.
    Returns (total ms, {kernel name: ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        before = kernel_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        after = kernel_counts()
        launched = {_COUNT_KIND[k]: after[k][0] - before[k][0]
                    for k in after}
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        TRACES["taken"] += 1
        why = _short(events, iters, launched)
        if not why:
            per = {}
            for e in events:
                per[e.key] = (per.get(e.key, 0.0)
                              + e.self_device_time_total / iters / 1e3)
            return sum(per.values()), per
        TRACES["short"] += 1
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
    """(name, B, H, lq, lk, D, causal, layout). "qkv" views q, k, v out of
    one (B, L, 3*H*D) projection, as multi-head attention hands them over;
    "bhld" is contiguous (B, H, L, D)."""
    return [
        ("bert_b8", 8, 12, 128, 128, 64, False, "qkv"),
        ("bert_b32", 32, 12, 128, 128, 64, False, "qkv"),
        ("bert_b8_causal", 8, 12, 128, 128, 64, True, "qkv"),
        ("lm_b8_l512_causal", 8, 12, 512, 512, 64, True, "qkv"),
        ("l512", 2, 12, 512, 512, 64, False, "bhld"),
        ("l512_causal", 2, 12, 512, 512, 64, True, "bhld"),
        ("decode_lq1_lk128", 8, 12, 1, 128, 64, True, "bhld"),
        ("unaligned_l100", 8, 12, 100, 100, 64, False, "qkv"),
        ("unaligned_l100_causal", 8, 12, 100, 100, 64, True, "qkv"),
        ("d128_l256", 2, 8, 256, 256, 128, False, "bhld"),
    ]


def make_qkv(b, h, lq, lk, d, layout, dtype, gen):
    import torch
    if layout == "qkv":
        qkv = torch.randn(b, lq, 3 * h * d, generator=gen, device="cuda")
        q, k, v = qkv.to(dtype).chunk(3, dim=-1)
        return [t.reshape(b, lq, h, d).transpose(1, 2) for t in (q, k, v)]
    return [torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype)
            for n in (lq, lk, lk)]


def check_flash(records):
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, h, lq, lk, d, causal, layout in flash_cases():
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
            tdt = getattr(torch, dtype)
            q, k, v = make_qkv(b, h, lq, lk, d, layout, tdt, gen)
            scale = 1.0 / math.sqrt(d)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                              scale=scale)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=causal,
                                                  scale=scale)
            err = max_err(out, ref)
            lse_err = max_err(lse, ref_lse)
            ok = (torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
                  and torch.allclose(lse, ref_lse, rtol=tol, atol=tol))
            check(ok, f"flash {name} {dtype}: max |O - plain| {err}, "
                      f"max |lse - plain| {lse_err} over tolerance {tol}")
            if causal and lq != lk:
                mask = torch.ones(lq, lk, dtype=torch.bool,
                                  device="cuda").tril(lk - lq)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=mask, scale=scale)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=causal, scale=scale)
            times = measure(
                lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                               scale=scale),
                lambda: fa.flash_attention_ref(q, k, v, causal=causal,
                                               scale=scale),
                lib)
            # (query, key) pairs the mask lets through, for these shapes
            pairs = (sum(min(lk, r + lk - lq + 1) for r in range(lq))
                     if causal else lq * lk)
            flops = 4.0 * b * h * pairs * d
            elt = q.element_size()
            nbytes = (b * h * (2 * lq + 2 * lk) * d * elt + b * h * lq * 4)
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            rec = dict(kernel="flash_attention_fwd", case=name,
                       shape=[b, h, lq, lk, d], causal=causal, layout=layout,
                       dtype=dtype, tol=tol, max_abs_err=err,
                       lse_max_abs_err=lse_err, bound_ms=bound_ms,
                       bound_by=bound_by, **times)
            if name == "bert_b8":
                # what the autograd.Function adds on the host per call,
                # as the serving path calls it
                with torch.inference_mode():
                    rec["function_wall_ms"] = time_ms(
                        lambda: fa.flash_attention(q, k, v, causal=causal,
                                                   scale=scale))
            records.append(rec)
            log(f"flash {name:22s} {dtype:8s} err {err:.2e} lse_err "
                f"{lse_err:.2e} " + fmt_times(rec))

    # a head dim the kernels do not take: the Function pads it with zeros
    # to 64 and launches the kernel; held against the plain version at 32
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        q, k, v = make_qkv(8, 12, 128, 128, 32, "qkv", getattr(torch, dtype),
                           gen)
        before = fa.launches
        with torch.no_grad():
            out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref, _ = fa.flash_attention_ref(q, k, v, causal=True)
        err = max_err(out, ref)
        check(fa.launches == before + 1 and out.shape == ref.shape,
              f"flash d32 {dtype}: the padded call did not launch the kernel")
        check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
              f"flash d32 {dtype}: max |O - plain| {err} over tolerance {tol}")
        records.append(dict(kernel="flash_attention_fwd", case="d32_padded",
                            shape=[8, 12, 128, 128, 32], causal=True,
                            layout="qkv", dtype=dtype, tol=tol,
                            max_abs_err=err))
        log(f"flash d32_padded (head dim 32 run at 64) {dtype:8s} err "
            f"{err:.2e}")


def flash_bwd_cases():
    """(name, B, H, lq, lk, D, causal, layout, kv_len). The first is the
    training path's: GPT-2-base at batch 8, seq 512, causal, q, k and v cut
    out of one QKV projection. lq160_lk200_causal holds the kernels' heavy-
    first block order: an odd number of query tiles (3 of 64 rows, 5 of 32)
    and a causal offset of 40, which is no multiple of a tile."""
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
    ]


def bwd_pairs(lq, lk, causal, kv_len):
    """(query, key) pairs the masks let through."""
    kv_lim = lk if kv_len is None else kv_len
    if not causal:
        return lq * kv_lim
    return sum(max(0, min(kv_lim, r + lk - lq + 1)) for r in range(lq))


def check_flash_bwd(records):
    """The dQ and dK/dV kernels against their plain versions, from the same
    q, k, v, dO, lse and delta; at the training shape, two calls of each
    kernel compared bit for bit, and the kernels timed against SDPA's
    backward (torch.autograd.grad of scaled_dot_product_attention)."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, b, h, lq, lk, d, causal, layout, kv_len in flash_bwd_cases():
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
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
            pairs = bwd_pairs(lq, lk, causal, kv_len)
            elt = q.element_size()
            # each input read once, each output written once: the kernels
            # read q, k, v, dO, lse and delta; the whole backward reads out
            # in place of delta
            qkvdo = b * h * (2 * lq + 2 * lk) * d * elt
            rows = b * h * lq * 4
            rec = dict(case=name, shape=[b, h, lq, lk, d], causal=causal,
                       kv_len=kv_len, layout=layout, dtype=dtype, tol=tol)
            if name != "lm_b8_l512_causal":
                for kernel, gn in (("flash_attention_bwd_dq", ("dq",)),
                                   ("flash_attention_bwd_dkv", ("dk", "dv"))):
                    records.append(dict(rec, kernel=kernel, max_abs_err=max(
                        errs[g] for g in gn)))
                log(f"flash bwd {name:22s} {dtype:8s} err dq {errs['dq']:.2e}"
                    f" dk {errs['dk']:.2e} dv {errs['dv']:.2e}")
                continue
            # the training shape: the same bits from a second call (no
            # atomics, a fixed order of every sum), then times against the
            # bounds and SDPA
            again = (fa.flash_attention_bwd_dq(*args, **kw),
                     *fa.flash_attention_bwd_dkv(*args, **kw))
            torch.cuda.synchronize()
            for g, g2, gname in zip((dq, dk, dv), again, ("dq", "dk", "dv")):
                check(torch.equal(g, g2), f"flash bwd {name} {dtype}: two "
                                          f"calls gave different {gname}")
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
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                r = dict(rec, kernel=kernel, max_abs_err=max(
                    errs[g] for g in gn), bound_ms=bound_ms,
                    bound_by=bound_by, flops=flops, pairs=pairs,
                    library="torch.autograd.grad of "
                            "scaled_dot_product_attention (dq, dk, dv)",
                    **times)
                records.append(r)
                log(f"{kernel:26s} {name} {dtype:8s} err "
                    f"{r['max_abs_err']:.2e} " + fmt_times(r))
            ratio = r["kernel_ms"] / r["library_ms"]
            log(f"flash bwd {name} {dtype}: two calls bit-identical; whole "
                f"backward / SDPA's {ratio:.3f}; SDPA's backward launches "
                f"{r['library_names']}")

    # a head dim the kernels do not take, through autograd: the Function
    # pads q, k, v and dO with zeros to 64, launches both kernels and slices
    # dQ, dK and dV back; held against the plain backward at 32
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        tdt = getattr(torch, dtype)
        q, k, v = make_qkv(8, 12, 128, 128, 32, "qkv", tdt, gen)
        do = torch.randn(8, 12, 128, 32, generator=gen, device="cuda").to(tdt)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = (fa.dq_launches, fa.dkv_launches)
        got = torch.autograd.grad(fa.flash_attention(*leaves, causal=True),
                                  leaves, do)
        torch.cuda.synchronize()
        out, lse = fa.flash_attention_ref(q, k, v, causal=True)
        want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
        check((fa.dq_launches, fa.dkv_launches)
              == (before[0] + 1, before[1] + 1),
              f"flash bwd d32 {dtype}: the padded call did not launch both "
              f"kernels")
        errs = {}
        for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
            errs[gname] = max_err(g, w)
            check(g.shape == w.shape and torch.allclose(
                g.float(), w.float(), rtol=tol, atol=tol),
                f"flash bwd d32 {dtype}: max |{gname} - plain| "
                f"{errs[gname]} over tolerance {tol}")
        for kernel, gn in (("flash_attention_bwd_dq", ("dq",)),
                           ("flash_attention_bwd_dkv", ("dk", "dv"))):
            records.append(dict(
                kernel=kernel, case="d32_padded", shape=[8, 12, 128, 128, 32],
                causal=True, layout="qkv", dtype=dtype, tol=tol,
                max_abs_err=max(errs[g] for g in gn)))
        log(f"flash bwd d32_padded (head dim 32 run at 64) {dtype:8s} err "
            f"dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e}")

    # dO with a zero stride on D, as autograd hands over an expanded
    # gradient: the wrapper copies it to a unit stride and does not raise
    q, k, v = make_qkv(2, 4, 64, 64, 64, "bhld", torch.float32, gen)
    out, lse = fa.flash_attention_ref(q, k, v, causal=True)
    do = torch.randn(2, 4, 64, 1, generator=gen, device="cuda").expand(
        2, 4, 64, 64)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    err = max(max_err(g, w) for g, w in zip(got, want))
    check(err <= 1e-4, f"flash bwd with an expanded dO: max err {err}")
    log(f"flash bwd expanded dO (stride 0 on D): err {err:.2e}")


def check_layer_norm(records):
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
    gen = torch.Generator(device="cuda").manual_seed(1)
    d = 768
    for rows in (1024, 4096):
        for eps in (1e-12, 1e-5):
            for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
                tdt = getattr(torch, dtype)
                x = (torch.randn(rows, d, generator=gen, device="cuda") * 2
                     + 0.5).to(tdt)
                g = torch.randn(d, generator=gen, device="cuda")
                b = torch.randn(d, generator=gen, device="cuda")
                y = ln.layer_norm_fwd(x, g, b, eps)
                torch.cuda.synchronize()
                ref = ln.layer_norm_ref(x, g, b, eps)
                err = max_err(y, ref)
                check(torch.allclose(y.float(), ref.float(), rtol=tol,
                                     atol=tol),
                      f"layer_norm rows {rows} eps {eps} {dtype}: max "
                      f"|y - plain| {err} over tolerance {tol}")
                # the library call takes gamma/beta in x's dtype
                gl, bl = g.to(tdt), b.to(tdt)
                times = measure(
                    lambda: ln.layer_norm_fwd(x, g, b, eps),
                    lambda: ln.layer_norm_ref(x, g, b, eps),
                    lambda: F.layer_norm(x, (d,), gl, bl, eps))
                nbytes = 2 * rows * d * x.element_size() + 2 * d * 4
                bound_ms, bound_by = bound(8.0 * rows * d, nbytes, dtype)
                rec = dict(kernel="layer_norm_fwd", case=f"rows{rows}",
                           shape=[rows, d], eps=eps, dtype=dtype, tol=tol,
                           max_abs_err=err, bound_ms=bound_ms,
                           bound_by=bound_by, **times)
                with torch.inference_mode():
                    rec["function_wall_ms"] = time_ms(
                        lambda: ln.layer_norm(x, g, b, eps))
                records.append(rec)
                log(f"layer_norm rows {rows:5d} eps {eps:.0e} {dtype:8s} "
                    f"err {err:.2e} " + fmt_times(rec))


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
    # plain version's two operations do; bf16: the f32 result rounds once
    tols = {"float32": 1e-6, "bfloat16": 1e-2}
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
            f"in f32 and bf16 agree with the plain version")
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
    log("scale_shift_act unaligned pointer: agrees in f32 and bf16")


def mm_cases():
    """(name, M, K, N, act, launches per forward, bucket): every distinct
    1x1/stride-1 conv of ResNet-50 at bucket 32 and 224 x 224 (M = 32 x H x
    W pixels, K in, N out channels), stage 3's and 4's first conv at bucket
    4 (the smoke's average batch, where the plan splits K), and one of no
    aligned dimension."""
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
            ("unaligned_100x70x30", 100, 70, 30, "relu6", 0, 0)]


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


# f32: sums of K products in another order than cuBLAS's; bf16: the f32
# sums round once to bf16 on both sides, one unit apart at most
MM_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}


def check_mm_epilogue(records):
    """The fused 1x1-conv GEMM against its plain version (TF32 off) at
    every case in f32 and bf16, under mm_plan's plan; two calls must give
    the same bits. The per-forward shapes are timed against their bound
    (operations in f32, bytes in bf16), the plain version and
    torch._addmm_activation(shift, x, w * scale) (torch.addmm where there
    is no activation)."""
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, m, k, n, act, per_fwd, bucket in mm_cases():
        for dtype, tol in MM_TOLS.items():
            tdt = getattr(torch, dtype)
            x, w, s, b = mm_inputs(m, k, n, dtype, gen)
            plan = cbr.mm_plan(m, n, k, tdt)
            acts = (act,) if per_fwd else ("relu", "relu6", None)
            for a in acts:
                y = cbr.mm_epilogue(x, w, s, b, a)
                again = cbr.mm_epilogue(x, w, s, b, a)
                torch.cuda.synchronize()
                check(torch.equal(y, again),
                      f"mm_epilogue {name} {dtype} {a}: two calls differ")
                ref = cbr.mm_epilogue_ref(x, w, s, b, a)
                err = max_err(y, ref)
                check(torch.allclose(y.float(), ref.float(), rtol=tol,
                                     atol=tol),
                      f"mm_epilogue {name} {dtype} {a}: max |y - plain| "
                      f"{err} over tolerance {tol}")
            rec = dict(kernel="mm_epilogue", case=name, shape=[m, k, n],
                       act=act, dtype=dtype, tol=tol, max_abs_err=err,
                       per_forward=per_fwd, bucket=bucket,
                       plan=plan_name(plan), bit_identical=True)
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
                log(f"mm_epilogue {name:19s} {dtype:8s} {rec['plan']:10s} "
                    f"err {err:.2e} {rec['tflops']:.1f} TFLOP/s "
                    + fmt_times(rec))
            else:
                log(f"mm_epilogue {name} {dtype} {rec['plan']}: relu, "
                    f"relu6, none agree with the plain version (err "
                    f"{err:.2e}), two calls bit-identical")
            records.append(rec)


def check_mm_plans(records):
    """A split of 1, 2 and 4 forced onto a shape of no aligned dimension
    and a small aligned one, in f32 and bf16 and for each act, against the
    plain version; then the reduce kernel alone against
    its plain version (f32 sums in the same order: equal bits expected),
    timed at s4_conv1_b4's plan."""
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    gen = torch.Generator(device="cuda").manual_seed(6)
    for name, m, k, n in (("unaligned_100x70x30", 100, 70, 30),
                          ("small_300x256x96", 300, 256, 96)):
        for dtype, tol in MM_TOLS.items():
            x, w, s, b = mm_inputs(m, k, n, dtype, gen)
            worst = 0.0
            for split in (1, 2, 4):
                plan = (cbr.MM_TILE, split)
                for a in ("relu", "relu6", None):
                    y = cbr._mm_epilogue_with_plan(x, w, s, b, a, plan)
                    torch.cuda.synchronize()
                    err = max_err(y, cbr.mm_epilogue_ref(x, w, s, b, a))
                    check(err <= tol,
                          f"mm_epilogue {name} {dtype} plan "
                          f"{plan_name(plan)} {a}: max |y - plain| "
                          f"{err} over tolerance {tol}")
                    worst = max(worst, err)
            records.append(dict(kernel="mm_epilogue", case=name + "_plans",
                                shape=[m, k, n], act=None, dtype=dtype,
                                tol=tol, max_abs_err=worst,
                                plans="split 1, 2, 4"))
            log(f"mm_epilogue {name} {dtype}: split 1, 2, 4 x relu, relu6, "
                f"none within {tol} (worst {worst:.2e})")
    # f32: the kernel and the plain version add the same f32 values in
    # the same order and round the epilogue's product and sum alike. The
    # bucket-4 cases take their plan's split, as serving gives it
    tols = {"float32": 1e-6, "bfloat16": 1e-2}
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
            f"none in f32 and bf16 agree with the plain version")


# ---------------------------------------------------------------------------
# the slice: BERT-base served over HTTP
# ---------------------------------------------------------------------------

N_CLIENTS, PER_CLIENT, SEQ = 16, 4, 128


def normal_arrays(net, seed=0, sigma=0.02):
    """Weights by the JAX package's Normal(0.02) name rules, from numpy:
    gamma ones, beta and bias zeros, everything else normal(0, 0.02); the
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
        elif leaf in ("beta", "bias"):
            arrays[name] = np.zeros(shape, np.float32)
        else:
            arrays[name] = rng.normal(0.0, sigma, shape).astype(np.float32)
    for name, b in net.named_buffers():
        fill = np.ones if name.endswith("running_var") else np.zeros
        arrays[name] = fill(tuple(b.shape), np.float32)
    return arrays


def kernel_counts():
    """(launches, plain calls) of every kernel's wrapper."""
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
    return {"flash_fwd": (fa.launches, fa.plain_calls),
            "flash_bwd_dq": (fa.dq_launches, fa.dq_plain_calls),
            "flash_bwd_dkv": (fa.dkv_launches, fa.dkv_plain_calls),
            "layer_norm": (ln.launches, ln.plain_calls),
            "scale_shift_act": (cbr.ssa_launches, cbr.ssa_plain_calls),
            "mm_epilogue": (cbr.mm_launches, cbr.mm_plain_calls),
            "mm_splitk_reduce": (cbr.mm_reduce_launches,
                                 cbr.mm_reduce_plain_calls)}


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


def _kernel_kind(name):
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_bwd_dkv"
    if "ln_warp_kernel" in name or "ln_block_kernel" in name:
        return "layer_norm"
    if "ssa_kernel" in name:
        return "scale_shift_act"
    if "mm_epilogue_kernel" in name:
        return "mm_epilogue"
    if "mm_splitk_reduce_kernel" in name:
        return "mm_splitk_reduce"
    low = name.lower()
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad",
                              "implicit")):
        return "conv"
    if any(s in low for s in ("gemm", "sm90", "cutlass", "cublas", "xmma")):
        return "matmul"
    if "reduce_kernel" in low:
        return "reductions"
    return "other"


def _by_kind(per):
    """{kernel name: ms} summed by kind of kernel."""
    kinds = {}
    for name, ms in per.items():
        kinds[_kernel_kind(name)] = kinds.get(_kernel_kind(name), 0.0) + ms
    return kinds


def forward_breakdown(fm, ids, b):
    """Where one forward of bucket `b` spends the card's time: profiler
    device time by kind of kernel, against the stream time of the same
    forward (events); their difference is the card's idle share."""
    x = ids[:b]
    total, per = device_ms(lambda: fm.run_raw(x), iters=5)
    wall = time_ms(lambda: fm.run_raw(x), iters=5)
    kinds = _by_kind(per)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return {"stream_ms": wall, "device_ms": total,
            "idle_share": 1.0 - total / wall if wall > 0 else None,
            "by_kind_ms": kinds,
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


def serve_bert(detail):
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models.bert import get_bert_model
    from incubator_mxnet_tpu_torch.serving import FrozenModel, ModelServer

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
    fm = FrozenModel(net, input_shape=(SEQ,), dtype="int32")
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
    # --- end of the main path ---

    check(not errors, f"client errors: {errors}")
    check(health == (200, "ok"), f"/healthz answered {health}")
    codes = [r[0] for r in results]
    check(codes == [200] * len(ids), f"status codes {codes}")
    batches = stats["serving.batches"]
    warmups = stats["serving.warmup_runs"]
    check(executed == warmups + batches == len(fm.buckets) + batches,
          f"executed {executed} != {warmups} warm-ups + {batches} batches")
    check(counts["flash"] == (12 * executed, 0),
          f"flash launches {counts['flash']} != 12 x {executed} batches")
    check(counts["layer_norm"] == (25 * executed, 0),
          f"layer_norm launches {counts['layer_norm']} != 25 x {executed}")
    log(f"served {len(ids)} requests: {batches} batches + {warmups} warm-ups;"
        f" flash launches {counts['flash'][0]} (12/batch), layer_norm "
        f"launches {counts['layer_norm'][0]} (25/batch)")

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
    err_direct = 0.0
    for bid, members in by_batch.items():
        n = len(members)
        check(sorted(members) == list(range(n)) and all(
            results[i][1]["batch_size"] == n for i in members.values()),
            f"batch {bid} is not whole: {members}")
        order = [members[j] for j in range(n)]
        seq_d, pooled_d = fm.predict_batch(ids[order])
        for row, i in enumerate(order):
            err_direct = max(err_direct,
                             float(np.abs(served[i][0] - seq_d[row]).max()),
                             float(np.abs(served[i][1] - pooled_d[row]).max()))
    check(err_direct <= 1e-4, f"served vs direct predict_batch {err_direct}")

    # every served row against an all-plain forward on the card
    err_plain = 0.0
    with all_plain(), torch.inference_mode():
        for s in range(0, len(ids), 32):
            seq_p, pooled_p = net(torch.from_numpy(ids[s:s + 32]).cuda())
            seq_p, pooled_p = seq_p.cpu().numpy(), pooled_p.cpu().numpy()
            for r in range(len(seq_p)):
                err_plain = max(
                    err_plain,
                    float(np.abs(served[s + r][0] - seq_p[r]).max()),
                    float(np.abs(served[s + r][1] - pooled_p[r]).max()))
    check(err_plain <= 2e-3, f"served vs all-plain forward {err_plain}")

    # device time of each bucket, direct predict_batch with the sync split
    exec_ms = {}
    for b in fm.buckets:
        samples = []
        for _ in range(5):
            t = {}
            fm.predict_batch(ids[:b], timings=t)
            samples.append(t["exec_ms"])
        exec_ms[b] = sorted(samples)[len(samples) // 2]
    breakdown = {b: forward_breakdown(fm, ids, b) for b in (1, 16)}
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
        "requests": len(ids), "ok": codes.count(200),
        "clients": N_CLIENTS, "per_client": PER_CLIENT,
        "requests_per_s": len(ids) / serve_s,
        "client_p50_ms": lat[len(lat) // 2],
        "client_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "client_max_ms": lat[-1],
        "server_p50_ms": stats.get("p50_ms"),
        "server_p99_ms": stats.get("p99_ms"),
        "batches": batches, "mean_batch": len(ids) / batches,
        "executed_batches": executed, "freeze_s": freeze_s,
        "flash_launches": counts["flash"][0],
        "layer_norm_launches": counts["layer_norm"][0],
        "launches": {k: v[0] for k, v in every.items()},
        "max_err_vs_direct": err_direct, "max_err_vs_plain": err_plain,
        "exec_ms_by_bucket": exec_ms,
        "batch_ms_by_bucket": {
            k.rsplit(".b", 1)[1]: v["p50"] for k, v in stats.items()
            if k.startswith("serving.exec_ms.b")},
        "response_bytes": len(body), "json_encode_ms": encode_ms,
        "json_decode_ms": decode_ms, "forward_breakdown": breakdown,
    }
    detail["serving"] = summary
    log("serving: " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# the slice: GPT-2-base trained through autograd and Trainer("adam")
# ---------------------------------------------------------------------------

# GPT-2-base at bench.py's full-width configuration; the rehearsal on a CPU
# cuts depth and widths through train_lm's arguments
LM = dict(vocab_size=50257, batch=8, seq=512, period=16, steps=30, lr=1e-3,
          prompt=32, new_tokens=16)
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


def train_lm(detail, cfg=LM, **model_kw):
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import autograd, gluon, gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import lm_loss, transformer_lm_base

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
    trainer = gluon.Trainer(net, "adam", {"learning_rate": cfg["lr"]})
    params = dict(net.named_parameters())

    def forward():
        with autograd.record():
            return lm_loss(net(x), x)

    # the all-plain step from the same weights, for step 0's gradients
    with all_plain():
        loss_plain = forward()
        autograd.backward(loss_plain)
    loss_plain = float(loss_plain.detach().mean())
    plain_grads = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None

    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    profiler.reset_counters()
    losses, phases, grad_err = [], [], {}
    for step in range(steps):
        t_a = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        autograd.backward(loss)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        if step == 0:
            for n, p in params.items():
                ref = plain_grads.pop(n)
                grad_err[n] = (float((p.grad - ref).abs().max()),
                               float(ref.abs().max()))
            torch.cuda.synchronize()
        t_d = time.perf_counter()
        trainer.step(b)
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        losses.append(float(loss.detach().mean()))
        phases.append((t_b - t_a, t_c - t_b, t_e - t_d))
    counts = kernel_counts()
    trainer_steps = profiler.counters().get("mxtpu/trainer.steps")
    peak_bytes = torch.cuda.max_memory_allocated()
    # --- end of the main path ---

    per_step = {"flash_fwd": n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers, "layer_norm": 2 * n_layers + 1}
    for kind, n in per_step.items():
        check(counts[kind] == (n * steps, 0),
              f"training: {kind} (launches, plain calls) {counts[kind]} != "
              f"({n} x {steps} steps, 0)")
    check(trainer_steps == steps, f"trainer.steps {trainer_steps} != {steps}")
    log(f"trained {steps} steps: launches per step " + ", ".join(
        f"{k} {counts[k][0] // steps}" for k in per_step) + ", plain calls 0")
    loss_err = abs(losses[0] - loss_plain)
    check(loss_err <= 1e-4 * loss_plain,
          f"step 0 loss {losses[0]} vs all-plain {loss_plain}")
    worst = max(grad_err, key=lambda n: grad_err[n][0] / max(
        grad_err[n][1], 1e-30))
    worst_ratio = grad_err[worst][0] / max(grad_err[worst][1], 1e-30)
    check(all(np.isfinite(e) and e <= GRAD_RTOL * scale
              for e, scale in grad_err.values()),
          f"step 0 gradients vs all-plain: {worst} off by "
          f"{grad_err[worst][0]} against its largest {grad_err[worst][1]}")
    log(f"step 0 vs all-plain: loss {losses[0]:.6f} vs {loss_plain:.6f}; "
        f"worst gradient {worst}: max diff {grad_err[worst][0]:.3e} of its "
        f"largest {grad_err[worst][1]:.3e} ({worst_ratio:.2e})")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < 0.5 * losses[0],
          f"loss {losses[0]} -> {losses[-1]} after {steps} steps: not below "
          f"half")
    log("losses: " + " ".join(f"{v:.4f}" for v in losses))

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
    check(np.array_equal(got, want),
          f"generate did not continue the period: {got.tolist()} vs "
          f"{want.tolist()}")
    with torch.no_grad():
        logits = net(prompt)[:, -1].float()
        with all_plain():
            logits_plain = net(prompt)[:, -1].float()
    prefill_err = float((logits - logits_plain).abs().max())
    logit_scale = float(logits_plain.abs().max())
    check(prefill_err <= 1e-4 * max(1.0, logit_scale),
          f"prefill logits vs all-plain: {prefill_err} (largest "
          f"{logit_scale})")
    log(f"generate: {new} tokens continue the period for both prompts; "
        f"prefill flash launches {gen_counts[0]}; prefill logits vs "
        f"all-plain {prefill_err:.2e} (largest {logit_scale:.2f})")

    # where one step's time goes on the card (it trains on: steps 31+)
    def train_step():
        loss = forward()
        autograd.backward(loss)
        trainer.step(b)

    dev_total, per = device_ms(train_step, iters=3)
    stream = time_ms(train_step, iters=3)
    kinds = _by_kind(per)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    timed = phases[2:] or phases
    med = [sorted(p[i] for p in timed)[len(timed) // 2] * 1e3
           for i in range(3)]
    step_ms = sorted(sum(p) for p in timed)[len(timed) // 2] * 1e3
    tokens = b * seq
    model_flops = 6.0 * n_params * tokens
    summary = {
        "config": dict(cfg, layers=n_layers, units=net._units,
                       params=n_params, dtype="float32", tf32=False),
        "losses": losses, "loss_plain_step0": loss_plain,
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_step": per_step,
        "step0_grad_worst": [worst, grad_err[worst][0], grad_err[worst][1]],
        "step_ms_median": step_ms, "forward_ms_median": med[0],
        "backward_ms_median": med[1], "optimizer_ms_median": med[2],
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_memory_bytes": peak_bytes,
        "step_device_ms": dev_total, "step_stream_ms": stream,
        "idle_share": 1.0 - dev_total / stream if stream > 0 else None,
        "step_by_kind_ms": kinds,
        "matmul_tflops": (model_flops / (kinds["matmul"] / 1e3) / 1e12
                          if kinds.get("matmul") else None),
        "top_kernels_ms": [[n[:80], ms] for n, ms in top],
        "generated": got.tolist(), "prefill_logit_err": prefill_err,
    }
    detail["training"] = summary
    log("training: " + json.dumps({k: v for k, v in summary.items()
                                   if k not in ("losses", "generated")}))
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


def reduces_per_forward(bucket, layers, channels, image):
    """Launches of the split-K reduce kernel in one predict forward of
    `bucket` images: the GEMMs whose plan splits K."""
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    return sum(cbr.mm_plan(bucket * pix, n, k, torch.float32)[1] > 1
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


def train_resnet(detail, cfg=RESNET, **net_kw):
    """ResNet-50 v1 (resnet50_v1_bnrelu) trained on one fixed batch through
    autograd.record -> SoftmaxCrossEntropyLoss -> autograd.backward ->
    Trainer("sgd", momentum, wd). Returns (summary, the trained net)."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import autograd, gluon, gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params

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
        np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, cfg["classes"], b)).to(device)
    trainer = gluon.Trainer(net, "sgd", {"learning_rate": cfg["lr"],
                                         "momentum": cfg["momentum"],
                                         "wd": cfg["wd"]})
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
    loss_plain = float(loss_plain.detach().mean())
    plain_grads = {n: p.grad for n, p in params.items()}
    plain_stats = {n: t.clone() for n, t in buffers.items()}
    with torch.no_grad():
        for n, t in buffers.items():
            t.copy_(stats0[n])
    for p in params.values():
        p.grad = None

    # --- the main path: counts at zero just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
            for n, p in params.items():
                ref = plain_grads.pop(n)
                grad_err[n] = (float((p.grad - ref).abs().max()),
                               float(ref.abs().max()))
            for n, t in buffers.items():
                stat_err[n] = (float((t - plain_stats[n]).abs().max()),
                               float(plain_stats[n].abs().max()))
            torch.cuda.synchronize()
        t_d = time.perf_counter()
        trainer.step(b)
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        losses.append(float(loss.detach().mean()))
        phases.append((t_b - t_a, t_c - t_b, t_e - t_d))
    counts = kernel_counts()
    turned_away = rejections()
    trainer_steps = profiler.counters().get("mxtpu/trainer.steps")
    peak_bytes = torch.cuda.max_memory_allocated()
    # --- end of the main path ---

    ssa, mm = per_fwd["train"]
    check(counts["scale_shift_act"] == (ssa * steps, 0),
          f"training: scale_shift_act (launches, plain calls) "
          f"{counts['scale_shift_act']} != ({ssa} x {steps} steps, 0)")
    check(counts["mm_epilogue"] == (mm, 0) and
          counts["mm_splitk_reduce"] == (0, 0),
          f"training: mm_epilogue {counts['mm_epilogue']}, "
          f"mm_splitk_reduce {counts['mm_splitk_reduce']} != (0, 0)")
    check(not turned_away, f"training: kernel selections rejected "
                           f"{turned_away}")
    check(trainer_steps == steps, f"trainer.steps {trainer_steps} != {steps}")
    log(f"trained {steps} steps: scale_shift_act launches "
        f"{counts['scale_shift_act'][0]} ({ssa} a step), plain calls 0, "
        f"rejections 0")
    loss_err = abs(losses[0] - loss_plain)
    check(loss_err <= 1e-4 * loss_plain,
          f"step 0 loss {losses[0]} vs all-plain {loss_plain}")

    def worst_of(errs):
        n = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-30))
        return n, errs[n][0], errs[n][1]

    worst = worst_of(grad_err)
    check(all(np.isfinite(e) and e <= GRAD_RTOL * scale
              for e, scale in grad_err.values()),
          f"step 0 gradients vs all-plain: {worst[0]} off by {worst[1]} "
          f"against its largest {worst[2]}")
    worst_stat = worst_of(stat_err)
    check(all(np.isfinite(e) and e <= 1e-5 * max(scale, 1.0)
              for e, scale in stat_err.values()),
          f"step 0 moving statistics vs all-plain: {worst_stat}")
    log(f"step 0 vs all-plain: loss {losses[0]:.6f} vs {loss_plain:.6f}; "
        f"worst gradient {worst[0]}: {worst[1]:.3e} of {worst[2]:.3e}; "
        f"worst moving statistic {worst_stat[0]}: {worst_stat[1]:.3e} of "
        f"{worst_stat[2]:.3e}")
    log("losses: " + " ".join(f"{v:.4f}" for v in losses))
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < 0.5 * losses[0],
          f"loss {losses[0]} -> {losses[-1]} after {steps} steps: not below "
          f"half")

    # where one step's time goes on the card (it trains on: steps 31+)
    def train_step():
        loss = forward()
        autograd.backward(loss)
        trainer.step(b)

    dev_total, per = device_ms(train_step, iters=3)
    stream = time_ms(train_step, iters=3)
    kinds = _by_kind(per)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    timed = phases[2:] or phases
    med = [sorted(p[i] for p in timed)[len(timed) // 2] * 1e3
           for i in range(3)]
    step_ms = sorted(sum(p) for p in timed)[len(timed) // 2] * 1e3
    summary = {
        "config": dict(cfg, layers=list(layers), params=n_params,
                       dtype="float32", tf32=False, layout="NHWC"),
        "losses": losses, "loss_plain_step0": loss_plain,
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_step": {"scale_shift_act": ssa, "mm_epilogue": mm},
        "step0_grad_worst": list(worst),
        "step0_moving_stat_worst": list(worst_stat),
        "step_ms_median": step_ms, "forward_ms_median": med[0],
        "backward_ms_median": med[1], "optimizer_ms_median": med[2],
        "images_per_s": b / (step_ms / 1e3),
        "peak_memory_bytes": peak_bytes,
        "step_device_ms": dev_total, "step_stream_ms": stream,
        "idle_share": 1.0 - dev_total / stream if stream > 0 else None,
        "step_by_kind_ms": kinds,
        "top_kernels_ms": [[n[:80], ms] for n, ms in top],
    }
    detail["resnet_training"] = summary
    log("resnet training: " + json.dumps(
        {k: v for k, v in summary.items() if k != "losses"}))
    return summary, net


def serve_resnet(detail, net, cfg=RESNET, **net_kw):
    """The trained network frozen and served: FrozenModel -> DynamicBatcher,
    `serve_threads` threads of `serve_per_thread` images each, in process.
    Every answer is held against a direct predict_batch of its batch and an
    all-plain forward; the zoo resnet50_v1 with the same weights against
    the network's predict logits."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import gpu, profiler
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import resnet
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    from incubator_mxnet_tpu_torch.serving import DynamicBatcher, FrozenModel

    hw = cfg["image"]
    layers = net_kw.get("layers", (3, 4, 6, 3))
    n_threads, per_thread = cfg["serve_threads"], cfg["serve_per_thread"]
    imgs = np.random.RandomState(5).standard_normal(
        (n_threads * per_thread, hw, hw, 3)).astype(np.float32)
    ssa, mm = bnrelu_launches(layers)["predict"]
    channels = net_kw.get("channels", (64, 256, 512, 1024, 2048))
    check(len(bnrelu_gemm_shapes(layers, channels, hw)) == mm,
          "bnrelu_gemm_shapes disagrees with bnrelu_launches")
    reduces = {bk: reduces_per_forward(bk, layers, channels, hw)
               for bk in cfg["buckets"]}

    # --- the main path: counts at zero just before, read just after ---
    reset_kernel_counts()
    profiler.reset_counters()
    t_freeze = time.perf_counter()
    fm = FrozenModel(net, input_shape=(hw, hw, 3), dtype="float32",
                     batch_buckets=cfg["buckets"])
    freeze_s = time.perf_counter() - t_freeze
    batcher = DynamicBatcher(fm, max_delay_ms=5.0, queue_limit=256,
                             default_timeout_ms=60000.0).start()
    results = [None] * len(imgs)
    errors = []

    def client(c):
        try:
            for j in range(per_thread):
                i = c * per_thread + j
                t = time.perf_counter()
                req = batcher.submit(imgs[i])
                out = req.wait(600)
                results[i] = (out[0], req.batch_id, req.batch_index,
                              req.batch_size,
                              (time.perf_counter() - t) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        t_serve = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        serve_s = time.perf_counter() - t_serve
        check(not any(t.is_alive() for t in threads), "clients hung")
    finally:
        batcher.stop()
    counts = kernel_counts()
    turned_away = rejections()
    copies = cbr.nhwc_copies
    stats = DynamicBatcher.stats()
    executed = profiler.counters()["serving/serving.executed_batches"]
    # --- end of the main path ---

    check(not errors, f"client errors: {errors}")
    batches = stats["serving.batches"]
    check(executed == len(fm.buckets) + batches,
          f"executed {executed} != {len(fm.buckets)} warm-ups + {batches}")
    check(counts["scale_shift_act"] == (ssa * executed, 0),
          f"serving: scale_shift_act {counts['scale_shift_act']} != "
          f"({ssa} x {executed} batches, 0)")
    check(counts["mm_epilogue"] == (mm * executed, 0),
          f"serving: mm_epilogue {counts['mm_epilogue']} != ({mm} x "
          f"{executed} batches, 0)")
    # the split-K pass: each warm-up's bucket and each batch's
    sizes = {r[1]: r[3] for r in results if r is not None}
    want = (sum(reduces.values())
            + sum(reduces[fm.bucket_for(sz)] for sz in sizes.values()))
    check(counts["mm_splitk_reduce"] == (want, 0),
          f"serving: mm_splitk_reduce {counts['mm_splitk_reduce']} != "
          f"({want}, 0) (per forward by bucket {reduces})")
    check(want > 0 or net_kw, "serving: no GEMM split K, so the reduce "
                              "kernel never ran on the main path")
    check(not turned_away, f"serving: kernel selections rejected "
                           f"{turned_away}")
    log(f"served {len(imgs)} images: {batches} batches + {len(fm.buckets)} "
        f"warm-ups; scale_shift_act {counts['scale_shift_act'][0]} ({ssa}/"
        f"batch), mm_epilogue {counts['mm_epilogue'][0]} ({mm}/batch), "
        f"mm_splitk_reduce {counts['mm_splitk_reduce'][0]} (by bucket "
        f"{reduces}), rejections 0, NHWC copies {copies}")

    classes = cfg["classes"]
    for out, *_ in results:
        check(out.shape == (classes,) and np.isfinite(out).all(),
              f"served output of shape {out.shape} or not finite")
    # every answer against a direct predict_batch of its batch
    by_batch = {}
    for i, r in enumerate(results):
        by_batch.setdefault(r[1], {})[r[2]] = i
    err_direct = 0.0
    for bid, members in by_batch.items():
        n = len(members)
        check(sorted(members) == list(range(n)) and all(
            results[i][3] == n for i in members.values()),
            f"batch {bid} is not whole: {members}")
        order = [members[j] for j in range(n)]
        (direct,) = fm.predict_batch(imgs[order])
        for row, i in enumerate(order):
            err_direct = max(err_direct,
                             float(np.abs(results[i][0] - direct[row]).max()))
    served = np.stack([r[0] for r in results])
    scale = float(np.abs(served).max())
    check(err_direct <= 1e-5 * max(1.0, scale),
          f"served vs direct predict_batch {err_direct} (largest {scale})")
    # every answer against an all-plain predict forward on the card
    device = next(net.parameters()).device
    with all_plain(), torch.inference_mode():
        plain = np.concatenate([
            net(torch.from_numpy(imgs[s:s + 32]).to(device)).cpu().numpy()
            for s in range(0, len(imgs), 32)])
    err_plain = float(np.abs(served - plain).max())
    check(err_plain <= 1e-3 * max(1.0, scale),
          f"served vs all-plain forward {err_plain} (largest {scale})")
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
    with torch.inference_mode():
        z = zoo(torch.from_numpy(imgs[:8]).to(device)).cpu().numpy()
    err_zoo = float(np.abs(z - served[:8]).max())
    check(err_zoo <= 1e-3 * max(1.0, scale),
          f"zoo resnet50_v1 vs the network's predict logits {err_zoo}")
    log(f"served answers vs direct predict_batch {err_direct:.2e}, vs "
        f"all-plain {err_plain:.2e}, zoo resnet50_v1 vs network "
        f"{err_zoo:.2e} (largest logit {scale:.2f})")

    exec_ms = {}
    for bk in fm.buckets:
        samples = []
        for _ in range(5):
            t = {}
            fm.predict_batch(imgs[:bk], timings=t)
            samples.append(t["exec_ms"])
        exec_ms[bk] = sorted(samples)[len(samples) // 2]
    big = fm.buckets[-1]
    breakdown = forward_breakdown(fm, imgs, big)
    lat = sorted(r[4] for r in results)
    summary = {
        "images": len(imgs), "threads": n_threads,
        "per_thread": per_thread, "images_per_s": len(imgs) / serve_s,
        "latency_p50_ms": lat[len(lat) // 2], "latency_max_ms": lat[-1],
        "batches": batches, "mean_batch": len(imgs) / batches,
        "executed_batches": executed, "freeze_s": freeze_s,
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_batch": {"scale_shift_act": ssa, "mm_epilogue": mm,
                               "mm_splitk_reduce_by_bucket": reduces},
        "nhwc_copies": copies,
        "max_err_vs_direct": err_direct, "max_err_vs_plain": err_plain,
        "max_err_zoo": err_zoo, "largest_logit": scale,
        "exec_ms_by_bucket": exec_ms,
        "forward_breakdown": {big: breakdown},
    }
    detail["resnet_serving"] = summary
    log("resnet serving: " + json.dumps(summary))
    return summary


def kernel_line(records, paths):
    """The {"kernels": [...]} record: each kernel at its main path's shape,
    f32, with its launches on each main path (`paths`: path name -> its
    summary, whose "launches" holds every kernel's count)."""
    def pick(kernel, case):
        return next(r for r in records if r["kernel"] == kernel
                    and r["case"] == case and r["dtype"] == "float32"
                    and r.get("eps", 1e-12) == 1e-12
                    and r.get("act", "relu") in ("relu", None)
                    and "kernel_ms" in r)

    csrc = "incubator_mxnet_tpu_torch/ops/cuda/csrc/"
    pallas = "incubator_mxnet_tpu/ops/pallas/"
    line = []
    for name, count, case, source, replaces in (
            ("flash_attention_fwd", "flash_fwd", "bert_b8",
             "flash_attention.cu", "flash_attention.py:109"),
            ("flash_attention_bwd_dq", "flash_bwd_dq", "lm_b8_l512_causal",
             "flash_attention_bwd.cu", "flash_attention.py:237"),
            ("flash_attention_bwd_dkv", "flash_bwd_dkv", "lm_b8_l512_causal",
             "flash_attention_bwd.cu", "flash_attention.py:254"),
            ("layer_norm_fwd", "layer_norm", "rows1024", "layer_norm.cu",
             "layer_norm.py:44"),
            ("scale_shift_act", "scale_shift_act", "stem_b128",
             "conv_bn_relu.cu", "conv_bn_relu.py:75"),
            ("mm_epilogue", "mm_epilogue", "s2_conv3", "conv_bn_relu.cu",
             "conv_bn_relu.py:190"),
            ("mm_splitk_reduce", "mm_splitk_reduce", "s4_conv1_b4",
             "conv_bn_relu.cu", "conv_bn_relu.py:190")):
        r = pick(name, case)
        worst = max(x["max_abs_err"] for x in records
                    if x["kernel"] == name and x["dtype"] == "float32")
        launches = {path: s["launches"].get(count, 0)
                    for path, s in paths.items()}
        entry = {
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": pallas + replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": r["max_abs_err"], "max_abs_err_f32_all": worst,
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timer": r["kernel_timer"],
            "wall_ms": r["kernel_wall_ms"],
            "function_wall_ms": r.get("function_wall_ms"),
            "library_wall_ms": r["library_wall_ms"], "case": case,
            "shape": r["shape"], "dtype": "float32"}
        if name == "flash_attention_fwd":
            lm = pick(name, "lm_b8_l512_causal")
            entry["lm_b8_l512_causal"] = {
                k: lm[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "max_abs_err")}
        if name == "mm_epilogue":
            entry["plan"] = r["plan"]
            entry["tflops"] = r["tflops"]
            entry["bucket4"] = {
                x["case"]: {k: x[k] for k in (
                    "plan", "kernel_ms", "plain_ms", "library_ms",
                    "bound_ms", "tflops")}
                for x in records if x["kernel"] == name
                and x["dtype"] == "float32" and x.get("bucket") == 4}
        if name in ("scale_shift_act", "mm_epilogue"):
            # the kernel's device time over the shapes of one training step
            # (row 5) or one bucket-32 forward (row 6), f32 and bf16
            per = (SSA_PER_STEP if name == "scale_shift_act" else
                   {c[0]: c[5] for c in mm_cases() if c[6] == 32})
            for dtype in ("float32", "bfloat16"):
                rows = [x for x in records if x["kernel"] == name
                        and x["dtype"] == dtype and x["case"] in per
                        and "kernel_ms" in x]
                entry["per_step_or_forward_" + dtype] = {
                    k: sum(per[x["case"]] * x[k] for x in rows)
                    for k in ("kernel_ms", "plain_ms", "library_ms",
                              "bound_ms")}
        line.append(entry)
    return line


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
            if "registers" in line or "spill" in line:
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
    paths = {"serve_bert": serve_bert(detail), "train_lm": train_lm(detail)}
    torch.cuda.empty_cache()
    paths["train_resnet"], net = train_resnet(detail)
    paths["serve_resnet"] = serve_resnet(detail, net)
    line = kernel_line(records, paths)
    detail["profiler_traces"] = TRACES
    log(f"profiler traces: {TRACES['taken']} taken, {TRACES['short']} short "
        f"and taken again, {TRACES['stream_time']} times read from the "
        f"stream instead")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "detail.json").write_text(json.dumps(detail, indent=1))
    log(gpu_name_and_limit())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
