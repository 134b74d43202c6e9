#!/usr/bin/env python3
"""A/B of two or more checkouts of the port on one card: the fused 1x1-conv
GEMM at ResNet-50's shapes, and ResNet-50 served through FrozenModel ->
DynamicBatcher.

    python3 incubator_mxnet_tpu_torch/tools/ab_resnet.py \\
        pr3=scratch_tree/pr3 new=. [--rounds 2] [--out chiprun_out/ab_resnet]

Each argument is ``label=root``, where root holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch/`` (for instance a ``git archive`` of a parent
commit, unpacked). Every side runs in a process of its own that imports the
package and ``chip_smoke`` of its root only, builds that root's GEMM kernel,
and measures with this script's code, so that every side is timed with the
same yardstick. The sides run in order and then in reverse, ``--rounds``
times in all (A, B, B, A for two sides and two rounds), so that a drift of
the card or the host over the call shows as a difference between rounds.

A side measures, with TF32 off:

* the GEMM wrapper (``ops.cuda.conv_bn_relu.mm_epilogue``) at ResNet-50's
  nine 1x1/stride-1 shapes at bucket 32 (f32 and bf16), stage 3's and 4's
  first conv at bucket 4 and stage 4's two convs at bucket 1 (f32): device
  time per call from ``torch.profiler``, summed over the kernels of 20
  calls. A trace is kept only if it holds exactly 20 times the launches
  the wrapper counted for one call; a short trace (the profiler dropped
  events) is counted in ``short_traces`` and taken again, four times at
  most, after which the time is null;
* the root's own ``chip_smoke.serve_resnet`` on ``resnet50_v1_bnrelu``
  with Normal(0.02) weights from seed 0 (images/s, latency, ``exec_ms`` by
  bucket, a bucket-32 forward's device breakdown, and every check the
  root's serving phase makes);
* ``exec_ms`` of ``FrozenModel.predict_batch`` at buckets 1, 4 and 32, 21
  times each, and the device time of one forward at each bucket (two
  traces of five forwards, with their event counts).

The script writes each side's JSON and log and ``ab.json`` under ``--out``
and prints one line per measurement: every run's value in run order, each
side's quartiles and, with two sides, in how many rounds the second read
lower. ``--report <ab.json>`` prints that report again, without a card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

if __package__:
    from . import _ab
else:                # run as a script: its directory is on sys.path
    import _ab

# (name, pixels per image, K, N, act, launches per forward): the 1x1,
# stride-1 convs of ResNet-50 at 224 x 224
GEMMS = [("s1_conv1_first", 56 * 56, 64, 64, "relu", 1),
         ("s1_conv3_ds", 56 * 56, 64, 256, None, 4),
         ("s1_conv1", 56 * 56, 256, 64, "relu", 2),
         ("s2_conv3", 28 * 28, 128, 512, None, 4),
         ("s2_conv1", 28 * 28, 512, 128, "relu", 3),
         ("s3_conv3", 14 * 14, 256, 1024, None, 6),
         ("s3_conv1", 14 * 14, 1024, 256, "relu", 5),
         ("s4_conv3", 7 * 7, 512, 2048, None, 3),
         ("s4_conv1", 7 * 7, 2048, 512, "relu", 2)]
# (bucket, dtypes, the GEMMs timed there)
TIMED = [(32, ("float32", "bfloat16"), [g[0] for g in GEMMS]),
         (4, ("float32",), ["s3_conv1", "s4_conv1"]),
         (1, ("float32",), ["s4_conv3", "s4_conv1"])]
EXEC_BUCKETS = (1, 4, 32)


def time_gemms(cbr):
    """Every case of TIMED through the root's mm_epilogue."""
    import math
    import torch
    launches = lambda: (cbr.mm_launches  # noqa: E731
                        + getattr(cbr, "mm_reduce_launches", 0))
    plan_of = getattr(cbr, "mm_plan", None)
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = {g[0]: g for g in GEMMS}
    out = []
    for bucket, dtypes, names in TIMED:
        for name in names:
            _, pixels, k, n, act, per_fwd = shapes[name]
            m = bucket * pixels
            for dtype in dtypes:
                tdt = getattr(torch, dtype)
                x = torch.randn(m, k, generator=gen, device="cuda").to(tdt)
                w = (torch.randn(k, n, generator=gen, device="cuda")
                     / math.sqrt(k)).to(tdt)
                s = torch.rand(n, generator=gen, device="cuda") + 0.5
                b = torch.randn(n, generator=gen, device="cuda")
                before = launches()
                cbr.mm_epilogue(x, w, s, b, act)
                per_call = launches() - before
                ms, short = _ab.trace_ms(
                    lambda: cbr.mm_epilogue(x, w, s, b, act),
                    lambda c: sum(c.values()) == _ab.ITERS * per_call)
                plan = None
                if plan_of is not None:
                    (bm, bn), split = plan_of(m, n, k, tdt)
                    plan = f"{bm}x{bn}/{split}"
                out.append(dict(case=f"{name}_b{bucket}", dtype=dtype,
                                shape=[m, k, n], per_forward=per_fwd,
                                bucket=bucket, launches_per_call=per_call,
                                plan=plan, ms=ms, short_traces=short))
                print(f"gemm {name}_b{bucket} {dtype} plan {plan} ms {ms} "
                      f"short traces {short}", flush=True)
    return out


def forward_sums(gemms):
    """A bucket-32 forward's 30 GEMM launches, by dtype (null if a case
    has no time)."""
    sums = {}
    for dtype in ("float32", "bfloat16"):
        rows = [g for g in gemms if g["bucket"] == 32 and g["dtype"] == dtype]
        sums[dtype] = (None if any(g["ms"] is None for g in rows) else
                       sum(g["per_forward"] * g["ms"] for g in rows))
    return sums


def time_exec(net, samples=21):
    """exec_ms of predict_batch (21 samples) and two device-time traces of
    five forwards at each of EXEC_BUCKETS."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.serving import FrozenModel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fm = FrozenModel(net, input_shape=(224, 224, 3), dtype="float32",
                     batch_buckets=EXEC_BUCKETS)
    imgs = np.random.RandomState(6).standard_normal(
        (EXEC_BUCKETS[-1], 224, 224, 3)).astype(np.float32)
    out = {}
    for bk in EXEC_BUCKETS:
        ms = []
        for _ in range(samples):
            t = {}
            fm.predict_batch(imgs[:bk], timings=t)
            ms.append(t["exec_ms"])
        traces = []
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fm.run_raw(imgs[:bk])
                torch.cuda.synchronize()
            dev = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
            traces.append(dict(
                ms=sum(e.self_device_time_total for e in dev) / 5 / 1e3,
                events=sum(e.count for e in dev)))
        out[bk] = dict(exec_ms_median=sorted(ms)[len(ms) // 2],
                       exec_ms=ms, device=traces)
        print(f"exec bucket {bk}: median {out[bk]['exec_ms_median']:.3f} "
              f"ms, device {[t['ms'] for t in traces]} ms", flush=True)
    return out


def run_side(root):
    """One side: the root's package and chip_smoke, this script's
    measurements."""
    cs, _ = _ab.import_root(root)
    import torch
    from incubator_mxnet_tpu_torch import gpu
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    t0 = time.perf_counter()
    build_s = _build.build(("conv_bn_relu",))
    result = {"root": str(Path(root).resolve()),
              "card": cs.gpu_name_and_limit(), "torch": torch.__version__,
              "build_s": build_s,
              "build_wall_s": time.perf_counter() - t0}
    gemms = time_gemms(cbr)
    result["gemms"] = gemms
    result["forward_gemm_ms"] = forward_sums(gemms)
    net = cs.resnet50_v1_bnrelu(classes=1000, ctx=gpu(0))
    load_jax_params(net, cs.normal_arrays(net, seed=0))
    serving = cs.serve_resnet({}, net)
    result["serving"] = {k: serving[k] for k in (
        "images_per_s", "mean_batch", "batches", "latency_p50_ms",
        "latency_max_ms", "exec_ms_by_bucket", "forward_breakdown",
        "launches", "max_err_vs_direct", "max_err_vs_plain")}
    result["exec"] = time_exec(net)
    return result


def metrics(result):
    """{name: value} of one side's run. A forward's device time is read
    from the trace with the most kernel events (a short trace dropped
    some)."""
    m = {f"gemm {g['case']} {g['dtype']} ms": g["ms"]
         for g in result["gemms"]}
    for dtype, v in result["forward_gemm_ms"].items():
        m[f"bucket-32 forward's GEMMs {dtype} ms"] = v
    for key in ("images_per_s", "mean_batch", "latency_p50_ms"):
        m[f"serving {key}"] = result["serving"][key]
    for bk, e in result["exec"].items():
        m[f"exec_ms bucket {bk}"] = e["exec_ms_median"]
        m[f"forward device ms bucket {bk}"] = max(
            e["device"], key=lambda t: t["events"])["ms"]
    return m


def notes(runs):
    """The short traces: GEMM times taken again, and forward traces with
    fewer kernel events than the most a side's traces held."""
    short = sum(g["short_traces"] for _, r in runs for g in r["gemms"])
    total = sum(len(r["gemms"]) for _, r in runs)
    yield f"short GEMM traces: {short} (of {total} times)"
    for label in dict.fromkeys(label for label, _ in runs):
        for bk in runs[0][1]["exec"]:
            traces = [t for lab, r in runs if lab == label
                      for t in r["exec"][bk]["device"]]
            whole = max(t["events"] for t in traces)
            yield (f"forward traces {label} bucket {bk}: "
                   f"{sum(t['events'] < whole for t in traces)} of "
                   f"{len(traces)} short (fewer than {whole} events)")


def main(argv=None):
    return _ab.main(argv, __doc__, __file__, run_side, metrics, notes,
                    default_out="chiprun_out/ab_resnet")


if __name__ == "__main__":
    sys.exit(main())
