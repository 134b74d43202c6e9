#!/usr/bin/env python3
"""A/B of two or more checkouts of the port on one card: the layer-norm
forward kernel at every case of chip_smoke's ``layer_norm_cases()``, a
whole ``ops.layer_norm`` call, and one bf16 BERT-base bucket-16 replay.

    python3 incubator_mxnet_tpu_torch/tools/ab_layer_norm.py \\
        parent=scratch_tree/parent new=. [--rounds 8] \\
        [--out chiprun_out/ab_layer_norm]

Each argument is ``label=root``, where root holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch/`` (for instance a ``git archive`` of a parent
commit, unpacked). Every side runs in a process of its own that imports the
package and ``chip_smoke`` of its root only, builds that root's kernels,
and measures with this script's code (``_ab``). The cases are those of the
``chip_smoke.py`` beside this script, so that every side runs the same
ones. The sides run in order and then in reverse, ``--rounds`` times in all.

A side measures, with TF32 off:

* at every case (rows x D) in f32 and bf16, x from a seeded normal and
  gamma and beta in x's dtype (the models' parameters on the f32 paths,
  and under amp and ``compute_dtype="bfloat16"``), ``ops.layer_norm`` as
  the models call it (under ``torch.inference_mode``): the layer-norm
  kernel's device time a call (``kernel ms``), the device time of every
  kernel the call launches (``call ms``: a side that casts gamma and beta
  first launches its casts too) and the kernels it launches a call. Each
  case is first held against the root's ``layer_norm_ref`` (f32 1e-5,
  bf16 2e-2; the side stops if one is off). The byte bound (x read and y
  written once, gamma and beta once, at 3.35 TB/s) stands beside each;
* one replay of BERT-base (bert_12_768_12, chip_smoke's weights and ids)
  frozen with ``compute_dtype="bfloat16"`` at bucket 16 only, through the
  root's ``chip_smoke.forward_breakdown``: device and stream ms, device ms
  by kind of kernel, and the kernels a replay launches;
* the compiler's registers, spills and stack frames of the root's
  layer-norm kernels (``nvcc -Xptxas -v``).

Every time is device time per call from ``torch.profiler`` over 20 calls,
from a trace in which every kernel ran a whole multiple of 20 times and the
layer-norm kernel (the root's ``chip_smoke._kernel_kind``) exactly 20
times; a short trace is counted and taken again, four times at most, after
which the time is null. x stays in the 50 MB L2 from one call to the next,
as a layer norm's input mostly does on the models' paths (the previous
kernel wrote it), so a time can beat the bound set by device memory.

The script writes each side's JSON and log and ``ab.json`` under ``--out``
and prints one line per measurement: every run's value in run order, each
side's quartiles and, for each side after the first, in how many rounds it
read lower than the first. ``--report <ab.json>`` prints that report
again, without a card.
"""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

if __package__:
    from . import _ab
else:                # run as a script: its directory is on sys.path
    import _ab

BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA's data sheet)
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
EPS = 1e-12             # BERT's


def cases():
    """``layer_norm_cases()`` of the chip_smoke.py beside this script (a
    parent's may not have it), loaded under a name of its own."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_ab_layer_norm_cases",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.layer_norm_cases()


def trace(fn, ours):
    """(our kernels' ms, every kernel's ms, kernels launched) a call of
    `fn`, short traces, kernel names: from the first whole trace of
    ``_ab.ITERS`` calls (every kernel a whole multiple of the calls, the
    kernels `ours` accepts once a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = _ab.ITERS
    fn()
    torch.cuda.synchronize()
    short = 0
    for _ in range(_ab.TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ms, counts = {}, {}
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                ms[e.key] = ms.get(e.key, 0.0) + e.self_device_time_total
                counts[e.key] = counts.get(e.key, 0) + e.count
        mine = [k for k in counts if ours(k)]
        if (mine and sum(counts[k] for k in mine) == n
                and all(c % n == 0 for c in counts.values())):
            return (sum(ms[k] for k in mine) / n / 1e3,
                    sum(ms.values()) / n / 1e3,
                    sum(counts.values()) / n, short, sorted(counts))
        short += 1
    return None, None, None, short, []


def time_layer_norm(cs, ops, ln):
    """Every (case, dtype) record of the side."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    ours = lambda name: cs._kernel_kind(name) == "layer_norm"  # noqa: E731
    records = []
    for case, rows, d, dtype in cases():
        tdt = getattr(torch, dtype)
        x = (torch.randn(rows, d, generator=gen, device="cuda") * 2
             + 0.5).to(tdt)
        g, b = (torch.randn(d, generator=gen, device="cuda").to(tdt)
                for _ in range(2))
        with torch.inference_mode():
            y = ops.layer_norm(x, g, b, eps=EPS)
            ref = ln.layer_norm_ref(x, g, b, EPS)
            err = float((y.float() - ref.float()).abs().max())
            if not torch.allclose(y.float(), ref.float(), rtol=TOLS[dtype],
                                  atol=TOLS[dtype]):
                raise SystemExit(f"A/B: layer_norm {case} {dtype}: max "
                                 f"|y - plain| {err}")
            kernel, call, launched, short, names = trace(
                lambda: ops.layer_norm(x, g, b, eps=EPS), ours)
        nbytes = 2 * rows * d * x.element_size() + 2 * d * g.element_size()
        records.append(dict(
            case=case, rows=rows, d=d, dtype=dtype, max_abs_err=err,
            kernel_ms=kernel, call_ms=call, launches=launched,
            short_traces=short, kernels=names,
            bound_ms=nbytes / BYTES_PER_S * 1e3))
        print(f"{case} {dtype}: kernel {kernel} call {call} ms, "
              f"{launched} kernels a call", flush=True)
    return records


def bert_replay(cs):
    """One bf16 BERT-base replay at bucket 16, by kind of kernel."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import gpu
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models.bert import get_bert_model
    from incubator_mxnet_tpu_torch.serving import FrozenModel
    net = get_bert_model("bert_12_768_12", vocab_size=30522, max_length=512,
                         use_pooler=True, ctx=gpu(0))
    load_jax_params(net, cs.normal_arrays(net, seed=0))
    fm = FrozenModel(net, input_shape=(cs.SEQ,), dtype="int32",
                     batch_buckets=(16,), compute_dtype="bfloat16")
    ids = np.random.RandomState(1).randint(
        0, 30522, (16, cs.SEQ)).astype(np.int32)
    out = cs.forward_breakdown(fm, ids, 16)["replay"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fm.run_raw(ids)
        torch.cuda.synchronize()
    out["kernels_a_replay"] = sum(
        e.count for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA) / 5
    return out


def run_side(root):
    """One side: the root's package and chip_smoke, this script's
    measurements."""
    cs, _ = _ab.import_root(root)
    import torch
    from incubator_mxnet_tpu_torch import ops
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
    t0 = time.perf_counter()
    build_s = _build.build(("layer_norm", "flash_attention"))
    ptxas = [line.strip()
             for line in _build.logs().get("layer_norm", "").splitlines()
             if any(s in line for s in ("entry function", "spill", "Used"))]
    result = {"root": str(Path(root).resolve()),
              "card": cs.gpu_name_and_limit(), "torch": torch.__version__,
              "build_s": build_s, "build_wall_s": time.perf_counter() - t0,
              "ptxas": ptxas}
    result["layer_norm"] = time_layer_norm(cs, ops, ln)
    result["bert_b16_bf16"] = bert_replay(cs)
    return result


def metrics(result):
    """{name: value} of one side's run."""
    m = {}
    for r in result["layer_norm"]:
        m[f"{r['case']} {r['dtype']} kernel ms"] = r["kernel_ms"]
        m[f"{r['case']} {r['dtype']} call ms"] = r["call_ms"]
    replay = result["bert_b16_bf16"]
    m["bert b16 bf16 replay device ms"] = replay["device_ms"]
    m["bert b16 bf16 replay stream ms"] = replay["stream_ms"]
    m["bert b16 bf16 replay kernels"] = replay["kernels_a_replay"]
    for kind in ("layer_norm", "other", "matmul", "flash_attention"):
        m[f"bert b16 bf16 replay {kind} ms"] = replay["by_kind_ms"].get(
            kind, 0.0)
    return m


def notes(runs):
    """Bounds, launches a call, short traces, worst errors and the
    compiler's registers and spills, side by side."""
    first = runs[0][1]["layer_norm"]
    yield "bound ms (bytes, 3.35 TB/s): " + ", ".join(
        f"{r['case']} {r['dtype']} {r['bound_ms']:.5f}" for r in first)
    short = sum(r["short_traces"] for _, res in runs
                for r in res["layer_norm"])
    total = sum(len(res["layer_norm"]) for _, res in runs)
    yield f"short traces: {short} (of {total} times)"
    for label, res in dict(runs).items():
        yield f"{label}: kernels a call: " + ", ".join(
            f"{r['case']} {r['dtype']} {r['launches']}"
            for r in res["layer_norm"])
        yield f"{label}: a bf16 call's kernels: " + "; ".join(sorted({
            n[:60] for r in res["layer_norm"] if r["dtype"] == "bfloat16"
            for n in r["kernels"]}))
        worst = {dt: max(r["max_abs_err"] for lab, rs in runs
                         if lab == label for r in rs["layer_norm"]
                         if r["dtype"] == dt)
                 for dt in ("float32", "bfloat16")}
        yield f"{label}: worst error against layer_norm_ref {worst}"
        # a side builds its kernels in its first run only
        for line in next((r["ptxas"] for lab, r in runs
                          if lab == label and r["ptxas"]), []):
            yield f"{label} ptxas: {line}"


def main(argv=None):
    return _ab.main(argv, __doc__, __file__, run_side, metrics, notes,
                    default_out="chiprun_out/ab_layer_norm")


if __name__ == "__main__":
    sys.exit(main())
