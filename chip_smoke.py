#!/usr/bin/env python3
"""Drive the PyTorch port (incubator_mxnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and the CUDA version;
2. builds the hand-written CUDA kernels from ops/cuda/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the BERT serving path gives it and a few more, and times the
   kernel, the plain version and one PyTorch library call that computes the
   same function, warm: device time from torch.profiler (`*_ms`, the
   numbers of the JSON line) and CUDA events around back-to-back calls
   (`*_wall_ms`, which include the host's launch cost);
4. serves BERT-base (bert_12_768_12, seq 128, random weights from
   numpy.random.RandomState(0) carried in through convert.load_jax_params)
   through FrozenModel -> DynamicBatcher -> ModelServer: 16 HTTP clients
   send 4 requests each; every answer is checked against a direct
   predict_batch of its batch and against an all-plain forward, and the
   kernel launch counts are checked against the executed batches;
5. prints one JSON line with a record per kernel, then, as the last line,
   {"ok": true, "device": {...}}.

Any failure exits non-zero. Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result. A detailed record is
written to chip_smoke_out/detail.json.
"""
from __future__ import annotations

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


def log(*a):
    print(*a, flush=True)


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


def device_ms(fn, iters=20):
    """Kernel time on the card per call of `fn`: the profiler's device time
    of every kernel (and copy) the calls launched, summed, over `iters`.
    Returns (total ms, {kernel name: ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per[e.key] = (per.get(e.key, 0.0)
                          + e.self_device_time_total / iters / 1e3)
    return sum(per.values()), per


def measure(kernel, plain, library):
    """Device time (profiler) and stream time (events) of the kernel's
    wrapper, its plain version and the library call."""
    out = {}
    for name, fn in (("kernel", kernel), ("plain", plain),
                     ("library", library)):
        out[f"{name}_ms"], per = device_ms(fn)
        out[f"{name}_wall_ms"] = time_ms(fn)
        if name == "kernel":
            out["kernel_names"] = sorted(per)
    return out


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def fmt_times(r):
    return (f"kernel_ms {r['kernel_ms']:.4f} (wall {r['kernel_wall_ms']:.4f})"
            f" plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} (wall {r['library_wall_ms']:.4f}) "
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
            records.append(rec)
            log(f"flash {name:22s} {dtype:8s} err {err:.2e} lse_err "
                f"{lse_err:.2e} " + fmt_times(rec))


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
                y = ln.layer_norm(x, g, b, eps)
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
                    lambda: ln.layer_norm(x, g, b, eps),
                    lambda: ln.layer_norm_ref(x, g, b, eps),
                    lambda: F.layer_norm(x, (d,), gl, bl, eps))
                nbytes = 2 * rows * d * x.element_size() + 2 * d * 4
                bound_ms, bound_by = bound(8.0 * rows * d, nbytes, dtype)
                rec = dict(kernel="layer_norm_fwd", case=f"rows{rows}",
                           shape=[rows, d], eps=eps, dtype=dtype, tol=tol,
                           max_abs_err=err, bound_ms=bound_ms,
                           bound_by=bound_by, **times)
                records.append(rec)
                log(f"layer_norm rows {rows:5d} eps {eps:.0e} {dtype:8s} "
                    f"err {err:.2e} " + fmt_times(rec))


# ---------------------------------------------------------------------------
# the slice: BERT-base served over HTTP
# ---------------------------------------------------------------------------

N_CLIENTS, PER_CLIENT, SEQ = 16, 4, 128


def bert_arrays(net, seed=0, sigma=0.02):
    """Weights by the JAX package's Normal(0.02) name rules, from numpy:
    gamma ones, beta and bias zeros, everything else normal(0, 0.02)."""
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
    return arrays


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def _kernel_kind(name):
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if "ln_warp_kernel" in name or "ln_block_kernel" in name:
        return "layer_norm"
    low = name.lower()
    if any(s in low for s in ("gemm", "sm90", "cutlass", "cublas", "xmma")):
        return "matmul"
    return "other"


def forward_breakdown(fm, ids, b):
    """Where one forward of bucket `b` spends the card's time: profiler
    device time by kind of kernel, against the stream time of the same
    forward (events); their difference is the card's idle share."""
    x = ids[:b]
    total, per = device_ms(lambda: fm.run_raw(x), iters=5)
    wall = time_ms(lambda: fm.run_raw(x), iters=5)
    kinds = {}
    for name, ms in per.items():
        kinds[_kernel_kind(name)] = kinds.get(_kernel_kind(name), 0.0) + ms
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
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
    from incubator_mxnet_tpu_torch.serving import FrozenModel, ModelServer

    t0 = time.perf_counter()
    net = get_bert_model("bert_12_768_12", vocab_size=30522, max_length=512,
                         use_pooler=True, ctx=gpu(0))
    load_jax_params(net, bert_arrays(net, seed=0))
    log(f"bert_12_768_12 built on {next(net.parameters()).device} with "
        f"{sum(p.numel() for p in net.parameters())} parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = np.random.RandomState(1).randint(
        0, 30522, (N_CLIENTS * PER_CLIENT, SEQ)).astype(np.int32)

    # --- the main path: counts at zero just before, read just after ---
    fa.reset_counts()
    ln.reset_counts()
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
    counts = {"flash": (fa.launches, fa.plain_calls),
              "layer_norm": (ln.launches, ln.plain_calls)}
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
    launched = (fa.launches, ln.launches)
    plain_fa = (lambda q, k, v, causal=False, scale=None:  # noqa: E731
                fa.flash_attention_ref(q, k, v, causal=causal,
                                       scale=scale)[0])
    err_plain = 0.0
    with mock.patch.object(fa, "flash_attention", plain_fa), \
            mock.patch.object(ln, "layer_norm", ln.layer_norm_ref), \
            torch.inference_mode():
        for s in range(0, len(ids), 32):
            seq_p, pooled_p = net(torch.from_numpy(ids[s:s + 32]).cuda())
            seq_p, pooled_p = seq_p.cpu().numpy(), pooled_p.cpu().numpy()
            for r in range(len(seq_p)):
                err_plain = max(
                    err_plain,
                    float(np.abs(served[s + r][0] - seq_p[r]).max()),
                    float(np.abs(served[s + r][1] - pooled_p[r]).max()))
    check((fa.launches, ln.launches) == launched,
          "the all-plain forward launched a kernel")
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
    check_layer_norm(records)
    detail["kernels"] = records
    serving = serve_bert(detail)

    def pick(kernel, case, dtype):
        return next(r for r in records if r["kernel"] == kernel
                    and r["case"] == case and r["dtype"] == dtype
                    and r.get("eps", 1e-12) == 1e-12)

    executed = serving["executed_batches"]
    line = []
    for name, case, source, replaces, launches in (
            ("flash_attention_fwd", "bert_b8",
             "incubator_mxnet_tpu_torch/ops/cuda/csrc/flash_attention.cu",
             "incubator_mxnet_tpu/ops/pallas/flash_attention.py:109",
             serving["flash_launches"]),
            ("layer_norm_fwd", "rows1024",
             "incubator_mxnet_tpu_torch/ops/cuda/csrc/layer_norm.cu",
             "incubator_mxnet_tpu/ops/pallas/layer_norm.py:44",
             serving["layer_norm_launches"])):
        r = pick(name, case, "float32")
        worst = max(x["max_abs_err"] for x in records
                    if x["kernel"] == name and x["dtype"] == "float32")
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per_batch": launches / executed,
            "max_abs_err": r["max_abs_err"], "max_abs_err_f32_all": worst,
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "wall_ms": r["kernel_wall_ms"],
            "library_wall_ms": r["library_wall_ms"], "shape": r["shape"],
            "dtype": "float32"})
    out_dir = ROOT / "chip_smoke_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "detail.json").write_text(
        json.dumps(detail, indent=1))
    log(gpu_name_and_limit())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
