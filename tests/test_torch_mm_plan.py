"""The fused 1x1-conv GEMM's plans (``mm_plan``, ``mm_ranges``), its route
(``mm_route``: the wgmma kernel or the SIMT one) and the plain version of
its split-K path against the Pallas ``_mm_epilogue`` of the JAX package.

A plan is the kernel's block tile and a number of K ranges, chosen from
the shapes alone; the route from the dtype, the shapes and the
alignment. On the CPU the wrappers run their plain versions (a CUDA kernel has
no interpret mode): ``mm_splitk_ref`` forms the partial products over the
plan's K ranges and sums them in the order the reduce kernel does, and the
Pallas kernel runs in interpret mode. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr

jcbr = importlib.import_module("incubator_mxnet_tpu.ops.pallas.conv_bn_relu")

DTYPES = [torch.float32, torch.bfloat16]
# the k-tile depth a range starts on: the SIMT kernel's f32 tile, the
# wgmma kernel's 128-byte bf16 rows
BK = {torch.float32: 16, torch.bfloat16: 64}
TILES = {torch.float32: (cbr.MM_TILE,), torch.bfloat16: cbr.MM_WGMMA_TILES}

# every distinct 1x1/stride-1 conv of ResNet-50 at 224 x 224: (name,
# pixels per image, K, N)
RESNET_GEMMS = [("s1_conv1_first", 56 * 56, 64, 64),
                ("s1_conv3_ds", 56 * 56, 64, 256),
                ("s1_conv1", 56 * 56, 256, 64),
                ("s2_conv3", 28 * 28, 128, 512),
                ("s2_conv1", 28 * 28, 512, 128),
                ("s3_conv3", 14 * 14, 256, 1024),
                ("s3_conv1", 14 * 14, 1024, 256),
                ("s4_conv3", 7 * 7, 512, 2048),
                ("s4_conv1", 7 * 7, 2048, 512)]


def _blocks(m, n, plan):
    (bm, bn), split = plan
    return -(-m // bm) * -(-n // bn) * split


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("split", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [1, 17, 70, 1024, 2048])
def test_ranges_tile_k_exactly_in_multiples_of_the_depth(k, split, dtype):
    ranges = cbr.mm_ranges(k, split, dtype)
    assert 1 <= len(ranges) <= split
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                         # contiguous
    assert all(k1 > k0 for k0, k1 in ranges)    # none empty
    assert all(k0 % BK[dtype] == 0 for k0, _ in ranges)
    lengths = {k1 - k0 for k0, k1 in ranges[:-1]}
    assert len(lengths) <= 1 and all(n % BK[dtype] == 0 for n in lengths)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("bucket", [1, 4, 32])
@pytest.mark.parametrize("gemm", RESNET_GEMMS, ids=[g[0] for g in RESNET_GEMMS])
def test_plan_fills_the_card_at_every_resnet_shape(gemm, bucket, dtype):
    """f32: blocks x split reach 128 unless one more range would be
    shorter than 256 (a short K, or bucket 1's stage 4, split 8 ways).
    bf16: the grid reaches half the SMs (66 blocks) unless K is under
    1024, where the f32 partials of a split cost more than the blocks it
    adds (tools/sweep_mm_plans.py), or one more range would be shorter
    than 256; the 128-wide tile only where it gives 132 blocks."""
    _, pixels, k, n = gemm
    m = bucket * pixels
    plan = cbr.mm_plan(m, n, k, dtype)
    tile, split = plan
    assert tile in TILES[dtype] and split >= 1
    ranges = cbr.mm_ranges(k, split, dtype)
    assert len(ranges) == split
    assert all(k1 - k0 >= 256 for k0, k1 in ranges[:-1])
    if dtype == torch.float32:
        assert _blocks(m, n, plan) >= 128 or k // (split + 1) < 256, plan
    else:
        assert (_blocks(m, n, plan) >= 66 or k < 1024
                or k // (split + 1) < 256), plan
        assert tile == (128, 64) or _blocks(m, n, (tile, 1)) >= 132, plan


# the plan at bucket 32: the one tile, 128 x 64, with K split where it
# gives fewer than 264 blocks
BUCKET32 = {"s1_conv1_first": 1, "s1_conv3_ds": 1, "s1_conv1": 1,
            "s2_conv3": 1, "s2_conv1": 1, "s3_conv3": 1, "s3_conv1": 2,
            "s4_conv3": 1, "s4_conv1": 3}


@pytest.mark.parametrize("gemm", RESNET_GEMMS, ids=[g[0] for g in RESNET_GEMMS])
def test_plan_at_bucket_32(gemm):
    name, pixels, k, n = gemm
    assert cbr.mm_plan(32 * pixels, n, k, torch.float32) == \
        ((128, 64), BUCKET32[name])


@pytest.mark.parametrize("m, n, k, want", [
    (196, 512, 2048, ((128, 64), 8)),     # s4_conv1 at bucket 4
    (784, 256, 1024, ((128, 64), 4)),     # s3_conv1 at bucket 4
    (49, 512, 2048, ((128, 64), 8)),      # s4_conv1 at bucket 1
    (49, 2048, 512, ((128, 64), 2)),      # s4_conv3 at bucket 1
    (1, 1, 1, ((128, 64), 1)),
])
def test_plan_at_small_batches(m, n, k, want):
    assert cbr.mm_plan(m, n, k, torch.float32) == want


def test_plan_is_a_pure_function_of_the_shapes(monkeypatch):
    assert list(inspect.signature(cbr.mm_plan).parameters) == \
        ["m", "n", "k", "dtype"]
    args = [(32 * p, n, k, dt) for _, p, k, n in RESNET_GEMMS
            for dt in DTYPES]
    first = [cbr.mm_plan(*a) for a in args]
    monkeypatch.setenv("MXTPU_MM_PLAN", "128x64/4")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert [cbr.mm_plan(*a) for a in reversed(args)] == first[::-1]


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        cbr.mm_plan(64, 64, 64, torch.float64)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        cbr.mm_ranges(64, 2, torch.float64)
    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    s = torch.ones(3)
    with pytest.raises(ValueError, match="no plan"):
        cbr._mm_epilogue_with_plan(x, w, s, s, "relu", ((64, 64), 1))
    with pytest.raises(ValueError, match="no plan"):
        cbr._mm_epilogue_with_plan(x, w, s, s, "relu", ((128, 64), 0))


def _inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) / np.sqrt(k)).astype(np.float32),
            (0.5 + rng.rand(n)).astype(np.float32),
            rng.randn(n).astype(np.float32))


# (M, K, N, split): ranges of 32 (f32 depth 16), of 48 and 22, of 64
SPLITK = [(200, 96, 40, 3), (100, 70, 30, 2), (300, 256, 96, 4)]


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("case", SPLITK, ids=lambda c: "x".join(map(str, c)))
def test_splitk_plain_version_matches_pallas(case, act):
    m, k, n, split = case
    arrays = _inputs(m + k + n, m, k, n)
    want = jcbr._mm_epilogue(*(jnp.asarray(a) for a in arrays), act, True)
    assert len(cbr.mm_ranges(k, split, torch.float32)) == split
    got = cbr.mm_splitk_ref(*(torch.from_numpy(a) for a in arrays), act,
                            split)
    assert got.shape == want.shape and got.dtype == torch.float32
    # f32 both sides; the sums of K products grouped into other ranges
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
def test_reduce_sums_the_partials_in_range_order(act):
    rng = np.random.RandomState(11)
    part = torch.from_numpy(rng.randn(5, 7, 9).astype(np.float32))
    s = torch.from_numpy((0.5 + rng.rand(9)).astype(np.float32))
    b = torch.from_numpy(rng.randn(9).astype(np.float32))
    acc = part[0]
    for i in range(1, 5):
        acc = acc + part[i]
    want = cbr._apply_act(acc * s + b, act)
    cbr.reset_counts()
    got = cbr.mm_splitk_reduce(part, s, b, act, torch.float32)
    assert torch.equal(got, want)               # the same order, the same bits
    assert (cbr.mm_reduce_plain_calls, cbr.mm_reduce_launches) == (1, 0)
    half = cbr.mm_splitk_reduce(part, s, b, act, torch.bfloat16)
    assert half.dtype == torch.bfloat16 and torch.equal(half,
                                                        want.bfloat16())


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
def test_forced_plan_on_cpu_runs_the_plans_plain_version(act, split):
    arrays = [torch.from_numpy(a) for a in _inputs(3, 100, 70, 30)]
    cbr.reset_counts()
    got = cbr._mm_epilogue_with_plan(*arrays, act, (cbr.MM_TILE, split))
    assert torch.equal(got, cbr.mm_splitk_ref(*arrays, act, split))
    np.testing.assert_allclose(
        got.numpy(), cbr.mm_epilogue_ref(*arrays, act).numpy(),
        rtol=1e-5, atol=1e-5)
    assert (cbr.mm_plain_calls, cbr.mm_launches) == (1, 0)


def test_mm_epilogue_on_cpu_is_the_plain_version():
    arrays = [torch.from_numpy(a) for a in _inputs(4, 300, 256, 96)]
    cbr.reset_counts()
    assert torch.equal(cbr.mm_epilogue(*arrays, "relu"),
                       cbr.mm_epilogue_ref(*arrays, "relu"))
    assert (cbr.mm_plain_calls, cbr.mm_launches, cbr.mm_reduce_launches,
            cbr.mm_reduce_plain_calls) == (1, 0, 0, 0)


# ---------------------------------------------------------------------------
# the bf16 plans and the route
# ---------------------------------------------------------------------------

# f32 plans at buckets 1 and 4, as the SIMT kernel has had them since its
# redesign: bf16's wgmma plans leave them alone
F32_SMALL = {"s1_conv1_first": 1, "s1_conv3_ds": 1, "s1_conv1": 1,
             "s2_conv3": 1, "s2_conv1": 2, "s3_conv3": 1, "s3_conv1": 4,
             "s4_conv3": 2, "s4_conv1": 8}


@pytest.mark.parametrize("bucket", [1, 4])
@pytest.mark.parametrize("gemm", RESNET_GEMMS, ids=[g[0] for g in RESNET_GEMMS])
def test_f32_plans_are_unchanged_at_small_buckets(gemm, bucket):
    name, pixels, k, n = gemm
    assert cbr.mm_plan(bucket * pixels, n, k, torch.float32) == \
        ((128, 64), F32_SMALL[name])


# the wgmma plans at bucket 32: a 128-wide tile where N > 64 and it still
# gives 132 blocks, no split (every grid has 66 blocks or more)
BF16_BUCKET32 = {"s1_conv1_first": ((128, 64), 1),
                 "s1_conv3_ds": ((128, 128), 1),
                 "s1_conv1": ((128, 64), 1),
                 "s2_conv3": ((128, 128), 1),
                 "s2_conv1": ((128, 128), 1),
                 "s3_conv3": ((128, 128), 1),
                 "s3_conv1": ((128, 64), 1),
                 "s4_conv3": ((128, 128), 1),
                 "s4_conv1": ((128, 64), 1)}


@pytest.mark.parametrize("gemm", RESNET_GEMMS, ids=[g[0] for g in RESNET_GEMMS])
def test_bf16_plan_at_bucket_32(gemm):
    name, pixels, k, n = gemm
    m = 32 * pixels
    plan = cbr.mm_plan(m, n, k, torch.bfloat16)
    assert plan == BF16_BUCKET32[name]
    (bm, bn), split = plan
    if n <= 64:                                  # N = 64 pays for no more
        assert bn == 64


@pytest.mark.parametrize("m, n, k, want", [
    (196, 512, 2048, ((128, 64), 5)),     # s4_conv1 at bucket 4: 16 blocks
    (784, 256, 1024, ((128, 64), 3)),     # s3_conv1 at bucket 4: 28 blocks
    (196, 256, 1024, ((128, 64), 4)),     # s3_conv1 at bucket 1: ranges of 256
    (49, 512, 2048, ((128, 64), 8)),      # s4_conv1 at bucket 1: 8 blocks
    (784, 512, 2048, ((128, 64), 2)),     # s4_conv1 at bucket 16: 56 blocks
    (3136, 128, 512, ((128, 64), 1)),     # s2_conv1 at bucket 4: K < 1024
    (196, 2048, 512, ((128, 64), 1)),     # s4_conv3 at bucket 4: K < 1024
    (1568, 512, 2048, ((128, 64), 1)),    # s4_conv1 at bucket 32: the M tail
    (100, 40, 72, ((128, 64), 1)),        # K a multiple of 8, not of 64
    (1, 8, 8, ((128, 64), 1)),
])
def test_bf16_plan_at_other_shapes(m, n, k, want):
    assert cbr.mm_plan(m, n, k, torch.bfloat16) == want


@pytest.mark.parametrize("split", [2, 3, 4, 8])
@pytest.mark.parametrize("k", [64, 72, 200, 512, 1024, 2048])
def test_bf16_ranges_are_whole_tiles_of_64(k, split):
    ranges = cbr.mm_ranges(k, split, torch.bfloat16)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert all(k1 > k0 for k0, k1 in ranges)
    assert all(k0 % 64 == 0 for k0, _ in ranges)
    # a range the kernel reads in whole 64-deep tiles ends where the next
    # begins: no tile of one range reads into the next
    assert all((k1 - k0) % 64 == 0 for k0, k1 in ranges[:-1])


@pytest.mark.parametrize("gemm", RESNET_GEMMS, ids=[g[0] for g in RESNET_GEMMS])
@pytest.mark.parametrize("bucket", [1, 4, 32])
def test_route_sends_every_resnet_shape_to_wgmma_in_bf16(gemm, bucket):
    _, pixels, k, n = gemm
    assert cbr.mm_route(n, k, torch.bfloat16, True) == "wgmma"
    assert cbr.mm_route(n, k, torch.float32, True) == "simt"


@pytest.mark.parametrize("n, k, aligned", [
    (30, 70, True),       # 100 x 70 x 30: neither row 16 bytes a multiple
    (40, 70, True),       # K not a multiple of 8
    (30, 72, True),       # N not a multiple of 8
    (256, 64, False),     # a pointer off 16 bytes
    (8, 0, True),         # no K: nothing for TMA to describe
])
def test_route_sends_what_tma_cannot_describe_to_simt(n, k, aligned):
    assert cbr.mm_route(n, k, torch.bfloat16, aligned) == "simt"


def test_route_is_a_pure_function_of_its_arguments(monkeypatch):
    assert list(inspect.signature(cbr.mm_route).parameters) == \
        ["n", "k", "dtype", "aligned"]
    args = [(n, k, dt, al) for _, _, k, n in RESNET_GEMMS for dt in DTYPES
            for al in (True, False)]
    first = [cbr.mm_route(*a) for a in args]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert [cbr.mm_route(*a) for a in reversed(args)] == first[::-1]
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        cbr.mm_route(8, 8, torch.float64, True)


def test_forced_plans_take_each_dtypes_tiles_and_routes():
    x, w = torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(
        8, 16, dtype=torch.bfloat16)
    s = torch.ones(16)
    for tile in cbr.MM_WGMMA_TILES:
        got = cbr._mm_epilogue_with_plan(x, w, s, s, "relu", (tile, 2))
        assert got.dtype == torch.bfloat16 and got.shape == (4, 16)
    # the SIMT kernel has one tile; f32 never takes the 128-wide one
    with pytest.raises(ValueError, match="no plan"):
        cbr._mm_epilogue_with_plan(x, w, s, s, "relu", ((128, 128), 1),
                                   route="simt")
    with pytest.raises(ValueError, match="no plan"):
        cbr._mm_epilogue_with_plan(x.float(), w.float(), s, s, "relu",
                                   ((128, 128), 1))
    with pytest.raises(ValueError, match="no route"):
        cbr._mm_epilogue_with_plan(x, w, s, s, "relu", ((128, 64), 1),
                                   route="tensor")


# (M, K, N, split) in bf16: ranges of 64 and 8 (K = 72), of 128 x 2 and
# 64 (K = 320), of 256 x 7 and the rest (K = 2048, s4_conv1's depth)
BF16_SPLITK = [(100, 72, 40, 2), (130, 320, 136, 3), (64, 2048, 64, 8)]


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("case", BF16_SPLITK,
                         ids=lambda c: "x".join(map(str, c)))
def test_bf16_splitk_plain_version_matches_pallas(case, act):
    m, k, n, split = case
    arrays = _inputs(m + k + n, m, k, n)
    x, w = (torch.from_numpy(a).bfloat16() for a in arrays[:2])
    s, b = (torch.from_numpy(a) for a in arrays[2:])
    ranges = cbr.mm_ranges(k, split, torch.bfloat16)
    assert len(ranges) == split and all(k0 % 64 == 0 for k0, _ in ranges)
    want = jcbr._mm_epilogue(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             jnp.asarray(w.float().numpy(), jnp.bfloat16),
                             jnp.asarray(arrays[2]), jnp.asarray(arrays[3]),
                             act, True)
    got = cbr.mm_splitk_ref(x, w, s, b, act, split)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # bf16 both sides from the same bf16 inputs: the f32 sums differ only
    # in the order of the K products (relative 1e-6), so the one rounding
    # to bf16 lands at most one unit (2**-8 of the value) apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)
    cbr.reset_counts()
    forced = cbr._mm_epilogue_with_plan(
        x, w, s, b, act, (cbr.mm_plan(m, n, k, torch.bfloat16)[0], split))
    assert torch.equal(forced, got)
    assert (cbr.mm_plain_calls, cbr.mm_launches, cbr.mm_wgmma_launches) == \
        (1, 0, 0)
