"""The fused 1x1-conv GEMM's plans (``mm_plan``, ``mm_ranges``) and the
plain version of its split-K path against the Pallas ``_mm_epilogue`` of the
JAX package.

A plan is the kernel's block tile and a number of K ranges, chosen from
the shapes alone. On the CPU the wrappers run their plain versions (a CUDA kernel has
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
BK = {torch.float32: 16, torch.bfloat16: 32}

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
    """blocks x split reach 128 unless one more range would be shorter
    than 256 (a short K, or bucket 1's stage 4, split 8 ways)."""
    _, pixels, k, n = gemm
    m = bucket * pixels
    plan = cbr.mm_plan(m, n, k, dtype)
    tile, split = plan
    assert tile == cbr.MM_TILE and split >= 1
    ranges = cbr.mm_ranges(k, split, dtype)
    assert len(ranges) == split
    assert all(k1 - k0 >= 256 for k0, k1 in ranges[:-1])
    assert _blocks(m, n, plan) >= 128 or k // (split + 1) < 256, plan


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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cbr.mm_plan(64, 64, 64, torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cbr.mm_ranges(64, 2, torch.float16)
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
