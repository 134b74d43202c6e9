"""The split-TF32 product of the f32 flash backward at head dim 256, emulated
in plain PyTorch on the CPU.

``flash_bwd_dq_tf32x3_kernel`` and ``flash_bwd_dkv_tf32x3_kernel``
(``ops/cuda/csrc/flash_attention_bwd.cu``) run every f32 product on the
tensor cores as three TF32 products: each operand x is split into
big = rna(x) and small = rna(x - big), TF32 rounded to nearest with ties
away from zero (``cvt.rna.tf32.f32``), and small.big + big.small +
big.big is summed in f32. Here that scheme runs on the CPU at the
kernels' products, S = Q K^T (a sum over D = 256) and dQ = dS K (a sum
over the keys), from seeded numpy inputs, and is held against float64 to
the bound that ``chip_smoke.py`` holds the kernels to on the card:
``F64_FACTOR`` times the plain f32 product's own error. One TF32 product
misses that bound by orders of magnitude, which is why the kernels take
three.
"""
import numpy as np
import pytest
import torch

import chip_smoke

D = 256


def rna(x):
    """f32 `x` rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, on its bits: the value ``cvt.rna.tf32.f32``
    gives, as an f32 with its low 13 bits zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_mm(a, b):
    """a @ b in split TF32: small.big + big.small + big.big in f32 (each
    product of two TF32 values is exact in f32); small.small is dropped."""
    a_big, b_big = rna(a), rna(b)
    a_small, b_small = rna(a - a_big), rna(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def errors(a, b):
    """Largest error against float64 of the f32 product, of the split
    product and of one TF32 product."""
    want = a.double() @ b.double()

    def err(x):
        return float((x.double() - want).abs().max())

    return err(a @ b), err(split_mm(a, b)), err(rna(a) @ rna(b))


def test_rna_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10        # TF32's spacing above 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0],
                        dtype=torch.float32)
    got = rna(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    # big + small holds x to about 2^-22 of it
    y = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32))
    big = rna(y)
    rest = (y.double() - big.double() - rna(y - big).double()).abs()
    assert float((rest / y.double().abs()).max()) <= 2.0 ** -21


# (name, M, K, N): the kernels' two kinds of product at D = 256, a 64-row
# block against 16- and 48-row streamed tiles
PRODUCTS = [("S = Q K^T", 64, D, 16), ("S = Q K^T", 64, D, 48),
            ("dQ = dS K", 64, 16, D), ("dQ = dS K", 64, 48, D)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("product", PRODUCTS, ids=lambda p: f"{p[0]}-{p[2]}")
def test_split_tf32_keeps_f32_accuracy(product, seed):
    _, m, k, n = product
    rs = np.random.RandomState(seed)
    a = torch.from_numpy(rs.randn(m, k).astype(np.float32))
    b = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    f32, split, _ = errors(a, b)
    assert split <= chip_smoke.F64_FACTOR * f32, (split, f32)


@pytest.mark.parametrize("product", PRODUCTS, ids=lambda p: f"{p[0]}-{p[2]}")
def test_one_tf32_product_misses_the_bound(product):
    _, m, k, n = product
    rs = np.random.RandomState(7)
    a = torch.from_numpy(rs.randn(m, k).astype(np.float32))
    b = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    f32, _, tf32 = errors(a, b)
    assert tf32 > 10 * chip_smoke.F64_FACTOR * f32, (tf32, f32)
