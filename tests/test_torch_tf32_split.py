"""The split-TF32 products of the f32 flash kernels at head dim 256,
emulated in plain PyTorch on the CPU.

``flash_fwd_tf32x3_kernel`` (``ops/cuda/csrc/flash_attention.cu``),
``flash_bwd_dq_tf32x3_kernel`` and ``flash_bwd_dkv_tf32x3_kernel``
(``ops/cuda/csrc/flash_attention_bwd.cu``) run every f32 product on the
tensor cores as three TF32 products: each operand x is split into
big = rna(x) and small = rna(x - big), TF32 rounded to nearest with ties
away from zero (``cvt.rna.tf32.f32``), and small.big + big.small +
big.big is summed in f32. Here that scheme runs on the CPU at the
kernels' products, S = Q K^T (a sum over D = 256) and dQ = dS K (a sum
over the keys), and through the forward as the kernel runs it (an online
softmax over 16-key tiles, S and P V each a split product, a tile's P V
folded into O's running sum in f32), from seeded numpy inputs, and is
held against float64 to the bound that ``chip_smoke.py`` holds the
kernels to on the card: ``F64_FACTOR`` times the plain f32 version's own
error. One TF32 product misses that bound by orders of magnitude, which
is why the kernels take three. Above head dim 256 the forward runs as
``flash_fwd_wide_tf32x3_kernel`` orders its sums (64-key tiles, S summed
a 64-column piece of D at a time, O's columns in chunks of 256, P V 16
keys at a time, lse rounded once) and is held to ``WIDE_F64_FACTOR``, and
so are dQ, dK and dV as ``flash_bwd_dq_wide_tf32x3_kernel`` and
``flash_bwd_dkv_wide_tf32x3_kernel`` order their sums (S and dP a 64-column
piece of D at a time, dS K, P^T dO and dS^T Q 16 keys or queries at a
time, in 256-column chunks).
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

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


# the forward kernel's key tile, and the log2 e it folds into the scale
KEYS = 16
LOG2E = 1.4426950408889634


def tiled_forward(q, k, v, causal, kv_len, mm):
    """flash_fwd_tf32x3_kernel's forward with every product taken by `mm`:
    S = scale Q K^T a 16-key tile at a time, masked (bottom-right causal,
    keys at or past kv_len) to -inf; the online softmax in base 2 (m, l
    and O's running sum rescaled by alpha); a tile's P V formed on its own
    and added to the rescaled sum in f32. Returns (O, lse): O = acc / l
    (0 for a row that sees no key), lse = (m + log2 l) ln 2 (-inf there)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    sl2 = LOG2E / math.sqrt(d)
    kv_lim = lk if kv_len is None else min(kv_len, lk)
    rows = torch.arange(lq)[:, None]
    m = torch.full((b, h, lq, 1), -1e30)
    l = torch.zeros((b, h, lq, 1))
    acc = torch.zeros((b, h, lq, d))
    for k0 in range(0, kv_lim, KEYS):
        keys = torch.arange(k0, k0 + KEYS)[None, :]
        kt, vt = k[:, :, k0:k0 + KEYS], v[:, :, k0:k0 + KEYS]
        pad = KEYS - kt.shape[2]        # past lk the kernel reads zeros
        if pad:
            kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
            vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        seen = keys < kv_lim
        if causal:
            seen = seen & (keys <= rows + lk - lq)
        s = torch.where(seen, mm(q, kt.transpose(-1, -2)) * sl2,
                        float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vt)
        m = m_new
    out = acc * torch.where(l > 0, 1 / l, torch.zeros_like(l))
    lse = torch.where(l > 0, (m + torch.log2(l)) * math.log(2.0),
                      torch.full_like(l, float("-inf")))
    return out, lse[..., 0]


# (name, B, H, lq, lk, causal, kv_len): the kernel's cases at small sizes
FORWARD_CASES = [("l192_causal", 1, 2, 192, 192, True, None),
                 ("kv_len100_l192_causal", 1, 2, 192, 192, True, 100),
                 ("l130_causal", 1, 2, 130, 130, True, None),
                 ("lq96_lk224_causal", 1, 2, 96, 224, True, None),
                 ("l160_kv_len77", 1, 2, 160, 160, False, 77)]


def forward_errors(case, mm, seed=0, d=D, forward=None):
    """Largest error against float64 of `mm`'s tiled forward (`forward`,
    default ``tiled_forward``) at head dim `d` and of the f32 plain version
    (``flash_attention_ref``): {"o": (mm's, plain's), "lse": (...)}, the
    lse over the rows that see a key."""
    _, b, h, lq, lk, causal, kv_len = case
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(b, h, n, d).astype(np.float32))
               for n in (lq, lk, lk))
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), kv_len=kv_len)
    got = (forward or tiled_forward)(q, k, v, causal, kv_len, mm)
    plain = fa.flash_attention_ref(q, k, v, **kw)
    want = fa.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    seen = want[1].isfinite()
    assert torch.equal(got[1].isneginf(), want[1].isneginf())

    def err(x, w, mask=None):
        x, w = x.double(), w
        if mask is not None:
            x, w = x[mask], w[mask]
        return float((x - w).abs().max())

    return {"o": (err(got[0], want[0]), err(plain[0], want[0])),
            "lse": (err(got[1], want[1], seen), err(plain[1], want[1], seen))}


@pytest.mark.parametrize("case", FORWARD_CASES, ids=lambda c: c[0])
def test_split_tf32_forward_keeps_f32_accuracy(case):
    """The forward as the kernel runs it, split TF32 for both products,
    within F64_FACTOR of the f32 plain version's error, O and lse."""
    for name, (split, plain) in forward_errors(case, split_mm).items():
        assert split <= chip_smoke.F64_FACTOR * plain, (name, split, plain)


@pytest.mark.parametrize("case", FORWARD_CASES[:2], ids=lambda c: c[0])
def test_one_tf32_product_misses_the_forward_bound(case):
    """The same forward with one TF32 product for S and P V misses the
    bound on O by far more than F64_FACTOR."""
    tf32, plain = forward_errors(case, lambda a, b: rna(a) @ rna(b))["o"]
    assert tf32 > 10 * chip_smoke.F64_FACTOR * plain, (tf32, plain)


# Above head dim 256: flash_fwd_wide_tf32x3_kernel's order of sums.
WIDE_KEYS = 64          # keys a tile
WIDE_PIECE = 64         # columns of D a streamed piece of Q and K
WIDE_CHUNK = 256        # O's columns a block
WIDE_PV_KEYS = 16       # keys of P V summed apart before the fold


def tiled_forward_wide(q, k, v, causal, kv_len, mm):
    """flash_fwd_wide_tf32x3_kernel's forward with every product taken by
    `mm`, at any head dim that is a multiple of 64: S = scale Q K^T a
    64-key tile at a time, its sum over D a 64-column piece at a time (each
    piece a fresh product, folded into the tile's S in f32, in order);
    masked as the kernels mask; the online softmax in base 2; O's columns
    in chunks of 256, each rescaled by alpha and then summing the tile's
    P V 16 keys at a time, each 16 keys' product formed on its own and
    added in f32. Returns (O, lse) as ``tiled_forward`` does, but lse as
    m ln 2 + ln l rounded once (the kernel's fmaf)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    sl2 = LOG2E / math.sqrt(d)
    kv_lim = lk if kv_len is None else min(kv_len, lk)
    rows = torch.arange(lq)[:, None]
    m = torch.full((b, h, lq, 1), -1e30)
    l = torch.zeros((b, h, lq, 1))
    acc = torch.zeros((b, h, lq, d))
    for k0 in range(0, kv_lim, WIDE_KEYS):
        keys = torch.arange(k0, k0 + WIDE_KEYS)[None, :]
        kt, vt = k[:, :, k0:k0 + WIDE_KEYS], v[:, :, k0:k0 + WIDE_KEYS]
        pad = WIDE_KEYS - kt.shape[2]   # past lk the kernel reads zeros
        if pad:
            kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
            vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        s = torch.zeros((b, h, lq, WIDE_KEYS))
        for c in range(0, d, WIDE_PIECE):
            s = s + mm(q[..., c:c + WIDE_PIECE],
                       kt[..., c:c + WIDE_PIECE].transpose(-1, -2))
        seen = keys < kv_lim
        if causal:
            seen = seen & (keys <= rows + lk - lq)
        s = torch.where(seen, s * sl2, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        for c in range(0, d, WIDE_CHUNK):
            o = acc[..., c:c + WIDE_CHUNK] * alpha
            for j in range(0, WIDE_KEYS, WIDE_PV_KEYS):
                o = o + mm(p[..., j:j + WIDE_PV_KEYS],
                           vt[:, :, j:j + WIDE_PV_KEYS, c:c + WIDE_CHUNK])
            acc[..., c:c + WIDE_CHUNK] = o
        m = m_new
    out = acc * torch.where(l > 0, 1 / l, torch.zeros_like(l))
    # m ln 2 + ln l rounded once, as fmaf does
    lse = torch.where(l > 0, (m.double() * np.float32(math.log(2.0))
                              + torch.log(l).double()).float(),
                      torch.full_like(l, float("-inf")))
    return out, lse[..., 0]


# (name, B, H, lq, lk, D, causal, kv_len): the wide kernel's cases at small
# sizes: D = 320 (a last chunk of 64 real columns) and 512 (two whole ones)
WIDE_CASES = [("d320_l192_causal", 1, 2, 192, 192, 320, True, None),
              ("d320_lq96_lk160_causal_kv130", 1, 2, 96, 160, 320, True, 130),
              ("d512_l128_kv_len77", 1, 2, 128, 128, 512, False, 77),
              ("d512_lq160_lk192_causal", 1, 2, 160, 192, 512, True, None)]


def wide_forward_errors(case, mm):
    """``forward_errors`` of ``tiled_forward_wide`` at the case's D."""
    return forward_errors(case[:5] + case[6:], mm, d=case[5],
                          forward=tiled_forward_wide)


@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: c[0])
def test_split_tf32_wide_forward_keeps_f32_accuracy(case):
    """The forward at D = 320 and 512 as the wide kernel runs it, split
    TF32 for both products, within WIDE_F64_FACTOR (the bar the card holds
    the kernel to) of the f32 plain version's error, O and lse."""
    for name, (split, plain) in wide_forward_errors(case, split_mm).items():
        assert split <= chip_smoke.WIDE_F64_FACTOR * plain, (
            name, split, plain)


@pytest.mark.parametrize("case", WIDE_CASES[1:3], ids=lambda c: c[0])
def test_one_tf32_product_misses_the_wide_forward_bound(case):
    """The same forward with one TF32 product for S and P V misses the
    bound on O by far more than WIDE_F64_FACTOR."""
    tf32, plain = wide_forward_errors(case, lambda a, b: rna(a) @ rna(b))["o"]
    assert tf32 > 10 * chip_smoke.WIDE_F64_FACTOR * plain, (tf32, plain)


WIDE_SUM_ROWS = 16      # keys (queries) of dS K, P^T dO, dS^T Q summed apart


def _folded(parts):
    """The parts (dim -3) added up in order, each sum rounded to f32."""
    total = parts[..., 0, :, :]
    for i in range(1, parts.shape[-3]):
        total = total + parts[..., i, :, :]
    return total


def _groups(x, n, dim):
    """`x` cut along `dim` into groups of `n` (zero-padded): a new dim -3
    of groups, the group's n at `dim`."""
    pad = -x.shape[dim] % n
    if pad:
        widths = [0, 0] * (x.dim() - dim % x.dim() - 1) + [0, pad]
        x = torch.nn.functional.pad(x, widths)
    shape = list(x.shape)
    dim %= x.dim()
    x = x.reshape(shape[:dim] + [shape[dim] // n, n] + shape[dim + 1:])
    return x.movedim(dim, -3)


def tiled_backward_wide(q, k, v, do, lse, delta, causal, kv_len, mm):
    """flash_bwd_dq_wide_tf32x3_kernel's and
    flash_bwd_dkv_wide_tf32x3_kernel's backward with every product taken
    by `mm`, at any head dim that is a multiple of 64, from the forward's
    lse and delta: S = Q K^T and dP = dO V^T summed over D a 64-column
    piece at a time (each piece a fresh product, folded in f32, in order);
    P = exp2(S scale log2 e - lse log2 e), masked by a select, and
    dS = P (dP - delta) scale; then dQ = dS K 16 keys at a time and
    dV = P^T dO and dK = dS^T Q 16 queries at a time, each 16 rows'
    product formed on its own and added in f32, in order. The kernels'
    64-row tiles and 256-column chunks change no sum (a sum runs down one
    column of D, in the order of the rows), so every tile and chunk is
    taken at once. Returns (dQ, dK, dV)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = np.float32(1.0 / math.sqrt(d))
    sl2 = np.float32(scale * np.float32(LOG2E))
    kv_lim = lk if kv_len is None else min(kv_len, lk)
    keys = torch.arange(lk)[None, :]
    seen = keys < kv_lim
    if causal:
        seen = seen & (keys <= torch.arange(lq)[:, None] + lk - lq)
    s = _folded(mm(_groups(q, WIDE_PIECE, -1),
                   _groups(k, WIDE_PIECE, -1).transpose(-1, -2)))
    dp = _folded(mm(_groups(do, WIDE_PIECE, -1),
                    _groups(v, WIDE_PIECE, -1).transpose(-1, -2)))
    l2 = (lse * np.float32(LOG2E))[..., None]
    p = torch.where(seen, torch.exp2(s * sl2 - l2), torch.zeros(()))
    ds = p * (dp - delta[..., None]) * scale
    dq = _folded(mm(_groups(ds, WIDE_SUM_ROWS, -1),
                    _groups(k, WIDE_SUM_ROWS, -2)))
    dk = _folded(mm(_groups(ds, WIDE_SUM_ROWS, -2).transpose(-1, -2),
                    _groups(q, WIDE_SUM_ROWS, -2)))
    dv = _folded(mm(_groups(p, WIDE_SUM_ROWS, -2).transpose(-1, -2),
                    _groups(do, WIDE_SUM_ROWS, -2)))
    return dq, dk, dv


def wide_backward_errors(case, mm, seed=0):
    """Largest error against float64 of `mm`'s ``tiled_backward_wide`` and
    of the f32 plain versions (``flash_attention_bwd_dq_ref`` and
    ``flash_attention_bwd_dkv_ref``) at the case's D, both from the f32
    plain forward's lse and delta, float64 on the same inputs widened:
    {"dq": (mm's, plain's), "dk": ..., "dv": ...}."""
    _, b, h, lq, lk, d, causal, kv_len = case
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(b, h, n, d).astype(np.float32))
               for n in (lq, lk, lk))
    do = torch.from_numpy(rs.randn(b, h, lq, d).astype(np.float32))
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), kv_len=kv_len)
    out, lse = fa.flash_attention_ref(q, k, v, **kw)
    args = (q, k, v, do, lse, fa._delta(do, out))
    got = tiled_backward_wide(*args, causal, kv_len, mm)
    plain = (fa.flash_attention_bwd_dq_ref(*args, **kw),
             *fa.flash_attention_bwd_dkv_ref(*args, **kw))
    wide = [t.double() for t in args]
    want = (fa.flash_attention_bwd_dq_ref(*wide, **kw),
            *fa.flash_attention_bwd_dkv_ref(*wide, **kw))

    def err(x, w):
        return float((x.double() - w).abs().max())

    return {g: (err(x, w), err(y, w))
            for g, x, y, w in zip(("dq", "dk", "dv"), got, plain, want)}


@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: c[0])
def test_split_tf32_wide_backward_keeps_f32_accuracy(case):
    """dQ, dK and dV at D = 320 and 512 as the wide split-TF32 kernels sum
    them, split TF32 for every product, each within WIDE_F64_FACTOR (the
    bar the card holds the kernels to) of the f32 plain version's error."""
    for name, (split, plain) in wide_backward_errors(case, split_mm).items():
        assert split <= chip_smoke.WIDE_F64_FACTOR * plain, (
            name, split, plain)


def test_one_tf32_product_misses_the_wide_backward_bound():
    """The same backward with one TF32 product for S, dP and the sums
    misses the bound on dQ, dK and dV by far more than WIDE_F64_FACTOR."""
    errs = wide_backward_errors(WIDE_CASES[3],
                                lambda a, b: rna(a) @ rna(b))
    for name, (tf32, plain) in errs.items():
        assert tf32 > 10 * chip_smoke.WIDE_F64_FACTOR * plain, (
            name, tf32, plain)
