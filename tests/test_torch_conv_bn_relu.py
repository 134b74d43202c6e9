"""The port's fused conv+BN+act pieces against the Pallas kernels of the JAX
package (``ops/pallas/conv_bn_relu.py``).

On the CPU the port's wrappers run their plain versions (a CUDA kernel has
no interpret mode); the Pallas kernels run in interpret mode, as
tests/test_trainloop.py runs them. The same numpy inputs go to both, and
the gradients are held against ``jax.vjp`` of the Pallas paths. The CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import _raw as jraw
from incubator_mxnet_tpu.ops import select as jsel
from incubator_mxnet_tpu.ops import pallas as jcbr
from incubator_mxnet_tpu_torch import profiler
from incubator_mxnet_tpu_torch.ops import _raw, select
from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _bn_params(rng, c):
    """gamma, beta, moving mean and a positive moving variance."""
    return (1.0 + 0.2 * rng.randn(c), 0.3 * rng.randn(c),
            0.2 * rng.randn(c), 0.5 + rng.rand(c))


# ---------------------------------------------------------------------------
# scale, shift, activation
# ---------------------------------------------------------------------------

# f32: one rounding of each of three operations; bf16: the output rounds
# to bf16 (8 bits) on both sides, the channel sums stay f32
SSA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "relu6", None])
@pytest.mark.parametrize("c", [3, 16, 64])
def test_scale_shift_act_forward_and_vjp_match_pallas(c, act, dtype):
    rng = np.random.RandomState(c)
    rows = 37                          # not a multiple of the TPU's 8
    x = (3.0 * rng.randn(rows, c)).astype(np.float32)
    s = (0.5 + rng.rand(c)).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    dy = rng.randn(rows, c).astype(np.float32)
    xj = jnp.asarray(x).astype(_JAX[dtype])
    want, vjp = jax.vjp(
        lambda a, sc, sh: jcbr.scale_shift_act(a, sc, sh, act=act,
                                               interpret=True),
        xj, jnp.asarray(s), jnp.asarray(b))
    dwant = vjp(jnp.asarray(dy).astype(_JAX[dtype]))

    xt = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    cbr.reset_counts()
    out = cbr.scale_shift_act(xt, st, bt, act)
    assert (cbr.ssa_launches, cbr.ssa_plain_calls) == (0, 1)
    assert out.dtype == _TORCH[dtype] and out.shape == (rows, c)
    tol = SSA_TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)
    out.backward(torch.from_numpy(dy).to(_TORCH[dtype]))
    assert xt.grad.dtype == _TORCH[dtype]
    for got, ref, name in zip((xt.grad, st.grad, bt.grad), dwant,
                              ("dx", "dscale", "dshift")):
        scale = max(1.0, float(np.abs(_f32(ref)).max()))
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol,
                                   atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("act", ["relu", "relu6", None])
def test_scale_shift_act_gradcheck_in_float64(act):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(3.0 * rng.randn(2, 3, 5)).requires_grad_()
    s = torch.from_numpy(0.5 + rng.rand(5)).requires_grad_()
    b = torch.from_numpy(rng.randn(5)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: cbr.scale_shift_act(*a, act), (x, s, b))


def test_scale_shift_act_keeps_leading_dims_and_refuses_bad_input():
    x = torch.randn(2, 3, 4, 8)
    s, b = torch.rand(8) + 0.5, torch.randn(8)
    ref = torch.relu(x * s + b)
    torch.testing.assert_close(cbr.scale_shift_act(x, s, b), ref)
    with pytest.raises(ValueError, match="must be"):
        cbr.scale_shift_act_fwd(x, s[:4], b)
    with pytest.raises(ValueError, match="unsupported act"):
        cbr.scale_shift_act_fwd(x, s, b, act="gelu")
    with pytest.raises(ValueError, match="no kernel for device"):
        cbr.scale_shift_act_fwd(x.to("meta"), s.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# conv + BN + act
# ---------------------------------------------------------------------------

GEOMETRIES = [  # (kernel, stride, pad): the three of ResNet's bottleneck
    ("1x1_s1", 1, (1, 1), (0, 0)),
    ("3x3_p1", 3, (1, 1), (1, 1)),
    ("1x1_s2", 1, (2, 2), (0, 0)),
]


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_conv_bn_relu_forward_and_vjp_match_pallas(geometry, act):
    name, k, stride, pad = geometry
    rng = np.random.RandomState(k + stride[0])
    x = rng.randn(2, 6, 7, 12).astype(np.float32)
    w = (0.3 * rng.randn(k, k, 12, 20)).astype(np.float32)
    bn = [a.astype(np.float32) for a in _bn_params(rng, 20)]
    args = [x, w] + bn
    want, vjp = jax.vjp(
        lambda *a: jcbr.conv_bn_relu(*a, stride=stride, pad=pad, act=act,
                                     interpret=True),
        *(jnp.asarray(a) for a in args))
    dy = rng.randn(*want.shape).astype(np.float32)
    dwant = vjp(jnp.asarray(dy))

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    cbr.reset_counts()
    out = cbr.conv_bn_relu(*leaves, stride=stride, pad=pad, act=act)
    # the 1x1/stride-1 conv is the GEMM kernel's; the others go to the
    # conv and the scale/shift/act kernel
    one = name == "1x1_s1"
    assert (cbr.mm_plain_calls, cbr.ssa_plain_calls) == (int(one),
                                                         int(not one))
    assert out.shape == tuple(want.shape)
    # f32 both sides; the conv sums 12 x k*k products in another order
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(dy))
    for t, ref, gname in zip(leaves, dwant, ("x", "w", "gamma", "beta",
                                             "mean", "var")):
        np.testing.assert_allclose(_f32(t.grad), _f32(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=gname)


def test_conv_bn_relu_function_gradcheck_in_float64():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 4, 4, 3)).requires_grad_()
    w = torch.from_numpy(0.5 * rng.randn(3, 3, 3, 5)).requires_grad_()
    s = torch.from_numpy(0.5 + rng.rand(5)).requires_grad_()
    b = torch.from_numpy(rng.randn(5)).requires_grad_()
    for k, pad in ((1, (0, 0)), (3, (1, 1))):
        wk = w[:k, :k].detach().clone().requires_grad_()
        assert torch.autograd.gradcheck(
            lambda *a: cbr.ConvBNReLUFunction.apply(*a, (1, 1), pad, "relu"),
            (x, wk, s, b))


# ---------------------------------------------------------------------------
# BatchNorm(act="relu") in training mode: the gradient runs through the
# batch statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax_through_its_statistics(monkeypatch, act,
                                                       training):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    rng = np.random.RandomState(7)
    x = (1.5 * rng.randn(3, 5, 5, 16) + 0.4).astype(np.float32)
    g, b, mm, mv = (a.astype(np.float32) for a in _bn_params(rng, 16))
    dy = rng.randn(*x.shape).astype(np.float32)

    def jfn(xx, gg, bb):
        return jraw.batch_norm(xx, gg, bb, jnp.asarray(mm), jnp.asarray(mv),
                               axis=-1, training=training, act=act)

    (y_j, nm_j, nv_j), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b))
    dx_j, dg_j, db_j = vjp((jnp.asarray(dy), jnp.zeros_like(nm_j),
                            jnp.zeros_like(nv_j)))

    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    cbr.reset_counts()
    y, nm, nv = _raw.batch_norm(xt, gt, bt, torch.from_numpy(mm),
                                torch.from_numpy(mv), axis=-1,
                                training=training, act=act)
    # the fused tail only with an activation, as in the JAX package
    assert cbr.ssa_plain_calls == int(act is not None)
    y.backward(torch.from_numpy(dy))
    # f32; the statistics reduce over 75 rows in another order, and the
    # kernel path applies the folded scale/shift where the plain path
    # normalizes first
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_f32(y), _f32(y_j), **tol)
    np.testing.assert_allclose(_f32(nm), _f32(nm_j), **tol)
    np.testing.assert_allclose(_f32(nv), _f32(nv_j), **tol)
    for got, ref, name in ((xt.grad, dx_j, "dx"), (gt.grad, dg_j, "dgamma"),
                           (bt.grad, db_j, "dbeta")):
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_batch_norm_gradient_flows_through_the_statistics():
    """A detached statistic would give another dx without raising: hold the
    fused path's dx against the plain chain's in float64."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(4, 3, 3, 6)).requires_grad_()
    g = torch.from_numpy(1.0 + 0.1 * rng.randn(6)).requires_grad_()
    b = torch.from_numpy(0.1 * rng.randn(6)).requires_grad_()
    mm = torch.zeros(6, dtype=torch.float64)
    mv = torch.ones(6, dtype=torch.float64)

    def fused(xx, gg, bb):
        return _raw.batch_norm(xx, gg, bb, mm, mv, axis=-1, act="relu")[0]

    def plain(xx, gg, bb):
        m = xx.mean((0, 1, 2))
        v = xx.var((0, 1, 2), correction=0)
        return torch.relu((xx - m) / torch.sqrt(v + 1e-5) * gg + bb)

    torch.testing.assert_close(fused(x, g, b), plain(x, g, b))
    dy = torch.from_numpy(rng.randn(4, 3, 3, 6))
    got = torch.autograd.grad(fused(x, g, b), (x, g, b), dy)
    want = torch.autograd.grad(plain(x, g, b), (x, g, b), dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w)
    assert torch.autograd.gradcheck(fused, (x, g, b))


# ---------------------------------------------------------------------------
# the selection decisions
# ---------------------------------------------------------------------------

SSA_CASES = [  # (shape, channel axis, act)
    ((2, 4, 4, 8), -1, "relu"), ((2, 4, 4, 8), 3, "relu6"),
    ((2, 4, 4, 8), -1, None), ((2, 8, 4, 4), 1, "relu"),
    ((2, 4, 4, 8), -1, "gelu"), ((5, 3), -1, "relu"),
]
CBR_CASES = [  # (dilate, num_group, layout, training, act)
    (None, 1, "NHWC", False, "relu"), ((1, 1), 1, "NHWC", False, None),
    (None, 1, "NHWC", False, "relu6"), (None, 1, "NHWC", True, "relu"),
    (None, 1, "NCHW", False, "relu"), (None, 2, "NHWC", False, "relu"),
    ((2, 2), 1, "NHWC", False, "relu"), (None, 1, "NHWC", False, "tanh"),
]


def test_selection_decisions_match_jax_and_are_counted(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    profiler.reset_counters()
    for shape, axis, act in SSA_CASES:
        x = np.zeros(shape, np.float32)
        assert (select.scale_shift_act(torch.from_numpy(x), axis, act)
                == jsel.scale_shift_act(jnp.asarray(x), axis, act)), shape
    x, w = torch.zeros(1, 4, 4, 8), torch.zeros(1, 1, 8, 8)
    for dilate, groups, layout, training, act in CBR_CASES:
        args = ((1, 1), (0, 0), dilate, groups, layout, training)
        assert (select.conv_bn_relu(x, w, *args, act=act)
                == jsel.conv_bn_relu(jnp.asarray(x.numpy()),
                                     jnp.asarray(w.numpy()), *args,
                                     act=act)), (dilate, groups, layout)
    c = profiler.counters()
    assert c["ops/kernel.selected.scale_shift_act"] == 4
    assert c["ops/kernel.rejected.scale_shift_act"] == 2
    assert c["ops/kernel.selected.conv_bn_relu"] == 3
    assert c["ops/kernel.rejected.conv_bn_relu"] == 5
    profiler.reset_counters()


@pytest.mark.parametrize("case", ["training", "nchw", "grouped"])
def test_rejected_conv_bn_relu_is_the_unfused_chain(monkeypatch, case):
    """Training mode, NCHW and grouped convs take conv -> batch_norm(act),
    as in the JAX package, and agree with it."""
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    rng = np.random.RandomState(4)
    layout = "NCHW" if case == "nchw" else "NHWC"
    groups = 2 if case == "grouped" else 1
    x = rng.randn(2, 5, 5, 8).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, 8 // groups, 6)).astype(np.float32)
    if layout == "NCHW":
        x, w = x.transpose(0, 3, 1, 2).copy(), w.transpose(3, 2, 0, 1).copy()
    bn = [a.astype(np.float32) for a in _bn_params(rng, 6)]
    kw = dict(pad=(1, 1), num_group=groups, layout=layout,
              training=case == "training")
    want = jraw.conv_bn_relu(*(jnp.asarray(a) for a in [x, w] + bn), **kw)
    cbr.reset_counts()
    got = _raw.conv_bn_relu(*(torch.from_numpy(a) for a in [x, w] + bn), **kw)
    assert cbr.mm_plain_calls == 0
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the bf16 1x1 conv: the wgmma kernel's route
# ---------------------------------------------------------------------------

# (Cin, Cout): ResNet's channel pairs of stage 1, cut to a few pixels, and
# one pair whose rows are no multiple of 16 bytes
BF16_1X1 = [(64, 64), (64, 256), (256, 64), (12, 20)]


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("chans", BF16_1X1, ids=lambda c: f"{c[0]}to{c[1]}")
def test_bf16_1x1_conv_bn_relu_matches_pallas(chans, act):
    """The 1x1/stride-1 conv in bf16, the path the wgmma kernel takes on
    the card, through the GEMM's plain version here; the Pallas forward in
    interpret mode on the same bf16 inputs."""
    cin, cout = chans
    rng = np.random.RandomState(cin + cout)
    x = rng.randn(2, 5, 6, cin).astype(np.float32)
    w = (rng.randn(1, 1, cin, cout) / np.sqrt(cin)).astype(np.float32)
    bn = [a.astype(np.float32) for a in _bn_params(rng, cout)]
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    want = jcbr.conv_bn_relu(jnp.asarray(_f32(xb), jnp.bfloat16),
                             jnp.asarray(_f32(wb), jnp.bfloat16),
                             *(jnp.asarray(a) for a in bn), act=act,
                             interpret=True)
    cbr.reset_counts()
    with torch.no_grad():
        got = cbr.conv_bn_relu(xb, wb, *(torch.from_numpy(a) for a in bn),
                               act=act)
    assert (cbr.mm_plain_calls, cbr.mm_launches, cbr.mm_wgmma_launches) == \
        (1, 0, 0)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    # bf16 both sides from the same inputs and folded f32 scale and shift:
    # the f32 sums differ in order only, so the one rounding to bf16
    # lands at most one unit (2**-8 of the value) apart
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                               atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_of_reads_dtype_rows_and_pointers(dtype):
    """The wrapper's route from its operands: bf16 with 16-byte rows and
    16-byte aligned x and w goes to wgmma; f32, a row of 70 or 30 values,
    or an x one value off 16 bytes goes to the SIMT kernel."""
    tdt = _TORCH[dtype]
    base = torch.zeros(2 * 64 * 8 + 8, dtype=tdt)
    x = base[:128 * 8].view(128, 8)
    w = torch.zeros(8, 64, dtype=tdt)
    bf16 = dtype == "bfloat16"
    assert cbr._route_of(x, w) == ("wgmma" if bf16 else "simt")
    assert cbr._route_of(base[1:1 + 128 * 8].view(128, 8), w) == "simt"
    assert cbr._route_of(torch.zeros(100, 70, dtype=tdt),
                         torch.zeros(70, 30, dtype=tdt)) == "simt"
