"""The port's autograd API against the JAX package's, on the CPU.

Both sides get the same numpy inputs and weights: the scopes' flags
(``record``, ``pause``, ``train_mode``, ``predict_mode``) and what dropout
does under each; ``grad`` on an MLP of Gluon Dense layers (with head
gradients, with a variable the heads do not reach, on Parameters);
``create_graph`` second derivatives through Dense, LayerNorm and
scale/shift/act (the port's kernel Functions, whose backward is
closed-form PyTorch); ``mark_variables``' buffers; a user ``Function``
(MXNet's documented sigmoid); ``backward(train_mode=False)``;
``get_symbol`` raising; and a second derivative through the flash
attention, which raises in both packages (the JAX package's Pallas
kernels have no JVP; the port's backward is once differentiable).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.ops.pallas import flash_attention as jax_flash
from incubator_mxnet_tpu_torch import autograd, gluon, ops
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln

TOL = dict(rtol=1e-5, atol=1e-6)

# scope sequences, entered outermost first
SCOPES = {
    "none": [],
    "record": ["record"],
    "record_predict": ["record(False)"],
    "pause": ["pause"],
    "pause_train": ["pause(True)"],
    "record_pause": ["record", "pause"],
    "record_pause_train": ["record", "pause(True)"],
    "record_predict_mode": ["record", "predict_mode"],
    "record_train_mode": ["record(False)", "train_mode"],
    "train_mode": ["train_mode"],
    "pause_train_mode": ["pause", "train_mode"],
    "predict_mode_record": ["predict_mode", "record"],
}


def _enter(stack, module, names):
    for n in names:
        name, _, arg = n.partition("(")
        fn = getattr(module, name)
        stack.enter_context(fn(arg == "True)") if arg else fn())


def _in_scopes(module, names, fn):
    import contextlib
    with contextlib.ExitStack() as stack:
        _enter(stack, module, names)
        return fn()


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_scope_flags_and_dropout_match_jax(scope):
    """is_recording and is_training inside each nesting of scopes, whether
    grad is enabled (recording), and whether dropout drops, as in the JAX
    package; the flags come back on exit."""
    names = SCOPES[scope]
    x = np.random.RandomState(0).rand(64, 8).astype(np.float32) + 1.0

    def jax_side():
        dropped = nd.Dropout(nd.array(x), p=0.5).asnumpy()
        return (jautograd.is_recording(), jautograd.is_training(),
                not np.array_equal(dropped, x))

    def port_side():
        dropped = ops.Dropout(torch.from_numpy(x), 0.5).numpy()
        return (autograd.is_recording(), autograd.is_training(),
                not np.array_equal(dropped, x), torch.is_grad_enabled())

    want = _in_scopes(jautograd, names, jax_side)
    got = _in_scopes(autograd, names, port_side)
    assert got[:3] == want
    if names and names[-1].startswith(("record", "pause")):
        # a recording scope sets grad mode; a training scope leaves it
        assert got[3] == got[0]
    assert (autograd.is_recording(), autograd.is_training()) == (False, False)
    assert torch.is_grad_enabled()


def _mlp_pair(seed=0):
    """A two-layer tanh MLP of Gluon Dense layers in both packages, with
    the same weights."""
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(6, activation="tanh", in_units=4),
             jgluon.nn.Dense(3, in_units=6))
    jnet.initialize(mx.init.Normal(0.5))
    tnet = gluon.nn.HybridSequential(
        gluon.nn.Dense(6, activation="tanh", in_units=4),
        gluon.nn.Dense(3, in_units=6))
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in jnet._collect_params_with_prefix().items():
        a = rng.randn(*p.shape).astype(np.float32) * 0.5
        p.set_data(nd.array(a))
        arrays[name] = a
    load_jax_params(tnet, arrays)
    return jnet, tnet


def _jparams(jnet):
    return list(jnet._collect_params_with_prefix().items())


@pytest.mark.parametrize("head_grad", [False, True])
def test_grad_on_an_mlp_matches_jax_and_writes_no_grad(head_grad):
    """grad(heads, [x] + params) with and without head gradients: the
    gradients of the input and of every Parameter as the JAX package's,
    .grad untouched (None before and after; a parameter's stays None)."""
    jnet, tnet = _mlp_pair()
    rng = np.random.RandomState(1)
    x = rng.randn(5, 4).astype(np.float32)
    hg = rng.randn(5, 3).astype(np.float32) if head_grad else None
    jx = nd.array(x)
    jx.attach_grad()
    jps = _jparams(jnet)
    with jautograd.record():
        jy = jnet(jx)
    want = jautograd.grad(jy, [jx] + [p.data() for _, p in jps],
                          head_grads=None if hg is None else nd.array(hg))
    tx = torch.from_numpy(x).requires_grad_()
    tps = tnet._collect_params_with_prefix()
    with autograd.record():
        ty = tnet(tx)
    got = autograd.grad(ty, [tx] + [tps[n] for n, _ in jps],
                        head_grads=None if hg is None else torch.from_numpy(hg))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.asnumpy(), **TOL)
    assert tx.grad is None
    assert all(p.data().torch().grad is None for p in tps.values())


def test_grad_single_variable_unreached_and_head_as_variable():
    """A single variable gives a single tensor; a variable the heads do not
    reach (or that takes no gradient) gets zeros; a head that is itself a
    variable gets its head gradient, as in the JAX package."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jx, jz = nd.array(x), nd.array(x + 1)
    jx.attach_grad()
    jz.attach_grad()
    with jautograd.record():
        jy = (jx * jx).sum()
    jw = jautograd.grad(jy, [jx, jz])
    jsingle = jautograd.grad(jy, jx)
    tx = torch.from_numpy(x).requires_grad_()
    tz = torch.from_numpy(x + 1).requires_grad_()
    frozen = torch.from_numpy(x + 2)
    with autograd.record():
        ty = (tx * tx).sum()
    got = autograd.grad(ty, [tx, tz, frozen], retain_graph=True)
    single = autograd.grad(ty, tx)
    assert isinstance(single, torch.Tensor)
    np.testing.assert_allclose(single.numpy(), jsingle.asnumpy(), **TOL)
    np.testing.assert_allclose(got[0].numpy(), jw[0].asnumpy(), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), jw[1].asnumpy())
    np.testing.assert_array_equal(got[2].numpy(), np.zeros_like(x))
    # the head is the variable: d head / d head is the seed
    seed = np.full((2, 3), 3.0, np.float32)
    jh = jautograd.grad(jx, [jx], head_grads=nd.array(seed))[0]
    th = autograd.grad(tx, [tx], head_grads=torch.from_numpy(seed))[0]
    np.testing.assert_array_equal(th.numpy(), jh.asnumpy())


def _penalty_jax(body, x, params):
    """h = ||d sum(c * body(x)) / dx||^2 through the JAX package's autograd
    with create_graph, then backward: (h, x.grad, each param's grad)."""
    jx = nd.array(x)
    jx.attach_grad()
    jps = [nd.array(p) for p in params]
    for p in jps:
        p.attach_grad()
    c = nd.array(np.random.RandomState(7).randn(
        *np.shape(body(jx, jps, jax=True))).astype(np.float32))
    with jautograd.record():
        f = (body(jx, jps, jax=True) * c).sum()
        gx = jautograd.grad(f, [jx], create_graph=True)[0]
        h = (gx * gx).sum()
    h.backward()
    return [h.asnumpy(), jx.grad.asnumpy()] + [p.grad.asnumpy() for p in jps]


def _penalty_port(body, x, params):
    tx = torch.from_numpy(x).requires_grad_()
    tps = [torch.from_numpy(p).requires_grad_() for p in params]
    out_shape = tuple(body(tx, tps, jax=False).shape)
    c = torch.from_numpy(np.random.RandomState(7).randn(
        *out_shape).astype(np.float32))
    with autograd.record():
        f = (body(tx, tps, jax=False) * c).sum()
        gx = autograd.grad(f, [tx], create_graph=True)[0]
        assert gx.requires_grad
        h = (gx * gx).sum()
    autograd.backward(h)
    # a leaf the penalty does not reach (beta; the shift, behind relu's
    # mask) keeps no gradient, where the JAX package's stays zeros
    return [h.detach().numpy()] + [
        np.zeros(tuple(p.shape), np.float32) if p.grad is None
        else p.grad.numpy() for p in [tx] + tps]


def _dense_ln(x, ps, jax):
    w, b, gamma, beta = ps
    if jax:
        y = (nd.dot(x, w) + b).tanh()
        return nd.LayerNorm(y, gamma, beta)
    y = torch.tanh(x @ w + b)
    return ln.layer_norm(y, gamma, beta)


def _ssa(x, ps, jax):
    scale, shift, w = ps
    if jax:
        y = nd.relu(x * scale + shift)
        return nd.dot(y, w)
    return cbr.scale_shift_act(x, scale, shift, "relu") @ w


@pytest.mark.parametrize("case", ["dense_layer_norm", "scale_shift_act"])
def test_second_derivatives_match_jax(case):
    """A gradient penalty, ||df/dx||^2 taken with create_graph=True and
    backpropagated, through Dense + tanh + LayerNorm (the port's
    LayerNormFunction, closed-form backward) and through the scale/shift/
    relu Function: the penalty, x's gradient and every parameter's as the
    JAX package's."""
    rng = np.random.RandomState(3)
    if case == "dense_layer_norm":
        body = _dense_ln
        x = rng.randn(4, 6).astype(np.float32)
        params = [rng.randn(6, 8).astype(np.float32) * 0.5,
                  rng.randn(8).astype(np.float32) * 0.1,
                  1 + 0.1 * rng.randn(8).astype(np.float32),
                  0.1 * rng.randn(8).astype(np.float32)]
    else:
        body = _ssa
        x = rng.randn(5, 8).astype(np.float32)
        params = [1 + 0.2 * rng.randn(8).astype(np.float32),
                  0.3 * rng.randn(8).astype(np.float32),
                  rng.randn(8, 3).astype(np.float32)]
    want = _penalty_jax(body, x, params)
    got = _penalty_port(body, x, params)
    assert np.abs(want[2]).max() > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                   err_msg=f"output {i}")


def test_second_derivative_through_conv_bn_relu_is_recorded():
    """ConvBNReLUFunction's backward re-derives through the plain conv
    under create_graph, so a gradient penalty through it equals the same
    penalty through the plain formulation (torch autograd all the way),
    where its backward used to return gradients with no graph."""
    rng = np.random.RandomState(4)
    arrays = [rng.randn(2, 5, 5, 3), rng.randn(3, 3, 3, 4) * 0.3,
              1 + 0.1 * rng.randn(4), 0.1 * rng.randn(4)]
    c = torch.from_numpy(rng.randn(2, 5, 5, 4).astype(np.float32))

    def penalty(fn):
        leaves = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
                  for a in arrays]
        with autograd.record():
            f = (fn(*leaves, (1, 1), (1, 1), "relu") * c).sum()
            gx = autograd.grad(f, leaves[0], create_graph=True)
            h = (gx * gx).sum()
        autograd.backward(h)
        return [h.detach()] + [t.grad for t in leaves]

    got = penalty(cbr.ConvBNReLUFunction.apply)
    want = penalty(cbr.conv_bn_ref)
    assert float(want[2].abs().max()) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("req", ["write", "add"])
def test_mark_variables_buffers_match_jax(req):
    """After backward the tensor passed as the gradient holds the gradient,
    the same object: written for "write", added to for "add" (two backwards
    from a buffer of ones), as the JAX package's; "null" takes none."""
    x = np.linspace(-1, 1, 6).astype(np.float32).reshape(2, 3)
    jx, jbuf = nd.array(x), nd.array(np.ones_like(x))
    jautograd.mark_variables([jx], [jbuf], req)
    tx, tbuf = torch.from_numpy(x.copy()), torch.ones(2, 3)
    tn = torch.from_numpy(x.copy())
    autograd.mark_variables([tx, tn], [tbuf, torch.zeros(2, 3)],
                            [req, "null"])
    for _ in range(2):
        with jautograd.record():
            jy = (jx * jx * jx).sum()
        jy.backward()
        with autograd.record():
            ty = (tx * tx * tx).sum() + (tn * tx).sum()
        autograd.backward(ty)
    assert tx.grad is tbuf
    assert tn.grad is None and not tn.requires_grad
    np.testing.assert_allclose(
        tbuf.numpy(), jx.grad.asnumpy() + (x if req == "write" else 2 * x),
        **TOL)


def test_mark_variables_on_a_parameter_and_rejects_a_computed_tensor():
    _, tnet = _mlp_pair()
    p = tnet._collect_params_with_prefix()["0.weight"]
    buf = torch.zeros(p.shape)
    autograd.mark_variables(p, buf, "add")
    assert p.grad_req == "add" and p.data().torch().grad is buf
    with autograd.record():
        y = tnet(torch.ones(2, 4)).sum()
    autograd.backward(y)
    assert p.data().torch().grad is buf and float(buf.abs().sum()) > 0
    with pytest.raises(ValueError, match="leaf"):
        autograd.mark_variables(p.data().torch() * 2, buf)


class _JaxSigmoid(jautograd.Function):
    def forward(self, x):
        y = 1 / (1 + nd.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self._saved
        return dy * y * (1 - y)


class _Sigmoid(autograd.Function):
    """MXNet's documented example."""

    def forward(self, x):
        y = 1 / (1 + torch.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self.saved_tensors
        return dy * y * (1 - y)


def test_user_function_between_dense_layers_matches_jax_and_sigmoid():
    """A user Function between two Dense layers: the forward ran under
    pause (no graph inside, predict mode), the gradients of every
    Parameter as the JAX package's and as the same net with
    torch.sigmoid; outside record() it is a plain call."""
    jnet, tnet = _mlp_pair(5)
    x = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    j0, j1 = jnet[0], jnet[1]
    t0, t1 = tnet[0], tnet[1]
    j0.act = t0.act = None
    seen = []

    class Spy(_Sigmoid):
        def forward(self, x):
            seen.append((autograd.is_recording(), autograd.is_training(),
                         torch.is_grad_enabled()))
            return super().forward(x)

    with jautograd.record():
        jy = j1(_JaxSigmoid()(j0(nd.array(x))))
    jy.backward()
    tps = tnet._collect_params_with_prefix()
    for fn in (Spy(), torch.sigmoid):
        with autograd.record():
            ty = t1(fn(t0(torch.from_numpy(x))))
        autograd.backward(ty)
        got = {n: p.data().torch().grad.clone() for n, p in tps.items()}
        for name, p in _jparams(jnet):
            np.testing.assert_allclose(got[name].numpy(),
                                       p.grad().asnumpy(), **TOL)
    assert seen == [(False, False, False)]
    out = _Sigmoid()(torch.zeros(3))
    assert out.grad_fn is None and torch.equal(out, torch.full((3,), 0.5))


def test_backward_takes_train_mode_like_jax():
    """backward(..., train_mode=False) is accepted in both packages and
    gives the same gradient as the default."""
    x = np.array([0.5, -1.0, 2.0], np.float32)
    jx = nd.array(x)
    jx.attach_grad()
    with jautograd.record():
        jy = (jx * jx).sum()
    jautograd.backward(jy, train_mode=False)
    tx = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        ty = (tx * tx).sum()
    autograd.backward(ty, train_mode=False)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **TOL)


def test_get_symbol_raises_naming_the_symbol_module():
    x = torch.ones(2, requires_grad=True)
    with autograd.record():
        y = x * 2
    with pytest.raises(NotImplementedError, match="A.9"):
        autograd.get_symbol(y)


def test_the_api_matches_the_jax_packages():
    assert autograd.__all__ == jautograd.__all__
    import inspect
    for name in ("record", "pause", "mark_variables", "backward", "grad"):
        assert (list(inspect.signature(getattr(autograd, name)).parameters)
                == list(inspect.signature(getattr(jautograd, name))
                        .parameters)), name


def test_attention_second_derivative_raises_in_both_packages():
    """jax.grad of jax.grad through the Pallas flash attention (interpret
    mode) raises: pallas_call has no JVP. The port raises too, on the CPU
    here and, the same Function, on the card, where its kernels record no
    graph: its backward is once differentiable, never a silent zero."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, 2, 16, 8).astype(np.float32) for _ in range(3))

    def f(q):
        return (jax_flash(q, jnp.asarray(k), jnp.asarray(v), block_q=8,
                          block_k=8, interpret=True) ** 2).sum()

    jax.grad(f)(jnp.asarray(q))                    # first order works
    with pytest.raises(Exception):
        jax.grad(lambda q: (jax.grad(f)(q) ** 2).sum())(jnp.asarray(q))

    tq = torch.from_numpy(q).requires_grad_()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    with autograd.record():
        out = fa.flash_attention(tq, tk, tv)
        g = autograd.grad((out ** 2).sum(), tq, create_graph=True)
        penalty = (g ** 2).sum()
    with pytest.raises(RuntimeError, match="once_differentiable"):
        autograd.backward(penalty)
