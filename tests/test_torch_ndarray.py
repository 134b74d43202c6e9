"""The port's ``nd`` against the JAX package's, on the CPU.

- A parity table: each case runs one function or method of ``nd`` in both
  packages on the same numpy inputs (seeded), and holds the port's values
  to the JAX package's within 1e-6 relative (1e-7 absolute, for values
  that cross zero) in float32, exactly for integers and booleans, with
  equal dtypes and shapes. The gamma-function family (``gammaln``,
  ``gamma``, ``digamma``) is held to 1e-5 relative: XLA's and torch's
  float32 algorithms for it differ by several ulps (1.2e-6 relative seen
  for ``gammaln``, 1.9e-6 for ``gamma``), which is no fault of either.
- A walk over the JAX package's public names of ``ndarray``,
  ``ndarray.random`` and ``ndarray.linalg``: each exists in the port, or
  raises ``NotImplementedError`` naming its ROADMAP item (A.5c or A.9;
  A.6 for ``nd.contrib``, which the JAX package's ``ops`` package adds to
  ``nd`` with the box and control-flow ops).
- A scripted mutation sequence (a slice written, ``+=``, ``detach`` then
  write, ``copyto``, ``astype(copy=False)``) with every array equal in
  both packages after every step: the port's arrays never alias.
- ``attach_grad`` with ``write`` and ``add``, ``backward(out_grad)`` and
  ``autograd.grad`` against the JAX tape within 1e-5.
- ``nd.save`` read by the JAX package's ``nd.load`` and the reverse, for
  one array, a list and a dict.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu_torch import autograd, cpu, nd
from nd_parity_cases import CASES, Arrays, inputs

RTOL, ATOL = 1e-6, 1e-7
SPECIAL_RTOL = {"gammaln": 1e-5, "gamma_fn": 1e-5, "digamma": 1e-5}
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _run(case, side):
    """The case on one side: a tuple of numpy arrays (dtype kept) and the
    packages' dtypes."""
    if side == "jax":
        M, scope = jnd, mx.cpu()
    else:
        M, scope = nd, cpu()
    with scope:
        out = CASES[case](M, Arrays(M, inputs()))
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [(np.asarray(o.asnumpy()), np.dtype(o.dtype), o.shape)
            for o in outs]


@pytest.mark.parametrize("case", list(CASES))
def test_parity_table(case):
    got, want = _run(case, "port"), _run(case, "jax")
    assert len(got) == len(want)
    for (g, gdt, gs), (w, wdt, ws) in zip(got, want):
        assert gdt == wdt, (case, gdt, wdt)
        assert gs == ws == g.shape, (case, gs, ws)
        if np.issubdtype(wdt, np.floating):
            np.testing.assert_allclose(g, w, rtol=SPECIAL_RTOL.get(
                case, RTOL), atol=ATOL, err_msg=case)
        else:
            np.testing.assert_array_equal(g, w, err_msg=case)


def test_every_case_runs_on_ndarrays_and_on_tensors():
    """A function given a tensor answers with a tensor of the NDArray
    path's value (the forward of a block calls nd.* on tensors)."""
    x = inputs()["a"]
    for fn in (nd.exp, nd.relu, lambda a: nd.sum(a, axis=1),
               lambda a: nd.topk(a, k=2), lambda a: nd.concat(a, a),
               lambda a: nd.dot(a, a, transpose_b=True)):
        t = fn(torch.from_numpy(x))
        n = fn(nd.array(x, ctx=cpu()))
        assert isinstance(t, torch.Tensor) and isinstance(n, nd.NDArray)
        np.testing.assert_array_equal(t.numpy(), n.asnumpy())


# ---------------------------------------------------------------------------
# every public name of the JAX package's nd, nd.random and nd.linalg
# ---------------------------------------------------------------------------

# names the port answers with NotImplementedError, and the ROADMAP item
RAISES = {"Custom": r"A\.9", "sparse": r"A\.5c", "contrib": r"A\.6"}


def _public(module, top):
    """The public names `module` defines (functions, classes, aliases and,
    for the `top` package, what its submodules give it), not the names it
    imports from elsewhere."""
    import types
    out = []
    for name in dir(module):
        if name.startswith("_"):
            continue
        obj = getattr(module, name)
        where = (obj.__name__ if isinstance(obj, types.ModuleType)
                 else getattr(obj, "__module__", None) or "")
        if (where.startswith(module.__name__) if top
                else where == module.__name__):
            out.append(name)
    return sorted(out)


@pytest.mark.parametrize("sub", ["", "random", "linalg"])
def test_every_public_name_is_ported_or_names_its_item(sub):
    jmod = jnd if not sub else getattr(jnd, sub)
    tmod = nd if not sub else getattr(nd, sub)
    names = _public(jmod, not sub)
    assert len(names) >= {"": 215, "random": 20, "linalg": 17}[sub]
    missing = [n for n in names if not hasattr(tmod, n)]
    assert not missing, missing
    for n in names:
        if n in RAISES and not sub:
            obj = getattr(tmod, n)
            with pytest.raises(NotImplementedError, match=RAISES[n]):
                obj.box_nms if n == "contrib" else (
                    obj.csr_matrix if n == "sparse" else obj())
    if not sub:
        with pytest.raises(NotImplementedError, match=r"A\.5c"):
            nd.embedding(nd.zeros((2,), ctx=cpu()),
                         nd.zeros((3, 2), ctx=cpu()), sparse_grad=True)

        class Sparse:
            stype = "csr"
        with pytest.raises(NotImplementedError, match=r"A\.5c"):
            nd.zeros((2,), ctx=cpu()) + Sparse()


def test_every_ndarray_method_and_operator_is_ported():
    """The JAX NDArray's public methods, properties and dunders are the
    port's too (``jax()``, the backing array, is ``torch()`` here)."""
    names = [n for n in dir(jnd.NDArray)
             if not n.startswith("_") or n.endswith("__")]
    assert len(names) >= 100
    missing = [n for n in names
               if not hasattr(nd.NDArray, "torch" if n == "jax" else n)]
    assert not missing, missing


# ---------------------------------------------------------------------------
# mutation never aliases
# ---------------------------------------------------------------------------

def _mutations(M):
    """The scripted sequence on one side; returns a snapshot (numpy) of
    every named array after every step."""
    arrs, snaps = {}, []

    def snap(step):
        snaps.append((step, {k: v.asnumpy().copy() for k, v in arrs.items()}))

    arrs["x"] = M.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    arrs["y"] = arrs["x"][1:3]
    arrs["y"][:] = 0
    snap("slice written")
    arrs["z"] = arrs["x"].reshape((12,))
    arrs["z"] += 1
    snap("reshape +=")
    arrs["d"] = arrs["x"].detach()
    arrs["d"][0, 0] = 100
    snap("detach written")
    arrs["c"] = M.zeros((3, 4))
    arrs["x"].copyto(arrs["c"])
    arrs["c"][1] = 5
    snap("copyto then written")
    arrs["s"] = arrs["x"].astype("float32", copy=False)
    assert arrs["s"] is arrs["x"]
    arrs["s"][0, 1] = -1
    snap("astype(copy=False) written")
    arrs["t"] = arrs["x"].astype("int32")
    arrs["t"][0] = 7
    snap("astype copy written")
    arrs["x"][2, 3] = 42
    arrs["x"] *= 2
    arrs["x"] -= arrs["c"]
    arrs["x"] /= 4
    snap("x written")
    arrs["e"] = M.zeros((2, 2))
    arrs["e"][:] = M.array(np.array([[1, 2], [3, 4]], np.float32))
    arrs["e"][M.array(np.array([0]))] = 9
    snap("written from arrays")
    return snaps


def test_mutation_sequence_matches_the_jax_package():
    with mx.cpu():
        want = _mutations(jnd)
    with cpu():
        got = _mutations(nd)
    for (step, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k],
                                          err_msg=f"{k} after {step}")


# ---------------------------------------------------------------------------
# autograd on NDArrays
# ---------------------------------------------------------------------------

def _grads(M, A, req):
    rng = np.random.RandomState(3)
    xv = rng.standard_normal((3, 4)).astype(np.float32)
    wv = rng.standard_normal((4, 2)).astype(np.float32)
    og = rng.standard_normal((3, 2)).astype(np.float32)
    x, w = M.array(xv), M.array(wv)
    w.attach_grad(req)
    out = {}
    for rnd in range(2):
        with A.record():
            y = M.tanh(M.dot(x, w))
        y.backward(out_grad=M.array(og))
        out[f"backward_{rnd}"] = w.grad.asnumpy()
    with A.record():
        z = (M.sigmoid(M.dot(x, w)) ** 2).sum()
    z.backward()
    out["backward_sum"] = w.grad.asnumpy()
    w2 = M.array(wv)
    w2.attach_grad()
    with A.record():
        h = M.dot(x, w2) * 3
    (g,) = A.grad([h], [w2], head_grads=[M.array(og)])
    out["grad"] = g.asnumpy()
    return out


@pytest.mark.parametrize("req", ["write", "add"])
def test_attach_grad_backward_and_grad_match_the_jax_tape(req):
    with mx.cpu():
        want = _grads(jnd, jautograd, req)
    with cpu():
        got = _grads(nd, autograd, req)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL, err_msg=k)
    if req == "add":
        np.testing.assert_allclose(got["backward_1"],
                                   2 * got["backward_0"], rtol=1e-6)


def test_a_marked_leaf_stays_a_leaf_across_writes():
    with cpu():
        w = nd.zeros((4,))
        w.attach_grad()
        x = nd.random.uniform(shape=(8, 4))
        for _ in range(2):
            with autograd.record():
                loss = ((nd.dot(x, w) - 1.0) ** 2).mean()
            loss.backward()
            w -= 0.1 * w.grad
            w[:] = w * 1.0
        t = w.torch()
        assert t.is_leaf and t.requires_grad and t.grad_req == "write"
        with autograd.pause():
            assert not (w * 2).torch().requires_grad


# ---------------------------------------------------------------------------
# the JAX package's file, both ways
# ---------------------------------------------------------------------------

FORMS = {
    "single": lambda M, a, b: M.array(a),
    "list": lambda M, a, b: [M.array(a), M.array(b)],
    "dict": lambda M, a, b: {"w": M.array(a), "ids": M.array(b)},
}


def _values(x):
    if isinstance(x, dict):
        return {k: (v.asnumpy(), np.dtype(v.dtype)) for k, v in x.items()}
    if isinstance(x, list):
        return [(v.asnumpy(), np.dtype(v.dtype)) for v in x]
    return (x.asnumpy(), np.dtype(x.dtype))


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_reads_the_other_packages_file(form, writer, tmp_path):
    a = np.random.RandomState(4).standard_normal((2, 3)).astype(np.float32)
    b = np.arange(5, dtype=np.int32)
    path = str(tmp_path / "arrays.nd")
    wm, rm, ws, rs = ((nd, jnd, cpu(), mx.cpu()) if writer == "port"
                      else (jnd, nd, mx.cpu(), cpu()))
    with ws:
        data = FORMS[form](wm, a, b)
        wm.save(path, data)
    with rs:
        back = rm.load(path)
    want, got = _values(data), _values(back)
    flat_w = want if isinstance(want, list) else (
        list(want.values()) if isinstance(want, dict) else [want])
    flat_g = got if isinstance(got, list) else (
        list(got.values()) if isinstance(got, dict) else [got])
    if isinstance(want, dict):
        assert sorted(want) == sorted(got)
    for (gv, gd), (wv, wd) in zip(flat_g, flat_w):
        assert gd == wd
        np.testing.assert_array_equal(gv, wv)


def test_an_op_error_carries_the_op_name():
    a, b = nd.ones((2, 3), ctx=cpu()), nd.ones((4, 5), ctx=cpu())
    with pytest.raises(RuntimeError) as err:
        nd.dot(a, b)
    assert "in nd.dot" in err.value.__notes__


def test_waitall_synchronizes_only_the_cards_in_use(monkeypatch):
    # four cards: the current one is 1, and only card 3 holds memory of
    # this process; cards 0 and 2 must get no CUDA context
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda i: 1 << 20 if i == 3 else 0)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    nd.waitall()
    assert synced == [1, 3]
