"""Hand-written CUDA kernels for Hopper (sm_90a), the counterparts of the
Pallas kernels of ``incubator_mxnet_tpu/ops/pallas/``. Sources live in
``csrc/``; ``_build`` compiles them with ``nvcc`` at first use.

Each wrapper counts, in its module, the kernel launches it made and the
calls that took its plain version. :func:`launch_counts` reads every pair
under one name a kernel. A CUDA graph replays its kernels without running
the wrappers' Python, so whoever captures one measures what the capture
counted with :func:`launch_delta` (and takes it back out: a capture runs
nothing on the card), and credits it on every replay with
:func:`add_launch_counts`; the capture itself runs under
:func:`gc_paused`. :func:`capture` does all of that for the port's three
graphs (``FusedTrainStep``'s step, ``FrozenModel``'s buckets and a
hybridized block's signatures).
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from . import conv_bn_relu, flash_attention, layer_norm

__all__ = ["conv_bn_relu", "flash_attention", "layer_norm", "launch_counts",
           "add_launch_counts", "launch_delta", "gc_paused",
           "register_generator", "capture", "flatten", "unflatten"]

# kernel name -> (module, its launch counter, its plain-call counter; None
# where the kernel shares its plain version, and that version's counter,
# with another kernel: both GEMM routes' plain calls count under
# "mm_epilogue")
_COUNTERS = {
    "flash_fwd": (flash_attention, "launches", "plain_calls"),
    "flash_bwd_dq": (flash_attention, "dq_launches", "dq_plain_calls"),
    "flash_bwd_dkv": (flash_attention, "dkv_launches", "dkv_plain_calls"),
    "layer_norm": (layer_norm, "launches", "plain_calls"),
    "scale_shift_act": (conv_bn_relu, "ssa_launches", "ssa_plain_calls"),
    "mm_epilogue": (conv_bn_relu, "mm_launches", "mm_plain_calls"),
    "mm_wgmma": (conv_bn_relu, "mm_wgmma_launches", None),
    "mm_splitk_reduce": (conv_bn_relu, "mm_reduce_launches",
                         "mm_reduce_plain_calls"),
}
_lock = threading.Lock()


def launch_counts() -> dict:
    """``{kernel: (launches, plain calls)}`` of every kernel's wrapper."""
    return {name: (getattr(mod, n), getattr(mod, p) if p else 0)
            for name, (mod, n, p) in _COUNTERS.items()}


def add_launch_counts(delta: dict) -> None:
    """Add the launches of `delta` (``{kernel: (launches, plain calls)}``,
    as :func:`launch_delta` measures it) to the counters: one graph
    replay's. A delta that holds a plain call raises and adds nothing: a
    replay runs on the card, where no wrapper takes its plain version."""
    unknown = set(delta) - set(_COUNTERS)
    if unknown:
        raise KeyError(f"add_launch_counts: no kernel {sorted(unknown)}")
    plain = {k: p for k, (_, p) in delta.items() if p}
    if plain:
        raise ValueError(f"add_launch_counts: a delta with plain calls "
                         f"{plain} cannot be credited as launches")
    with _lock:
        for name, (n, _) in delta.items():
            mod, attr, _ = _COUNTERS[name]
            setattr(mod, attr, getattr(mod, attr) + n)


@contextlib.contextmanager
def launch_delta():
    """Count apart what runs inside: yields a dict that is filled on exit
    with ``{kernel: (launches, plain calls)}`` made inside, and sets every
    counter back to where it stood on entry (also when the body raises).
    Nothing else may launch a kernel meanwhile: its counts would be taken
    back out too."""
    before = launch_counts()
    delta = {}
    try:
        yield delta
        after = launch_counts()
        delta.update({k: (after[k][0] - before[k][0],
                          after[k][1] - before[k][1]) for k in before})
    finally:
        with _lock:
            for name, (n, p) in before.items():
                mod, n_attr, p_attr = _COUNTERS[name]
                setattr(mod, n_attr, n)
                if p_attr:
                    setattr(mod, p_attr, p)


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector held off inside, for a CUDA graph
    capture. A graph left in a reference cycle (a stopped server's frozen
    model, say) is destroyed whenever the collector next runs, and one
    destroyed while another is being captured invalidates that capture.
    What becomes garbage inside is collected after."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def register_generator(graph, gen):
    """Register the CUDA generator `gen` with `graph` before its capture:
    each replay then draws from the generator's offset at that moment and
    advances it, and a re-seed after the capture reaches the replays.
    Raises where this PyTorch cannot register a generator: a graph would
    either refuse the draw or keep one mask for every replay."""
    reg = getattr(graph, "register_generator_state", None)
    if reg is None:
        raise RuntimeError(
            f"torch {torch.__version__} cannot register a generator with a "
            f"CUDA graph (CUDAGraph.register_generator_state): a captured "
            f"step could not draw fresh random numbers on each replay")
    reg(gen)


def flatten(out):
    """Outputs -> (list of tensors, tree), for a tensor or nested tuples
    and lists of tensors."""
    leaves = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            leaves.append(o)
            return ("leaf", len(leaves) - 1)
        if isinstance(o, (tuple, list)):
            return ("seq", type(o) is tuple, [walk(i) for i in o])
        raise TypeError(f"a captured function returns tensors, got "
                        f"{type(o).__name__}")
    return leaves, walk(out)


def unflatten(tree, leaves):
    """The outputs of :func:`flatten`'s `tree` with `leaves` in place."""
    if tree[0] == "leaf":
        return leaves[tree[1]]
    seq = [unflatten(c, leaves) for c in tree[2]]
    return tuple(seq) if tree[1] else seq


def capture(fn, device, pool, generator, what, warmup=None):
    """`fn()` captured as one CUDA graph in the memory pool `pool`.

    `warmup` (default `fn`) runs once eagerly on a side stream first, so
    that nothing lazy (a kernel's build or its opt-in to shared memory, a
    library handle) runs inside the capture; then `generator` is
    registered with the graph and `fn` is captured under
    :func:`launch_delta` and :func:`gc_paused`. A capture that took a
    plain version raises, naming `what`. Returns the graph, the leaves and
    tree of `fn`'s outputs (:func:`flatten`) and the launches of one
    replay, which the caller credits on each (:func:`add_launch_counts`).
    """
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        (warmup or fn)()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    register_generator(graph, generator)
    with launch_delta() as delta, gc_paused(), \
            torch.cuda.graph(graph, pool=pool):
        out = fn()
    plain = {k: p for k, (_, p) in delta.items() if p}
    if plain:
        raise RuntimeError(f"{what} ran plain versions {plain}")
    leaves, tree = flatten(out)
    return graph, leaves, tree, dict(delta)
