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
:func:`gc_paused`.
"""
from __future__ import annotations

import contextlib
import gc
import threading

from . import conv_bn_relu, flash_attention, layer_norm

__all__ = ["conv_bn_relu", "flash_attention", "layer_norm", "launch_counts",
           "add_launch_counts", "launch_delta", "gc_paused"]

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
