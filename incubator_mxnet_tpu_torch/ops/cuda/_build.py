"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface, and loaded with ``ctypes``. No PyTorch
header is included, so a build takes seconds. The library lands in
``_build/<name>-<digest>.so``, where the digest covers the source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged one is
reused. ``flash_attention_wide.cu`` is no library of its own: the flash
backward's source includes it. ``build()`` starts one ``nvcc`` per source,
all at once.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "nvcc", "build", "load", "logs"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "layer_norm",
           "conv_bn_relu", "mm_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    # the shared headers, and the sources that a library includes
    # (flash_attention_wide.cu), which are no library of their own
    for hdr in sorted(p for p in CSRC.iterdir()
                      if p.suffix == ".cuh" or (p.suffix == ".cu"
                                                and p.stem not in SOURCES)):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of `names` that is not built yet, one ``nvcc``
    process per source, all started together. Returns ``{name: seconds}``
    (0.0 for a library already built). Raises on the first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    procs = {}
    seconds = {}
    for name in names:
        out = _target(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        _logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def logs() -> dict:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of each library this process built."""
    return dict(_logs)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C function to ``(restype, argtypes)``; they are
    declared on the library before it is returned."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[name] = lib
        return lib
