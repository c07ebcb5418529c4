"""Build, bind and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source in :data:`SOURCES` is compiled by its own
``nvcc`` call, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes.  The build
runs at first use, on the machine with the card, into the gitignored
``_build/`` directory under a name keyed by the hash of all sources and
flags; there is no fallback when it fails.

Each C entry point takes device pointers and the stream as ``void*`` and
sizes as ``int``, and returns ``cudaGetLastError()`` right after its
launch; :func:`launch` raises when that is not 0 and otherwise adds one to
the entry's count in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

__all__ = ["SOURCES", "LAUNCHES", "reset_launches", "load_library",
           "launch"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG, "csrc", f) for f in (
    "routed_project.cu", "routed_variants.cu", "fused_project.cu"))
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no a*b+c is contracted into an FMA, so every float op rounds
# as the plain PyTorch versions' separate ops do (the routed kernels call
# fmaf explicitly, which the flag leaves alone)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> ctypes argument types (pointers, ints, then the stream)
_ENTRIES = {
    "routed_fwd": [_P, _P, _P, _P, _P, _I, _P],
    "routed_bwd_gather": [_P, _P, _P, _P, _P, _I, _P],
    "routed_bwd_scatter": [_P] * 6 + [_I] * 4 + [_P],
    "routed_fwd_dense": [_P, _P, _P, _P, _P, _I, _I, _P],
    "routed_fwd_hist": [_P, _P, _P, _P, _P, _I, _P],
    "routed_fwd_window": [_P] * 7 + [_I] * 5 + [_P],
    "routed_bwd_window": [_P] * 10 + [_I] * 5 + [_P],
    "routed_fwd_densew": [_P] * 8 + [_I] * 5 + [_P],
    "fused_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

# kernel launches per wrapper; each wrapper adds one where it launches its
# kernel and nowhere else
LAUNCHES = {name: 0 for name in _ENTRIES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (once per source hash) and load the kernels' shared library.

    Returns ``(lib, build_log)``; ``build_log`` holds nvcc's output
    (``-Xptxas -v`` register and spill lines) when this call built it.
    Raises with the compiler's output when the build fails."""
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")
    log = ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
        nvcc = _nvcc()

        def run(cmd):
            return subprocess.run(cmd, capture_output=True, text=True)

        try:
            # the sources compile in parallel (each is self-contained),
            # then one link
            with ThreadPoolExecutor(len(SOURCES)) as pool:
                procs = list(pool.map(run, (
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                    for src, obj in zip(SOURCES, objs))))
            if all(p.returncode == 0 for p in procs):
                procs.append(run([nvcc, "-shared", "-o", tmp, *objs]))
            log = "".join(p.stdout + p.stderr for p in procs)
            if any(p.returncode != 0 for p in procs):
                raise RuntimeError(f"nvcc failed:\n{log}")
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.routed_error_string.argtypes = [ctypes.c_int]
    lib.routed_error_string.restype = ctypes.c_char_p
    return lib, log


def launch(name, tensors, ints):
    """Launch entry ``name`` on the current stream of the first tensor's
    device; ``None`` in ``tensors`` passes a null pointer."""
    lib, _ = load_library()
    dev = next(t.device for t in tensors if t is not None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (None if t is None else t.data_ptr() for t in tensors)
    rc = getattr(lib, name)(*ptrs, *ints, stream)
    if rc != 0:
        msg = lib.routed_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    LAUNCHES[name] += 1
