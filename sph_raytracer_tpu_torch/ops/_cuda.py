"""Build, bind and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source in :data:`SOURCES` is compiled by its own
``nvcc`` call, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes.  The build
runs at first use, on the machine with the card, into the gitignored
``_build/`` directory under a name keyed by the hash of all sources, the
headers they include (:data:`HEADERS`) and the flags; there is no fallback
when it fails.

Each C entry point takes device pointers and the stream as ``void*`` and
sizes as ``int``, and returns ``cudaGetLastError()`` right after its
launch; :func:`launch` raises when that is not 0 and otherwise adds one to
the entry's count in :data:`LAUNCHES`.  The build and the count are each
under a lock, so ranks that run as threads of one process (the sharded
operators' tests and ``chip_smoke.py``) build once and lose no count.  A
kernel templated on its weight
type has one entry a type: ``<name>`` reads float32 weights and
``<name>_bf16`` bfloat16 ones (``routed_w_dtype='bf16'``), each counted on
its own.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

__all__ = ["SOURCES", "HEADERS", "LAUNCHES", "BF16_ENTRIES",
           "reset_launches", "load_library", "launch"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fused kernel's instantiations compile over four sources, in parallel:
# fused_fwd's (fused_project*.cu) and the sweep's (fused_sweep*.cu,
# tools/fused_sweep.py)
SOURCES = tuple(os.path.join(_PKG, "csrc", f) for f in (
    "routed_project.cu", "routed_variants.cu", "fused_project.cu",
    "fused_project_lerp.cu", "fused_sweep.cu", "fused_sweep_parent.cu"))
HEADERS = tuple(os.path.join(_PKG, "csrc", f) for f in (
    "weight.cuh", "fused_kernel.cuh"))
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
    "routed_fwd_dense": [_P] * 5 + [_I] * 4 + [_P],
    "routed_fwd_hist": [_P] * 6 + [_I] * 3 + [_P],
    "routed_fwd_window": [_P] * 9 + [_I] * 7 + [_P],
    "routed_bwd_window": [_P] * 10 + [_I] * 5 + [_P],
    "routed_fwd_densew": [_P] * 9 + [_I] * 6 + [_P],
    "fused_fwd": [_P] * 8 + [_I] * 5 + [_P],
    # fused_fwd's two designs and stage truncations (tools/fused_sweep.py)
    "fused_fwd_sweep": [_P] * 8 + [_I] * 7 + [_P],
    # routed_fwd's and routed_bwd_gather's walk at other settings (the
    # sweeps' entry)
    "routed_csr_dot": [_P] * 5 + [_I] * 3 + [_P],
}
# the kernels templated on their weight type: each has a bfloat16 entry
# ``<name>_bf16`` with the float32 entry's arguments
BF16_ENTRIES = tuple(f"{n}_bf16" for n in (
    "routed_fwd", "routed_bwd_gather", "routed_bwd_scatter",
    "routed_fwd_dense", "routed_fwd_hist", "routed_fwd_densew",
    "routed_csr_dot"))
_ENTRIES.update({n: _ENTRIES[n[:-len("_bf16")]] for n in BF16_ENTRIES})

# kernel launches per wrapper; each wrapper adds one where it launches its
# kernel and nowhere else
LAUNCHES = {name: 0 for name in _ENTRIES}
_COUNT_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
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


def load_library():
    """Build (once per source hash) and load the kernels' shared library.

    Returns ``(lib, build_log)``; ``build_log`` holds each nvcc call's
    seconds and output (``-Xptxas -v`` register and spill lines) when this
    call built it.  Threads that ask at once wait for one build.
    Raises with the compiler's output when the build fails."""
    with _BUILD_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=None)
def _load_library():
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
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

        def run(cmd, what):
            t0 = time.time()
            p = subprocess.run(cmd, capture_output=True, text=True)
            p.stdout = f"{what}: {time.time() - t0:.1f} s\n{p.stdout}"
            return p

        try:
            # the sources compile in parallel (each is self-contained),
            # then one link
            with ThreadPoolExecutor(len(SOURCES)) as pool:
                procs = list(pool.map(
                    run, ([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                          for src, obj in zip(SOURCES, objs)),
                    (os.path.basename(src) for src in SOURCES)))
            if all(p.returncode == 0 for p in procs):
                procs.append(run([nvcc, "-shared", "-o", tmp, *objs],
                                 "link"))
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
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
