"""Routed projection engine: GPU CSR tables + hand-written CUDA kernels.

Port of ``sph_raytracer_tpu/ops/routed_project.py``'s banded engine.  The
operator is the sparse matrix A (rays x voxels) of traced segment lengths;
the forward is y = A·d and the backward dD = Aᵀ·dy, accumulated in f32.

Tables (:func:`build_tables`), built on the device with torch ops from the
traced ``(lin, lens)``:

* a ray-major CSR ``row_ptr`` (R+1) / ``col`` / ``val`` of the live
  (nonzero-length) crossings, and
* for the deterministic backward, its voxel-major transpose ``vox_ptr``
  (V+1) / ``ray`` / ``valT``, made by a **stable** sort of ``col`` so each
  voxel row lists its rays in ascending order (a fixed summation order).

Kernels (``csrc/routed_project.cu``), each beside its plain PyTorch
version and a launch counter in :data:`LAUNCHES`:

==================== ============================== =====================
wrapper              replaces (TPU kernel)          plain version
==================== ============================== =====================
routed_fwd           ``_fwd_banded_pallas`` (B1)     routed_fwd_ref
routed_bwd_gather    ``_bwd_banded_dense_pallas`` (B2) routed_bwd_gather_ref
routed_bwd_scatter   ``_bwd_banded_pallas`` (B3)     routed_bwd_scatter_ref
==================== ============================== =====================

A wrapper runs the plain version only because the tensor it was given
lies on the CPU; for a CUDA tensor it launches the kernel or raises.  The
library is built from the sources in this package with ``nvcc`` at first
use (:func:`load_library`); there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import NamedTuple

import torch

__all__ = [
    "RoutedTables",
    "build_tables",
    "routed_fwd",
    "routed_bwd_gather",
    "routed_bwd_scatter",
    "routed_fwd_ref",
    "routed_bwd_gather_ref",
    "routed_bwd_scatter_ref",
    "routed_project",
    "BACKWARDS",
    "LAUNCHES",
    "reset_launches",
    "load_library",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG, "csrc", "routed_project.cu"),)
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches per wrapper; each wrapper adds one where it launches its
# kernel and nowhere else
LAUNCHES = {"routed_fwd": 0, "routed_bwd_gather": 0, "routed_bwd_scatter": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

class RoutedTables(NamedTuple):
    """GPU-native CSR tables of one operator (see module docstring).
    ``vox_ptr``/``ray``/``valT`` are None when the transpose was not
    built (the scatter backward does not need it)."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    vox_ptr: torch.Tensor
    ray: torch.Tensor
    valT: torch.Tensor
    n_rays: int
    n_vox: int

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self[:6]
                   if t is not None)


def build_tables(lin, lens, n_vox: int, transpose: bool = True
                 ) -> RoutedTables:
    """Build the CSR tables from a traced (lin (R, M), lens (R, M)) pair on
    the tables' device.  Zero-length slots are dropped."""
    R = lin.shape[0]
    live = lens != 0
    counts = live.sum(dim=1)
    nnz = int(counts.sum())
    if nnz >= 2 ** 31 or n_vox >= 2 ** 31 or R >= 2 ** 31:
        raise OverflowError(f"CSR tables index with int32: nnz={nnz}, "
                            f"rays={R}, voxels={n_vox}")
    dev = lin.device
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    col = lin[live].to(torch.int32)
    val = lens[live].to(torch.float32)
    vox_ptr = ray = valT = None
    if transpose:
        order = torch.sort(col, stable=True).indices
        rows = torch.repeat_interleave(
            torch.arange(R, dtype=torch.int32, device=dev), counts,
            output_size=nnz)
        ray, valT = rows[order], val[order]
        vox_ptr = torch.zeros(n_vox + 1, dtype=torch.int32, device=dev)
        vox_ptr[1:] = torch.cumsum(torch.bincount(col, minlength=n_vox), 0)
    return RoutedTables(row_ptr, col, val, vox_ptr, ray, valT, R, n_vox)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _row_ids(ptr, nnz):
    n = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device),
                                   torch.diff(ptr).long(), output_size=nnz)


def routed_fwd_ref(t: RoutedTables, d):
    """y = A·d: gather d·val per crossing, segment-sum by ray."""
    prod = d.index_select(0, t.col.long()) * t.val.to(d.dtype)
    y = torch.zeros(t.n_rays, dtype=d.dtype, device=d.device)
    return y.index_add_(0, _row_ids(t.row_ptr, t.nnz), prod)


def routed_bwd_gather_ref(t: RoutedTables, dy):
    """dD = Aᵀ·dy over the voxel-major transpose."""
    prod = dy.index_select(0, t.ray.long()) * t.valT.to(dy.dtype)
    dD = torch.zeros(t.n_vox, dtype=dy.dtype, device=dy.device)
    return dD.index_add_(0, _row_ids(t.vox_ptr, t.nnz), prod)


def routed_bwd_scatter_ref(t: RoutedTables, dy):
    """dD = Aᵀ·dy by scatter-add over the ray-major CSR."""
    prod = (dy.index_select(0, _row_ids(t.row_ptr, t.nnz))
            * t.val.to(dy.dtype))
    dD = torch.zeros(t.n_vox, dtype=dy.dtype, device=dy.device)
    return dD.index_add_(0, t.col.long(), prod)


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the routed "
                       "CUDA kernels are built from source at first use")


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
    so = os.path.join(BUILD_DIR, f"routed_project_{h.hexdigest()[:16]}.so")
    log = ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
            ("routed_fwd", [p, p, p, p, p, i, p]),
            ("routed_bwd_gather", [p, p, p, p, p, i, p]),
            ("routed_bwd_scatter", [p, p, p, p, p, i, i, p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.routed_error_string.argtypes = [ctypes.c_int]
    lib.routed_error_string.restype = ctypes.c_char_p
    return lib, log


def _launch(name, tensors, ints):
    lib, _ = load_library()
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = getattr(lib, name)(*(t.data_ptr() for t in tensors), *ints, stream)
    if rc != 0:
        msg = lib.routed_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    LAUNCHES[name] += 1


def _check(x, n, what, tables):
    """Validate a kernel input: 1-D float32 of length n on the tables'
    CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} is on {x.device}; the CUDA kernels take "
                         "CUDA tensors (CPU tensors use the plain version)")
    if x.dtype != torch.float32 or x.shape != (n,):
        raise ValueError(f"{what} must be float32 of shape ({n},), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if tables.col.device != x.device:
        raise ValueError(f"tables on {tables.col.device}, {what} on "
                         f"{x.device}")
    return x.contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def routed_fwd(t: RoutedTables, d):
    """y (R,) = A·d for a flat (V,) density; kernel ``routed_fwd``."""
    if d.device.type == "cpu":
        return routed_fwd_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    _launch("routed_fwd", (t.row_ptr, t.col, t.val, d, y), (t.n_rays,))
    return y


def routed_bwd_gather(t: RoutedTables, dy):
    """dD (V,) = Aᵀ·dy, deterministic; kernel ``routed_bwd_gather``."""
    if t.vox_ptr is None:
        raise ValueError("routed_bwd_gather needs the voxel-major "
                         "transpose (build_tables(..., transpose=True))")
    if dy.device.type == "cpu":
        return routed_bwd_gather_ref(t, dy)
    dy = _check(dy, t.n_rays, "dy", t)
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    _launch("routed_bwd_gather", (t.vox_ptr, t.ray, t.valT, dy, dD),
            (t.n_vox,))
    return dD


def routed_bwd_scatter(t: RoutedTables, dy):
    """dD (V,) = Aᵀ·dy by atomics; kernel ``routed_bwd_scatter``."""
    if dy.device.type == "cpu":
        return routed_bwd_scatter_ref(t, dy)
    dy = _check(dy, t.n_rays, "dy", t)
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    _launch("routed_bwd_scatter", (t.row_ptr, t.col, t.val, dy, dD),
            (t.n_rays, t.n_vox))
    return dD


# TraceConfig.routed_dense -> backward wrapper.  The TPU's VMEM envelope
# gates on the dense backward (operator.py:1341-1361 of the JAX package)
# have no counterpart on the card, so 'auto' always takes the gather.
BACKWARDS = {"auto": routed_bwd_gather, "bwd": routed_bwd_gather,
             "off": routed_bwd_scatter}


class _RoutedProject(torch.autograd.Function):
    """y = A·d with the routed kernels: forward ``routed_fwd``, backward
    the wrapper ``bwd`` (one of :data:`BACKWARDS`)."""

    @staticmethod
    def forward(ctx, d, tables, bwd):
        ctx.tables, ctx.bwd = tables, bwd
        return routed_fwd(tables, d)

    @staticmethod
    def backward(ctx, dy):
        return ctx.bwd(ctx.tables, dy), None, None


def routed_project(d, tables: RoutedTables, bwd=routed_bwd_gather):
    """Differentiable y (R,) = A·d for a flat (V,) f32 density."""
    return _RoutedProject.apply(d, tables, bwd)
