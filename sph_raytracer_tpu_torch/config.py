"""Configuration for the PyTorch / CUDA port of the spherical raytracer.

``TraceConfig`` keeps every field name of ``sph_raytracer_tpu.config``
(config.py:20-183) so code written against one package runs on the other;
dtypes are torch dtypes.  Every value the JAX package accepts runs here.
Fields fall in two groups:

* **Used:** ``ftype``, ``itype``, ``mode``, ``precompute_block_rays``,
  ``block_rays`` (the blockwise fused path), ``trace_method``,
  ``routed_dense``, ``routed_banded``, ``routed_fwd_reduce``,
  ``routed_w_dtype``, ``routed_voxel_order``, ``fused_backend``,
  ``fused_bwd``.  ``ftype`` and ``itype`` take what the JAX package takes
  (a numpy dtype or scalar type, a dtype name, a JAX dtype) as well as a
  torch dtype, and are stored as torch dtypes (:func:`as_torch_dtype`).
  In routed mode
  ``routed_dense``, ``routed_banded`` and ``routed_fwd_reduce`` pick a
  (forward, backward) pair of kernels (``ops.routed_project.resolve``):

  ====================================== ===================== ===================
  config                                 forward               backward / ``.T``
  ====================================== ===================== ===================
  ``routed_dense`` 'auto' / 'bwd'        ``routed_fwd``        ``routed_bwd_gather``
  ``routed_dense`` 'off'                 ``routed_fwd``        ``routed_bwd_scatter``
  ``routed_dense`` 'fwd'                 ``routed_fwd_dense``  ``routed_bwd_scatter``
  ``routed_dense`` 'both'                ``routed_fwd_dense``  ``routed_bwd_gather``
  ``routed_fwd_reduce='hist'``           ``routed_fwd_hist``   by ``routed_dense``
  ``routed_banded=False``                ``routed_fwd_window`` ``routed_bwd_window``
  ====================================== ===================== ===================

  'hist' with ``routed_dense`` 'fwd'/'both' gives way to the dense
  forward with a ``UserWarning``, as in the JAX package.  Fused mode reads
  only ``routed_dense``, for its backward ('auto'/'bwd'/'both' gather,
  'off'/'fwd' scatter).
* **Accepted no-ops** — TPU table-layout or relay knobs with no
  counterpart on the GPU tables (CSR, its voxel-major transpose, the
  window chunk table, whose tile and window sizes are the port's own
  constants chosen for the card): ``routed_g``, ``routed_sr``,
  ``routed_kd``, ``routed_bands``, ``routed_band_rows`` (beyond the
  'hist' check below), ``routed_chunk_multiple``, ``routed_build`` (the
  tables are built on the operator's device), ``pdevice`` (the trace runs
  on the operator's device), ``sharded_local_build`` (each rank of
  :class:`..parallel.ShardedOperator` always traces and builds its own
  rays alone, bitwise the rows a build of every ray would give it); and
  ``interpret``: on the CPU every kernel
  wrapper runs its plain PyTorch version, as the JAX package's interpret
  mode runs its Pallas kernels on the CPU.  The TPU's VMEM-envelope clamps
  and the dense-slot rep-skew gate of ``routed_dense`` have no counterpart
  on the card either: a forced value always runs its kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["TraceConfig", "default_config", "check_supported",
           "as_torch_dtype"]


def as_torch_dtype(x) -> torch.dtype:
    """The torch dtype of ``x``: a ``torch.dtype``, a ``"torch.<name>"``
    string, or anything ``np.dtype()`` takes (a numpy dtype or scalar type,
    a dtype name, ``float``, a JAX dtype such as ``jnp.float64``, which
    carries a numpy dtype), read as numpy reads it (``"float"`` is float64,
    as in the JAX package); a name numpy refuses is looked up in torch
    (``"bfloat16"``).  Anything else raises ``TypeError``."""
    if isinstance(x, torch.dtype):
        return x
    name = None
    if isinstance(x, str) and x.startswith("torch."):
        name = x.removeprefix("torch.")
    elif x is not None:
        try:
            name = np.dtype(x).name
        except TypeError:
            name = x if isinstance(x, str) else None
    dt = getattr(torch, name, None) if name else None
    if isinstance(dt, torch.dtype):
        return dt
    raise TypeError(f"{x!r} is not a dtype the port knows")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static configuration for tracing / projection.

    Attributes:
        ftype: float dtype of the geometry math and tables.  float32 is the
            card's working type and the only one the CUDA kernels take;
            float64 is the parity-testing dtype (precomputed mode).
        itype: integer dtype of voxel indices.
        mode: 'precomputed' caches (linear-index, length) tables and runs
            gather / scatter-add in PyTorch; 'routed' builds GPU CSR tables
            on the device and runs the hand-written CUDA projection kernels
            (ops/routed_project.py); 'fused' keeps no crossing tables: the
            trace runs inside the ``fused_fwd`` kernel at every forward
            (ops/fused_project.py); 'auto' picks 'routed' on a CUDA device
            and 'precomputed' on the CPU.
        precompute_block_rays: rays per block of the crossing trace (bounds
            the peak memory of its dense (block, M) temporaries).
        trace_method: 'auto', 'sorted' or 'ranked', all three the sorted
            trace (``ops.trace.trace_crossings``).  The JAX package's
            'ranked' trace trades the sort, slow on a TPU, for all-pairs
            comparisons (O(block·M²) temporaries) and yields the same
            (voxel, length) pairs; the sort is fast on the card, so the
            port keeps one trace.
        routed_dense: dense-slot choice of the routed engine (module
            docstring's table): the gather backward (``routed_bwd_gather``,
            deterministic) for 'auto'/'bwd'/'both', the atomic scatter
            (``routed_bwd_scatter``) for 'off'/'fwd'; the voxel-major
            forward (``routed_fwd_dense``) for 'fwd'/'both'.  'both' keeps
            only the voxel-major transpose.
        routed_banded: False runs the window-routed pair
            (``routed_fwd_window`` / ``routed_bwd_window``) on one chunk
            table of (ray tile, voxel window) chunks.
        routed_fwd_reduce: 'hist' runs the ray-tile reduce forward
            (``routed_fwd_hist``); needs ``routed_band_rows=8``, as in the
            JAX package.
        routed_voxel_order: the voxel linearization of routed mode's
            tables: 'a' the canonical azimuth-innermost C-order, 'r'
            radius-innermost (``ops.trace.voxel_order_lin``), which changes
            which voxels sit next to each other in the density the
            forward gathers, in the gradient and in the rows of the
            transpose.  The density argument, the outputs and the
            gradient stay canonical (one ``movedim`` in, one out); fused
            and precomputed modes keep 'a', as in the JAX package.
        routed_w_dtype: 'f32', or 'bf16': the banded engine's weight
            tables (``val`` / ``valT``: routed mode with
            ``routed_banded=True``, and fused mode's routed backward,
            whose tables are banded whatever ``routed_banded`` is) hold
            each float32 length rounded to nearest even in bfloat16, and
            its kernels read them through their ``<name>_bf16``
            instantiations (f32 accumulation).  2 B a crossing less per
            table; the image moves by the rounding (≤ 2⁻⁸ relative a
            length), and both directions read the same rounded lengths, so
            the pair stays exactly adjoint.  Where no banded table is
            built (``mode='precomputed'``, routed mode with
            ``routed_banded=False``, fused mode whose backward re-traces)
            it warns and keeps f32, as the JAX package does.  (The JAX
            package also warns in fused mode with ``routed_banded=False``,
            yet quantizes that backward's banded tables all the same, as
            the port does without the warning.)  The JAX package also
            keeps f32 when its
            superchunk heights are not multiples of 16 rows (TPU bf16
            tiling), as in tiny configs; the port has no superchunks and
            quantizes on every banded build, so on such configs the two
            packages differ by that rounding.
        block_rays: rays per block of the blockwise fused path.
        fused_backend: fused-mode engine: 'pallas' (the JAX name, kept)
            is the in-kernel-trace engine (``fused_fwd``; ValueError for a
            grid outside ``fused_project.supported``); 'xla' is the
            blockwise re-trace path (``ops.project.project_fused``);
            'auto' takes the engine when the grid is supported, else the
            blockwise path.
        fused_bwd: fused-mode backward with the engine: 'retrace'
            re-traces blockwise and scatter-adds (no tables); 'routed'
            builds backward-only routed tables at construction and runs
            ``routed_dense``'s backward kernel on them; 'auto' is 'routed'
            built lazily, at the first forward that needs a gradient or
            the first ``.T`` (a forward-only operator never builds them),
            and 'retrace' outside the engine.
    """

    ftype: torch.dtype = torch.float32
    itype: torch.dtype = torch.int32
    mode: str = "auto"
    block_rays: int = 2048
    precompute_block_rays: int = 8192
    interpret: bool = False
    pdevice: Optional[str] = "auto"
    trace_method: str = "auto"
    routed_g: int = 4096
    routed_sr: int = 64
    routed_kd: int = 3
    routed_banded: bool = True
    routed_bands: int = 32
    routed_band_rows: int = 8
    routed_chunk_multiple: object = "auto"
    fused_backend: str = "auto"
    fused_bwd: str = "auto"
    routed_build: str = "auto"
    routed_dense: str = "auto"
    routed_w_dtype: str = "f32"
    routed_fwd_reduce: str = "masks"
    routed_voxel_order: str = "a"
    sharded_local_build: Optional[bool] = None

    def __post_init__(self):
        for field in ("ftype", "itype"):
            object.__setattr__(self, field,
                               as_torch_dtype(getattr(self, field)))

    def replace(self, **kw) -> "TraceConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> TraceConfig:
    return TraceConfig()


_VALID = {
    "mode": ("auto", "precomputed", "routed", "fused"),
    "trace_method": ("auto", "sorted", "ranked"),
    "routed_dense": ("auto", "off", "fwd", "bwd", "both"),
    "routed_fwd_reduce": ("masks", "hist"),
    "routed_w_dtype": ("f32", "bf16"),
    "routed_voxel_order": ("a", "r"),
    "fused_backend": ("auto", "pallas", "xla"),
    "fused_bwd": ("auto", "retrace", "routed"),
}


def check_supported(config: TraceConfig) -> None:
    """Raise ``ValueError`` for an unknown value or combination."""
    for field, allowed in _VALID.items():
        if getattr(config, field) not in allowed:
            raise ValueError(f"{field}={getattr(config, field)!r} "
                             f"(want one of {allowed})")
    # the JAX package's check (operator.py:281-285), kept so a config
    # valid on one package is valid on the other
    if config.routed_fwd_reduce == "hist" and config.routed_band_rows != 8:
        raise ValueError("routed_fwd_reduce='hist' needs routed_band_rows=8 "
                         "(the placement gathers address within 8-row bands)")
