"""Configuration for the PyTorch / CUDA port of the spherical raytracer.

``TraceConfig`` keeps every field name of ``sph_raytracer_tpu.config``
(config.py:20-183) so code written against one package runs on the other;
dtypes are torch dtypes.  Fields fall in three groups:

* **Used:** ``ftype``, ``itype``, ``mode``, ``precompute_block_rays``,
  ``trace_method`` ('auto'/'sorted'), ``routed_dense`` ('auto'/'bwd'/'off'),
  ``routed_banded`` (True), ``routed_fwd_reduce`` ('masks'),
  ``routed_w_dtype`` ('f32').
* **Accepted no-ops** — TPU table-layout or relay knobs with no
  counterpart on the GPU tables (ray-major CSR + its voxel-major
  transpose): ``interpret``, ``routed_g``, ``routed_sr``, ``routed_kd``,
  ``routed_bands``, ``routed_band_rows``, ``routed_chunk_multiple``,
  ``routed_voxel_order``, ``routed_build``, ``pdevice`` (the trace runs on
  the operator's device), ``block_rays``, ``fused_backend``,
  ``fused_bwd``, ``sharded_local_build``.
* **Not ported yet** — values whose kernel is not in this slice raise
  ``NotImplementedError`` naming the ROADMAP item (see
  :func:`check_supported`); they never silently run another kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["TraceConfig", "default_config", "check_supported"]


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
            (ops/routed_project.py); 'auto' picks 'routed' on a CUDA device
            and 'precomputed' on the CPU.  'fused' is not ported yet.
        precompute_block_rays: rays per block of the crossing trace (bounds
            the peak memory of its dense (block, M) temporaries).
        trace_method: 'sorted' (or 'auto', which means 'sorted' here).
        routed_dense: backward kernel of the routed engine: 'auto'/'bwd'
            pick the deterministic voxel-major gather (``routed_bwd_gather``);
            'off' picks the ray-major atomic scatter (``routed_bwd_scatter``).
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

    def replace(self, **kw) -> "TraceConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> TraceConfig:
    return TraceConfig()


# (field, value) -> the ROADMAP item that ports its kernel
_NOT_PORTED = {
    ("mode", "fused"): "ROADMAP A6 / B4 (fused mode)",
    ("routed_dense", "fwd"): "ROADMAP B5 (dense-slot forward)",
    ("routed_dense", "both"): "ROADMAP B5 (dense-slot forward)",
    ("routed_fwd_reduce", "hist"): "ROADMAP B6 (histogram-reduce forward)",
    ("routed_banded", False): "ROADMAP B7 (pre-band window-routed engine)",
    ("routed_w_dtype", "bf16"): "ROADMAP B1-B3 follow-up (bf16 weight tables)",
    ("trace_method", "ranked"): "ROADMAP A2 (trace_crossings_ranked)",
}

_VALID = {
    "mode": ("auto", "precomputed", "routed", "fused"),
    "trace_method": ("auto", "sorted", "ranked"),
    "routed_dense": ("auto", "off", "fwd", "bwd", "both"),
    "routed_fwd_reduce": ("masks", "hist"),
    "routed_w_dtype": ("f32", "bf16"),
    "routed_voxel_order": ("a", "r"),
}


def check_supported(config: TraceConfig) -> None:
    """Raise ``ValueError`` for an unknown value and ``NotImplementedError``
    for a value whose kernel this port does not have yet."""
    for field, allowed in _VALID.items():
        if getattr(config, field) not in allowed:
            raise ValueError(f"{field}={getattr(config, field)!r} "
                             f"(want one of {allowed})")
    for (field, value), item in _NOT_PORTED.items():
        if getattr(config, field) == value:
            raise NotImplementedError(
                f"TraceConfig({field}={value!r}) is not ported to the "
                f"PyTorch/CUDA package yet: {item}")
