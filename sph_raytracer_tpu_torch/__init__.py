"""sph_raytracer_tpu_torch — the PyTorch / CUDA port of sph_raytracer_tpu.

Raytraces 3D and time-varying 4D density volumes on spherical voxel grids
through arbitrary detectors, producing differentiable line integrals, with
a tomographic retrieval stack (models, losses, Adam gradient descent).
Same public names as ``sph_raytracer_tpu``; the routed and fused
projection engines run hand-written CUDA kernels on an NVIDIA H100
(``sm_90a``).  The
package imports torch and numpy only — never jax, nor the JAX package.

Not ported yet (ROADMAP): ``autotune``, ``solve``, ``plotting`` and the
sharded operators.
"""

from .grid import SphericalGrid
from .operator import Operator
from .viewgeom import (
    ConeCircGeom,
    ConeRectGeom,
    ParallelGeom,
    ViewGeom,
    ViewGeomCollection,
)
from .config import TraceConfig

from . import loss, models, retrieval, utils  # noqa: E402,F401

__all__ = [
    "SphericalGrid",
    "Operator",
    "ViewGeom",
    "ViewGeomCollection",
    "ConeRectGeom",
    "ConeCircGeom",
    "ParallelGeom",
    "TraceConfig",
    "loss",
    "models",
    "retrieval",
    "utils",
]

__version__ = "0.1.0"
