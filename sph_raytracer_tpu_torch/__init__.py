"""sph_raytracer_tpu_torch — the PyTorch / CUDA port of sph_raytracer_tpu.

Raytraces 3D and time-varying 4D density volumes on spherical voxel grids
through arbitrary detectors, producing differentiable line integrals, with
a tomographic retrieval stack (models, losses, Adam gradient descent, and
the CGNR / MLEM solvers of ``solve``), the routed-engine autotuner
(``autotune``) and matplotlib visualization (``plotting``).
Same public names as ``sph_raytracer_tpu``; the routed and fused
projection engines run hand-written CUDA kernels on an NVIDIA H100
(``sm_90a``).  The
package imports torch and numpy only (matplotlib lazily) — never jax, nor
the JAX package.  The ray- and volume-sharded operators are in
:mod:`.parallel` (``torch.distributed``), imported on demand as in the JAX
package.
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
from .tune import autotune

from . import loss, models, plotting, retrieval, solve, utils  # noqa: E402,F401

__all__ = [
    "SphericalGrid",
    "Operator",
    "ViewGeom",
    "ViewGeomCollection",
    "ConeRectGeom",
    "ConeCircGeom",
    "ParallelGeom",
    "TraceConfig",
    "autotune",
    "loss",
    "models",
    "plotting",
    "retrieval",
    "solve",
    "utils",
]

__version__ = "0.1.0"
