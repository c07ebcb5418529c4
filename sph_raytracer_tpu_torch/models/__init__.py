"""Parametric volume models for tomographic retrieval (port of
``sph_raytracer_tpu.models``): ``Model(grid)`` instances are callables
``coeffs → volume`` with a ``coeffs_shape`` property and an optional
``proj(coeffs)`` hook applied after each optimizer step.
``SphHarmModel`` is not ported yet (ROADMAP A7)."""
from .base import (
    AxisAlignmentModel,
    CubesModel,
    FullyDenseModel,
    Model,
)

__all__ = ["Model", "FullyDenseModel", "CubesModel", "AxisAlignmentModel"]
