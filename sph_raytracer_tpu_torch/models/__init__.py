"""Parametric volume models for tomographic retrieval (port of
``sph_raytracer_tpu.models``): ``Model(grid)`` instances are callables
``coeffs → volume`` with a ``coeffs_shape`` property and an optional
``proj(coeffs)`` hook applied after each optimizer step."""
from .base import (
    AxisAlignmentModel,
    CubesModel,
    FullyDenseModel,
    Model,
)
from .sphharm import SphHarmModel, real_sph_harm_basis

__all__ = ["Model", "FullyDenseModel", "CubesModel", "AxisAlignmentModel",
           "SphHarmModel", "real_sph_harm_basis"]
