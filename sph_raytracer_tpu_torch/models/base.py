"""Model protocol + built-in phantoms (port of
``sph_raytracer_tpu/models/base.py``; reference model.py):

  * ``Model`` — model.py:7-39
  * ``FullyDenseModel`` identity — model.py:42-52
  * ``CubesModel`` two-box phantom — model.py:55-83
  * ``AxisAlignmentModel`` axis markers — model.py:86-114
"""
from __future__ import annotations

import numpy as np
import torch

from ..operator import resolve_device

__all__ = ["Model", "FullyDenseModel", "CubesModel", "AxisAlignmentModel"]


class Model:
    """A parameterized model of a volume: ``volume = model(coeffs)``.

    Subclasses implement ``__call__`` as a differentiable function of
    ``coeffs`` and declare ``coeffs_shape``.  An optional ``proj(coeffs)``
    method is applied to the coefficients after each optimizer step (e.g.
    positivity projection; reference retrieval.py:119-121).
    """

    def __init__(self, grid):
        raise NotImplementedError

    def __call__(self, coeffs):
        """Generate volume density from parameters."""
        raise NotImplementedError

    @property
    def coeffs_shape(self):
        """Shape of the coefficient tensor."""
        raise NotImplementedError

    def __repr__(self):
        return f"{self.__class__.__name__}({tuple(self.grid.shape)})"


class FullyDenseModel(Model):
    """Coefficients are the voxel densities themselves
    (reference model.py:42-52)."""

    def __init__(self, grid):
        self.grid = grid

    def __call__(self, coeffs):
        return coeffs

    @property
    def coeffs_shape(self):
        return tuple(self.grid.shape)


class _PhantomModel(Model):
    """Fixed test volume; ``coeffs_shape == ()`` and coeffs are ignored
    except for their device and dtype.  ``model(None)`` (the JAX package
    ignores the coefficients) gives the float32 volume on the model's
    ``device`` (``None`` at construction means ``"cuda"``)."""

    def __init__(self, grid, device=None):
        self.grid = grid
        self.device = resolve_device(device)

    def __call__(self, coeffs):
        if coeffs is None:
            return torch.as_tensor(self.volume, dtype=torch.float32,
                                   device=self.device)
        coeffs = torch.as_tensor(coeffs)
        return torch.as_tensor(self.volume, dtype=coeffs.dtype,
                               device=coeffs.device)

    @property
    def coeffs_shape(self):
        return ()


class CubesModel(_PhantomModel):
    """Two boxes in spherical coordinates (reference model.py:55-83)."""

    def __init__(self, grid, device=None):
        super().__init__(grid, device)
        nr, ne, na = tuple(grid.shape)[-3:]
        vol = np.zeros(tuple(grid.shape))
        r0, r1 = int(nr * 0.333), int(nr * 0.666)
        e00, e01 = int(ne * 0.2), int(ne * 0.3)
        e10, e11 = int(ne * 0.7), int(ne * 0.9)
        a0, a1 = int(na * 0.4), int(na * 0.6)
        vol[..., r0:r1, e00:e01, a0:a1] = 1
        vol[..., r0:r1, e10:e11, a0:a1] = 1
        self.volume = vol
        self.r0, self.r1 = r0, r1
        self.e00, self.e01, self.e10, self.e11 = e00, e01, e10, e11
        self.a0, self.a1 = a0, a1


class AxisAlignmentModel(_PhantomModel):
    """Axis-marker phantom for orientation / mirroring checks
    (reference model.py:86-114): bars along +X (short), +Y (medium) and the
    +Z polar cap."""

    def __init__(self, grid, device=None):
        super().__init__(grid, device)
        nr, ne, na = tuple(grid.shape)[-3:]
        vol = np.zeros(tuple(grid.shape))
        vol[..., : nr // 3, ne // 2, 0] = 1          # X axis
        vol[..., : nr // 2, ne // 2, (na * 3) // 4] = 1  # Y axis
        vol[..., :, 0, :] = 1                        # Z axis
        self.volume = vol
