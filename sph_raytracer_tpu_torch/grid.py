"""Spherical voxel grid specification.

The port's own copy of ``sph_raytracer_tpu/grid.py`` (numpy only; the port
imports nothing of the JAX package).  Semantics follow the reference
library's ``SphericalGrid`` (geometry.py:27-251): the same voxel-index
conventions (geometry.py:77-104 ASCII art), lin/log radial spacing
(geometry.py:154-168), shape/size inference from manual boundaries
(geometry.py:133-151) and 4D "dynamic" time axis.  The spec lives on the
host in numpy float64 (grids are tiny) and becomes tensors of the
configured dtype only when an operator is built.
"""
from __future__ import annotations

import math
from collections import namedtuple
from typing import Tuple

import numpy as np

__all__ = [
    "SphericalGrid",
    "StaticShape",
    "DynamicShape",
    "StaticSize",
    "DynamicSize",
]

StaticSize = namedtuple("Size", ["r", "e", "a"])
StaticShape = namedtuple("Shape", ["r", "e", "a"])
DynamicSize = namedtuple("Size", ["t", "r", "e", "a"])
DynamicShape = namedtuple("Shape", ["t", "r", "e", "a"])


class SphericalGrid:
    r"""Spherical grid information.

    Specifies the physical geometry of the volume being raytraced: radial
    shell boundaries ``r_b``, elevation cone boundaries ``e_b`` in radians
    [0, π] measured from +Z, azimuth half-plane boundaries ``a_b`` in
    radians [-π, π] measured from +X, and optionally time samples ``t``
    for 4D (dynamic) volumes.

    Either give ``shape`` (+ ``size_*`` extents, with 'lin' or 'log' radial
    ``spacing``) or manually specify boundary arrays ``r_b/e_b/a_b`` (and
    ``t``), in which case shape and size are inferred.

    Args:
        shape: (N_r, N_e, N_a) or (N_t, N_r, N_e, N_a).
        size_t: temporal extent (t_min, t_max), units per ``timeunit``.
        size_r: radial extent (r_min, r_max), distance units.
        size_e: elevation extent in radians.
        size_a: azimuth extent in radians.
        spacing: radial bin spacing, 'lin' or 'log'.
        t, r_b, e_b, a_b: manual sample/boundary arrays.
        timeunit: numpy datetime64 unit for ``nptime``.

    Attributes mirror the reference: ``shape``, ``size``, ``dynamic``,
    boundary arrays ``r_b/e_b/a_b``, bin centers ``r/e/a`` (geometric mean
    for log spacing), ``t``, ``coords``, ``mesh``, ``nptime``.
    """

    def __init__(
        self,
        shape=(50, 50, 50),
        size_t=(0, 1),
        size_r=(0, 1),
        size_e=(0, np.pi),
        size_a=(-np.pi, np.pi),
        spacing: str = "lin",
        t=None,
        r_b=None,
        e_b=None,
        a_b=None,
        timeunit: str = "s",
        rs_b=None,
        phis_b=None,
        thetas_b=None,
    ):
        # reference-compat deprecated aliases (reference geometry.py:113-130)
        if (rs_b is not None) and (phis_b is not None) and (thetas_b is not None):
            import warnings

            warnings.warn("rs_b/phis_b/thetas_b are deprecated; use "
                          "r_b/e_b/a_b", DeprecationWarning)
            r_b, e_b, a_b = rs_b, phis_b, thetas_b
        self.dynamic = False

        if shape is not None:
            if len(shape) == 3:
                size = StaticSize(size_r, size_e, size_a)
                shape = StaticShape(*(int(s) for s in shape[-3:]))
            elif len(shape) == 4:
                size = DynamicSize(size_t, size_r, size_e, size_a)
                shape = DynamicShape(*(int(s) for s in shape))
                self.dynamic = True
            else:
                raise ValueError("shape must be 3D or 4D")

        # manual boundary specification: infer shape and size
        if (r_b is not None) and (e_b is not None) and (a_b is not None):
            r_b, e_b, a_b = (np.asarray(x, dtype=np.float64) for x in (r_b, e_b, a_b))
            size_r = float(r_b.min()), float(r_b.max())
            size_e = float(e_b.min()), float(e_b.max())
            size_a = float(a_b.min()), float(a_b.max())

            if t is None:
                shape = StaticShape(len(r_b) - 1, len(e_b) - 1, len(a_b) - 1)
                size = StaticSize(size_r, size_e, size_a)
                self.dynamic = False
            else:
                t = np.asarray(t, dtype=np.float64)
                size_t = float(t.min()), float(t.max())
                shape = DynamicShape(len(t), len(r_b) - 1, len(e_b) - 1, len(a_b) - 1)
                size = DynamicSize(size_t, size_r, size_e, size_a)
                self.dynamic = True

            r, e, a = ((x[1:] + x[:-1]) / 2 for x in (r_b, e_b, a_b))

        elif shape is not None:
            if len(shape) == 4:
                t = np.linspace(size.t[0], size.t[1], shape.t, dtype=np.float64)
            if spacing == "log":
                r_b = np.logspace(
                    math.log10(size.r[0]), math.log10(size.r[1]), shape.r + 1,
                    dtype=np.float64,
                )
                r = np.sqrt(r_b[1:] * r_b[:-1])
            elif spacing == "lin":
                r_b = np.linspace(size.r[0], size.r[1], shape.r + 1, dtype=np.float64)
                r = (r_b[1:] + r_b[:-1]) / 2
            else:
                raise ValueError("Invalid value for spacing")
            e_b = np.linspace(size.e[0], size.e[1], shape.e + 1, dtype=np.float64)
            a_b = np.linspace(size.a[0], size.a[1], shape.a + 1, dtype=np.float64)
            e = (e_b[1:] + e_b[:-1]) / 2
            a = (a_b[1:] + a_b[:-1]) / 2

        else:
            raise ValueError("Must specify either shape or (r_b, e_b, a_b)")

        self.size = size
        self.shape = shape
        self.spacing = spacing
        self.r_b, self.e_b, self.a_b = r_b, e_b, a_b
        # deprecated attribute aliases (reference geometry.py:182)
        self.rs_b, self.phis_b, self.thetas_b = r_b, e_b, a_b
        self.t, self.r, self.e, self.a = t, r, e, a
        self.timeunit = timeunit

    # ---- trace-relevant static facts -------------------------------------

    @property
    def vshape(self) -> Tuple[int, int, int]:
        """Spatial voxel shape (N_r, N_e, N_a) regardless of dynamic."""
        return tuple(self.shape[-3:])

    @property
    def full_azimuth(self) -> bool:
        """Whether azimuth spans the full circle, enabling periodic wrap of
        azimuth region indices (reference raytracer.py:528-532)."""
        return bool(-self.a_b[0] == self.a_b[-1] == np.pi)

    @property
    def num_crossings(self) -> int:
        """Max crossings per ray M = 2(N_r+1) + 2(N_e+1) + (N_a+1) + 1
        (incl. the ray-start pseudo-crossing; reference raytracer.py:72,
        117-122 and examples/memory_usage.py:23-24)."""
        nr, ne, na = self.vshape
        return 2 * (nr + 1) + 2 * (ne + 1) + (na + 1) + 1

    # ---- reference-parity conveniences ------------------------------------

    def __repr__(self):
        string = f"{self.__class__.__name__}(\n"
        string += f"    shape={tuple(self.shape)},\n"
        for k, v in self.size._asdict().items():
            string += f"    size_{k}=({v[0]:.2f}, {v[1]:.2f}),\n"
        string += ")"
        return string

    def __eq__(self, other):
        if not isinstance(other, SphericalGrid):
            return NotImplemented
        if self.shape != other.shape or self.dynamic != other.dynamic:
            return False
        same = (
            np.array_equal(self.r_b, other.r_b)
            and np.array_equal(self.e_b, other.e_b)
            and np.array_equal(self.a_b, other.a_b)
        )
        if self.dynamic:
            same = same and np.array_equal(self.t, other.t)
        return same

    def __hash__(self):
        return hash((tuple(self.shape), self.dynamic,
                     self.r_b.tobytes(), self.e_b.tobytes(), self.a_b.tobytes()))

    @property
    def coords(self):
        if self.dynamic:
            return {"t": self.t, "r": self.r, "e": self.e, "a": self.a}
        return {"r": self.r, "e": self.e, "a": self.a}

    @property
    def mesh(self):
        """Dense mesh of grid coordinates, shape (*grid.shape, ndim)."""
        return np.stack(
            np.meshgrid(*self.coords.values(), indexing="ij"), axis=-1
        )

    @property
    def nptime(self):
        """Times as numpy datetime64 (reference geometry.py:244-247)."""
        return self.t.astype(f"datetime64[{self.timeunit}]")

    def plot(self, ax=None):
        """Matplotlib wireframe sphere at the outer radius
        (reference geometry.py:197-226)."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.axes(projection="3d")
            ax.set_proj_type("persp")

        u = np.linspace(0, 2 * np.pi, 20)
        v = np.linspace(0, np.pi, 20)
        rmax = self.size.r[1]
        x = np.outer(np.cos(u), np.sin(v)) * rmax
        y = np.outer(np.sin(u), np.sin(v)) * rmax
        z = np.outer(np.ones_like(u), np.cos(v)) * rmax

        artist = ax.plot_surface(x, y, z, zorder=99)
        ax.set_aspect("equal")
        ax.set_xlabel("X")
        ax.set_ylabel("Y")
        ax.set_zlabel("Z")
        return artist
