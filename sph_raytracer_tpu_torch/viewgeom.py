"""Detector / viewing geometry specifications.

The port's own copy of ``sph_raytracer_tpu/viewgeom.py`` (numpy only; the
port imports nothing of the JAX package).  Ray semantics follow the
reference library's view geometries (geometry.py:259-681) — default
``lookdir=-pos`` aimed at the origin (geometry.py:475-478), default ``updir=cross(lookdir, z)``
(geometry.py:479-482), tan-spaced rectangular FOV grid with matplotlib
pixel convention (geometry.py:493-508), degenerate 1-pixel axes collapsing
to the central LOS (geometry.py:500-501), polar detectors with theta
offset +π/2 (geometry.py:568), parallel beams sharing one direction
(geometry.py:647-655) — with specs in host-side numpy float64 and rays
as lazily computed functions of the spec, converted to tensors only
inside an operator.

Divergences from the reference (deliberate, documented):
  * ``ViewGeomCollection.__add__`` no longer mutates both operands
    (reference bug at geometry.py:368-374); ``a + b`` returns a new
    collection.  ``sum(geoms)`` still works.
  * ``ConeCircGeom(spacing='log')`` uses a true geometric spacing of
    tan-radii (the reference passes tan values straight to ``logspace``,
    geometry.py:561-566 — a latent bug acknowledged in SURVEY §C5).
"""
from __future__ import annotations

import math
from collections import namedtuple

import numpy as np

__all__ = [
    "ViewGeom",
    "ViewGeomCollection",
    "ConeRectGeom",
    "ConeCircGeom",
    "ParallelGeom",
    "Segment",
]

Segment = namedtuple("Segment", ["color", "thickness", "start", "end"])

_Z = np.array((0.0, 0.0, 1.0))


def _unit(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# wireframe toolkit: a tiny value type + segment builders + one shared 3D
# renderer used by every .plot() in the package (geoms, collections, and
# Operator.plot).  The reference instead hand-builds [segments, widths,
# colors] triples and a FuncAnimation closure in each class
# (geometry.py:310-456); here each geometry only *describes* its outline.
# ---------------------------------------------------------------------------

class Wireframe(namedtuple("Wireframe", ["segments", "widths", "colors"])):
    """One drawable frame of 3D line segments.

    ``segments`` is (S, 2, 3) float64; ``widths`` (S,); ``colors`` a
    length-S tuple of matplotlib colors.
    """

    __slots__ = ()

    @classmethod
    def lines(cls, segments, width: float = 1.0, color="black"):
        segments = np.asarray(segments, dtype=np.float64).reshape(-1, 2, 3)
        n = len(segments)
        return cls(segments, np.full(n, float(width)), (color,) * n)

    @classmethod
    def empty(cls):
        return cls(np.zeros((0, 2, 3)), np.zeros((0,)), ())

    def __add__(self, other):
        return Wireframe(
            np.concatenate([self.segments, other.segments]),
            np.concatenate([self.widths, other.widths]),
            self.colors + other.colors,
        )


def _pairs(a, b):
    """Segments joining two broadcast-compatible (…, 3) point sets."""
    a, b = np.broadcast_arrays(np.asarray(a, np.float64),
                               np.asarray(b, np.float64))
    return np.stack((a.reshape(-1, 3), b.reshape(-1, 3)), axis=1)


def _ring(pts):
    """Closed polyline through the (N, 3) points ``pts``."""
    return _pairs(pts, np.roll(pts, -1, axis=0))


def render_wireframes(frames, bound, ax=None, path=None,
                      cycle_ms: int = 3000):
    """Draw wireframe ``frames`` on 3D axes.

    Args:
        frames: sequence of :class:`Wireframe` (one per animation frame).
        bound: half-extent of the cubic plot volume.
        ax: existing 3D axes (default: a new 3x3" figure).
        path: optional (N, 3) polyline drawn in gray (e.g. an orbit).
        cycle_ms: total animation cycle length in milliseconds.

    Returns:
        the axes for a single frame, else a FuncAnimation cycling frames.
    """
    import matplotlib.pyplot as plt
    from matplotlib import animation
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    if ax is None:
        fig = plt.figure(figsize=(3, 3))
        ax = fig.add_subplot(projection="3d", computed_zorder=False)

    if path is not None and len(path) > 1:
        ax.add_collection(
            Line3DCollection(_pairs(path[:-1], path[1:]),
                             linewidths=1.0, colors="gray"))

    art = Line3DCollection([])
    ax.add_collection(art)

    def show(i):
        wf = frames[i]
        art.set_segments(wf.segments)
        art.set_linewidth(wf.widths)
        art.set_colors(list(wf.colors))
        return (art,)

    show(0)
    for label, limset in (("X", ax.set_xlim3d), ("Y", ax.set_ylim3d),
                          ("Z", ax.set_zlim3d)):
        getattr(ax, f"set_{label.lower()}label")(label)
        limset((-bound, bound))

    if len(frames) <= 1:
        return ax
    return animation.FuncAnimation(
        ax.figure, show, len(frames), interval=cycle_ms / len(frames),
        blit=False)


def _default_updir(lookdir):
    """Default detector up-direction ``cross(lookdir, ẑ)`` (reference
    geometry.py:479-482), with a fallback to ``x̂`` when lookdir is parallel
    to ẑ — the reference produces NaN rays for views straight down an axis
    pole (a latent bug we fix rather than replicate)."""
    up = np.cross(lookdir, _Z)
    if np.linalg.norm(up) < 1e-12 * np.linalg.norm(lookdir):
        up = np.array((1.0, 0.0, 0.0))
    return up


class ViewGeom:
    """Custom sensor with arbitrary ray placement.

    Args:
        ray_starts: XYZ pixel locations, shape (..., 3) (broadcastable
            against ``rays``).
        rays: XYZ pixel lines-of-sight, shape (..., 3); normalized on
            construction (reference geometry.py:284-288).

    The detector shape is ``rays.shape[:-1]`` and dictates the image shape
    returned by the operator.
    """

    def __init__(self, ray_starts, rays):
        self.ray_starts = np.asarray(ray_starts, dtype=np.float64)
        rays = np.asarray(rays, dtype=np.float64)
        self.rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        self.shape = self.rays.shape[:-1]

    # -- merging (reference geometry.py:290-300) ---------------------------

    def __add__(self, other):
        if other is None or (np.isscalar(other) and other == 0):
            return ViewGeomCollection(self)
        if isinstance(other, ViewGeomCollection):
            return ViewGeomCollection(*([self] + list(other.geoms)))
        return ViewGeomCollection(self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __repr__(self):
        return f"{self.__class__.__name__}(\n    shape={tuple(self.shape)}\n)"

    @property
    def _reach(self) -> float:
        """How far to extend drawn rays: twice the detector distance."""
        return 2.0 * float(np.linalg.norm(
            np.asarray(self.ray_starts, np.float64), axis=-1).max())

    def wireframe_frames(self):
        """Drawable outline of this detector, one :class:`Wireframe` per
        animation frame.  The generic detector draws every ray, extended
        to twice its own start distance."""
        starts = np.broadcast_to(self.ray_starts, (*self.shape, 3))
        reach = 2.0 * np.linalg.norm(starts, axis=-1, keepdims=True)
        return [Wireframe.lines(_pairs(starts, starts + self.rays * reach))]

    @property
    def _wireframe(self):
        """Legacy [segments, widths, colors] frame list (consumed by
        Operator.plot and older callers)."""
        return [[wf.segments, wf.widths, list(wf.colors)]
                for wf in self.wireframe_frames()]

    def plot(self, ax=None):
        """Matplotlib wireframe plot (reference geometry.py:325-351)."""
        return render_wireframes(
            self.wireframe_frames(),
            bound=np.abs(self.ray_starts).max(), ax=ax)


class ViewGeomCollection(ViewGeom):
    """Ordered set of same-shape ViewGeoms — a multi-vantage observation
    stack (reference geometry.py:354-456).  Stacks rays/ray_starts/pos
    along a new leading axis; ``shape == (n_geoms, *geom.shape)``."""

    def __init__(self, *geoms):
        if not all(g.shape == geoms[0].shape for g in geoms):
            raise ValueError("ViewGeoms must all have same shape")
        if len(geoms) == 1 and isinstance(geoms[0], ViewGeomCollection):
            self.geoms = list(geoms[0].geoms)
        else:
            self.geoms = list(geoms)

    def __add__(self, other):
        if other is None or (np.isscalar(other) and other == 0):
            return ViewGeomCollection(*self.geoms)
        if isinstance(other, ViewGeomCollection):
            return ViewGeomCollection(*(self.geoms + other.geoms))
        return ViewGeomCollection(*(self.geoms + [other]))

    def __radd__(self, other):
        return self.__add__(other)

    def __getitem__(self, ind):
        return self.geoms[ind]

    def __len__(self):
        return len(self.geoms)

    @property
    def shape(self):
        return (len(self.geoms), *self.geoms[0].shape)

    @property
    def rays(self):
        return np.stack([np.broadcast_to(g.rays, (*g.shape, 3)) for g in self.geoms])

    @property
    def ray_starts(self):
        # per-geom ray_starts may be broadcast shapes like (1, 1, 3);
        # keep them minimal and stack, broadcasting happens at trace time
        starts = [g.ray_starts for g in self.geoms]
        common = np.broadcast_shapes(*[s.shape for s in starts])
        return np.stack([np.broadcast_to(s, common) for s in starts])

    @property
    def pos(self):
        if all(hasattr(g, "pos") for g in self.geoms):
            return np.stack([g.pos for g in self.geoms])
        return None

    def wireframe_frames(self):
        """One frame per member vantage."""
        return [wf for g in self.geoms for wf in g.wireframe_frames()]

    def plot(self, ax=None):
        """Animated wireframe of all vantages (reference geometry.py:409-456)."""
        return render_wireframes(
            self.wireframe_frames(),
            bound=np.abs(self.ray_starts).max(), ax=ax, path=self.pos)


class ConeRectGeom(ViewGeom):
    """Rectangular cone-beam (pinhole) detector.

    Args:
        shape: (npix_x, npix_y).
        pos: XYZ detector position.
        lookdir: pointing direction (default: aimed at origin, ``-pos``).
        updir: detector +Y direction (default ``cross(lookdir, z)``).
        fov: field of view in degrees (fov_x, fov_y).

    Follows the matplotlib image convention where pixel (0, 0) is the top
    left of the view (reference geometry.py:469-470).
    """

    def __init__(self, shape, pos, lookdir=None, updir=None, fov=(45, 45)):
        pos = np.asarray(pos, dtype=np.float64)
        lookdir = -pos if lookdir is None else np.asarray(lookdir, dtype=np.float64)
        if updir is None:
            updir = _default_updir(lookdir)
        else:
            updir = np.asarray(updir, dtype=np.float64)
        self.shape = tuple(shape)
        self.pos = pos
        self.lookdir = _unit(lookdir)
        self.updir = _unit(updir)
        self.fov = np.asarray(fov, dtype=np.float64)

    @property
    def rays(self):
        """Ray unit vectors, shape (*shape, 3) (reference geometry.py:493-508)."""
        u = np.cross(self.lookdir, self.updir)
        v = self.updir
        ulim = math.tan(math.radians(self.fov[0] / 2)) if self.shape[0] > 1 else 0.0
        vlim = math.tan(math.radians(self.fov[1] / 2)) if self.shape[1] > 1 else 0.0
        rays = (
            self.lookdir[None, None, :]
            + u[None, None, :] * np.linspace(-ulim, ulim, self.shape[0])[:, None, None]
            + v[None, None, :] * np.linspace(-vlim, vlim, self.shape[1])[None, :, None]
        )
        return rays / np.linalg.norm(rays, axis=-1, keepdims=True)

    @property
    def ray_starts(self):
        """Single shared start position, shape (1, 1, 3)."""
        return self.pos[None, None, :]

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(\n"
            f"    shape={self.shape}\n"
            f"    pos={self.pos.tolist()},\n"
            f"    lookdir={self.lookdir.tolist()},\n"
            f"    fov={self.fov.tolist()}\n)"
        )

    def wireframe_frames(self):
        """FOV pyramid: spokes from the pinhole to the four projected
        detector corners, closed by the far rectangle."""
        far = self.pos + self._reach * self.rays[(0, 0, -1, -1), (0, -1, -1, 0)]
        return [Wireframe.lines(np.concatenate(
            (_pairs(self.pos, far), _ring(far))))]


class ConeCircGeom(ConeRectGeom):
    """Circular (polar) cone-beam detector.

    Args:
        shape: (npix_r, npix_theta).
        pos / lookdir / updir: as :class:`ConeRectGeom`.
        fov: (inner_fov, outer_fov) annulus in degrees.
        spacing: radial pixel spacing, 'lin' or 'log'.
    """

    def __init__(self, *args, fov=(0, 45), spacing="lin", **kwargs):
        super().__init__(*args, fov=fov, **kwargs)
        rlim = [
            math.tan(math.radians(self.fov[0] / 2)),
            math.tan(math.radians(self.fov[1] / 2)),
        ]
        if spacing == "lin":
            self.r = np.linspace(rlim[0], rlim[1], self.shape[0])
        elif spacing == "log":
            if rlim[0] <= 0:
                raise ValueError("log spacing requires inner fov > 0")
            self.r = np.geomspace(rlim[0], rlim[1], self.shape[0])
        else:
            raise ValueError(f"Invalid spacing {spacing}")
        self.theta = np.linspace(0, 2 * np.pi, self.shape[1]) + np.pi / 2

    @property
    def rays(self):
        """Ray unit vectors, shape (*shape, 3) (reference geometry.py:570-582)."""
        u = np.cross(self.lookdir, self.updir)
        v = self.updir
        rays = (
            self.lookdir[None, None, :]
            + self.r[:, None, None] * np.cos(self.theta[None, :, None]) * u[None, None, :]
            + self.r[:, None, None] * np.sin(self.theta[None, :, None]) * v[None, None, :]
        )
        return rays / np.linalg.norm(rays, axis=-1, keepdims=True)

    def wireframe_frames(self):
        """FOV annulus cone: inner and outer far rings plus four spokes
        from the pinhole to the outer ring."""
        inner, outer = (self.pos + self._reach * self.rays[i]
                        for i in (0, -1))
        spoke_every = math.ceil(len(outer) / 4)
        return [Wireframe.lines(np.concatenate((
            _pairs(self.pos, outer[::spoke_every]),
            _ring(inner), _ring(outer))))]


class ParallelGeom(ViewGeom):
    """Rectangular parallel-beam detector: all pixels share one ray
    direction, pixel positions form the grid (reference geometry.py:607-681).

    Args:
        shape: (npix_x, npix_y).
        pos: XYZ position of detector center.
        lookdir / updir: as :class:`ConeRectGeom`.
        size: detector extent in distance units (width, height).
    """

    def __init__(self, shape, pos, lookdir=None, updir=None, size=(1, 1)):
        pos = np.asarray(pos, dtype=np.float64)
        lookdir = -pos if lookdir is None else np.asarray(lookdir, dtype=np.float64)
        if updir is None:
            updir = _default_updir(lookdir)
        else:
            updir = np.asarray(updir, dtype=np.float64)
        lookdir = _unit(lookdir)
        updir = _unit(updir)

        u = np.cross(lookdir, updir)
        v = updir
        # u-axis spans +ulim → -ulim (reference geometry.py:638)
        ulim = size[0] / 2 if shape[0] > 1 else 0.0
        vlim = size[1] / 2 if shape[1] > 1 else 0.0
        self._u_arr = u[None, None, :] * np.linspace(ulim, -ulim, shape[0])[:, None, None]
        self._v_arr = v[None, None, :] * np.linspace(-vlim, vlim, shape[1])[None, :, None]

        self.shape = tuple(shape)
        self.pos = pos
        self.lookdir = lookdir
        self.updir = updir
        self.size = tuple(size)

    @property
    def rays(self):
        """Shared ray direction, shape (1, 1, 3)."""
        return self.lookdir[None, None, :]

    @property
    def ray_starts(self):
        """Per-pixel start positions, shape (*shape, 3)."""
        return (self.pos[None, None, :] + self._u_arr + self._v_arr).reshape(
            (*self.shape, 3)
        )

    def __repr__(self):
        return (
            f"ParallelGeom(\n"
            f"    shape={self.shape}\n"
            f"    pos={self.pos.tolist()},\n"
            f"    lookdir={self.lookdir.tolist()},\n)"
        )

    def wireframe_frames(self):
        """Beam box: the four corner rays as parallel rails joining the
        near and far detector rectangles."""
        near = self.ray_starts[(0, 0, -1, -1), (0, -1, -1, 0)]
        far = near + self._reach * self.lookdir
        return [Wireframe.lines(np.concatenate(
            (_pairs(near, far), _ring(near), _ring(far))))]
