"""Visualization utilities.

Port of ``sph_raytracer_tpu/plotting.py``: ``image_stack`` (single image
or animated stack, polar axes auto-selected for circular detectors),
``color_negative`` (negatives → green channel), ``sph2cart`` and
``preview3d`` (orbiting 3D preview rendered with the raytracer itself by
rolling the volume one azimuth bin per frame instead of building N view
geometries — the reference's stated cheat, plotting.py:216-217,264-274).
The frames render in one operator call on its device; matplotlib is
host-side and imported lazily.
"""
from __future__ import annotations

from collections.abc import Iterable
from itertools import repeat

import numpy as np
import torch

from .viewgeom import ConeCircGeom, ConeRectGeom, ViewGeomCollection

__all__ = ["image_stack", "color_negative", "preview3d", "sph2cart"]


def sph2cart(rea):
    """Spherical → cartesian, numpy (reference plotting.py:188-207)."""
    rea = np.asarray(rea, dtype=np.float64)
    r, e, a = np.moveaxis(rea, -1, 0)
    return np.stack(
        [r * np.sin(e) * np.cos(a), r * np.sin(e) * np.sin(a), r * np.cos(e)],
        axis=-1,
    )


def _degree_ticks(*axes):
    from matplotlib.ticker import EngFormatter

    fmt = EngFormatter(unit="\N{DEGREE SIGN}", sep="")
    for a in axes:
        a.set_major_formatter(fmt)


def _draw_polar(ax, img, geom, **kw):
    """One polar frame: pcolormesh over the detector's FOV annulus."""
    inner, outer = (0.0, 1.0) if geom is None else tuple(geom.fov)
    if geom is not None:
        _degree_ticks(ax.yaxis)
    edges_r = np.linspace(inner / 2, outer / 2, img.shape[-2] + 1)
    edges_t = np.linspace(0, 2 * np.pi, img.shape[-1] + 1)
    ax.grid(alpha=0.2)
    return ax.pcolormesh(*np.meshgrid(edges_t, edges_r), img, **kw)


def _draw_rect(ax, img, geom, **kw):
    """One rectangular frame: imshow with FOV extents in degrees."""
    extent = None
    if geom is not None:
        half_u, half_v = geom.fov[0] / 2, geom.fov[1] / 2
        extent = (-half_v, half_v, -half_u, half_u)
        _degree_ticks(ax.xaxis, ax.yaxis)
    return ax.imshow(img, extent=extent, **kw)


def image_stack(images, geom=None, ax=None, colorbar=False, polar=None, **kwargs):
    """Plot a single image or animate a stack of images.

    Args:
        images: (num_images, W, H) for an animation or (W, H) for a single
            image.
        geom: view geometry for FOV axis labels; a ViewGeomCollection
            supplies per-frame geometry.  Circular detectors select polar
            axes (reference plotting.py:102-108).
        ax: existing matplotlib Axes.
        colorbar: include a colorbar.
        polar: override polar-plot auto-detection.
        **kwargs: forwarded to imshow/pcolormesh.

    Returns:
        matplotlib.animation.ArtistAnimation for stacks, Figure for single
        images.
    """
    import matplotlib.pyplot as plt
    from matplotlib import animation

    images = np.asarray(images)
    if images.ndim not in (2, 3):
        raise ValueError("Invalid images shape")
    animated = images.ndim == 3
    frames = images if animated else images[None]

    # one geometry per frame (a collection/iterable supplies its own)
    if isinstance(geom, (ViewGeomCollection, Iterable)):
        per_frame = list(geom)
    else:
        per_frame = list(repeat(geom, len(frames)))

    if polar is None:
        polar = isinstance(
            per_frame[0] if per_frame else geom, ConeCircGeom)
    if ax is None:
        ax = plt.figure(figsize=(3, 3)).add_subplot(polar=polar)
    fig = ax.figure

    # shared color scale across the whole stack unless caller pins it
    if not {"vmin", "vmax"} <= kwargs.keys():
        kwargs["vmin"] = np.nanmin(images)
        kwargs["vmax"] = np.nanmax(images)

    draw = _draw_polar if polar else _draw_rect
    artists = [[draw(ax, img, g, animated=animated, **kwargs)]
               for img, g in zip(frames, per_frame)]

    if colorbar:
        fig.colorbar(artists[0][0], pad=0.1)
    if animated:
        return animation.ArtistAnimation(fig, artists, interval=200)
    return fig


def color_negative(x):
    """Grayscale → RGB with negative values shown in the green channel
    (reference plotting.py:168-183)."""
    x = np.asarray(x)
    pos = np.clip(x, 0, None)
    neg = -np.clip(x, None, 0)
    return np.stack((pos, neg, np.zeros_like(pos)), axis=-1)


def preview3d(volume, grid, shape=(256, 256), orbit=True, elev=60, azim=0,
              operator_cls=None, **op_kwargs):
    """Orbiting 3D preview of a volume, rendered with the raytracer.

    Rather than building one view geometry per frame, a single
    :class:`ConeRectGeom` is traced once and the volume is rolled one
    azimuth bin per frame (reference plotting.py:210-297); all frames then
    render in one forward call on the operator's device, the frames as
    channels: one kernel launch a frame (``fused_fwd`` with
    ``mode='fused'``, ``routed_fwd`` with ``'auto'`` on the card).

    Args:
        volume: (*grid.shape) or (*grid.shape, C) channel-last volume.
        grid: :class:`SphericalGrid` the volume lives on.
        shape: output image shape.
        orbit: orbit around the volume (False = fixed vantage).
        elev / azim: initial camera angles in degrees.
        operator_cls / **op_kwargs: operator class + extra kwargs, e.g.
            ``mode='fused'`` or ``device='cpu'`` (dependency-injected to
            avoid a circular import; defaults to
            :class:`~sph_raytracer_tpu_torch.operator.Operator`, which runs
            on the card unless ``device`` says otherwise).

    Returns:
        (num_frames, *shape[, C]) image stack; num_frames = grid.shape.t
        for dynamic volumes else grid.shape.a.
    """
    if operator_cls is None:
        from .operator import Operator as operator_cls  # noqa: N813

    volume = (_numpy(volume) if isinstance(volume, torch.Tensor)
              else np.asarray(volume))
    if volume.ndim not in (3, 4, 5):
        raise ValueError(f"Invalid shape for volume: {tuple(volume.shape)}")
    if (volume.ndim - len(grid.shape)) > 1:
        raise ValueError("volume/grid shape mismatch")

    gshape = tuple(grid.shape)
    na = gshape[-1]
    offsets = range(gshape[0] if grid.dynamic else na)
    has_channels = volume.ndim == len(gshape) + 1

    # camera on a ring, offset half an azimuth voxel to dodge boundary
    # artifacts (reference plotting.py:268-273)
    pos = sph2cart((
        4 * grid.size.r[1],
        np.deg2rad(elev),
        0.125 * 2 * np.pi / na + np.deg2rad(azim),
    ))
    geom = ConeRectGeom(shape, pos=pos, fov=(30, 30))
    # static 3D operator regardless of grid.dynamic: frames are stacked as
    # channels
    from .grid import SphericalGrid

    sgrid = grid if not grid.dynamic else SphericalGrid(
        r_b=grid.r_b, e_b=grid.e_b, a_b=grid.a_b
    )
    op = operator_cls(sgrid, geom, **op_kwargs)

    frames = []
    for i, offset in enumerate(offsets):
        vol = volume[offset] if grid.dynamic else volume
        az_axis = -2 if has_channels else -1
        frames.append(np.roll(vol, offset if orbit else 0, axis=az_axis))
    rotvol = np.stack(frames)  # (F, nr, ne, na[, C])

    if has_channels:
        rotvol = np.moveaxis(rotvol, -1, 0)  # (C, F, nr, ne, na)
        out = _numpy(op(torch.as_tensor(rotvol)))  # (C, F, *shape)
        return np.moveaxis(out, 0, -1)  # (F, *shape, C)
    return _numpy(op(torch.as_tensor(rotvol)))  # (F, *shape)


def _numpy(t):
    return t.detach().cpu().numpy()
