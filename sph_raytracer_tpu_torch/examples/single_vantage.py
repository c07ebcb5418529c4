"""Forward raytracing from a single vantage point.

Port of ``examples/single_vantage.py``: a nested-shell volume on a 50³
grid seen by one 256×256 ``ConeRectGeom`` at ``pos=(5, 0, 0)`` (65,536
rays).  On the card ``mode='auto'`` builds the routed tables and the
forward is one ``routed_fwd`` launch.  Writes ``single_vantage.png``::

    python -m sph_raytracer_tpu_torch.examples.single_vantage [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import ConeRectGeom, Operator, SphericalGrid
from ..operator import resolve_device
from ._common import Clock, parse_args, pyplot


def run(device=None, grid_shape=(50, 50, 50), det=(256, 256)) -> dict:
    """The shells' image: ``op`` (the operator), ``x`` (the volume),
    ``image`` (``op(x)``) and the setup / run seconds."""
    dev = resolve_device(device)
    clock = Clock(dev)
    # a rectilinear detector with a 45° field of view aimed at the origin
    grid = SphericalGrid(shape=grid_shape)
    geom = ConeRectGeom(shape=det, pos=(5, 0, 0), fov=(45, 45))
    op = clock.build(Operator, grid, geom, device=dev)

    # static test volume with two nested shells
    x = np.zeros(tuple(grid.shape), np.float32)
    x[-1, :, :] += 1
    x[-10, :, :] += 1
    x = torch.as_tensor(x, device=dev)
    with torch.no_grad():
        image = op(x)
    return dict(op=op, x=x, image=image, **clock.seconds())


def plot(result, outdir=".") -> list:
    """``single_vantage.png``: the image beside the view geometry."""
    plt = pyplot()
    plt.close("all")
    fig = plt.figure()
    ax1 = fig.add_subplot(1, 2, 1)
    ax2 = fig.add_subplot(1, 2, 2, projection="3d")
    ax1.set_title("Nested Shells")
    ax1.imshow(result["image"].cpu().numpy())
    ax2.set_title("View Geometry")
    result["op"].plot(ax=ax2)
    path = os.path.join(outdir, "single_vantage.png")
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return [path]


def main(argv=None):
    args = parse_args(__doc__, argv)
    res = run(device=args.device)
    print(f"image {tuple(res['image'].shape)}: setup {res['setup_s']:.3f} s,"
          f" run {res['run_s']:.3f} s")
    for path in plot(res, args.outdir):
        print(f"saved {path}")


if __name__ == "__main__":
    main()
