"""Ahead-of-time export for serving.

Port of ``examples/aot_serving.py``.  A serving process should not
re-trace geometry or rebuild tables at start: export the operator's
tables and program once (``utils.export_operator``), then serve from the
archive (``utils.load_exported``), with no ``Operator``, trace or table
build on the serving path.  A 24³ grid and a 32×32 detector; the
``"forward"`` and ``"grad_step"`` programs are exported, restored and held
to the live operator.  On the card the served programs launch the same
``routed_fwd`` / ``routed_bwd_gather`` kernels the operator does::

    python -m sph_raytracer_tpu_torch.examples.aot_serving [--device cpu]
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .. import ConeRectGeom, Operator, SphericalGrid
from ..operator import resolve_device
from ..utils import export_operator, load_exported
from ._common import Clock, parse_args


def run(device=None, n=24, det=32, export_dir=None) -> dict:
    """Export, restore and serve: ``op``, ``density``, ``image`` (served),
    ``live`` (``op(density)``), ``grad`` (served ``grad_step``), the
    restored programs ``serve_fwd`` / ``serve_grad``, ``paths`` /
    ``sizes`` of the archives and the setup / run seconds.
    The archives go to ``export_dir``, or to a temporary directory
    removed on return.  Raises AssertionError when the served image is
    not the live one within 1e-6."""
    dev = resolve_device(device)
    clock = Clock(dev)
    grid = SphericalGrid(shape=(n, n, n))
    geom = ConeRectGeom(shape=(det, det), pos=(4, 0, 0), fov=(40, 40))

    # ---- offline: build once, export the programs ----------------------
    op = clock.build(Operator, grid, geom, device=dev)
    with tempfile.TemporaryDirectory(prefix="sph_serving_") as tmp:
        outdir = export_dir or tmp
        paths = {w: os.path.join(outdir, f"{w}.zip")
                 for w in ("forward", "grad_step")}
        export_operator(op, paths["forward"], what="forward")
        with torch.no_grad():
            y_example = op(torch.ones(tuple(grid.shape), device=dev))
        export_operator(op, paths["grad_step"], what="grad_step",
                        loss_y=y_example)
        sizes = {w: os.path.getsize(p) for w, p in paths.items()}

        # ---- serving: restore callables, no Operator construction -------
        serve_fwd = load_exported(paths["forward"], device=dev)
        serve_grad = load_exported(paths["grad_step"], device=dev)

    density = torch.as_tensor(
        np.random.default_rng(0).random(tuple(grid.shape)),
        dtype=torch.float32, device=dev)
    image = serve_fwd(density)
    grad = serve_grad(density, image)
    with torch.no_grad():
        live = op(density)
    # the restored programs match the live operator
    if not torch.allclose(image, live, rtol=0, atol=1e-6):
        raise AssertionError("the served image is not the live operator's")
    return dict(op=op, density=density, image=image, live=live, grad=grad,
                serve_fwd=serve_fwd, serve_grad=serve_grad, paths=paths,
                sizes=sizes, **clock.seconds())


def plot(result, outdir=".") -> list:
    """The JAX script writes no figure; neither does this."""
    return []


def main(argv=None):
    args = parse_args(__doc__, argv)
    outdir = tempfile.mkdtemp(prefix="sph_serving_")
    res = run(device=args.device, export_dir=outdir)
    p, s = res["paths"], res["sizes"]
    print(f"exported: {p['forward']} ({s['forward'] / 1e6:.1f} MB), "
          f"{p['grad_step']}")
    print(f"setup {res['setup_s']:.3f} s, run {res['run_s']:.3f} s")
    plot(res, args.outdir)
    print(f"served image {tuple(res['image'].shape)}, grad "
          f"{tuple(res['grad'].shape)}: OK")


if __name__ == "__main__":
    main()
