"""Multi-GPU scaled retrieval step (BASELINE.json config #5's widths).

Port of ``examples/multichip_scaling.py``: a 100³ volume and 20
``ConeRectGeom((100, 200))`` views (400,000 rays), the rays sharded over
the ranks of a process group (``parallel.ShardedOperator``,
``mode='fused'``), then one gradient step of ``mean((op(d) - y)²)``
(forward, backward, the volume gradient summed over the ranks) timed over
3 calls.  The JAX script's ``jax.jit(value_and_grad)`` is an eager
forward and backward here, timed with the device synchronised.  On the
card each step runs ``fused_fwd`` and ``routed_bwd_gather`` (on the
backward tables built at the first gradient).  ``SPH_TPU_EXAMPLE_GRID`` /
``_VIEWS`` shrink the run, as in the JAX script.

``make_mesh`` needs a default process group.  Run alone, ``main()`` makes
one rank over a ``file://`` store in a temporary directory; under
``torchrun`` it joins torchrun's group (``env://``), one process a GPU::

    python -m sph_raytracer_tpu_torch.examples.multichip_scaling [--device cpu]
    torchrun --nproc-per-node=4 -m sph_raytracer_tpu_torch.examples.multichip_scaling
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ConeRectGeom, SphericalGrid
from ..parallel import ShardedOperator, make_mesh
from ._common import (Clock, knob, parse_args, process_group, step_fn,
                      timed_steps)


def orbit(n: int, nview: int, det):
    """``nview`` rectangular detectors of ``det`` pixels on a circle of
    radius 3 at z = 0.4, aimed at the origin."""
    return sum(
        ConeRectGeom(det, pos=(3 * np.cos(t), 3 * np.sin(t), 0.4),
                     fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, nview, endpoint=False)
    )


def sharded_run(cls, n, nview, det, iters, mesh, device, **kw) -> dict:
    """The step of a sharded operator ``cls(grid, views, mesh=mesh, **kw)``
    on an n³ grid seen by :func:`orbit`'s ``nview`` views of ``det``
    pixels: ``op``, ``mesh``, ``x``, ``y`` (``op(x)``), ``loss`` / ``grad``
    (the step at ``x``), ``step_s`` (seconds a step over ``iters``),
    ``nrays``, ``rays_per_s`` and the setup / run seconds.  ``mesh``
    defaults to :func:`..parallel.make_mesh` on ``device`` (the default
    process group must exist)."""
    mesh = make_mesh(device=device) if mesh is None else mesh
    dev = mesh.device
    clock = Clock(dev)
    grid = SphericalGrid(shape=(n, n, n))
    views = orbit(n, nview, det)
    op = clock.build(cls, grid, views, mesh=mesh, **kw)
    x = torch.as_tensor(np.random.default_rng(0).random(tuple(grid.shape)),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        y = op(x)

    # one full gradient step: forward + backward, the gradient summed
    loss, g, dt = timed_steps(step_fn(op, y), x, iters, dev)
    nrays = int(np.prod(views.shape))
    return dict(op=op, mesh=mesh, x=x, y=y, loss=loss, grad=g, step_s=dt,
                nrays=nrays, rays_per_s=nrays / dt, **clock.seconds())


def run(device=None, n=100, nview=20, iters=3, mesh=None) -> dict:
    """The ray-sharded step at ``mode='fused'`` (:func:`sharded_run`)."""
    return sharded_run(ShardedOperator, n, nview, (n, 2 * n), iters, mesh,
                       device, mode="fused")


def plot(result, outdir=".") -> list:
    """The JAX script writes no figure; neither does this."""
    return []


def main(argv=None):
    args = parse_args(__doc__, argv)
    with process_group(args.device):
        mesh = make_mesh(device=args.device)
        print(f"mesh: {mesh.size} devices over axis 'rays'")
        res = run(n=knob("GRID", 100), nview=knob("VIEWS", 20), mesh=mesh)
        dt = res["step_s"]
        print(f"fwd+bwd {dt * 1e3:.1f} ms/iter, {res['rays_per_s']:,.0f} "
              f"rays/s on {mesh.size} devices (setup {res['setup_s']:.3f} s)")
    plot(res, args.outdir)


if __name__ == "__main__":
    main()
