"""Tomographic retrieval of a static volume from a 50-view orbit.

Port of ``examples/static_retrieval.py``: the two-shell phantom on a 50³
grid, an orbit of 50 circular ``ConeCircGeom((100, 50))`` detectors
(250,000 rays), ``retrieval.gd`` (Adam, ``SquareLoss + NegRegularizer``,
lr 0.1) for 100 iterations, then ``preview3d`` stacks of the truth and the
result.  On the card the retrieval runs ``routed_fwd`` and
``routed_bwd_gather`` each iteration; the previews render with
``mode='fused'`` (``fused_fwd``, one launch a frame: a one-shot
projection needs no tables).  ``SPH_TPU_EXAMPLE_GRID`` / ``_VIEWS`` /
``_ITERS`` / ``_PREVIEW`` shrink the run, as in the JAX script.  Writes
``static_retrieval1.gif`` and ``static_retrieval2.gif`` (matplotlib and
its pillow writer)::

    python -m sph_raytracer_tpu_torch.examples.static_retrieval [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import ConeCircGeom, Operator, SphericalGrid
from ..loss import NegRegularizer, SquareLoss
from ..models import FullyDenseModel
from ..operator import resolve_device
from ..plotting import image_stack, preview3d
from ..retrieval import gd
from ._common import Clock, knob, parse_args, pyplot


def phantom(n: int) -> np.ndarray:
    """The two-shell phantom on an n³ grid."""
    x = np.zeros((n, n, n), np.float32)
    x[:, n // 2:, :n // 2] = 1
    x[:, :n // 2, n // 2:] = 1
    return x


def orbit(n: int, nview: int):
    """``nview`` circular detectors of (2n, n) pixels on a circle of
    radius 5 at z = 1, aimed at the origin; as in the JAX script the
    angles include 2π, so the first and last views coincide."""
    return sum(
        ConeCircGeom(shape=(2 * n, n),
                     pos=(5 * np.cos(th), 5 * np.sin(th), 1),
                     fov=(0, 45))
        for th in np.linspace(0, 2 * np.pi, nview)
    )


def run(device=None, n=50, nview=50, iters=100, preview=256,
        ftype=torch.float32) -> dict:
    """The retrieval: ``op``, ``geoms``, ``x`` (truth), ``meas``,
    ``coeffs`` (detached), ``reproj``, ``losses`` (each loss's history),
    ``preview_truth`` / ``preview_coeffs`` (numpy frame stacks) and the
    setup / run seconds.  ``ftype`` is the operator's and the
    coefficients' dtype (float64 runs the table path, for parity tests)."""
    dev = resolve_device(device)
    clock = Clock(dev)
    grid = SphericalGrid(shape=(n, n, n))
    x = torch.as_tensor(phantom(n), dtype=ftype, device=dev)
    geoms = orbit(n, nview)
    op = clock.build(Operator, grid, geoms, ftype=ftype, device=dev)
    with torch.no_grad():
        meas = op(x)

    m = FullyDenseModel(grid)
    loss_fns = [1 * SquareLoss(), 1 * NegRegularizer()]
    coeffs, reproj, losses = gd(
        op, meas, m, coeffs=torch.ones(m.coeffs_shape, dtype=ftype,
                                       device=dev),
        lr=1e-1, loss_fns=loss_fns, num_iterations=iters,
        progress_bar=False)
    coeffs = coeffs.detach()

    prev = dict(shape=(preview, preview), mode="fused", device=dev)
    preview_truth = preview3d(x, grid, **prev)
    preview_coeffs = preview3d(coeffs, grid, **prev)
    return dict(op=op, geoms=geoms, x=x, meas=meas, coeffs=coeffs,
                reproj=reproj.detach(), losses=losses,
                preview_truth=preview_truth, preview_coeffs=preview_coeffs,
                **clock.seconds())


def plot(result, outdir=".") -> list:
    """``static_retrieval1.gif`` (truth and result previews) and
    ``static_retrieval2.gif`` (measurements and view geometry)."""
    plt = pyplot()
    plt.close("all")
    fig1 = plt.figure(figsize=(8, 4))
    ax1 = fig1.add_subplot(1, 2, 1)
    ax2 = fig1.add_subplot(1, 2, 2)
    ax1.set_title("Truth")
    ani1 = image_stack(result["preview_truth"], ax=ax1, colorbar=True)
    ax2.set_title("Retrieved")
    ani2 = image_stack(result["preview_coeffs"], ax=ax2, colorbar=True)
    ani2.event_source = ani1.event_source
    path1 = os.path.join(outdir, "static_retrieval1.gif")
    ani1.save(path1, extra_anim=[ani2])

    fig2 = plt.figure(figsize=(8, 4))
    ax3 = fig2.add_subplot(1, 2, 1, polar=True)
    ax4 = fig2.add_subplot(1, 2, 2, projection="3d")
    ax3.set_title("Measurements")
    ani3 = image_stack(result["meas"].cpu().numpy(), result["geoms"],
                       ax=ax3, colorbar=True)
    ax4.set_title("View Geometry")
    ani4 = result["op"].plot(ax=ax4)
    path2 = os.path.join(outdir, "static_retrieval2.gif")
    ani4.save(path2, fps=30, extra_anim=[ani3])
    plt.close("all")
    return [path1, path2]


def main(argv=None):
    args = parse_args(__doc__, argv)
    res = run(device=args.device, n=knob("GRID", 50),
              nview=knob("VIEWS", 50), iters=knob("ITERS", 100),
              preview=knob("PREVIEW", 256))
    hist = np.sum([h for h in res["losses"].values()], axis=0)
    print(f"loss {hist[0]:.6g} -> {hist[-1]:.6g}: setup "
          f"{res['setup_s']:.3f} s, run {res['run_s']:.3f} s")
    print("plotting...")
    plot(res, args.outdir)
    print("saved static_retrieval[12].gif")


if __name__ == "__main__":
    main()
