"""Bandlimited (spherical-harmonic) retrieval.

Port of ``examples/sph_harm_retrieval.py``: the volume is parameterized
as lmax-bandlimited angular structure with free radial profiles
(``SphHarmModel``), so the unknowns shrink from Nr·Ne·Na to
(lmax+1)²·Nr.  A 24³ grid (``size_r=(1, 8)``), lmax 3, 12 views of 24×24
at radius 16; ``retrieval.gd`` (``SquareLoss``, lr 0.05) for 200
iterations on a truth the model represents exactly.  On the card each
iteration runs ``routed_fwd`` and ``routed_bwd_gather``.  Writes
``sph_harm_retrieval.png``::

    python -m sph_raytracer_tpu_torch.examples.sph_harm_retrieval [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import ConeRectGeom, Operator, SphericalGrid
from ..loss import SquareLoss
from ..models import SphHarmModel
from ..operator import resolve_device
from ..retrieval import gd
from ._common import Clock, parse_args, pyplot


def run(device=None, n=24, lmax=3, nview=12, det=24, iters=200) -> dict:
    """The retrieval: ``op``, ``truth`` / ``vol`` (volumes),
    ``truth_coeffs`` / ``coeffs``, ``losses``, ``rel`` (the relative
    volume error) and the setup / run seconds."""
    dev = resolve_device(device)
    clock = Clock(dev)
    grid = SphericalGrid(shape=(n, n, n), size_r=(1, 8))
    model = SphHarmModel(grid, lmax=lmax, device=dev)

    # ground truth: a bandlimited volume the model can represent exactly
    rng = np.random.default_rng(0)
    truth_coeffs = torch.as_tensor(
        0.2 * rng.standard_normal(model.coeffs_shape) + 1.0,
        dtype=torch.float32, device=dev)
    truth = model(truth_coeffs)

    geoms = sum(
        ConeRectGeom((det, det), pos=(16 * np.cos(t), 16 * np.sin(t), 3),
                     fov=(35, 35))
        for t in np.linspace(0, 2 * np.pi, nview, endpoint=False)
    )
    op = clock.build(Operator, grid, geoms, device=dev)
    with torch.no_grad():
        meas = op(truth)

    coeffs, _, losses = gd(op, meas, model, lr=5e-2,
                           loss_fns=[SquareLoss()], num_iterations=iters,
                           progress_bar=False)
    coeffs = coeffs.detach()
    vol = model(coeffs)
    rel = float(torch.linalg.norm(vol - truth) / torch.linalg.norm(truth))
    return dict(op=op, truth=truth, vol=vol, truth_coeffs=truth_coeffs,
                coeffs=coeffs, losses=losses, rel=rel, **clock.seconds())


def plot(result, outdir=".") -> list:
    """``sph_harm_retrieval.png``: an r slice of truth and result, and the
    loss history."""
    plt = pyplot()
    fig, axs = plt.subplots(1, 3, figsize=(12, 4))
    truth = result["truth"].cpu().numpy()
    mid = truth.shape[-3] // 2
    axs[0].imshow(truth[mid])
    axs[0].set_title("truth (r slice)")
    axs[1].imshow(result["vol"].cpu().numpy()[mid])
    axs[1].set_title("retrieved")
    axs[2].semilogy(next(iter(result["losses"].values())))
    axs[2].set_title("SquareLoss")
    path = os.path.join(outdir, "sph_harm_retrieval.png")
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return [path]


def main(argv=None):
    args = parse_args(__doc__, argv)
    res = run(device=args.device)
    print(f"relative volume error: {res['rel']:.4f}")
    print(f"setup {res['setup_s']:.3f} s, run {res['run_s']:.3f} s")
    for path in plot(res, args.outdir):
        print(f"saved {path}")


if __name__ == "__main__":
    main()
