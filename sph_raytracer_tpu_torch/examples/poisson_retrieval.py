"""Photon-counting retrieval: Poisson noise, ML-EM / OS-EM solver.

Port of ``examples/poisson_retrieval.py``: a smooth positive phantom on a
16³ grid (``size_r=(0.5, 4)``), 12 views of 24×24, photon counts drawn at
500 counts per unit column density, then ``solve.mlem`` (30 sweeps of
OS-EM at 3 subsets) against the Gaussian-model ``solve.cg`` (30
iterations, ``damp=1e-3``, ``sart_preconditioner``) on the same counts.
On the card each sweep or iteration runs ``routed_fwd`` and
``routed_bwd_gather``.  The counts are drawn with numpy from
``default_rng(0)`` as in the JAX script; the rates differ from the JAX
package's in their last bits, so the draws need not match it count for
count.  Writes ``poisson_retrieval.png``::

    python -m sph_raytracer_tpu_torch.examples.poisson_retrieval [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import ConeRectGeom, Operator, SphericalGrid
from ..operator import resolve_device
from ..solve import cg, mlem, sart_preconditioner
from ._common import Clock, parse_args, pyplot


def run(device=None, n=16, nview=12, det=24, iters=30, subsets=3,
        scale=500.0) -> dict:
    """Both retrievals: ``op``, ``truth``, ``counts``, ``x_em`` / ``x_cg``,
    ``info_em`` / ``info_cg``, ``em`` / ``cgr`` (the relative volume
    errors over the voxels the views see) and the setup / run seconds."""
    dev = resolve_device(device)
    clock = Clock(dev)
    # smooth positive phantom, 12-view orbit
    grid = SphericalGrid(shape=(n, n, n), size_r=(0.5, 4.0))
    r = np.asarray(grid.r)[:, None, None]
    e = np.asarray(grid.e)[None, :, None]
    truth = torch.as_tensor(
        ((1.0 + 0.5 * np.sin(2 * e)) * np.exp(-(r - 1.5) ** 2) + 0.05)
        * np.ones(tuple(grid.shape)), dtype=torch.float32, device=dev)
    geom = sum(
        ConeRectGeom((det, det),
                     pos=(8 * np.cos(t), 8 * np.sin(t), 2 * np.sin(2 * t)),
                     fov=(35, 35))
        for t in np.linspace(0, 2 * np.pi, nview, endpoint=False)
    )
    op = clock.build(Operator, grid, geom, device=dev)

    # photon counts; scale = expected counts per unit column density
    with torch.no_grad():
        rate = scale * op(truth).double().cpu().numpy()
    counts = np.random.default_rng(0).poisson(rate).astype(np.float32)
    y = torch.as_tensor(counts, device=dev)

    # ML-EM (the physically matched solver), then CGNR on the same counts
    x_em, _, info_em = mlem(op, y, num_iterations=iters, scale=scale,
                            subsets=subsets)
    x_cg, _, info_cg = cg(op, y / scale, num_iterations=iters, damp=1e-3,
                          precond=sart_preconditioner(op))

    s = info_em["sensitivity"]
    seen = s > 0.05 * s.max()

    def err(x):
        return float((x - truth).abs()[seen].mean() / truth[seen].mean())

    return dict(op=op, truth=truth, counts=counts, x_em=x_em, x_cg=x_cg,
                info_em=info_em, info_cg=info_cg, em=err(x_em),
                cgr=err(x_cg), **clock.seconds())


def plot(result, outdir=".") -> list:
    """``poisson_retrieval.png``: a mid-elevation slice of the truth and
    both retrievals."""
    plt = pyplot()
    truth = result["truth"].cpu().numpy()
    fig, axs = plt.subplots(1, 3, figsize=(10, 3.2))
    mid = truth.shape[1] // 2
    for ax, (title, vol) in zip(
            axs, [("Truth", truth), ("ML-EM", result["x_em"]),
                  ("CGNR", result["x_cg"])]):
        vol = np.asarray(vol.cpu()) if torch.is_tensor(vol) else vol
        im = ax.imshow(vol[:, mid, :], vmin=0, vmax=truth.max())
        ax.set_title(title)
        ax.set_xlabel("azimuth bin")
    axs[0].set_ylabel("radial bin")
    fig.colorbar(im, ax=axs, shrink=0.85)
    path = os.path.join(outdir, "poisson_retrieval.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return [path]


def main(argv=None):
    args = parse_args(__doc__, argv)
    res = run(device=args.device)
    print(f"mean counts/pixel: {res['counts'].mean():.1f}")
    print(f"ML-EM relative volume error: {res['em']:.3f}")
    print(f"CGNR relative volume error: {res['cgr']:.3f}")
    print(f"setup {res['setup_s']:.3f} s, run {res['run_s']:.3f} s")
    plot(res, args.outdir)
    print("OK")


if __name__ == "__main__":
    main()
