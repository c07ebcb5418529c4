"""Tomographic measurements of a time-varying (4D) volume.

Port of ``examples/dynamic_measurements.py``: a 20-time-bin grid of 50³
(two static shells and a moving elevation element), one
``ConeCircGeom((100, 50))`` view a time bin (100,000 rays), its forward
projection and a fixed-vantage ``preview3d``; then ``view_times``: 40
views over the same 20 bins (200,000 rays), each seeing the volume
linearly interpolated between its bracketing bins.  On the card both
forwards run ``routed_fwd`` (the ``view_times`` tables doubled, each
crossing in two bins); the preview renders with ``mode='fused'``
(``fused_fwd``, one launch a frame).  ``SPH_TPU_EXAMPLE_GRID`` /
``_TBINS`` / ``_PREVIEW`` shrink the run, as in the JAX script.  Writes
``dynamic.gif`` (matplotlib and its pillow writer)::

    python -m sph_raytracer_tpu_torch.examples.dynamic_measurements [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import Operator, SphericalGrid
from ..operator import resolve_device
from ..plotting import image_stack, preview3d
from ._common import Clock, knob, parse_args, pyplot
from .static_retrieval import orbit


def phantom(t: int, n: int) -> np.ndarray:
    """Two static shells and an elevation element that moves one bin
    each time bin, on a (t, n, n, n) grid."""
    x = np.zeros((t, n, n, n), np.float32)
    x[:, :, n // 2:, :n // 2] = 1
    x[:, :, :n // 2, n // 2:] = 1
    for time in range(t):
        x[time, :, min(time * 2, n - 1), :] += 1
    return x


def run(device=None, n=50, tbins=20, preview=256,
        ftype=torch.float32) -> dict:
    """Both measurement stacks: ``op`` / ``geoms`` / ``meas`` (one view a
    bin), ``op_ct`` / ``geoms_ct`` / ``meas_ct`` / ``times``
    (``view_times``, two views a bin), ``x`` (the 4D volume), ``preview``
    (numpy frames, one a time bin) and the setup / run seconds.
    ``ftype`` is the operators' dtype (float64 runs the table path, for
    parity tests)."""
    dev = resolve_device(device)
    clock = Clock(dev)
    grid = SphericalGrid(shape=(tbins, n, n, n))
    x = torch.as_tensor(phantom(tbins, n), dtype=ftype, device=dev)

    # one orbit vantage per time bin
    geoms = orbit(n, grid.shape.t)
    op = clock.build(Operator, grid, geoms, ftype=ftype, device=dev)
    with torch.no_grad():
        meas = op(x)
    frames = preview3d(x, grid, azim=-45, orbit=False,
                       shape=(preview, preview), mode="fused", device=dev)

    # views at arbitrary times: 2x-oversampled vantages, each seeing the
    # volume interpolated between its bracketing time bins
    v = 2 * grid.shape.t
    geoms_ct = orbit(n, v)
    times = np.linspace(float(grid.t[0]), float(grid.t[-1]), v)
    op_ct = clock.build(Operator, grid, geoms_ct, view_times=times,
                        ftype=ftype, device=dev)
    with torch.no_grad():
        meas_ct = op_ct(x)
    return dict(op=op, geoms=geoms, meas=meas, op_ct=op_ct,
                geoms_ct=geoms_ct, meas_ct=meas_ct, times=times, x=x,
                preview=frames, **clock.seconds())


def plot(result, outdir=".") -> list:
    """``dynamic.gif``: the volume preview, the view geometry and the
    measurements, animated together."""
    plt = pyplot()
    plt.close("all")
    fig = plt.figure(figsize=(12, 4))
    ax1 = fig.add_subplot(1, 3, 1)
    ax2 = fig.add_subplot(1, 3, 2, projection="3d")
    ax3 = fig.add_subplot(1, 3, 3, polar=True)
    ani1 = image_stack(result["preview"], ax=ax1)
    ax1.set_title("Dynamic Volume Preview")
    ax2.set_title("View Geometry")
    ani2 = result["op"].plot(ax=ax2)
    ani3 = image_stack(result["meas"].cpu().numpy(), geom=result["geoms"],
                       ax=ax3)
    ax3.set_title("Measurements")
    ani3.event_source = ani2.event_source = ani1.event_source
    path = os.path.join(outdir, "dynamic.gif")
    ani1.save(path, fps=15, extra_anim=[ani2, ani3])
    plt.close("all")
    return [path]


def main(argv=None):
    args = parse_args(__doc__, argv)
    res = run(device=args.device, n=knob("GRID", 50),
              tbins=knob("TBINS", 20), preview=knob("PREVIEW", 256))
    tb = res["op"].grid.shape.t
    print(f"measurements {tuple(res['meas'].shape)}: setup "
          f"{res['setup_s']:.3f} s, run {res['run_s']:.3f} s")
    print("plotting...")
    for path in plot(res, args.outdir):
        print(f"saved {path}")
    print(f"continuous-time measurements: {tuple(res['meas_ct'].shape)} "
          f"({len(res['times'])} views over {tb} time bins)")


if __name__ == "__main__":
    main()
