"""Device-memory estimator for the port's execution modes.

Port of ``examples/memory_usage.py``, with its parameters (a 512×512
sensor, 25 observations, 2 channels, a (1, 32, 16, 32) volume, an
8,192-ray block) and its "reference (torch) peak" line, over the port's
own layouts (M = 2(N_r+1) + 2(N_e+1) + (N_a+1) + 1 crossings a ray at
most, ``ops/trace.py``):

* ``mode='precomputed'``: the padded trace, ``lin`` (int32) and ``lens``
  (float32), M slots a ray, 8 B a slot; the forward's gather transient,
  4 B a slot a channel;
* routed mode (``'auto'`` on the card): the ray-major CSR (``row_ptr``,
  ``col``, ``val``) that ``routed_fwd`` reads and its voxel-major
  transpose (``vox_ptr``, ``ray``, ``valT``) that ``routed_bwd_gather``
  reads (``ops.routed_project.RoutedTables``): 16 B a crossing with
  float32 weights, 12 B with ``routed_w_dtype='bf16'``; the build holds
  the padded trace of every ray first;
* fused mode: no crossing table for the forward (``fused_fwd`` traces in
  the kernel), only the rays (``FusedRays``: start and unit direction,
  24 B a ray, and a 4 B time-bin offset on a 4D grid); a gradient builds
  the transpose alone at the first backward.  The blockwise path
  (``fused_backend='xla'``, float64) holds one block's crossings.

Each crossing count is the bound M; a real geometry's tables hold fewer,
so the estimate bounds them from above::

    python -m sph_raytracer_tpu_torch.examples.memory_usage [--device cpu]
"""
from __future__ import annotations

import torch

from ..operator import resolve_device
from ._common import parse_args


def crossings_per_ray(volume) -> int:
    """M, the most crossings a ray makes through a ``volume`` = (T, N_r,
    N_e, N_a) grid (``ops/trace.py``)."""
    _, nrad, nele, nazi = volume
    return 2 * (nrad + 1) + 2 * (nele + 1) + (nazi + 1) + 1


def estimate(nrays: int, volume, nchan: int = 1, block: int = 8192) -> dict:
    """Bytes of each layout for ``nrays`` rays through a ``volume`` =
    (T, N_r, N_e, N_a) grid, at the bound of M crossings a ray (the
    module docstring)."""
    ntime, nrad, nele, nazi = volume
    nvox = ntime * nrad * nele * nazi
    m = crossings_per_ray(volume)
    slots = nrays * m
    csr = 4 * (nrays + 1) + (4 + 4) * slots        # row_ptr, col, val
    transpose = 4 * (nvox + 1) + (4 + 4) * slots   # vox_ptr, ray, valT
    return {
        "volume": 4 * nvox,
        "precomputed": 8 * slots,
        "gather": 4 * nchan * slots,
        "routed": csr + transpose,
        "routed_bf16": csr + transpose - 2 * 2 * slots,
        "trace": 8 * slots,
        "fused_rays": (24 + (4 if ntime > 1 else 0)) * nrays,
        "fused_bwd": transpose,
        "blockwise": (4 + 4 + 4 + 4) * block * m,
        # the reference's model (its examples/memory_usage.py:23-44)
        "reference": (8 * 3 + 8 + 8 + 8) * nchan * nrays * (m - 1),
    }


def run(device=None, npix=(512, 512), volume=(1, 32, 16, 32), nobs=25,
        nchan=2, block=8192) -> dict:
    """The estimate (:func:`estimate`, bytes) for ``nobs`` views of a
    ``npix`` sensor (channels share the geometry), and the device's memory
    (``device_bytes``, None on the CPU)."""
    dev = resolve_device(device)
    nrays = nobs * npix[0] * npix[1]
    est = estimate(nrays, volume, nchan, block)
    total = (torch.cuda.get_device_properties(dev).total_memory
             if dev.type == "cuda" else None)
    return dict(params=dict(npix=tuple(npix), volume=tuple(volume),
                            nobs=nobs, nchan=nchan, block=block),
                nrays=nrays, bytes=est, device_bytes=total,
                setup_s=0.0, run_s=0.0)


def plot(result, outdir=".") -> list:
    """The JAX script writes no figure; neither does this."""
    return []


def main(argv=None):
    args = parse_args(__doc__, argv)
    res = run(device=args.device)
    p, b = res["params"], res["bytes"]
    gb = {k: v / 1e9 for k, v in b.items()}
    _, nrad, nele, nazi = p["volume"]
    print("\n--- Parameters ---\n")
    print(f"({nrad}, {nele}, {nazi}) volume")
    print(f"{p['nobs']} observations, {p['nchan']} channels, "
          f"{p['npix']} sensor")
    print(f"{res['nrays']:,} rays, at most "
          f"{crossings_per_ray(p['volume'])} crossings a ray")
    print("\n--- Memory Usage ---\n")
    print(f"Volume memory:                 {gb['volume']:.3f} GB")
    print(f"Precomputed tables (resident): {gb['precomputed']:9.2f} GB")
    print(f"  + forward gather transient:  {gb['gather']:9.2f} GB")
    print(f"Routed tables (resident):      {gb['routed']:9.2f} GB  "
          f"(bf16 weights {gb['routed_bf16']:.2f} GB)")
    print(f"  + build transient (trace):   {gb['trace']:9.2f} GB")
    print(f"Fused mode rays (resident):    {gb['fused_rays']:9.4f} GB")
    print(f"  + backward tables (grad):    {gb['fused_bwd']:9.2f} GB")
    print(f"Blockwise fused working set:   {gb['blockwise']:9.4f} GB  "
          f"(block={p['block']})")
    print(f"Reference (torch) peak:        {gb['reference']:9.2f} GB")
    if res["device_bytes"] is not None:
        print(f"Device memory:                 "
              f"{res['device_bytes'] / 1e9:9.2f} GB")
    plot(res, args.outdir)


if __name__ == "__main__":
    main()
