"""On-card sweep of the two redesigned backwards' size parameters at a real
configuration: ``routed_bwd_scatter`` (B3) over its ray tile and hash-table
slots, ``routed_bwd_window`` (B7b) over its work-item size ``K``::

    python -m sph_raytracer_tpu_torch.tools.bwd_sweep [config]  # flagship

It builds the config's trace once (:data:`wfwd_probe.CONFIGS`), the
ray-major CSR and the window chunk table from it, and one seeded dy.  For
each setting it checks the kernel against its plain version (rtol 1e-4:
atomics sum in a run-to-run order) and prints its time (CUDA events, the
mean of :data:`wfwd_probe.N_TIMED` launches), for B3 the global atomics
issued and the crossings that overflowed the table (the kernel's own
counts) beside the distinct (tile, voxel) pairs, for B7b the item count
and the largest item's crossings.  The module's defaults
(``SCATTER_TILE``, ``SCATTER_SLOTS``, ``WIN_K``) are among the settings.
Runs on the card only.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..grid import SphericalGrid
from ..operator import Operator
from ..ops import routed_project as rp
from ..ops._cuda import launch
from .wfwd_probe import CONFIGS, SEED, _orbit, cuda_ms

__all__ = ["SCATTER_SETTINGS", "WINDOW_K", "sweep", "main"]

# (tile rays, table slots) of routed_bwd_scatter; K of routed_bwd_window
SCATTER_SETTINGS = ((64, 2048), (64, 4096), (128, 4096), (128, 8192),
                    (256, 8192), (256, 16384))
WINDOW_K = (2048, 4096, 8192, 16384, 65536)


def _scatter(t, dy, tile, slots, counts):
    """``routed_bwd_scatter`` at another tile and table size than the
    wrapper's."""
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    launch("routed_bwd_scatter", (t.row_ptr, t.col, t.val, dy, dD, counts),
           (t.n_rays, t.n_vox, tile, slots))
    return dD


def _close(got, want):
    """Outputs outside rtol 1e-4 / atol 1e-5 of the largest."""
    tol = 1e-5 * float(want.abs().max()) + 1e-4 * want.abs()
    return int(((got - want).abs() > tol).sum())


def _item_sizes(t):
    n = torch.diff(t.cptr).long()[t.bwd_order.long()]
    cs = torch.cat([n.new_zeros(1), torch.cumsum(n, 0)])
    ip = t.item_ptr.long()
    return cs[ip[1:]] - cs[ip[:-1]]


def sweep(config="flagship"):
    """One record a setting (dicts, see the module docstring)."""
    dev = torch.device("cuda")
    vshape, n_views, det = CONFIGS[config]
    op = Operator(SphericalGrid(shape=vshape), _orbit(n_views, det),
                  mode="precomputed", device=dev)
    V = op._flat_size
    csr = rp.build_tables(op.lin, op.lens, V, transpose=False)
    dy = torch.randn(csr.n_rays,
                     generator=torch.Generator().manual_seed(SEED)).to(dev)
    records = []
    want = rp.routed_bwd_scatter_ref(csr, dy)
    for tile, slots in SCATTER_SETTINGS:
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        got = _scatter(csr, dy, tile, slots, counts)
        issued, over = counts.tolist()
        records.append({
            "kernel": "routed_bwd_scatter", "tile": tile, "slots": slots,
            "ms": cuda_ms(lambda: _scatter(csr, dy, tile, slots, None)),
            "atomics": issued, "overflowed": over,
            "pairs": rp.scatter_atomics(csr, tile), "nnz": csr.nnz,
            "outside_tol": _close(got, want)})
    for K in WINDOW_K:
        t = rp.build_window_tables(op.lin, op.lens, V, K=K)
        want = rp.routed_bwd_window_ref(t, dy)
        got = rp.routed_bwd_window(t, dy)
        records.append({
            "kernel": "routed_bwd_window", "K": K,
            "ms": cuda_ms(lambda: rp.routed_bwd_window(t, dy)),
            "items": t.n_items, "largest_item": int(_item_sizes(t).max()),
            "nnz": t.nnz, "outside_tol": _close(got, want)})
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="flagship",
                    choices=sorted(CONFIGS))
    args = ap.parse_args(argv)
    print(f"[sweep] {args.config} on {torch.cuda.get_device_name()}",
          flush=True)
    for r in sweep(args.config):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
