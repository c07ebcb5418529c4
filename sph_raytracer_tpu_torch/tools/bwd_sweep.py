"""On-card sweep of the redesigned backwards' parameters at a real
configuration: ``routed_bwd_scatter`` (B3) over its ray tile and hash-table
slots, ``routed_bwd_window`` (B7b) over its work-item size ``K``,
``routed_bwd_gather`` (B2) over its lanes a voxel and quads a lane a step,
on float32 and bfloat16 weights::

    python -m sph_raytracer_tpu_torch.tools.bwd_sweep [config ...] \
        [--kernels B3 B7b B2]                      # flagship, all three

It builds the config's trace once (:data:`wfwd_probe.CONFIGS`), the
ray-major CSR, its transpose and the window chunk table from it, and one
seeded dy.  For each setting it checks the kernel against its plain version
(rtol 1e-4: atomics sum in a run-to-run order; B2 sums in a fixed order)
and prints its time (CUDA events, the mean of :data:`wfwd_probe.N_TIMED`
launches), for B3 the global atomics issued and the crossings that
overflowed the table (the kernel's own counts) beside the distinct (tile,
voxel) pairs, for B7b the item count and the largest item's crossings, for
B2 its bound (the bytes it must move over the H100's 3.35 TB/s).  One
record holds ``torch.mv`` on the CSR of Aᵀ.  The module's defaults
(``SCATTER_TILE``, ``SCATTER_SLOTS``, ``WIN_K``, ``BWD_LANES``,
``BWD_QUADS``) are among the settings.  Exits 1 when a setting disagrees
with its plain version.  Runs on the card only.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..grid import SphericalGrid
from ..operator import Operator
from ..ops import routed_project as rp
from ..ops._cuda import launch
from .wfwd_probe import CONFIGS, HBM_BYTES_PER_S, SEED, _orbit, cuda_ms

__all__ = ["SCATTER_SETTINGS", "WINDOW_K", "CSR_SETTINGS", "KERNELS",
           "csr_dot", "csr_case", "sweep", "main"]

# (tile rays, table slots) of routed_bwd_scatter; K of routed_bwd_window
SCATTER_SETTINGS = ((64, 2048), (64, 4096), (128, 4096), (128, 8192),
                    (256, 8192), (256, 16384))
WINDOW_K = (2048, 4096, 8192, 16384, 65536)
# (lanes a row, quads a lane a step) of the CSR walk of routed_fwd (B1)
# and routed_bwd_gather (B2)
CSR_SETTINGS = tuple((lanes, quads) for lanes in (2, 4, 8, 16, 32)
                     for quads in (1, 2))
KERNELS = ("B3", "B7b", "B2")


def csr_dot(ptr, idx, w, x, n_rows, lanes, quads):
    """out (n_rows,) = the CSR (ptr, idx, w) times x by the walk of
    ``routed_fwd`` / ``routed_bwd_gather`` at other settings (entry
    ``routed_csr_dot``, its ``_bf16`` one on bf16 weights)."""
    out = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    launch(rp._entry("routed_csr_dot", w), (ptr, idx, w, x, out),
           (n_rows, lanes, quads))
    return out


def csr_case(seed, R, V, device):
    """A traced-like (lin (R, M), lens (R, M)) pair of R rays over V
    voxels on ``device``, the rows the CSR walk is held to
    (tests/test_torch_gpu.py, ``chip_smoke.py``): rays of 0, 1, 3, 4, 5,
    15-17, 35, 160, 671 and 2,000 crossings, each starting at every offset
    mod 4, then 0-129 at random (R ≥ 96); voxels 0, 1 and 2 take 2,000,
    671 and 160 more crossings, their rows starting where they fall;
    lengths in (0, 1]."""
    n, pos = [], 0
    for length in (0, 1, 3, 4, 5, 15, 16, 17, 35, 160, 671, 2000):
        for off in range(4):
            pad = (off - pos) % 4
            n += [pad, length]
            pos += pad + length
    rng = np.random.default_rng(seed)
    n = torch.tensor(np.r_[n, rng.integers(0, 130, R - len(n))],
                     device=device)
    M = int(n.max())
    gen = torch.Generator(device=device).manual_seed(seed)
    lin = torch.randint(0, V, (R, M), generator=gen, device=device,
                        dtype=torch.int32)
    lens = 1 - torch.rand((R, M), generator=gen, device=device)
    lens[torch.arange(M, device=device) >= n[:, None]] = 0
    hot = torch.nonzero(lens.reshape(-1))[:, 0]
    hot = hot[torch.randperm(hot.numel(), generator=gen, device=device)]
    flat = lin.view(-1)
    flat[hot[:2000]], flat[hot[2000:2671]], flat[hot[2671:2831]] = 0, 1, 2
    return lin, lens


def csr_records(config, kernel, t, x):
    """One record of ``kernel`` (``'routed_fwd'`` or
    ``'routed_bwd_gather'``, its ``_bf16`` entry on bf16 tables) on table
    ``t`` and input ``x``, and one a setting of :data:`CSR_SETTINGS` of its
    walk, each checked against its plain version first (rtol 1e-5: the walk
    sums in a fixed order)."""
    fwd = kernel == "routed_fwd"
    reads = (t.row_ptr, t.col, t.val) if fwd else (t.vox_ptr, t.ray, t.valT)
    n_rows = t.n_rays if fwd else t.n_vox
    want = getattr(rp, f"{kernel}_ref")(t, x)
    bound = (sum(a.numel() * a.element_size() for a in reads)
             + 4 * x.numel() + 4 * n_rows) / HBM_BYTES_PER_S * 1e3
    name = rp._entry(kernel, reads[2])
    shipped = getattr(rp, kernel)
    out = [{"config": config, "kernel": name, "setting": "shipped",
            "outside_tol": _close(shipped(t, x), want, 1e-5),
            "ms": cuda_ms(lambda: shipped(t, x)), "bound_ms": bound}]
    for lanes, quads in CSR_SETTINGS:
        def run():
            return csr_dot(*reads, x, n_rows, lanes, quads)
        out.append({"config": config, "kernel": name, "lanes": lanes,
                    "quads": quads, "outside_tol": _close(run(), want, 1e-5),
                    "ms": cuda_ms(run), "bound_ms": bound})
    return out


def _scatter(t, dy, tile, slots, counts):
    """``routed_bwd_scatter`` at another tile and table size than the
    wrapper's."""
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    launch("routed_bwd_scatter", (t.row_ptr, t.col, t.val, dy, dD, counts),
           (t.n_rays, t.n_vox, tile, slots))
    return dD


def _close(got, want, rtol=1e-4):
    """Outputs outside ``rtol`` / atol 1e-5 of the largest."""
    tol = 1e-5 * float(want.abs().max()) + rtol * want.abs()
    return int(((got - want).abs() > tol).sum())


def _item_sizes(t):
    n = torch.diff(t.cptr).long()[t.bwd_order.long()]
    cs = torch.cat([n.new_zeros(1), torch.cumsum(n, 0)])
    ip = t.item_ptr.long()
    return cs[ip[1:]] - cs[ip[:-1]]


def sweep(config="flagship", kernels=KERNELS):
    """One record a setting (dicts, see the module docstring) of each of
    ``kernels``."""
    dev = torch.device("cuda")
    vshape, n_views, det = CONFIGS[config]
    op = Operator(SphericalGrid(shape=vshape), _orbit(n_views, det),
                  mode="precomputed", device=dev)
    V = op._flat_size
    csr = rp.build_tables(op.lin, op.lens, V, transpose="B2" in kernels)
    dy = torch.randn(csr.n_rays,
                     generator=torch.Generator().manual_seed(SEED)).to(dev)
    records = []
    want = rp.routed_bwd_scatter_ref(csr, dy) if "B3" in kernels else None
    for tile, slots in SCATTER_SETTINGS if "B3" in kernels else ():
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        got = _scatter(csr, dy, tile, slots, counts)
        issued, over = counts.tolist()
        records.append({
            "config": config, "kernel": "routed_bwd_scatter", "tile": tile,
            "slots": slots,
            "ms": cuda_ms(lambda: _scatter(csr, dy, tile, slots, None)),
            "atomics": issued, "overflowed": over,
            "pairs": rp.scatter_atomics(csr, tile), "nnz": csr.nnz,
            "outside_tol": _close(got, want)})
    for K in WINDOW_K if "B7b" in kernels else ():
        t = rp.build_window_tables(op.lin, op.lens, V, K=K)
        want = rp.routed_bwd_window_ref(t, dy)
        got = rp.routed_bwd_window(t, dy)
        records.append({
            "config": config, "kernel": "routed_bwd_window", "K": K,
            "ms": cuda_ms(lambda: rp.routed_bwd_window(t, dy)),
            "items": t.n_items, "largest_item": int(_item_sizes(t).max()),
            "nnz": t.nnz, "outside_tol": _close(got, want)})
    del op
    if "B2" in kernels:
        AT = torch.sparse_csr_tensor(csr.vox_ptr, csr.ray, csr.valT,
                                     size=(V, csr.n_rays),
                                     check_invariants=False)
        records.append({"config": config, "kernel": "torch.mv (A^T)",
                        "nnz": csr.nnz,
                        "ms": cuda_ms(lambda: torch.mv(AT, dy))})
        for w_dtype in (torch.float32, torch.bfloat16):
            t = csr._replace(valT=csr.valT.to(w_dtype))
            records += csr_records(config, "routed_bwd_gather", t, dy)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", default=["flagship"],
                    choices=sorted(CONFIGS))
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=KERNELS)
    args = ap.parse_args(argv)
    bad = 0
    for config in args.configs:
        print(f"[sweep] {config} on {torch.cuda.get_device_name()}",
              flush=True)
        for r in sweep(config, args.kernels):
            bad += r.get("outside_tol") or 0
            print(json.dumps(r), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
