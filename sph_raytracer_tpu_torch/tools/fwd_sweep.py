"""On-card sweep of the redesigned forwards' parameters at a real
configuration: ``routed_fwd_window`` (B7a) over its piece size ``KF`` and
CTA size, ``routed_fwd_dense`` (B5) over its atomic width and warp order,
``routed_fwd_densew`` (B8) over its item size ``K``, ``routed_fwd_hist``
(B6) over its share size and ``routed_fwd`` (B1) over its lanes a ray and
quads a lane a step (:data:`bwd_sweep.CSR_SETTINGS`), on float32 and
bfloat16 weights::

    python -m sph_raytracer_tpu_torch.tools.fwd_sweep [config ...] \
        [--kernels B7a B5 B8 B6 B1]                # flagship, all five

For each config it builds the trace once (:data:`wfwd_probe.CONFIGS`), the
ray-major CSR and its transpose and the window chunk table from it, and one
seeded density.  Each setting is checked against its plain version (rtol
1e-4: atomics sum in a run-to-run order) before it is timed (CUDA events,
the mean of :data:`wfwd_probe.N_TIMED` launches after 3); each record
holds the time, the bound (the bytes the kernel must move, each table it
reads, the density and y once, over the H100's 3.35 TB/s), for B7a the
piece count and the largest piece, for B5 the global atomics it issues
(:func:`routed_project.dense_fwd_atomics`) beside the crossings; B5 also
over its warp order (``spread``) and, as width 0, with plain stores in
place of its atomics (a race, timed only); for B8 the items, the largest
and the atomics it issues (:func:`wfwd_probe.densew_atomics`); for B6 the
shares and the most crossings and rays a share holds
(:func:`routed_project.hist_cut`).  One record a config holds
``torch.mv`` on the CSR of A.  The module's defaults (``WIN_KF``,
``WIN_FWD_THREADS``, ``DENSE_WIDTH``, ``DENSE_SPREAD``, ``WIN_K``,
``HIST_SHARE``, ``FWD_LANES``, ``FWD_QUADS``) are among the settings; B1's
records also hold the shipped kernel itself and are checked at rtol 1e-5
(it sums in a fixed order).
Exits 1 when a setting disagrees with its plain version.  Runs on the card
only.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..grid import SphericalGrid
from ..operator import Operator
from ..ops import routed_project as rp
from ..ops._cuda import launch
from .bwd_sweep import _close, csr_records
from .wfwd_probe import (CONFIGS, HBM_BYTES_PER_S, SEED, _orbit, cuda_ms,
                         densew_atomics)

__all__ = ["WINDOW_KF", "WINDOW_THREADS", "DENSE_WIDTHS", "DENSE_SPREADS",
           "DENSEW_K", "HIST_SHARES", "KERNELS", "window_fwd", "dense_fwd",
           "hist_fwd", "sweep", "main"]

# KF of routed_fwd_window (the last: one piece a tile), its CTA sizes;
# the atomic widths of routed_fwd_dense (0: plain stores, a race whose
# output is not checked: the scatter's time without atomics) and its warp
# spreads
WINDOW_KF = (2048, 4096, 8192, 16384, 65536, 2 ** 31 - 1)
WINDOW_THREADS = (128, 256, 512, 1024)
DENSE_WIDTHS = (0, 1, 2, 4)
DENSE_SPREADS = (1, 64, 512)
# routed_fwd_densew's item sizes K; routed_fwd_hist's share sizes
DENSEW_K = (2048, 4096, 8192, 16384)
HIST_SHARES = (1024, 2048, 4096)
KERNELS = ("B7a", "B5", "B8", "B6", "B1")


def window_fwd(t, d, threads):
    """``routed_fwd_window`` with CTAs of ``threads`` threads."""
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    launch("routed_fwd_window",
           (t.tile_ptr, t.ckey, t.cptr, t.loc, t.val, t.piece_ptr,
            t.piece_chunk, d, y),
           (t.n_win, t.n_rays, len(t.ckey), t.n_pieces, t.G, t.W, threads))
    return y


def dense_fwd(t, d, width, spread=1):
    """``routed_fwd_dense`` (its ``_bf16`` entry on bf16 tables) at atomic
    ``width``, warp w on voxel (w % spread)·ceil(V / spread) + w // spread."""
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    launch(rp._entry("routed_fwd_dense", t.valT),
           (t.vox_ptr, t.ray, t.valT, d, y),
           (t.n_vox, t.n_rays, width, spread))
    return y


def hist_fwd(t, d, share, cut):
    """``routed_fwd_hist`` (its ``_bf16`` entry on bf16 tables) with shares
    of ``share`` merge-path steps, their ends read from ``cut``
    (:func:`routed_project.hist_cut` at this share)."""
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    launch(rp._entry("routed_fwd_hist", t.val),
           (t.row_ptr, t.col, t.val, cut, d, y), (t.n_rays, t.nnz, share))
    return y


def _nbytes(*ts):
    return sum(x.numel() * x.element_size() for x in ts)


def sweep(config="flagship", kernels=KERNELS):
    """One record a setting (dicts, see the module docstring) of each of
    ``kernels``."""
    dev = torch.device("cuda")
    vshape, n_views, det = CONFIGS[config]
    op = Operator(SphericalGrid(shape=vshape), _orbit(n_views, det),
                  mode="precomputed", device=dev)
    V = op._flat_size
    t = rp.build_tables(op.lin, op.lens, V)
    d = torch.rand(V, generator=torch.Generator().manual_seed(SEED)).to(dev)
    R, io = t.n_rays, 4 * V + 4 * t.n_rays
    A = torch.sparse_csr_tensor(t.row_ptr, t.col, t.val, size=(R, V),
                                check_invariants=False)
    records = [{"config": config, "kernel": "torch.mv", "nnz": t.nnz,
                "ms": cuda_ms(lambda: torch.mv(A, d))}]
    for KF in WINDOW_KF if "B7a" in kernels else ():
        w = rp.build_window_tables(op.lin, op.lens, V, KF=KF)
        want = rp.routed_fwd_window_ref(w, d)
        sizes = torch.diff(w.piece_ptr)
        bound = _nbytes(w.tile_ptr, w.piece_ptr, w.piece_chunk, w.ckey,
                        w.cptr, w.loc, w.val) + io
        for threads in WINDOW_THREADS:
            records.append({
                "config": config, "kernel": "routed_fwd_window", "KF": KF,
                "threads": threads,
                "outside_tol": _close(window_fwd(w, d, threads), want),
                "ms": cuda_ms(lambda: window_fwd(w, d, threads)),
                "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
                "pieces": w.n_pieces, "largest_piece": int(sizes.max()),
                "piece_table_bytes": _nbytes(w.piece_ptr, w.piece_chunk)})
        del w
    for K in DENSEW_K if "B8" in kernels else ():
        w32 = rp.build_window_tables(op.lin, op.lens, V, K=K)
        n = torch.diff(w32.cptr).long()[w32.bwd_order.long()]
        cs = torch.cat([n.new_zeros(1), torch.cumsum(n, 0)])
        ip = w32.item_ptr.long()
        largest = int((cs[ip[1:]] - cs[ip[:-1]]).max())
        for w_dtype in (torch.float32, torch.bfloat16):
            w = w32._replace(val=w32.val.to(w_dtype))
            want = rp.routed_fwd_densew_ref(w, d)
            bound = _nbytes(w.item_ptr, w.item_win, w.bwd_order, w.ckey,
                            w.cptr, w.loc, w.val) + io
            records.append({
                "config": config,
                "kernel": rp._entry("routed_fwd_densew", w.val), "K": K,
                "outside_tol": _close(rp.routed_fwd_densew(w, d), want),
                "ms": cuda_ms(lambda: rp.routed_fwd_densew(w, d)),
                "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
                "items": w.n_items, "largest_item": largest,
                "item_table_bytes": _nbytes(w.item_ptr, w.item_win),
                "issued": densew_atomics(w)[1], "nnz": w.nnz})
        del w, w32
    del op
    for w_dtype in (torch.float32, torch.bfloat16):
        tw = t._replace(val=t.val.to(w_dtype), valT=t.valT.to(w_dtype))
        if "B1" in kernels:
            records += csr_records(config, "routed_fwd", tw, d)
        for share in HIST_SHARES if "B6" in kernels else ():
            want = rp.routed_fwd_hist_ref(tw, d)
            table = rp.hist_cut(tw, share)
            rays, ks = table[:, 0], table[:, 1]
            bound = _nbytes(tw.row_ptr, tw.col, tw.val, table) + io
            records.append({
                "config": config,
                "kernel": rp._entry("routed_fwd_hist", tw.val),
                "share": share,
                "outside_tol": _close(hist_fwd(tw, d, share, table), want),
                "ms": cuda_ms(lambda: hist_fwd(tw, d, share, table)),
                "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
                "shares": int(rays.numel()) - 1,
                "most_crossings": int(torch.diff(ks).max()),
                "most_rays": int(torch.diff(rays).max()) + 1})
        if "B5" not in kernels:
            continue
        want = rp.routed_fwd_dense_ref(tw, d)
        bound = _nbytes(tw.vox_ptr, tw.ray, tw.valT) + io
        for width in DENSE_WIDTHS:
            for spread in DENSE_SPREADS:
                records.append({
                    "config": config,
                    "kernel": rp._entry("routed_fwd_dense", tw.valT),
                    "width": width, "spread": spread,
                    "outside_tol": _close(dense_fwd(tw, d, width, spread),
                                          want) if width else None,
                    "ms": cuda_ms(lambda: dense_fwd(tw, d, width, spread)),
                    "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
                    "atomics": rp.dense_fwd_atomics(tw, width) if width
                    else 0, "nnz": tw.nnz})
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
