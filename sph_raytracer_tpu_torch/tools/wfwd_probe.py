"""On-card probe: the window-major forward ``routed_fwd_densew`` (B8)
beside the by-tile forward ``routed_fwd`` (B1) at a real configuration.

The port's counterpart of the JAX package's ``tools/wfwd_probe.py``::

    python -m sph_raytracer_tpu_torch.tools.wfwd_probe [config] \
        [--w-dtype bf16]                                      # vol100, f32

It builds the port's ``Operator`` on the config's orbit (one trace), and
from that trace the ray-major CSR (B1's table) and the window chunk table
(read by ``routed_fwd_window``, B7a, and by B8).  It runs the three
forwards on one seeded density and prints, for each, its time (CUDA
events), its bound (the bytes it must move — its tables, the density and
y, each once — over the H100's 3.35 TB/s), the bytes of the tables it
reads, the chunk count and the largest difference of its y from B1's; for
B8 also the atomics it issues.  The command runs on the card;
:func:`probe` takes ``device='cpu'`` (the wrappers then run their plain
versions and no time is measured).

``w_dtype='bf16'`` mirrors the JAX package's ``banded_device_wfwd(bt,
w_dtype=)``: B8 and B1 read bfloat16 weights (their ``_bf16`` kernels),
B7a keeps its float32 chunk table, as the window engine does.

Left out of the JAX probe: its RP-capped hybrid (``split_reps`` /
``select_chunks``) splits the TPU's rep-chunks, which exist because a TPU
chunk holds at most SR·128 crossings.  A chunk of the port's table holds
any count, so the split has no counterpart and no RP argument is taken.
The JAX probe's r-innermost voxel order is TPU table layout
(``routed_voxel_order`` does nothing in the port): the tables keep the
trace's own voxel order.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..grid import SphericalGrid
from ..operator import Operator, resolve_device
from ..ops import routed_project as rp
from ..viewgeom import ConeRectGeom

__all__ = ["CONFIGS", "HBM_BYTES_PER_S", "cuda_ms", "probe", "densew_atomics",
           "main"]

# name: (vol_shape, n_views, det_shape), as in the JAX package's
# tools/scalebench.py; the orbit is ConeRectGeom(det, pos=(2 cos t,
# 2 sin t, 0.3), fov=(45, 45)) over n_views angles
CONFIGS = {
    "flagship": ((50, 50, 50), 50, (50, 100)),
    "vol100": ((100, 100, 100), 50, (50, 100)),
}
_WARP = 32  # crossings a warp of routed_fwd_densew takes a step
DENSEW_BLOCK = 128  # its CTA size (kDensewBlock, csrc/routed_variants.cu)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SEED = 0      # of the probe's density
N_TIMED = 20  # launches a kernel's time is the mean of


def _orbit(n_views, det):
    return sum(ConeRectGeom(det, pos=(2 * np.cos(t), 2 * np.sin(t), 0.3),
                            fov=(45, 45))
               for t in np.linspace(0, 2 * np.pi, n_views, endpoint=False))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def densew_atomics(t: rp.WindowTables, threads=DENSEW_BLOCK):
    """``(runs, atomics)`` of ``routed_fwd_densew`` over chunk table ``t``:
    the (ray, chunk) pairs that hold a crossing, and the global adds the
    kernel issues.

    The kernel walks each work item's chunks ``threads`` at a time (its
    CTA size; a smaller one lets a small table span several batches), laid
    end to end (a batch); a warp takes 32 consecutive crossings of a
    batch, one a lane, and adds one run of one ray in each warp's slice."""
    ray, _ = rp._window_ids(t)
    dev = t.loc.device
    order = t.bwd_order.long()
    n = torch.diff(t.cptr).long()[order]   # the chunks in walk order
    nc = n.shape[0]
    ip = t.item_ptr.long()
    item = torch.repeat_interleave(torch.arange(t.n_items, device=dev),
                                   torch.diff(ip), output_size=nc)
    j = torch.arange(nc, device=dev)
    # each chunk's batch, and its first crossing in the batch
    bkey = item * (nc + 1) + (j - ip[:-1][item]) // threads
    new_b = torch.ones(nc, dtype=torch.bool, device=dev)
    new_b[1:] = bkey[1:] != bkey[:-1]
    batch = torch.cumsum(new_b.long(), 0) - 1
    cu = torch.cumsum(n, 0) - n
    first = cu - cu[new_b][batch]
    # each crossing in walk order: its chunk, ray and warp slice
    cid = torch.repeat_interleave(j, n, output_size=t.nnz)
    pos = torch.arange(t.nnz, device=dev) - cu[cid]
    r = ray[t.cptr[:-1].long()[order][cid] + pos]
    slice_id = batch[cid] * (t.nnz + 1) + (first[cid] + pos) // _WARP
    new_run = torch.ones(t.nnz, dtype=torch.bool, device=dev)
    new_run[1:] = (cid[1:] != cid[:-1]) | (r[1:] != r[:-1])
    new_slice = torch.ones(t.nnz, dtype=torch.bool, device=dev)
    new_slice[1:] = slice_id[1:] != slice_id[:-1]
    return int(new_run.sum()), int((new_slice | new_run).sum())


def cuda_ms(fn, n=N_TIMED, warm=3):
    """Mean milliseconds per call of ``fn`` over ``n`` calls (CUDA events,
    after ``warm`` untimed calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def probe(config="vol100", device=None, w_dtype="f32"):
    """Run ``routed_fwd`` (B1), ``routed_fwd_window`` (B7a) and
    ``routed_fwd_densew`` (B8) at ``config``: a name in :data:`CONFIGS` or
    a ``(vol_shape, n_views, det_shape)`` tuple, B1 and B8 on weights of
    ``w_dtype`` ('f32' or 'bf16'), B7a on f32 ones.

    Returns a dict: the sizes (``n_rays``, ``n_vox``, ``nnz``), ``setup_s``
    (trace and both tables), B8's ``runs`` and ``atomics``
    (:func:`densew_atomics`), the tables ``csr`` (B1's) and ``win`` (B8's),
    the density ``d``, each kernel's image in ``y`` and one record a kernel
    in ``kernels``.  ``ms`` is the mean of :data:`N_TIMED` launches on the
    card, None on the CPU."""
    wdt = {"f32": torch.float32, "bf16": torch.bfloat16}[w_dtype]
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    vshape, n_views, det = CONFIGS[config] if isinstance(config, str) \
        else config
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.time()
    op = Operator(SphericalGrid(shape=vshape), _orbit(n_views, det),
                  mode="precomputed", device=dev)
    V = op._flat_size
    csr = rp.build_tables(op.lin, op.lens, V, transpose=False, w_dtype=wdt)
    win32 = rp.build_window_tables(op.lin, op.lens, V)
    # the same chunk table with each length rounded, as a bf16 build makes
    win = win32._replace(val=win32.val.to(wdt))
    del op
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t0
    d = torch.rand(V, generator=torch.Generator().manual_seed(SEED)).to(dev)
    runs, atomics = densew_atomics(win)
    common = (win.ckey, win.cptr, win.loc)
    reads = {"routed_fwd": (csr, (csr.row_ptr, csr.col, csr.val)),
             "routed_fwd_window": (win32, (win32.tile_ptr, win32.piece_ptr,
                                           win32.piece_chunk, *common,
                                           win32.val)),
             "routed_fwd_densew": (win, (win.item_ptr, win.item_win,
                                         win.bwd_order, *common, win.val))}
    ys, records = {}, []
    for name, (tab, ts) in reads.items():
        kern = getattr(rp, name)
        ys[name] = kern(tab, d)
        table_bytes = _nbytes(*ts)
        records.append({
            "name": name,
            "ms": cuda_ms(lambda: kern(tab, d)) if cuda else None,
            "bound_ms": (table_bytes + 4 * V + 4 * csr.n_rays)
            / HBM_BYTES_PER_S * 1e3,
            "table_bytes": table_bytes,
            "chunks": None if tab is csr else int(win.ckey.shape[0]),
            "atomics": atomics if name == "routed_fwd_densew" else None,
            "max_abs_diff_vs_routed_fwd": float(
                (ys[name] - ys["routed_fwd"]).abs().max()),
        })
    return {"config": config, "device": str(dev), "w_dtype": w_dtype,
            "n_rays": csr.n_rays,
            "n_vox": V, "nnz": win.nnz, "setup_s": setup_s, "runs": runs,
            "atomics": atomics, "csr": csr, "win": win, "d": d, "y": ys,
            "kernels": records}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="vol100",
                    choices=sorted(CONFIGS))
    ap.add_argument("--w-dtype", default="f32", choices=("f32", "bf16"),
                    help="weights of B1 and B8 (B7a stays f32)")
    args = ap.parse_args(argv)
    res = probe(args.config, w_dtype=args.w_dtype)
    print(f"[probe] {args.config}, {args.w_dtype} weights, on "
          f"{torch.cuda.get_device_name()}: "
          f"R={res['n_rays']} V={res['n_vox']} nnz={res['nnz']} setup "
          f"{res['setup_s']:.3f} s; routed_fwd_densew: {res['runs']} (ray, "
          f"chunk) runs, {res['atomics']} atomics (one a crossing would be "
          f"{res['nnz']})", flush=True)
    for r in res["kernels"]:
        print(f"[probe] {r['name']}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, tables {r['table_bytes']} B, chunks "
              f"{r['chunks']}, max diff vs routed_fwd "
              f"{r['max_abs_diff_vs_routed_fwd']:.3e}", flush=True)
    print(json.dumps({k: res[k] for k in ("config", "device", "w_dtype",
                                          "n_rays", "n_vox", "nnz",
                                          "setup_s", "runs", "atomics",
                                          "kernels")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
