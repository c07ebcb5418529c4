"""Routed projection engine: GPU CSR tables + hand-written CUDA kernels.

Port of ``sph_raytracer_tpu/ops/routed_project.py``'s banded engine.  The
operator is the sparse matrix A (rays x voxels) of traced segment lengths;
the forward is y = A·d and the backward dD = Aᵀ·dy, accumulated in f32.

Tables, built on the device with torch ops from the traced ``(lin, lens)``
(:func:`build_tables`):

* a ray-major CSR ``row_ptr`` (R+1) / ``col`` / ``val`` of the live
  (nonzero-length) crossings, and
* for the deterministic backward, its voxel-major transpose ``vox_ptr``
  (V+1) / ``ray`` / ``valT``, made by a **stable** sort of ``col`` so each
  voxel row lists its rays in ascending order (a fixed summation order).

Either half may be left out (``csr=False`` / ``transpose=False``): a
table set holds only what its (forward, backward) pair reads, so
``routed_dense='both'`` and fused mode's gather keep the transpose alone
(the counterpart of the JAX package's ``build_banded_device(...,
bwd_only=True)``).

The window-routed engine (``routed_banded=False``) reads one chunk table
instead (:func:`build_window_tables`, :class:`WindowTables`): the live
crossings grouped into (tile of :data:`WIN_G` rays, window of
:data:`WIN_W` voxels) chunks, 8 B a crossing, and the window-major work
items of the backward and of ``routed_fwd_densew`` (each window's chunks
cut into runs of at most :data:`WIN_K` crossings, 8 B an item) and the
forward's pieces (each tile's crossings cut into runs of at most
:data:`WIN_KF`, 8 B a piece).

Kernels (``csrc/routed_project.cu``, ``csrc/routed_variants.cu``), each
beside its plain PyTorch version and a launch counter in :data:`LAUNCHES`
(TPU kernels in ``sph_raytracer_tpu/ops/routed_project.py``):

=================== ================================= ======================
wrapper             replaces (TPU kernel)             plain version
=================== ================================= ======================
routed_fwd          ``_fwd_banded_pallas`` (B1)       routed_fwd_ref
routed_bwd_gather   ``_bwd_banded_dense_pallas`` (B2) routed_bwd_gather_ref
routed_bwd_scatter  ``_bwd_banded_pallas`` (B3)       routed_bwd_scatter_ref
routed_fwd_dense    ``_fwd_banded_dense_pallas`` (B5) routed_fwd_dense_ref
routed_fwd_hist     ``_fwd_banded_hist_pallas`` (B6)  routed_fwd_hist_ref
routed_fwd_window   ``_fwd_pallas`` (B7a)             routed_fwd_window_ref
routed_bwd_window   ``_bwd_pallas`` (B7b)             routed_bwd_window_ref
routed_fwd_densew   ``_fwd_banded_densew_pallas``     routed_fwd_densew_ref
                    (B8)
=================== ================================= ======================

``routed_fwd_densew`` has no ``TraceConfig`` value, as B8 has none in the
JAX package: :mod:`sph_raytracer_tpu_torch.tools.wfwd_probe` runs it.

Weights (the lengths ``val`` / ``valT``) are float32, or bfloat16 with
``w_dtype=torch.bfloat16`` (``routed_w_dtype='bf16'``): each f32 length is
rounded to nearest even once, at the build, and both directions read the
same rounded values, so every (forward, backward) pair stays exactly
adjoint.  B1, B2, B3, B5, B6 and B8 launch their ``<name>_bf16`` entry on
bfloat16 tables (widened to f32 in the kernel, f32 accumulation); the
window pair B7a / B7b takes float32 only, as the JAX package runs its
window engine on f32 tables alone.  Every wrapper raises ``ValueError`` on
a weight dtype it does not take, on the CPU too.

:func:`resolve` maps a ``TraceConfig`` to its (forward, backward) pair and
:func:`build_for` builds the tables that pair reads; :func:`save_tables` /
:func:`load_tables` keep a table set on disk (the operators' table cache,
``SPH_TPU_TRACE_CACHE``).

A wrapper runs the plain version only because the tensor it was given
lies on the CPU; for a CUDA tensor it launches the kernel or raises.  The
library is built from the sources in this package with ``nvcc`` at first
use (:func:`load_library`, in :mod:`._cuda`); there is no fallback.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ._cuda import LAUNCHES, launch, load_library, reset_launches

__all__ = [
    "RoutedTables",
    "WindowTables",
    "WIN_G",
    "WIN_W",
    "WIN_K",
    "WIN_KF",
    "WIN_FWD_THREADS",
    "HIST_SHARE",
    "hist_cut",
    "DENSE_WIDTH",
    "DENSE_SPREAD",
    "FWD_LANES",
    "FWD_QUADS",
    "BWD_LANES",
    "BWD_QUADS",
    "CSR_BLOCK",
    "SCATTER_TILE",
    "SCATTER_SLOTS",
    "scatter_atomics",
    "dense_fwd_atomics",
    "build_tables",
    "build_window_tables",
    "build_for",
    "save_tables",
    "load_tables",
    "routed_fwd",
    "routed_bwd_gather",
    "routed_bwd_scatter",
    "routed_fwd_dense",
    "routed_fwd_hist",
    "routed_fwd_window",
    "routed_bwd_window",
    "routed_fwd_densew",
    "routed_fwd_ref",
    "routed_bwd_gather_ref",
    "routed_bwd_scatter_ref",
    "routed_fwd_dense_ref",
    "routed_fwd_hist_ref",
    "routed_fwd_window_ref",
    "routed_bwd_window_ref",
    "routed_fwd_densew_ref",
    "routed_project",
    "resolve",
    "FORWARDS",
    "BACKWARDS",
    "LAUNCHES",
    "reset_launches",
    "load_library",
]

# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

class RoutedTables(NamedTuple):
    """GPU-native CSR tables of one operator (see module docstring).
    ``vox_ptr``/``ray``/``valT`` are None when the transpose was not
    built; ``row_ptr``/``col``/``val`` are None when the ray-major CSR
    was not.  ``cut`` is ``routed_fwd_hist``'s cut table
    (:func:`hist_cut` at :data:`HIST_SHARE`, so tied to that setting),
    built only for it (:func:`build_for`); without one the wrapper makes
    it at each call."""

    row_ptr: Optional[torch.Tensor]
    col: Optional[torch.Tensor]
    val: Optional[torch.Tensor]
    vox_ptr: Optional[torch.Tensor]
    ray: Optional[torch.Tensor]
    valT: Optional[torch.Tensor]
    n_rays: int
    n_vox: int
    cut: Optional[torch.Tensor] = None

    @property
    def nnz(self) -> int:
        return int((self.col if self.col is not None else self.ray).shape[0])

    @property
    def device(self) -> torch.device:
        return (self.col if self.col is not None else self.ray).device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self[:6], self.cut) if t is not None)


def _live(lin, lens, n_vox):
    """Per-ray live counts and nnz of a traced table; raises when int32
    indices would not reach."""
    R = lin.shape[0]
    live = lens != 0
    counts = live.sum(dim=1)
    nnz = int(counts.sum())
    if nnz >= 2 ** 31 or n_vox >= 2 ** 31 or R >= 2 ** 31:
        raise OverflowError(f"routed tables index with int32: nnz={nnz}, "
                            f"rays={R}, voxels={n_vox}")
    return R, live, counts, nnz


_W_DTYPES = (torch.float32, torch.bfloat16)


def _weights(lens, live, w_dtype):
    """The live lengths as weights: float32, or each float32 length rounded
    to nearest even in bfloat16 (a float64 trace is rounded to float32
    first, as the JAX package's f32 tables are); no float32 copy outlives
    the cast."""
    if w_dtype not in _W_DTYPES:
        raise ValueError(f"weight dtype {w_dtype} (want torch.float32 or "
                         "torch.bfloat16)")
    return lens[live].to(torch.float32).to(w_dtype)


def build_tables(lin, lens, n_vox: int, transpose: bool = True,
                 csr: bool = True,
                 w_dtype: torch.dtype = torch.float32) -> RoutedTables:
    """Build the CSR tables from a traced (lin (R, M), lens (R, M)) pair on
    the tables' device.  Zero-length slots are dropped.

    ``transpose`` adds the voxel-major transpose; ``csr=False`` then drops
    the ray-major CSR (the voxel-major kernels do not read it).
    ``w_dtype`` is the dtype of ``val`` / ``valT`` (module docstring)."""
    R, live, counts, nnz = _live(lin, lens, n_vox)
    dev = lin.device
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    col = lin[live].to(torch.int32)
    val = _weights(lens, live, w_dtype)
    vox_ptr = ray = valT = None
    if transpose:
        order = torch.sort(col, stable=True).indices
        rows = torch.repeat_interleave(
            torch.arange(R, dtype=torch.int32, device=dev), counts,
            output_size=nnz)
        ray, valT = rows[order], val[order]
        vox_ptr = torch.zeros(n_vox + 1, dtype=torch.int32, device=dev)
        vox_ptr[1:] = torch.cumsum(torch.bincount(col, minlength=n_vox), 0)
        if not csr:
            row_ptr = col = val = None
    return RoutedTables(row_ptr, col, val, vox_ptr, ray, valT, R, n_vox)


# The window chunk table's tile and window sizes: at the flagship (250,000
# rays, 125,000 voxels) 245 tiles of G rays and 489 windows of W voxels.
# The in-chunk offsets are packed in 16 bits each (G <= 32768 keeps the
# packed word non-negative); the forward holds a G-float y tile and the
# backward and routed_fwd_densew a W-float window in shared memory
# (csrc/routed_variants.cu).
WIN_G = 1024
WIN_W = 256
# the window-major work item (routed_bwd_window's and routed_fwd_densew's):
# at most this many crossings (a larger chunk is an item of its own); the
# flagship's hottest window holds ~141,700 crossings and its largest chunk
# ~2,400.  tools/bwd_sweep.py and tools/fwd_sweep.py time others: on an
# H100 (700 W) both read fastest at 4,096 (routed_fwd_densew 0.0786 ms,
# 0.0847-0.0947 at 2,048, 8,192 and 16,384; PERF.md section 6)
WIN_K = 4096
# the forward's piece: each tile's crossings cut into the fewest near-equal
# runs of at most this many (a cut may fall inside a chunk), one CTA of
# WIN_FWD_THREADS threads a piece; the flagship's tiles hold ~69,800
# crossings on average, 87,600 at most.  tools/fwd_sweep.py times others:
# on an H100 (700 W) KF 2,048-16,384 at 128-512 threads read 0.073-0.094
# ms there, one piece a tile 0.088-0.343 ms (PERF.md section 6)
WIN_KF = 4096
WIN_FWD_THREADS = 256


class WindowTables(NamedTuple):
    """The window-routed engine's chunk table (one table serves both
    directions).  A chunk holds the live crossings of one (tile of ``G``
    rays, window of ``W`` voxels) pair; chunks are stored tile-major,
    windows ascending, and only non-empty ones are kept (``NC``).

    * ``loc`` (nnz,) int32: ``(ray % G) << 16 | (voxel % W)`` and ``val``
      (nnz,) f32 the length, crossings sorted by chunk (stable: ray, then
      trace order within a chunk) — 8 B a crossing;
    * ``cptr`` (NC+1,) crossing offsets, ``ckey`` (NC,) ``tile·n_win +
      window`` of each chunk;
    * ``tile_ptr`` (n_tiles+1,) the chunks of each tile (the forward's
      walk, windows ascending);
    * ``bwd_order`` (NC,) the chunks sorted by (window, tile) and
      ``win_ptr`` (n_win+1,) each window's range in it;
    * ``item_ptr`` (n_items+1,) the window-major work items (walked by
      ``routed_bwd_window`` and ``routed_fwd_densew``, one CTA an item) as
      ranges of ``bwd_order``, and ``item_win`` (n_items,) the window of
      each: every
      non-empty window's range cut greedily at chunk boundaries into runs
      of at most ``K`` crossings (a chunk of more is an item alone); an
      empty window has no item;
    * ``piece_ptr`` (n_pieces+1,) the forward's pieces as crossing offsets,
      and ``piece_chunk`` (n_pieces,) the chunk that holds each piece's
      first crossing: every non-empty tile's crossing range cut into
      ``ceil(n / KF)`` near-equal runs (a cut may fall inside a chunk); an
      empty tile has no piece."""

    loc: torch.Tensor
    val: torch.Tensor
    cptr: torch.Tensor
    ckey: torch.Tensor
    tile_ptr: torch.Tensor
    bwd_order: torch.Tensor
    win_ptr: torch.Tensor
    item_ptr: torch.Tensor
    item_win: torch.Tensor
    piece_ptr: torch.Tensor
    piece_chunk: torch.Tensor
    n_rays: int
    n_vox: int
    G: int
    W: int
    K: int
    KF: int

    @property
    def nnz(self) -> int:
        return int(self.loc.shape[0])

    @property
    def n_tiles(self) -> int:
        return int(self.tile_ptr.shape[0]) - 1

    @property
    def n_win(self) -> int:
        return int(self.win_ptr.shape[0]) - 1

    @property
    def n_items(self) -> int:
        return int(self.item_ptr.shape[0]) - 1

    @property
    def n_pieces(self) -> int:
        return int(self.piece_ptr.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.loc.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self[:11])


def _work_items(n, win_ptr, K):
    """The window-major work items over chunks of sizes ``n`` (in
    ``bwd_order``) and windows ``win_ptr``: ``item_ptr``, the items' ranges
    of ``bwd_order``.  Each window is cut greedily (an item takes chunks
    while its crossings stay within ``K``, and at least one chunk); all
    windows take their next item at once, so the loop runs as many times
    as the busiest window has items."""
    end_at = torch.cumsum(n.long(), 0)       # crossings up to each chunk's end
    start_at = end_at - n.long()
    wp = win_ptr.long()
    keep = wp[1:] > wp[:-1]
    j, j_end = wp[:-1][keep], wp[1:][keep]  # each open window's next item
    starts = [j]
    while j.numel():
        nxt = torch.searchsorted(end_at, start_at[j] + K, right=True)
        nxt = torch.minimum(torch.maximum(nxt, j + 1), j_end)
        more = nxt < j_end
        j, j_end = nxt[more], j_end[more]
        starts.append(j)
    starts = torch.sort(torch.cat(starts)).values
    return torch.cat([starts, starts.new_full((1,), n.shape[0])]).to(
        torch.int32)


def _pieces(cptr, tile_ptr, KF):
    """The forward's pieces over chunk offsets ``cptr`` and tiles
    ``tile_ptr``: ``(piece_ptr, piece_chunk)``, each non-empty tile's
    crossings cut into ``ceil(n / KF)`` runs whose sizes differ by at most
    one."""
    cp, tp = cptr.long(), tile_ptr.long()
    beg = cp[tp[:-1]]
    n = cp[tp[1:]] - beg
    per = (n + KF - 1) // KF                  # pieces a tile: 0 when empty
    tile = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device),
                                   per)
    j = torch.arange(tile.shape[0], device=n.device) - (
        torch.cumsum(per, 0) - per)[tile]
    start = beg[tile] + (n[tile] * j) // per[tile]
    chunk = torch.searchsorted(cp, start, right=True) - 1
    return (torch.cat([start, cp[-1:]]).to(torch.int32),
            chunk.to(torch.int32))


def build_window_tables(lin, lens, n_vox: int, G: int = WIN_G,
                        W: int = WIN_W, K: int = WIN_K, KF: int = WIN_KF,
                        w_dtype: torch.dtype = torch.float32) -> WindowTables:
    """Build the window chunk table, the window-major work items of at
    most ``K`` crossings and the forward's pieces of at most ``KF`` from a
    traced (lin, lens) pair on its device (zero-length slots dropped).
    ``w_dtype`` is the dtype of ``val``: bfloat16 tables feed
    ``routed_fwd_densew`` alone (B7a / B7b take float32)."""
    if not (0 < G <= 2 ** 15 and 0 < W <= 2 ** 16):
        raise ValueError(f"tile G={G} / window W={W} must fit 15 / 16 bits")
    if 4 * max(G, W) > 40 * 1024:
        raise ValueError(f"tile G={G} / window W={W}: the window kernels' "
                         "shared memory (a G-float y tile or a W-float "
                         "window, beside up to 8 KB of chunk lists) would "
                         "pass 48 KB")
    if K < 1:
        raise ValueError(f"work item size K={K} must be positive")
    if KF < 1:
        raise ValueError(f"piece size KF={KF} must be positive")
    R, live, counts, nnz = _live(lin, lens, n_vox)
    dev = lin.device
    n_tiles, n_win = -(-R // G), -(-n_vox // W)
    if n_tiles * n_win >= 2 ** 31:
        raise OverflowError(f"{n_tiles} tiles x {n_win} windows: chunk keys "
                            "index with int32")
    rows = torch.repeat_interleave(torch.arange(R, device=dev), counts,
                                   output_size=nnz)
    col = lin[live].long()
    key, order = torch.sort((rows // G) * n_win + col // W, stable=True)
    loc = (((rows % G) << 16) | (col % W))[order].to(torch.int32)
    val = _weights(lens, live, w_dtype)[order]
    ckey, per_chunk = torch.unique_consecutive(key, return_counts=True)
    cptr = torch.zeros(ckey.shape[0] + 1, dtype=torch.int32, device=dev)
    cptr[1:] = torch.cumsum(per_chunk, 0)
    ctile, cwin = ckey // n_win, ckey % n_win

    def ptr(ids, n):
        out = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        out[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
        return out

    bwd_order = torch.sort(cwin * n_tiles + ctile).indices
    win_ptr = ptr(cwin, n_win)
    item_ptr = _work_items(per_chunk[bwd_order], win_ptr, K)
    item_win = cwin[bwd_order][item_ptr[:-1].long()].to(torch.int32)
    tile_ptr = ptr(ctile, n_tiles)
    return WindowTables(loc, val, cptr, ckey.to(torch.int32), tile_ptr,
                        bwd_order.to(torch.int32), win_ptr, item_ptr,
                        item_win, *_pieces(cptr, tile_ptr, KF), R, n_vox, G,
                        W, K, KF)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _row_ids(ptr, nnz):
    n = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device),
                                   torch.diff(ptr).long(), output_size=nnz)


def routed_fwd_ref(t: RoutedTables, d):
    """y = A·d: gather d·val per crossing, segment-sum by ray."""
    prod = d.index_select(0, t.col.long()) * t.val.to(d.dtype)
    y = torch.zeros(t.n_rays, dtype=d.dtype, device=d.device)
    return y.index_add_(0, _row_ids(t.row_ptr, t.nnz), prod)


def routed_bwd_gather_ref(t: RoutedTables, dy):
    """dD = Aᵀ·dy over the voxel-major transpose."""
    prod = dy.index_select(0, t.ray.long()) * t.valT.to(dy.dtype)
    dD = torch.zeros(t.n_vox, dtype=dy.dtype, device=dy.device)
    return dD.index_add_(0, _row_ids(t.vox_ptr, t.nnz), prod)


def routed_bwd_scatter_ref(t: RoutedTables, dy):
    """dD = Aᵀ·dy by scatter-add over the ray-major CSR."""
    prod = (dy.index_select(0, _row_ids(t.row_ptr, t.nnz))
            * t.val.to(dy.dtype))
    dD = torch.zeros(t.n_vox, dtype=dy.dtype, device=dy.device)
    return dD.index_add_(0, t.col.long(), prod)


def routed_fwd_dense_ref(t: RoutedTables, d):
    """y = A·d over the voxel-major transpose: d[v]·valT scattered by
    ray."""
    prod = (d.index_select(0, _row_ids(t.vox_ptr, t.nnz))
            * t.valT.to(d.dtype))
    y = torch.zeros(t.n_rays, dtype=d.dtype, device=d.device)
    return y.index_add_(0, t.ray.long(), prod)


def routed_fwd_hist_ref(t: RoutedTables, d):
    """y = A·d over the ray-major CSR: the function ``routed_fwd_hist``
    computes, with :func:`routed_fwd_ref`'s arithmetic."""
    return routed_fwd_ref(t, d)


def _window_ids(t: WindowTables):
    """Global (ray, voxel) ids of every crossing of a chunk table."""
    ck = torch.repeat_interleave(t.ckey.long(), torch.diff(t.cptr).long(),
                                 output_size=t.nnz)
    loc = t.loc.long()
    return ((ck // t.n_win) * t.G + (loc >> 16),
            (ck % t.n_win) * t.W + (loc & 0xFFFF))


def routed_fwd_window_ref(t: WindowTables, d):
    """y = A·d chunk by chunk over the window chunk table."""
    ray, vox = _window_ids(t)
    prod = d.index_select(0, vox) * t.val.to(d.dtype)
    y = torch.zeros(t.n_rays, dtype=d.dtype, device=d.device)
    return y.index_add_(0, ray, prod)


def routed_bwd_window_ref(t: WindowTables, dy):
    """dD = Aᵀ·dy chunk by chunk over the window chunk table."""
    ray, vox = _window_ids(t)
    prod = dy.index_select(0, ray) * t.val.to(dy.dtype)
    dD = torch.zeros(t.n_vox, dtype=dy.dtype, device=dy.device)
    return dD.index_add_(0, vox, prod)


def routed_fwd_densew_ref(t: WindowTables, d):
    """y = A·d window by window: the chunks in ``bwd_order``, d[voxel]·val
    gathered and added into y by ray."""
    ray, vox = _window_ids(t)
    order = t.bwd_order.long()
    n = torch.diff(t.cptr).long()[order]
    # crossing ids of the chunks in walk order: each chunk's start, then
    # consecutive ids
    start = t.cptr[:-1].long()[order] - (torch.cumsum(n, 0) - n)
    k = torch.repeat_interleave(start, n, output_size=t.nnz) + torch.arange(
        t.nnz, device=start.device)
    prod = d.index_select(0, vox[k]) * t.val[k].to(d.dtype)
    y = torch.zeros(t.n_rays, dtype=d.dtype, device=d.device)
    return y.index_add_(0, ray[k], prod)


def _entry(name, w):
    """The C entry of kernel ``name`` for weight table ``w``: ``name`` for
    float32, ``name_bf16`` for bfloat16; ``ValueError`` for another
    dtype."""
    if w.dtype == torch.float32:
        return name
    if w.dtype == torch.bfloat16:
        return f"{name}_bf16"
    raise ValueError(f"{name} takes float32 or bfloat16 weights, got "
                     f"{w.dtype}")


def _f32_only(name, w):
    """The window pair's weight check: float32 alone."""
    if w.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 weights only (the window "
                         "engine keeps f32 tables, as in the JAX package), "
                         f"got {w.dtype}")


def _aligned(tables, *names):
    """The quad walks' check (``routed_fwd``, ``routed_bwd_gather``,
    ``routed_fwd_window``, ``routed_fwd_hist``):
    each named table starts on a 16 B boundary (their vector loads read 4
    entries from a 4-aligned index)."""
    for name in names:
        if getattr(tables, name).data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             "kernel reads it in aligned quads)")


def _check(x, n, what, tables):
    """Validate a kernel input: 1-D float32 of length n on the tables'
    CUDA device."""
    if x.dtype != torch.float32 or x.shape != (n,):
        raise ValueError(f"{what} must be float32 of shape ({n},), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{what} is on {x.device}; the CUDA kernels take "
                         "CUDA tensors (CPU tensors use the plain version)")
    if tables.device != x.device:
        raise ValueError(f"tables on {tables.device}, {what} on "
                         f"{x.device}")
    return x.contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch(entry, t, out, tensors, ints):
    """Launch ``entry`` into ``out`` and return it.  With no crossing or no
    output the result is zeros, and nothing is launched or counted: CUDA
    refuses a launch with an empty grid, and a rank of the sharded operators
    (:mod:`..parallel`) may hold no ray or no live voxel."""
    if t.nnz == 0 or out.numel() == 0:
        return out.zero_()
    launch(entry, tensors, ints)
    return out


# routed_bwd_scatter's CTA: a tile of SCATTER_TILE consecutive rays sums its
# crossings by voxel in a shared table of SCATTER_SLOTS (key, value) slots
# (a power of two; 64 KB) before one global atomic a distinct voxel.  At the
# flagship a 128-ray tile crosses ~2,800 distinct voxels on average;
# tools/bwd_sweep.py times other sizes.
SCATTER_TILE = 128
SCATTER_SLOTS = 8192


def scatter_atomics(t: RoutedTables, tile: int = SCATTER_TILE) -> int:
    """The global atomics ``routed_bwd_scatter`` issues when no crossing
    overflows its table: one a distinct (tile of ``tile`` consecutive rays,
    voxel) pair of the ray-major CSR (one a crossing, ``t.nnz``, before the
    tiles)."""
    rows = _row_ids(t.row_ptr, t.nnz)
    return int(torch.unique((rows // tile) * t.n_vox + t.col.long()).numel())


# routed_fwd_dense's atomic width: the lanes that hold rays of one aligned
# group of DENSE_WIDTH rays sum their values (at most DENSE_WIDTH lanes a
# sum) before one DENSE_WIDTH-wide global atomic (1, 2 or 4); and its warp
# order: warp w takes voxel (w % DENSE_SPREAD)·ceil(V / DENSE_SPREAD) +
# w // DENSE_SPREAD, so that the warps in flight scatter into rays of
# distant voxels.  tools/fwd_sweep.py times others: on an H100 (700 W) at
# the flagship the spread moved it 7-10 %, the width (half the atomics at
# 4) 1.5-5 % (PERF.md section 6)
DENSE_WIDTH = 4
DENSE_SPREAD = 512


def dense_fwd_atomics(t: RoutedTables, width: int = DENSE_WIDTH) -> int:
    """The global atomics ``routed_fwd_dense`` issues at atomic ``width``:
    a warp takes 32 consecutive crossings of one voxel's list a step, and
    each run of equal ``ray // width`` in a step issues one atomic for
    every ``width`` lanes of it (one a crossing, ``t.nnz``, at width 1);
    the last group of a ray count that is not a multiple of ``width``
    takes one scalar atomic a ray of it instead."""
    k = torch.arange(t.nnz, device=t.ray.device)
    vp = t.vox_ptr.long()
    pos = k - vp[:-1][_row_ids(t.vox_ptr, t.nnz)]   # place in the list
    g = t.ray.long() // width
    start = pos % 32 == 0
    start[1:] |= g[1:] != g[:-1]
    run0 = torch.cummax(torch.where(start, k, 0), 0).values
    last = torch.ones_like(start)
    last[:-1] = start[1:]
    flush = last | ((k - run0) % width == width - 1)
    n = int(flush.sum())
    tail = t.n_rays % width
    if tail:
        n += (tail - 1) * int((flush & (g == t.n_rays // width)).sum())
    return n


# routed_fwd_hist's share: the steps of the merge path of the rays' ends
# and the crossings a CTA of 256 threads takes (hist_cut), one aligned quad
# a thread a step.  At the flagship (250,000 rays, 17.1 M crossings) 8,475
# shares of at most 2,048 crossings.  tools/fwd_sweep.py times others: on
# an H100 (700 W) the latency of a CTA's chain of loads sets the pace.  With
# the CTA size, quads a step and the ends' search as run-time choices of
# the kernel, 8 crossings a thread in 2 steps of one quad at 32 registers
# (full occupancy) read fastest, 0.0678-0.0723 ms at 1,024-4,096 with CTAs
# sized to match; 4 or 16 crossings a thread, or 2-4 quads a step,
# 0.0727-0.2674 ms, and each CTA searching row_ptr for its share's ends in
# place of the cut table 0.0739-0.0780.  Fixed at 256 threads, share 2,048
# reads 0.0681 ms, 1,024 0.0714, 4,096 0.0976 (PERF.md section 6)
HIST_SHARE = 2048


def hist_cut(t: RoutedTables, share: int = HIST_SHARE):
    """``routed_fwd_hist``'s cut of the ray-major CSR into shares: int32
    (ray, crossing) pairs, shape (n_shares + 1, 2), 8 B a share (67,808 B
    at the flagship beside its 139,352,436 B CSR).  The merge path takes
    the crossings in order and each ray's end right after its last crossing
    (ray i's end at step i + row_ptr[i + 1]); share s is its steps
    [s·share, (s + 1)·share): the crossings [cut[s, 1], cut[s + 1, 1]) and
    the ends of rays [cut[s, 0], cut[s + 1, 0]).  So a share holds at most
    ``share`` crossings and ends, its first ray may have begun in the share
    before and its last one may go on into the next.  The kernel reads its
    share's two ends from the table (a search of ``row_ptr`` in each CTA
    cost 8-10 % of its time)."""
    total = t.n_rays + t.nnz
    dev = t.row_ptr.device
    diag = torch.cat([torch.arange(0, total, share, device=dev),
                      torch.tensor([total], device=dev)])
    ends = torch.arange(t.n_rays, device=dev) + t.row_ptr[1:].long()
    rays = torch.searchsorted(ends, diag)  # the ends before each cut
    return torch.stack([rays, diag - rays], 1).to(torch.int32)


# routed_fwd_densew walks the work items (WIN_K) in CTAs of 128 threads, 4
# crossings a thread a step, the window's d staged in shared memory.  At
# the flagship 4,955 items of a mean 3,452 crossings.  tools/fwd_sweep.py
# chose it with these as run-time choices of the kernel: on an H100 (700
# W) at the flagship 0.0786 ms, 0.0799 at 256 threads, 0.0921 at 512, 5 %
# slower with d read through L2, 0.094-0.097 by aligned quads (their
# in-quad runs issue 10.5 M atomics against 9.0 M); plain stores in place
# of the atomics 0.0785, so the atomics do not set its pace.  Fixed in the
# kernel it reads 0.0750-0.0757 ms (PERF.md section 6)


# routed_fwd and routed_bwd_gather walk their CSR rows with a group of
# lanes a row (FWD_LANES a ray, BWD_LANES a voxel), each lane taking
# aligned quads of its row, FWD_QUADS / BWD_QUADS a step, in CTAs of
# CSR_BLOCK threads.  The kernels fix these (csrc/routed_project.cu
# kFwdLanes, ...); the names here mirror them for the tools and the tests'
# emulation of the walk.  tools/fwd_sweep.py (B1) and tools/bwd_sweep.py
# (B2) time other lanes and quads through the entry routed_csr_dot: on an
# H100 (700 W) at the flagship (a live ray holds 68.6 crossings on average,
# a live voxel 147.2) 8 lanes a ray read 0.0540 ms (2-4 lanes 0.0638-0.0904,
# 16-32 0.0544-0.0842) and 16 a voxel 0.0555 (2-8 0.0626-0.1097, 32
# 0.0573-0.0644).  A lane does best with about two quads of its row: at
# vol100 (136.5 crossings a ray, 34.1 a voxel) 16 lanes a ray and 8 a voxel
# read fastest (PERF.md section 6)
FWD_LANES, FWD_QUADS = 8, 1
BWD_LANES, BWD_QUADS = 16, 1
CSR_BLOCK = 256


def routed_fwd(t: RoutedTables, d):
    """y (R,) = A·d for a flat (V,) density; kernel ``routed_fwd``."""
    if t.row_ptr is None:
        raise ValueError("routed_fwd needs the ray-major CSR (these are "
                         "backward-only tables for the gather)")
    entry = _entry("routed_fwd", t.val)
    if d.device.type == "cpu":
        return routed_fwd_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    _aligned(t, "col", "val")
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    return _launch(entry, t, y, (t.row_ptr, t.col, t.val, d, y), (t.n_rays,))


def routed_bwd_gather(t: RoutedTables, dy):
    """dD (V,) = Aᵀ·dy, deterministic; kernel ``routed_bwd_gather``."""
    if t.vox_ptr is None:
        raise ValueError("routed_bwd_gather needs the voxel-major "
                         "transpose (build_tables(..., transpose=True))")
    entry = _entry("routed_bwd_gather", t.valT)
    if dy.device.type == "cpu":
        return routed_bwd_gather_ref(t, dy)
    dy = _check(dy, t.n_rays, "dy", t)
    _aligned(t, "ray", "valT")
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    return _launch(entry, t, dD, (t.vox_ptr, t.ray, t.valT, dy, dD),
                   (t.n_vox,))


def routed_bwd_scatter(t: RoutedTables, dy, counts=None):
    """dD (V,) = Aᵀ·dy over the ray-major CSR, summed by voxel in each
    ray tile before its global atomics; kernel ``routed_bwd_scatter``.

    ``counts``, an int32 CUDA tensor of shape (2,), gathers (adds to) the
    global atomics the kernel issues and the crossings that overflowed its
    tile's table; the plain version ignores it."""
    if t.row_ptr is None:
        raise ValueError("routed_bwd_scatter needs the ray-major CSR")
    entry = _entry("routed_bwd_scatter", t.val)
    if dy.device.type == "cpu":
        return routed_bwd_scatter_ref(t, dy)
    if counts is not None and (counts.dtype != torch.int32
                               or counts.shape != (2,)
                               or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous int32 tensor of "
                         f"shape (2,), got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    dy = _check(dy, t.n_rays, "dy", t)
    if counts is not None and counts.device != dy.device:
        raise ValueError(f"counts on {counts.device}, dy on {dy.device}")
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    return _launch(entry, t, dD, (t.row_ptr, t.col, t.val, dy, dD, counts),
                   (t.n_rays, t.n_vox, SCATTER_TILE, SCATTER_SLOTS))


def routed_fwd_dense(t: RoutedTables, d):
    """y (R,) = A·d over the voxel-major transpose, by ``DENSE_WIDTH``-wide
    atomics over aligned ray groups; kernel ``routed_fwd_dense``."""
    if t.vox_ptr is None:
        raise ValueError("routed_fwd_dense needs the voxel-major transpose "
                         "(build_tables(..., transpose=True))")
    entry = _entry("routed_fwd_dense", t.valT)
    if d.device.type == "cpu":
        return routed_fwd_dense_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    return _launch(entry, t, y, (t.vox_ptr, t.ray, t.valT, d, y),
                   (t.n_vox, t.n_rays, DENSE_WIDTH, DENSE_SPREAD))


def routed_fwd_hist(t: RoutedTables, d):
    """y (R,) = A·d over the ray-major CSR, one CTA a share of
    ``HIST_SHARE`` merge-path steps, its ends read from the cut table
    ``t.cut`` (:func:`hist_cut`; made here when ``t`` has none); kernel
    ``routed_fwd_hist``."""
    if t.row_ptr is None:
        raise ValueError("routed_fwd_hist needs the ray-major CSR")
    entry = _entry("routed_fwd_hist", t.val)
    if d.device.type == "cpu":
        return routed_fwd_hist_ref(t, d)
    n_cuts = -(-(t.n_rays + t.nnz) // HIST_SHARE) + 1
    if t.cut is not None and (t.cut.dtype != torch.int32
                              or t.cut.shape != (n_cuts, 2)):
        raise ValueError(f"cut table {t.cut.dtype} {tuple(t.cut.shape)} is "
                         f"not hist_cut(t, {HIST_SHARE}): int32 "
                         f"({n_cuts}, 2)")
    d = _check(d, t.n_vox, "density", t)
    _aligned(t, "col", "val")
    cut = hist_cut(t) if t.cut is None else t.cut
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    return _launch(entry, t, y, (t.row_ptr, t.col, t.val, cut, d, y),
                   (t.n_rays, t.nnz, HIST_SHARE))


def routed_fwd_window(t: WindowTables, d):
    """y (R,) = A·d over the window chunk table, one CTA of
    ``WIN_FWD_THREADS`` a piece (``t.piece_ptr``); kernel
    ``routed_fwd_window``."""
    _f32_only("routed_fwd_window", t.val)
    if d.device.type == "cpu":
        return routed_fwd_window_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    _aligned(t, "loc", "val")
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    return _launch("routed_fwd_window", t, y,
                   (t.tile_ptr, t.ckey, t.cptr, t.loc, t.val, t.piece_ptr,
                    t.piece_chunk, d, y),
                   (t.n_win, t.n_rays, len(t.ckey), t.n_pieces, t.G, t.W,
                    WIN_FWD_THREADS))


def routed_bwd_window(t: WindowTables, dy):
    """dD (V,) = Aᵀ·dy over the window chunk table, one CTA a work item
    (``t.item_ptr``); kernel ``routed_bwd_window``."""
    _f32_only("routed_bwd_window", t.val)
    if dy.device.type == "cpu":
        return routed_bwd_window_ref(t, dy)
    dy = _check(dy, t.n_rays, "dy", t)
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    return _launch("routed_bwd_window", t, dD,
                   (t.win_ptr, t.item_ptr, t.item_win, t.bwd_order, t.ckey,
                    t.cptr, t.loc, t.val, dy, dD),
                   (t.n_win, t.n_vox, t.n_items, t.G, t.W))


def routed_fwd_densew(t: WindowTables, d):
    """y (R,) = A·d over the window chunk table, window-major, one CTA a
    work item (``t.item_ptr``), by global atomics; kernel
    ``routed_fwd_densew``."""
    entry = _entry("routed_fwd_densew", t.val)
    if d.device.type == "cpu":
        return routed_fwd_densew_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    return _launch(entry, t, y,
                   (t.item_ptr, t.item_win, t.bwd_order, t.ckey, t.cptr,
                    t.loc, t.val, d, y),
                   (t.n_win, t.n_rays, t.n_vox, t.n_items, t.G, t.W))


# TraceConfig.routed_dense -> the banded engine's forward and backward
# (operator.py:1341-1380 of the JAX package).  The TPU's VMEM-envelope
# clamps and the dense-slot rep-skew gate have no counterpart on the card:
# 'auto' always takes the gather backward, and a forced 'fwd'/'both'
# always runs the dense forward (without the JAX package's warning, whose
# numbers are TPU times).  Fused mode reads BACKWARDS alone.
FORWARDS = {"auto": routed_fwd, "bwd": routed_fwd, "off": routed_fwd,
            "fwd": routed_fwd_dense, "both": routed_fwd_dense}
BACKWARDS = {"auto": routed_bwd_gather, "bwd": routed_bwd_gather,
             "both": routed_bwd_gather, "off": routed_bwd_scatter,
             "fwd": routed_bwd_scatter}

# the tables each wrapper reads ('csr+cut': the CSR and its cut table)
_READS = {routed_fwd: "csr", routed_fwd_hist: "csr+cut",
          routed_bwd_scatter: "csr", routed_fwd_dense: "transpose",
          routed_bwd_gather: "transpose", routed_fwd_window: "window",
          routed_bwd_window: "window"}


def resolve(config):
    """The (forward, backward) wrappers of a routed-mode ``TraceConfig``:
    the window pair for ``routed_banded=False``, else :data:`FORWARDS` /
    :data:`BACKWARDS` by ``routed_dense``, with ``routed_fwd_reduce='hist'``
    taking the ray-tile forward unless the dense forward was chosen (then
    it gives way with a ``UserWarning``, operator.py:1028-1046 of the JAX
    package)."""
    if not config.routed_banded:
        return routed_fwd_window, routed_bwd_window
    fwd = FORWARDS[config.routed_dense]
    if config.routed_fwd_reduce == "hist":
        if fwd is routed_fwd_dense:
            warnings.warn(
                "routed_fwd_reduce='hist' requested but routed_dense="
                f"{config.routed_dense!r} selects the dense forward; running "
                "routed_fwd_dense instead (set routed_dense='off' or 'auto' "
                "for the hist kernel)", stacklevel=3)
        else:
            fwd = routed_fwd_hist
    return fwd, BACKWARDS[config.routed_dense]


def build_for(lin, lens, n_vox: int, *wrappers,
              w_dtype: torch.dtype = torch.float32):
    """The tables that ``wrappers`` read (:data:`_READS`), and nothing
    more, with weights of ``w_dtype``; a 'csr+cut' read adds the CSR's cut
    table (:func:`hist_cut` at :data:`HIST_SHARE`)."""
    reads = {_READS[w] for w in wrappers}
    if "window" in reads:
        return build_window_tables(lin, lens, n_vox, w_dtype=w_dtype)
    t = build_tables(lin, lens, n_vox, transpose="transpose" in reads,
                     csr=bool(reads & {"csr", "csr+cut"}), w_dtype=w_dtype)
    return t._replace(cut=hist_cut(t)) if "csr+cut" in reads else t


# ---------------------------------------------------------------------------
# the table cache
# ---------------------------------------------------------------------------

_TABLE_KINDS = {"RoutedTables": RoutedTables, "WindowTables": WindowTables}


def save_tables(path: str, t) -> None:
    """Write a table set (:class:`RoutedTables` or :class:`WindowTables`)
    as the directory ``path``: one ``.npy`` file a tensor (bfloat16 as its
    int16 bits) and ``meta.json`` (the class, its sizes, each tensor's
    dtype).  The directory is written under a temporary name and installed
    with one ``os.replace``, so a reader finds it whole or not at all; a
    writer that lost the race to another rank or process drops its own."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent,
                           prefix=os.path.basename(path) + ".tmp-")
    try:
        meta = {"kind": type(t).__name__, "tensors": {}, "ints": {},
                "none": []}
        for name, v in zip(t._fields, t):
            if v is None:  # a half the pair does not read
                meta["none"].append(name)
            elif isinstance(v, torch.Tensor):
                meta["tensors"][name] = str(v.dtype).split(".")[-1]
                if v.dtype == torch.bfloat16:
                    v = v.view(torch.int16)
                np.save(os.path.join(tmp, f"{name}.npy"),
                        v.detach().cpu().numpy())
            else:
                meta["ints"][name] = int(v)
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        try:
            os.replace(tmp, path)
        except OSError:
            if not os.path.isdir(path):
                raise
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_tables(path: str, device):
    """Read a table set written by :func:`save_tables` onto ``device``: the
    arrays are memory-mapped (copy on write), so on the CPU the tensors
    page in at first use and on a card they are copied once."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    fields = dict(meta["ints"], **dict.fromkeys(meta["none"]))
    for name, dtype in meta["tensors"].items():
        a = torch.from_numpy(np.load(os.path.join(path, f"{name}.npy"),
                                     mmap_mode="c"))
        if dtype == "bfloat16":
            a = a.view(torch.bfloat16)
        fields[name] = a.to(device)
    return _TABLE_KINDS[meta["kind"]](**fields)


class _RoutedProject(torch.autograd.Function):
    """y = fwd(tables, d), backward bwd(tables, dy): one (forward,
    backward) pair of wrappers over the tables both read."""

    @staticmethod
    def forward(ctx, d, tables, fwd, bwd):
        ctx.tables, ctx.bwd = tables, bwd
        return fwd(tables, d)

    @staticmethod
    def backward(ctx, dy):
        return ctx.bwd(ctx.tables, dy), None, None, None


def routed_project(d, tables, bwd=routed_bwd_gather, fwd=routed_fwd):
    """Differentiable y (R,) = A·d for a flat (V,) f32 density."""
    return _RoutedProject.apply(d, tables, fwd, bwd)
