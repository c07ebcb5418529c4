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
:data:`WIN_W` voxels) chunks, 8 B a crossing, and the backward's work
items (each window's chunks cut into runs of at most :data:`WIN_K`
crossings, 8 B an item).

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

:func:`resolve` maps a ``TraceConfig`` to its (forward, backward) pair and
:func:`build_for` builds the tables that pair reads.

A wrapper runs the plain version only because the tensor it was given
lies on the CPU; for a CUDA tensor it launches the kernel or raises.  The
library is built from the sources in this package with ``nvcc`` at first
use (:func:`load_library`, in :mod:`._cuda`); there is no fallback.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from ._cuda import LAUNCHES, launch, load_library, reset_launches

__all__ = [
    "RoutedTables",
    "WindowTables",
    "WIN_G",
    "WIN_W",
    "WIN_K",
    "SCATTER_TILE",
    "SCATTER_SLOTS",
    "scatter_atomics",
    "build_tables",
    "build_window_tables",
    "build_for",
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
    was not."""

    row_ptr: Optional[torch.Tensor]
    col: Optional[torch.Tensor]
    val: Optional[torch.Tensor]
    vox_ptr: Optional[torch.Tensor]
    ray: Optional[torch.Tensor]
    valT: Optional[torch.Tensor]
    n_rays: int
    n_vox: int

    @property
    def nnz(self) -> int:
        return int((self.col if self.col is not None else self.ray).shape[0])

    @property
    def device(self) -> torch.device:
        return (self.col if self.col is not None else self.ray).device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self[:6]
                   if t is not None)


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


def build_tables(lin, lens, n_vox: int, transpose: bool = True,
                 csr: bool = True) -> RoutedTables:
    """Build the CSR tables from a traced (lin (R, M), lens (R, M)) pair on
    the tables' device.  Zero-length slots are dropped.

    ``transpose`` adds the voxel-major transpose; ``csr=False`` then drops
    the ray-major CSR (the voxel-major kernels do not read it)."""
    R, live, counts, nnz = _live(lin, lens, n_vox)
    dev = lin.device
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    col = lin[live].to(torch.int32)
    val = lens[live].to(torch.float32)
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


# The window chunk table's tile and window sizes, chosen for the card: at
# the flagship (250,000 rays, 125,000 voxels) the forward launches 245 CTAs,
# more than the H100's 132 SMs, and a CTA's eight chunk groups stage G + 8·W
# floats of shared memory (12 KB; csrc/routed_variants.cu).  The in-chunk
# offsets are packed in 16 bits each (G <= 32768 keeps the packed word
# non-negative).
WIN_G = 1024
WIN_W = 256
# the backward's work item: at most this many crossings (a larger chunk is
# an item of its own); the flagship's hottest window holds ~141,700
# crossings and its largest chunk ~2,400 (tools/bwd_sweep.py times others)
WIN_K = 4096


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
      ``win_ptr`` (n_win+1,) each window's range in it (the window-major
      walk of ``routed_fwd_densew``);
    * ``item_ptr`` (n_items+1,) the backward's work items as ranges of
      ``bwd_order``, and ``item_win`` (n_items,) the window of each: every
      non-empty window's range cut greedily at chunk boundaries into runs
      of at most ``K`` crossings (a chunk of more is an item alone); an
      empty window has no item."""

    loc: torch.Tensor
    val: torch.Tensor
    cptr: torch.Tensor
    ckey: torch.Tensor
    tile_ptr: torch.Tensor
    bwd_order: torch.Tensor
    win_ptr: torch.Tensor
    item_ptr: torch.Tensor
    item_win: torch.Tensor
    n_rays: int
    n_vox: int
    G: int
    W: int
    K: int

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
    def device(self) -> torch.device:
        return self.loc.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self[:9])


def _work_items(n, win_ptr, K):
    """The backward's work items over chunks of sizes ``n`` (in
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


def build_window_tables(lin, lens, n_vox: int, G: int = WIN_G,
                        W: int = WIN_W, K: int = WIN_K) -> WindowTables:
    """Build the window chunk table, and the backward's work items of at
    most ``K`` crossings, from a traced (lin, lens) pair on its device
    (zero-length slots dropped)."""
    if not (0 < G <= 2 ** 15 and 0 < W <= 2 ** 16):
        raise ValueError(f"tile G={G} / window W={W} must fit 15 / 16 bits")
    if 4 * (G + 8 * W) > 48 * 1024:
        raise ValueError(f"tile G={G} / window W={W}: the window forward's "
                         "shared memory would pass 48 KB")
    if K < 1:
        raise ValueError(f"work item size K={K} must be positive")
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
    val = lens[live].to(torch.float32)[order]
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
    return WindowTables(loc, val, cptr, ckey.to(torch.int32),
                        ptr(ctile, n_tiles), bwd_order.to(torch.int32),
                        win_ptr, item_ptr, item_win, R, n_vox, G, W, K)


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


def routed_fwd(t: RoutedTables, d):
    """y (R,) = A·d for a flat (V,) density; kernel ``routed_fwd``."""
    if t.row_ptr is None:
        raise ValueError("routed_fwd needs the ray-major CSR (these are "
                         "backward-only tables for the gather)")
    if d.device.type == "cpu":
        return routed_fwd_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    launch("routed_fwd", (t.row_ptr, t.col, t.val, d, y), (t.n_rays,))
    return y


def routed_bwd_gather(t: RoutedTables, dy):
    """dD (V,) = Aᵀ·dy, deterministic; kernel ``routed_bwd_gather``."""
    if t.vox_ptr is None:
        raise ValueError("routed_bwd_gather needs the voxel-major "
                         "transpose (build_tables(..., transpose=True))")
    if dy.device.type == "cpu":
        return routed_bwd_gather_ref(t, dy)
    dy = _check(dy, t.n_rays, "dy", t)
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    launch("routed_bwd_gather", (t.vox_ptr, t.ray, t.valT, dy, dD),
           (t.n_vox,))
    return dD


def routed_bwd_scatter(t: RoutedTables, dy, counts=None):
    """dD (V,) = Aᵀ·dy over the ray-major CSR, summed by voxel in each
    ray tile before its global atomics; kernel ``routed_bwd_scatter``.

    ``counts``, an int32 CUDA tensor of shape (2,), gathers (adds to) the
    global atomics the kernel issues and the crossings that overflowed its
    tile's table; the plain version ignores it."""
    if t.row_ptr is None:
        raise ValueError("routed_bwd_scatter needs the ray-major CSR")
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
    launch("routed_bwd_scatter", (t.row_ptr, t.col, t.val, dy, dD, counts),
           (t.n_rays, t.n_vox, SCATTER_TILE, SCATTER_SLOTS))
    return dD


def routed_fwd_dense(t: RoutedTables, d):
    """y (R,) = A·d over the voxel-major transpose, by atomics; kernel
    ``routed_fwd_dense``."""
    if t.vox_ptr is None:
        raise ValueError("routed_fwd_dense needs the voxel-major transpose "
                         "(build_tables(..., transpose=True))")
    if d.device.type == "cpu":
        return routed_fwd_dense_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    launch("routed_fwd_dense", (t.vox_ptr, t.ray, t.valT, d, y),
           (t.n_vox, t.n_rays))
    return y


def routed_fwd_hist(t: RoutedTables, d):
    """y (R,) = A·d, one CTA per ray tile; kernel ``routed_fwd_hist``."""
    if t.row_ptr is None:
        raise ValueError("routed_fwd_hist needs the ray-major CSR")
    if d.device.type == "cpu":
        return routed_fwd_hist_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    launch("routed_fwd_hist", (t.row_ptr, t.col, t.val, d, y), (t.n_rays,))
    return y


def routed_fwd_window(t: WindowTables, d):
    """y (R,) = A·d over the window chunk table; kernel
    ``routed_fwd_window``."""
    if d.device.type == "cpu":
        return routed_fwd_window_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    launch("routed_fwd_window",
           (t.tile_ptr, t.ckey, t.cptr, t.loc, t.val, d, y),
           (t.n_win, t.n_rays, t.n_vox, t.G, t.W))
    return y


def routed_bwd_window(t: WindowTables, dy):
    """dD (V,) = Aᵀ·dy over the window chunk table, one CTA a work item
    (``t.item_ptr``); kernel ``routed_bwd_window``."""
    if dy.device.type == "cpu":
        return routed_bwd_window_ref(t, dy)
    dy = _check(dy, t.n_rays, "dy", t)
    dD = torch.empty(t.n_vox, dtype=torch.float32, device=dy.device)
    launch("routed_bwd_window",
           (t.win_ptr, t.item_ptr, t.item_win, t.bwd_order, t.ckey, t.cptr,
            t.loc, t.val, dy, dD),
           (t.n_win, t.n_vox, t.n_items, t.G, t.W))
    return dD


def routed_fwd_densew(t: WindowTables, d):
    """y (R,) = A·d over the window chunk table, window-major, by atomics;
    kernel ``routed_fwd_densew``."""
    if d.device.type == "cpu":
        return routed_fwd_densew_ref(t, d)
    d = _check(d, t.n_vox, "density", t)
    y = torch.empty(t.n_rays, dtype=torch.float32, device=d.device)
    launch("routed_fwd_densew",
           (t.win_ptr, t.bwd_order, t.ckey, t.cptr, t.loc, t.val, d, y),
           (t.n_win, t.n_rays, t.n_vox, t.G, t.W))
    return y


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

# the table each wrapper reads
_READS = {routed_fwd: "csr", routed_fwd_hist: "csr",
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


def build_for(lin, lens, n_vox: int, *wrappers):
    """The tables that ``wrappers`` read, and nothing more."""
    reads = {_READS[w] for w in wrappers}
    if "window" in reads:
        return build_window_tables(lin, lens, n_vox)
    return build_tables(lin, lens, n_vox, transpose="transpose" in reads,
                        csr="csr" in reads)


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
