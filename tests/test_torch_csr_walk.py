"""The walk of ``routed_fwd`` (B1) and ``routed_bwd_gather`` (B2), emulated.

Both kernels (``csrc/routed_project.cu``, ``csr_group_dot``) give each CSR
row a group of L lanes (``FWD_LANES`` / ``BWD_LANES``): a warp holds 32 / L
rows, whose row pointers it loads at once (rows past the table's last read
an empty row at its end and store nothing), and lane g of a group takes the
row's aligned quads g, g + L, g + 2L, ... (U = ``FWD_QUADS`` /
``BWD_QUADS`` a step), the crossings of a quad outside the row masked.  The
lane sums its crossings in order (one FMA each), the group sums its lanes
by shuffles in a fixed tree, lane 0 stores the row.

The plain emulation below takes the same groups, quads and masks on
synthetic tables whose rows hold 0, 1, 3, 4, 5, a group step ± 1, two
steps and more crossings, each starting at every offset mod 4, at row
counts ≡ 1, 2, 3 (mod the rows a CTA holds, so the last warp and CTA are
part full): every crossing is taken exactly once, by its own row, and the
emulated sum equals the plain version.  The kernels themselves run on the
card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch

from sph_raytracer_tpu_torch.ops import routed_project as rp

WARP = 32
# kernel: (lanes a row, quads a lane a step, longest row); the longest rows
# of the flagship: 160 crossings a ray, 671 a voxel
WALKS = {"routed_fwd": (rp.FWD_LANES, rp.FWD_QUADS, 160),
         "routed_bwd_gather": (rp.BWD_LANES, rp.BWD_QUADS, 671)}


def _lengths(step, longest, rows_a_cta, residue):
    """Row lengths: each length of interest after a pad row (0-3
    crossings) that makes it start at each offset mod 4, then empty rows
    up to a count ≡ ``residue`` (mod ``rows_a_cta``)."""
    out, pos = [], 0
    for n in (0, 1, 3, 4, 5, step - 1, step, step + 1, 2 * step + 3,
              longest):
        for off in range(4):
            pad = (off - pos) % 4
            out += [pad, n]
            pos += pad + n
    while len(out) % rows_a_cta != residue:
        out.append(0)
    return out


def _table(kernel, lengths, n_cols, seed):
    """A RoutedTables whose rows (rays for B1, voxels for B2) have
    ``lengths``: column ids drawn from ``n_cols``, lengths in (0, 1]."""
    rng = np.random.default_rng(seed)
    ptr = torch.tensor(np.r_[0, np.cumsum(lengths)], dtype=torch.int32)
    nnz = int(ptr[-1])
    idx = torch.tensor(rng.integers(0, n_cols, nnz), dtype=torch.int32)
    w = torch.tensor(1 - rng.random(nnz), dtype=torch.float32)
    if kernel == "routed_fwd":
        return rp.RoutedTables(ptr, idx, w, None, None, None, len(lengths),
                               n_cols)
    return rp.RoutedTables(None, None, None, ptr, idx, w, n_cols,
                           len(lengths))


def _walk(ptr, idx, w, x, lanes, quads, block=rp.CSR_BLOCK):
    """The kernel's walk over CSR (ptr, idx, w) on x, in plain torch:
    (out, taken), ``taken[k]`` the times crossing k was summed."""
    n = ptr.shape[0] - 1
    nnz = idx.shape[0]
    rows = -(-n * lanes // block) * (block // lanes)  # the grid's groups
    assert rows % (WARP // lanes) == 0 and rows >= n
    # each warp's row pointers, clamped at the table's end
    p = ptr.long()[torch.clamp(torch.arange(rows + 1), max=n)]
    beg, end = p[:-1], p[1:]
    a0 = beg & ~3
    nq = torch.where(end > beg, (end - a0 + 3) // 4, 0)
    row = torch.repeat_interleave(torch.arange(rows), nq)
    j = torch.arange(row.shape[0]) - (torch.cumsum(nq, 0) - nq)[row]
    k = a0[row, None] + 4 * j[:, None] + torch.arange(4)    # (quads, 4)
    live = (k >= beg[row, None]) & (k < end[row, None])
    taken = torch.bincount(k[live], minlength=nnz)
    # every crossing taken by its own row, and only by rows < n
    owner = rp._row_ids(ptr, nnz)
    assert bool((owner[k[live]] == row[:, None].expand_as(k)[live]).all())
    assert bool((row < n).all())
    # lane g of a row's group takes quads g, g + L, ...: its j-th in order
    g, pos = j % lanes, j // lanes
    # (U quads a step issue their loads together; the sum is in quad order)
    steps = int(pos.max()) + 1 if pos.numel() else 0
    prod_x = torch.zeros(rows, lanes, steps, 4, dtype=torch.float64)
    prod_w = torch.zeros_like(prod_x)
    mask = torch.zeros(rows, lanes, steps, 4, dtype=torch.bool)
    kk = torch.clamp(k, max=nnz - 1)
    prod_x[row, g, pos] = torch.where(live, x[idx.long()[kk]], 0).double()
    prod_w[row, g, pos] = torch.where(live, w[kk], 0).double()
    mask[row, g, pos] = live
    acc = torch.zeros(rows, lanes, dtype=torch.float32)
    for s in range(steps):
        for i in range(4):
            # fmaf: one rounding of x·w + acc (x·w is exact in float64)
            fma = (prod_x[:, :, s, i] * prod_w[:, :, s, i]
                   + acc.double()).float()
            acc = torch.where(mask[:, :, s, i], fma, acc)
    off = lanes // 2
    while off:  # the group's shuffle tree; lane 0 holds the row
        acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:n, 0], taken


@pytest.mark.parametrize("residue", [1, 2, 3])
@pytest.mark.parametrize("kernel", sorted(WALKS))
def test_csr_walk(kernel, residue):
    lanes, quads, longest = WALKS[kernel]
    lengths = _lengths(4 * lanes * quads, longest, rp.CSR_BLOCK // lanes,
                       residue)
    t = _table(kernel, lengths, 37, residue)
    fwd = kernel == "routed_fwd"
    ptr, idx, w = ((t.row_ptr, t.col, t.val) if fwd
                   else (t.vox_ptr, t.ray, t.valT))
    starts = ptr[:-1].long() % 4
    for n in (1, 3, 4, 5, 4 * lanes * quads + 1, longest):
        assert set(starts[torch.diff(ptr) == n].tolist()) == {0, 1, 2, 3}
    x = torch.tensor(np.random.default_rng(7).random(
        t.n_vox if fwd else t.n_rays), dtype=torch.float32)
    got, taken = _walk(ptr, idx, w, x, lanes, quads)
    assert bool((taken == 1).all())
    want = (rp.routed_fwd_ref if fwd else rp.routed_bwd_gather_ref)(t, x)
    assert not bool(got[torch.diff(ptr) == 0].any())
    # (float32 sums in another order than the plain version's)
    tol = 1e-6 * float(want.abs().max()) + 1e-6 * want.abs()
    assert bool(((got - want).abs() <= tol).all())
