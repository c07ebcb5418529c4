"""Precomputed-table forward projection and adjoint backprojection.

Port of the precomputed mode of ``sph_raytracer_tpu/ops/project.py``: the
crossing tables are traced once (blocked, so the dense (block, M)
temporaries stay bounded) and cached as packed (linear-index, length)
pairs; the forward is a gather-multiply-reduce and autograd's backward of
it is a scatter-add.  This is ``mode='precomputed'``, the CPU default, the
float64 path and the oracle the routed kernels are held against.

``project_fused`` is the blockwise fused path (``mode='fused'`` with
``fused_backend='xla'``, float64, or a grid outside the fused kernel's
envelope): each ray block is re-traced on the fly and reduced, so the
(rays, M) crossing tables never exist; ``torch.utils.checkpoint`` around
the block makes autograd re-run the trace in the backward instead of
keeping it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import as_torch_dtype
from .trace import GridSpec, pack_linear, trace_crossings

__all__ = ["precompute_table", "project_table", "backproject_table",
           "project_fused"]


def precompute_table(gs: GridSpec, xs, rays, block: int = 8192,
                     itype=torch.int32, method: str = "sorted",
                     platform: str = "", device=None):
    """Trace all rays once, returning packed (lin, lens) tables.

    Args:
        xs, rays: (*rshape, 3) ray starts and directions (arrays or
            tensors; broadcast against each other), converted to
            ``gs.ftype`` on ``device``.
        block: rays traced per step; peak memory is O(block·M).
        itype: a torch, numpy or JAX dtype or its name.
        method / platform: accepted and ignored.  The JAX package's
            'ranked' trace gives the same (voxel, length) pairs as its
            'sorted' one without a sort, which is slow on a TPU; the port
            runs the sorted trace for both (``ops.trace``).

    Returns (lin (R, M) int, lens (R, M) float, R, rshape).
    """
    itype = as_torch_dtype(itype)
    xs = torch.as_tensor(xs, dtype=gs.ftype, device=device)
    rays = torch.as_tensor(rays, dtype=gs.ftype, device=xs.device)
    shape = torch.broadcast_shapes(xs.shape, rays.shape)
    xs = xs.expand(shape).reshape(-1, 3)
    rays = rays.expand(shape).reshape(-1, 3)
    n, M = xs.shape[0], gs.num_crossings
    lin = torch.empty((n, M), dtype=itype, device=xs.device)
    lens = torch.empty((n, M), dtype=gs.ftype, device=xs.device)
    for i in range(0, n, block):
        regs, lens_b, _ = trace_crossings(gs, xs[i:i + block],
                                          rays[i:i + block], itype=itype)
        lin[i:i + block] = pack_linear(regs, gs, itype=itype)
        lens[i:i + block] = lens_b
    return lin, lens, n, tuple(shape[:-1])


def project_table(density_flat, lin, lens):
    """Forward projection from a precomputed table.

    Args:
        density_flat: (..., V) volume with spatial dims flattened; leading
            dims broadcast as channels.
        lin: (R, M) packed voxel indices.
        lens: (R, M) segment lengths (zero where invalid).

    Returns (..., R) line integrals.
    """
    vals = density_flat[..., lin.long()]  # (..., R, M)
    return torch.sum(vals * lens.to(vals.dtype), dim=-1)


def backproject_table(y, lin, lens, volume_size: int):
    """Adjoint: scatter-add y·lens into a flat volume (reference
    Operator.T, raytracer.py:715-748).

    Args:
        y: (..., R) line integrals (leading dims = channels).
        lin: (R, M) packed voxel indices.
        lens: (R, M) lengths.

    Returns (..., volume_size) flat density.
    """
    weights = y[..., None] * lens.to(y.dtype)  # (..., R, M)
    lead = weights.shape[:-2]
    out = torch.zeros((*lead, volume_size), dtype=y.dtype, device=y.device)
    return out.index_add_(-1, lin.reshape(-1).long(),
                          weights.reshape(*lead, -1))


def project_fused(gs: GridSpec, density_flat, xs, rays, view_offsets=None,
                  block: int = 2048, itype=torch.int32):
    """Fused forward projection: re-trace each ray block on the fly.

    Peak memory is O(block·M).  Differentiable w.r.t. ``density_flat``: the
    block body runs under ``torch.utils.checkpoint``, so the backward
    re-traces and scatter-adds instead of keeping the crossings.

    Args:
        density_flat: (..., V) flat volume (or (..., T·V) for dynamic grids
            with ``view_offsets``); leading dims are channels.
        xs, rays: (*rshape, 3) ray geometry, traced in ``gs.ftype`` on the
            density's device.
        view_offsets: optional (*rshape,) per-ray linear offsets (t·V) of
            the binned 4D volume.

    Returns (..., *rshape) line integrals.
    """
    itype = as_torch_dtype(itype)
    dev = density_flat.device
    xs = torch.as_tensor(xs, dtype=gs.ftype, device=dev)
    rays = torch.as_tensor(rays, dtype=gs.ftype, device=dev)
    shape = torch.broadcast_shapes(xs.shape, rays.shape)
    xs = xs.expand(shape).reshape(-1, 3)
    rays = rays.expand(shape).reshape(-1, 3)
    off = (None if view_offsets is None else torch.as_tensor(
        view_offsets, device=dev).long().expand(shape[:-1]).reshape(-1))

    def blk(d, xs_b, rays_b, off_b):
        regs, lens, _ = trace_crossings(gs, xs_b, rays_b, itype=itype)
        lin = pack_linear(regs, gs, itype=itype).long()
        if off_b is not None:
            lin = lin + off_b[:, None]
        vals = d[..., lin]  # (..., B, M)
        return torch.sum(vals * lens.to(vals.dtype), dim=-1)

    run = blk
    if torch.is_grad_enabled() and density_flat.requires_grad:
        def run(*args):
            return checkpoint(blk, *args, use_reentrant=False)
    out = torch.cat([
        run(density_flat, xs[i:i + block], rays[i:i + block],
            None if off is None else off[i:i + block])
        for i in range(0, xs.shape[0], block)], dim=-1)
    return out.reshape(tuple(out.shape[:-1]) + tuple(shape[:-1]))
