"""Precomputed-table forward projection and adjoint backprojection.

Port of the precomputed mode of ``sph_raytracer_tpu/ops/project.py``: the
crossing tables are traced once (blocked, so the dense (block, M)
temporaries stay bounded) and cached as packed (linear-index, length)
pairs; the forward is a gather-multiply-reduce and autograd's backward of
it is a scatter-add.  This is ``mode='precomputed'``, the CPU default, the
float64 path and the oracle the routed kernels are held against.
``project_fused`` is not ported yet (ROADMAP A6).
"""
from __future__ import annotations

import torch

from .trace import GridSpec, pack_linear, trace_crossings

__all__ = ["precompute_table", "project_table", "backproject_table"]


def precompute_table(gs: GridSpec, xs, rays, block: int = 8192,
                     itype=torch.int32, device=None):
    """Trace all rays once, returning packed (lin, lens) tables.

    Args:
        xs, rays: (*rshape, 3) ray starts and directions (arrays or
            tensors; broadcast against each other), converted to
            ``gs.ftype`` on ``device``.
        block: rays traced per step; peak memory is O(block·M).

    Returns (lin (R, M) int, lens (R, M) float, R, rshape).
    """
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
