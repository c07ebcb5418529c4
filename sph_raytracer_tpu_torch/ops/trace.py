"""Crossing assembly: sort, midpoint voxel labels, segment lengths.

Port of ``sph_raytracer_tpu/ops/trace.py`` (the 'sorted' pipeline).  Per
ray, all rays vectorized:

  1. r/e/a crossing distances (:mod:`.intersect`)         → M-1 candidates
  2. a ray-start pseudo-crossing at t=0, so behind-the-start exclusion is a
     per-segment ``t ≥ 0`` test
  3. a sort of the distances (values only; the order of equal distances
     moves only zero-length segments)
  4. segment lengths = diff of sorted distances, +inf for the last segment
  5. segment voxel labels by midpoint classification (:func:`_bin_segments`)

``M = 2(N_r+1) + 2(N_e+1) + (N_a+1) + 1`` crossings per ray.
``trace_method='ranked'`` runs this pipeline too: the JAX package's
``trace_crossings_ranked`` avoids a sort that is slow on a TPU and yields
the same (voxel, length) pairs, and the sort is fast on the card.
``voxel_order_*`` is not ported yet (ROADMAP A3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .intersect import (
    OUTSIDE,
    cone_crossings,
    plane_crossings,
    sphere_crossings,
)

__all__ = ["GridSpec", "trace_crossings", "pack_linear"]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Grid boundaries as hashable float tuples plus shape facts."""

    r_b: Tuple[float, ...]
    e_b: Tuple[float, ...]
    a_b: Tuple[float, ...]
    full_azimuth: bool
    ftype: torch.dtype = torch.float32

    @property
    def nr(self) -> int:
        return len(self.r_b) - 1

    @property
    def ne(self) -> int:
        return len(self.e_b) - 1

    @property
    def na(self) -> int:
        return len(self.a_b) - 1

    @property
    def vshape(self) -> Tuple[int, int, int]:
        return (self.nr, self.ne, self.na)

    @property
    def num_crossings(self) -> int:
        return 2 * (self.nr + 1) + 2 * (self.ne + 1) + (self.na + 1) + 1

    def arrays(self, device=None):
        return tuple(torch.tensor(b, dtype=self.ftype, device=device)
                     for b in (self.r_b, self.e_b, self.a_b))

    @classmethod
    def from_grid(cls, grid, ftype=torch.float32) -> "GridSpec":
        return cls(
            r_b=tuple(float(x) for x in grid.r_b),
            e_b=tuple(float(x) for x in grid.e_b),
            a_b=tuple(float(x) for x in grid.a_b),
            full_azimuth=grid.full_azimuth,
            ftype=ftype,
        )


def _bin_segments(gs: GridSpec, xs, rays_n, ts, lens_raw, itype):
    """Label segments by the voxel containing their midpoint (see the JAX
    module for why midpoint labels replace the reference's entered-region
    forward fill).

    Returns (regs (3, …, M) int, valid (…, M) bool); ``valid`` is True for
    forward (t ≥ 0), finite, positive-length, in-grid segments.
    """
    live = torch.isfinite(lens_raw) & (lens_raw > 0) & (ts >= 0)
    t_mid = torch.where(live, ts + lens_raw * 0.5, -1.0)
    p = xs[..., None, :] + t_mid[..., None] * rays_n[..., None, :]
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    xy = torch.hypot(px, py)
    vals = (torch.sqrt(px ** 2 + py ** 2 + pz ** 2), torch.atan2(xy, pz),
            torch.atan2(py, px))

    out = []
    statics = (gs.r_b, gs.e_b, gs.a_b)
    for axis, (b_host, bounds, v) in enumerate(
            zip(statics, gs.arrays(xs.device), vals)):
        if axis == 2 and (b_host[0] < -math.pi - 1e-12
                          or b_host[-1] > math.pi + 1e-12):
            # azimuth grid extends beyond atan2's (-π, π] range: wrap into
            # one period starting at the first boundary (jnp.mod semantics)
            v = bounds[0] + torch.remainder(v - bounds[0], 2 * math.pi)
        n = bounds.shape[0] - 1
        reg = torch.searchsorted(bounds, v.contiguous(),
                                 right=True).to(itype) - 1
        # exactly on the outer boundary counts as the last voxel
        reg = torch.where(v == bounds[-1], n - 1, reg)
        out.append(torch.where(live, reg, OUTSIDE))

    reg_r, reg_e, reg_a = out
    valid = (live
             & (reg_r >= 0) & (reg_r <= gs.nr - 1)
             & (reg_e >= 0) & (reg_e <= gs.ne - 1)
             & (reg_a >= 0) & (reg_a <= gs.na - 1))
    return torch.stack([reg_r, reg_e, reg_a], dim=0), valid


def trace_crossings(gs: GridSpec, xs, rays, itype=torch.int32, ftype=None):
    """Full crossing trace for a batch of rays.

    Args:
        gs: grid spec.
        xs: ray start positions (*rays, 3) tensor (broadcastable against
            ``rays``); the trace runs on its device.
        rays: ray directions (*rays, 3).

    Returns:
        regs: (3, *rays, M) voxel index triplet per sorted crossing
            (-1 where the segment is outside the grid or invalid).
        lens: (*rays, M) segment length per crossing; zero where invalid.
        ts: (*rays, M) sorted crossing distances.
    """
    ftype = ftype or gs.ftype
    xs = torch.as_tensor(xs, dtype=ftype)
    rays = torch.as_tensor(rays, dtype=ftype, device=xs.device)
    shape = torch.broadcast_shapes(xs.shape, rays.shape)
    xs = xs.expand(shape)
    rays = rays.expand(shape)
    rays_n = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)

    r_b, e_b, a_b = gs.arrays(xs.device)
    r_t = sphere_crossings(r_b, xs, rays, itype=itype, ftype=ftype)[0]
    e_t = cone_crossings(e_b, xs, rays, itype=itype, ftype=ftype)[0]
    a_t = plane_crossings(a_b, xs, rays, full_azimuth=gs.full_azimuth,
                          itype=itype, ftype=ftype)[0]
    ts = torch.cat([torch.zeros((*shape[:-1], 1), dtype=ftype,
                                device=xs.device), r_t, e_t, a_t], dim=-1)
    ts_s = torch.sort(ts, dim=-1).values

    lens_raw = torch.diff(ts_s, dim=-1, append=torch.full(
        (*ts_s.shape[:-1], 1), math.inf, dtype=ftype, device=xs.device))
    regs, valid = _bin_segments(gs, xs, rays_n, ts_s, lens_raw, itype)
    lens = torch.where(valid, lens_raw, 0.0)
    return regs, lens, ts_s


def pack_linear(regs, gs: GridSpec, itype=torch.int32):
    """Pack a (3, …, M) region triplet into flat voxel indices (…, M).

    Out-of-grid triplets (which always carry zero length) are clamped into
    range so gathers stay in bounds."""
    r = torch.clamp(regs[0], 0, gs.nr - 1)
    e = torch.clamp(regs[1], 0, gs.ne - 1)
    a = torch.clamp(regs[2], 0, gs.na - 1)
    return ((r * gs.ne + e) * gs.na + a).to(itype)
