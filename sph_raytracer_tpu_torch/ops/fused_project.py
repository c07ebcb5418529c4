"""Fused projection engine: the crossing trace runs inside a CUDA kernel.

Port of ``sph_raytracer_tpu/ops/fused_pallas.py``.  ``mode='fused'``
forward-projects without any per-crossing state in device memory: no
crossing tables, no CSR, no setup, O(1) memory per ray at any ray count.
Per ray, the kernel ``fused_fwd`` (``csrc/fused_project.cu``):

  1. computes all M boundary-crossing distances with the branchless
     intersection math of ``fused_pallas.py:156-225`` (sphere / cone /
     plane families, the snaps and the shadows), NaN -> +inf, a boundary
     a lane (both roots of a sphere or cone from one computation), and
     stages the finite ones in shared memory;
  2. sorts the S = pow2(count) first of them (a warp bitonic network in
     registers, S/32 a lane);
  3. takes segment lengths as adjacent differences and labels each live
     segment by the voxel of its midpoint through binary searches over the
     boundary tables (the azimuth by half-plane sign tests, no atan2), the
     segments from the first t >= 0 on, one a lane;
  4. sums ``density[code] · len``; with ``view_times`` (lerp) each segment
     also reads a second time bin, ``(1-w)·len`` at ``off0`` and ``w·len``
     at ``off1``.

Beside it: :func:`fused_fwd_ref`, the same per-ray algorithm in torch ops
on (block, Mp) tensors (the CPU path and the kernel's oracle on the card);
:func:`bwd_blockwise`, the re-trace backward (``trace_crossings`` +
``pack_linear`` + ``index_add_`` per block, ``_bwd_blockwise`` of the JAX
module, which is XLA there and plain torch here); and two autograd
Functions: :func:`fused_project` (``fused_bwd='retrace'``, the custom VJP of
``fused_pallas.py:575-646``) and :func:`fused_routed_project` (the forward
here, the backward a routed kernel on backward-only tables);
:func:`fused_pallas_project` is the JAX module's entry under its own name
and signature, over :func:`prep_rays` and :func:`fused_project`.

Scope (:func:`supported`): float32, ≤127 boundaries per axis, azimuth
boundaries within [-π, π] (the half-plane tests assume it), padded M ≤ 512
(the kernel sorts up to Mp/32 distances per lane in registers: 16 at the
cap, and stages Mp floats a warp in shared memory),
fewer than 2**30 linear voxels (int32 codes).  The JAX module's VMEM clause
has no counterpart: the density is gathered from global memory.

Knife-edge convention (as in the JAX module): a segment midpoint exactly on
a grid boundary may label to either neighbour voxel; the half-plane tests
here and the trace's atan2 + searchsorted round such ties differently at
f32.  Both labels are valid; integrals differ only by the density contrast
across that boundary.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import as_torch_dtype
from ._cuda import launch
from .trace import GridSpec, pack_linear, trace_crossings

__all__ = [
    "supported",
    "padded_crossings",
    "FusedRays",
    "prep_rays",
    "boundary_table",
    "fused_fwd",
    "fused_fwd_ref",
    "bwd_blockwise",
    "fused_project",
    "fused_routed_project",
    "fused_pallas_project",
]

INF = math.inf
# boundary-table layout shared with csrc/fused_project.cu (enum Row)
W = 128
(R2C, COS2, COS_UP, NOT_EQ, R2S, COS_E, SIN_A, COS_A, A_NEG, TOL) = range(10)
ROWS = 10


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def padded_crossings(gs: GridSpec) -> int:
    """Mp: the crossing count M padded to a power of two."""
    return _pow2(gs.num_crossings)


def supported(gs: GridSpec, n_flat: int) -> bool:
    """Whether this grid fits the fused engine's envelope."""
    if gs.ftype != torch.float32:
        return False
    if max(gs.nr, gs.ne, gs.na) + 1 > 127:
        return False
    if padded_crossings(gs) > 512:  # 16 distances per lane in registers
        return False
    # azimuth half-plane sign tests assume boundaries in [-π, π]
    if gs.a_b[0] < -np.pi - 1e-9 or gs.a_b[-1] > np.pi + 1e-9:
        return False
    if n_flat >= (1 << 30):  # linear codes must fit int32 comfortably
        return False
    return True


def _pad(vals, fill):
    out = np.full(W, fill, np.float32)
    out[: len(vals)] = np.asarray(vals, np.float32)
    return out


@functools.lru_cache(maxsize=16)
def _table_np(gs: GridSpec) -> np.ndarray:
    """The (ROWS, W) f32 boundary table; values rounded exactly as
    ``fused_pallas.py::_boundary_const`` rounds them."""
    r_b = np.asarray(gs.r_b, np.float32)
    e_b = np.asarray(gs.e_b, np.float32)
    a_b = np.asarray(gs.a_b, np.float32)
    ftol = float(np.finfo(np.float32).resolution)
    tol3 = ftol ** (1.0 / 3)   # isclose factor 3 (intersect.isclose)
    tol2 = ftol ** (1.0 / 2)   # factor 2 (cone discriminant snap)
    e64, a64 = e_b.astype(np.float64), a_b.astype(np.float64)
    tab = np.zeros((ROWS, W), np.float32)
    tab[R2C] = _pad(r_b ** 2, 0.0)                      # squared in f32
    tab[COS2] = _pad(np.cos(e64).astype(np.float32) ** 2, 0.0)
    tab[COS_UP] = _pad(np.cos(e64) >= 0, 0.0)
    tab[NOT_EQ] = _pad(~np.isclose(e_b, np.pi / 2, atol=tol3), 0.0)
    tab[R2S] = _pad(r_b.astype(np.float64) ** 2, INF)   # squared in f64
    tab[COS_E] = _pad(np.cos(e64), -INF)
    tab[SIN_A] = _pad(np.sin(a64), 0.0)
    tab[COS_A] = _pad(np.cos(a64), -1.0)
    tab[A_NEG] = _pad(a_b <= 0, 0.0)
    tab[TOL, :3] = (ftol, tol3, tol2)
    return tab


@functools.lru_cache(maxsize=16)
def boundary_table(gs: GridSpec, device) -> torch.Tensor:
    """The grid's boundary table as a small tensor on ``device``."""
    return torch.from_numpy(_table_np(gs)).to(device)


class FusedRays(NamedTuple):
    """Per-ray inputs of the fused engine, flat over the rays."""

    xs: torch.Tensor               # (R, 3) f32 starts
    dirs: torch.Tensor             # (R, 3) f32 unit directions
    off0: Optional[torch.Tensor]   # (R,) int32 time-bin offset t·V
    off1: Optional[torch.Tensor]   # (R,) int32 second bin (lerp)
    w: Optional[torch.Tensor]      # (R,) f32 weight of off1 (lerp)

    @property
    def n(self) -> int:
        return int(self.xs.shape[0])


def prep_rays(xs, rays, off0=None, off1=None, w=None,
              device=None) -> FusedRays:
    """Broadcast the starts to the rays, normalise the rays (in f32, as
    ``fused_pallas.py::_prep_geo``) and flatten the per-ray offsets."""
    xs = torch.as_tensor(xs, dtype=torch.float32, device=device)
    rays = torch.as_tensor(rays, dtype=torch.float32, device=xs.device)
    shape = torch.broadcast_shapes(xs.shape, rays.shape)
    xs = xs.expand(shape).reshape(-1, 3).contiguous()
    rays = rays.expand(shape).reshape(-1, 3)
    dirs = (rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
            ).contiguous()

    def flat(a, dtype):
        if a is None:
            return None
        a = torch.as_tensor(np.asarray(a), device=xs.device).to(dtype)
        return a.expand(shape[:-1]).reshape(-1).contiguous()

    return FusedRays(xs, dirs, flat(off0, torch.int32),
                     flat(off1, torch.int32), flat(w, torch.float32))


# ---------------------------------------------------------------------------
# plain version (the CPU path and the kernel's oracle)
# ---------------------------------------------------------------------------

def _crossings(gs: GridSpec, tab, xs, dirs):
    """All Mp crossing distances of each ray, unsorted, (B, Mp); invalid,
    missed and pad rows +inf.  fused_pallas.py:156-225 at f32."""
    ftol, tol3, tol2 = tab[TOL, 0], tab[TOL, 1], tab[TOL, 2]
    nrb, neb, nab = gs.nr + 1, gs.ne + 1, gs.na + 1
    r2, cos2 = tab[R2C, :nrb], tab[COS2, :neb]
    cos_up, not_eq = tab[COS_UP, :neb], tab[NOT_EQ, :neb]
    sin_a, cos_a = tab[SIN_A, :nab], tab[COS_A, :nab]
    xx, xy, xz = (xs[:, i:i + 1] for i in range(3))
    rx, ry, rz = (dirs[:, i:i + 1] for i in range(3))
    # spheres
    tc = -(xx * rx + xy * ry + xz * rz)
    cxx = xy * rz - xz * ry
    cyy = xz * rx - xx * rz
    czz = xx * ry - xy * rx
    d2 = cxx * cxx + cyy * cyy + czz * czz
    disc = r2 - d2
    t1c = torch.sqrt(torch.clamp_min(disc, 0.0))
    miss = disc < 0
    t_near = torch.where(miss, INF, tc - t1c)
    t_far = torch.where(miss, INF, tc + t1c)
    # cones
    rdx = rx * xx + ry * xy + rz * xz
    xx2 = xx * xx + xy * xy + xz * xz
    aa = rz * rz - cos2
    bb = 2.0 * (rz * xz - rdx * cos2)
    cc = xz * xz - xx2 * cos2
    aa = torch.where(torch.abs(aa) < tol3, 0.0, aa)
    delta = bb * bb - 4.0 * aa * cc
    delta = torch.where(torch.abs(delta) < tol2, 0.0, delta)
    neg = delta < 0
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    safe_aa = torch.where(aa == 0, 1.0, aa)
    t1 = torch.where(neg, INF, (-bb + sq) / (2.0 * safe_aa))
    t2 = torch.where(neg, INF, (-bb - sq) / (2.0 * safe_aa))
    is_single = (aa == 0) & (torch.abs(bb) >= tol3)
    th_near = torch.where(is_single, -cc / torch.where(bb == 0, 1.0, bb), t1)
    th_far = torch.where(is_single, INF, t2)
    dead = ((aa == 0) & (torch.abs(bb) < tol3)) | ((aa != 0) & neg)
    th_near = torch.where(dead, INF, th_near)
    th_far = torch.where(dead, INF, th_far)

    def cone_shadow(t):
        pz = xz + t * rz
        shadow = ((pz >= 0) != (cos_up > 0)) & (not_eq > 0)
        return torch.where(shadow & torch.isfinite(t), INF, t)

    th_near, th_far = cone_shadow(th_near), cone_shadow(th_far)
    # azimuth half-planes
    nxv = -sin_a * xx + cos_a * xy
    nrv = -sin_a * rx + cos_a * ry
    cross_z = cos_a * ry - sin_a * rx
    ta = torch.where(torch.abs(cross_z) <= ftol, INF,
                     -nxv / torch.where(nrv == 0, 1.0, nrv))
    pxa = xx + ta * rx
    pya = xy + ta * ry
    shadow_a = cos_a * pxa + sin_a * pya < 0
    ta = torch.where(shadow_a & torch.isfinite(ta), INF, ta)

    B, M, Mp = xs.shape[0], gs.num_crossings, padded_crossings(gs)
    ts = torch.cat([torch.zeros_like(tc), t_near, t_far, th_near, th_far, ta,
                    torch.full((B, Mp - M), INF, dtype=torch.float32,
                               device=xs.device)], dim=1)
    return torch.where(torch.isnan(ts), INF, ts)


def _segments(ts):
    """Lengths (+inf after the last) and the live mask of sorted ts."""
    lens = torch.cat([ts[:, 1:] - ts[:, :-1],
                      torch.full_like(ts[:, :1], INF)], dim=1)
    live = (torch.isfinite(lens) & (lens > 0) & (ts >= 0)
            & torch.isfinite(ts))
    return lens, live


def _bsearch(ok, nb, like):
    """pos = (# leading boundaries i with ok(i)) - 1 ∈ [-1, nb-1], per
    element of ``like``: the 7-step search of fused_pallas.py:243-254."""
    pos = torch.full(like.shape, -1, dtype=torch.long, device=like.device)
    for step in (64, 32, 16, 8, 4, 2, 1):
        cand = pos + step
        hit = ok(torch.clamp(cand, max=W - 1)) & (cand < nb)
        pos = torch.where(hit, cand, pos)
    return pos


def _codes(gs: GridSpec, tab, xs, dirs, ts, lens, live):
    """Midpoint voxel code (without the time offset) and validity of each
    segment (fused_pallas.py:284-316)."""
    t_mid = ts + lens * 0.5
    px = xs[:, 0:1] + t_mid * dirs[:, 0:1]
    py = xs[:, 1:2] + t_mid * dirs[:, 1:2]
    pz = xs[:, 2:3] + t_mid * dirs[:, 2:3]
    p2 = px * px + py * py + pz * pz
    pn = torch.sqrt(p2)

    def a_ok(i):
        crossge = tab[COS_A][i] * py - tab[SIN_A][i] * px >= 0
        alneg = tab[A_NEG][i] > 0.5
        return torch.where(py >= 0, alneg | crossge, alneg & crossge)

    rbin = _bsearch(lambda i: p2 >= tab[R2S][i], gs.nr + 1, p2)
    ebin = _bsearch(lambda i: pz <= pn * tab[COS_E][i], gs.ne + 1,
                   p2)
    abin = _bsearch(a_ok, gs.na + 1, p2)
    valid = (live
             & (rbin >= 0) & (rbin <= gs.nr - 1)
             & (ebin >= 0) & (ebin <= gs.ne - 1)
             & (abin >= 0) & (abin <= gs.na - 1))
    code = ((torch.clamp(rbin, 0, gs.nr - 1) * gs.ne
             + torch.clamp(ebin, 0, gs.ne - 1)) * gs.na
            + torch.clamp(abin, 0, gs.na - 1))
    return code, valid


def fused_fwd_ref(gs: GridSpec, rays: FusedRays, d, block: int = 8192):
    """y (R,) f32 for a flat f32 density: the kernel's algorithm in torch
    ops, ``block`` rays at a time."""
    tab = boundary_table(gs, d.device)
    y = torch.empty(rays.n, dtype=torch.float32, device=d.device)
    for i in range(0, rays.n, block):
        sl = slice(i, i + block)
        xs, dirs = rays.xs[sl], rays.dirs[sl]
        ts = torch.sort(_crossings(gs, tab, xs, dirs), dim=1).values
        lens, live = _segments(ts)
        code, valid = _codes(gs, tab, xs, dirs, ts, lens, live)
        wl = torch.where(valid, lens, 0.0)
        off0 = 0 if rays.off0 is None else rays.off0[sl, None].long()
        code = code + off0
        if rays.w is None:
            y[sl] = torch.sum(d[code] * wl, dim=1)
        else:
            wr = rays.w[sl, None]
            code1 = code - off0 + rays.off1[sl, None].long()
            y[sl] = torch.sum(d[code] * (wl * (1.0 - wr))
                              + d[code1] * (wl * wr), dim=1)
    return y


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check(x, shape, dtype, what, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{what} must be {dtype} of shape {shape} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def fused_fwd(gs: GridSpec, rays: FusedRays, d):
    """y (R,) = the fused projection of a flat f32 density; kernel
    ``fused_fwd``."""
    if d.device.type == "cpu":
        return fused_fwd_ref(gs, rays, d)
    if d.device.type != "cuda":
        raise ValueError(f"density is on {d.device}; the kernel takes CUDA "
                         "tensors (CPU tensors use the plain version)")
    if not supported(gs, d.shape[0]):
        raise ValueError("grid outside the fused engine's envelope (see "
                         "ops/fused_project.supported)")
    dev, R = d.device, rays.n
    _check(d, (d.shape[0],), torch.float32, "density", dev)
    _check(rays.xs, (R, 3), torch.float32, "xs", dev)
    _check(rays.dirs, (R, 3), torch.float32, "dirs", dev)
    for name in ("off0", "off1"):
        if getattr(rays, name) is not None:
            _check(getattr(rays, name), (R,), torch.int32, name, dev)
    if (rays.w is None) != (rays.off1 is None):
        raise ValueError("lerp needs both off1 and w")
    if rays.w is not None:
        _check(rays.w, (R,), torch.float32, "w", dev)
    y = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:  # a rank's empty share (..parallel): CUDA refuses the grid
        return y
    launch("fused_fwd",
           (rays.xs, rays.dirs, rays.off0, rays.off1, rays.w,
            boundary_table(gs, dev), d, y),
           (R, gs.nr, gs.ne, gs.na, padded_crossings(gs)))
    return y


# ---------------------------------------------------------------------------
# backward and autograd
# ---------------------------------------------------------------------------

def bwd_blockwise(gs: GridSpec, rays: FusedRays, g, n_flat: int,
                  block: int = 4096, itype=torch.int32):
    """dD (n_flat,) f32 for the fused forward: re-trace each block and
    scatter-add g·len (the checkpointing transpose: no residuals).  With
    lerp each crossing scatters into both time bins."""
    g = g.reshape(-1).to(torch.float32)
    dD = torch.zeros(n_flat, dtype=torch.float32, device=g.device)
    for i in range(0, rays.n, block):
        sl = slice(i, i + block)
        regs, lens, _ = trace_crossings(gs, rays.xs[sl], rays.dirs[sl],
                                        itype=itype)
        lin = pack_linear(regs, gs, itype=itype).long()
        if rays.off0 is not None:
            lin = lin + rays.off0[sl, None].long()
        w = g[sl, None] * lens.to(torch.float32)
        if rays.w is not None:
            wcol = rays.w[sl, None]
            lin2 = lin - rays.off0[sl, None].long() + rays.off1[sl, None].long()
            dD.index_add_(0, lin2.reshape(-1), (w * wcol).reshape(-1))
            w = w * (1.0 - wcol)
        dD.index_add_(0, lin.reshape(-1), w.reshape(-1))
    return dD


class _FusedProject(torch.autograd.Function):
    """y = fused_fwd(d); backward: the blockwise re-trace."""

    @staticmethod
    def forward(ctx, d, gs, rays, itype):
        ctx.gs, ctx.rays, ctx.itype, ctx.n = gs, rays, itype, d.shape[0]
        return fused_fwd(gs, rays, d)

    @staticmethod
    def backward(ctx, dy):
        return (bwd_blockwise(ctx.gs, ctx.rays, dy, ctx.n, itype=ctx.itype),
                None, None, None)


def fused_project(d, gs: GridSpec, rays: FusedRays, itype=torch.int32):
    """Differentiable fused projection (``fused_bwd='retrace'``)."""
    return _FusedProject.apply(d, gs, rays, itype)


class _FusedRouted(torch.autograd.Function):
    """y = fused_fwd(d); backward: a routed backward kernel ``bwd`` on
    backward-only tables (ops/routed_project.py)."""

    @staticmethod
    def forward(ctx, d, gs, rays, tables, bwd):
        ctx.tables, ctx.bwd = tables, bwd
        return fused_fwd(gs, rays, d)

    @staticmethod
    def backward(ctx, dy):
        return ctx.bwd(ctx.tables, dy.contiguous()), None, None, None, None


def fused_routed_project(d, gs: GridSpec, rays: FusedRays, tables, bwd):
    """Differentiable fused projection trained through ``bwd`` (one of
    ``routed_project.BACKWARDS``) on ``tables``."""
    return _FusedRouted.apply(d, gs, rays, tables, bwd)


def fused_pallas_project(gs: GridSpec, density_flat, xs, rays,
                         itype=torch.int32, interpret: bool = False,
                         view_offsets=None, view_offsets2=None,
                         view_w=None):
    """The JAX module's entry (``fused_pallas.py:576``): the fused forward
    projection of a flat density (V,) (T·V with ``view_offsets``) through
    rays (*rshape, 3), on the density's device, as (*rshape,) f32.
    ``view_offsets2`` / ``view_w`` lerp each segment between two time bins.
    Differentiable w.r.t. the density by the blockwise re-trace, as the
    JAX function's custom VJP.  ``interpret`` is accepted and ignored (a
    CPU density runs the kernel's plain version)."""
    d = torch.as_tensor(density_flat)
    rshape = np.broadcast_shapes(np.shape(xs), np.shape(rays))[:-1]
    frays = prep_rays(xs, rays, view_offsets, view_offsets2, view_w,
                      device=d.device)
    y = fused_project(d.to(torch.float32), gs, frays, as_torch_dtype(itype))
    return y.reshape(rshape)
