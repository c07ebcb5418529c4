"""Ray-sharded projection: the distributed operator.

Port of ``sph_raytracer_tpu/parallel/sharded.py``.  The rays (detector
pixels × views, flattened) are split into contiguous ranges, one a rank;
the volume is replicated.  Each rank traces and keeps only its rays'
tables (or, in fused mode, its rays) and runs the single-device kernels on
them; the mode, the kernel pair and every other knob resolve as for
:class:`..operator.Operator`, and every knob runs on each rank's share (so
the JAX package's "not plumbed through the sharded build" warnings have no
counterpart here).

What a rank sees, as in the JAX package: ``sop(x)`` is the **full** image
on every rank, and the gradient with respect to ``x`` the full gradient.

* forward: the rank's kernel on its rays, placed in a zero image of every
  ray and summed over the mesh (one ``all_reduce`` of the image: ranges
  may differ in length, and a sum with zeros adds nothing, so each ray's
  value is the kernel's own);
* backward (``torch.autograd``) and ``.T``: the rank's adjoint on its
  slice of ``dy`` (the backward of :class:`..operator.Operator`'s own
  forward in that mode; ``.T`` its adjoint), the density gradients summed
  over the mesh (one ``all_reduce`` of the volume, the counterpart of the
  ``psum`` at ``parallel/sharded.py:143``), so ``retrieval.gd`` and
  ``solve.cg`` run unchanged on every rank.

A rank whose range holds no ray still takes part in both collectives
(with zeros), so a mesh larger than the rays does not hang.

:func:`sharded_project` is the JAX module's function of the same name: the
fused projection of each rank's rays (:func:`shard_rays`), summed into
the image of every ray on every rank, differentiable as the operator is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TraceConfig, as_torch_dtype
from ..operator import Operator
from ..ops.fused_project import fused_project, prep_rays
from ..ops.project import project_fused
from ..ops.routed_project import WIN_G, routed_fwd_window
from ..ops.trace import GridSpec, voxel_order_unflat
from .mesh import RAY_AXIS, Mesh, make_mesh

__all__ = ["ShardedOperator", "shard_rays", "sharded_project", "ray_range"]


def ray_range(n: int, size: int, rank: int, block: int = 1):
    """Rank ``rank``'s contiguous range ``(lo, hi)`` of ``n`` items split
    over ``size`` ranks in whole runs of ``block``: ceil(n / block / size)
    blocks a rank, so the last ranks' ranges may be shorter, or empty."""
    per = -(-(-(-n // block)) // size) * block
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def shard_rays(mesh: Mesh, xs, rays, axis: str = RAY_AXIS, block: int = 1):
    """Flatten the ray arrays (broadcast against each other) and take this
    rank's contiguous range of them (:func:`ray_range`).

    The JAX package pads the rays to a multiple of the mesh with rays that
    miss the grid; here the ranges differ in length instead.  ``axis`` is
    the mesh's axis name (``ValueError`` for another).

    Returns ``(xs (n_rank, 3), rays (n_rank, 3), n, ray_shape)``, float64
    numpy, with ``n`` the number of rays of every rank together."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    xs = np.asarray(xs, dtype=np.float64)
    rays = np.asarray(rays, dtype=np.float64)
    shape = np.broadcast_shapes(xs.shape, rays.shape)
    n = int(np.prod(shape[:-1]))
    lo, hi = ray_range(n, mesh.size, mesh.rank, block)
    return (np.broadcast_to(xs, shape).reshape(-1, 3)[lo:hi].copy(),
            np.broadcast_to(rays, shape).reshape(-1, 3)[lo:hi].copy(), n,
            tuple(shape[:-1]))


def _placed(mesh: Mesh, local, span, n, like):
    """``local`` (C, hi - lo; None: zeros of ``like``'s dtype) at columns
    ``span`` = (lo, hi) of a zero (C, n) tensor, summed over ``mesh``."""
    if local is not None and tuple(span) == (0, n):
        return mesh.all_reduce(local.contiguous())
    out = like.new_zeros((like.shape[0], n), dtype=(
        like.dtype if local is None else local.dtype))
    if local is not None:
        out[:, span[0]:span[1]] = local
    return mesh.all_reduce(out)


class _Summed(torch.autograd.Function):
    """The sharded forward ``x2 → Σ_ranks A_rank·x2``, differentiable.
    Each rank runs ``local_fwd``, a differentiable forward of its share
    (for the operators :meth:`..operator.Operator._fwd_local`, every
    mode's autograd as it is; None where it holds no work) on ``x2``,
    keeping that local graph; the piece is placed at the rank's columns
    ``rows`` of the (C, n) result and summed over the mesh, and in the
    backward the gradient the local graph gives for ``dy[:, rows]`` is
    summed over ``mesh``, so every rank takes part in both collectives,
    with zeros where it holds no ray or no voxel."""

    @staticmethod
    def forward(ctx, x2, local_fwd, mesh, rows, n):
        with torch.enable_grad():
            xl = x2.detach().requires_grad_(True)
            local = local_fwd(xl)
        ctx.mesh, ctx.rows, ctx.xl, ctx.local = mesh, rows, xl, local
        # a copy: the sum runs in place, and ``local`` roots the backward
        return _placed(mesh, None if local is None else
                       local.detach().clone(), rows, n, x2)

    @staticmethod
    def backward(ctx, dy):
        lo, hi = ctx.rows
        g = None
        if ctx.local is not None:
            (g,) = torch.autograd.grad(ctx.local, ctx.xl, dy[:, lo:hi],
                                       allow_unused=True)
        g = torch.zeros_like(ctx.xl) if g is None else g.contiguous()
        ctx.xl = ctx.local = None
        return ctx.mesh.all_reduce(g), None, None, None, None


def _sharded_forward(mesh: Mesh, x2, local_fwd, rows, n):
    """The (C, n) image of every rank's rays on every rank: each rank's
    ``local_fwd(x2)`` at its columns ``rows``, summed over ``mesh``;
    differentiable (:class:`_Summed`) where ``x2`` asks for a gradient.
    The one placement and reduction of the sharded operators and
    :func:`sharded_project`."""
    if torch.is_grad_enabled() and x2.requires_grad:
        return _Summed.apply(x2, local_fwd, mesh, rows, n)
    return _placed(mesh, local_fwd(x2), rows, n, x2)


def sharded_project(mesh: Mesh, gs: GridSpec, flat2, xs, rays, off, block,
                    itype_name, axis: str = RAY_AXIS, pallas: bool = False,
                    interpret: bool = False, off2=None, w=None):
    """Fused projection with the rays sharded and the volume replicated
    (the JAX module's ``sharded_project``), called on every rank of
    ``mesh``.

    Args:
        flat2: (C, V) volume (C, T·V with ``off``), channels flattened.
        xs / rays / off: this rank's rays, as :func:`shard_rays` gives
            them, and their per-ray time offsets t·V (zeros for a static
            grid).
        block: rays a block of the blockwise re-trace.
        itype_name: the index dtype, a name or any dtype.
        pallas: run the fused engine (``fused_fwd``) on the rank's rays
            instead of the blockwise re-trace; ``off2`` / ``w`` (lerp
            between two time bins) need it, as in the JAX package.
        interpret: accepted and ignored (CPU tensors run the kernel's
            plain version).

    Returns the (C, n) image of every rank's rays on every rank (the JAX
    function returns it ray-sharded, padded to the mesh), differentiable
    w.r.t. ``flat2``: the gradient is summed over the mesh.  Two
    collectives a forward (the ranks' ray counts, the image) and one a
    backward."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if w is not None and not pallas:
        raise ValueError("lerp (off2 / w) needs the fused engine, "
                         "pallas=True")
    flat2 = torch.as_tensor(flat2, device=mesh.device)
    if pallas:  # the fused engine computes in float32
        flat2 = flat2.to(torch.float32)
    itype = as_torch_dtype(itype_name)
    k = int(np.shape(xs)[0])
    counts = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    counts[mesh.rank] = k
    counts = mesh.all_reduce(counts).tolist()
    lo = sum(counts[:mesh.rank])

    def local_fwd(x2):
        if k == 0:
            return None
        if not pallas:
            return project_fused(gs, x2, xs, rays, view_offsets=off,
                                 block=block, itype=itype)
        frays = prep_rays(xs, rays, off, off2, w, device=x2.device)
        return torch.stack([fused_project(x, gs, frays, itype) for x in x2])

    return _sharded_forward(mesh, flat2, local_fwd, (lo, lo + k),
                            sum(counts))


class _ShardedBase(Operator):
    """What the ray- and the volume-sharded operators add to
    :class:`..operator.Operator`, whose per-mode forward and adjoint run on
    this rank's rays ``_rows`` and voxels ``_vox``: each result placed in a
    zero tensor of every ray (or voxel) and summed over the mesh."""

    def __init__(self, grid, geom, mesh: Optional[Mesh] = None, dynamic=None,
                 config: Optional[TraceConfig] = None, device=None, **kw):
        if mesh is not None and device is not None:
            raise ValueError("pass device= to make_mesh, or a mesh, not "
                             "both (the mesh holds this rank's device)")
        self.mesh = make_mesh(device=device) if mesh is None else mesh
        if self.mesh.rank < 0:
            raise ValueError("this rank is not in the mesh (make_mesh gave "
                             "it rank -1)")
        super().__init__(grid, geom, dynamic=dynamic, config=config,
                         device=self.mesh.device, **kw)

    def _empty(self):
        return self._rows[0] == self._rows[1] or self._vox[0] == self._vox[1]

    def _local_fwd(self, x2):
        """This rank's forward of ``x2`` (C, every voxel, in the tables'
        order) on its voxels, or None where it holds no work."""
        return None if self._empty() else self._fwd_local(
            x2[:, self._vox[0]:self._vox[1]])

    def __call__(self, density):
        """Forward projection: the full ``(*channels, *geom.shape)`` image
        on every rank (see the module docstring)."""
        density = torch.as_tensor(density, device=self.device)
        gshape = tuple(self.grid.shape)
        if tuple(density.shape[-len(gshape):]) != gshape:
            raise ValueError(f"density shape {tuple(density.shape)} does "
                             f"not end with grid shape {gshape}")
        chan = density.shape[: -len(gshape)]
        x2 = self._kernel_in(density.reshape(-1, self._flat_size))
        out = _sharded_forward(self.mesh, x2, self._local_fwd, self._rows,
                               self._nrays)
        return out.reshape(tuple(chan) + self._rshape)

    def T(self, line_integrations):
        """Adjoint backprojection: the full ``(*channels, *grid.shape)``
        density on every rank."""
        y = torch.as_tensor(line_integrations, device=self.device)
        chan = y.shape[: y.dim() - len(self._rshape)]
        y2 = y.reshape(-1, self._nrays)
        if self._kernel_dtype() is not None:
            y2 = y2.to(self._kernel_dtype())
        lo, hi = self._rows
        local = None if self._empty() else self._bwd_local(y2[:, lo:hi])
        out = _placed(self.mesh, local, self._vox, self._flat_size, y2)
        out = voxel_order_unflat(out, self.grid.vshape, self._vorder)
        return out.reshape(*chan, *self.grid.shape)


class ShardedOperator(_ShardedBase):
    """Drop-in :class:`..operator.Operator` with the rays sharded over a
    mesh and the volume replicated.

    Args:
        grid / geom: as :class:`..operator.Operator`.
        mesh: :class:`.mesh.Mesh`; its device is this rank's.
        dynamic / config / mode / ftype / itype / view_times / ...: as
            :class:`..operator.Operator`.  Each rank traces and builds the
            tables of its own rays alone (``config.sharded_local_build`` is
            accepted and changes nothing); the window tables
            (``routed_banded=False``) split in whole tiles of
            :data:`..ops.routed_project.WIN_G` rays.
        device: with no ``mesh``, the device :func:`.mesh.make_mesh` is
            given for its mesh of every rank of the default group
            (``None``: the card).  It comes after the JAX package's
            parameters (``grid, geom, mesh, dynamic, config``).

    Usage::

        distributed_init()
        op = ShardedOperator(grid, geom, mesh=make_mesh())
        image = op(density)                     # every rank: the full image
        torch.mean((op(d) - y) ** 2).backward() # d.grad: the full gradient
    """

    def _build(self):
        m = self.mesh
        block = WIN_G if self._fwd is routed_fwd_window else 1
        self._rows = ray_range(self._nrays, m.size, m.rank, block)
        super()._build()

    def __repr__(self):
        return (f"ShardedOperator({tuple(self.grid.shape)} → "
                f"{tuple(self.geom.shape)}, rank {self.mesh.rank} of "
                f"{self.mesh.size}, rays [{self._rows[0]}, {self._rows[1]}))")
