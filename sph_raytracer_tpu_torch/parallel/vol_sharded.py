"""Volume-sharded operator: the density split over the mesh.

Port of ``sph_raytracer_tpu/parallel/vol_sharded.py``.  The ray-sharded
operator divides the table memory by the rays; this one divides it by the
volume.  The linear voxel ids, in the routed voxel order
(``routed_voxel_order``, applied first as at ``vol_sharded.py:237``) and
with the time offsets of a 4D grid added (a slab of a 4D grid is a range
of the flat ``T·V`` id), are split into contiguous ranges, one a rank.  A
rank keeps the tables of every ray over the crossings whose voxel lies in
its range, ids renumbered from the range's start, so the ranks' tables
hold each live crossing once and together weigh about one unsharded table
set.

Collectives, the mirror image of the ray sharding:

* forward: each rank's kernel on its slab of the density gives a partial
  image of every ray; one ``all_reduce`` of the image sums them (the
  ``psum`` at ``vol_sharded.py:135``);
* backward and ``.T``: each rank's adjoint kernel on the full ``dy`` gives
  its slab of the gradient; one ``all_reduce`` of a zero volume holding
  the slab gives every rank the full gradient (as the ray-sharded
  operator's, so ``retrieval.gd`` runs unchanged).  This is one collective
  the TPU path does not pay: there the gradient stays row-sharded
  (``vol_sharded.py:119-123``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import TraceConfig
from .mesh import Mesh
from .sharded import _ShardedBase, ray_range

__all__ = ["VolShardedOperator"]


class VolShardedOperator(_ShardedBase):
    """:class:`..operator.Operator` with the density sharded over the mesh
    (routed mode, float32: the CUDA kernels on each rank's slab tables).

    Args:
        grid / geom: as :class:`..operator.Operator`.
        mesh: :class:`.mesh.Mesh`; its device is this rank's.
        device: with no ``mesh``, the device :func:`.mesh.make_mesh` is
            given (``None``: the card).
        config: :class:`..config.TraceConfig`; its mode is replaced by
            ``'routed'``, and every routed knob (the kernel pair, the
            weight dtype, the voxel order) runs on each slab.
        ftype: overrides ``config.ftype``; only float32 is taken.
        view_times / dynamic: as :class:`..operator.Operator`.

    Same surface as :class:`.sharded.ShardedOperator`: ``__call__`` (the
    full image on every rank), ``.T``, autograd, ``payload`` /
    ``with_payload`` (this rank's slab tables)."""

    def __init__(self, grid, geom, mesh: Optional[Mesh] = None,
                 config: Optional[TraceConfig] = None, ftype=None,
                 view_times=None, dynamic=None, device=None):
        cfg = config or TraceConfig()
        if ftype is not None:
            cfg = cfg.replace(ftype=ftype)
        if cfg.ftype != torch.float32:
            raise ValueError(f"VolShardedOperator runs the routed kernels, "
                             f"whose tables are float32; got {cfg.ftype}")
        super().__init__(grid, geom, mesh, dynamic,
                         cfg.replace(mode="routed"), device,
                         view_times=view_times)

    def _build(self):
        m = self.mesh
        self._vox = ray_range(self._flat_size, m.size, m.rank)
        super()._build()

    def __repr__(self):
        return (f"VolShardedOperator({tuple(self.grid.shape)} → "
                f"{tuple(self.geom.shape)}, rank {self.mesh.rank} of "
                f"{self.mesh.size}, voxels [{self._vox[0]}, {self._vox[1]}))")
