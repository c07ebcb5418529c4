"""Multi-GPU parallelism on ``torch.distributed``.

Port of ``sph_raytracer_tpu/parallel/``: one process a GPU, NCCL between
them (gloo only when the caller asks for the CPU).

* :func:`make_mesh` / :func:`distributed_init`: the process group and this
  rank's place in it (:class:`.mesh.Mesh`).
* :class:`ShardedOperator`: the rays sharded over the ranks, the volume
  replicated; the image and the density gradient summed over the mesh.
* :class:`VolShardedOperator`: the volume sharded, every ray on every rank.
* :func:`shard_rays`: this rank's contiguous range of the rays.
"""
from .mesh import distributed_init, make_mesh
from .sharded import ShardedOperator, shard_rays
from .vol_sharded import VolShardedOperator

__all__ = ["make_mesh", "distributed_init", "ShardedOperator",
           "shard_rays", "VolShardedOperator"]
