"""Volume-axis sharding: the density and its tables split over the ranks.

Port of ``examples/volume_sharded.py``.  The ray axis
(``multichip_scaling``) divides the work but keeps the whole volume on
every rank; the volume axis divides the tables, each rank holding the
crossings of its slab of voxels (``parallel.VolShardedOperator``): the
forward sums each rank's partial image over the ranks, the backward each
rank's slab of the gradient.  A 48³ grid and 12 views of 48×48 (27,648
rays), routed mode (``'auto'``), then one gradient step of
``mean((op(d) - y)²)`` timed over 3 calls, eager as in
``multichip_scaling``.  On the card each step runs ``routed_fwd`` and
``routed_bwd_gather`` on the slab tables.

The JAX script's ``TraceConfig(interpret=..., routed_g=...,
routed_bands=8, routed_chunk_multiple=2)`` sets the TPU lane layout,
which the port's tables do not have (those fields are accepted no-ops,
``config.py``), so this script drops them and the ``SPH_TPU_EXAMPLE_G``
knob.  ``SPH_TPU_EXAMPLE_GRID`` / ``_VIEWS`` shrink the run.  The process
group is made as in ``multichip_scaling``::

    python -m sph_raytracer_tpu_torch.examples.volume_sharded [--device cpu]
"""
from __future__ import annotations

from ..parallel import VolShardedOperator, make_mesh
from ._common import knob, parse_args, process_group
from .multichip_scaling import sharded_run


def run(device=None, n=48, nview=12, iters=3, mesh=None) -> dict:
    """The volume-sharded step, routed mode
    (:func:`.multichip_scaling.sharded_run`)."""
    return sharded_run(VolShardedOperator, n, nview, (n, n), iters, mesh,
                       device)


def plot(result, outdir=".") -> list:
    """The JAX script writes no figure; neither does this."""
    return []


def main(argv=None):
    args = parse_args(__doc__, argv)
    with process_group(args.device):
        mesh = make_mesh(device=args.device)
        res = run(n=knob("GRID", 48), nview=knob("VIEWS", 12), mesh=mesh)
        print(repr(res["op"]))
        dt = res["step_s"]
        print(f"fwd+bwd {dt * 1e3:.1f} ms/iter, {res['rays_per_s']:,.0f} "
              f"rays/s — density rows and tables split over {mesh.size} "
              f"devices (setup {res['setup_s']:.3f} s)")
    plot(res, args.outdir)


if __name__ == "__main__":
    main()
