"""The JAX package's ``examples/`` scripts, ported: one module each.

Each module has ``run(device=None, **sizes)``, which does all the
computing at the JAX script's sizes (``device=None`` is the card) and
returns tensors and numbers; ``plot(result, outdir=".")``, which writes
the script's figures with matplotlib (imported there, so a machine
without it can still ``run``); and ``main()``, which prints the script's
lines::

    python -m sph_raytracer_tpu_torch.examples.<name> [--device cpu] [--outdir DIR]

The package's top-level ``__init__`` does not import these modules.
"""

__all__ = [
    "single_vantage",
    "static_retrieval",
    "dynamic_measurements",
    "sph_harm_retrieval",
    "poisson_retrieval",
    "aot_serving",
    "memory_usage",
    "multichip_scaling",
    "volume_sharded",
]
