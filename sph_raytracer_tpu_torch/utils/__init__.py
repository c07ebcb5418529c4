"""Utility subsystems: checkpointing, the JAX-state interop, the per-LOS
debug tracer (``debug``), profiling and timing (``profiling``) and the
serving export (``export``)."""
from . import debug, export, profiling  # noqa: F401
from .checkpoint import load_checkpoint, save_checkpoint
from .interop import adam_state_from_jax, adam_state_to_jax

__all__ = ["save_checkpoint", "load_checkpoint", "adam_state_from_jax",
           "adam_state_to_jax", "debug", "export", "profiling"]
