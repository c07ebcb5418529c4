"""Utility subsystems: checkpointing, the JAX-state interop, the per-LOS
debug tracer (``debug``), profiling and timing (``profiling``) and the
serving export (``export``).  The JAX package's names are re-exported
here as there (``from ..utils import export_operator``)."""
from . import debug, export, profiling  # noqa: F401
from .checkpoint import load_checkpoint, save_checkpoint
from .debug import debug_trace, format_trace
from .export import export_operator, load_exported
from .interop import adam_state_from_jax, adam_state_to_jax

__all__ = ["save_checkpoint", "load_checkpoint", "debug_trace",
           "format_trace", "profiling", "export_operator", "load_exported",
           "adam_state_from_jax", "adam_state_to_jax", "debug", "export"]
