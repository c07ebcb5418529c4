"""Utility subsystems: checkpointing and the JAX-state interop.
``debug``, ``export`` and ``profiling`` are not ported yet (ROADMAP A10)."""
from .checkpoint import load_checkpoint, save_checkpoint
from .interop import adam_state_from_jax, adam_state_to_jax

__all__ = ["save_checkpoint", "load_checkpoint", "adam_state_from_jax",
           "adam_state_to_jax"]
