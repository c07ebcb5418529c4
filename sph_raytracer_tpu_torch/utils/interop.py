"""Retrieval state carried across from the JAX package.

``sph_raytracer_tpu.retrieval.gd`` checkpoints the pytree
``(coeffs, optax.adam state)`` as ``.npz`` leaves (its
utils/checkpoint.py:20-35).  For ``optax.adam`` those leaves are, in
order: the coefficients, the step count, the first moment ``mu`` and the
second moment ``nu``.  ``torch.optim.Adam`` keeps the same three
quantities per parameter as ``step``, ``exp_avg`` and ``exp_avg_sq``, and
its update is the same function of them (bias-corrected first moment over
the bias-corrected root second moment plus eps), so a retrieval started
on the JAX package resumes in the port from the converted state.
Geometry and grids cross as the numpy boundaries and ray arrays they
already are.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["adam_state_from_jax", "adam_state_to_jax"]


def adam_state_from_jax(leaves, device=None):
    """``[coeffs, count, mu, nu]`` (numpy, as the JAX checkpoint stores
    them) → ``(coeffs tensor, torch.optim.Adam per-parameter state)``.

    The state dict is what ``optimizer.state[coeffs]`` holds: ``step``
    (a CPU float32 scalar tensor, as torch keeps it), ``exp_avg`` and
    ``exp_avg_sq`` on the coefficients' device and dtype."""
    if len(leaves) != 4:
        raise ValueError(f"expected [coeffs, count, mu, nu] leaves of an "
                         f"optax.adam retrieval state, got {len(leaves)}")
    coeffs, count, mu, nu = (np.asarray(x) for x in leaves)
    c = torch.as_tensor(coeffs, device=device)
    state = {
        "step": torch.tensor(float(count), dtype=torch.float32),
        "exp_avg": torch.as_tensor(mu, dtype=c.dtype, device=c.device),
        "exp_avg_sq": torch.as_tensor(nu, dtype=c.dtype, device=c.device),
    }
    return c, state


def adam_state_to_jax(coeffs, state):
    """Inverse of :func:`adam_state_from_jax`: numpy leaves
    ``[coeffs, count (int32), mu, nu]`` in the JAX checkpoint's order."""
    def host(x):
        return x.detach().cpu().numpy()

    return [host(coeffs), np.asarray(int(state["step"]), dtype=np.int32),
            host(state["exp_avg"]), host(state["exp_avg_sq"])]
