"""Retrieval state carried across from the JAX package.

``sph_raytracer_tpu.retrieval.gd`` checkpoints the pytree
``(coeffs, optax.adam state)`` as ``.npz`` leaves (its
utils/checkpoint.py:20-35).  For ``optax.adam`` over coefficients of n
leaves those are, in order: the n coefficient leaves, the step count, the
n first moments ``mu`` and the n second moments ``nu`` (3n + 1 leaves;
dict leaves in sorted-key order).  ``torch.optim.Adam`` keeps the same
three quantities per parameter as ``step``, ``exp_avg`` and
``exp_avg_sq``, and its update is the same function of them
(bias-corrected first moment over the bias-corrected root second moment
plus eps), so a retrieval started on the JAX package resumes in the port
from the converted state.  Geometry and grids cross as the numpy
boundaries and ray arrays they already are.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["adam_state_from_jax", "adam_state_to_jax"]


def adam_state_from_jax(leaves, device=None):
    """``[*coeffs, count, *mu, *nu]`` (numpy, as the JAX checkpoint stores
    them) → ``(coeffs, torch.optim.Adam per-parameter state)``.

    A state dict is what ``optimizer.state[param]`` holds: ``step`` (a CPU
    float32 scalar tensor, as torch keeps it), ``exp_avg`` and
    ``exp_avg_sq`` on the coefficients' device and dtype.  With one
    coefficient leaf (4 leaves) this returns the tensor and its dict; with
    n > 1 leaves, a list of n tensors and a list of n dicts, in the
    checkpoint's leaf order."""
    n, rem = divmod(len(leaves) - 1, 3)
    if rem or n < 1:
        raise ValueError(f"expected [*coeffs, count, *mu, *nu] leaves of an "
                         f"optax.adam retrieval state (3n + 1 of them), got "
                         f"{len(leaves)}")
    arrs = [np.asarray(x) for x in leaves]
    count = float(arrs[n])
    cs, states = [], []
    for c_np, mu, nu in zip(arrs[:n], arrs[n + 1:2 * n + 1],
                            arrs[2 * n + 1:]):
        c = torch.as_tensor(c_np, device=device)
        cs.append(c)
        states.append({
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.as_tensor(mu, dtype=c.dtype, device=c.device),
            "exp_avg_sq": torch.as_tensor(nu, dtype=c.dtype,
                                          device=c.device),
        })
    return (cs[0], states[0]) if n == 1 else (cs, states)


def adam_state_to_jax(coeffs, state):
    """Inverse of :func:`adam_state_from_jax`: numpy leaves ``[*coeffs,
    count (int32), *mu, *nu]`` in the JAX checkpoint's order.  ``coeffs``
    and ``state`` are a tensor and its dict, or lists of them."""
    if isinstance(coeffs, torch.Tensor):
        coeffs, state = [coeffs], [state]

    def host(x):
        return x.detach().cpu().numpy()

    return ([host(c) for c in coeffs]
            + [np.asarray(int(state[0]["step"]), dtype=np.int32)]
            + [host(s["exp_avg"]) for s in state]
            + [host(s["exp_avg_sq"]) for s in state])
