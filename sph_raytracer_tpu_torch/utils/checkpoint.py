"""Checkpoint / resume for retrieval state.

Port of ``sph_raytracer_tpu/utils/checkpoint.py`` with the same ``.npz``
format: the state's leaves as ``leaf_0 … leaf_{n-1}`` plus
``__iteration__``, written atomically.  Leaves are flattened depth-first
from nested tuples / lists / dicts (dict keys in sorted order, as
``jax.tree.leaves`` orders them), so a file written by either package
holds its leaves in the same order.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "tree_leaves"]


def tree_leaves(state: Any) -> list:
    """Leaves of nested tuples / lists / dicts, depth-first."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in tree_leaves(state[k])]
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in tree_leaves(s)]
    return [state]


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(s, leaves) for s in like)
    return next(leaves)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, state: Any, iteration: int) -> None:
    """Atomically save ``state``'s leaves and an iteration counter."""
    arrays = {f"leaf_{i}": _numpy(x)
              for i, x in enumerate(tree_leaves(state))}
    arrays["__iteration__"] = np.asarray(iteration)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: Any = None
                    ) -> Optional[Tuple[Any, int]]:
    """Load a checkpoint written by either package's ``save_checkpoint``.

    Args:
        path: checkpoint file.
        like: nested structure to unflatten into (its leaves give the
            numpy dtypes); ``None`` returns the flat list of leaves.

    Returns:
        (state, iteration) with numpy leaves, or None if ``path`` does
        not exist.
    """
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [np.asarray(data[f"leaf_{i}"]) for i in range(n)]
        iteration = int(data["__iteration__"])
    if like is None:
        return leaves, iteration
    like_leaves = tree_leaves(like)
    if len(like_leaves) != n:
        raise ValueError(f"checkpoint {path} has {n} leaves, expected "
                         f"{len(like_leaves)}")
    leaves = [lf.astype(_numpy(l).dtype) for lf, l in zip(leaves, like_leaves)]
    return _unflatten(like, iter(leaves)), iteration
