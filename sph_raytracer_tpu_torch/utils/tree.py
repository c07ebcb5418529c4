"""Nested containers of tensors: the port's pytrees.

A tree is a leaf (a tensor, or anything that is not a container) or a
dict, list or tuple of trees.  Dict leaves come in sorted-key order, the
order of ``jax.tree.leaves``, so the leaves of a checkpoint line up with
the JAX package's.  ``retrieval.gd`` optimizes every leaf of its
coefficients and ``solve`` runs its Krylov and EM updates leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Iterable

import torch

__all__ = ["leaves", "unflatten", "tree_map", "vdot", "axpy", "where"]


def leaves(tree: Any) -> list:
    """The leaves of ``tree``, depth-first, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for s in tree for x in leaves(s)]
    return [tree]


def unflatten(like: Any, new_leaves: Iterable) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(s) for s in t)
        return next(it)

    return build(like)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])


def vdot(a: Any, b: Any) -> torch.Tensor:
    """Sum over leaves of ``<a_i, b_i>``, a 0-d tensor in the leaves'
    promoted dtype (float64 leaves sum in float64)."""
    parts = [torch.vdot(x.reshape(-1), y.reshape(-1))
             for x, y in zip(leaves(a), leaves(b))]
    return sum(parts[1:], start=parts[0])


def axpy(alpha, x: Any, y: Any) -> Any:
    """``y + alpha * x`` leaf by leaf."""
    return tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def where(c, a: Any, b: Any) -> Any:
    """``torch.where(c, a_i, b_i)`` leaf by leaf."""
    return tree_map(lambda ai, bi: torch.where(c, ai, bi), a, b)
