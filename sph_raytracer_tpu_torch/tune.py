"""Routed-engine autotuner.

Port of ``sph_raytracer_tpu/tune.py``.  On the card the routed step's
speed depends on which pair of kernels runs and on the tables they read
(``routed_dense``, ``routed_fwd_reduce``, ``routed_banded``,
``routed_voxel_order``: the table in :mod:`.config`), and the best choice
shifts with the problem's shape.  :func:`autotune` measures a small set of
candidates end to end on the device its operators use and returns the
fastest :class:`~sph_raytracer_tpu_torch.config.TraceConfig`.

Each candidate costs one table build and a few timed steps on the first
call; the result persists to a JSON sidecar keyed by the grid, the
geometry, the base config and the card's name, and later calls read it
without building anything.

Usage::

    cfg = autotune(grid, geom)          # measures once, then cached
    op = Operator(grid, geom, config=cfg)
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .config import TraceConfig

__all__ = ["autotune", "DEFAULT_CANDIDATES", "GRID_CANDIDATES"]

# Fields that change the kernel pair or the tables' layout on the card.
# routed_w_dtype='bf16' is left out: it changes the result, and the tuner
# picks among configurations that compute the same operator.
DEFAULT_CANDIDATES: Tuple[dict, ...] = (
    {"routed_dense": "auto"},
    {"routed_dense": "off"},
    {"routed_dense": "fwd"},
    {"routed_dense": "both"},
    {"routed_fwd_reduce": "hist"},
    {"routed_banded": False},
    {"routed_voxel_order": "r"},
)

# the wider sweep for crossing-dense problems (vol100 and up): every
# kernel pair in both voxel orders
GRID_CANDIDATES: Tuple[dict, ...] = tuple(
    dict(c, routed_voxel_order=vo)
    for c in DEFAULT_CANDIDATES[:-1] for vo in ("a", "r"))

_K = 6  # chained steps a timing run (the production metric, below)
_METRIC = f"eager-step-x{_K}"


def _norm_candidate(c) -> dict:
    """A candidate is a dict of TraceConfig fields to replace, or the JAX
    package's ``(routed_bands, routed_band_rows)`` pair, which is accepted
    and changes nothing on the card (both fields are TPU layout knobs)."""
    if isinstance(c, dict):
        return dict(c)
    b, r = c
    return {"routed_bands": int(b), "routed_band_rows": int(r)}


def _sig(grid, geom, device_name: str, config: TraceConfig) -> str:
    """The sidecar's key: grid, geometry, base config and the device's
    name (prefixed so it never collides with a JAX package sidecar)."""
    h = hashlib.sha256()
    h.update(repr(tuple(grid.shape)).encode())
    for a in (grid.r_b, grid.e_b, grid.a_b):
        h.update(np.asarray(a, np.float64).tobytes())
    h.update(np.asarray(geom.ray_starts, np.float64).tobytes())
    h.update(np.asarray(geom.rays, np.float64).tobytes())
    h.update(f"torch/{device_name}/{config!r}/v1".encode())
    return h.hexdigest()[:24]


def autotune(grid, geom, candidates: Optional[Sequence] = None,
             config: Optional[TraceConfig] = None, ftype=None,
             iters: int = 6, cache: bool = True, cached_only: bool = False,
             verbose: bool = False, force: bool = False,
             device=None) -> TraceConfig:
    """Measure candidate routed configurations and return the fastest.

    Args:
        grid / geom: as :class:`~sph_raytracer_tpu_torch.operator.Operator`.
        candidates: iterable of dicts of TraceConfig fields (default
            :data:`DEFAULT_CANDIDATES`); the JAX package's
            ``(routed_bands, routed_band_rows)`` pairs are accepted and are
            no-ops on the card.
        config: base config; tuned fields are replaced.
        iters: timing iterations a candidate (slope timing,
            :func:`.utils.profiling.time_fn`).
        cache: persist / reuse the result (JSON in ``SPH_TPU_TUNE_CACHE``,
            default ``~/.cache/sph_raytracer_tpu``).
        cached_only: never measure: the cached result if there is one,
            else the base config unchanged.
        verbose: print each candidate's time and the leader's
            confirmation to stderr.
        force: ignore an existing sidecar entry and re-measure (the
            result still overwrites it).
        device: the device the operators use (``None``: ``"cuda"``, which
            raises without a card).

    Returns:
        The base config with ``mode='routed'`` and the fastest candidate's
        fields.

    A candidate whose tables do not fit (``OverflowError`` of the int32
    tables, or the card's memory) is skipped and reported on stderr every
    time; any other error, a kernel that fails to build or launch
    included, is raised.
    """
    from .operator import Operator, resolve_device
    from .utils.profiling import time_fn

    device = resolve_device(device)
    base = (config or TraceConfig()).replace(mode="routed")
    if ftype is not None:
        base = base.replace(ftype=ftype)
    candidates = [_norm_candidate(c)
                  for c in (candidates or DEFAULT_CANDIDATES)]

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    cdir = os.environ.get("SPH_TPU_TUNE_CACHE") or os.path.expanduser(
        "~/.cache/sph_raytracer_tpu")
    cpath = os.path.join(cdir, f"tune_{_sig(grid, geom, name, base)}.json")
    saved = None
    if cache and not force and os.path.exists(cpath):
        with open(cpath) as fh:
            saved = json.load(fh)
        if saved.get("metric") != _METRIC and not cached_only:
            saved = None
    if saved is not None:
        if verbose:
            print(f"[autotune] cached: {saved['fields']}", file=sys.stderr)
        return base.replace(**saved["fields"])
    if cached_only and not force:
        return base

    gen = torch.Generator().manual_seed(0)
    x = torch.rand(tuple(grid.shape), generator=gen,
                   dtype=torch.float64).to(device=device, dtype=base.ftype)
    ops = {}

    # the production metric: K chained steps of forward → mean-square
    # loss → gradient → d - 1e-3·g, run eagerly as retrieval.gd runs them
    def measure(i):
        if i not in ops:
            op = Operator(grid, geom, config=base.replace(**candidates[i]),
                          device=device)
            with torch.no_grad():
                ops[i] = (op, op(x))
        op, y = ops[i]

        def chunk():
            d = x
            for _ in range(_K):
                v = d.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(torch.mean((op(v) - y) ** 2), v)
                d = v.detach() - 1e-3 * g
            return d

        return time_fn(chunk, iters=max(2, iters // 2)) / _K

    results = []
    for i, fields in enumerate(candidates):
        try:
            t = measure(i)
        except (OverflowError, torch.cuda.OutOfMemoryError) as e:
            ops.pop(i, None)
            print(f"[autotune] {fields}: skipped, {type(e).__name__}: "
                  f"{str(e)[:160]}", file=sys.stderr)
            continue
        results.append((t, i))
        if verbose:
            print(f"[autotune] {fields}: {t * 1e3:.4f} ms/step "
                  f"[eager-chained x{_K}]", file=sys.stderr)
    if not results:
        raise RuntimeError("autotune: every candidate was skipped")
    results.sort()
    # confirm the leader: a slope timing can glitch low under host jitter;
    # re-measure the leader, keep the slower of its two readings, and
    # re-sort until the leader's confirmation agrees within 1.4x
    confirms = []
    for _ in range(min(3, len(results))):
        t, i = results[0]
        t2 = measure(i)
        confirms.append({"fields": candidates[i], "ms": [t * 1e3, t2 * 1e3]})
        if verbose:
            print(f"[autotune] confirm {candidates[i]}: {t * 1e3:.4f} -> "
                  f"{t2 * 1e3:.4f} ms/step", file=sys.stderr)
        results[0] = (max(t, t2), i)
        results.sort()
        if results[0][1] == i and t2 <= 1.4 * t:
            break
    ops.clear()
    t, i = results[0]
    fields = candidates[i]
    if cache:
        os.makedirs(cdir, exist_ok=True)
        with open(cpath, "w") as fh:
            json.dump({"fields": fields, "ms_per_step": t * 1e3,
                       "metric": _METRIC, "device": name,
                       "confirm": confirms,
                       "all": [{"fields": candidates[j], "ms": tt * 1e3}
                               for tt, j in results]}, fh)
    return base.replace(**fields)
