"""Profiling helpers: a ``torch.profiler`` trace and step timing.

Port of ``sph_raytracer_tpu/utils/profiling.py``.  :func:`time_fn` keeps
the JAX package's contract (``tune.autotune`` ranks with it): the slope of
two chained runs, one retry at 4x the iterations, then the chained-run
average, announced on stderr.
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from .tree import leaves

__all__ = ["trace", "time_fn", "fetch_sync"]


@contextlib.contextmanager
def trace(logdir: str = None):
    """``with profiling.trace(logdir): ...``: profile the block with
    ``torch.profiler`` (the CUDA activity too when a card is present) and
    write a Chrome trace, viewable in Perfetto, to
    ``logdir/trace_<ns>.json`` (default directory: under the system's
    temporary directory).  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(),
                              "sph_raytracer_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def fetch_sync(x):
    """Wait for the device and read one element of each tensor (or
    array) leaf of ``x`` (a tensor or a dict / list / tuple of them);
    returns those elements as a list of numpy arrays, as the JAX
    package's ``fetch_sync`` does."""
    ls = [l for l in leaves(x) if hasattr(l, "reshape")]
    if any(isinstance(l, torch.Tensor) and l.is_cuda for l in ls):
        torch.cuda.synchronize()
    return [l.detach().reshape(-1)[:1].cpu().numpy()
            if isinstance(l, torch.Tensor) else np.asarray(l).ravel()[:1]
            for l in ls]


def time_fn(f: Callable, *args, iters: int = 10, warmup: int = 1,
            baseline_iters: int = 2) -> float:
    """Seconds an iteration of ``f(*args)`` by two chained timed runs
    (the slope removes the constant dispatch and sync overhead)."""
    def run(n):
        o = None
        for _ in range(n):
            o = f(*args)
        fetch_sync(o)

    for _ in range(warmup):
        run(1)

    def slope(n_iters):
        t0 = time.perf_counter()
        run(baseline_iters)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(baseline_iters + n_iters)
        t2 = time.perf_counter() - t0
        return (t2 - t1) / n_iters, t2 / (baseline_iters + n_iters)

    # host jitter can exceed the work of a fast f, driving the slope to ~0
    # or below: retry longer, then fall back to the chained-run average
    # (an upper bound that still holds the constant overhead), announced
    # so that a caller comparing candidates (tune.py) sees which it got
    dt, avg = slope(iters)
    if dt <= 0:
        dt, avg = slope(4 * iters)
    if dt <= 0:
        print(f"[time_fn] slope non-positive twice; falling back to "
              f"chained-run average {avg * 1e3:.3f} ms (upper bound: "
              f"includes constant dispatch/sync overhead)",
              file=sys.stderr)
    return dt if dt > 0 else avg
