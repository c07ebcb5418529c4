"""Per-LOS debug tracer.

Port of ``sph_raytracer_tpu/utils/debug.py``, surfaced through
``Operator(debug=True, debug_los=...)``.  :func:`debug_trace` slices the
one requested line of sight out of the detector before tracing, so its
cost is O(M) whatever the detector's size.

It traces that ray on the CPU in float64 by design, as the JAX package
traces it on its CPU backend: this is a printout of the exact geometry of
one line of sight, not the operator's path.  The operator's own tables
and kernels run where the operator runs (on the card by default), and
nothing here falls back to the CPU for them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.trace import trace_crossings

__all__ = ["debug_trace", "format_trace"]


def debug_trace(op, los: Optional[tuple] = None, out=None):
    """Print a per-crossing table for one line of sight of an operator.

    Args:
        op: an :class:`~sph_raytracer_tpu_torch.operator.Operator`.
        los: index tuple into ``op.geom.shape`` selecting the LOS
            (default: the central pixel).
        out: file-like (default stdout).

    Returns:
        (regs, lens, ts) numpy arrays for the selected LOS: ``regs``
        shaped (3, M) in canonical voxel indices, ``lens`` / ``ts``
        shaped (M,), float64.  For 4D operators the header shows the
        LOS's time bin (under ``view_times``, both bracketing bins with
        their lerp weights: each printed segment contributes ``(1-w)·len``
        to the floor bin and ``w·len`` to the ceil bin, as the doubled
        table splits it).
    """
    rshape = tuple(op.geom.shape)
    if los is None:
        los = tuple(s // 2 for s in rshape)
    los = tuple(int(i) for i in np.atleast_1d(np.asarray(los)))
    if len(los) != len(rshape):
        raise ValueError(
            f"debug_los {los} does not index geom shape {rshape}")

    # the one LOS, sliced before tracing
    xs = np.broadcast_to(np.asarray(op.geom.ray_starts, np.float64),
                         (*rshape, 3))[los]
    rays = np.broadcast_to(np.asarray(op.geom.rays, np.float64),
                           (*rshape, 3))[los]
    gs = dataclasses.replace(op.gs, ftype=torch.float64)
    regs, lens, ts = trace_crossings(gs, torch.from_numpy(xs[None].copy()),
                                     torch.from_numpy(rays[None].copy()),
                                     itype=op.config.itype)
    regs, lens, ts = regs[:, 0].numpy(), lens[0].numpy(), ts[0].numpy()

    time_info = None
    if op._view_offsets is not None:
        V = op._vsize
        flat = int(np.ravel_multi_index(los, rshape))
        k0 = int(op._view_offsets.reshape(-1)[flat]) // V
        if op._time_w is not None:
            k1 = int(op._time_off2.reshape(-1)[flat]) // V
            time_info = (k0, k1, float(op._time_w.reshape(-1)[flat]))
        else:
            time_info = (k0, None, None)

    print(format_trace(regs, lens, ts, los=los, xs=xs, rays=rays,
                       time_info=time_info), file=out)
    return regs, lens, ts


def format_trace(regs, lens, ts, los=None, xs=None, rays=None,
                 time_info=None) -> str:
    """Format one LOS's (3, M) regions / (M,) lengths / (M,) distances as
    a table of the segments that contribute to the integral and the
    invalid crossings around them."""
    lines = [
        f"LOS {los}: {int((lens > 0).sum())} contributing segments, "
        f"total length {lens.sum():.6g}",
    ]
    if xs is not None:
        lines.append(f"ray_start: {np.asarray(xs)}")
    if rays is not None:
        lines.append(f"ray: {np.asarray(rays)}")
    if time_info is not None:
        k0, k1, w = time_info
        if k1 is None or not w:
            lines.append(f"time bin: {k0}")
        else:
            lines.append(
                f"time lerp: bin {k0} × {1 - w:.4g} + bin {k1} × {w:.4g} "
                f"(each segment length splits accordingly)")
    lines.append(
        f"{'idx':>4} {'t':>12} {'len':>12} {'r':>4} {'e':>4} {'a':>4} note")
    for k in range(lens.shape[-1]):
        if not np.isfinite(ts[k]) and lens[k] == 0:
            continue
        note = "(zero/invalid)" if lens[k] == 0 else ""
        lines.append(
            f"{k:>4} {ts[k]:>12.6g} {lens[k]:>12.6g} "
            f"{regs[0][k]:>4} {regs[1][k]:>4} {regs[2][k]:>4} {note}")
    return "\n".join(lines)
