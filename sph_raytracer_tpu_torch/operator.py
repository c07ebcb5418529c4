"""Raytracing operator: differentiable forward projection + adjoint.

Port of ``sph_raytracer_tpu/operator.py``.  Same public surface —
``op(density)`` forward line integration with leading channel dims,
``op.T(y)`` adjoint backprojection, 4D dynamic volumes with per-view time
binning or ``view_times`` linear interpolation — in PyTorch on an explicit
device, with two execution modes:

* ``mode='precomputed'``: packed (lin, lens) crossing tables cached at
  construction; forward / adjoint are PyTorch gather / scatter-add and
  autograd differentiates the forward (:mod:`.ops.project`).
* ``mode='routed'`` (``'auto'`` on CUDA): the tables become GPU CSR
  tables built on the device, and forward / backward run the hand-written
  CUDA kernels inside a ``torch.autograd.Function``
  (:mod:`.ops.routed_project`).

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and with no card present that raises.

Not ported yet (ROADMAP): ``mode='fused'``, ``debug``/``debug_los``,
``payload``/``with_payload``, ``regs``, ``plot`` and the on-disk trace
cache.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .config import TraceConfig, check_supported
from .grid import SphericalGrid
from .ops.project import backproject_table, precompute_table, project_table
from .ops.routed_project import BACKWARDS, build_tables, routed_project
from .ops.trace import GridSpec
from .viewgeom import ViewGeom

__all__ = ["Operator", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``; a
    CUDA device without a card raises (no silent CPU fallback)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU (the port never falls back to it silently)")
    return device


class Operator:
    """Differentiable raytracing operator ``density → line integrals``.

    Args:
        grid: :class:`SphericalGrid` volume extent/resolution.
        geom: :class:`ViewGeom` detector specification.
        config: :class:`TraceConfig`; the convenience kwargs ``mode=`` /
            ``ftype=`` / ``itype=`` / ``trace_method=`` override it.
        dynamic: force 4D semantics (default: ``grid.dynamic``).
        view_times: optional per-view observation times (length
            ``geom.shape[0]``, in ``grid.t`` units; numeric or datetime64);
            each view sees the volume linearly interpolated between its two
            bracketing time bins (the crossing table is doubled with
            lerp-weighted lengths, so every engine handles it unchanged).
        device: torch device of the tables and the computation; ``None``
            means ``"cuda"``.

    Usage::

        op = Operator(grid, geom)                 # on the card
        image = op(density)                       # forward, differentiable
        density_bp = op.T(image)                  # adjoint
    """

    def __init__(self, grid: SphericalGrid, geom: ViewGeom, dynamic=None,
                 config: Optional[TraceConfig] = None,
                 mode: Optional[str] = None, ftype=None, itype=None,
                 trace_method: Optional[str] = None, view_times=None,
                 device=None, debug: bool = False, debug_los=None):
        config = config or TraceConfig()
        if mode is not None:
            config = config.replace(mode=mode)
        if trace_method is not None:
            config = config.replace(trace_method=trace_method)
        if ftype is not None:
            config = config.replace(ftype=ftype)
        if itype is not None:
            config = config.replace(itype=itype)
        check_supported(config)
        if debug or debug_los is not None:
            raise NotImplementedError(
                "Operator(debug=...) is not ported yet (ROADMAP A4)")
        self.config = config
        self.device = resolve_device(device)
        self.grid = grid
        self.geom = geom
        self.dynamic = grid.dynamic if dynamic is None else dynamic
        self.gs = GridSpec.from_grid(grid, ftype=config.ftype)

        self._rshape = tuple(geom.shape)
        self._nrays = int(np.prod(self._rshape)) if self._rshape else 1
        nr, ne, na = grid.vshape
        self._vsize = nr * ne * na

        self._time_off2 = self._time_w = None
        if view_times is not None:
            if not grid.dynamic:
                raise ValueError("view_times requires a 4D (dynamic) grid")
            T = grid.shape.t
            vt = np.atleast_1d(np.asarray(view_times))
            if np.issubdtype(vt.dtype, np.datetime64):
                vt = vt.astype("datetime64[ns]").astype(np.int64)
                t_axis = np.asarray(grid.nptime).astype(
                    "datetime64[ns]").astype(np.int64)
            else:
                t_axis = np.asarray(grid.t)
            if not self._rshape or self._rshape[0] != vt.shape[0]:
                raise ValueError(
                    f"view_times has {vt.shape[0]} entries but geom has "
                    f"leading view axis {self._rshape[:1]}")
            # fractional bin index along the (possibly non-uniform) time
            # axis; times outside [t[0], t[-1]] clamp to the end bins
            fi = np.interp(vt.astype(np.float64),
                           t_axis.astype(np.float64),
                           np.arange(T, dtype=np.float64))
            k0 = np.clip(np.floor(fi).astype(np.int64), 0, T - 1)
            k1 = np.minimum(k0 + 1, T - 1)
            w = np.where(k1 == k0, 0.0, fi - k0)
            per_view = self._nrays // vt.shape[0]
            self.dynamic = True
            self._view_offsets = np.repeat(
                k0 * self._vsize, per_view).reshape(self._rshape)
            if w.any():
                self._time_off2 = np.repeat(
                    k1 * self._vsize, per_view).reshape(self._rshape)
                self._time_w = np.repeat(w, per_view).reshape(self._rshape)
            self._flat_size = T * self._vsize
        elif self.dynamic:
            if not grid.dynamic:
                raise ValueError("dynamic=True requires a 4D (dynamic) grid")
            T = grid.shape.t
            if self._rshape[0] != T:
                raise ValueError(
                    f"dynamic grid with {T} time bins requires geom with "
                    f"{T} leading views, got geom.shape={self._rshape}")
            per_view = self._nrays // T
            # per-ray linear offset t_index·V (reference raytracer.py:705-710)
            self._view_offsets = np.repeat(
                np.arange(T, dtype=np.int64) * self._vsize, per_view
            ).reshape(self._rshape)
            self._flat_size = T * self._vsize
        else:
            self._view_offsets = None
            self._flat_size = self._vsize
        # linear voxel ids must fit the index dtype (reference
        # raytracer.py:273)
        imax = int(torch.iinfo(config.itype).max)
        if self._flat_size - 1 > imax:
            raise OverflowError(
                f"grid has {self._flat_size} linear voxels but "
                f"itype={config.itype} indexes at most {imax + 1}; pass "
                "itype=torch.int64")

        mode = config.mode
        if mode == "auto":
            mode = "routed" if self.device.type == "cuda" else "precomputed"
        if mode == "routed" and config.ftype != torch.float32:
            # the CUDA kernels take f32 tables; other dtypes keep the
            # PyTorch table path
            if config.mode == "routed":
                warnings.warn(
                    "routed mode requires float32 (its tables are f32); "
                    "falling back to mode='precomputed' for "
                    f"ftype={config.ftype}")
            mode = "precomputed"
        self._mode = mode

        lin, lens, _, _ = precompute_table(
            self.gs, np.asarray(geom.ray_starts, dtype=np.float64),
            np.asarray(geom.rays, dtype=np.float64),
            block=min(config.precompute_block_rays,
                      _round_block(self._nrays)),
            itype=config.itype, device=self.device)
        lin, lens = self._apply_offsets(lin, lens)
        self.lin = self.lens = self._tables = None
        if mode == "routed":
            self._bwd = BACKWARDS[config.routed_dense]
            self._tables = build_tables(
                lin, lens, self._flat_size,
                transpose=self._bwd is BACKWARDS["auto"])
        else:
            self.lin, self.lens = lin, lens

    # ------------------------------------------------------------------
    def _apply_offsets(self, lin, lens):
        """Apply per-view time offsets to a traced ``(lin, lens)`` table.

        Binned 4D: add ``t_index·V`` to the voxel ids.  Time-interpolated
        4D (``view_times``): append a second copy of each crossing at the
        ceil bin, splitting each length into ``(1-w)·len`` / ``w·len`` —
        the lerp becomes part of the linear operator itself."""
        if self._view_offsets is None:
            return lin, lens
        dev, it = lin.device, lin.dtype
        off0 = torch.as_tensor(self._view_offsets.reshape(-1, 1),
                               dtype=it, device=dev)
        if self._time_w is None:
            return lin + off0, lens
        off1 = torch.as_tensor(self._time_off2.reshape(-1, 1), dtype=it,
                               device=dev)
        w = torch.as_tensor(self._time_w.reshape(-1, 1), dtype=lens.dtype,
                            device=dev)
        return (torch.cat([lin + off0, lin + off1], dim=-1),
                torch.cat([lens * (1 - w), lens * w], dim=-1))

    # ------------------------------------------------------------------
    def __call__(self, density):
        """Forward projection.

        Args:
            density: (*channels, *grid.shape) volume (tensor or array,
                moved to the operator's device); dynamic grids take
                (*channels, T, N_r, N_e, N_a).  Routed mode computes in
                float32.

        Returns:
            (*channels, *geom.shape) line integrals.
        """
        density = torch.as_tensor(density, device=self.device)
        gshape = tuple(self.grid.shape)
        if tuple(density.shape[-len(gshape):]) != gshape:
            raise ValueError(f"density shape {tuple(density.shape)} does "
                             f"not end with grid shape {gshape}")
        chan = density.shape[: -len(gshape)]
        flat = density.reshape(*chan, self._flat_size)
        if self._tables is not None:
            flat2 = flat.reshape(-1, self._flat_size).to(torch.float32)
            out = torch.stack([routed_project(f, self._tables, self._bwd)
                               for f in flat2])
        else:
            out = project_table(flat, self.lin, self.lens)
        return out.reshape(*chan, *self._rshape)

    def T(self, line_integrations):
        """Adjoint backprojection (4D volumes and channel dims supported).

        Args:
            line_integrations: (*channels, *geom.shape).

        Returns:
            (*channels, *grid.shape) density.
        """
        y = torch.as_tensor(line_integrations, device=self.device)
        chan = y.shape[: y.dim() - len(self._rshape)]
        yf = y.reshape(*chan, self._nrays)
        if self._tables is not None:
            yf2 = yf.reshape(-1, self._nrays).to(torch.float32)
            out = torch.stack([self._bwd(self._tables, v) for v in yf2])
        else:
            out = backproject_table(yf, self.lin, self.lens,
                                    volume_size=self._flat_size)
        return out.reshape(*chan, *self.grid.shape)

    # ------------------------------------------------------------------
    def __repr__(self):
        if self.dynamic:
            return (f"Operator({(self.geom.shape[0], *self.grid.shape)} → "
                    f"{tuple(self.geom.shape)})")
        return f"Operator({tuple(self.grid.shape)} → {tuple(self.geom.shape)})"


def _round_block(n: int) -> int:
    """Smallest power-of-two block ≥ min(n, 1)."""
    return 1 << max(0, (n - 1)).bit_length()
