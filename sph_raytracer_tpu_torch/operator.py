"""Raytracing operator: differentiable forward projection + adjoint.

Port of ``sph_raytracer_tpu/operator.py``.  Same public surface —
``op(density)`` forward line integration with leading channel dims,
``op.T(y)`` adjoint backprojection, 4D dynamic volumes with per-view time
binning or ``view_times`` linear interpolation — in PyTorch on an explicit
device, with two execution modes:

* ``mode='precomputed'``: packed (lin, lens) crossing tables cached at
  construction; forward / adjoint are PyTorch gather / scatter-add and
  autograd differentiates the forward (:mod:`.ops.project`).
* ``mode='routed'`` (``'auto'`` on CUDA): the tables become GPU tables
  built on the device, and forward / backward run a pair of hand-written
  CUDA kernels inside a ``torch.autograd.Function``
  (:mod:`.ops.routed_project`).  ``routed_dense``, ``routed_fwd_reduce``
  and ``routed_banded`` pick the pair (:func:`.ops.routed_project.resolve`,
  the table in :mod:`.config`), the same for ``__call__``, its gradient
  and ``.T``; only the tables that pair reads are built.
* ``mode='fused'``: no tables at construction.  Inside the envelope
  (:func:`.ops.fused_project.supported`) the forward is the ``fused_fwd``
  kernel, which traces every ray itself; the gradient runs a routed
  backward kernel on backward-only tables built at the first forward
  that needs one (``fused_bwd='auto'``), or re-traces blockwise
  (``'retrace'``).  Outside it (``fused_backend='xla'``, float64) the
  blockwise path :func:`.ops.project.project_fused` runs.

``routed_w_dtype='bf16'`` stores the banded tables' lengths in bfloat16
(routed mode's tables and fused mode's backward tables; the kernels'
``<name>_bf16`` instantiations read them); elsewhere it warns and keeps
f32 (:mod:`.config`).

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and with no card present that raises.

Not ported yet (ROADMAP): ``debug``/``debug_los``, ``payload``/
``with_payload``, ``regs``, ``plot`` and the on-disk trace cache.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .config import TraceConfig, check_supported
from .grid import SphericalGrid
from .ops.fused_project import (
    fused_fwd,
    fused_project,
    fused_routed_project,
    prep_rays,
    supported,
)
from .ops.project import (
    backproject_table,
    precompute_table,
    project_fused,
    project_table,
)
from .ops.routed_project import BACKWARDS, build_for, resolve, routed_project
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
            lerp-weighted lengths; the fused kernel instead reads both
            bins per segment, and outside its envelope fused mode falls
            back to 'precomputed' with a warning).
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
        self._engine = mode == "fused" and self._fused_engine()
        if mode == "fused" and self._time_w is not None and not self._engine:
            # the lerp runs inside the fused kernel (two time bins per
            # segment); the blockwise path has no doubled-table analog
            warnings.warn(
                "fused mode supports view_times only in the in-kernel "
                "fused engine (unavailable here: fused_backend='xla' or "
                "outside the envelope); falling back to mode='precomputed'")
            mode = "precomputed"
        self._mode = mode
        # the routed (forward, backward) kernel pair; fused mode's routed
        # backward reads routed_dense alone
        self._fwd, self._bwd = (resolve(config) if mode == "routed" else
                                (None, BACKWARDS[config.routed_dense]))
        # fused_bwd='auto': the routed backward whenever the fused kernel
        # runs, built lazily so a forward-only operator keeps no tables
        self._fused_bwd = config.fused_bwd
        self._fused_bwd_lazy = False
        if config.fused_bwd == "auto":
            self._fused_bwd = "routed" if self._engine else "retrace"
            self._fused_bwd_lazy = self._engine
        # the banded tables' weight dtype: bf16 wherever banded tables are
        # built, routed mode's with routed_banded and fused mode's routed
        # backward's whatever routed_banded is (its tables are banded)
        self._w_dtype = torch.float32
        if config.routed_w_dtype == "bf16":
            if ((mode == "routed" and config.routed_banded)
                    or (mode == "fused" and self._fused_bwd == "routed")):
                self._w_dtype = torch.bfloat16
            else:
                warnings.warn(
                    "routed_w_dtype='bf16' only applies to the BANDED routed "
                    f"engine (mode={mode!r}, routed_banded="
                    f"{config.routed_banded}); weight tables stay f32")

        self.lin = self.lens = self._tables = self._fused_btd = None
        self._tables_memo = None
        if mode == "fused":
            xs = np.asarray(geom.ray_starts, dtype=np.float64)
            rays = np.asarray(geom.rays, dtype=np.float64)
            if self._engine:
                self._frays = prep_rays(xs, rays, self._view_offsets,
                                        self._time_off2, self._time_w,
                                        device=self.device)
                if self._fused_bwd == "routed" and not self._fused_bwd_lazy:
                    self._ensure_fused_btd()
            else:
                self._xs = torch.as_tensor(xs, dtype=config.ftype,
                                           device=self.device)
                self._rays = torch.as_tensor(rays, dtype=config.ftype,
                                             device=self.device)
                self._off = (None if self._view_offsets is None else
                             torch.as_tensor(self._view_offsets,
                                             device=self.device))
        elif mode == "routed":
            lin, lens = self._trace()
            self._tables = build_for(lin, lens, self._flat_size, self._fwd,
                                     self._bwd, w_dtype=self._w_dtype)
        else:
            self.lin, self.lens = self._trace()

    # ------------------------------------------------------------------
    def _trace(self):
        """The crossing tables ``(lin, lens)`` of every ray, time offsets
        applied, on the operator's device."""
        lin, lens, _, _ = precompute_table(
            self.gs, np.asarray(self.geom.ray_starts, dtype=np.float64),
            np.asarray(self.geom.rays, dtype=np.float64),
            block=min(self.config.precompute_block_rays,
                      _round_block(self._nrays)),
            itype=self.config.itype, device=self.device)
        return self._apply_offsets(lin, lens)

    def _fused_engine(self) -> bool:
        """Whether fused mode runs the in-kernel-trace engine
        (``fused_fwd``); ``fused_backend='pallas'`` outside its envelope
        raises."""
        be = self.config.fused_backend
        if be == "xla":
            return False
        ok = supported(self.gs, self._flat_size)
        if be == "pallas" and not ok:
            raise ValueError(
                "fused_backend='pallas' but this grid is outside the "
                "in-kernel fused engine's envelope (see "
                "ops/fused_project.supported)")
        return ok

    def _ensure_fused_btd(self):
        """The fused mode's backward-only routed tables, built at first
        use: only what ``routed_dense``'s backward reads (the transpose
        for the gather, the ray-major CSR for the scatter)."""
        if self._fused_btd is None:
            lin, lens = self._trace()
            self._fused_btd = build_for(lin, lens, self._flat_size,
                                        self._bwd, w_dtype=self._w_dtype)
        return self._fused_btd

    # ------------------------------------------------------------------
    def _apply_offsets(self, lin, lens):
        """Apply per-view time offsets to a traced ``(lin, lens)`` table.

        Binned 4D: add ``t_index·V`` to the voxel ids.  Time-interpolated
        4D (``view_times``): append a second copy of each crossing at the
        ceil bin, splitting each length into ``(1-w)·len`` / ``w·len`` —
        the lerp becomes part of the linear operator itself (bf16 tables
        round each of the two split lengths, as the JAX package does)."""
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
                (*channels, T, N_r, N_e, N_a).  Routed mode and the fused
                kernel compute in float32.

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
        if self._mode == "fused":
            out = self._fused(flat)
        elif self._tables is not None:
            flat2 = flat.reshape(-1, self._flat_size).to(torch.float32)
            out = torch.stack([routed_project(f, self._tables, self._bwd,
                                              self._fwd) for f in flat2])
        else:
            out = project_table(flat, self.lin, self.lens)
        return out.reshape(tuple(chan) + self._rshape)

    def _fused(self, flat):
        if not self._engine:
            return project_fused(
                self.gs, flat, self._xs, self._rays, view_offsets=self._off,
                block=min(self.config.block_rays, _round_block(self._nrays)),
                itype=self.config.itype).reshape(*flat.shape[:-1], -1)
        flat2 = flat.reshape(-1, self._flat_size).to(torch.float32)
        out = torch.stack([self._fused_one(f) for f in flat2])
        return out.reshape(*flat.shape[:-1], -1)

    def _fused_one(self, f):
        """The fused kernel's forward of one flat f32 volume, with the
        backward that ``fused_bwd`` resolved to."""
        if self._fused_bwd == "retrace":
            return fused_project(f, self.gs, self._frays, self.config.itype)
        if torch.is_grad_enabled() and f.requires_grad:
            self._ensure_fused_btd()
        if self._fused_btd is None:
            return fused_fwd(self.gs, self._frays, f)
        return fused_routed_project(f, self.gs, self._frays,
                                    self._fused_btd, self._bwd)

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
        tables = self._tables
        if self._engine and self._fused_bwd == "routed":
            # the routed backward's tables, built here at first use
            tables = self._ensure_fused_btd()
        if tables is not None:
            yf2 = yf.reshape(-1, self._nrays).to(torch.float32)
            out = torch.stack([self._bwd(tables, v) for v in yf2])
        else:
            lin, lens = self._lin_lens()
            out = backproject_table(yf, lin, lens,
                                    volume_size=self._flat_size)
        return out.reshape(*chan, *self.grid.shape)

    def _lin_lens(self):
        """``(lin, lens)`` for the table adjoint; fused mode traces them
        at its first ``.T`` and keeps them (re-tracing per call would cost
        the whole trace every time)."""
        if self.lin is not None:
            return self.lin, self.lens
        if self._tables_memo is None:
            self._tables_memo = self._trace()
        return self._tables_memo

    # ------------------------------------------------------------------
    def __repr__(self):
        if self.dynamic:
            return (f"Operator({(self.geom.shape[0], *self.grid.shape)} → "
                    f"{tuple(self.geom.shape)})")
        return f"Operator({tuple(self.grid.shape)} → {tuple(self.geom.shape)})"


def _round_block(n: int) -> int:
    """Smallest power-of-two block ≥ min(n, 1)."""
    return 1 << max(0, (n - 1)).bit_length()
