"""Export an operator's program and tables for serving.

Port of ``sph_raytracer_tpu/utils/export.py``.  A serving process should
not re-trace the geometry or rebuild the tables at start:
:func:`export_operator` writes the operator's tensors (``Operator.payload``
plus fused mode's ray tables) and a description of its program to one
``.zip``, and :func:`load_exported` returns a callable that runs the same
kernels on them without constructing an ``Operator``: no geometry code, no
trace, no table build.

The archive holds two parts:

* ``meta.json``: the program (``what``), the mode, the kernel pair by the
  wrappers' names in ``ops.routed_project`` (``routed_fwd``,
  ``routed_bwd_gather``, ...), the table type and its integer fields,
  ``grid.shape``, ``geom.shape``, the flat volume size, the voxel order,
  fused mode's grid boundaries and every tensor's dtype;
* ``payload.pt``: those tensors, written with ``torch.save`` and read back
  with ``weights_only=True`` onto the serving device.

The program itself is not serialized: ``torch.export`` cannot trace the
kernels, which are bound through ctypes (``ops/_cuda.py``), and binding
each of them as a ``torch.library`` custom op would put the dispatcher on a
training step that is already host-bound.  The loader instead calls the
same wrappers and ``torch.autograd.Function``\\ s the operator calls
(``routed_project``, ``fused_routed_project``, ``project_table``), so a
served forward or gradient equals the live operator's bit for bit.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Callable

import torch

from ..ops import routed_project as rp
from ..ops.fused_project import (
    FusedRays,
    fused_fwd,
    fused_project,
    fused_routed_project,
)
from ..ops.project import project_table
from ..ops.trace import GridSpec, voxel_order_flat

__all__ = ["export_operator", "load_exported"]

# the routed wrappers a TraceConfig resolves to, by name
_WRAPPERS = {w.__name__: w for w in (
    *rp.FORWARDS.values(), *rp.BACKWARDS.values(), rp.routed_fwd_hist,
    rp.routed_fwd_window, rp.routed_bwd_window)}
_TABLE_TYPES = {"RoutedTables": rp.RoutedTables,
                "WindowTables": rp.WindowTables}


def _split(prefix, nt):
    """A named tuple's tensors (keyed ``prefix.field``) and a JSON record
    of its type, integer fields and empty fields."""
    tensors, rec = {}, {"type": type(nt).__name__, "ints": {}, "none": []}
    for f, v in zip(nt._fields, nt):
        if isinstance(v, torch.Tensor):
            tensors[f"{prefix}.{f}"] = v
        elif v is None:
            rec["none"].append(f)
        else:
            rec["ints"][f] = int(v)
    return tensors, rec


def _join(cls, prefix, rec, tensors):
    fields = dict(rec["ints"])
    fields.update({f: None for f in rec["none"]})
    fields.update({k.split(".", 1)[1]: v for k, v in tensors.items()
                   if k.startswith(prefix + ".")})
    return cls(**fields)


def export_operator(op, path: str, what: str = "forward",
                    loss_y=None) -> None:
    """Write an operator's program and tensors to a ``.zip`` archive.

    Args:
        op: an :class:`~sph_raytracer_tpu_torch.operator.Operator` in
            precomputed or routed mode, or fused mode on its kernel
            engine (the blockwise fused path is not exported).
        path: output archive.
        what: ``"forward"`` (density → line integrals) or
            ``"grad_step"`` (density, measurements → the gradient of
            ``mean((f(density) - y)**2)`` w.r.t. the density).
        loss_y: example measurements; when given, their shape is checked
            against ``geom.shape``.
    """
    if what not in ("forward", "grad_step"):
        raise ValueError(f"unknown program {what!r}")
    if op._mode == "fused" and not op._engine:
        raise ValueError("export covers precomputed, routed and the fused "
                         "kernel engine; this fused operator runs the "
                         "blockwise path")
    rshape = tuple(op.geom.shape)
    if loss_y is not None and tuple(loss_y.shape) != rshape:
        raise ValueError(f"loss_y has shape {tuple(loss_y.shape)}, the "
                         f"operator's images {rshape}")
    payload = op.payload
    meta = {
        "format": 1, "what": what, "mode": op._mode,
        "grid_shape": list(op.grid.shape), "geom_shape": list(rshape),
        "vshape": list(op.grid.vshape), "flat_size": op._flat_size,
        "voxel_order": op._vorder, "itype": str(op.config.itype),
        "fwd": op._fwd.__name__ if op._fwd is not None else None,
        "bwd": op._bwd.__name__ if op._bwd is not None else None,
        "fused_bwd": op._fused_bwd,
    }
    tensors = {}
    for key in ("dt", "fbtd"):
        if key in payload:
            t, meta["tables"] = _split(key, payload[key])
            meta["tables"]["key"] = key
            tensors.update(t)
    if "lin" in payload:
        tensors["lin"], tensors["lens"] = payload["lin"], payload["lens"]
    if op._mode == "fused":
        t, meta["rays"] = _split("frays", op._frays)
        tensors.update(t)
        gs = op.gs
        meta["gs"] = {"r_b": list(gs.r_b), "e_b": list(gs.e_b),
                      "a_b": list(gs.a_b), "full_azimuth": gs.full_azimuth,
                      "ftype": str(gs.ftype)}
    meta["dtypes"] = {k: str(v.dtype) for k, v in tensors.items()}
    buf = io.BytesIO()
    torch.save(tensors, buf)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr("payload.pt", buf.getvalue())


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.split(".", 1)[1])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy in fresh storage when it does not start on 16 B
    (the quad walks' check, ``ops/routed_project._aligned``)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _program(meta, tensors) -> Callable:
    """The flat forward ``f(d (flat_size,)) -> y (R,)`` of an archive,
    differentiable through the operator's own autograd Functions."""
    mode = meta["mode"]
    if mode == "precomputed":
        lin, lens = tensors["lin"], tensors["lens"]
        return lambda d: project_table(d, lin, lens)
    tables = None
    if "tables" in meta:
        rec = meta["tables"]
        tables = _join(_TABLE_TYPES[rec["type"]], rec["key"], rec, tensors)
    bwd = _WRAPPERS[meta["bwd"]] if meta["bwd"] else None
    if mode == "routed":
        fwd = _WRAPPERS[meta["fwd"]]
        vshape, vo = meta["vshape"], meta["voxel_order"]
        return lambda d: rp.routed_project(
            voxel_order_flat(d.to(torch.float32), vshape, vo), tables, bwd,
            fwd)
    g = meta["gs"]
    gs = GridSpec(tuple(g["r_b"]), tuple(g["e_b"]), tuple(g["a_b"]),
                  g["full_azimuth"], _dtype(g["ftype"]))
    rays = _join(FusedRays, "frays", meta["rays"], tensors)
    if tables is not None:
        return lambda d: fused_routed_project(d.to(torch.float32), gs, rays,
                                              tables, bwd)
    if meta["fused_bwd"] == "retrace":
        itype = _dtype(meta["itype"])
        return lambda d: fused_project(d.to(torch.float32), gs, rays, itype)
    return lambda d: fused_fwd(gs, rays, d.to(torch.float32))


def load_exported(path: str, device=None) -> Callable:
    """Load an archive written by :func:`export_operator`.

    Args:
        path: the archive.
        device: where its tensors go and its kernels run; ``None`` means
            ``"cuda"``, which raises without a card (no CPU fallback).

    Returns a callable ``f(density)`` (``"forward"``) or ``f(density, y)``
    (``"grad_step"``) with the tensors bound; it constructs no
    ``Operator``, traces nothing and builds no table.
    """
    from ..operator import resolve_device

    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        tensors = torch.load(io.BytesIO(z.read("payload.pt")),
                             map_location=device, weights_only=True)
    tensors = {k: _aligned(v) for k, v in tensors.items()}
    program = _program(meta, tensors)
    gshape, rshape = tuple(meta["grid_shape"]), tuple(meta["geom_shape"])
    n = meta["flat_size"]

    def forward(density):
        d = torch.as_tensor(density, device=device)
        if tuple(d.shape) != gshape:
            raise ValueError(f"density shape {tuple(d.shape)}, want "
                             f"{gshape}")
        return program(d.reshape(n)).reshape(rshape)

    if meta["what"] == "forward":
        return forward

    def grad_step(density, y):
        d = torch.as_tensor(density, device=device).detach()
        d.requires_grad_(True)
        y = torch.as_tensor(y, device=device)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(torch.mean((forward(d) - y) ** 2), d)
        return g

    return grad_step
