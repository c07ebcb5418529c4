"""The port's trace and table caches (``SPH_TPU_TRACE_CACHE``).

A cold build writes ``torch_trace_<hash>.npz`` and ``torch_tables_<hash>/``;
a warm build reads them and traces nothing (the trace is made to raise),
giving bitwise the cold build's tables; the keys part every input that
changes what is built; a write that races another leaves one whole entry;
and a trace the JAX package wrote into the same directory is never read.
"""
import datetime
import os
import threading
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch import operator as op_mod
from sph_raytracer_tpu_torch.ops import routed_project as rp
from sph_raytracer_tpu_torch.parallel import ShardedOperator
from sph_raytracer_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)


def _problem(pkg, views=3):
    grid = pkg.SphericalGrid(shape=(6, 6, 6))
    geom = sum(pkg.ConeRectGeom((4, 6), pos=(2 * np.cos(t), 2 * np.sin(t),
                                             0.4), fov=(45, 45))
               for t in np.linspace(0, 2 * np.pi, views, endpoint=False))
    return grid, geom


def _no_trace(*a, **k):
    raise AssertionError("a cache hit traced")


def _tensors(o):
    """The tensors an operator computes with (tables, or lin / lens)."""
    if o._tables is not None:
        return list(o._tables)
    if o._fused_btd is not None:
        return list(o._fused_btd)
    return [o.lin, o.lens]


def _equal(a, b):
    return (a is None and b is None) or (
        a == b if isinstance(a, int) else
        a.dtype == b.dtype and torch.equal(a, b))


CASES = {
    "auto": dict(mode="routed"),
    "bf16": dict(mode="routed",
                 config=prt.TraceConfig(routed_w_dtype="bf16")),
    "hist": dict(mode="routed",
                 config=prt.TraceConfig(routed_fwd_reduce="hist")),
    "window": dict(mode="routed",
                   config=prt.TraceConfig(routed_banded=False)),
    "precomputed": dict(mode="precomputed", ftype=torch.float64),
    "fused-bwd": dict(config=prt.TraceConfig(mode="fused",
                                             fused_bwd="routed")),
}


@pytest.mark.parametrize("case", CASES)
def test_warm_hit_does_not_trace(case, tmp_path, monkeypatch):
    monkeypatch.setenv("SPH_TPU_TRACE_CACHE", str(tmp_path))
    grid, geom = _problem(prt)
    cold = prt.Operator(grid, geom, device="cpu", **CASES[case])
    kinds = sorted(f.split("_")[1] for f in os.listdir(tmp_path))
    assert kinds == (["trace"] if case == "precomputed"
                     else ["tables", "trace"])
    monkeypatch.setattr(op_mod, "precompute_table", _no_trace)
    warm = prt.Operator(grid, geom, device="cpu", **CASES[case])
    assert all(_equal(a, b) for a, b in zip(_tensors(cold), _tensors(warm)))
    x = torch.rand(tuple(grid.shape), dtype=cold.config.ftype)
    with torch.no_grad():
        assert torch.equal(cold(x), warm(x))
    # a built operator with no cache still matches (the cache changes
    # nothing it computes)
    monkeypatch.undo()
    fresh = prt.Operator(grid, geom, device="cpu", **CASES[case])
    assert all(_equal(a, b) for a, b in zip(_tensors(fresh), _tensors(warm)))


def test_sharded_rank_tables_cached(tmp_path, monkeypatch):
    """Each rank's tables are keyed by its ray range: two ranks write two
    entries, and a warm two-rank build reads both without tracing."""
    monkeypatch.setenv("SPH_TPU_TRACE_CACHE", str(tmp_path))
    grid, geom = _problem(prt)

    def build():
        store, tag = dist.HashStore(), uuid.uuid4().hex
        out = [None, None]

        def body(r):
            pg = dist.ProcessGroupGloo(dist.PrefixStore(tag, store), r, 2,
                                       datetime.timedelta(seconds=30))
            out[r] = ShardedOperator(grid, geom, mode="routed", mesh=Mesh(
                pg, r, 2, torch.device("cpu")))._tables

        threads = [threading.Thread(target=body, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(40)
        return out

    cold = build()
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("torch_tables_")]) == 2
    monkeypatch.setattr(op_mod, "precompute_table", _no_trace)
    warm = build()
    for c, w in zip(cold, warm):
        assert all(_equal(a, b) for a, b in zip(c, w))


def test_keys_differ(tmp_path, monkeypatch):
    """ftype, geometry, ray range, voxel range, kernel pair, weight dtype,
    voxel order and view times each change the key."""
    grid, geom = _problem(prt)
    paths = set()

    def add(o, *wrappers, **attrs):
        for k, v in attrs.items():
            setattr(o, k, v)
        key = "/".join([*(w.__name__ for w in wrappers), str(o._w_dtype),
                        o._vorder, f"vox{o._vox}", o._time_key()])
        paths.add(o._cache_path("tables", key))
        return o

    monkeypatch.setenv("SPH_TPU_TRACE_CACHE", str(tmp_path))
    base = dict(device="cpu", mode="fused")
    o = prt.Operator(grid, geom, **base)
    fwd, bwd = rp.routed_fwd, rp.routed_bwd_gather
    add(o, fwd, bwd)
    add(prt.Operator(grid, geom, ftype=torch.float64, **base), fwd, bwd)
    add(prt.Operator(grid, _problem(prt, views=2)[1], **base), fwd, bwd)
    add(prt.Operator(grid, geom, **base), fwd, bwd, _rows=(0, 36))
    add(prt.Operator(grid, geom, **base), fwd, bwd, _rows=(36, 72))
    add(prt.Operator(grid, geom, **base), fwd, bwd, _vox=(0, 100))
    add(prt.Operator(grid, geom, **base), fwd, rp.routed_bwd_scatter)
    add(prt.Operator(grid, geom, **base), fwd, bwd,
        _w_dtype=torch.bfloat16)
    add(prt.Operator(grid, geom, **base), fwd, bwd, _vorder="r")
    tgrid = prt.SphericalGrid(shape=(2, 6, 6, 6))
    for times in ((0.2, 0.4, 0.6), (0.2, 0.4, 0.7)):
        add(prt.Operator(tgrid, geom, view_times=np.asarray(times),
                         **base), fwd, bwd)
    assert len(paths) == 11
    assert all(os.path.basename(p).startswith("torch_tables_")
               for p in paths)


def test_racing_writers_leave_one_whole_entry(tmp_path, monkeypatch):
    """Eight threads build the same operator at once into one cache: one
    whole trace and one whole table set remain, no temporary is left, and
    a warm build reads them."""
    monkeypatch.setenv("SPH_TPU_TRACE_CACHE", str(tmp_path))
    grid, geom = _problem(prt)
    out, errs = [None] * 8, []

    def body(i):
        try:
            out[i] = prt.Operator(grid, geom, mode="routed",
                                  device="cpu")._tables
        except BaseException as e:  # noqa: B036 - asserted below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and not any(t.is_alive() for t in threads)
    names = sorted(os.listdir(tmp_path))
    assert [n.split("_")[1] for n in names] == ["tables", "trace"], names
    monkeypatch.setattr(op_mod, "precompute_table", _no_trace)
    warm = prt.Operator(grid, geom, mode="routed", device="cpu")._tables
    for t in out:
        assert all(_equal(a, b) for a, b in zip(t, warm))


def test_jax_trace_cache_not_read(tmp_path, monkeypatch):
    """A trace in the JAX package's format at the JAX package's own cache
    path (``trace_<hash>.npz``, named by its ``_trace_cache_path``) sits in
    the same directory; the port neither reads it nor overwrites it."""
    monkeypatch.setenv("SPH_TPU_TRACE_CACHE", str(tmp_path))
    jgrid, jgeom = _problem(srt)
    jax_path = srt.Operator(jgrid, jgeom, ftype=jnp.float64,
                            _compute=False)._trace_cache_path()
    grid, geom = _problem(prt)
    lin, lens, n, rs = prt.ops.project.precompute_table(
        prt.ops.trace.GridSpec.from_grid(grid), geom.ray_starts, geom.rays,
        device="cpu")
    np.savez(jax_path, lin=lin.numpy(), lens=lens.numpy().astype(np.float64),
             n=n, rs=np.asarray(rs))
    jax_files = os.listdir(tmp_path)
    assert len(jax_files) == 1 and jax_files[0].startswith("trace_")
    with monkeypatch.context() as m:
        m.setattr(op_mod, "precompute_table", _no_trace)
        with pytest.raises(AssertionError, match="traced"):
            prt.Operator(grid, geom, mode="precomputed",
                         ftype=torch.float64, device="cpu")
    before = os.stat(tmp_path / jax_files[0]).st_mtime_ns
    prt.Operator(grid, geom, mode="precomputed", ftype=torch.float64,
                 device="cpu")
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2 and names[0].startswith("torch_trace_")
    assert os.stat(tmp_path / jax_files[0]).st_mtime_ns == before


@pytest.mark.parametrize("const,config", [
    ("HIST_SHARE", prt.TraceConfig(routed_fwd_reduce="hist")),
    ("WIN_K", prt.TraceConfig(routed_banded=False)),
    ("WIN_KF", prt.TraceConfig(routed_banded=False))])
def test_build_constant_change_misses(const, config, tmp_path, monkeypatch):
    """The tables bake in the build constants (the 'hist' cut table, the
    window work items and pieces): a warm build after one of them changed
    misses the cache, traces and builds, and computes what a fresh build
    with that constant computes."""
    monkeypatch.setenv("SPH_TPU_TRACE_CACHE", str(tmp_path))
    grid, geom = _problem(prt)
    kw = dict(config=config.replace(mode="routed"), device="cpu")
    prt.Operator(grid, geom, **kw)
    monkeypatch.setattr(rp, const, getattr(rp, const) // 2)
    traced = []
    real = op_mod.precompute_table
    monkeypatch.setattr(op_mod, "precompute_table",
                        lambda *a, **k: traced.append(1) or real(*a, **k))
    warm = prt.Operator(grid, geom, **kw)
    assert traced
    monkeypatch.delenv("SPH_TPU_TRACE_CACHE")
    fresh = prt.Operator(grid, geom, **kw)
    assert all(_equal(a, b) for a, b in zip(warm._tables, fresh._tables))


def test_save_load_tables_roundtrip(tmp_path):
    """Every table kind and weight dtype, and an empty table set (a rank
    with no ray), round trip bitwise; the arrays load memory-mapped."""
    grid, geom = _problem(prt)
    op = prt.Operator(grid, geom, mode="precomputed", device="cpu")
    lin, lens = op.lin, op.lens
    sets = [rp.build_for(lin, lens, op._flat_size, rp.routed_fwd_hist,
                         rp.routed_bwd_gather, w_dtype=torch.bfloat16),
            rp.build_for(lin, lens, op._flat_size, rp.routed_bwd_gather),
            rp.build_window_tables(lin, lens, op._flat_size),
            rp.build_for(lin[:0], lens[:0], op._flat_size, rp.routed_fwd,
                         rp.routed_bwd_scatter)]
    for i, t in enumerate(sets):
        path = str(tmp_path / f"t{i}")
        rp.save_tables(path, t)
        got = rp.load_tables(path, "cpu")
        assert type(got) is type(t)
        assert all(_equal(a, b) for a, b in zip(got, t))
    assert isinstance(np.load(tmp_path / "t0" / "col.npy", mmap_mode="r"),
                      np.memmap)
