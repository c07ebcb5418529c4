"""The port's sharded operators (``sph_raytracer_tpu_torch.parallel``) on
the CPU, against the JAX package's and the port's unsharded operators.

Several ranks run as threads of one process, each with its own gloo
process group over one in-memory store (:func:`run_ranks`): a two-rank
group and a collective cost milliseconds here, where spawning processes
costs seconds; it plays the part ``xla_force_host_platform_device_count``
plays for the JAX package's sharded tests (tests/conftest.py).  One real
two-process run is marked ``slow``.

Oracles: the JAX ``ShardedOperator`` on the 8-device CPU mesh (precomputed
and fused, float64, at ``tests/test_sharded.py``'s configs; its gradient
of the mean-square loss taken as ``2/N · sop.T(sop(x) - t)``, the adjoint
the JAX package's autodiff runs), and for the routed kernels' f32 shards
the JAX unsharded ``Operator(precomputed, float64)`` built on the port's
own f32 trace (``tests/test_vol_sharded.py`` holds the JAX volume-sharded
operator to it; the shared trace makes the comparison one of the kernels'
math, as ``tests/test_torch_operator.py`` does).  No JAX Pallas kernel
runs, in interpret mode or otherwise.
"""
import datetime
import multiprocessing
import os
import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu.parallel import ShardedOperator as JaxSharded
from sph_raytracer_tpu.parallel import make_mesh as jax_mesh
from sph_raytracer_tpu_torch.parallel import (
    ShardedOperator,
    VolShardedOperator,
    distributed_init,
    make_mesh,
    shard_rays,
)
from sph_raytracer_tpu_torch.ops.fused_project import fused_pallas_project
from sph_raytracer_tpu_torch.ops.project import project_fused
from sph_raytracer_tpu_torch.ops.trace import GridSpec
from sph_raytracer_tpu_torch.parallel.mesh import Mesh
from sph_raytracer_tpu_torch.parallel.sharded import ray_range, sharded_project

torch.set_num_threads(2)

F64 = torch.float64
TOL64 = 1e-10             # tests/test_sharded.py's atol


def run_ranks(n, fn, device="cpu", timeout=30):
    """``fn(mesh)`` on ``n`` ranks, each a thread with its own gloo group;
    returns each rank's result.  A rank's error is raised here (a rank that
    fails before a collective leaves the others to time out, so the error
    that is not a timeout is raised first)."""
    store, tag = dist.HashStore(), uuid.uuid4().hex
    out, err = [None] * n, [None] * n

    def body(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(tag, store), r, n,
                                       datetime.timedelta(seconds=timeout))
            out[r] = fn(Mesh(pg, r, n, torch.device(device)))
        except BaseException as e:  # noqa: B036 - re-raised below
            err[r] = e

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 10)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    errs = sorted((e for e in err if e is not None),
                  key=lambda e: "Timed out" in str(e))
    if errs:
        raise errs[0]
    return out


def close(got, want, rtol=1e-5, rel_atol=1e-6):
    """f32 sums in another order: rtol 1e-5, atol 1e-6 of the largest."""
    want = torch.as_tensor(np.array(want))
    torch.testing.assert_close(got.detach().to(want.dtype), want, rtol=rtol,
                               atol=rel_atol * float(want.abs().max()))


# ---------------------------------------------------------------------------
# configurations (tests/test_sharded.py, tests/test_vol_sharded.py)
# ---------------------------------------------------------------------------

def _orbit(pkg, n, det, z, fov=45, span=2 * np.pi):
    return sum(pkg.ConeRectGeom(det, pos=(2 * np.cos(t), 2 * np.sin(t), z),
                                fov=(fov, fov))
               for t in np.linspace(0, span, n, endpoint=False))


CONFIGS = {
    # test_sharded.py:13-24
    "setup": lambda pkg: (pkg.SphericalGrid(shape=(8, 8, 8)),
                          _orbit(pkg, 5, (6, 7), 0.4)),
    # :65-72, 15 rays
    "uneven": lambda pkg: (pkg.SphericalGrid(shape=(5, 5, 5)),
                           pkg.ConeRectGeom((3, 5), pos=(2.0, 0.3, 0.2),
                                            fov=(40, 40))),
    # :75-86
    "dyn4d": lambda pkg: (pkg.SphericalGrid(shape=(4, 6, 6, 6)),
                          _orbit(pkg, 4, (5, 5), 0.3, span=np.pi)),
    # :89-97, on a 4-device submesh
    "submesh": lambda pkg: (pkg.SphericalGrid(shape=(5, 5, 5)),
                            pkg.ConeRectGeom((4, 4), pos=(2.0, 0.3, 0.2),
                                             fov=(40, 40))),
    # test_vol_sharded.py:17-30
    "vol": lambda pkg: (pkg.SphericalGrid(shape=(16, 12, 12)),
                        _orbit(pkg, 4, (8, 12), 0.4)),
}


def _inputs(name):
    grid, geom = CONFIGS[name](prt)
    rng = np.random.default_rng(sum(map(ord, name)))
    return (rng.random(tuple(grid.shape)), rng.random(tuple(geom.shape)))


def _mse_grad(fwd, adj, x, t):
    """The gradient of mean((A x - t)²): 2/N · Aᵀ(A x - t)."""
    y = np.asarray(fwd(x))
    return 2.0 / y.size * np.asarray(adj(y - t))


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX ShardedOperator's image of (x, 2x), gradient and ``.T`` of
    each config (forward only where the port's gradient and ``.T`` are held
    to the port's own unsharded operator instead)."""
    out = {}
    for name, mode, mesh in (("setup", "precomputed", jax_mesh()),
                             ("setup", "fused", jax_mesh()),
                             ("uneven", "precomputed", jax_mesh()),
                             ("dyn4d", "precomputed", jax_mesh()),
                             ("submesh", "precomputed",
                              jax_mesh(jax.devices()[:4]))):
        grid, geom = CONFIGS[name](srt)
        sop = JaxSharded(grid, geom, mesh=mesh, mode=mode, ftype=jnp.float64)
        x, t = _inputs(name)
        res = {"y2": np.asarray(sop(jnp.asarray(np.stack([x, 2 * x]))))}
        if name == "setup" and mode == "precomputed":
            res["T"] = np.asarray(sop.T(jnp.asarray(t)))
            res["g"] = 2.0 / t.size * np.asarray(
                sop.T(jnp.asarray(res["y2"][0] - t)))
        out[name, mode] = res
    return out


@pytest.fixture(scope="module")
def jax_on_port_trace(tmp_path_factory):
    """The JAX ``Operator(precomputed, float64)`` built on the port's f32
    trace (fed through the JAX package's trace cache): its image, the
    mean-square-loss gradient and ``.T`` of each config's inputs."""
    out = {}
    old = os.environ.get("SPH_TPU_TRACE_CACHE")
    try:
        for name in ("setup", "vol"):
            os.environ["SPH_TPU_TRACE_CACHE"] = str(
                tmp_path_factory.mktemp(name))
            jgrid, jgeom = CONFIGS[name](srt)
            path = srt.Operator(jgrid, jgeom, ftype=jnp.float64,
                                _compute=False)._trace_cache_path()
            grid, geom = CONFIGS[name](prt)
            lin, lens, n, rs = prt.ops.project.precompute_table(
                prt.ops.trace.GridSpec.from_grid(grid), geom.ray_starts,
                geom.rays, device="cpu")
            np.savez(path, lin=lin.numpy(), lens=lens.numpy().astype(
                np.float64), n=n, rs=np.asarray(rs))
            jop = srt.Operator(jgrid, jgeom, ftype=jnp.float64)
            x, t = (a.astype(np.float32).astype(np.float64)
                    for a in _inputs(name))
            out[name] = {"y": np.asarray(jop(jnp.asarray(x))),
                         "T": np.asarray(jop.T(jnp.asarray(t))),
                         "g": _mse_grad(lambda v: jop(jnp.asarray(v)),
                                        lambda v: jop.T(jnp.asarray(v)),
                                        x, t)}
    finally:
        if old is None:
            os.environ.pop("SPH_TPU_TRACE_CACHE", None)
        else:
            os.environ["SPH_TPU_TRACE_CACHE"] = old
    return out


def _drive(op, x, t):
    """A sharded or unsharded operator's image, mean-square-loss gradient
    and ``.T`` of (x, t)."""
    xt = x.clone().requires_grad_(True)
    y = op(xt)
    torch.mean((y - t) ** 2).backward()
    return y.detach(), xt.grad, op.T(t)


# ---------------------------------------------------------------------------
# ShardedOperator against the JAX ShardedOperator (float64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mode,D", [
    ("setup", "precomputed", 2), ("setup", "precomputed", 8),
    ("setup", "fused", 4), ("uneven", "precomputed", 4),
    ("dyn4d", "precomputed", 3), ("submesh", "precomputed", 4)])
def test_sharded_matches_jax(jax_sharded, name, mode, D):
    grid, geom = CONFIGS[name](prt)
    x, t = (torch.tensor(a) for a in _inputs(name))
    # the port's unsharded f64 operator (the fused mode's function too)
    ref = prt.Operator(grid, geom, mode="precomputed", ftype=F64,
                       device="cpu")
    want_y, want_g, want_T = _drive(ref, x, t)
    jx = jax_sharded[name, mode]

    def rank(mesh):
        sop = ShardedOperator(grid, geom, mesh=mesh, mode=mode, ftype=F64)
        assert sop._mode == mode
        return (sop(torch.stack([x, 2 * x])), *_drive(sop, x, t),
                sop._rows)

    res = run_ranks(D, rank)
    rows = [r[-1] for r in res]
    # contiguous ranges over every ray
    assert rows[0][0] == 0 and rows[-1][1] == ref._nrays
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    for y2, y, g, bt, _ in res:
        np.testing.assert_allclose(y2.numpy(), jx["y2"], rtol=0, atol=TOL64)
        assert torch.equal(y, y2[0])
        np.testing.assert_allclose(g.numpy(), jx.get("g", want_g),
                                   rtol=0, atol=TOL64)
        np.testing.assert_allclose(bt.numpy(), jx.get("T", want_T),
                                   rtol=0, atol=TOL64)
        # every rank holds the same full image and gradient
        assert torch.equal(y, res[0][1]) and torch.equal(g, res[0][2])


# ---------------------------------------------------------------------------
# the routed kernels' shards (float32; the plain versions on the CPU)
# ---------------------------------------------------------------------------

PAIRS = {
    "auto": dict(),
    "off": dict(routed_dense="off"),
    "both": dict(routed_dense="both"),
    "fwd": dict(routed_dense="fwd"),
    "hist": dict(routed_fwd_reduce="hist"),
    "window": dict(routed_banded=False),
    "auto-r": dict(routed_voxel_order="r"),
}


def _assert_rows_of(got, full, lo, hi):
    """``got`` is bitwise rows [lo, hi) of the table set ``full`` built
    over every ray: the CSR's rows, the transpose's crossings of those
    rays in their order, the voxels' pointers counted again."""
    assert (got.n_rays, got.n_vox) == (hi - lo, full.n_vox)
    if isinstance(full, prt.ops.routed_project.WindowTables):
        # whole tiles of WIN_G rays: every ray on one rank at this size
        assert (lo, hi) in ((0, full.n_rays), (full.n_rays, full.n_rays))
        assert got.nnz == (full.nnz if lo < hi else 0)
        if lo < hi:
            assert all(a == b if isinstance(a, int) else torch.equal(a, b)
                       for a, b in zip(got, full))
        return
    if full.row_ptr is not None:
        a, b = int(full.row_ptr[lo]), int(full.row_ptr[hi])
        assert torch.equal(got.row_ptr, full.row_ptr[lo:hi + 1] - a)
        assert torch.equal(got.col, full.col[a:b])
        assert torch.equal(got.val, full.val[a:b])
    if full.vox_ptr is not None:
        keep = (full.ray >= lo) & (full.ray < hi)
        assert torch.equal(got.ray, full.ray[keep] - lo)
        assert torch.equal(got.valT, full.valT[keep])
        vox = torch.repeat_interleave(torch.arange(full.n_vox),
                                      torch.diff(full.vox_ptr).long())[keep]
        assert torch.equal(torch.diff(got.vox_ptr).long(),
                           torch.bincount(vox, minlength=full.n_vox))


@pytest.mark.parametrize("pair", PAIRS)
def test_routed_shards(jax_on_port_trace, pair):
    """Each kernel pair's per-rank tables on four ranks: the image,
    gradient and ``.T`` against the port's unsharded operator and the JAX
    one; each rank's tables, built from its own rays alone, bitwise its
    rows of the unsharded tables, and the ranks' nnz summing to the
    unsharded nnz; ``with_payload`` bitwise."""
    grid, geom = CONFIGS["setup"](prt)
    cfg = prt.TraceConfig(mode="routed", **PAIRS[pair])
    x, t = (torch.tensor(a, dtype=torch.float32) for a in _inputs("setup"))
    ref = prt.Operator(grid, geom, config=cfg, device="cpu")
    want = _drive(ref, x, t)
    jx = jax_on_port_trace["setup"]

    def rank(mesh):
        sop = ShardedOperator(grid, geom, mesh=mesh, config=cfg)
        _assert_rows_of(sop._tables, ref._tables, *sop._rows)
        with torch.no_grad():
            same = torch.equal(sop.with_payload(sop.payload)(x), sop(x))
        return (*_drive(sop, x, t), sop._tables.nnz, same)

    res = run_ranks(4, rank)
    assert sum(r[3] for r in res) == ref._tables.nnz
    for y, g, bt, _, same in res:
        assert same
        for got, w in zip((y, g, bt), want):
            close(got, w)
        for got, key in zip((y, g, bt), ("y", "g", "T")):
            close(got, jx[key])


@pytest.mark.parametrize("mode", ["precomputed", "auto", "window", "fused"])
def test_more_ranks_than_rays(mode):
    """3 rays over 4 ranks: the last rank holds none, launches nothing,
    still takes part in both sums, and no rank hangs."""
    grid = prt.SphericalGrid(shape=(5, 5, 5))
    geom = prt.ViewGeom(np.array([[2.0, 0.3, 0.2], [2.0, -0.2, 0.1],
                                  [0.3, 2.0, -0.2]]),
                        np.array([[-1.0, 0.0, 0.0], [-1.0, 0.1, 0.0],
                                  [0.0, -1.0, 0.1]]))
    kw = (dict(mode="precomputed", ftype=F64) if mode == "precomputed"
          else dict(mode="fused") if mode == "fused"
          else dict(config=prt.TraceConfig(
              mode="routed", routed_banded=mode != "window")))
    dt = F64 if mode == "precomputed" else torch.float32
    x, t = (torch.tensor(a, dtype=dt) for a in _inputs("uneven"))
    t = t.reshape(-1)[:3]
    want = _drive(prt.Operator(grid, geom, device="cpu", **kw), x, t)

    def rank(mesh):
        sop = ShardedOperator(grid, geom, mesh=mesh, **kw)
        return (*_drive(sop, x, t), sop._rows)

    res = run_ranks(4, rank)
    assert any(r[-1][0] == r[-1][1] for r in res)
    for y, g, bt, _ in res:
        for got, w in zip((y, g, bt), want):
            close(got, w, rtol=1e-12 if dt == F64 else 1e-5)


# ---------------------------------------------------------------------------
# VolShardedOperator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair,D", [("auto", 2), ("auto", 4), ("off", 4),
                                    ("window", 4), ("auto-r", 4)])
def test_vol_sharded(jax_on_port_trace, pair, D):
    """Image, gradient and ``.T`` against the JAX unsharded operator and the
    port's; the slabs' nnz sum exactly to the unsharded nnz (each live
    crossing in one slab)."""
    grid, geom = CONFIGS["vol"](prt)
    cfg = prt.TraceConfig(**PAIRS[pair])
    x, t = (torch.tensor(a, dtype=torch.float32) for a in _inputs("vol"))
    ref = prt.Operator(grid, geom, config=cfg.replace(mode="routed"),
                       device="cpu")
    want = _drive(ref, x, t)
    jx = jax_on_port_trace["vol"]

    def rank(mesh):
        sop = VolShardedOperator(grid, geom, mesh=mesh, config=cfg)
        return (*_drive(sop, x, t), sop._tables.nnz, sop._vox)

    res = run_ranks(D, rank)
    assert sum(r[3] for r in res) == ref._tables.nnz
    assert res[-1][4][1] == ref._flat_size
    for y, g, bt, _, _ in res:
        for got, w in zip((y, g, bt), want):
            close(got, w)
        for got, key in zip((y, g, bt), ("y", "g", "T")):
            close(got, jx[key])


def test_view_times_shards():
    """``view_times`` (lerp-doubled tables) through the ray- and the
    volume-sharded routed builds, against the unsharded operator
    (tests/test_sharded.py:300-342's configuration)."""
    grid = prt.SphericalGrid(shape=(3, 6, 6, 6), size_t=(0.0, 10.0))
    geom = _orbit(prt, 5, (4, 4), 0.3, span=np.pi)
    times = np.linspace(1.0, 9.0, 5)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.random(tuple(grid.shape)), dtype=torch.float32)
    t = torch.tensor(rng.random(tuple(geom.shape)), dtype=torch.float32)
    want = _drive(prt.Operator(grid, geom, mode="routed", view_times=times,
                               device="cpu"), x, t)

    def rank(mesh):
        return [_drive(cls(grid, geom, mesh=mesh, view_times=times,
                           **kw), x, t)
                for cls, kw in ((ShardedOperator, dict(mode="routed")),
                                (VolShardedOperator, {}))]

    for per_rank in run_ranks(3, rank):
        for got in per_rank:
            for a, w in zip(got, want):
                close(a, w)


def test_gd_two_ranks():
    """``retrieval.gd``, 3 iterations, through a two-rank ShardedOperator
    at 'auto': the same coefficients on both ranks, and the unsharded
    run's at rtol 1e-6."""
    grid, geom = CONFIGS["setup"](prt)
    x, _ = _inputs("setup")
    ref = prt.Operator(grid, geom, mode="routed", device="cpu")
    y = ref(torch.tensor(x, dtype=torch.float32)).detach()

    def run(op):
        c, _, losses = prt.retrieval.gd(op, y, prt.models.FullyDenseModel(
            grid), num_iterations=3, progress_bar=False)
        return c, next(iter(losses.values()))

    want_c, want_h = run(ref)
    res = run_ranks(2, lambda mesh: run(ShardedOperator(
        grid, geom, mesh=mesh, mode="routed")))
    assert torch.equal(res[0][0], res[1][0])
    for c, h in res:
        torch.testing.assert_close(c, want_c, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(h, want_h, rtol=1e-6)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_shard_rays_and_ranges():
    for n, size, block in ((15, 4, 1), (3, 4, 1), (2100, 3, 1024),
                           (0, 2, 1)):
        ranges = [ray_range(n, size, r, block) for r in range(size)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(lo % block == 0 for lo, hi in ranges if lo < hi)
    _, geom = CONFIGS["uneven"](prt)
    parts = [shard_rays(Mesh(None, r, 4, torch.device("cpu")),
                        geom.ray_starts, geom.rays) for r in range(4)]
    assert [p[0].shape[0] for p in parts] == [4, 4, 4, 3]
    assert all(p[2] == 15 and p[3] == (3, 5) for p in parts)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]),
                                  np.asarray(geom.rays).reshape(-1, 3))


def test_make_mesh_and_distributed_init(tmp_path):
    """A world-1 gloo group through a ``file://`` store: ``make_mesh`` on
    the CPU when asked and a ShardedOperator on it (mesh=None),
    ``make_mesh(n)`` over the world size raises, a second
    ``distributed_init`` is a no-op."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="distributed_init"):
        make_mesh(device="cpu")
    distributed_init(f"file://{tmp_path}/store", num_processes=1,
                     process_id=0, device="cpu")
    try:
        group = dist.group.WORLD
        distributed_init(f"file://{tmp_path}/other", num_processes=1,
                         process_id=0, device="cpu")
        assert dist.group.WORLD is group
        mesh = make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert make_mesh(1, device="cpu").size == 1
        with pytest.raises(ValueError):
            make_mesh(2, device="cpu")
        grid, geom = CONFIGS["uneven"](prt)
        x = torch.tensor(_inputs("uneven")[0], dtype=torch.float32)
        sop = ShardedOperator(grid, geom, mode="routed", device="cpu")
        assert sop.mesh == mesh
        assert torch.equal(sop(x), prt.Operator(grid, geom, mode="routed",
                                                device="cpu")(x))
        with pytest.raises(ValueError, match="not both"):
            ShardedOperator(grid, geom, mesh=mesh, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["gloo", None])
def test_make_mesh_gives_the_cpu_only_when_asked(tmp_path, monkeypatch,
                                                 backend):
    """A default group that ``distributed_init`` did not make (a bare
    ``init_process_group``, with gloo or with no backend named): neither
    ``make_mesh()`` nor the operators' default mesh runs on the CPU unless
    it is asked for (here, with no card, they raise); and a group whose
    backend carries no tensors of the asked device type is refused."""
    dist.init_process_group(backend=backend,
                            init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        grid, geom = CONFIGS["uneven"](prt)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedOperator(grid, geom, mode="routed")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VolShardedOperator(grid, geom)
        assert make_mesh(device="cpu").device == torch.device("cpu")
        monkeypatch.setattr(dist, "get_backend_config",
                            lambda group=None: "cuda:nccl")
        with pytest.raises(ValueError, match="carries no cpu tensors"):
            make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_vol_sharded_refuses_f64():
    grid, geom = CONFIGS["uneven"](prt)
    mesh = Mesh(None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="float32"):
        VolShardedOperator(grid, geom, mesh=mesh, ftype=F64)
    with pytest.raises(ValueError, match="not in the mesh"):
        ShardedOperator(grid, geom, mesh=Mesh(None, -1, 1, mesh.device))


# ---------------------------------------------------------------------------
# the JAX package's positional orders and sharded_project
# ---------------------------------------------------------------------------

def test_positional_calls_match_keyword_forms(tmp_path):
    """On a one-rank gloo group, the calls the JAX package's signatures
    make valid: ``make_mesh(None, "rays")``, ``shard_rays(mesh, xs, rays,
    "rays", 1)``, ``ShardedOperator(grid, geom, mesh, True, cfg)`` and
    ``VolShardedOperator(grid, geom, mesh, cfg, np.float32)`` each give
    their keyword form's result, bitwise; another axis name is kept on
    the mesh and refused by ``shard_rays``."""
    distributed_init(f"file://{tmp_path}/store", num_processes=1,
                     process_id=0, device="cpu")
    try:
        mesh = make_mesh(None, "rays", device="cpu")
        assert mesh == make_mesh(device="cpu") and mesh.axis == "rays"
        assert make_mesh(None, "r", device="cpu").axis == "r"
        grid, geom = CONFIGS["dyn4d"](prt)
        for got, want in zip(
                shard_rays(mesh, geom.ray_starts, geom.rays, "rays", 1),
                shard_rays(mesh, geom.ray_starts, geom.rays, block=1)):
            np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="axis"):
            shard_rays(mesh, geom.ray_starts, geom.rays, "r")
        cfg = prt.TraceConfig(mode="routed")
        x = torch.tensor(_inputs("dyn4d")[0], dtype=torch.float32)
        pos = ShardedOperator(grid, geom, mesh, True, cfg)
        kw = ShardedOperator(grid, geom, mesh=mesh, dynamic=True,
                             config=cfg)
        assert pos.dynamic and pos.config == kw.config
        assert torch.equal(pos(x), kw(x))
        grid, geom = CONFIGS["uneven"](prt)
        x = torch.tensor(_inputs("uneven")[0], dtype=torch.float32)
        vpos = VolShardedOperator(grid, geom, mesh, cfg, np.float32)
        vkw = VolShardedOperator(grid, geom, mesh=mesh, config=cfg,
                                 ftype=torch.float32)
        assert torch.equal(vpos(x), vkw(x))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name,pallas", [
    ("setup", False), ("uneven", False), ("uneven", True), ("dyn4d", False),
    ("dyn4d", True)])
def test_sharded_project(request, name, pallas):
    """``sharded_project`` in the JAX argument order on two ranks, each
    with its ``shard_rays`` range and time offsets t·V: every rank's image
    of every ray and its gradient of a sum of squares (summed over the
    mesh) against the unsharded projection of all rays, ``project_fused``
    at float64 (image bitwise, gradient rtol 1e-12) or, with ``pallas``,
    the fused engine at float32 (image bitwise, gradient rtol 1e-6): the
    ranks sum the gradient in another order.  At ``setup`` the image is
    also held to the JAX ``ShardedOperator(mode='fused')``'s, which runs
    the JAX ``sharded_project`` (atol 1e-10, as
    ``test_sharded_matches_jax``)."""
    grid, geom = CONFIGS[name](prt)
    dt = torch.float32 if pallas else F64
    gs = GridSpec.from_grid(grid, dt)
    x, t = _inputs(name)
    flat2 = torch.tensor(np.stack([x, 2 * x]).reshape(2, -1), dtype=dt)
    t = torch.tensor(t.reshape(-1), dtype=dt)
    xs, rays = (a.reshape(-1, 3) for a in np.broadcast_arrays(
        geom.ray_starts, geom.rays))
    n = len(xs)
    off = np.zeros(n, np.int32)
    if grid.dynamic:  # each view sees its time bin
        off = np.repeat(np.arange(geom.shape[0]) * (flat2.shape[1] //
                        grid.shape.t), n // geom.shape[0]).astype(np.int32)

    def drive(fn):
        d = flat2.clone().requires_grad_(True)
        y = fn(d)
        torch.sum((y - t) ** 2).backward()
        return y.detach(), d.grad

    if pallas:
        want = drive(lambda d: torch.stack([fused_pallas_project(
            gs, c, xs, rays, view_offsets=off) for c in d]))
    else:
        want = drive(lambda d: project_fused(gs, d, xs, rays,
                                             view_offsets=off, block=4))

    def rank(mesh):
        rxs, rrays, _, _ = shard_rays(mesh, geom.ray_starts, geom.rays,
                                      "rays", 1)
        lo, hi = ray_range(n, mesh.size, mesh.rank)
        return drive(lambda d: sharded_project(
            mesh, gs, d, rxs, rrays, off[lo:hi], 4, "int32", "rays",
            pallas))

    jax_y2 = (request.getfixturevalue("jax_sharded")[name, "fused"]["y2"]
              if name == "setup" else None)
    for y, g in run_ranks(2, rank):
        assert torch.equal(y, want[0])
        torch.testing.assert_close(g, want[1],
                                   rtol=1e-6 if pallas else 1e-12, atol=0)
        if jax_y2 is not None:
            np.testing.assert_allclose(y.numpy(), jax_y2.reshape(2, -1),
                                       rtol=0, atol=TOL64)


# ---------------------------------------------------------------------------
# two real processes (gloo), marked slow
# ---------------------------------------------------------------------------

def _two_process_rank(rank, store_path, queue):
    try:
        distributed_init(f"file://{store_path}", num_processes=2,
                         process_id=rank, device="cpu")
        grid, geom = CONFIGS["setup"](prt)
        x, t = (torch.tensor(a, dtype=torch.float32)
                for a in _inputs("setup"))
        out = [_drive(cls(grid, geom, device="cpu", **kw), x, t)
               for cls, kw in ((ShardedOperator, dict(mode="routed")),
                               (VolShardedOperator, {}))]
        queue.put((rank, [[a.numpy() for a in o] for o in out]))
        dist.destroy_process_group()
    except BaseException as e:  # noqa: B036 - reported to the parent
        queue.put((rank, repr(e)))


@pytest.mark.slow
def test_two_processes(tmp_path):
    """Two gloo processes: both sharded operators' image and gradient
    against the unsharded operator."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_two_process_rank,
                         args=(r, str(tmp_path / "store"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(60)
        assert not p.is_alive()
    grid, geom = CONFIGS["setup"](prt)
    x, t = (torch.tensor(a, dtype=torch.float32) for a in _inputs("setup"))
    want = _drive(prt.Operator(grid, geom, mode="routed", device="cpu"),
                  x, t)
    for r in range(2):
        assert not isinstance(got[r], str), got[r]
        for per_op in got[r]:
            for a, w in zip(per_op, want):
                close(torch.tensor(a), w)
