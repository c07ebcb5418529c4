"""Port ``Operator`` vs the reference goldens and the JAX package.

* ``mode='precomputed'`` (float64, CPU) against the goldens of
  tests/test_parity.py, at that file's tolerances.
* ``mode='routed'`` on the CPU, which runs the plain PyTorch versions of
  the CUDA kernels, against the JAX package's routed operator with its
  Pallas kernels in interpret mode, for both backward variants.
* The routed plain versions against each other and the adjoint identity.
* Dynamic 4D and ``view_times`` against the JAX package.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import routed_project as rp

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
F64 = torch.float64


def load(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


def _orbit(pkg, n=5, npix=6):
    return sum(
        pkg.ConeRectGeom((npix, npix),
                         pos=(2 * np.cos(t), 2 * np.sin(t), 0.5),
                         lookdir=(0.35 - 2 * np.cos(t), 0.2 - 2 * np.sin(t),
                                  -0.5), fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, n, endpoint=False))


# configurations copied from tests/test_parity.py:58-105 and :122-132
GOLDENS = {
    "conerect": (
        lambda: prt.SphericalGrid(shape=(12, 14, 16), size_r=(0.3, 1.0)),
        lambda: prt.ConeRectGeom((10, 12), pos=(1.8, 0.4, 0.3),
                                 fov=(40, 35)), {}),
    # the reference's ConeCircGeom.theta is float32, so its rays carry
    # ~1e-7 noise (tests/test_parity.py:74-78)
    "conecirc_log": (
        lambda: prt.SphericalGrid(shape=(10, 9, 11), size_r=(0.1, 1.0),
                                  spacing="log"),
        lambda: prt.ConeCircGeom((8, 12), pos=(0.459903, 1.833782,
                                               -0.412418), fov=(5, 35)),
        dict(atol_img=5e-6, atol_grad=5e-6, atol_rays=1e-6)),
    "parallel_partial": (
        lambda: prt.SphericalGrid(r_b=np.linspace(0, 1, 9),
                                  e_b=np.linspace(0.3, 2.8, 8),
                                  a_b=np.linspace(-2.0, 2.5, 10)),
        lambda: prt.ParallelGeom((9, 7), pos=(2.0, -0.3, 0.2),
                                 lookdir=(-2.0, 0.45, -0.1),
                                 size=(1.8, 1.6)), {}),
    "collection_orbit": (lambda: prt.SphericalGrid(shape=(8, 8, 8)),
                         lambda: _orbit(prt), {}),
    "dynamic4d": (
        lambda: prt.SphericalGrid(shape=(4, 6, 6, 6)),
        lambda: sum(
            prt.ConeRectGeom((5, 5), pos=(2 * np.cos(t), 2 * np.sin(t), 0.2),
                             lookdir=(0.3 - 2 * np.cos(t),
                                      0.25 - 2 * np.sin(t), -0.2),
                             fov=(45, 45))
            for t in np.linspace(0, np.pi, 4, endpoint=False)), {}),
}


def assert_golden_parity(op, g, atol_img=1e-6, atol_grad=1e-6,
                         atol_rays=1e-12):
    """tests/test_parity.py's checks: rays, image, loss, gradient."""
    rays = np.broadcast_to(np.asarray(op.geom.rays), g["rays"].shape)
    assert np.allclose(rays, g["rays"], atol=atol_rays)
    density = torch.tensor(g["density"], dtype=F64, requires_grad=True)
    img = op(density)
    assert np.allclose(img.detach().numpy(), g["image"], rtol=1e-5,
                       atol=atol_img), np.abs(img.detach().numpy()
                                              - g["image"]).max()
    loss = torch.mean((img - torch.tensor(g["grad_target"])) ** 2)
    loss.backward()
    assert np.isclose(loss.item(), float(g["loss"]), rtol=1e-6)
    grad = density.grad.numpy()
    assert np.allclose(grad, g["grad"], rtol=1e-5, atol=atol_grad), \
        np.abs(grad - g["grad"]).max()


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_precomputed_golden_parity(name):
    grid_fn, geom_fn, tol = GOLDENS[name]
    op = prt.Operator(grid_fn(), geom_fn(), ftype=F64, device="cpu")
    assert op._mode == "precomputed"
    assert_golden_parity(op, load(name), **tol)


def test_adjoint_golden_parity():
    g = load("adjoint")
    grid = prt.SphericalGrid(shape=(7, 8, 9))
    geom = prt.ConeRectGeom((6, 7), pos=(1.7, -0.5, 0.4),
                            lookdir=(-1.55, 0.75, -0.35), fov=(40, 40))
    op = prt.Operator(grid, geom, ftype=F64, device="cpu")
    bp = op.T(g["y"]).numpy()
    assert np.allclose(bp, g["backprojection"], rtol=1e-5, atol=1e-6), \
        np.abs(bp - g["backprojection"]).max()


# ---------------------------------------------------------------------------
# routed mode (plain versions on the CPU) vs the JAX routed engine
# ---------------------------------------------------------------------------

def _routed_problem(pkg):
    grid = pkg.SphericalGrid(shape=(16, 8, 8))
    geom = sum(
        pkg.ConeRectGeom((6, 6), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 3, endpoint=False))
    return grid, geom


def _jax_routed_on_port_trace(cfg, monkeypatch, tmp_path):
    """The JAX routed operator built from the port's own f32 trace, fed
    through the JAX package's trace cache (``SPH_TPU_TRACE_CACHE``).

    Both packages' f32 traces carry ~1e-5 relative rounding noise in the
    cone crossings (cancellation in the quadratic; XLA's fused program
    rounds differently from its own eager run), so the same tables are
    given to both sides: the comparison then holds the kernels' math."""
    jgrid, jgeom = _routed_problem(srt)
    monkeypatch.setenv("SPH_TPU_TRACE_CACHE", str(tmp_path))
    path = srt.Operator(jgrid, jgeom, config=cfg,
                        _compute=False)._trace_cache_path()
    grid, geom = _routed_problem(prt)
    lin, lens, n, rs = prt.ops.project.precompute_table(
        prt.ops.trace.GridSpec.from_grid(grid), geom.ray_starts, geom.rays,
        device="cpu")
    np.savez(path, lin=lin.numpy(), lens=lens.numpy(), n=n,
             rs=np.asarray(rs))
    return srt.Operator(jgrid, jgeom, config=cfg)


@pytest.mark.parametrize("dense,jax_dense_bwd,port_bwd", [
    ("auto", True, rp.routed_bwd_gather),     # B2 <-> routed_bwd_gather
    ("off", False, rp.routed_bwd_scatter),    # B3 <-> routed_bwd_scatter
])
def test_routed_matches_jax_routed(dense, jax_dense_bwd, port_bwd,
                                   monkeypatch, tmp_path):
    jop = _jax_routed_on_port_trace(srt.TraceConfig(
        mode="routed", interpret=True, routed_g=128,
        routed_chunk_multiple=2, routed_dense=dense), monkeypatch, tmp_path)
    assert jop._dense == (False, jax_dense_bwd)
    grid, geom = _routed_problem(prt)
    op = prt.Operator(grid, geom, mode="routed", device="cpu",
                      config=prt.TraceConfig(routed_dense=dense))
    assert op._mode == "routed" and op._bwd is port_bwd

    rng = np.random.default_rng(0)
    x = rng.random(tuple(grid.shape)).astype(np.float32)
    target = rng.random(tuple(geom.shape)).astype(np.float32)

    def jloss(v):
        return jnp.mean((jop(v) - target) ** 2)

    jimg = np.asarray(jop(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(x)))

    xt = torch.tensor(x, requires_grad=True)
    img = op(xt)
    torch.mean((img - torch.tensor(target)) ** 2).backward()
    # f32 sums in another order than the Pallas kernels'
    np.testing.assert_allclose(img.detach().numpy(), jimg, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-6)
    # the adjoint runs the same backward
    np.testing.assert_allclose(op.T(jimg.copy()).numpy(),
                               np.asarray(jop.T(jnp.asarray(jimg))),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tables():
    grid, geom = _routed_problem(prt)
    op = prt.Operator(grid, geom, mode="precomputed", device="cpu")
    t = rp.build_tables(op.lin, op.lens, op._flat_size)
    return op, t


def test_tables_are_csr_of_the_trace(tables):
    op, t = tables
    live = op.lens != 0
    assert t.nnz == int(live.sum()) > 0
    assert torch.equal(t.row_ptr[1:] - t.row_ptr[:-1], live.sum(1).int())
    # the transpose lists each voxel's rays in ascending order (stable sort)
    vox = torch.repeat_interleave(torch.arange(t.n_vox),
                                  torch.diff(t.vox_ptr).long())
    key = vox * t.n_rays + t.ray.long()
    assert bool((torch.diff(key) >= 0).all())
    assert torch.equal(torch.sort(t.valT).values, torch.sort(t.val).values)


def test_plain_versions_agree(tables):
    """The three plain versions against each other and the table path."""
    op, t = tables
    rng = np.random.default_rng(1)
    d = torch.tensor(rng.random(t.n_vox), dtype=torch.float32)
    dy = torch.tensor(rng.normal(size=t.n_rays), dtype=torch.float32)
    np.testing.assert_allclose(
        rp.routed_fwd_ref(t, d).numpy(),
        prt.ops.project.project_table(d, op.lin, op.lens).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rp.routed_bwd_gather_ref(t, dy).numpy(),
                               rp.routed_bwd_scatter_ref(t, dy).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bwd", ["routed_bwd_gather_ref",
                                 "routed_bwd_scatter_ref"])
def test_adjoint_identity(tables, bwd):
    """<Ax, y> == <x, Aᵀy> for the forward and each backward."""
    _, t = tables
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=t.n_vox), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=t.n_rays), dtype=torch.float32)
    lhs = float(torch.dot(rp.routed_fwd_ref(t, x), y))
    rhs = float(torch.dot(x, getattr(rp, bwd)(t, y)))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))


def test_wrappers_take_plain_version_only_on_cpu(tables):
    """A CPU tensor runs the plain version; the kernel counters stay put."""
    _, t = tables
    rp.reset_launches()
    d = torch.ones(t.n_vox)
    assert torch.equal(rp.routed_fwd(t, d), rp.routed_fwd_ref(t, d))
    assert torch.equal(rp.routed_bwd_scatter(t, torch.ones(t.n_rays)),
                       rp.routed_bwd_scatter_ref(t, torch.ones(t.n_rays)))
    assert set(rp.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("mode", ["precomputed", "routed"])
def test_channels_and_adjoint(mode):
    grid, geom = _routed_problem(prt)
    op = prt.Operator(grid, geom, mode=mode, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.random((2, *grid.shape)), dtype=torch.float32)
    y = op(x)
    assert y.shape == (2, *geom.shape)
    for c in range(2):
        np.testing.assert_allclose(y[c].numpy(), op(x[c]).numpy(),
                                   rtol=1e-6)
    bp = op.T(y)
    assert bp.shape == (2, *grid.shape)
    np.testing.assert_allclose(bp[1].numpy(), op.T(y[1]).numpy(), rtol=1e-6)
    lhs, rhs = float(torch.sum(y * y)), float(torch.sum(x * bp))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.parametrize("mode", ["precomputed", "routed"])
def test_chord_invariant(mode):
    """Unit density in the shell r ∈ [0.2, 1]: an axis-aligned ray 1e-3
    off the axis integrates 2·(1 - 0.2) (tests/test_operator.py's oracle)."""
    grid = prt.SphericalGrid(shape=(7, 9, 11), size_r=(0.2, 1.0))
    off = 1e-3
    starts = np.array([[-5, off, off], [off, -5, -off], [off, off, 5]])
    dirs = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]])
    op = prt.Operator(grid, prt.ViewGeom(starts, dirs), mode=mode,
                      device="cpu")
    np.testing.assert_allclose(op(torch.ones(tuple(grid.shape))).numpy(),
                               2 * 0.8, atol=1e-2)


# ---------------------------------------------------------------------------
# 4D: view_times vs the JAX package
# ---------------------------------------------------------------------------

def _time_problem(pkg, V=6):
    grid = pkg.SphericalGrid(shape=(4, 5, 5, 5), size_t=(10.0, 40.0))
    geom = sum(
        pkg.ConeRectGeom((4, 4), pos=(2 * np.cos(t), 2 * np.sin(t), 0.3),
                         fov=(45, 45))
        for t in np.linspace(0, np.pi, V, endpoint=False))
    return grid, geom, np.linspace(11.0, 39.0, V)


def test_view_times_match_jax():
    jgrid, jgeom, times = _time_problem(srt)
    jop = srt.Operator(jgrid, jgeom, ftype=jnp.float64, view_times=times)
    grid, geom, _ = _time_problem(prt)
    op = prt.Operator(grid, geom, ftype=F64, view_times=times,
                      device="cpu")
    rng = np.random.default_rng(4)
    vol = rng.random(tuple(grid.shape))
    y = rng.normal(size=tuple(geom.shape))
    np.testing.assert_allclose(op(vol).numpy(), np.asarray(jop(vol)),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(op.T(y).numpy(), np.asarray(jop.T(y)),
                               rtol=1e-10, atol=1e-12)
    v = torch.tensor(vol, requires_grad=True)
    torch.sum(op(v) * torch.tensor(y)).backward()
    jg = jax.grad(lambda d: jnp.sum(jop(d) * y))(jnp.asarray(vol))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)


def test_view_times_routed_matches_precomputed():
    grid, geom, times = _time_problem(prt)
    ops = [prt.Operator(grid, geom, mode=m, view_times=times, device="cpu")
           for m in ("precomputed", "routed")]
    vol = torch.tensor(np.random.default_rng(5).random(tuple(grid.shape)),
                       dtype=torch.float32)
    a, b = (o(vol) for o in ops)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ops[1].T(a).numpy(), ops[0].T(a).numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# configuration surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("mode", "fused"), ("routed_dense", "fwd"), ("routed_dense", "both"),
    ("routed_fwd_reduce", "hist"), ("routed_banded", False),
    ("routed_w_dtype", "bf16"), ("trace_method", "ranked"),
])
def test_unported_values_raise(field, value):
    grid, geom = _routed_problem(prt)
    cfg = prt.TraceConfig(**{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prt.Operator(grid, geom, config=cfg, device="cpu")


def test_config_keeps_jax_field_names():
    import dataclasses

    names = {f.name for f in dataclasses.fields(srt.TraceConfig)}
    assert names == {f.name for f in dataclasses.fields(prt.TraceConfig)}
    grid, geom = _routed_problem(prt)
    with pytest.raises(ValueError):
        prt.Operator(grid, geom, mode="bogus", device="cpu")
    # f64 keeps the table path, as in the JAX package
    with pytest.warns(UserWarning, match="float32"):
        op = prt.Operator(grid, geom, mode="routed", ftype=F64, device="cpu")
    assert op._mode == "precomputed"
    with pytest.raises(OverflowError):
        prt.Operator(prt.SphericalGrid(shape=(2, 2, 128)), geom,
                     itype=torch.int8, device="cpu")
