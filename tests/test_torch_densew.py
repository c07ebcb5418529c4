"""The window-major forward ``routed_fwd_densew`` (B8) and its probe.

On the CPU the wrapper runs its plain version.  The JAX side runs B8
itself, ``_fwd_banded_densew_pallas``, in interpret mode on tables that
the JAX router builds from the port's f32 trace (no JAX ``Operator``: its
trace compile would cost seconds), as ``tools/wfwd_probe.py`` builds them:
``build_routed_tables`` → ``band_pack_dense(by='window', slot_pad=8)`` →
``banded_device_wfwd``.  Its ray r is ``y[:T].reshape(-1)[r]``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import routed_project as rp
from sph_raytracer_tpu_torch.tools import wfwd_probe

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)  # f32 sums in another order
TINY = ((16, 8, 16), 4, (6, 8))  # (vol_shape, n_views, det_shape)


@pytest.fixture(scope="module")
def traced():
    """The port's f32 trace of a 4-view orbit through a (16, 8, 16) grid:
    192 rays, 2,048 voxels; on the JAX side (128-ray tiles, 1,024-voxel
    windows) 2 ray tiles and 2 windows."""
    grid = prt.SphericalGrid(shape=(16, 8, 16))
    geom = sum(
        prt.ConeRectGeom((6, 8), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 4, endpoint=False))
    lin, lens, _, _ = prt.ops.project.precompute_table(
        prt.ops.trace.GridSpec.from_grid(grid), geom.ray_starts, geom.rays,
        device="cpu")
    return lin, lens, int(np.prod(grid.shape))


def test_densew_matches_jax_pallas(traced):
    from sph_raytracer_tpu.ops.route import (band_pack_dense,
                                             build_routed_tables)
    from sph_raytracer_tpu.ops.routed_project import (
        _fwd_banded_densew_pallas, banded_device_wfwd)

    lin, lens, V = traced
    R = lin.shape[0]
    # the numpy router (the native one costs a library load here)
    rt = build_routed_tables(lin.numpy(), lens.numpy(), V, G=128, SR=8, KD=3,
                             use_native=False)
    ft, meta = banded_device_wfwd(band_pack_dense(rt, by="window",
                                                  slot_pad=8))
    assert (R, V, int((lens != 0).sum())) == (192, 2048, 3078)
    assert rt.T >= 2 and rt.H // 8 >= 2  # ray tiles, density windows
    d = np.random.default_rng(0).random(V).astype(np.float32)
    d2 = np.zeros((rt.H, 128), np.float32)
    d2.reshape(-1)[:V] = d
    # called once, eagerly: a jit would add its compile
    y = _fwd_banded_densew_pallas(jnp.asarray(d2), ft, meta, 8,
                                  interpret=True)
    want = np.asarray(y)[:rt.T].reshape(-1)[:R]
    w = rp.build_window_tables(lin, lens, V, G=64, W=128)
    assert (w.n_tiles, w.n_win) == (3, 16)
    got = rp.routed_fwd_densew(w, torch.tensor(d))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("G,W", [(g, w) for g in (16, 64, 256, 1024)
                                 for w in (32, 128, 256, 1024)])
def test_densew_adjoint_and_window_forward(traced, G, W):
    """On chunk tables of several tile and window sizes (one tile or many,
    2 to 64 windows): B8's y equals a dense A·d; <A_B8 x, y> == <x, A_B7bᵀ
    y>; and B8's y equals B7a's, since for each ray both plain versions
    add the same crossings in the same order (windows ascending, trace
    order within a window)."""
    lin, lens, V = traced
    t = rp.build_window_tables(lin, lens, V, G=G, W=W)
    assert (t.n_tiles, t.n_win) == (-(-192 // G), -(-V // W))
    live = (lens != 0).numpy()
    A = np.zeros((t.n_rays, V))
    np.add.at(A, (np.nonzero(live)[0], lin.numpy()[live]),
              lens.numpy()[live])
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=V), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=t.n_rays), dtype=torch.float32)
    ax = rp.routed_fwd_densew(t, x)
    np.testing.assert_allclose(ax.numpy(), A @ x.double().numpy(), **TOL)
    lhs = float(torch.dot(ax, y))
    rhs = float(torch.dot(x, rp.routed_bwd_window(t, y)))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))
    assert torch.equal(ax, rp.routed_fwd_window_ref(t, x))


def test_probe_on_cpu():
    rp.reset_launches()
    res = wfwd_probe.probe(TINY, device="cpu")
    assert [r["name"] for r in res["kernels"]] == [
        "routed_fwd", "routed_fwd_window", "routed_fwd_densew"]
    assert set(rp.LAUNCHES.values()) == {0}  # plain versions only
    want = res["y"]["routed_fwd"]
    for r in res["kernels"]:
        assert r["ms"] is None
        assert r["table_bytes"] > 0 and r["bound_ms"] > 0
        torch.testing.assert_close(res["y"][r["name"]], want, **TOL)
        assert r["max_abs_diff_vs_routed_fwd"] <= 1e-5 * float(
            want.abs().max())
    win = res["win"]
    b8 = res["kernels"][2]
    assert b8["chunks"] == win.ckey.shape[0] == res["kernels"][1]["chunks"]
    # one atomic per (ray, chunk) run, more where a run crosses a warp's
    # 32-crossing slice; fewer than one a crossing
    assert 0 < res["runs"] <= b8["atomics"] < res["nnz"] == win.nnz


def test_densew_atomics_counts_runs_and_slices():
    """Two chunks of one tile, each a work item of its own window: rays
    0,0,1 in the first; 40 crossings of ray 2 in the second (a 32-crossing
    slice boundary inside the run).  An atomic a run in each warp's
    32-crossing slice of an item's walk: 2 in the first item, 2 in the
    second."""
    lin = torch.tensor([[0, 1] + [0] * 39, [2] + [0] * 40, [300] * 41],
                       dtype=torch.int32)
    lens = torch.zeros(3, 41)
    lens[0, :2] = lens[1, 0] = 1.0
    lens[2, :40] = 1.0
    t = rp.build_window_tables(lin, lens, 512, G=4, W=256)
    assert len(t.ckey) == 2 and t.nnz == 43 and t.n_items == 2
    assert wfwd_probe.densew_atomics(t) == (3, 4)


@pytest.mark.parametrize("a,b,atomics", [
    (1, 1, 2), (31, 1, 2), (32, 1, 2), (33, 40, 4), (5, 100, 5),
    # ray 0 over slices 0-4, ray 1 inside slice 4
    (129, 4, 6),
    # each ray over two whole slices
    (64, 64, 4),
    # ray 1 from slice 0 to slice 6
    (1, 200, 8)])
def test_densew_atomics_in_one_chunk(a, b, atomics):
    """Ray 0 with ``a`` crossings, then ray 1 with ``b``, in one chunk (one
    work item): two runs; an atomic at each run's start and at each
    32-crossing slice."""
    lin = torch.zeros(2, max(a, b), dtype=torch.int32)
    lens = torch.zeros(2, max(a, b))
    lens[0, :a] = lens[1, :b] = 1.0
    t = rp.build_window_tables(lin, lens, 256, G=4, W=256)
    assert len(t.ckey) == 1 and t.nnz == a + b
    assert wfwd_probe.densew_atomics(t) == (2, atomics)


@pytest.mark.parametrize("dtype,shape,match", [
    (torch.float64, (2048,), "must be float32"),
    (torch.float16, (2048,), "must be float32"),
    (torch.int32, (2048,), "must be float32"),
    (torch.float32, (2049,), r"must be float32 of shape \(2048,\)"),
    (torch.float32, (1, 2048), r"must be float32 of shape \(2048,\)"),
    (torch.float32, (2048,), "CUDA kernels take CUDA tensors"),
])
def test_densew_rejects_wrong_input(traced, dtype, shape, match):
    """A CPU density runs the plain version; anything else goes to the
    kernel, which takes only a float32 CUDA tensor of shape (V,) = (2048,)
    (a ``meta`` tensor stands in for one on another device)."""
    lin, lens, V = traced
    t = rp.build_window_tables(lin, lens, V, G=64, W=128)
    with pytest.raises(ValueError, match=match):
        rp.routed_fwd_densew(t, torch.ones(shape, dtype=dtype, device="meta"))
