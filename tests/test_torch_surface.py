"""The port's ``Operator`` surface and the modules on it, against the JAX
package: voxel orders, ``regs``, the debug tracer, ``payload`` /
``with_payload``, the serving export, plotting, profiling and the
autotuner.

On the CPU the kernel wrappers run their plain versions.  Parity with the
JAX package is checked in float64 ``mode='precomputed'`` on the same numpy
inputs; the routed voxel order ``'r'`` is held bitwise to ``'a'`` at
``routed_dense='auto'`` (the relabel keeps each ray's crossings in trace
order and the transpose's stable sort keeps each voxel's rays in order).
"""
import io
import os

import jax
import jax.numpy as jnp
import matplotlib
import matplotlib.animation
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu.ops import trace as jtrace
from sph_raytracer_tpu.utils.debug import debug_trace as jdebug_trace
from sph_raytracer_tpu_torch.ops import trace as ptrace
from sph_raytracer_tpu_torch.utils.debug import debug_trace
from sph_raytracer_tpu_torch.utils.export import export_operator, load_exported

matplotlib.use("Agg")
torch.set_num_threads(2)

F64 = torch.float64


# ---------------------------------------------------------------------------
# voxel orders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 3])
def test_voxel_order_matches_jax(T):
    rng = np.random.default_rng(T)
    vshape = (5, 3, 4)
    V = int(np.prod(vshape))
    lin = rng.integers(0, T * V, size=(7, 9)).astype(np.int32)
    want = jtrace.voxel_order_lin(lin, vshape, "r")
    got = ptrace.voxel_order_lin(lin, vshape, "r")
    assert got.dtype == np.int32 and np.array_equal(got, want)
    got_t = ptrace.voxel_order_lin(torch.from_numpy(lin), vshape, "r")
    assert got_t.dtype == torch.int32 and np.array_equal(got_t.numpy(), want)
    assert ptrace.voxel_order_lin(lin, vshape, "a") is lin
    # a bijection: flat'[lin'] == flat[lin] for every id
    ids = np.arange(T * V, dtype=np.int32)
    assert np.array_equal(np.sort(ptrace.voxel_order_lin(ids, vshape, "r")),
                          ids)
    flat = rng.random((2, T * V))
    fr = ptrace.voxel_order_flat(torch.from_numpy(flat), vshape, "r")
    np.testing.assert_array_equal(fr.numpy(), np.asarray(
        jtrace.voxel_order_flat(jnp.asarray(flat), vshape, "r")))
    assert np.array_equal(fr.numpy()[:, ptrace.voxel_order_lin(ids, vshape,
                                                               "r")],
                          flat[:, ids])
    back = ptrace.voxel_order_unflat(fr, vshape, "r")
    assert torch.equal(back, torch.from_numpy(flat))


def _orbit(pkg, n, det, z=0.4):
    return sum(pkg.ConeRectGeom(det, pos=(2 * np.cos(t), 2 * np.sin(t), z),
                                fov=(45, 45))
               for t in np.linspace(0, 2 * np.pi, n, endpoint=False))


ORDER_CASES = {
    "static": lambda: (prt.SphericalGrid(shape=(8, 6, 7)),
                       _orbit(prt, 3, (6, 6)), {}),
    "binned4d": lambda: (prt.SphericalGrid(shape=(3, 5, 4, 6)),
                         _orbit(prt, 3, (6, 6)), {}),
    "view_times": lambda: (
        prt.SphericalGrid(shape=(3, 5, 4, 6), size_t=(0.0, 2.0)),
        _orbit(prt, 4, (6, 6)), dict(view_times=[0.0, 0.5, 1.3, 2.0])),
}


def _fwd_grad_adj(op, x, y):
    v = x.clone().requires_grad_(True)
    img = op(v)
    (g,) = torch.autograd.grad(torch.mean((img - y) ** 2), v)
    return img.detach(), g, op.T(y)


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_routed_voxel_order_r(case):
    """routed_voxel_order='r' relabels the tables; forward (2 channels),
    gradient and ``.T`` are bitwise equal to 'a' at routed_dense='auto',
    and the pairs that sum over the transpose's rows or over windows
    agree at rtol 1e-5."""
    grid, geom, kw = ORDER_CASES[case]()
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(2, *grid.shape, generator=gen)
    y = torch.rand(2, *geom.shape, generator=gen)
    cfgs = [dict()] + ([dict(routed_dense="off"), dict(routed_dense="both"),
                        dict(routed_banded=False)] if case == "static"
                       else [])
    for cfg in cfgs:
        ops = {vo: prt.Operator(grid, geom, mode="routed", device="cpu",
                                config=prt.TraceConfig(
                                    routed_voxel_order=vo, **cfg), **kw)
               for vo in "ar"}
        assert ops["r"]._vorder == "r"
        a, r = (_fwd_grad_adj(ops[vo], x, y) for vo in "ar")
        for got, want in zip(r, a):
            if cfg:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
            else:
                assert torch.equal(got, want)
        if not cfg:  # the ray-major CSR on relabelled ids
            ta, tr = ops["a"]._tables, ops["r"]._tables
            assert torch.equal(tr.row_ptr, ta.row_ptr)
            assert torch.equal(tr.col, ptrace.voxel_order_lin(
                ta.col, grid.vshape, "r"))
            assert not torch.equal(tr.col, ta.col)
    # fused and precomputed modes keep 'a'
    cfg_r = prt.TraceConfig(routed_voxel_order="r")
    assert prt.Operator(grid, geom, mode="fused", device="cpu",
                        config=cfg_r, **kw)._vorder == "a"


# ---------------------------------------------------------------------------
# regs and the debug tracer against the JAX package (float64)
# ---------------------------------------------------------------------------

def _problem(pkg):
    grid = pkg.SphericalGrid(shape=(6, 6, 6), size_r=(1, 4))
    # an even width: an odd-width detector aimed at the origin sends its
    # central column through the z-axis, where the two packages' f64
    # crossings may split a zero-length segment differently (ROADMAP C)
    geom = pkg.ConeRectGeom((5, 6), (8, 0.5, 0.2), fov=(30, 30))
    return grid, geom


@pytest.fixture
def jit_trace(monkeypatch):
    """The JAX package's ``trace_crossings`` jitted, in place of the eager
    one that ``Operator.regs`` and ``debug_trace`` import at each call
    (the same function; eager it compiles op by op, ~5 s a shape)."""
    fn = jax.jit(jtrace.trace_crossings, static_argnums=0,
                 static_argnames=("itype", "ftype", "platform"))
    monkeypatch.setattr(jtrace, "trace_crossings", fn)


@pytest.fixture(scope="module")
def pair():
    """The JAX package's f64 precomputed operator and the port's."""
    jop = srt.Operator(*_problem(srt), mode="precomputed",
                       ftype=jnp.float64)
    op = prt.Operator(*_problem(prt), mode="precomputed", ftype=F64,
                      device="cpu")
    return jop, op


def _printed(fn, *a, **kw):
    buf = io.StringIO()
    out = fn(*a, out=buf, **kw)
    return out, buf.getvalue()


def test_regs_and_debug_match_jax(pair, jit_trace, capsys):
    jop, op = pair
    # the labels of every segment that carries length (the others label
    # points outside the grid, where an atan2 at ±pi may go either way)
    live = op.lens.reshape(tuple(op.geom.shape) + (-1,)).numpy() > 0
    assert np.array_equal(op.regs.numpy()[:, live],
                          np.asarray(jop.regs)[:, live])
    (jr, jl, jt), jtext = _printed(jdebug_trace, jop, los=(1, 2))
    (r, l, t), text = _printed(debug_trace, op, los=(1, 2))
    assert np.array_equal(r, jr)
    np.testing.assert_allclose(l, jl, rtol=1e-12, atol=0)
    np.testing.assert_allclose(t, jt, rtol=1e-12, atol=0)
    assert text == jtext and text.startswith("LOS (1, 2):")
    # the printed LOS is the operator's own row of its table
    assert np.isclose(l.sum(), float(op.lens[1 * 6 + 2].sum()), rtol=1e-12)
    # Operator(debug=True) prints the same table at construction; the
    # default LOS is the central pixel
    prt.Operator(*_problem(prt), mode="precomputed", ftype=F64,
                 device="cpu", debug=True, debug_los=(1, 2))
    assert capsys.readouterr().out == text
    assert _printed(debug_trace, op)[1].startswith("LOS (2, 3):")
    with pytest.raises(ValueError):
        debug_trace(op, los=(1, 2, 3))
    with pytest.warns(UserWarning, match="regs materializes"):
        op.REGS_WARN_ELEMS = 10
        op.regs
    del op.REGS_WARN_ELEMS


def test_debug_time_headers_match_jax(jit_trace):
    """The header of a 4D operator's LOS: both lerp bins under
    ``view_times``, the one bin when binned."""
    def problem(pkg):
        grid = pkg.SphericalGrid(shape=(3, 5, 5, 5), size_r=(1, 4),
                                 size_t=(0.0, 2.0))
        geoms = pkg.ViewGeomCollection(*[
            pkg.ConeRectGeom((4, 4), (8.0, 0.1 * i, 0.2), fov=(30, 30))
            for i in range(3)])
        return grid, geoms

    for kw, los, head in (
            (dict(view_times=[0.0, 0.5, 2.0]), (1, 2, 2), "time lerp: bin 0"),
            (dict(dynamic=True), (2, 1, 1), "time bin: 2")):
        jop = srt.Operator(*problem(srt), mode="precomputed",
                           ftype=jnp.float64, _compute=False, **kw)
        op = prt.Operator(*problem(prt), mode="precomputed", ftype=F64,
                          device="cpu", **kw)
        (jr, jl, _), jtext = _printed(jdebug_trace, jop, los=los)
        (r, l, _), text = _printed(debug_trace, op, los=los)
        assert text == jtext and head in text
        assert np.array_equal(r, jr)
        np.testing.assert_allclose(l, jl, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# payload / with_payload and the serving export
# ---------------------------------------------------------------------------

def _small(mode, **kw):
    grid = prt.SphericalGrid(shape=(8, 6, 7))
    return prt.Operator(grid, _orbit(prt, 3, (6, 6)), mode=mode,
                        device="cpu", **kw)


@pytest.mark.parametrize("mode", ["precomputed", "routed", "fused"])
def test_payload_round_trip(mode):
    """``with_payload(payload)`` shares the payload's tensors (same
    ``data_ptr``) and gives bitwise-equal forwards and gradients, also on
    another instance (fused mode's lazy backward is not built there)."""
    op = _small(mode)
    assert op.payload.keys() == {"precomputed": {"lin", "lens"},
                                 "routed": {"dt"},
                                 "fused": {"fbtd"}}[mode]
    pl = op.payload
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(*op.grid.shape, generator=gen)
    y = torch.rand(*op.geom.shape, generator=gen)
    for src in (op, _small(mode)):
        new = src.with_payload(pl)
        got = {"lin": new.lin, "lens": new.lens, "dt": new._tables,
               "fbtd": new._fused_btd}
        for key, t in pl.items():
            for a, b in zip(_tensors(got[key]), _tensors(t)):
                assert a.data_ptr() == b.data_ptr()
        for got_t, want in zip(_fwd_grad_adj(new, x, y),
                               _fwd_grad_adj(op, x, y)):
            assert torch.equal(got_t, want)
    if mode == "fused":
        assert src._fused_btd is None  # the other instance built nothing
    if mode != "precomputed":  # tables of another operator's size
        other = prt.Operator(op.grid, _orbit(prt, 2, (6, 6)), mode=mode,
                             device="cpu")
        with pytest.raises(ValueError, match="rays"):
            other.with_payload(pl)


def _tensors(t):
    """A payload entry's tensors: the tensor, or a table's tensor fields."""
    return [t] if isinstance(t, torch.Tensor) else [
        v for v in t if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("mode", ["precomputed", "routed", "fused"])
def test_export_round_trip(mode, pair, tmp_path, monkeypatch):
    """The exported forward and gradient step equal the live operator's
    bit for bit (routed mode on radius-innermost tables); in float64
    precomputed mode they match the JAX package's forward and
    ``jax.grad`` at rtol 1e-10."""
    gen = torch.Generator().manual_seed(2)
    op = {"precomputed": lambda: pair[1],
          "routed": lambda: _small(mode, config=prt.TraceConfig(
              routed_voxel_order="r")),
          "fused": lambda: _small(mode)}[mode]()
    x = torch.rand(*op.grid.shape, generator=gen, dtype=op.config.ftype)
    y = torch.rand(*op.geom.shape, generator=gen, dtype=op.config.ftype)
    paths = {}
    for what in ("forward", "grad_step"):
        paths[what] = str(tmp_path / f"{what}.zip")
        export_operator(op, paths[what], what=what, loss_y=y)
    fwd = load_exported(paths["forward"], device="cpu")
    step = load_exported(paths["grad_step"], device="cpu")
    img, g, _ = _fwd_grad_adj(op, x, y)
    assert torch.equal(fwd(x), img)
    assert torch.equal(step(x, y), g)
    if mode == "precomputed":
        jop = pair[0]
        xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
        np.testing.assert_allclose(fwd(x).numpy(), np.asarray(jop(xj)),
                                   rtol=1e-10, atol=1e-14)
        jg = jax.grad(lambda d: jnp.mean((jop(d) - yj) ** 2))(xj)
        np.testing.assert_allclose(step(x, y).numpy(), np.asarray(jg),
                                   rtol=1e-10, atol=1e-14)
        # the serving device defaults to the card: none here, so it raises
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_exported(paths["forward"])


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------

def test_plotting(tmp_path):
    from sph_raytracer_tpu import plotting as jplot
    from sph_raytracer_tpu_torch import plotting

    rea = np.random.default_rng(3).random((5, 3)) * [2, np.pi, 2 * np.pi]
    np.testing.assert_array_equal(plotting.sph2cart(rea),
                                  jplot.sph2cart(rea))
    x = np.array([[1.0, -2.0], [0.0, 3.0]])
    np.testing.assert_array_equal(plotting.color_negative(x),
                                  jplot.color_negative(x))
    grid = prt.SphericalGrid(shape=(5, 5, 5))
    geom = prt.ConeRectGeom((6, 6), pos=(2.0, 0.1, 0.2))
    op = prt.Operator(grid, geom, device="cpu")
    img = op(torch.ones(5, 5, 5)).numpy()
    fig = plotting.image_stack(img, geom, colorbar=True)
    fig.savefig(tmp_path / "img.png")
    ani = plotting.image_stack(np.stack([img, 2 * img]), geom)
    assert isinstance(ani, matplotlib.animation.ArtistAnimation)
    ani.save(tmp_path / "t.gif", writer="pillow", fps=5)
    polar = prt.ConeCircGeom((4, 8), pos=(0, 0.1, 3.0), fov=(5, 30))
    assert plotting.image_stack(img[:4, :4].repeat(2, 1),
                                polar).axes[0].name == "polar"
    with pytest.raises(ValueError):
        plotting.image_stack(np.zeros((2, 3, 4, 5)))
    op.plot()
    matplotlib.pyplot.savefig(tmp_path / "op.png")
    for f in ("img.png", "t.gif", "op.png"):
        assert os.path.getsize(tmp_path / f) > 0
    matplotlib.pyplot.close("all")
    vol = np.random.default_rng(0).random((6, 6, 8))
    g = prt.SphericalGrid(shape=(6, 6, 8))
    kw = dict(shape=(12, 12), ftype=F64, device="cpu")
    assert plotting.preview3d(vol, g, **kw).shape == (8, 12, 12)
    assert plotting.preview3d(np.stack([vol] * 3, -1), g,
                              **kw).shape == (8, 12, 12, 3)
    dg = prt.SphericalGrid(shape=(3, 6, 6, 8))
    dvol = np.random.default_rng(0).random((3, 6, 6, 8))
    assert plotting.preview3d(dvol, dg, **kw).shape == (3, 12, 12)


def test_preview3d_matches_jax():
    from sph_raytracer_tpu import plotting as jplot
    from sph_raytracer_tpu_torch import plotting

    vol = np.random.default_rng(4).random((4, 4, 6))
    want = jplot.preview3d(vol, srt.SphericalGrid(shape=(4, 4, 6)),
                           shape=(8, 8), ftype=jnp.float64)
    got = plotting.preview3d(vol, prt.SphericalGrid(shape=(4, 4, 6)),
                             shape=(8, 8), ftype=F64, device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                               atol=1e-14)
    # fused mode (the kernel engine's plain version, f32) agrees too
    fused = plotting.preview3d(vol, prt.SphericalGrid(shape=(4, 4, 6)),
                               shape=(8, 8), mode="fused", device="cpu")
    np.testing.assert_allclose(fused, np.asarray(want), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# profiling and the autotuner
# ---------------------------------------------------------------------------

def test_profiling(tmp_path):
    from sph_raytracer_tpu_torch.utils.profiling import (fetch_sync,
                                                         time_fn, trace)

    op = _small("routed")
    x = torch.rand(*op.grid.shape)
    assert time_fn(op, x, iters=3) > 0
    out = fetch_sync({"a": torch.ones(4), "b": (torch.zeros(2),),
                      "c": np.arange(3)})
    assert [o.tolist() for o in out] == [[1.0], [0.0], [0]]
    with trace(str(tmp_path)) as d:
        op(x)
    (f,) = os.listdir(d)
    assert f.endswith(".json") and os.path.getsize(os.path.join(d, f)) > 0


def test_autotune_mechanics(tmp_path, monkeypatch):
    """autotune measures the candidates on the operators' device, caches
    the choice in a JSON sidecar, reads it back without building an
    operator, passes the base config through on ``cached_only`` without a
    sidecar, and raises (does not skip) an error it cannot skip."""
    monkeypatch.setenv("SPH_TPU_TUNE_CACHE", str(tmp_path))
    grid = prt.SphericalGrid(shape=(8, 6, 7))
    geom = _orbit(prt, 3, (6, 6))
    cands = [{"routed_dense": "auto"}, {"routed_voxel_order": "r"}, (4, 8)]
    cfg = prt.autotune(grid, geom, candidates=cands, iters=1, device="cpu")
    assert cfg.mode == "routed"
    (side,) = os.listdir(tmp_path)
    assert side.startswith("tune_") and side.endswith(".json")
    op = prt.Operator(grid, geom, config=cfg, device="cpu")
    op0 = prt.Operator(grid, geom, mode="routed", device="cpu")
    x = torch.rand(*grid.shape)
    torch.testing.assert_close(op(x), op0(x), rtol=1e-5, atol=1e-7)

    def no_build(*a, **k):
        raise AssertionError("a cached autotune built an operator")

    with monkeypatch.context() as m:
        m.setattr(prt.Operator, "__init__", no_build)
        assert prt.autotune(grid, geom, candidates=cands, iters=1,
                            device="cpu") == cfg
        assert prt.autotune(grid, geom, cached_only=True,
                            device="cpu") == cfg
        other = _orbit(prt, 2, (6, 6))
        base = prt.TraceConfig(routed_dense="off")
        assert prt.autotune(grid, other, config=base, cached_only=True,
                            device="cpu") == base.replace(mode="routed")
    with pytest.raises(ValueError, match="routed_dense"):
        prt.autotune(grid, geom, candidates=[{"routed_dense": "bogus"}],
                     force=True, device="cpu")
