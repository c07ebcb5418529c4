"""The port's example modules (``sph_raytracer_tpu_torch.examples``) on the
CPU, at tiny sizes.

Each example's ``run(device="cpu", ...)`` with the JAX example test's
assertions where they apply (``tests/test_examples.py``); its figures
written to ``tmp_path`` by ``plot()``, which must project nothing.  Two
JAX oracles, both ``mode='precomputed'`` at float64 through the JAX
package's API (no JAX example script runs): the static retrieval's
measurements and loss history, and the dynamic example's binned and
``view_times`` images.  The sharded examples run on ranks that are threads
with their own gloo groups, as in ``tests/test_torch_parallel.py``; a
``main()`` that makes the default process group leaves none behind.
"""
import datetime
import importlib
import os
import threading
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import sph_raytracer_tpu as srt
import sph_raytracer_tpu.loss as jloss
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu.models import FullyDenseModel as JaxDense
from sph_raytracer_tpu.retrieval import gd as jax_gd
from sph_raytracer_tpu_torch import examples
from sph_raytracer_tpu_torch.examples import (
    aot_serving,
    dynamic_measurements,
    memory_usage,
    multichip_scaling,
    poisson_retrieval,
    single_vantage,
    sph_harm_retrieval,
    static_retrieval,
    volume_sharded,
)
from sph_raytracer_tpu_torch.examples._common import step_fn
from sph_raytracer_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)

F64 = torch.float64


def _close(a, b):
    """tests/test_torch_retrieval.py's tolerance (float64 both sides)."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-12)


def _plot(mod, res, tmp_path, monkeypatch, names):
    """``mod.plot`` to ``tmp_path`` (figures at a low dpi) with every
    projection refused: a plot computes nothing on the device."""
    pytest.importorskip("matplotlib")
    import matplotlib

    def refuse(*a, **k):
        raise AssertionError("plot() projected")

    monkeypatch.setattr(prt.Operator, "_fwd_local", refuse)
    monkeypatch.setattr(prt.Operator, "_bwd_local", refuse)
    with matplotlib.rc_context({"figure.dpi": 30, "savefig.dpi": 30}):
        paths = mod.plot(res, str(tmp_path))
    assert sorted(os.path.basename(p) for p in paths) == sorted(names)
    for name in names:
        assert (tmp_path / name).stat().st_size > 0


# ---------------------------------------------------------------------------
# the single-device examples
# ---------------------------------------------------------------------------

def test_single_vantage(tmp_path, monkeypatch):
    """The JAX script's content at a small size: its detector (a
    ``ConeRectGeom`` at ``pos=(5, 0, 0)``, 45° fov) ray for ray against the
    JAX package's, and its phantom, the two full shells at radial indices
    -1 and -10."""
    res = single_vantage.run("cpu", grid_shape=(12, 8, 8), det=(16, 16))
    geom = srt.ConeRectGeom((16, 16), pos=(5, 0, 0), fov=(45, 45))
    got = res["op"].geom
    np.testing.assert_allclose(np.broadcast_to(got.ray_starts, (16, 16, 3)),
                               np.broadcast_to(geom.ray_starts, (16, 16, 3)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.rays, geom.rays, rtol=1e-12, atol=1e-12)
    x = res["x"]
    shells = torch.zeros(12)
    shells[[-1, -10]] = 1
    assert torch.equal(x, shells[:, None, None].expand(12, 8, 8))
    img = res["image"]
    assert img.shape == (16, 16) and bool(torch.isfinite(img).all())
    # the outer shell is crossed by every ray that meets the grid
    assert float(img.max()) > 0 and float(img.min()) >= 0
    _plot(single_vantage, res, tmp_path, monkeypatch, ["single_vantage.png"])


def _jax_orbit(n, nview):
    return sum(
        srt.ConeCircGeom(shape=(2 * n, n),
                         pos=(5 * np.cos(th), 5 * np.sin(th), 1), fov=(0, 45))
        for th in np.linspace(0, 2 * np.pi, nview))


def test_static_retrieval_matches_jax():
    """6³, 3 views, 3 ``gd`` iterations: the measurements and each loss's
    history against the JAX package's precomputed float64 operator and
    ``gd`` from the same float64 start.  (The rays and the grid are the
    dynamic test's binned ones, so one process compiles the JAX trace
    once for both.)"""
    n, nview, iters = 6, 3, 3
    res = static_retrieval.run("cpu", n=n, nview=nview, iters=iters,
                               preview=4, ftype=F64)
    jgrid = srt.SphericalGrid(shape=(n, n, n))
    jop = srt.Operator(jgrid, _jax_orbit(n, nview), mode="precomputed",
                       ftype=jnp.float64)
    jmeas = jop(jnp.asarray(static_retrieval.phantom(n), jnp.float64))
    _close(res["meas"].numpy(), jmeas)
    _, _, jlosses = jax_gd(
        jop, jmeas, JaxDense(jgrid), coeffs=jnp.ones((n, n, n), jnp.float64),
        lr=1e-1, loss_fns=[1 * jloss.SquareLoss(), 1 * jloss.NegRegularizer()],
        num_iterations=iters, progress_bar=False)
    got, want = list(res["losses"].values()), list(jlosses.values())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == iters
        _close(g, w)
    square = got[0]
    assert square[-1] < square[0]
    assert res["preview_truth"].shape == (n, 4, 4)
    assert res["preview_coeffs"].shape == (n, 4, 4)


def test_static_retrieval_plot(tmp_path, monkeypatch):
    """The two GIFs, at 2³ (2 preview frames) and 2 views."""
    res = static_retrieval.run("cpu", n=2, nview=2, iters=2, preview=6)
    hist = next(iter(res["losses"].values()))
    assert hist[-1] < hist[0]
    _plot(static_retrieval, res, tmp_path, monkeypatch,
          ["static_retrieval1.gif", "static_retrieval2.gif"])


def test_dynamic_measurements_match_jax():
    """T = 3 bins of 6³: the binned and the ``view_times`` images against
    the JAX package's precomputed float64 operators."""
    n, tbins = 6, 3
    res = dynamic_measurements.run("cpu", n=n, tbins=tbins, preview=4,
                                   ftype=F64)
    jgrid = srt.SphericalGrid(shape=(tbins, n, n, n))
    x = jnp.asarray(dynamic_measurements.phantom(tbins, n), jnp.float64)
    jop = srt.Operator(jgrid, _jax_orbit(n, tbins), mode="precomputed",
                       ftype=jnp.float64)
    _close(res["meas"].numpy(), jop(x))
    jop_ct = srt.Operator(jgrid, _jax_orbit(n, 2 * tbins),
                          view_times=res["times"], mode="precomputed",
                          ftype=jnp.float64)
    _close(res["meas_ct"].numpy(), jop_ct(x))
    assert res["meas_ct"].shape == (2 * tbins, 2 * n, n)
    assert res["preview"].shape == (tbins, 4, 4)


def test_dynamic_measurements_plot(tmp_path, monkeypatch):
    """``dynamic.gif``, at 2 time bins of 2³."""
    res = dynamic_measurements.run("cpu", n=2, tbins=2, preview=6)
    _plot(dynamic_measurements, res, tmp_path, monkeypatch, ["dynamic.gif"])


def test_sph_harm_retrieval(tmp_path, monkeypatch):
    """The bandlimited retrieval recovers the truth (the JAX test's
    ``rel < 0.2``) at a 12³ grid, 6 views, 60 iterations."""
    res = sph_harm_retrieval.run("cpu", n=12, nview=6, det=12, iters=60)
    assert res["rel"] < 0.2, res["rel"]
    hist = next(iter(res["losses"].values()))
    assert len(hist) == 60 and hist[-1] < hist[0]
    _plot(sph_harm_retrieval, res, tmp_path, monkeypatch,
          ["sph_harm_retrieval.png"])


def test_poisson_retrieval(tmp_path, monkeypatch):
    """The physically matched solver wins on Poisson data (the JAX test's
    ``em < cgr`` and ``em < 0.2``) at 8³ with 12 views of 8×8, the
    smallest size tried at which both hold on seed 0 (ML-EM 0.140, CGNR
    0.162; at the JAX script's 16³ and 24×24: 0.122, 0.170)."""
    res = poisson_retrieval.run("cpu", n=8, det=8)
    assert res["em"] < res["cgr"], (res["em"], res["cgr"])
    assert res["em"] < 0.2, res["em"]
    assert bool((res["x_em"] >= 0).all())
    _plot(poisson_retrieval, res, tmp_path, monkeypatch,
          ["poisson_retrieval.png"])


def test_aot_serving(tmp_path):
    """At 8³ and 8×8: the served image is the live operator's bit for bit,
    the served gradient at another target the live one's; the archives go
    to ``export_dir``, or to a directory removed on return."""
    res = aot_serving.run("cpu", n=8, det=8, export_dir=str(tmp_path))
    assert torch.equal(res["image"], res["live"])
    op, d = res["op"], res["density"].clone().requires_grad_(True)
    t = torch.rand(res["image"].shape, generator=torch.Generator()
                   .manual_seed(5))
    torch.mean((op(d) - t) ** 2).backward()
    g = res["serve_grad"](res["density"], t)
    assert res["grad"].shape == g.shape == (8, 8, 8)
    assert float(g.abs().max()) > 0
    torch.testing.assert_close(g, d.grad)
    assert sorted(os.listdir(tmp_path)) == ["forward.zip", "grad_step.zip"]
    res = aot_serving.run("cpu", n=8, det=8)
    assert not any(os.path.exists(p) for p in res["paths"].values())


def test_memory_usage_bounds_real_tables(capsys):
    """The estimate against a small real operator's tensors: the padded
    trace and the fused rays exactly, the routed tables (f32 and bf16) and
    fused mode's backward tables from above."""
    grid = prt.SphericalGrid(shape=(6, 5, 7))
    geom = multichip_scaling.orbit(6, 3, (6, 8))
    nrays = int(np.prod(geom.shape))
    est = memory_usage.estimate(nrays, (1, 6, 5, 7))
    pre = prt.Operator(grid, geom, mode="precomputed", device="cpu")
    assert pre.lin.nbytes + pre.lens.nbytes == est["precomputed"]
    for w_dtype, key in (("f32", "routed"), ("bf16", "routed_bf16")):
        cfg = prt.TraceConfig(mode="routed", routed_w_dtype=w_dtype)
        op = prt.Operator(grid, geom, config=cfg, device="cpu")
        assert op._tables.nnz > 0
        assert op._tables.nbytes <= est[key], (w_dtype, op._tables.nbytes)
    fused = prt.Operator(grid, geom, mode="fused", device="cpu")
    assert sum(t.nbytes for t in fused._frays if t is not None) \
        == est["fused_rays"]
    assert fused._ensure_fused_btd().nbytes <= est["fused_bwd"]

    memory_usage.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "Memory Usage" in out and "Reference (torch) peak" in out


# ---------------------------------------------------------------------------
# the sharded examples, ranks as threads
# ---------------------------------------------------------------------------

def run_ranks(n, fn, timeout=30):
    """``fn(mesh)`` on ``n`` ranks, each a thread with its own gloo group
    over one in-memory store; returns each rank's result."""
    store, tag = dist.HashStore(), uuid.uuid4().hex
    out, err = [None] * n, [None] * n

    def body(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(tag, store), r, n,
                                       datetime.timedelta(seconds=timeout))
            out[r] = fn(Mesh(pg, r, n, torch.device("cpu")))
        except BaseException as e:  # noqa: B036 - re-raised below
            err[r] = e

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 10)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    errs = [e for e in err if e is not None]
    if errs:
        raise errs[0]
    return out


SHARDED = {"multichip_scaling": (multichip_scaling, "fused"),
           "volume_sharded": (volume_sharded, "routed")}


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_example_matches_unsharded(name):
    """Two ranks: every rank's image, and its gradient at a second point,
    within 1e-5 of the unsharded operator's; the step at the example's own
    point (its target is ``op(x)``) is zero."""
    mod, mode = SHARDED[name]
    n, nview = 6, 3
    rng = np.random.default_rng(7)
    x2 = torch.tensor(rng.random((n, n, n)), dtype=torch.float32)

    def rank(mesh):
        res = mod.run(n=n, nview=nview, iters=1, mesh=mesh)
        t = torch.rand(res["y"].shape, generator=torch.Generator()
                       .manual_seed(3))
        return res, step_fn(res["op"], t)(x2)[1], t

    out = run_ranks(2, rank)
    res0 = out[0][0]
    ref = prt.Operator(res0["op"].grid, res0["op"].geom, mode=mode,
                       device="cpu")
    y = ref(res0["x"])
    for res, g2, t in out:
        assert res["nrays"] == y.numel()
        assert res["mesh"].size == 2 and res["rays_per_s"] > 0
        scale = float(y.abs().max())
        torch.testing.assert_close(res["y"], y, rtol=1e-5, atol=1e-5 * scale)
        assert float(res["grad"].abs().max()) <= 1e-6
        want = step_fn(ref, t)(x2)[1]
        torch.testing.assert_close(g2, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_main_leaves_no_group(name, monkeypatch, capsys):
    """``main()`` alone makes a one-rank group over a ``file://`` store
    and destroys it; the JAX script's ``rays/s`` line is printed."""
    monkeypatch.setenv("SPH_TPU_EXAMPLE_GRID", "4")
    monkeypatch.setenv("SPH_TPU_EXAMPLE_VIEWS", "2")
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    SHARDED[name][0].main(["--device", "cpu"])
    assert not dist.is_initialized()
    assert "rays/s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", examples.__all__)
def test_main_without_card_raises(name, monkeypatch):
    """No fallback: with no card, ``main()`` refuses before computing
    anything unless ``--device cpu`` is given."""
    mod = importlib.import_module(f"sph_raytracer_tpu_torch.examples.{name}")
    assert callable(mod.run) and callable(mod.plot)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    assert not dist.is_initialized()
