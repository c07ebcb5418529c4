"""``routed_w_dtype='bf16'``: the banded engine's bfloat16 weight tables.

On the CPU every kernel wrapper runs its plain PyTorch version, which
widens the bfloat16 lengths to f32 as the kernels' ``<name>_bf16``
instantiations do.  One JAX operator, built once for the module, is the
oracle: tests/test_w_dtype.py's fixture config with ``routed_dense='off'``
(B1 + B3 in interpret mode), fed the port's own f32 trace
(``test_torch_operator._jax_routed_on_port_trace``), so both packages round
the same f32 lengths.  The five banded (forward, backward) pairs of the
port are held against it; the rest are port-only checks: the tables hold
the rounded lengths, the image is the f32 operator's on pre-rounded
lengths, the adjoint identity and the gradient, the three cases that warn
and keep f32, the tiny config where the JAX package keeps f32 and the port
quantizes, and the wrappers' dtype checks.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import routed_project as rp
from sph_raytracer_tpu_torch.tools import wfwd_probe
from test_torch_operator import _jax_routed_on_port_trace

torch.set_num_threads(2)
BF16 = torch.bfloat16

# the banded pairs: config -> (forward, backward)
PAIRS = {
    "auto": (dict(), rp.routed_fwd, rp.routed_bwd_gather),
    "off": (dict(routed_dense="off"), rp.routed_fwd, rp.routed_bwd_scatter),
    "both": (dict(routed_dense="both"), rp.routed_fwd_dense,
             rp.routed_bwd_gather),
    "fwd": (dict(routed_dense="fwd"), rp.routed_fwd_dense,
            rp.routed_bwd_scatter),
    "hist": (dict(routed_fwd_reduce="hist"), rp.routed_fwd_hist,
             rp.routed_bwd_gather),
}


def _problem(pkg):
    """tests/test_w_dtype.py's fixture: big enough that the JAX package's
    superchunk heights are 16-row multiples, so it really quantizes."""
    grid = pkg.SphericalGrid(shape=(32, 16, 16))
    geom = sum(
        pkg.ConeRectGeom((8, 10), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 3, endpoint=False))
    return grid, geom


def _inputs(grid, geom):
    rng = np.random.default_rng(0)
    return (rng.random(tuple(grid.shape)).astype(np.float32),
            rng.random(tuple(geom.shape)).astype(np.float32))


def _port(mode="routed", **cfg):
    grid, geom = _problem(prt)
    return prt.Operator(grid, geom, mode=mode, device="cpu",
                        config=prt.TraceConfig(routed_w_dtype="bf16", **cfg))


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    """The JAX bf16 operator's image of the module's density and ``.T`` of
    its target."""
    cfg = srt.TraceConfig(mode="routed", interpret=True, routed_g=128,
                          routed_chunk_multiple=2, routed_dense="off",
                          routed_w_dtype="bf16")
    with pytest.MonkeyPatch.context() as mp:
        jop = _jax_routed_on_port_trace(cfg, mp, tmp_path_factory.mktemp(
            "bf16"), problem=_problem)
    # the JAX side really quantized (no 16-row fallback)
    assert jop._dt[0].w.dtype == jnp.bfloat16
    assert jop._dt[1].wp.dtype == jnp.bfloat16
    x, target = _inputs(*_problem(srt))
    return (np.asarray(jop(jnp.asarray(x))),
            np.asarray(jop.T(jnp.asarray(target))))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_bf16_matches_jax(jax_bf16, name):
    """Image and ``.T`` of each banded pair against the JAX bf16 operator.
    Both round the same f32 lengths to the same bf16 values, so what is
    left is f32 summation order: the f32 tests' rtol 1e-5 / atol 1e-6
    (tests/test_torch_operator.py), not the 2e-2 of two traces."""
    cfg, fwd, bwd = PAIRS[name]
    op = _port(**cfg)
    assert (op._fwd, op._bwd) == (fwd, bwd)
    x, target = _inputs(op.grid, op.geom)
    img, bp = jax_bf16
    with torch.no_grad():
        np.testing.assert_allclose(op(torch.tensor(x)).numpy(), img,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(op.T(torch.tensor(target)).numpy(), bp,
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def traced():
    grid, geom = _problem(prt)
    op = prt.Operator(grid, geom, mode="precomputed", device="cpu")
    return op.lin, op.lens, op._flat_size


def test_tables_hold_rounded_lengths(traced):
    """bf16 tables hold each live f32 length rounded to nearest even
    (``Tensor.to(torch.bfloat16)``, as numpy's bfloat16 cast in the JAX
    package), in both halves and in the window chunk table; they are
    2 B a crossing smaller a weight array."""
    lin, lens, V = traced
    t32 = rp.build_tables(lin, lens, V)
    t16 = rp.build_tables(lin, lens, V, w_dtype=BF16)
    want = lens[lens != 0].to(BF16)
    assert t16.val.dtype == t16.valT.dtype == BF16
    assert torch.equal(t16.val, want)
    assert torch.equal(t16.valT, t32.valT.to(BF16))
    assert torch.equal(t16.ray, t32.ray) and torch.equal(t16.col, t32.col)
    assert t32.nbytes - t16.nbytes == 2 * 2 * t16.nnz
    w32 = rp.build_window_tables(lin, lens, V)
    w16 = rp.build_window_tables(lin, lens, V, w_dtype=BF16)
    assert torch.equal(w16.val, w32.val.to(BF16))
    assert torch.equal(w16.loc, w32.loc)
    with pytest.raises(ValueError, match="weight dtype"):
        rp.build_tables(lin, lens, V, w_dtype=torch.float16)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_bf16_is_f32_on_rounded_lengths(traced, name):
    """The bf16 operator is the f32 one on pre-rounded lengths (rtol 1e-6:
    the widening is exact); it is adjoint to f32 rounding, and autograd's
    gradient of ½|Ax - t|² is ``.T`` of the residual."""
    lin, lens, V = traced
    cfg, fwd, bwd = PAIRS[name]
    op = _port(**cfg)
    rounded = rp.build_tables(lin, lens.to(BF16).float(), V)
    x, target = (torch.tensor(a) for a in _inputs(op.grid, op.geom))
    v = x.clone().requires_grad_(True)
    img = op(v)
    np.testing.assert_allclose(
        img.detach().numpy().ravel(),
        rp.routed_fwd_ref(rounded, x.reshape(-1)).numpy(), rtol=1e-6,
        atol=1e-7)
    t = op._tables
    gen = np.random.default_rng(1)
    a = torch.tensor(gen.normal(size=t.n_vox), dtype=torch.float32)
    b = torch.tensor(gen.normal(size=t.n_rays), dtype=torch.float32)
    lhs = float(torch.dot(fwd(t, a).double(), b.double()))
    rhs = float(torch.dot(a.double(), bwd(t, b).double()))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    (0.5 * torch.sum((img - target) ** 2)).backward()
    np.testing.assert_allclose(v.grad.numpy(),
                               op.T(img.detach() - target).numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("banded", [True, False])
def test_fused_backward_tables_are_bf16(traced, banded):
    """Fused mode's lazily built backward tables are bf16 (the gather's
    transpose alone), with ``routed_banded`` either way: they are banded
    tables whatever it says (config docstring), so it builds them without
    a warning.  The gradient is ``.T`` of the residual, which the gather
    computes on the rounded lengths."""
    lin, lens, V = traced
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        op = _port(mode="fused", routed_banded=banded)
    assert op._engine and op._fused_btd is None
    x, target = (torch.tensor(a) for a in _inputs(op.grid, op.geom))
    v = x.clone().requires_grad_(True)
    img = op(v)
    (0.5 * torch.sum((img - target) ** 2)).backward()
    btd = op._fused_btd
    assert btd.valT.dtype == BF16 and btd.row_ptr is None
    res = (img.detach() - target).reshape(-1)
    rounded = rp.build_tables(lin, lens.to(BF16).float(), V, csr=False)
    np.testing.assert_allclose(v.grad.numpy().ravel(),
                               rp.routed_bwd_gather_ref(rounded, res).numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cfg", [
    dict(mode="precomputed"), dict(mode="routed", routed_banded=False),
    dict(mode="fused", fused_bwd="retrace")], ids=str)
def test_bf16_warns_and_keeps_f32(cfg):
    """Where no banded routed table is built, bf16 warns and keeps f32
    (the JAX package's rule and words, tests/test_w_dtype.py)."""
    with pytest.warns(UserWarning, match="BANDED routed engine"):
        op = _port(**cfg)
    assert op._w_dtype == torch.float32
    if op._tables is not None:          # the window chunk table
        assert op._tables.val.dtype == torch.float32
    elif op.lens is not None:           # precomputed
        assert op.lens.dtype == torch.float32
    else:                               # fused, re-tracing backward
        v = torch.ones(tuple(op.grid.shape), requires_grad=True)
        op(v).sum().backward()
        assert op._fused_btd is None and op._tables is None


def test_tiny_config_quantizes_where_jax_keeps_f32():
    """tests/test_w_dtype.py's tiling-fallback config: the JAX package's
    superchunk heights are not 16-row multiples, so it warns and keeps f32;
    the port has no superchunks and quantizes (config docstring)."""
    cfg = dict(routed_dense="off", routed_w_dtype="bf16")
    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always")
        jop = srt.Operator(
            srt.SphericalGrid(shape=(8, 8, 8)),
            srt.ConeRectGeom((4, 4), (3.0, 0.0, 0.3), fov=(30, 30)),
            config=srt.TraceConfig(mode="routed", interpret=True,
                                   routed_g=128, routed_chunk_multiple=1,
                                   routed_bands=1, **cfg))
    assert jop._dt[0].w.dtype == jnp.float32
    assert any("16-row" in str(w.message) for w in wlist)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        op = prt.Operator(
            prt.SphericalGrid(shape=(8, 8, 8)),
            prt.ConeRectGeom((4, 4), (3.0, 0.0, 0.3), fov=(30, 30)),
            mode="routed", device="cpu", config=prt.TraceConfig(**cfg))
    assert op._tables.val.dtype == BF16


def test_view_times_round_each_split_length():
    """Time-interpolated tables hold both split lengths, (1-w)·len and
    w·len, each rounded in bf16."""
    grid = prt.SphericalGrid(shape=(4, 5, 5, 5), size_t=(10.0, 40.0))
    geom = sum(
        prt.ConeRectGeom((4, 4), pos=(2 * np.cos(t), 2 * np.sin(t), 0.3),
                         fov=(45, 45))
        for t in np.linspace(0, np.pi, 3, endpoint=False))
    times = np.array([12.0, 25.5, 38.0])
    ops = [prt.Operator(grid, geom, mode=m, device="cpu", view_times=times,
                        config=prt.TraceConfig(routed_w_dtype=w))
           for m, w in (("routed", "bf16"), ("precomputed", "f32"))]
    lens = ops[1].lens
    assert torch.equal(ops[0]._tables.val, lens[lens != 0].to(BF16))


def test_window_pair_rejects_bf16(traced):
    """B7a / B7b take f32 tables only (the JAX package never runs its
    window engine on bf16 ones); B8 reads a bf16 chunk table, equal to the
    f32 kernel on pre-rounded lengths."""
    lin, lens, V = traced
    w16 = rp.build_window_tables(lin, lens, V, w_dtype=BF16)
    d = torch.rand(V, generator=torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="float32 weights only"):
        rp.routed_fwd_window(w16, d)
    with pytest.raises(ValueError, match="float32 weights only"):
        rp.routed_bwd_window(w16, torch.ones(w16.n_rays))
    rounded = rp.build_window_tables(lin, lens.to(BF16).float(), V)
    np.testing.assert_allclose(rp.routed_fwd_densew(w16, d).numpy(),
                               rp.routed_fwd_densew(rounded, d).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_wrappers_reject_other_weight_dtypes(traced):
    """Every wrapper checks its table's weight dtype before it runs
    anything, on the CPU too: float64 raises."""
    lin, lens, V = traced
    t = rp.build_tables(lin, lens, V)
    t64 = t._replace(val=t.val.double(), valT=t.valT.double())
    w = rp.build_window_tables(lin, lens, V)
    w64 = w._replace(val=w.val.double())
    d, dy = torch.ones(V), torch.ones(t.n_rays)
    for kern, tab, x in ((rp.routed_fwd, t64, d),
                         (rp.routed_bwd_gather, t64, dy),
                         (rp.routed_bwd_scatter, t64, dy),
                         (rp.routed_fwd_dense, t64, d),
                         (rp.routed_fwd_hist, t64, d),
                         (rp.routed_fwd_densew, w64, d),
                         (rp.routed_fwd_window, w64, d),
                         (rp.routed_bwd_window, w64, dy)):
        with pytest.raises(ValueError, match="float64"):
            kern(tab, x)


def test_probe_bf16():
    """``wfwd_probe.probe(..., w_dtype='bf16')``: B1 and B8 on bf16 tables
    (their images agree to f32 summation order), B7a on its f32 chunk
    table (within the rounding)."""
    res = wfwd_probe.probe(((16, 8, 16), 4, (6, 8)), device="cpu",
                           w_dtype="bf16")
    assert res["csr"].val.dtype == res["win"].val.dtype == BF16
    y = res["y"]
    ref = y["routed_fwd"]
    np.testing.assert_allclose(y["routed_fwd_densew"].numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y["routed_fwd_window"].numpy(), ref.numpy(),
                               rtol=2e-2, atol=1e-6)
    assert not torch.equal(y["routed_fwd_window"], ref)
