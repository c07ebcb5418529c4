"""The routed engine's variants in the port vs the JAX package.

On the CPU every kernel wrapper runs its plain PyTorch version; the JAX
operators run their Pallas kernels in interpret mode (``routed_dense=
'both'``: B5 + B2; ``routed_fwd_reduce='hist'``: B6 + B2) or, for
``routed_banded=False``, their jnp reference ``routed_project_ref``, the
way the JAX package's own tests run them.  Both sides read the port's f32
trace (``test_torch_operator._jax_routed_on_port_trace``).  Also: the
chunk table's invariants and its chunks against the JAX router's, the
adjoint identity of every (forward, backward) pair, and the config rules.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import routed_project as rp
from test_torch_operator import _jax_routed_on_port_trace, _routed_problem

torch.set_num_threads(2)

# the JAX package's settings for a small problem (tests/test_routed.py,
# tests/test_hist_reduce.py:40-42)
JAX_BASE = dict(mode="routed", interpret=True, routed_g=128,
                routed_chunk_multiple=2)
VARIANTS = {
    "both": (dict(routed_dense="both"),
             rp.routed_fwd_dense, rp.routed_bwd_gather),
    "hist": (dict(routed_fwd_reduce="hist", routed_bands=4),
             rp.routed_fwd_hist, rp.routed_bwd_gather),
    "window": (dict(routed_banded=False),
               rp.routed_fwd_window, rp.routed_bwd_window),
}
TOL = dict(rtol=1e-5, atol=1e-6)  # f32 sums in another order
_JAX = {}


def _inputs(grid, geom):
    rng = np.random.default_rng(0)
    return (rng.random(tuple(grid.shape)).astype(np.float32),
            rng.random(tuple(geom.shape)).astype(np.float32))


def _jax(name, tmp_path_factory):
    """One JAX operator per variant, built once for the module: the
    operator, and its image, mean-square-loss gradient and ``.T`` of the
    module's inputs."""
    if name not in _JAX:
        cfg = srt.TraceConfig(**JAX_BASE, **VARIANTS[name][0])
        with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
            # 'both' warns of a TPU regression and forced dense slots
            warnings.simplefilter("ignore")
            jop = _jax_routed_on_port_trace(
                cfg, mp, tmp_path_factory.mktemp(name))
        x, target = _inputs(*_routed_problem(srt))
        img = np.asarray(jop(jnp.asarray(x)))
        grad = np.asarray(jax.grad(
            lambda v: jnp.mean((jop(v) - target) ** 2))(jnp.asarray(x)))
        _JAX[name] = (jop, img, grad, np.asarray(jop.T(jnp.asarray(img))))
    return _JAX[name]


def _port(**cfg):
    grid, geom = _routed_problem(prt)
    return prt.Operator(grid, geom, mode="routed", device="cpu",
                        config=prt.TraceConfig(**cfg))


def _image_grad_T(op, y_T):
    x, target = _inputs(op.grid, op.geom)
    v = torch.tensor(x, requires_grad=True)
    img = op(v)
    torch.mean((img - torch.tensor(target)) ** 2).backward()
    return (img.detach().numpy(), v.grad.numpy(),
            op.T(torch.tensor(y_T)).numpy())


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_jax(name, tmp_path_factory):
    cfg, fwd, bwd = VARIANTS[name]
    jop, jimg, jgrad, jT = _jax(name, tmp_path_factory)
    if name != "window":
        assert jop._dense == (name == "both", True)
    op = _port(**cfg)
    assert (op._fwd, op._bwd) == (fwd, bwd)
    img, grad, T = _image_grad_T(op, jimg)
    np.testing.assert_allclose(img, jimg, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)
    np.testing.assert_allclose(T, jT, **TOL)


def test_dense_fwd_pairs_with_scatter():
    """'fwd' = the dense forward of 'both' + the scatter backward of
    'off' (no JAX compile: those two are held against JAX elsewhere)."""
    fwd, both, off = (_port(routed_dense=v) for v in ("fwd", "both", "off"))
    assert (fwd._fwd, fwd._bwd) == (rp.routed_fwd_dense,
                                    rp.routed_bwd_scatter)
    # the dense forward and the scatter read the transpose and the CSR
    assert fwd._tables.vox_ptr is not None
    assert fwd._tables.row_ptr is not None
    assert both._tables.row_ptr is None  # 'both' keeps the transpose alone
    y_T = _inputs(fwd.grid, fwd.geom)[1]
    got = _image_grad_T(fwd, y_T)
    np.testing.assert_allclose(got[0], _image_grad_T(both, y_T)[0], **TOL)
    for a, b in zip(got[1:], _image_grad_T(off, y_T)[1:]):
        np.testing.assert_allclose(a, b, **TOL)


def test_hist_needs_8_row_bands():
    grid, geom = _routed_problem(prt)
    with pytest.raises(ValueError, match="routed_band_rows=8"):
        prt.Operator(grid, geom, device="cpu", config=prt.TraceConfig(
            routed_fwd_reduce="hist", routed_band_rows=16))


@pytest.mark.parametrize("dense", ["fwd", "both"])
def test_hist_gives_way_to_dense_forward(dense):
    with pytest.warns(UserWarning, match="dense forward"):
        op = _port(routed_fwd_reduce="hist", routed_dense=dense)
    assert op._fwd is rp.routed_fwd_dense
    assert op._bwd is rp.BACKWARDS[dense]


@pytest.mark.parametrize("dense,bwd,kept,dropped", [
    ("fwd", rp.routed_bwd_scatter, "row_ptr", "vox_ptr"),
    ("both", rp.routed_bwd_gather, "vox_ptr", "row_ptr"),
])
def test_fused_dense_values_pick_the_backward(dense, bwd, kept, dropped):
    """Fused mode reads routed_dense for its backward only: 'fwd' trains
    through the scatter, 'both' through the gather, on backward-only
    tables; routed_banded and routed_fwd_reduce do not change it."""
    grid, geom = _routed_problem(prt)
    op = prt.Operator(grid, geom, mode="fused", device="cpu",
                      config=prt.TraceConfig(routed_dense=dense,
                                             routed_banded=False,
                                             routed_fwd_reduce="hist"))
    assert op._engine and op._fwd is None and op._bwd is bwd
    btd = op._ensure_fused_btd()
    assert getattr(btd, kept) is not None and getattr(btd, dropped) is None
    y = _inputs(grid, geom)[1]
    np.testing.assert_allclose(op.T(y).numpy(), _port().T(y).numpy(), **TOL)


@pytest.fixture(scope="module")
def traced():
    grid, geom = _routed_problem(prt)
    op = prt.Operator(grid, geom, mode="precomputed", device="cpu")
    return op.lin, op.lens, op._flat_size


def test_window_table_invariants(traced):
    lin, lens, V = traced
    G, W = 16, 64
    w = rp.build_window_tables(lin, lens, V, G=G, W=W)
    t = rp.build_tables(lin, lens, V)
    assert (w.n_tiles, w.n_win) == (-(-t.n_rays // G), V // W)
    # every live crossing once, with its length
    ray, vox = rp._window_ids(w)
    key = lambda r, c, v: torch.sort(  # noqa: E731
        (r.long() * V + c.long()).double() * 4 + v.double()).values
    rows = torch.repeat_interleave(torch.arange(t.n_rays),
                                   torch.diff(t.row_ptr).long())
    assert w.nnz == t.nnz
    assert torch.equal(key(ray, vox, w.val), key(rows, t.col, t.val))
    # one tile and one window per chunk, no empty chunk, stored tile-major
    cid = torch.repeat_interleave(torch.arange(len(w.ckey)),
                                  torch.diff(w.cptr).long())
    assert bool((torch.diff(w.cptr) > 0).all())
    assert torch.equal(ray // G, (w.ckey.long() // w.n_win)[cid])
    assert torch.equal(vox // W, (w.ckey.long() % w.n_win)[cid])
    assert bool((torch.diff(w.ckey) > 0).all())
    tile, win = w.ckey.long() // w.n_win, w.ckey.long() % w.n_win
    assert torch.equal(w.tile_ptr.long(),
                       torch.searchsorted(tile, torch.arange(w.n_tiles + 1)))
    # bwd_order is window-major, tiles ascending within a window
    bkey = (win * w.n_tiles + tile)[w.bwd_order.long()]
    assert bool((torch.diff(bkey) > 0).all())
    assert torch.equal(w.win_ptr.long(), torch.searchsorted(
        win[w.bwd_order.long()], torch.arange(w.n_win + 1)))


def test_window_chunks_match_jax_router():
    """At the JAX router's tile and window (G rays, SR·128 voxels) the
    chunk table has its non-empty (tile, window) chunks, on a synthetic
    table of 6 tiles and 5 windows with some chunks empty."""
    from sph_raytracer_tpu.ops.route import build_routed_tables

    rng = np.random.default_rng(5)
    R, V, G, SR = 700, 5000, 128, 8
    lin = (rng.integers(0, 40, (R, 12)) * 125
           + np.arange(R)[:, None] % 125).astype(np.int32)
    lens = np.where(rng.random((R, 12)) < 0.6, rng.random((R, 12)), 0)
    lens[256:384][lin[256:384] >= 2048] = 0  # tile 2 sees windows 0-1
    rt = build_routed_tables(lin, lens.astype(np.float32), V, G=G, SR=SR)
    live = rt.w.reshape(rt.NC, rt.SR, -1).any(axis=(1, 2))
    want = set(zip(rt.tile[live].tolist(), rt.sg[live].tolist()))
    w = rp.build_window_tables(torch.tensor(lin), torch.tensor(lens), V,
                               G=G, W=SR * 128)
    assert (w.n_tiles, w.n_win) == (6, 5)
    got = set(zip((w.ckey // w.n_win).tolist(), (w.ckey % w.n_win).tolist()))
    assert got == want and len(got) == 27


PAIRS = {"B5-B2": ("transpose", rp.routed_fwd_dense_ref,
                   rp.routed_bwd_gather_ref),
         "B5-B3": ("both", rp.routed_fwd_dense_ref,
                   rp.routed_bwd_scatter_ref),
         "B6-B2": ("both", rp.routed_fwd_hist_ref,
                   rp.routed_bwd_gather_ref),
         "B7a-B7b": ("window", rp.routed_fwd_window_ref,
                     rp.routed_bwd_window_ref)}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_adjoint_identity_of_pairs(traced, pair):
    """<Ax, y> == <x, Aᵀy> for each new (forward, backward) pair."""
    lin, lens, V = traced
    tables, fwd, bwd = PAIRS[pair]
    t = (rp.build_window_tables(lin, lens, V, G=16, W=64)
         if tables == "window" else
         rp.build_tables(lin, lens, V, csr=tables == "both"))
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=V), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=t.n_rays), dtype=torch.float32)
    lhs, rhs = float(torch.dot(fwd(t, x), y)), float(torch.dot(x, bwd(t, y)))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))


def test_new_wrappers_take_plain_version_only_on_cpu(traced):
    """A CPU tensor runs the plain version; the kernel counters stay put."""
    lin, lens, V = traced
    t = rp.build_tables(lin, lens, V)
    w = rp.build_window_tables(lin, lens, V)
    d, dy = torch.ones(V), torch.ones(t.n_rays)
    rp.reset_launches()
    for kern, ref, tab, x in (
            (rp.routed_fwd_dense, rp.routed_fwd_dense_ref, t, d),
            (rp.routed_fwd_hist, rp.routed_fwd_hist_ref, t, d),
            (rp.routed_fwd_window, rp.routed_fwd_window_ref, w, d),
            (rp.routed_bwd_window, rp.routed_bwd_window_ref, w, dy)):
        assert torch.equal(kern(tab, x), ref(tab, x))
    assert set(rp.LAUNCHES.values()) == {0}
