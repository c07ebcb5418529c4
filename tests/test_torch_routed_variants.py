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
    # routed_fwd_hist's tables carry its cut table, and only its
    cut = getattr(op._tables, "cut", None)
    assert (cut is not None) == (name == "hist")
    if cut is not None:
        assert torch.equal(cut, rp.hist_cut(op._tables))
        assert op._tables.nbytes == op._tables._replace(
            cut=None).nbytes + cut.numel() * 4
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


def _hot_window_table(K, KF=rp.WIN_KF):
    """A hand-made table with one hot window: 40 rays (5 tiles of 8) cross
    voxels 0-31 (window 0) 12 times each, ray 39 also crosses voxel 70
    (window 2); window 1 is empty.  Each tile holds 96 crossings (the last
    97)."""
    rng = np.random.default_rng(7)
    lin = torch.tensor(rng.integers(0, 32, (40, 13)), dtype=torch.int32)
    lin[:, 12] = 70
    lens = torch.tensor(rng.random((40, 13)) + 0.1, dtype=torch.float32)
    lens[:39, 12] = 0
    return rp.build_window_tables(lin, lens, 96, G=8, W=32, K=K, KF=KF)


def _windows(request, name, K, KF=rp.WIN_KF):
    if name == "hot":
        return _hot_window_table(K, KF)
    lin, lens, V = request.getfixturevalue("traced")
    return rp.build_window_tables(lin, lens, V, G=16, W=64, K=K, KF=KF)


@pytest.mark.parametrize("name,K", [("traced", 1), ("traced", 100),
                                    ("traced", 10 ** 6), ("hot", 40),
                                    ("hot", 100)])
def test_window_work_items(request, name, K):
    """The backward's work items tile each non-empty window's range of
    bwd_order in order, greedily: an item passes K only as a single chunk,
    and stops short of K only where the next chunk would pass it or its
    window ends; an empty window has none."""
    t = _windows(request, name, K)
    ip, iw, wp = t.item_ptr.long(), t.item_win.long(), t.win_ptr.long()
    n = torch.diff(t.cptr).long()[t.bwd_order.long()]
    cs = torch.cat([n.new_zeros(1), torch.cumsum(n, 0)])
    size = cs[ip[1:]] - cs[ip[:-1]]
    chunks = torch.diff(ip)
    assert t.n_items == iw.numel() and int(ip[0]) == 0
    assert int(ip[-1]) == len(t.ckey) and bool((chunks > 0).all())
    # each window's items: consecutive, from its range's start to its end
    assert bool((torch.diff(iw) >= 0).all())
    for w in range(t.n_win):
        items = torch.nonzero(iw == w).flatten()
        if wp[w] == wp[w + 1]:
            assert items.numel() == 0
        else:
            assert int(ip[items[0]]) == wp[w] and int(ip[items[-1] + 1]) \
                == wp[w + 1]
    assert bool(((size <= K) | (chunks == 1)).all())
    ends_window = ip[1:] == wp[1:][iw]
    nxt = n[ip[1:].clamp(max=n.numel() - 1)]
    assert bool((ends_window | (size + nxt > K)).all())
    if name == "hot":
        assert t.n_win == 3 and int((iw == 0).sum()) > 1 and 1 not in iw
    assert t.nbytes == sum(x.numel() * 4 for x in t[:11])


def _item_walk(t, dy):
    """dD by a plain walk over the work items: each item's chunks summed
    into a window of its own, each window then added into dD."""
    ray, vox = rp._window_ids(t)
    order = t.bwd_order.long()
    dD = torch.zeros(t.n_vox)
    for i in range(t.n_items):
        v0 = int(t.item_win[i]) * t.W
        part = torch.zeros(t.W)
        for c in order[int(t.item_ptr[i]):int(t.item_ptr[i + 1])].tolist():
            k = slice(int(t.cptr[c]), int(t.cptr[c + 1]))
            part.index_add_(0, vox[k] - v0, dy[ray[k]] * t.val[k])
        nv = min(t.W, t.n_vox - v0)
        dD[v0:v0 + nv] += part[:nv]
    return dD


@pytest.mark.parametrize("name,K", [("traced", 100), ("hot", 40)])
def test_work_item_walk_matches_plain_version(request, name, K):
    t = _windows(request, name, K)
    dy = torch.tensor(np.random.default_rng(8).normal(size=t.n_rays),
                      dtype=torch.float32)
    want = rp.routed_bwd_window_ref(t, dy)
    torch.testing.assert_close(_item_walk(t, dy), want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def _piece_walk(t, d):
    """y by a plain walk over the forward's pieces, as routed_fwd_window
    takes them: each piece's crossings, their chunks advanced from
    ``piece_chunk`` as the crossing grows, summed into a tile of its own;
    the tile then stored (the piece is the whole tile) or added."""
    cp, tp = t.cptr.long(), t.tile_ptr.long()
    y = torch.zeros(t.n_rays)
    for p in range(t.n_pieces):
        k0, k1 = int(t.piece_ptr[p]), int(t.piece_ptr[p + 1])
        c0 = int(t.piece_chunk[p])
        tile = int(t.ckey[c0]) // t.n_win
        k = torch.arange(k0, k1)
        c = c0 + torch.searchsorted(cp[c0 + 1:], k, right=True)
        loc = t.loc[k].long()
        vox = (t.ckey[c].long() % t.n_win) * t.W + (loc & 0xFFFF)
        part = torch.zeros(t.G).index_add_(0, loc >> 16, d[vox] * t.val[k])
        r0 = tile * t.G
        nr = min(t.G, t.n_rays - r0)
        if (k0, k1) == (int(cp[tp[tile]]), int(cp[tp[tile + 1]])):
            y[r0:r0 + nr] = part[:nr]
        else:
            y[r0:r0 + nr] += part[:nr]
    return y


@pytest.mark.parametrize("name,KF", [("traced", 1), ("traced", 100),
                                     ("traced", 10 ** 6), ("hot", 40),
                                     ("hot", 10 ** 6)])
def test_forward_piece_walk(request, name, KF):
    """The forward's pieces cover each non-empty tile's crossings once and
    in order, in ceil(n / KF) runs of at most KF whose sizes differ by at
    most one, each with the chunk of its first crossing; the plain walk
    over them equals the plain version."""
    t = _windows(request, name, rp.WIN_K, KF)
    cp, tp = t.cptr.long(), t.tile_ptr.long()
    pp, pc = t.piece_ptr.long(), t.piece_chunk.long()
    size = torch.diff(pp)
    assert int(pp[0]) == 0 and int(pp[-1]) == t.nnz
    assert bool((size > 0).all()) and bool((size <= KF).all())
    assert bool((cp[pc] <= pp[:-1]).all() & (pp[:-1] < cp[pc + 1]).all())
    n = cp[tp[1:]] - cp[tp[:-1]]
    tile = t.ckey[pc].long() // t.n_win
    last = torch.searchsorted(cp, pp[1:] - 1, right=True) - 1
    assert torch.equal(tile, t.ckey[last].long() // t.n_win)
    assert torch.equal(torch.bincount(tile, minlength=t.n_tiles),
                       (n + KF - 1) // KF)
    for j in range(t.n_tiles):
        s = size[tile == j]
        assert int(s.sum()) == int(n[j])
        assert s.numel() == 0 or int(s.max() - s.min()) <= 1
    if name == "hot":
        assert t.n_pieces == (5 * 3 if KF == 40 else 5)
    d = torch.tensor(np.random.default_rng(9).random(t.n_vox),
                     dtype=torch.float32)
    want = rp.routed_fwd_window_ref(t, d)
    torch.testing.assert_close(_piece_walk(t, d), want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def _densew_walk(t, d, threads):
    """y by a plain walk over the work items as routed_fwd_densew takes
    them, and the global adds it makes: each item's chunks ``threads`` at a
    time laid end to end, 32 crossings a warp's slice, each run of one ray
    in a slice summed and added once."""
    ray, vox = rp._window_ids(t)
    prod = (d[vox] * t.val.float()).tolist()
    ray, cp = ray.tolist(), t.cptr.tolist()
    order, ip = t.bwd_order.tolist(), t.item_ptr.tolist()
    y = torch.zeros(t.n_rays, dtype=torch.float64)
    adds = 0
    for i in range(t.n_items):
        chunks = order[ip[i]:ip[i + 1]]
        for b in range(0, len(chunks), threads):
            walk = [k for c in chunks[b:b + threads]
                    for k in range(cp[c], cp[c + 1])]
            for w in range(0, len(walk), 32):
                runs = []
                for k in walk[w:w + 32]:
                    if runs and runs[-1][0] == ray[k]:
                        runs[-1][1] += prod[k]
                    else:
                        runs.append([ray[k], prod[k]])
                for r, x in runs:
                    y[r] += x
                adds += len(runs)
    return y.float(), adds


@pytest.mark.parametrize("name,K,G,threads", [
    ("traced", 100, 16, 128), ("traced", 1, 16, 128), ("hot", 40, 8, 128),
    # windows of more chunks than a batch (as a CTA of fewer threads would
    # take them), walked in several batches: 27 tiles of 4 rays; the hot
    # window's 5 chunks in one item
    ("traced", 10 ** 6, 4, 8), ("traced", 10 ** 6, 4, 16),
    ("hot", 10 ** 6, 8, 2)])
def test_densew_item_walk(request, name, K, G, threads):
    """routed_fwd_densew's walk over the work items (a hot window split
    into several, or one item walked in several batches) equals the plain
    version, and issues the global adds that wfwd_probe.densew_atomics
    counts."""
    from sph_raytracer_tpu_torch.tools.wfwd_probe import densew_atomics

    if name == "hot":
        t = _hot_window_table(K)
        assert (int((t.item_win == 0).sum()) > 1) == (K == 40)
    else:
        lin, lens, V = request.getfixturevalue("traced")
        t = rp.build_window_tables(lin, lens, V, G=G, W=64, K=K)
        windows = int((torch.diff(t.win_ptr) > 0).sum())
        assert (t.n_items == windows) == (K == 10 ** 6)
    d = torch.tensor(np.random.default_rng(11).random(t.n_vox),
                     dtype=torch.float32)
    want = rp.routed_fwd_densew_ref(t, d)
    y, adds = _densew_walk(t, d, threads)
    torch.testing.assert_close(y, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    runs, atomics = densew_atomics(t, threads)
    assert atomics == adds and runs <= adds < t.nnz
    if threads < 128:
        assert int(torch.diff(t.item_ptr).max()) > threads


def _hist_table(R):
    """A hand-made ray-major CSR: ray 3 of 30 crossings (longer than a
    share), rays 10-20 empty, R - 1 empty, the others 0-12 crossings."""
    rng = np.random.default_rng(R)
    lens = torch.tensor(rng.random((R, 30)) + 0.1, dtype=torch.float32)
    lens[:, 12:] = 0
    lens[torch.arange(R), torch.tensor(rng.integers(0, 13, R))] = 0
    lens[3] = 0.5
    lens[10:21] = 0
    lens[R - 1] = 0
    lin = torch.tensor(rng.integers(0, 50, (R, 30)), dtype=torch.int32)
    return rp.build_tables(lin, lens, 50, transpose=False)


@pytest.mark.parametrize("R,share", [(45, 7), (46, 7), (47, 7), (48, 7),
                                     (45, 16), (46, 1), (45, 31),
                                     (47, 1000)])
def test_hist_share_cut(R, share):
    """routed_fwd_hist's merge-path shares at R ≡ 1, 2, 3 (mod 4): they
    cover every crossing and every ray's end once, each holds at most
    ``share`` of them; summing each share's crossings, storing the rays
    that lie wholly in it and adding the rays its ends cut gives the plain
    version, and each empty ray is written 0."""
    t = _hist_table(R)
    cut = rp.hist_cut(t, share)
    assert cut.dtype == torch.int32
    rays, ks = cut[:, 0].long(), cut[:, 1].long()
    n = rays.numel() - 1
    assert n == -(-(R + t.nnz) // share)
    assert (int(rays[0]), int(ks[0]), int(rays[-1]), int(ks[-1])) == (
        0, 0, R, t.nnz)
    steps = torch.diff(rays) + torch.diff(ks)
    assert bool((steps[:-1] == share).all()) and 0 < int(steps[-1]) <= share
    assert bool((torch.diff(rays) >= 0).all() & (torch.diff(ks) >= 0).all())
    rp_ = t.row_ptr.long()
    d = torch.tensor(np.random.default_rng(12).random(50),
                     dtype=torch.float32)
    prod = d[t.col.long()] * t.val
    row = rp._row_ids(t.row_ptr, t.nnz)
    y = torch.full((R,), float("nan"))
    cut = torch.zeros(R)       # the adds of cut rays, into a zeroed y
    stored = torch.zeros(R, dtype=torch.long)
    for s in range(n):
        i0, k0, i1, k1 = (int(rays[s]), int(ks[s]), int(rays[s + 1]),
                          int(ks[s + 1]))
        # the rays the share touches: its crossings' and its ends'
        last = min(i1, R - 1)
        assert k1 <= int(rp_[last + 1]) and int(rp_[i0]) <= k0
        part = torch.zeros(last - i0 + 1).index_add_(
            0, row[k0:k1] - i0, prod[k0:k1])
        for j, r in enumerate(range(i0, last + 1)):
            if r < i1 and int(rp_[r]) >= k0:
                y[r] = part[j]
                stored[r] += 1
            else:
                cut[r] += part[j]
    y = torch.where(stored == 1, y, cut)
    empty = torch.diff(t.row_ptr) == 0
    assert bool(empty[10:21].all()) and bool(empty[-1])
    assert bool((stored <= 1).all()) and bool((stored[empty] == 1).all())
    assert bool((y[empty] == 0).all())
    assert int(torch.diff(t.row_ptr).max()) == 30
    assert share >= 30 or bool((stored[3] == 0))  # ray 3 is cut
    want = rp.routed_fwd_hist_ref(t, d)
    torch.testing.assert_close(y, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def _dense_group_sums(t, d, width):
    """y by a plain emulation of routed_fwd_dense's grouped sums: in each
    32-crossing step of a voxel's list, each run of equal ray // width cut
    into runs of at most ``width`` lanes, each summed component by
    component, then added into y at rays width·g + j < R; and the count
    of those sums."""
    k = torch.arange(t.nnz)
    pos = k - t.vox_ptr[:-1].long()[rp._row_ids(t.vox_ptr, t.nnz)]
    g = t.ray.long() // width
    start = pos % 32 == 0
    start[1:] |= g[1:] != g[:-1]
    run0 = torch.cummax(torch.where(start, k, 0), 0).values
    start |= (k - run0) % width == 0
    run = torch.cumsum(start.long(), 0) - 1
    prod = d[rp._row_ids(t.vox_ptr, t.nnz)] * t.valT
    acc = torch.zeros(int(start.sum()), width).index_put_(
        (run, t.ray.long() % width), prod, accumulate=True)
    rays = g[start][:, None] * width + torch.arange(width)
    keep = rays < t.n_rays
    return (torch.zeros(t.n_rays).index_add_(0, rays[keep], acc[keep]),
            int(start.sum()))


@pytest.mark.parametrize("width,R", [(1, 108), (2, 108), (4, 108), (2, 105),
                                     (4, 105), (4, 106), (4, 103)])
def test_dense_group_sums(traced, width, R):
    """routed_fwd_dense's grouped sums equal the plain version, at each
    atomic width and at ray counts R = 108 ≡ 0, 105 ≡ 1, 106 ≡ 2 and
    103 ≡ 3 (mod 4), whose last group is cut short; where no group is,
    one counted atomic a sum."""
    lin, lens, V = traced
    assert lin.shape[0] == 108
    t = rp.build_tables(lin[:R], lens[:R], V, csr=False)
    d = torch.tensor(np.random.default_rng(10).random(V),
                     dtype=torch.float32)
    want = rp.routed_fwd_dense_ref(t, d)
    y, sums = _dense_group_sums(t, d, width)
    torch.testing.assert_close(y, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    assert R % width or rp.dense_fwd_atomics(t, width) == sums


def _transpose(lists, R):
    """The voxel-major transpose of hand-made voxel lists (voxel v crossed
    by the rays ``lists[v]``, each of length 1)."""
    rows = [[v for v, rays in enumerate(lists) if r in rays]
            for r in range(R)]
    lin = torch.zeros(R, max(map(len, rows)), dtype=torch.int32)
    lens = torch.zeros(lin.shape)
    for r, vs in enumerate(rows):
        lin[r, :len(vs)] = torch.tensor(vs, dtype=torch.int32)
        lens[r, :len(vs)] = 1.0
    return rp.build_tables(lin, lens, len(lists), csr=False)


@pytest.mark.parametrize("lists,R,want", [
    # four rays of one group in one step
    ([[0, 1, 2, 3]], 4, {1: 4, 2: 2, 4: 1}),
    # rays 2-35: the group of rays 32-35 is cut by the warp's 32-crossing
    # step (crossings 30-31 / 32-33 of the list), two atomics
    ([list(range(2, 36))], 36, {1: 34, 2: 17, 4: 10}),
    # R = 6: at width 4 rays 4-5 are a last group cut short, two scalar
    # atomics
    ([[0, 2], [4, 5]], 6, {1: 4, 2: 3, 4: 3}),
])
def test_dense_fwd_atomics(lists, R, want):
    """The global atomics of routed_fwd_dense: one a run of one ray group
    in a warp's step, scalar ones for a last group cut short."""
    t = _transpose(lists, R)
    assert t.nnz == sum(map(len, lists))
    assert {w: rp.dense_fwd_atomics(t, w) for w in want} == want


@pytest.mark.parametrize("rows,tile,pairs", [
    # two rays of one tile share voxels 1 and 2: 3 pairs from 5 crossings
    ([[1, 2], [2, 1, 3]], 2, 3),
    # the same rays in tiles of one ray: a pair a crossing
    ([[1, 2], [2, 1, 3]], 1, 5),
    # an empty ray; ray 2 in the next tile repeats ray 0's voxels
    ([[4, 4, 5], [], [4, 5]], 2, 4),
])
def test_scatter_atomics(rows, tile, pairs):
    """The global atomics of routed_bwd_scatter without overflow: one a
    distinct (tile, voxel) pair of the CSR."""
    M = max(len(r) for r in rows)
    lin = torch.zeros(len(rows), M, dtype=torch.int32)
    lens = torch.zeros(len(rows), M)
    for i, r in enumerate(rows):
        lin[i, :len(r)] = torch.tensor(r)
        lens[i, :len(r)] = 1.0
    t = rp.build_tables(lin, lens, 8, transpose=False)
    assert rp.scatter_atomics(t, tile) == pairs
    assert t.nnz == sum(len(r) for r in rows)


@pytest.mark.parametrize("call,match", [
    (lambda t, w: rp.routed_bwd_scatter(
        t, torch.ones(t.n_rays, device="meta"),
        counts=torch.zeros(2, dtype=torch.int64, device="meta")),
     "counts must be a contiguous int32"),
    (lambda t, w: rp.routed_bwd_scatter(
        t, torch.ones(t.n_rays, device="meta"),
        counts=torch.zeros(3, dtype=torch.int32, device="meta")),
     "counts must be a contiguous int32"),
    (lambda t, w: rp.routed_bwd_window(
        w, torch.ones(w.n_rays + 1, device="meta")), "must be float32"),
    (lambda t, w: rp.build_window_tables(
        torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, 1), 4, K=0),
     "K=0 must be positive"),
    (lambda t, w: rp.build_window_tables(
        torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, 1), 4, KF=0),
     "KF=0 must be positive"),
    # a 64 KB y tile: the window forward's shared memory
    (lambda t, w: rp.build_window_tables(
        torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, 1), 4,
        G=2 ** 14), "would pass 48 KB"),
    # a cut table built for another share size
    (lambda t, w: rp.routed_fwd_hist(
        t._replace(cut=rp.hist_cut(t, rp.HIST_SHARE // 2)),
        torch.ones(t.n_vox, device="meta")), "is not hist_cut"),
])
def test_redesigned_wrappers_reject_wrong_input(traced, call, match):
    """What the two redesigned kernels do not take raises (a ``meta``
    tensor stands in for one on the card)."""
    lin, lens, V = traced
    t = rp.build_tables(lin, lens, V, transpose=False)
    w = rp.build_window_tables(lin, lens, V, G=16, W=64)
    with pytest.raises(ValueError, match=match):
        call(t, w)
