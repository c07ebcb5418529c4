"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Run on a machine with an H100 (no JAX needed there; ``--noconftest``
skips tests/conftest.py, which imports jax)::

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (the fused kernel at every padded crossing count it is built for,
on rays whose finite crossing count is one off or at each of its sort
sizes, a ray that misses the grid and one through the cones' apex, run
to run, and with the lerp; the routed variants on synthetic tables with empty
rays, empty windows and a last tile of one ray; the window backward on a
window cut into several work items, the window forward on tiles cut into
several pieces at each CTA size, the dense forward at each atomic width and
at ray counts that are not a multiple of 4, the window-major forward on a
hot window cut into several work items, the merge-path forward on rays
longer than a share, runs of empty rays and a last partial share at each
share size, the forward and the gather backward on rows of 0 to 2,000
crossings at every start offset mod 4, run to run and adjoint with each
partner, the scatter
backward on tiles that overflow its shared table), each ``<name>_bf16``
instantiation against its
plain version on bf16 tables, and one training step of each routed
configuration (f32 and bf16 weights) and of fused mode on the card
against the CPU, ``solve.cg`` at ``'auto'`` against ``'precomputed'``
with its launches, ``routed_voxel_order='r'`` against ``'a'``, and two
example modules (``single_vantage``, ``aot_serving``) tiny.
"""
import numpy as np
import pytest
import torch

import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import fused_project as fp
from sph_raytracer_tpu_torch.ops import routed_project as rp
from sph_raytracer_tpu_torch.ops.trace import GridSpec
from sph_raytracer_tpu_torch.tools import bwd_sweep, fused_sweep, fwd_sweep

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(device, **kw):
    grid = prt.SphericalGrid(shape=(12, 10, 10))
    geom = sum(
        prt.ConeRectGeom((8, 9), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 4, endpoint=False))
    return grid, prt.Operator(grid, geom, mode="routed", device=device, **kw)


def test_kernels_match_plain_versions(cuda):
    _, op = _problem(cuda)
    t = op._tables
    gen = torch.Generator().manual_seed(0)
    d = torch.rand(t.n_vox, generator=gen).to(cuda)
    dy = torch.randn(t.n_rays, generator=gen).to(cuda)
    before = dict(rp.LAUNCHES)
    for kern, ref, x, rtol in (
            (rp.routed_fwd, rp.routed_fwd_ref, d, 1e-5),
            (rp.routed_bwd_gather, rp.routed_bwd_gather_ref, dy, 1e-5),
            # atomics sum in a run-to-run order
            (rp.routed_bwd_scatter, rp.routed_bwd_scatter_ref, dy, 1e-4)):
        got, want = kern(t, x), ref(t, x)
        torch.cuda.synchronize()
        assert got.device.type == "cuda"
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=1e-5 * float(want.abs().max()))
        assert rp.LAUNCHES[kern.__name__] == before[kern.__name__] + 1
    # the gather backward and the forward are deterministic run to run
    assert torch.equal(rp.routed_bwd_gather(t, dy),
                       rp.routed_bwd_gather(t, dy))
    assert torch.equal(rp.routed_fwd(t, d), rp.routed_fwd(t, d))


def _synthetic(seed, R, V, M, vox=None, empty=0.1, long_ray=0):
    """A (lin, lens) table of R rays x M slots: voxel ids drawn from
    ``vox`` (default all V), a share ``empty`` of rays without crossings,
    zero-length slots scattered, and ray 0 given ``long_ray`` crossings
    (longer than a share of routed_fwd_hist)."""
    rng = np.random.default_rng(seed)
    M = max(M, long_ray)
    vox = np.arange(V) if vox is None else np.asarray(vox)
    lin = rng.choice(vox, size=(R, M))
    lens = rng.random((R, M)).astype(np.float32)
    lens[rng.random((R, M)) < 0.3] = 0
    lens[rng.random(R) < empty] = 0
    if long_ray:
        lens[0, :long_ray] = 0.5
    lens[1:, 40:] = 0
    return torch.tensor(lin, dtype=torch.int32), torch.tensor(lens)


# R = 2·1024 + 1: the last window tile (WIN_G = 1024) holds one ray; the
# second case's ray 0 (3,000 crossings) spans hist shares; the third case
# draws its voxels from two ranges of 300, so most windows are empty
VARIANT_CASES = [dict(R=1, V=7, M=4),
                 dict(R=2049, V=1541, M=48, long_ray=3000),
                 dict(R=2049, V=9000, M=40,
                      vox=np.r_[0:300, 8700:9000], empty=0.5)]


@pytest.mark.parametrize("case", range(len(VARIANT_CASES)))
def test_variant_kernels_match_plain_versions(cuda, case):
    kw = VARIANT_CASES[case]
    lin, lens = _synthetic(case, **kw)
    lin, lens, V = lin.to(cuda), lens.to(cuda), kw["V"]
    t = rp.build_tables(lin, lens, V)
    wins = [rp.build_window_tables(lin, lens, V),
            rp.build_window_tables(lin, lens, V, G=64, W=128)]
    gen = torch.Generator().manual_seed(case)
    d = torch.rand(V, generator=gen).to(cuda)
    dy = torch.randn(kw["R"], generator=gen).to(cuda)
    checks = [(rp.routed_fwd_dense, rp.routed_fwd_dense_ref, t, d),
              (rp.routed_fwd_hist, rp.routed_fwd_hist_ref, t, d)]
    for w in wins:
        checks += [(rp.routed_fwd_window, rp.routed_fwd_window_ref, w, d),
                   (rp.routed_bwd_window, rp.routed_bwd_window_ref, w, dy),
                   (rp.routed_fwd_densew, rp.routed_fwd_densew_ref, w, d)]
    for kern, ref, tab, x in checks:
        before = rp.LAUNCHES[kern.__name__]
        got, want = kern(tab, x), ref(tab, x)
        torch.cuda.synchronize()
        assert rp.LAUNCHES[kern.__name__] == before + 1
        # shared or global atomics sum in a run-to-run order
        torch.testing.assert_close(
            got, want, rtol=1e-4,
            atol=1e-5 * max(float(want.abs().max()), 1e-30))


# the kernels with a bf16 instantiation, and the table each reads
BF16_KERNELS = {"routed_fwd": "csr", "routed_bwd_gather": "csr",
                "routed_bwd_scatter": "csr", "routed_fwd_dense": "csr",
                "routed_fwd_hist": "csr", "routed_fwd_densew": "window"}


@pytest.mark.parametrize("case", range(len(VARIANT_CASES)))
def test_bf16_kernels_match_plain_versions(cuda, case):
    """Each ``<name>_bf16`` entry against its plain version on the same
    bf16 tables (which widens the same rounded lengths); only the bf16
    counter moves."""
    kw = VARIANT_CASES[case]
    lin, lens = _synthetic(case, **kw)
    lin, lens, V = lin.to(cuda), lens.to(cuda), kw["V"]
    tabs = {"csr": rp.build_tables(lin, lens, V, w_dtype=torch.bfloat16),
            "window": rp.build_window_tables(lin, lens, V,
                                             w_dtype=torch.bfloat16)}
    gen = torch.Generator().manual_seed(case)
    d = torch.rand(V, generator=gen).to(cuda)
    dy = torch.randn(kw["R"], generator=gen).to(cuda)
    for name, which in BF16_KERNELS.items():
        tab = tabs[which]
        assert tab.val is None or tab.val.dtype == torch.bfloat16
        x = dy if "bwd" in name else d
        before = dict(rp.LAUNCHES)
        got = getattr(rp, name)(tab, x)
        want = getattr(rp, f"{name}_ref")(tab, x)
        torch.cuda.synchronize()
        assert rp.LAUNCHES[f"{name}_bf16"] == before[f"{name}_bf16"] + 1
        assert rp.LAUNCHES[name] == before[name]
        # atomics sum in a run-to-run order
        torch.testing.assert_close(
            got, want, rtol=1e-4,
            atol=1e-5 * max(float(want.abs().max()), 1e-30))


def _adjoint_rel(fwd, bwd, t, gen, device):
    x = torch.randn(t.n_vox, generator=gen).to(device)
    y = torch.randn(t.n_rays, generator=gen).to(device)
    lhs = float(torch.dot(fwd(t, x).double(), y.double()))
    return abs(lhs - float(torch.dot(x.double(), bwd(t, y).double()))) \
        / abs(lhs)


@pytest.mark.parametrize("G,K", [(rp.WIN_G, rp.WIN_K), (64, 4000)])
def test_window_backward_splits_a_hot_window(cuda, G, K):
    """Window 0 holds ~48,000 crossings (voxels 0-255): it is cut into
    several work items (chunks of 24,000 crossings alone, or two of 1,500
    an item) whose partial windows meet in global atomics; window 1 (3,821
    crossings) is one item and stores plainly.  Against the plain version
    and the adjoint identity with routed_fwd_window."""
    lin, lens = _synthetic(5, R=2049, V=600, M=40, vox=np.r_[0:256, 400:420])
    lin, lens = lin.to(cuda), lens.to(cuda)
    t = rp.build_window_tables(lin, lens, 600, G=G, K=K)
    assert int((t.item_win == 0).sum()) > 1
    assert int((t.item_win == 1).sum()) == 1
    gen = torch.Generator().manual_seed(5)
    dy = torch.randn(t.n_rays, generator=gen).to(cuda)
    want = rp.routed_bwd_window_ref(t, dy)
    got = rp.routed_bwd_window(t, dy)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    assert _adjoint_rel(rp.routed_fwd_window, rp.routed_bwd_window, t, gen,
                        cuda) <= 1e-5


# (G, W, KF, V): the defaults (tiles of ~26,000 crossings cut into
# pieces, the last tile one ray in one piece); windows of one voxel (a
# tile's one piece holds 2,000 chunks, more than a CTA's batch of chunk
# ends); small pieces that cut chunks
@pytest.mark.parametrize("G,W,KF,V", [(rp.WIN_G, rp.WIN_W, rp.WIN_KF, 600),
                                      (1024, 1, 10 ** 6, 2000),
                                      (64, 128, 100, 600)])
def test_window_forward_splits_hot_tiles(cuda, G, W, KF, V):
    """routed_fwd_window over tiles cut into pieces whose partial tiles
    meet in global atomics, at every CTA size, against the plain version;
    the adjoint identity with routed_bwd_window."""
    lin, lens = _synthetic(5, R=2049, V=V, M=40,
                           vox=np.r_[0:256, 400:420] if V == 600 else None)
    t = rp.build_window_tables(lin.to(cuda), lens.to(cuda), V, G=G, W=W,
                               KF=KF)
    assert (t.n_pieces > t.n_tiles) == (KF < 10 ** 6)
    assert int(t.tile_ptr[-1] - t.tile_ptr[-2]) >= 1  # the last tile's ray
    gen = torch.Generator().manual_seed(5)
    d = torch.rand(V, generator=gen).to(cuda)
    want = rp.routed_fwd_window_ref(t, d)
    before = rp.LAUNCHES["routed_fwd_window"]
    for threads in fwd_sweep.WINDOW_THREADS:
        got = fwd_sweep.window_fwd(t, d, threads)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(rp.routed_fwd_window(t, d), want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    assert rp.LAUNCHES["routed_fwd_window"] == before + 5
    assert _adjoint_rel(rp.routed_fwd_window, rp.routed_bwd_window, t, gen,
                        cuda) <= 1e-5


@pytest.mark.parametrize("R", [601, 602, 603])
def test_dense_forward_groups(cuda, R):
    """routed_fwd_dense (f32 and bf16) on 20 voxel lists of ~250 ascending
    rays each (some listed twice), so 4-ray groups straddle a warp's
    32-crossing steps, at R ≡ 1, 2, 3 (mod 4), where the last group is cut
    short: at every atomic width and warp order against the plain version,
    and the adjoint identity with routed_bwd_gather and
    routed_bwd_scatter."""
    lin, lens = _synthetic(R, R=R, V=20, M=12, empty=0.05)
    gen = torch.Generator().manual_seed(R)
    d = torch.rand(20, generator=gen).to(cuda)
    for w_dtype in (torch.float32, torch.bfloat16):
        t = rp.build_tables(lin.to(cuda), lens.to(cuda), 20, w_dtype=w_dtype)
        assert bool((t.ray == R - 1).any())
        assert int(torch.diff(t.vox_ptr).min()) > 32
        want = rp.routed_fwd_dense_ref(t, d)
        for width in (1, 2, 4):  # (width 0, plain stores, is timed only)
            for spread in fwd_sweep.DENSE_SPREADS:
                got = fwd_sweep.dense_fwd(t, d, width, spread)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
        for bwd in (rp.routed_bwd_gather, rp.routed_bwd_scatter):
            assert _adjoint_rel(rp.routed_fwd_dense, bwd, t, gen,
                                cuda) <= 1e-5


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_densew_walks_a_hot_window_in_items(cuda, w_dtype):
    """routed_fwd_densew on window 0 of ~48,000 crossings cut into work
    items of at most 4,000 (window 1, 3,821 crossings, one item), and on
    an item of more chunks than a CTA takes at once, against the plain
    version; the adjoint identity with routed_bwd_window on the
    f32 table of the same rounded lengths."""
    lin, lens = _synthetic(5, R=2049, V=600, M=40, vox=np.r_[0:256, 400:420])
    t = rp.build_window_tables(lin.to(cuda), lens.to(cuda), 600, G=64,
                               K=4000, w_dtype=w_dtype)
    assert int((t.item_win == 0).sum()) > 1
    assert int((t.item_win == 1).sum()) == 1
    gen = torch.Generator().manual_seed(5)
    d = torch.rand(600, generator=gen).to(cuda)
    want = rp.routed_fwd_densew_ref(t, d)
    entry = rp._entry("routed_fwd_densew", t.val)
    before = rp.LAUNCHES[entry]
    torch.testing.assert_close(rp.routed_fwd_densew(t, d), want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    assert rp.LAUNCHES[entry] == before + 1
    # tiles of 16 rays: window 0's 129 chunks in one item, taken by the CTA
    # in two batches
    t2 = rp.build_window_tables(lin.to(cuda), lens.to(cuda), 600, G=16,
                                K=10 ** 6, w_dtype=w_dtype)
    assert int(torch.diff(t2.item_ptr).max()) > 128
    want2 = rp.routed_fwd_densew_ref(t2, d)
    torch.testing.assert_close(rp.routed_fwd_densew(t2, d), want2, rtol=1e-4,
                               atol=1e-5 * float(want2.abs().max()))
    t32 = t._replace(val=t.val.float())
    x = torch.randn(600, generator=gen).to(cuda)
    y = torch.randn(t.n_rays, generator=gen).to(cuda)
    lhs = float(torch.dot(rp.routed_fwd_densew(t, x).double(), y.double()))
    rhs = float(torch.dot(x.double(), rp.routed_bwd_window(t32, y).double()))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.parametrize("R", [2049, 2050, 2051])
def test_hist_shares_cut_rays(cuda, R):
    """routed_fwd_hist (f32 and bf16) at R ≡ 1, 2, 3 (mod 4) on a table
    whose ray 0 is longer than a share, with a run of 300 empty rays and
    a last, partial share: at every share size of the sweep (and shares of
    37 steps, which cut most rays) against the plain version (empty rays
    0), and through the wrapper with the cut table it makes for tables
    without one; the adjoint identity with routed_bwd_gather."""
    lin, lens = _synthetic(R, R=R, V=1541, M=48, long_ray=5000)
    lens[100:400] = 0
    gen = torch.Generator().manual_seed(R)
    d = torch.rand(1541, generator=gen).to(cuda)
    for w_dtype in (torch.float32, torch.bfloat16):
        t = rp.build_tables(lin.to(cuda), lens.to(cuda), 1541,
                            w_dtype=w_dtype)
        assert int(torch.diff(t.row_ptr).max()) == 5000
        empty = torch.diff(t.row_ptr) == 0
        want = rp.routed_fwd_hist_ref(t, d)
        for share in (37, *fwd_sweep.HIST_SHARES):
            got = fwd_sweep.hist_fwd(t, d, share, rp.hist_cut(t, share))
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-5 * float(want.abs().max()))
            assert not bool(got[empty].any())
        assert t.cut is None
        got = rp.routed_fwd_hist(t, d)
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))
        assert not bool(got[empty].any())
        assert _adjoint_rel(rp.routed_fwd_hist, rp.routed_bwd_gather, t, gen,
                            cuda) <= 1e-5


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residue", [1, 2, 3])
def test_csr_walks(cuda, residue, w_dtype):
    """routed_fwd (B1) and routed_bwd_gather (B2), f32 and bf16, on rows
    of every length of interest (``bwd_sweep.csr_case``) at ray and voxel
    counts ≡
    1, 2, 3 (mod 32, so mod the rows any warp or CTA holds): against
    their plain versions at rtol 1e-5, bitwise equal over two launches (a
    fixed summation order), and exactly adjoint (rel ≤ 1e-8 on x, y ≥ 0:
    80,000 rows, so the f32 rounding of the 2,000-crossing rows stays
    ~1e-9 of the whole) with B2 and B3 (B1) and with B5 and B6 (B2) on the
    same rounded lengths."""
    R = V = 80000 + residue
    lin, lens = bwd_sweep.csr_case(residue, R, V, cuda)
    t = rp.build_tables(lin, lens, V, w_dtype=w_dtype)
    del lin, lens
    assert int(torch.diff(t.row_ptr).max()) == 2000
    assert int(torch.diff(t.vox_ptr).max()) >= 2000
    gen = torch.Generator().manual_seed(residue)
    x = torch.rand(V, generator=gen).to(cuda)
    y = torch.rand(R, generator=gen).to(cuda)
    for kern, inp in ((rp.routed_fwd, x), (rp.routed_bwd_gather, y)):
        entry = rp._entry(kern.__name__, t.val)
        before = rp.LAUNCHES[entry]
        got = kern(t, inp)
        want = getattr(rp, f"{kern.__name__}_ref")(t, inp)
        torch.cuda.synchronize()
        assert rp.LAUNCHES[entry] == before + 1
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
        assert torch.equal(got, kern(t, inp))
    ax = float(torch.dot(rp.routed_fwd(t, x).double(), y.double()))
    for bwd in (rp.routed_bwd_gather, rp.routed_bwd_scatter):
        aty = float(torch.dot(x.double(), bwd(t, y).double()))
        assert abs(ax - aty) <= 1e-8 * abs(ax), bwd.__name__
    aty = float(torch.dot(x.double(), rp.routed_bwd_gather(t, y).double()))
    for fwd in (rp.routed_fwd_dense, rp.routed_fwd_hist):
        ax = float(torch.dot(fwd(t, x).double(), y.double()))
        assert abs(ax - aty) <= 1e-8 * abs(ax), fwd.__name__


def test_csr_walks_refuse_unaligned_tables(cuda):
    """B1 and B2 read their index and weight tables in aligned quads: a
    table that does not start on 16 B raises, before any launch."""
    t = rp.build_tables(*bwd_sweep.csr_case(4, 300, 50, cuda), 50)
    x, y = torch.rand(50, device=cuda), torch.rand(300, device=cuda)

    def shifted(a):  # the same values 4 B past a 16 B boundary
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)
        buf[1:] = a
        return buf[1:]

    before = dict(rp.LAUNCHES)
    for kern, inp, names in ((rp.routed_fwd, x, ("col", "val")),
                             (rp.routed_bwd_gather, y, ("ray", "valT"))):
        for name in names:
            bad = t._replace(**{name: shifted(getattr(t, name))})
            with pytest.raises(ValueError, match="16-byte"):
                kern(bad, inp)
    assert dict(rp.LAUNCHES) == before


def test_scatter_table_overflow(cuda):
    """Tiles of 128 rays x 128 crossings on voxels drawn from 10^6: ~16,000
    distinct voxels a tile, more than the 8,192 slots of its table, so
    crossings overflow to global atomics; a second CSR with 300 voxels
    overflows none and issues one atomic a (tile, voxel) pair."""
    assert (rp.SCATTER_TILE, rp.SCATTER_SLOTS) == (128, 8192)
    rng = np.random.default_rng(6)
    R, M, V = 600, 128, 10 ** 6
    gen = torch.Generator().manual_seed(6)
    for nv, overflow in ((V, True), (300, False)):
        lin = torch.tensor(rng.integers(0, nv, (R, M)), dtype=torch.int32)
        lens = torch.tensor(rng.random((R, M)), dtype=torch.float32)
        t = rp.build_tables(lin.to(cuda), lens.to(cuda), V, transpose=False)
        dy = torch.randn(R, generator=gen).to(cuda)
        counts = torch.zeros(2, dtype=torch.int32, device=cuda)
        got = rp.routed_bwd_scatter(t, dy, counts=counts)
        want = rp.routed_bwd_scatter_ref(t, dy)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))
        issued, over = counts.tolist()
        pairs = rp.scatter_atomics(t)
        if overflow:
            assert over > 0 and pairs <= issued < t.nnz
        else:
            assert (issued, over) == (pairs, 0) and pairs < t.nnz
        assert _adjoint_rel(rp.routed_fwd, rp.routed_bwd_scatter, t, gen,
                            cuda) <= 1e-5


ROUTED_CONFIGS = [dict(), dict(routed_dense="off"),
                  dict(routed_dense="fwd"), dict(routed_dense="both"),
                  dict(routed_fwd_reduce="hist"),
                  dict(routed_banded=False)]
ROUTED_CONFIGS += [dict(c, routed_w_dtype="bf16") for c in ROUTED_CONFIGS[:5]]


@pytest.mark.parametrize("cfg", ROUTED_CONFIGS, ids=str)
def test_routed_step_matches_cpu(cuda, cfg):
    config = prt.TraceConfig(**cfg)
    grid, op_c = _problem(cuda, config=config)
    _, op_h = _problem("cpu", config=config)
    assert op_c._fwd is op_h._fwd and op_c._bwd is op_h._bwd
    x = np.random.default_rng(1).random(tuple(grid.shape)).astype(np.float32)
    grads = []
    for op in (op_c, op_h):
        v = torch.tensor(x, device=op.device, requires_grad=True)
        y = op(v)
        torch.mean((y - 1.0) ** 2).backward()
        grads.append((y.detach().cpu(), v.grad.cpu()))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-4,
                               atol=1e-7)


def test_cuda_tensor_never_reaches_plain_version(cuda):
    _, op = _problem("cpu")  # tables on the CPU
    with pytest.raises(ValueError, match="tables on cpu"):
        rp.routed_fwd(op._tables, torch.ones(op._tables.n_vox, device=cuda))
    _, op_c = _problem(cuda)
    with pytest.raises(ValueError, match="float32"):
        rp.routed_fwd(op_c._tables, torch.ones(op_c._tables.n_vox,
                                               dtype=torch.float64,
                                               device=cuda))


def _fused_check(got, want):
    """The kernel rounds each float op as the plain version does
    (-fmad=false) and sums in another order: rtol 1e-5, atol 1e-5 of the
    largest value, on every ray."""
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# one grid per padded crossing count Mp = 16 (one warp's 32 slots), 64,
# 128, 256, 512 (the kernel's template K = Mp / 32 distances per lane) on
# an orbit; on the 50³ and (100, 60, 60) grids also rays whose finite
# crossing count is 2^j - 1, 2^j and 2^j + 1 (the compacted sort's sizes
# S = 32 ... 256, and 512 on the Mp = 512 grid), a ray that misses the
# outer sphere (finite cone and plane crossings, no segment inside: y = 0)
# and one that passes 1e-6 from the cones' apex (tools/fused_sweep.
# edge_rays)
EDGE_COUNTS = {(50, 50, 50): [31, 32, 33, 63, 64, 65, 127, 128, 129],
               (100, 60, 60): [255, 256, 257]}


@pytest.mark.parametrize("shape", [(2, 2, 2), (8, 8, 8), (20, 20, 20),
                                   (50, 50, 50), (100, 60, 60)])
def test_fused_kernel_matches_plain_version(cuda, shape):
    grid = prt.SphericalGrid(shape=shape)
    geom = sum(
        prt.ConeRectGeom((16, 24), pos=(2 * np.cos(t), 2 * np.sin(t), 0.3),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 4, endpoint=False))
    gs = GridSpec.from_grid(grid)
    assert fp.supported(gs, int(np.prod(shape)))
    rays = fp.prep_rays(geom.ray_starts, geom.rays, device=cuda)
    if shape in EDGE_COUNTS:
        edge = fused_sweep.edge_rays(gs, EDGE_COUNTS[shape], device=cuda)
        rays = fp.FusedRays(torch.cat([rays.xs, edge.xs]),
                            torch.cat([rays.dirs, edge.dirs]), None, None,
                            None)
    d = torch.rand(int(np.prod(shape)),
                   generator=torch.Generator().manual_seed(2)).to(cuda)
    before = rp.LAUNCHES["fused_fwd"]
    got = fp.fused_fwd(gs, rays, d)
    assert rp.LAUNCHES["fused_fwd"] == before + 1
    _fused_check(got, fp.fused_fwd_ref(gs, rays, d))
    # one accumulator a lane and a fixed shuffle tree
    assert torch.equal(got, fp.fused_fwd(gs, rays, d))
    if shape in EDGE_COUNTS:
        assert float(got[-2]) == 0.0  # the ray that misses the grid


def test_fused_kernel_lerp(cuda):
    grid = prt.SphericalGrid(shape=(3, 8, 6, 6), size_t=(0.0, 10.0))
    geom = sum(
        prt.ConeRectGeom((5, 6), pos=(2 * np.cos(t), 2 * np.sin(t), 0.3),
                         fov=(45, 45))
        for t in np.linspace(0, np.pi, 4, endpoint=False))
    op = prt.Operator(grid, geom, mode="fused", device=cuda,
                      view_times=np.array([0.0, 3.3, 6.7, 10.0]))
    assert op._frays.w is not None
    d = torch.rand(op._flat_size,
                   generator=torch.Generator().manual_seed(3)).to(cuda)
    got = fp.fused_fwd(op.gs, op._frays, d)
    _fused_check(got, fp.fused_fwd_ref(op.gs, op._frays, d))
    assert torch.equal(got, fp.fused_fwd(op.gs, op._frays, d))


@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
def test_fused_step_matches_cpu(cuda, w_dtype):
    grid = prt.SphericalGrid(shape=(12, 10, 10))
    geom = sum(
        prt.ConeRectGeom((8, 9), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 4, endpoint=False))
    x = np.random.default_rng(4).random(tuple(grid.shape)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        op = prt.Operator(grid, geom, mode="fused", device=dev,
                          config=prt.TraceConfig(routed_w_dtype=w_dtype))
        v = torch.tensor(x, device=op.device, requires_grad=True)
        y = op(v)
        torch.mean((y - 1.0) ** 2).backward()
        assert op._fused_btd is not None
        out.append((y.detach().cpu(), v.grad.cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-7)


def test_cg_routed_matches_precomputed(cuda):
    """``solve.cg`` at ``mode='auto'`` (``routed_fwd`` + ``routed_bwd_gather``
    through ``op.T``) against ``mode='precomputed'`` (the plain table path)
    on the card: x and every residual norm within 1e-3 relative, and
    1 + n + 1 forwards and 2 + n adjoints for n iterations."""
    from sph_raytracer_tpu_torch import solve

    grid, op = _problem(cuda)
    op_p = prt.Operator(grid, op.geom, mode="precomputed", device=cuda)
    truth = torch.rand(tuple(grid.shape),
                       generator=torch.Generator().manual_seed(5)).to(cuda)
    y = op_p(truth)
    rp.reset_launches()
    x, _, info = solve.cg(op, y, num_iterations=10, damp=1e-3)
    assert rp.LAUNCHES["routed_fwd"] == 1 + 10 + 1
    assert rp.LAUNCHES["routed_bwd_gather"] == 2 + 10
    x_p, _, info_p = solve.cg(op_p, y, num_iterations=10, damp=1e-3)
    rel = float(torch.linalg.vector_norm(x - x_p)
                / torch.linalg.vector_norm(x_p))
    assert rel <= 1e-3
    np.testing.assert_allclose(info["rnorm"], info_p["rnorm"], rtol=1e-3)


def test_voxel_order_r_matches_a(cuda):
    """``routed_voxel_order='r'`` against ``'a'`` at ``'auto'`` on the card
    at a mid size.  The image (``routed_fwd``: the same ray-major rows,
    relabelled) is bitwise equal.  ``routed_bwd_gather`` splits a voxel's
    row over its lanes by the row's start mod 4 (aligned quads), and the
    relabel moves where each row starts: the gradient and ``.T`` are
    bitwise equal on every voxel whose row starts at the same offset mod 4
    in both tables (or holds at most one crossing), and within rtol 1e-5
    elsewhere (the same sum, added in another order)."""
    grid = prt.SphericalGrid(shape=(24, 20, 20))
    geom = sum(
        prt.ConeRectGeom((32, 36), pos=(2 * np.cos(t), 2 * np.sin(t), 0.3),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 6, endpoint=False))
    ops = {vo: prt.Operator(grid, geom, device=cuda, config=prt.TraceConfig(
        routed_voxel_order=vo)) for vo in "ar"}
    gen = torch.Generator().manual_seed(7)
    x = torch.rand(tuple(grid.shape), generator=gen).to(cuda)
    y = torch.rand(tuple(geom.shape), generator=gen).to(cuda)
    out = {}
    for vo, op in ops.items():
        v = x.clone().requires_grad_(True)
        img = op(v)
        (g,) = torch.autograd.grad(torch.mean((img - y) ** 2), v)
        out[vo] = (img.detach(), g.reshape(-1), op.T(y).reshape(-1))
    assert torch.equal(out["r"][0], out["a"][0])
    ta, tr = ops["a"]._tables, ops["r"]._tables
    ids = torch.arange(ta.n_vox, device=cuda, dtype=torch.int32)
    rid = prt.ops.trace.voxel_order_lin(ids, grid.vshape, "r").long()
    start_a, start_r = ta.vox_ptr[:-1], tr.vox_ptr[:-1][rid]
    same = (start_a % 4 == start_r % 4) | (torch.diff(ta.vox_ptr) <= 1)
    for got, want in zip(out["r"][1:], out["a"][1:]):
        assert torch.equal(got[same], want[same])
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


def _sharded_problem(device):
    grid = prt.SphericalGrid(shape=(12, 10, 10))
    geom = sum(
        prt.ConeRectGeom((8, 9), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 4, endpoint=False))
    gen = torch.Generator().manual_seed(11)
    x = torch.rand(tuple(grid.shape), generator=gen).to(device)
    return grid, geom, x, torch.rand(tuple(geom.shape),
                                     generator=gen).to(device)


def _step(op, x, t):
    v = x.clone().requires_grad_(True)
    img = op(v)
    (g,) = torch.autograd.grad(torch.mean((img - t) ** 2), v)
    return img.detach(), g, op.T(t)


def test_sharded_nccl_world1_bitwise(cuda, tmp_path):
    """A one-rank NCCL group (``file://`` store): ``ShardedOperator`` at
    'auto', 'off' and fused, and ``VolShardedOperator``, bitwise equal to
    the unsharded operator (one rank's tables are the whole table set, and
    a one-rank sum is the identity)."""
    from sph_raytracer_tpu_torch.parallel import (ShardedOperator,
                                                  VolShardedOperator,
                                                  distributed_init, make_mesh)

    import torch.distributed as dist

    distributed_init(f"file://{tmp_path}/store", num_processes=1,
                     process_id=0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        grid, geom, x, t = _sharded_problem(cuda)
        for cls, kw in ((ShardedOperator, dict(mode="routed")),
                        (ShardedOperator, dict(config=prt.TraceConfig(
                            routed_dense="off"))),
                        (ShardedOperator, dict(mode="fused")),
                        (VolShardedOperator, {})):
            ref = prt.Operator(grid, geom, device=cuda, **kw)
            sop = cls(grid, geom, mesh=mesh, **kw)
            before = dict(rp.LAUNCHES)
            got = _step(sop, x, t)
            assert sum(rp.LAUNCHES.values()) > sum(before.values())
            for a, b in zip(got, _step(ref, x, t)):
                if ref._bwd is rp.routed_bwd_scatter and a.shape != t.shape:
                    # the scatter's atomics add in a run-to-run order
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
                else:
                    assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_empty_shard_launches_nothing(cuda):
    """Tables with no crossing, and a fused call with no ray: every wrapper
    returns zeros (or nothing) and launches nothing (CUDA refuses an empty
    grid); four thread ranks over three rays on the card (gloo, CUDA
    tensors) match the unsharded operator's image and ``.T`` and do not
    hang.  (Not the gradient: the autograd engine runs a card's backward on
    one thread of its own, where thread ranks' collectives would wait on
    each other; ``chip_smoke.py`` phase 19 runs such ranks as processes.)"""
    import datetime
    import threading

    import torch.distributed as dist

    from sph_raytracer_tpu_torch.parallel import ShardedOperator
    from sph_raytracer_tpu_torch.parallel.mesh import Mesh

    lin = torch.zeros((5, 4), dtype=torch.int32, device=cuda)
    lens = torch.zeros((5, 4), device=cuda)
    d, dy = torch.rand(30, device=cuda), torch.rand(5, device=cuda)
    before = dict(rp.LAUNCHES)
    for rows in (slice(None), slice(0, 0)):
        t = rp.build_tables(lin[rows], lens[rows], 30)
        w = rp.build_window_tables(lin[rows], lens[rows], 30)
        n = t.n_rays
        for kern, tab, x in ((rp.routed_fwd, t, d),
                             (rp.routed_fwd_dense, t, d),
                             (rp.routed_fwd_hist, t, d),
                             (rp.routed_bwd_gather, t, dy[:n]),
                             (rp.routed_bwd_scatter, t, dy[:n]),
                             (rp.routed_fwd_window, w, d),
                             (rp.routed_bwd_window, w, dy[:n]),
                             (rp.routed_fwd_densew, w, d)):
            assert not kern(tab, x).any()
    gs = GridSpec.from_grid(prt.SphericalGrid(shape=(4, 4, 4)))
    rays = fp.prep_rays(np.zeros((0, 3)), np.ones((0, 3)), device=cuda)
    assert fp.fused_fwd(gs, rays, torch.rand(64, device=cuda)).shape == (0,)
    torch.cuda.synchronize()
    assert rp.LAUNCHES == before

    grid = prt.SphericalGrid(shape=(5, 5, 5))
    geom = prt.ViewGeom(np.array([[2.0, 0.3, 0.2], [2.0, -0.2, 0.1],
                                  [0.3, 2.0, -0.2]]),
                        np.array([[-1.0, 0.0, 0.0], [-1.0, 0.1, 0.0],
                                  [0.0, -1.0, 0.1]]))
    x = torch.rand((5, 5, 5), device=cuda)
    t = torch.rand(3, device=cuda)
    ref = prt.Operator(grid, geom, mode="routed", device=cuda)
    want = (ref(x), ref.T(t))
    store, out = dist.HashStore(), [None] * 4

    def body(r):
        pg = dist.ProcessGroupGloo(dist.PrefixStore("e", store), r, 4,
                                   datetime.timedelta(seconds=60))
        sop = ShardedOperator(grid, geom, mode="routed",
                              mesh=Mesh(pg, r, 4, cuda))
        out[r] = (sop._rows, (sop(x), sop.T(t)))

    threads = [threading.Thread(target=body, args=(r,)) for r in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(90)
    assert not any(th.is_alive() for th in threads)
    assert out[3][0] == (3, 3)
    for _, got in out:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_table_cache_warm_hit_bitwise(cuda, tmp_path, monkeypatch):
    """A warm table-cache hit on the card traces nothing and gives bitwise
    the cold build's tables (and, through ``routed_fwd``, whose sums run in
    a fixed order, bitwise the image; the window forward's atomics add in a
    run-to-run order)."""
    from sph_raytracer_tpu_torch import operator as op_mod

    monkeypatch.setenv("SPH_TPU_TRACE_CACHE", str(tmp_path))
    grid, geom, x, t = _sharded_problem(cuda)
    for cfg in (prt.TraceConfig(), prt.TraceConfig(routed_banded=False),
                prt.TraceConfig(routed_w_dtype="bf16")):
        cold = prt.Operator(grid, geom, device=cuda, config=cfg)
        with monkeypatch.context() as m:
            m.setattr(op_mod, "precompute_table", None)  # a call raises
            warm = prt.Operator(grid, geom, device=cuda, config=cfg)
        for a, b in zip(cold._tables, warm._tables):
            assert (a is None and b is None) or (
                a == b if isinstance(a, int) else
                a.device == b.device and a.dtype == b.dtype
                and torch.equal(a, b))
        if cold._fwd is rp.routed_fwd:
            assert torch.equal(cold(x), warm(x))
        else:
            torch.testing.assert_close(warm(x), cold(x), rtol=1e-5,
                                       atol=1e-6)


def test_examples_tiny_on_card(cuda, tmp_path):
    """Two example modules tiny on the card: ``single_vantage``'s image
    against ``mode='precomputed'`` (one ``routed_fwd`` launch), and
    ``aot_serving``'s served image bitwise the live one, its gradient at a
    seeded target the live operator's (the served programs launch the
    same kernels)."""
    from sph_raytracer_tpu_torch.examples import aot_serving, single_vantage

    rp.reset_launches()
    res = single_vantage.run(cuda, grid_shape=(12, 10, 10), det=(24, 20))
    torch.cuda.synchronize()
    assert rp.LAUNCHES["routed_fwd"] == 1
    ref = prt.Operator(res["op"].grid, res["op"].geom, mode="precomputed",
                       device=cuda)
    want = ref(res["x"])
    torch.testing.assert_close(res["image"], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))

    rp.reset_launches()
    res = aot_serving.run(cuda, n=12, det=16, export_dir=str(tmp_path))
    torch.cuda.synchronize()
    assert rp.LAUNCHES["routed_fwd"] >= 3
    assert rp.LAUNCHES["routed_bwd_gather"] >= 1
    assert torch.equal(res["image"], res["live"])
    d = res["density"].clone().requires_grad_(True)
    t = torch.rand(res["image"].shape, generator=torch.Generator()
                   .manual_seed(5)).to(cuda)
    torch.mean((res["op"](d) - t) ** 2).backward()
    torch.testing.assert_close(res["serve_grad"](res["density"], t), d.grad)
