"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Run on a machine with an H100 (no JAX needed there; ``--noconftest``
skips tests/conftest.py, which imports jax)::

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (the fused kernel at every padded crossing count it is built for,
and with the lerp; the routed variants on synthetic tables with empty
rays, empty windows and a last tile of one ray; the window backward on a
window cut into several work items, the scatter backward on tiles that
overflow its shared table), and one training step of each routed
configuration and of fused mode on the card against the CPU.
"""
import numpy as np
import pytest
import torch

import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import fused_project as fp
from sph_raytracer_tpu_torch.ops import routed_project as rp
from sph_raytracer_tpu_torch.ops.trace import GridSpec

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
    # the gather backward is deterministic run to run
    assert torch.equal(rp.routed_bwd_gather(t, dy),
                       rp.routed_bwd_gather(t, dy))


def _synthetic(seed, R, V, M, vox=None, empty=0.1, long_ray=0):
    """A (lin, lens) table of R rays x M slots: voxel ids drawn from
    ``vox`` (default all V), a share ``empty`` of rays without crossings,
    zero-length slots scattered, and ray 0 given ``long_ray`` crossings
    (longer than a thread's share of a hist tile)."""
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


# R = 2·1024 + 1 = 8·256 + 1: the last window tile (WIN_G = 1024) and the
# last hist tile (256 rays) hold one ray; the third case draws its voxels
# from two ranges of 300, so most windows are empty
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


# one grid per padded crossing count Mp = 32, 64, 128, 256, 512 (the
# kernel's template K = Mp / 32 distances per lane)
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
    d = torch.rand(int(np.prod(shape)),
                   generator=torch.Generator().manual_seed(2)).to(cuda)
    before = rp.LAUNCHES["fused_fwd"]
    got = fp.fused_fwd(gs, rays, d)
    assert rp.LAUNCHES["fused_fwd"] == before + 1
    _fused_check(got, fp.fused_fwd_ref(gs, rays, d))


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
    _fused_check(fp.fused_fwd(op.gs, op._frays, d),
                 fp.fused_fwd_ref(op.gs, op._frays, d))


def test_fused_step_matches_cpu(cuda):
    grid = prt.SphericalGrid(shape=(12, 10, 10))
    geom = sum(
        prt.ConeRectGeom((8, 9), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                         fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 4, endpoint=False))
    x = np.random.default_rng(4).random(tuple(grid.shape)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        op = prt.Operator(grid, geom, mode="fused", device=dev)
        v = torch.tensor(x, device=op.device, requires_grad=True)
        y = op(v)
        torch.mean((y - 1.0) ** 2).backward()
        assert op._fused_btd is not None
        out.append((y.detach().cpu(), v.grad.cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-7)
