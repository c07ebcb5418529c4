"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Run on a machine with an H100 (no JAX needed there; ``--noconftest``
skips tests/conftest.py, which imports jax)::

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (the fused kernel at every padded crossing count it is built for,
and with the lerp), and one routed and one fused training step on the card
against the CPU.
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


def test_routed_step_matches_cpu(cuda):
    grid, op_c = _problem(cuda)
    _, op_h = _problem("cpu")
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
