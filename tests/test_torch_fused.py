"""Port fused mode vs the JAX package (CPU; the kernel's plain version).

* ``fused_fwd_ref`` (the plain version of the ``fused_fwd`` CUDA kernel)
  against the JAX package's in-kernel fused engine in interpret mode on one
  case (one interpret compile for the whole file), and its boundary table
  against the JAX kernel's.
* ``Operator(mode='fused', device='cpu')`` against the JAX f32
  ``mode='precomputed'`` operator on the cases of tests/test_fused_pallas.py,
  forward and gradient through every ``fused_bwd`` / ``routed_dense``
  backward; binned 4D and ``view_times`` likewise.
* The lazy backward-only tables, the adjoint identity, the envelope, the
  blockwise path (``project_fused``) against the goldens, channels.

Tolerances: forward atol 2e-5 / rtol 1e-4 and gradient atol 1e-4 /
rtol 1e-3, those of tests/test_fused_pallas.py:61,67 (f32 sums in another
order, and the two packages' f32 traces differ by ~1e-5 relative); goldens
at tests/test_parity.py's rtol 1e-5 / atol 1e-6 (f64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu.ops import fused_pallas as jfp
from sph_raytracer_tpu.ops.trace import GridSpec as JGridSpec
from sph_raytracer_tpu_torch.ops import fused_project as fp
from sph_raytracer_tpu_torch.ops import routed_project as rp
from sph_raytracer_tpu_torch.ops.trace import GridSpec
from test_torch_operator import GOLDENS, assert_golden_parity, load

torch.set_num_threads(2)

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=1e-4, rtol=1e-3)


def _orbit(pkg, views, det, z, phase=0.0, span=2 * np.pi):
    return sum(pkg.ConeRectGeom(det, pos=(2 * np.cos(t), 2 * np.sin(t), z),
                                fov=(45, 45))
               for t in np.linspace(phase, phase + span, views,
                                    endpoint=False))


# tests/test_fused_pallas.py:31-45, for either package
CASES = [
    (dict(shape=(8, 9, 10), size_r=(0.3, 1.0)),
     lambda pkg: _orbit(pkg, 3, (6, 7), 0.4)),
    (dict(shape=(7, 6, 9), size_r=(0.1, 1.0), spacing="log"),
     lambda pkg: pkg.ConeRectGeom((5, 6), pos=(0.5, 0.1, 0.2),
                                  lookdir=(1.0, 0.3, -0.1), fov=(60, 60))),
    (dict(r_b=np.linspace(0.0, 1.0, 7), e_b=np.linspace(0.4, 2.7, 7),
          a_b=np.linspace(-2.0, 2.4, 8)),
     lambda pkg: pkg.ConeRectGeom((6, 6), pos=(1.8, -0.4, 0.3),
                                  fov=(35, 35))),
]


def _case(pkg, i):
    gkw, mk = CASES[i]
    return pkg.SphericalGrid(**gkw), mk(pkg)


def _density(grid, seed):
    return np.random.default_rng(seed).random(
        tuple(grid.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernel's plain version vs the JAX kernel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_kernel_case():
    """CASES[0] through the JAX in-kernel fused engine (interpret)."""
    grid, geom = _case(srt, 0)
    gs = JGridSpec.from_grid(grid, ftype=jnp.float32)
    x = _density(grid, 0).reshape(-1)
    xs = jnp.asarray(np.broadcast_to(geom.ray_starts, (*geom.shape, 3)),
                     jnp.float32)
    rays = jnp.asarray(geom.rays, jnp.float32)
    y = jfp.fused_pallas_project(gs, jnp.asarray(x), xs, rays, jnp.int32,
                                 True)
    return x, np.asarray(y).reshape(-1)


def test_plain_version_matches_jax_kernel(jax_kernel_case):
    x, y_jax = jax_kernel_case
    grid, geom = _case(prt, 0)
    rays = fp.prep_rays(geom.ray_starts, geom.rays)
    y = fp.fused_fwd_ref(GridSpec.from_grid(grid), rays, torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), y_jax, **FWD)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_boundary_table_matches_jax(case):
    """Same f32 values as fused_pallas.py::_boundary_const, bit for bit."""
    grid, _ = _case(prt, case)
    gs = GridSpec.from_grid(grid)
    bc = jfp._boundary_const(JGridSpec.from_grid(_case(srt, case)[0],
                                                 ftype=jnp.float32))
    tab = fp._table_np(gs)
    rows = bc.shape[0] - 8
    nb = (gs.nr + 1, gs.ne + 1, gs.ne + 1, gs.ne + 1, gs.na + 1, gs.na + 1)
    for row, col, n in zip((fp.R2C, fp.COS2, fp.COS_UP, fp.NOT_EQ, fp.SIN_A,
                            fp.COS_A), range(6), nb):
        np.testing.assert_array_equal(tab[row, :n], bc[:n, col])
    for row, k in zip((fp.R2S, fp.COS_E, fp.SIN_A, fp.COS_A, fp.A_NEG),
                      range(5)):
        np.testing.assert_array_equal(tab[row], bc[rows + k])


def test_wrapper_takes_plain_version_only_on_cpu():
    grid, geom = _case(prt, 0)
    gs = GridSpec.from_grid(grid)
    rays = fp.prep_rays(geom.ray_starts, geom.rays)
    d = torch.tensor(_density(grid, 1).reshape(-1))
    rp.reset_launches()
    assert torch.equal(fp.fused_fwd(gs, rays, d),
                       fp.fused_fwd_ref(gs, rays, d))
    assert set(rp.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# Operator(mode='fused') vs the JAX precomputed operator
# ---------------------------------------------------------------------------

_JAX_REF = {}


def _jax_reference(key, make, seed, **kw):
    """(x, image, grad of sum(image**2)) of the JAX f32 precomputed
    operator on the problem ``make(srt)``; cached per key."""
    if key not in _JAX_REF:
        grid, geom = make(srt)
        op = srt.Operator(grid, geom, mode="precomputed", ftype=jnp.float32,
                          **kw)
        x = _density(grid, seed)
        img = np.asarray(op(jnp.asarray(x)))
        g = np.asarray(jax.grad(lambda v: jnp.sum(op(v) ** 2))(
            jnp.asarray(x)))
        _JAX_REF[key] = (x, img, g)
    return _JAX_REF[key]


def _check_operator(op, x, img, grad):
    v = torch.tensor(x, requires_grad=True)
    y = op(v)
    np.testing.assert_allclose(y.detach().numpy(), img, **FWD)
    torch.sum(y ** 2).backward()
    np.testing.assert_allclose(v.grad.numpy(), grad, **GRAD)


BWDS = [("auto", "auto", rp.routed_bwd_gather),
        ("auto", "off", rp.routed_bwd_scatter),
        ("routed", "auto", rp.routed_bwd_gather),
        ("routed", "off", rp.routed_bwd_scatter),
        ("retrace", "auto", None)]


@pytest.mark.parametrize("fused_bwd,dense,bwd", BWDS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_fused_operator_matches_jax(case, fused_bwd, dense, bwd):
    x, img, grad = _jax_reference(("case", case),
                                  lambda pkg: _case(pkg, case), case)
    grid, geom = _case(prt, case)
    op = prt.Operator(grid, geom, mode="fused", device="cpu",
                      config=prt.TraceConfig(fused_bwd=fused_bwd,
                                             routed_dense=dense))
    assert op._engine
    assert op._fused_bwd == ("routed" if fused_bwd == "auto" else fused_bwd)
    assert op._bwd is (bwd or op._bwd)
    _check_operator(op, x, img, grad)


def _dynamic(pkg):
    """tests/test_fused_pallas.py:92-112: binned 4D, view angles off the
    π/3-spaced azimuth boundaries."""
    grid = pkg.SphericalGrid(shape=(3, 6, 6, 6), size_r=(0.3, 1.0))
    return grid, _orbit(pkg, 3, (5, 5), 0.3, phase=0.15, span=np.pi)


def test_fused_dynamic_binned_matches_jax():
    x, img, grad = _jax_reference("dynamic", _dynamic, 1)
    op = prt.Operator(*_dynamic(prt), mode="fused", device="cpu")
    assert op._engine and op._frays.off0 is not None
    _check_operator(op, x, img, grad)


TIMES = np.array([0.0, 3.3, 6.7, 10.0])


def _lerp(pkg):
    """tests/test_fused_pallas.py:232-260: view_times with lerp."""
    grid = pkg.SphericalGrid(shape=(3, 8, 6, 6), size_t=(0.0, 10.0))
    return grid, _orbit(pkg, 4, (5, 6), 0.3, span=np.pi)


@pytest.mark.parametrize("fused_bwd", ["auto", "retrace"])
def test_fused_view_times_matches_jax(fused_bwd):
    """The lerp kernel reads both time bins per segment; the JAX
    precomputed operator doubles its table.  The gradient runs on the
    port's doubled backward tables ('auto') or re-traces ('retrace')."""
    x, img, grad = _jax_reference("lerp", _lerp, 2, view_times=TIMES)
    grid, geom = _lerp(prt)
    op = prt.Operator(grid, geom, mode="fused", device="cpu",
                      view_times=TIMES,
                      config=prt.TraceConfig(fused_bwd=fused_bwd))
    assert op._engine and op._frays.w is not None
    _check_operator(op, x, img, grad)


def test_view_times_outside_engine_fall_back():
    grid, geom = _lerp(prt)
    with pytest.warns(UserWarning, match="view_times"):
        op = prt.Operator(grid, geom, mode="fused", device="cpu",
                          view_times=TIMES,
                          config=prt.TraceConfig(fused_backend="xla"))
    assert op._mode == "precomputed"


# ---------------------------------------------------------------------------
# lazy tables, adjoint, channels
# ---------------------------------------------------------------------------

def test_lazy_backward_tables():
    grid, geom = _case(prt, 0)
    x = torch.tensor(_density(grid, 5))
    op = prt.Operator(grid, geom, mode="fused", device="cpu")
    assert op._fused_bwd_lazy and op._fused_btd is None and op.lin is None
    with torch.no_grad():
        op(x.requires_grad_(True))
    assert op._fused_btd is None            # a forward under no_grad
    op(x.detach())
    assert op._fused_btd is None            # no gradient asked for
    torch.sum(op(x.requires_grad_(True))).backward()
    t = op._fused_btd                       # the first gradient
    assert t is not None and t.row_ptr is None and t.vox_ptr is not None
    assert t.nbytes == sum(a.numel() * a.element_size()
                           for a in (t.vox_ptr, t.ray, t.valT))

    op_t = prt.Operator(grid, geom, mode="fused", device="cpu")
    op_t.T(torch.ones(tuple(geom.shape)))
    assert op_t._fused_btd is not None      # the first .T()
    op_off = prt.Operator(grid, geom, mode="fused", device="cpu",
                          config=prt.TraceConfig(routed_dense="off"))
    op_off.T(torch.ones(tuple(geom.shape)))
    assert op_off._fused_btd.vox_ptr is None
    assert op_off._fused_btd.row_ptr is not None
    op_r = prt.Operator(grid, geom, mode="fused", device="cpu",
                        config=prt.TraceConfig(fused_bwd="routed"))
    assert not op_r._fused_bwd_lazy and op_r._fused_btd is not None
    op_x = prt.Operator(grid, geom, mode="fused", device="cpu",
                        config=prt.TraceConfig(fused_bwd="retrace"))
    torch.sum(op_x(x.requires_grad_(True))).backward()
    assert op_x._fused_btd is None and op_x._tables_memo is None


@pytest.mark.parametrize("fused_bwd", ["auto", "retrace"])
def test_fused_adjoint_identity(fused_bwd):
    """<A x, y> = <x, Aᵀ y>: the fused forward against ``.T`` (routed
    backward tables, or the memoised trace for 'retrace').  Both label
    these rays alike (no knife edge in CASES[0]), so relative 1e-5."""
    grid, geom = _case(prt, 0)
    op = prt.Operator(grid, geom, mode="fused", device="cpu",
                      config=prt.TraceConfig(fused_bwd=fused_bwd))
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=tuple(grid.shape)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=tuple(geom.shape)), dtype=torch.float32)
    lhs = float(torch.sum(op(x).double() * y.double()))
    rhs = float(torch.sum(x.double() * op.T(y).double()))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_fused_channels():
    grid, geom = _case(prt, 0)
    x = torch.tensor(_density(grid, 7))
    op = prt.Operator(grid, geom, mode="fused", device="cpu")
    y = op(torch.stack([x, 2 * x]))
    assert y.shape == (2, *geom.shape)
    np.testing.assert_allclose(y[0].numpy(), op(x).numpy(), rtol=1e-6)
    np.testing.assert_allclose(y[1].numpy(), op(2 * x).numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# envelope and the blockwise path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,ftype", [
    ((100, 100, 100), "float32"), ((128, 128, 128), "float32"),
    ((8, 8, 8), "float64"), ((8, 9, 10), "float32")])
def test_supported_agrees_with_jax(shape, ftype):
    """The grids of tests/test_fused_pallas.py:139-162."""
    n = int(np.prod(shape))
    jgs = JGridSpec.from_grid(srt.SphericalGrid(shape=shape),
                              ftype=getattr(jnp, ftype))
    gs = GridSpec.from_grid(prt.SphericalGrid(shape=shape),
                            ftype=getattr(torch, ftype))
    assert fp.supported(gs, n) == jfp.supported(jgs, n)


def test_envelope_and_blockwise_path():
    geom = prt.ConeRectGeom((4, 4), pos=(2.0, 0.1, 0.2), fov=(30, 30))
    with pytest.raises(ValueError, match="envelope"):
        prt.Operator(prt.SphericalGrid(shape=(128, 128, 128)), geom,
                     mode="fused", device="cpu",
                     config=prt.TraceConfig(fused_backend="pallas"))
    grid, geom = _case(prt, 0)
    x = _density(grid, 8)
    # the blockwise path sums the same trace as the precomputed table
    for cfg in (prt.TraceConfig(fused_backend="xla"),
                prt.TraceConfig(ftype=torch.float64)):
        op = prt.Operator(grid, geom, mode="fused", device="cpu",
                          config=cfg)
        assert not op._engine and op._fused_bwd == "retrace"
        ref = prt.Operator(grid, geom, mode="precomputed", device="cpu",
                           config=cfg)
        xt = torch.tensor(x, dtype=cfg.ftype)
        np.testing.assert_allclose(op(xt).numpy(), ref(xt).numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_project_fused_golden_parity(name):
    """The blockwise path in float64 (image, loss and gradient through
    the checkpointed re-trace) at tests/test_parity.py's tolerances."""
    grid_fn, geom_fn, tol = GOLDENS[name]
    op = prt.Operator(grid_fn(), geom_fn(), mode="fused",
                      ftype=torch.float64, device="cpu")
    assert op._mode == "fused" and not op._engine
    assert_golden_parity(op, load(name), **tol)
