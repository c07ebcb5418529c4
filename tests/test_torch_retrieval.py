"""Port losses, ``gd`` and the JAX-state interop vs the JAX package.

Inputs are made with numpy from a seed and handed to both packages; every
comparison runs at float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu.loss as jloss
import sph_raytracer_tpu_torch as prt
import sph_raytracer_tpu_torch.loss as ploss
from sph_raytracer_tpu.models import FullyDenseModel as JaxDense
from sph_raytracer_tpu.retrieval import gd as jax_gd
from sph_raytracer_tpu_torch.models import FullyDenseModel
from sph_raytracer_tpu_torch.retrieval import gd
from sph_raytracer_tpu_torch.utils import (
    adam_state_from_jax,
    adam_state_to_jax,
    load_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(2)

SHAPE = (3, 4, 5)
NPIX = 7

rng = np.random.default_rng(0)
A = rng.normal(size=(NPIX, int(np.prod(SHAPE))))
D = rng.normal(size=SHAPE)
Y = rng.random(NPIX) + 0.5
PMASK = (rng.random(NPIX) > 0.3).astype(np.float64)
VMASK = (rng.random(SHAPE) > 0.3).astype(np.float64)
TRUTH = rng.normal(size=SHAPE)


def _f_jax(d):
    return jnp.asarray(A) @ d.reshape(-1)


def _f_torch(d):
    return torch.tensor(A) @ d.reshape(-1)


# each loss, built the same way in both packages
LOSSES = {
    "square": lambda m: m.SquareLoss(projection_mask=PMASK),
    "square_rel": lambda m: m.SquareRelLoss(volume_mask=VMASK),
    "abs": lambda m: 2 * m.AbsLoss(projection_mask=PMASK),
    "cheater": lambda m: m.CheaterLoss(TRUTH, volume_mask=VMASK),
    "neg": lambda m: m.NegRegularizer(volume_mask=VMASK),
    "neg_sum": lambda m: 0.5 * m.NegSumRegularizer(),
    "tv": lambda m: m.TVRegularizer(volume_mask=VMASK),
    "poisson": lambda m: m.PoissonLoss(scale=0.7, projection_mask=PMASK),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    jl, pl = LOSSES[name](jloss), LOSSES[name](ploss)
    assert jl.kind == pl.kind
    d = D if name != "poisson" else np.abs(D)  # positive Poisson rates
    jv, jg = jax.value_and_grad(
        lambda v: jl(_f_jax, jnp.asarray(Y), v, v))(jnp.asarray(d))
    dt = torch.tensor(d, requires_grad=True)
    pv = pl(_f_torch, torch.tensor(Y), dt, dt)
    pv.backward()
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-10)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-14)


@pytest.fixture(scope="module")
def problem():
    def build(pkg, **kw):
        grid = pkg.SphericalGrid(shape=(6, 6, 6))
        geom = sum(
            pkg.ConeRectGeom((6, 6), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                             fov=(50, 50))
            for t in np.linspace(0, 2 * np.pi, 4, endpoint=False))
        return grid, pkg.Operator(grid, geom, **kw)

    jgrid, jop = build(srt, ftype=jnp.float64)
    grid, op = build(prt, ftype=torch.float64, device="cpu")
    r = np.random.default_rng(1)
    y = np.asarray(jop(jnp.asarray(r.random(tuple(grid.shape)))))
    c0 = r.random(tuple(grid.shape))
    return jgrid, jop, grid, op, y, c0


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-12)


def test_gd_matches_jax(problem):
    jgrid, jop, grid, op, y, c0 = problem
    jc, jy, jh = jax_gd(jop, y, JaxDense(jgrid), coeffs=jnp.asarray(c0),
                        num_iterations=5, lr=0.05, progress_bar=False)
    pc, py, ph = gd(op, y.copy(), FullyDenseModel(grid),
                    coeffs=torch.tensor(c0), num_iterations=5, lr=0.05,
                    progress_bar=False)
    assert pc.dtype == torch.float64
    _close(pc.numpy(), jc)
    _close(py.numpy(), jy)
    (jhist,), (phist,) = jh.values(), ph.values()
    assert len(phist) == 5
    _close(phist, jhist)


def test_resume_from_jax_checkpoint(problem, tmp_path):
    """3 JAX gd steps → checkpoint → interop → 3 port steps == 6 JAX
    steps."""
    jgrid, jop, grid, op, y, c0 = problem
    ck = str(tmp_path / "ck.npz")
    jax_gd(jop, y, JaxDense(jgrid), coeffs=jnp.asarray(c0),
           num_iterations=3, lr=0.05, progress_bar=False,
           checkpoint_path=ck, checkpoint_every=3)
    leaves, it = load_checkpoint(ck)
    assert it == 3
    # the JAX checkpoint's leaf order is that of (coeffs, optax.adam state)
    like = jax.tree.leaves((jnp.asarray(c0), optax.adam(0.05).init(
        jnp.asarray(c0))))
    assert [np.shape(x) for x in leaves] == [np.shape(x) for x in like]
    assert leaves[1].dtype == np.int32 and int(leaves[1]) == 3

    jc6, _, jh6 = jax_gd(jop, y, JaxDense(jgrid), coeffs=jnp.asarray(c0),
                         num_iterations=6, lr=0.05, progress_bar=False)
    pc, _, ph = gd(op, y.copy(), FullyDenseModel(grid),
                   coeffs=torch.tensor(c0), num_iterations=6, lr=0.05,
                   progress_bar=False, checkpoint_path=ck, resume=True)
    _close(pc.numpy(), jc6)
    (jhist,), (phist,) = jh6.values(), ph.values()
    assert len(phist) == 3
    _close(phist, jhist[3:])


def test_interop_round_trip(tmp_path):
    r = np.random.default_rng(2)
    leaves = [r.random(SHAPE), np.asarray(7, np.int32), r.random(SHAPE),
              r.random(SHAPE)]
    c, st = adam_state_from_jax(leaves, device="cpu")
    assert float(st["step"]) == 7 and st["exp_avg"].dtype == torch.float64
    back = adam_state_to_jax(c, st)
    for a, b in zip(leaves, back):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, (c, {"b": st["exp_avg"], "a": 3}), 5)
    (c2, d2), it = load_checkpoint(path, like=(c, {"b": st["exp_avg"],
                                                   "a": 0}))
    assert it == 5 and int(d2["a"]) == 3
    np.testing.assert_array_equal(c2, leaves[0])


def test_gd_port_contract(problem):
    """Best-so-far, oracle losses and the proj hook, in the port alone."""
    _, _, grid, op, y, c0 = problem

    class Positive(FullyDenseModel):
        def proj(self, c):
            return torch.clamp(c, min=0)

    lfs = [ploss.SquareLoss(), ploss.CheaterLoss(c0, use_grad=False)]
    pc, py, ph = gd(op, y.copy(), Positive(grid), coeffs=torch.tensor(-c0),
                    num_iterations=4, loss_fns=lfs, lr=0.1,
                    progress_bar=False)
    assert set(ph) == set(lfs) and all(len(v) == 4 for v in ph.values())
    assert py.shape == y.shape and bool((pc >= 0).all())
    with pytest.raises(ValueError, match="same grid"):
        gd(op, y, FullyDenseModel(prt.SphericalGrid(shape=(5, 6, 6))),
           num_iterations=1, progress_bar=False)


def test_gd_accepts_chunk(problem):
    """``chunk=`` (the JAX package's scan length, tests/test_retrieval.py's
    call form) is accepted and changes nothing in the eager loop."""
    _, _, grid, op, y, c0 = problem
    runs = [gd(op, y.copy(), FullyDenseModel(grid), coeffs=torch.tensor(c0),
               num_iterations=3, lr=0.05, progress_bar=False, **kw)
            for kw in ({}, {"chunk": 5})]
    (c_a, y_a, h_a), (c_b, y_b, h_b) = runs
    assert torch.equal(c_a, c_b) and torch.equal(y_a, y_b)
    assert list(h_a.values()) == list(h_b.values())
    assert len(next(iter(h_b.values()))) == 3


class _JaxScaled(srt.models.Model):
    """tests/test_retrieval.py::test_gd_pytree_coeffs's model: dict
    coefficients ``{"vol", "scale"}``, volume ``vol * scale``."""

    def __init__(self, grid):
        self.grid = grid

    def __call__(self, c):
        return c["vol"] * c["scale"]

    @property
    def coeffs_shape(self):
        return None  # the caller supplies the coefficients


class _PortScaled(prt.models.Model):
    def __init__(self, grid):
        self.grid = grid

    def __call__(self, c):
        return c["vol"] * c["scale"]

    @property
    def coeffs_shape(self):
        return None


def _init(pkg_full, pkg_ones):
    return {"vol": pkg_full((6, 6, 6), 0.5), "scale": pkg_ones(())}


@pytest.fixture(scope="module")
def jax_pytree(problem, tmp_path_factory):
    """The JAX package's pytree ``gd``: 6 iterations, and 3 iterations
    that leave a checkpoint."""
    jgrid, jop, grid, op, y, c0 = problem
    init = _init(jnp.full, jnp.ones)
    ck = str(tmp_path_factory.mktemp("pytree") / "ck.npz")
    jax_gd(jop, y, _JaxScaled(jgrid), coeffs=init, num_iterations=3,
           lr=0.05, progress_bar=False, checkpoint_path=ck,
           checkpoint_every=3)
    return jax_gd(jop, y, _JaxScaled(jgrid), coeffs=init, num_iterations=6,
                  lr=0.05, progress_bar=False), ck


def _port_init():
    return _init(lambda s, v: torch.full(s, v, dtype=torch.float64),
                 lambda s: torch.ones(s, dtype=torch.float64))


def test_gd_pytree_coeffs_match_jax(problem, jax_pytree):
    """Dict coefficients (the JAX package's replacement for the
    reference's ``optim_vars``): every leaf optimized, the same structure
    back, per leaf and loss history equal to the JAX package's."""
    _, _, grid, op, y, _ = problem
    (jc, jy, jh), _ = jax_pytree
    pc, py, ph = gd(op, y.copy(), _PortScaled(grid), coeffs=_port_init(),
                    num_iterations=6, lr=0.05, progress_bar=False)
    assert set(pc) == {"vol", "scale"}
    assert pc["vol"].shape == (6, 6, 6) and pc["scale"].shape == ()
    for k in pc:
        assert pc[k].dtype == torch.float64
        _close(pc[k].numpy(), jc[k])
    _close(py.numpy(), jy)
    (jhist,), (phist,) = jh.values(), ph.values()
    assert len(phist) == 6 and phist[-1] < phist[0]
    _close(phist, jhist)


def test_resume_pytree_from_jax_checkpoint(problem, jax_pytree, tmp_path):
    """3 JAX pytree steps → checkpoint (3n + 1 leaves: the n coefficient
    leaves, count, the n mu, the n nu; dict keys sorted) → 3 port steps ==
    6 JAX steps; the port's own checkpoint has the same layout."""
    _, _, grid, op, y, _ = problem
    (jc6, _, jh6), ck = jax_pytree
    leaves, it = load_checkpoint(ck)
    assert it == 3 and len(leaves) == 7
    # "scale" sorts before "vol"
    assert [np.shape(x) for x in leaves] == [
        (), (6, 6, 6), (), (), (6, 6, 6), (), (6, 6, 6)]
    assert leaves[2].dtype == np.int32 and int(leaves[2]) == 3
    mine = str(tmp_path / "mine.npz")
    pc, _, ph = gd(op, y.copy(), _PortScaled(grid), coeffs=_port_init(),
                   num_iterations=6, lr=0.05, progress_bar=False,
                   checkpoint_path=ck, resume=True)
    for k in pc:
        _close(pc[k].numpy(), jc6[k])
    (jhist,), (phist,) = jh6.values(), ph.values()
    assert len(phist) == 3
    _close(phist, jhist[3:])
    gd(op, y.copy(), _PortScaled(grid), coeffs=_port_init(),
       num_iterations=3, lr=0.05, progress_bar=False, checkpoint_path=mine,
       checkpoint_every=3)
    mine_leaves, it = load_checkpoint(mine)
    assert it == 3
    for a, b in zip(mine_leaves, leaves):
        assert a.dtype == b.dtype
        _close(a, b)


def test_interop_pytree_leaves():
    """``[*coeffs, count, *mu, *nu]`` ↔ lists of tensors and Adam states;
    a leaf count that is not 3n + 1 is refused."""
    r = np.random.default_rng(3)
    shapes = [(2, 3), ()]
    leaves = ([r.random(s) for s in shapes] + [np.asarray(4, np.int32)]
              + [r.random(s) for s in shapes] + [r.random(s) for s in shapes])
    cs, sts = adam_state_from_jax(leaves, device="cpu")
    assert [tuple(c.shape) for c in cs] == shapes
    assert all(float(s["step"]) == 4 for s in sts)
    for a, b in zip(leaves, adam_state_to_jax(cs, sts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="3n"):
        adam_state_from_jax(leaves[:-1])
