"""Port ``solve`` (``cg``, ``sart_preconditioner``, ``mlem`` / OS-EM) vs the
JAX package.

The counterparts of tests/test_solve.py: the same inputs, made with numpy
from a seed, go through both packages at float64 with
``mode='precomputed'`` (no Pallas call); the port runs on the CPU.  Each
JAX call runs its iterations in one chunk, so it compiles once.  CG is
compared over few iterations: past ~15 on this underdetermined system the
two packages' last-bit differences (summation order) grow by orders of
magnitude an iteration, as any two CG implementations' do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu.solve as jsolve
import sph_raytracer_tpu_torch as prt
import sph_raytracer_tpu_torch.solve as psolve
from sph_raytracer_tpu.models import Model as JaxModel
from sph_raytracer_tpu.models import SphHarmModel as JaxSphHarm
from sph_raytracer_tpu_torch.models import Model, SphHarmModel
from sph_raytracer_tpu_torch.ops import routed_project as rp

torch.set_num_threads(2)


def _orbit(pkg, n):
    return sum(
        pkg.ConeRectGeom((6, 6), pos=(2 * np.cos(t), 2 * np.sin(t), 0.4),
                         fov=(50, 50))
        for t in np.linspace(0, 2 * np.pi, n, endpoint=False))


@pytest.fixture(scope="module")
def small():
    """tests/test_solve.py's ``small`` with 6 views of 6×6 for its 5 of
    5×5: a (4, 4, 4) grid and views at z = 0.4, in both packages, and the
    JAX image of a seeded volume.  6 views make OS-EM's 3 subsets one
    shape (one JAX trace compile).  With 5×5 the odd column aimed at the origin
    crosses the z-axis (ROADMAP C, "not faults"): there the JAX trace keeps
    a 4.4e-16 crossing that the port's drops, and MLEM's ``s > 0`` turns
    that into a voxel kept in one package and zeroed in the other."""
    grid = prt.SphericalGrid(shape=(4, 4, 4))
    jgrid = srt.SphericalGrid(shape=(4, 4, 4))
    op = prt.Operator(grid, _orbit(prt, 6), ftype=torch.float64,
                      device="cpu")
    jop = srt.Operator(jgrid, _orbit(srt, 6), ftype=jnp.float64)
    truth = np.random.default_rng(0).random((4, 4, 4))
    y = np.asarray(jop(jnp.asarray(truth)))
    return jgrid, jop, grid, op, y


def _close(a, b, rtol=1e-6, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


class _JaxSplit(JaxModel):
    """A linear model over dict coefficients: the volume's inner and
    outer radial halves."""

    def __init__(self, grid):
        self.grid = grid

    def __call__(self, c):
        return jnp.concatenate([c["inner"], c["outer"]])


class _PortSplit(Model):
    def __init__(self, grid):
        self.grid = grid

    def __call__(self, c):
        return torch.cat([c["inner"], c["outer"]])


def _cg_case(name, jgrid, grid, y):
    """(JAX kwargs, port kwargs, y) of one ``cg`` case; a shared
    ``num_iterations`` is 10 (see the module docstring)."""
    j, p = {"num_iterations": 10}, {"num_iterations": 10}
    if name == "damp":
        j["damp"] = p["damp"] = 1e-3
    elif name == "mask":
        mask = np.zeros(y.shape)
        mask[::2] = 1.0  # keep alternate views only
        j.update(damp=1e-3, projection_mask=mask)
        p.update(damp=1e-3, projection_mask=mask)
    elif name == "sart":
        j["damp"] = p["damp"] = 1e-3
    elif name == "sphharm":
        j.update(model=JaxSphHarm(jgrid, lmax=1, dtype=jnp.float64),
                 damp=1e-9)
        p.update(model=SphHarmModel(grid, lmax=1, dtype=torch.float64,
                                    device="cpu"), damp=1e-9)
    elif name == "pytree":
        j.update(model=_JaxSplit(jgrid), damp=1e-3,
                 x0={k: jnp.zeros((2, 4, 4)) for k in ("outer", "inner")})
        p.update(model=_PortSplit(grid), damp=1e-3,
                 x0={k: torch.zeros((2, 4, 4), dtype=torch.float64)
                     for k in ("outer", "inner")})
    elif name == "tol":
        # the freeze triggers after 5 iterations; the loop runs out the
        # second chunk of 5 frozen, then breaks
        j.update(num_iterations=20, damp=1e-3, tol=2e-2, chunk=5)
        p.update(num_iterations=20, damp=1e-3, tol=2e-2, chunk=5)
    if name != "tol":
        j["chunk"] = j["num_iterations"]
    return j, p


CG_CASES = ["plain", "damp", "mask", "sart", "sphharm", "pytree", "tol"]


@pytest.mark.parametrize("name", CG_CASES)
def test_cg_matches_jax(small, name):
    jgrid, jop, grid, op, y = small
    jkw, pkw = _cg_case(name, jgrid, grid, y)
    if name == "sart":
        jkw["precond"] = jsolve.sart_preconditioner(jop)
        pkw["precond"] = psolve.sart_preconditioner(op)
    jx, jy, ji = jsolve.cg(jop, y, **jkw)
    px, py, pi = psolve.cg(op, y.copy(), **pkw)
    if name == "pytree":
        assert set(px) == {"inner", "outer"}
        for k in px:
            _close(px[k].numpy(), jx[k])
    else:
        assert px.dtype == torch.float64
        _close(px.numpy(), jx)
    _close(py.numpy(), jy)
    assert set(pi) == set(ji) == {"rnorm", "iterations", "bnorm"}
    assert pi["iterations"] == ji["iterations"]
    assert len(pi["rnorm"]) == len(ji["rnorm"])
    _close(pi["rnorm"], ji["rnorm"])
    _close(pi["bnorm"], ji["bnorm"])
    if name == "tol":
        # frozen before the budget; the loop broke at the chunk's end
        assert pi["iterations"] == 5 and len(pi["rnorm"]) == 10


@pytest.mark.parametrize("space", ["volume", "sphharm"])
def test_sart_preconditioner_matches_jax(small, space):
    jgrid, jop, grid, op, y = small
    jm = pm = None
    if space == "sphharm":
        jm = JaxSphHarm(jgrid, lmax=1, dtype=jnp.float64)
        pm = SphHarmModel(grid, lmax=1, dtype=torch.float64, device="cpu")
    d = psolve.sart_preconditioner(op, model=pm)
    assert d.dtype == torch.float64 and bool((d > 0).all())
    _close(d.numpy(), jsolve.sart_preconditioner(jop, model=jm))


MLEM_CASES = {
    "plain": {},
    "scale": {"scale": 7.5},
    "mask": {"projection_mask": "alternate"},
    "osem": {"subsets": 3},
}


@pytest.mark.parametrize("name", sorted(MLEM_CASES))
def test_mlem_matches_jax(small, name):
    """x, the NLL history and the sensitivity; OS-EM at ``subsets=3``
    (sub-operators of 2 views each), whose summed sensitivity is the full
    operator's ``Aᵀ1``."""
    jgrid, jop, grid, op, y = small
    kw = dict(MLEM_CASES[name])
    counts = y * kw.get("scale", 1.0)
    if kw.get("projection_mask") == "alternate":
        mask = np.zeros(y.shape)
        mask[::2] = 1.0
        kw["projection_mask"] = mask
    jx, jy, ji = jsolve.mlem(jop, counts, num_iterations=12, chunk=12, **kw)
    px, py, pi = psolve.mlem(op, counts.copy(), num_iterations=12, **kw)
    _close(px.numpy(), jx)
    _close(py.numpy(), jy)
    assert pi["iterations"] == ji["iterations"] == 12
    _close(pi["nll"], ji["nll"])
    _close(pi["sensitivity"].numpy(), ji["sensitivity"])
    assert bool((px >= 0).all())
    assert bool((px[pi["sensitivity"] <= 0] == 0).all())
    if name == "osem":
        ones = torch.ones(y.shape, dtype=torch.float64)
        _close(pi["sensitivity"].numpy(), op.T(ones).numpy())


def test_osem_refusals(small):
    """OS-EM needs a static operator over a ViewGeomCollection with at
    least ``subsets`` views (ValueError otherwise, as in the JAX package)."""
    jgrid, jop, grid, op, y = small
    single = prt.Operator(grid, prt.ConeRectGeom(
        (6, 6), pos=(2.0, 0, 0.4), fov=(50, 50)), ftype=torch.float64,
        device="cpu")
    with pytest.raises(ValueError, match="ViewGeomCollection"):
        psolve.mlem(single, np.ones((6, 6)), num_iterations=2, subsets=3)
    with pytest.raises(ValueError, match="at least 7 views"):
        psolve.mlem(op, y.copy(), num_iterations=2, subsets=7)
    dgrid = prt.SphericalGrid(shape=(6, 4, 4, 4), size_t=(0, 5))
    dyn = prt.Operator(dgrid, _orbit(prt, 6), ftype=torch.float64,
                       device="cpu")
    with pytest.raises(ValueError, match="4D"):
        psolve.mlem(dyn, np.ones(dyn.geom.shape), num_iterations=2,
                    subsets=3)


def test_cg_routed_f32_matches_precomputed_f64(small):
    """The card's path on the CPU: routed mode's f32 tables, ``op.T``
    through ``routed_bwd_gather``'s plain version, against the port's f64
    precomputed run; and one forward and one adjoint an iteration."""
    _, _, grid, op, y = small
    routed = prt.Operator(grid, _orbit(prt, 6), mode="routed", device="cpu")
    y32 = torch.tensor(y, dtype=torch.float32)
    pre = psolve.sart_preconditioner(routed)
    x64, _, i64 = psolve.cg(op, y.copy(), num_iterations=8, damp=1e-3,
                            precond=psolve.sart_preconditioner(op))
    rp.reset_launches()
    x32, y_out, i32 = psolve.cg(routed, y32, num_iterations=8, damp=1e-3,
                                precond=pre)
    assert x32.dtype == y_out.dtype == torch.float32
    _close(x32.numpy(), x64.numpy(), rtol=1e-4, atol=1e-4 * float(
        x64.abs().max()))
    _close(i32["rnorm"], i64["rnorm"], rtol=1e-4)
    # plain versions on the CPU count no launch
    assert sum(rp.LAUNCHES.values()) == 0


def test_cg_adjoint_calls(small, monkeypatch):
    """``cg`` on a bare operator applies ``f`` and ``f.T`` only: 1 + n + 1
    forwards and 2 + n adjoints for n iterations (the chip smoke test
    holds the kernels' launch counts to this formula)."""
    _, _, grid, op, y = small
    calls = {"fwd": 0, "T": 0}

    class Counted:
        grid, device, config = op.grid, op.device, op.config

        def __call__(self, v):
            calls["fwd"] += 1
            return op(v)

        def T(self, v):
            calls["T"] += 1
            return op.T(v)

    psolve.cg(Counted(), y.copy(), num_iterations=7, chunk=3)
    assert calls == {"fwd": 1 + 7 + 1, "T": 2 + 7}


def test_solvers_without_card_raise(monkeypatch):
    """A bare callable with no ``.device`` and numpy data asks for the
    card, as the operator's entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psolve.cg(lambda v: v, np.ones(3), x0=np.zeros(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psolve.mlem(lambda v: v, np.ones(3), x0=np.ones(3))
