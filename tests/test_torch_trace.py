"""Port vs JAX package: geometry, crossing trace, and the port's guards.

The PyTorch/CUDA port (``sph_raytracer_tpu_torch``) is held against the
JAX package on the same numpy inputs: detector rays must be identical and
the traced (voxel, length) pairs of every ray must agree as multisets at
float64.
"""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu.ops.project import precompute_table as jax_precompute
from sph_raytracer_tpu.ops.trace import GridSpec as JaxGridSpec
from sph_raytracer_tpu_torch.ops.project import precompute_table
from sph_raytracer_tpu_torch.ops.trace import GridSpec

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _orbit(pkg):
    return sum(
        pkg.ConeRectGeom((6, 6), pos=(2 * np.cos(t), 2 * np.sin(t), 0.5),
                         lookdir=(0.35 - 2 * np.cos(t), 0.2 - 2 * np.sin(t),
                                  -0.5), fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 5, endpoint=False))


# (grid, geom) builders taken from tests/test_parity.py, per package
CONFIGS = {
    "conerect": lambda p: (
        p.SphericalGrid(shape=(12, 14, 16), size_r=(0.3, 1.0)),
        p.ConeRectGeom((10, 12), pos=(1.8, 0.4, 0.3), fov=(40, 35))),
    "conecirc_log": lambda p: (
        p.SphericalGrid(shape=(10, 9, 11), size_r=(0.1, 1.0), spacing="log"),
        p.ConeCircGeom((8, 12), pos=(0.459903, 1.833782, -0.412418),
                       fov=(5, 35))),
    "parallel_partial": lambda p: (
        p.SphericalGrid(r_b=np.linspace(0, 1, 9),
                        e_b=np.linspace(0.3, 2.8, 8),
                        a_b=np.linspace(-2.0, 2.5, 10)),
        p.ParallelGeom((9, 7), pos=(2.0, -0.3, 0.2),
                       lookdir=(-2.0, 0.45, -0.1), size=(1.8, 1.6))),
    "collection_orbit": lambda p: (p.SphericalGrid(shape=(8, 8, 8)),
                                   _orbit(p)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rays_match_jax(name):
    (jgrid, jgeom), (pgrid, pgeom) = CONFIGS[name](srt), CONFIGS[name](prt)
    for a, b in ((jgeom.rays, pgeom.rays),
                 (jgeom.ray_starts, pgeom.ray_starts),
                 (jgrid.r_b, pgrid.r_b), (jgrid.e_b, pgrid.e_b),
                 (jgrid.a_b, pgrid.a_b)):
        assert np.asarray(a).shape == np.asarray(b).shape
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=1e-12)
    assert pgrid.full_azimuth == jgrid.full_azimuth


def _multisets(lin, lens):
    """Per ray: the (voxel, length) pairs longer than the 1e-12 length
    tolerance, sorted by (voxel, length).  Shorter segments are left out:
    a knife-edge midpoint tie may label one with either neighbour voxel
    (the JAX package's jitted trace does so differently from its own
    eager run), and it moves no integral by more than the tolerance."""
    out = []
    for li, le in zip(np.asarray(lin), np.asarray(lens)):
        keep = le > 1e-12
        li, le = li[keep], le[keep]
        order = np.lexsort((le, li))
        out.append((li[order], le[order]))
    return out


@pytest.mark.parametrize("name", ["conerect", "parallel_partial",
                                  "collection_orbit"])
def test_trace_matches_jax_multiset(name):
    (jgrid, jgeom), (pgrid, pgeom) = CONFIGS[name](srt), CONFIGS[name](prt)
    shape = np.broadcast_shapes(np.shape(jgeom.ray_starts),
                                np.shape(jgeom.rays))
    starts = np.broadcast_to(jgeom.ray_starts, shape).reshape(-1, 3).copy()
    rays = np.broadcast_to(jgeom.rays, shape).reshape(-1, 3).copy()
    jl, jn, n, _ = jax_precompute(
        JaxGridSpec.from_grid(jgrid, ftype=jnp.float64), starts, rays,
        block=256)
    pl, pn, pn_rays, _ = precompute_table(
        GridSpec.from_grid(pgrid, ftype=torch.float64), starts, rays,
        block=100, device="cpu")
    assert pn_rays == n == len(starts) and pl.shape == (n, jl.shape[1])
    live = 0
    for (a_l, a_n), (b_l, b_n) in zip(_multisets(jl[:n], jn[:n]),
                                      _multisets(pl, pn)):
        np.testing.assert_array_equal(b_l, a_l)
        np.testing.assert_allclose(b_n, a_n, rtol=0, atol=1e-12)
        live += len(a_l)
    assert live > 0


# tests/test_trace.py:146-190's grids: partial, log and full azimuth, and a
# degenerate single-voxel r/a grid
RANKED_GRIDS = {
    "cube8": lambda p: p.SphericalGrid(shape=(8, 8, 8)),
    "log": lambda p: p.SphericalGrid(shape=(6, 7, 8), size_r=(0.1, 2.0),
                                     spacing="log"),
    "partial": lambda p: p.SphericalGrid(r_b=np.linspace(0, 1, 7),
                                         e_b=np.linspace(0.3, 2.8, 7),
                                         a_b=np.linspace(-2.0, 2.5, 9)),
    "single": lambda p: p.SphericalGrid(shape=(1, 2, 1), size_r=(0, 25)),
}


def _rays_into_grid():
    """40 random rays aimed into the unit ball, a quarter of them starting
    inside it (float64)."""
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(40, 3)) * 3
    xs[:10] *= 0.1
    dirs = rng.uniform(-0.8, 0.8, size=(40, 3)) - xs
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return xs, dirs


@pytest.mark.parametrize("name", sorted(RANKED_GRIDS))
def test_ranked_matches_jax_ranked_trace(name):
    """``trace_method='ranked'`` (the port's sorted trace, config
    docstring) holds the (voxel, length) pairs of the JAX package's
    ``trace_crossings_ranked``: the same multiset per ray at float64."""
    xs, dirs = _rays_into_grid()
    jl, jn, n, _ = jax_precompute(
        JaxGridSpec.from_grid(RANKED_GRIDS[name](srt), ftype=jnp.float64),
        xs, dirs, block=64, method="ranked")
    op = prt.Operator(RANKED_GRIDS[name](prt), prt.ViewGeom(xs, dirs),
                      mode="precomputed", ftype=torch.float64, device="cpu",
                      config=prt.TraceConfig(trace_method="ranked"))
    assert n == len(xs) and op.lin.shape == (n, jl.shape[1])
    live = 0
    for (a_l, a_n), (b_l, b_n) in zip(_multisets(jl[:n], jn[:n]),
                                      _multisets(op.lin, op.lens)):
        np.testing.assert_array_equal(b_l, a_l)
        np.testing.assert_allclose(b_n, a_n, rtol=0, atol=1e-12)
        live += len(a_l)
    assert live > 0


def test_ranked_config_runs_sorted_trace():
    """Every ``trace_method`` value builds the same tables, bit for bit."""
    xs, dirs = _rays_into_grid()
    grid = RANKED_GRIDS["partial"](prt)
    ops = [prt.Operator(grid, prt.ViewGeom(xs, dirs), mode="precomputed",
                        ftype=torch.float64, device="cpu",
                        config=prt.TraceConfig(trace_method=m))
           for m in ("ranked", "sorted", "auto")]
    for op in ops[1:]:
        assert torch.equal(op.lin, ops[0].lin)
        assert torch.equal(op.lens, ops[0].lens)


def test_import_loads_no_jax():
    """Importing the port loads no jax and no module of the JAX package."""
    code = (
        "import sys, sph_raytracer_tpu_torch\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib')\n"
        "       or m.startswith(('jax.', 'jaxlib.'))\n"
        "       or (m.split('.')[0] == 'sph_raytracer_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _port_sources():
    root = os.path.join(REPO, "sph_raytracer_tpu_torch")
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    """No port file (nor chip_smoke.py) imports jax, the JAX package or
    the JAX package's ``tools/``."""
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "sph_raytracer_tpu",
                                   "optax", "tools"), (path, name)


def test_operator_without_card_raises(monkeypatch):
    """``Operator(grid, geom)`` with no device asks for the card and raises
    when there is none; it never falls back to the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid, geom = CONFIGS["collection_orbit"](prt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prt.Operator(grid, geom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prt.Operator(grid, geom, device="cuda")
