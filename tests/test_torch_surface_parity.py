"""The port's public surface held against the JAX package's.

One case a JAX module (``test_surface_matches_jax``): every name of the
module's ``__all__`` is in the port's counterpart; for a function or a
class every JAX parameter is in the port's signature, of the same kind and,
where it is positional, at the same index, and the port's own parameters
come after them or are keyword-only; every public attribute of a JAX class
is on the port's class, or on a tiny instance of it where the port sets it
in ``__init__``.  ``LANE_LAYOUT`` lists what the port leaves out on
purpose, each with its reason.  A name the port lacks shows up here.

Then the behaviour behind calls that the JAX package takes: the ``utils``
names, the phantom models' ``None`` coefficients, JAX-style dtypes, the
``Operator``'s positional parameters, and the ops-level names given over
the port's own code (``fused_pallas_project``, ``precompute_table``'s
``method`` / ``platform``, ``GridSpec.ftype_name``).  This file compiles
no JAX program: it imports, inspects and compares with numpy.
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.config import TraceConfig, as_torch_dtype
from sph_raytracer_tpu_torch.ops import fused_project as fp
from sph_raytracer_tpu_torch.ops.project import precompute_table
from sph_raytracer_tpu_torch.ops.trace import GridSpec
from sph_raytracer_tpu_torch.parallel import ShardedOperator
from sph_raytracer_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)

# (JAX module, port module): "" is the package root
MODULES = [(m, m) for m in (
    "", "config", "grid", "viewgeom", "operator", "loss", "models",
    "models.base", "models.sphharm", "retrieval", "solve", "plotting",
    "tune", "utils", "utils.checkpoint", "utils.debug", "utils.export",
    "utils.profiling", "parallel", "parallel.mesh", "parallel.sharded",
    "parallel.vol_sharded", "ops.intersect", "ops.trace", "ops.project",
    "ops.routed_project")] + [("ops.fused_pallas", "ops.fused_project")]

# (JAX module, name) -> why the port has no counterpart: each exists only
# for the TPU's 128-lane table layout, which the port's CSR tables replace
LANE_LAYOUT = {
    ("ops.routed_project", "DeviceTables"):
        "the 128-lane int8 route tables of the window kernels; the port's "
        "WindowTables is a chunk table of 8 B a crossing",
    ("ops.routed_project", "device_tables"):
        "packs ops/route.py's RoutedTables into DeviceTables (lane layout)",
    ("ops.routed_project", "routed_project"):
        "takes d2 (H, 128), DeviceTables and RoutedMeta (lane layout); the "
        "port's routed_project(d, tables, bwd, fwd) takes a flat density "
        "and its CSR tables",
    ("ops.routed_project", "routed_project_ref"):
        "the plain version over DeviceTables (lane layout); the port's "
        "plain versions are routed_*_ref over its CSR tables",
    ("ops.routed_project", "routed_backproject_ref"):
        "the plain adjoint over DeviceTables (lane layout)",
    ("parallel.vol_sharded", "shard_banded_tables_vol"):
        "splits band-packed superchunk tables by 8-row density windows; "
        "each port rank builds CSR tables of its voxel range itself",
}

_TINY = dict(grid=lambda: prt.SphericalGrid(shape=(2, 3, 4)),
             geom=lambda: prt.ConeRectGeom((2, 2), (3, 0.5, 0.2)))


def _tiny_instance(cls):
    """A tiny CPU instance of a port class whose attributes its
    ``__init__`` sets (``Operator.device``: a property in the JAX
    package)."""
    grid, geom = _TINY["grid"](), _TINY["geom"]()
    if issubclass(cls, ShardedOperator):
        return cls(grid, geom, mesh=Mesh(None, 0, 1, torch.device("cpu")),
                   mode="precomputed")
    if issubclass(cls, prt.Operator):
        return cls(grid, geom, mode="precomputed", device="cpu")
    return None


def _module(pkg, name):
    return importlib.import_module(pkg + ("." + name if name else ""))


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and getattr(v, "__module__", None) == mod.__name__]
    return list(names)


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters.values())
    except (TypeError, ValueError):
        return None


_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
_POS = (inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _signature_faults(where, jax_obj, port_obj):
    jp, pp = _params(jax_obj), _params(port_obj)
    if jp is None:
        return []
    if pp is None:
        return [f"{where}: the port's has no signature"]
    faults = []
    pnames = [p.name for p in pp]
    pkinds = {p.kind for p in pp}
    for i, p in enumerate(jp):
        if p.kind in _VAR:
            if p.kind not in pkinds:
                faults.append(f"{where}: no {p.kind.description} parameter")
            continue
        if p.name.startswith("_"):
            continue
        if p.name not in pnames:
            faults.append(f"{where}: lacks parameter {p.name!r}")
            continue
        q = pp[pnames.index(p.name)]
        if q.kind != p.kind:
            faults.append(f"{where}: {p.name!r} is {q.kind.description}, "
                          f"not {p.kind.description}")
        elif p.kind in _POS and pnames.index(p.name) != i:
            faults.append(f"{where}: {p.name!r} at index "
                          f"{pnames.index(p.name)}, not {i}")
    jnames = {p.name for p in jp}
    last = max((i for i, q in enumerate(pp) if q.name in jnames
                and q.kind not in _VAR), default=-1)
    for i, q in enumerate(pp[:last]):
        if q.name not in jnames and q.kind in _POS:
            faults.append(f"{where}: the port's {q.name!r} comes before "
                          "JAX parameters and is not keyword-only")
    return faults


def _attribute_faults(where, jax_cls, port_cls):
    missing = [a for a in dir(jax_cls)
               if not a.startswith("_") and not hasattr(port_cls, a)]
    if missing:
        inst = _tiny_instance(port_cls)
        missing = [a for a in missing
                   if inst is None or not hasattr(inst, a)]
    return [f"{where}: lacks attribute {a!r}" for a in missing]


@pytest.mark.parametrize("jax_mod,port_mod", MODULES,
                         ids=[j or "root" for j, _ in MODULES])
def test_surface_matches_jax(jax_mod, port_mod):
    J, P = _module("sph_raytracer_tpu", jax_mod), _module(
        "sph_raytracer_tpu_torch", port_mod)
    faults = []
    for name in _public(J):
        if (jax_mod, name) in LANE_LAYOUT:
            continue
        where = f"{jax_mod or 'root'}.{name}"
        if not hasattr(P, name):
            faults.append(f"{where}: missing")
            continue
        jo, po = getattr(J, name), getattr(P, name)
        if inspect.ismodule(jo):
            assert inspect.ismodule(po), where
            continue
        if callable(jo):
            faults += _signature_faults(where, jo, po)
        if inspect.isclass(jo):
            faults += _attribute_faults(where, jo, po)
    assert not faults, "\n".join(faults)


def test_lane_layout_names_are_jax_names():
    """Every allowlisted name is a public name of its JAX module and has
    its reason, so a renamed JAX name cannot leave a stale entry; the
    lane-layout builders among them are absent from the port."""
    for (mod, name), why in LANE_LAYOUT.items():
        assert name in _public(_module("sph_raytracer_tpu", mod)), name
        assert why
    assert not hasattr(prt.ops.routed_project, "device_tables")
    assert not hasattr(prt.parallel.vol_sharded, "shard_banded_tables_vol")


# ---------------------------------------------------------------------------
# utils: the JAX package's names
# ---------------------------------------------------------------------------

def test_utils_exports_the_jax_names():
    from sph_raytracer_tpu_torch.utils import (debug_trace,
                                               export_operator,
                                               format_trace, load_exported)
    assert export_operator is prt.utils.export.export_operator
    assert load_exported is prt.utils.export.load_exported
    assert debug_trace is prt.utils.debug.debug_trace
    assert format_trace is prt.utils.debug.format_trace
    assert set(srt.utils.__all__) <= set(prt.utils.__all__)
    for sub in ("debug", "export", "profiling"):
        assert inspect.ismodule(getattr(prt.utils, sub))


# ---------------------------------------------------------------------------
# the phantom models: None coefficients, device=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [("CubesModel", (12, 10, 10)),
                                        ("AxisAlignmentModel", (9, 8, 8))])
def test_phantom_models_take_none(name, shape):
    """``m(None)`` is the JAX model's phantom (tests/test_models.py's
    grids; rtol 0), float32 on the model's device; a tensor keeps giving
    its own dtype and device; no card and no ``device`` raises."""
    want = np.asarray(getattr(srt.models, name)(
        srt.SphericalGrid(shape=shape))(None))
    grid = prt.SphericalGrid(shape=shape)
    m = getattr(prt.models, name)(grid, device="cpu")
    got = m(None)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert m(torch.zeros((), dtype=torch.float64)).dtype == torch.float64
    assert m.coeffs_shape == ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(prt.models, name)(grid)


# ---------------------------------------------------------------------------
# dtypes as the JAX package takes them
# ---------------------------------------------------------------------------

def test_as_torch_dtype():
    """Torch, numpy and JAX dtypes and their names map to the torch dtype,
    a name read as numpy reads it (``"float"`` is float64, ``"int"``
    int64, as ``jnp.dtype`` gives them with x64 on);
    anything else raises ``TypeError`` naming the value (``None`` too,
    which ``np.dtype`` would read as float64); ``TraceConfig`` and
    ``GridSpec`` store torch dtypes."""
    for given, want in ((torch.float32, torch.float32),
                        (np.float64, torch.float64),
                        (np.dtype("int64"), torch.int64),
                        ("float64", torch.float64), ("int32", torch.int32),
                        ("torch.int64", torch.int64), ("f8", torch.float64),
                        (jnp.float64, torch.float64),
                        (jnp.int32, torch.int32),
                        (jnp.bfloat16, torch.bfloat16),
                        ("bfloat16", torch.bfloat16),
                        ("float", torch.float64), ("int", torch.int64)):
        assert as_torch_dtype(given) is want, given
    for bad in (None, "float99", "Tensor", 3.5, object()):
        with pytest.raises(TypeError, match="not a dtype") as err:
            as_torch_dtype(bad)
        assert repr(bad) in str(err.value)
    assert TraceConfig(ftype=np.float64).ftype is torch.float64
    assert TraceConfig(itype="int64").itype is torch.int64
    assert TraceConfig().replace(ftype=jnp.float64).ftype is torch.float64
    assert GridSpec.from_grid(prt.SphericalGrid(shape=(2, 2, 2)),
                              np.float64).ftype is torch.float64


def _parity_case():
    """A 6×6 detector off the z-axis (tests/test_torch_surface.py)."""
    grid = prt.SphericalGrid(shape=(6, 7, 8))
    geom = prt.ConeRectGeom((6, 6), (3, 0.5, 0.2), fov=(30, 30))
    x = np.random.default_rng(16).random(tuple(grid.shape))
    return grid, geom, x


@pytest.fixture(scope="module")
def f64_image():
    grid, geom, x = _parity_case()
    op = prt.Operator(grid, geom, mode="precomputed", ftype=torch.float64,
                      itype=torch.int64, device="cpu")
    return op(torch.tensor(x))


@pytest.mark.parametrize("ftype,itype", [
    (np.float64, np.int64), ("float64", "int32"), (jnp.float64, np.int64)],
    ids=["numpy", "names", "jax"])
def test_operator_takes_jax_dtypes(f64_image, ftype, itype):
    """The image with numpy / JAX / named dtypes is bitwise the image with
    the torch dtypes; the tables carry the asked index dtype."""
    grid, geom, x = _parity_case()
    op = prt.Operator(grid, geom, mode="precomputed", ftype=ftype,
                      itype=itype, device="cpu")
    assert op.config.ftype is torch.float64
    assert op.lin.dtype is as_torch_dtype(itype)
    assert torch.equal(op(torch.tensor(x)), f64_image)


def test_operator_positional_parameters(f64_image):
    """``Operator``'s positional order is the JAX package's
    (``debug`` at index 10 of the bound call, ``device`` after
    ``debug_los``): the positional call gives the keyword call's image."""
    grid, geom, x = _parity_case()
    op = prt.Operator(grid, geom, None, None, "precomputed", np.float64,
                      "int64", None, None, False, None, "cpu")
    assert op.device == torch.device("cpu") and op.config.mode == \
        "precomputed"
    assert torch.equal(op(torch.tensor(x)), f64_image)


# ---------------------------------------------------------------------------
# ops-level names over the port's own code
# ---------------------------------------------------------------------------

def test_gridspec_ftype_name():
    gs = GridSpec.from_grid(prt.SphericalGrid(shape=(3, 3, 3)),
                            ftype="float64")
    assert gs.ftype_name == "float64" and gs.ftype is torch.float64
    assert GridSpec(gs.r_b, gs.e_b, gs.a_b, gs.full_azimuth).ftype is \
        torch.float32
    assert hash(gs) == hash(GridSpec.from_grid(
        prt.SphericalGrid(shape=(3, 3, 3)), torch.float64))


def test_precompute_table_method_and_platform():
    """``method`` / ``platform`` are accepted; every value gives the same
    tables, bitwise."""
    grid, geom, _ = _parity_case()
    gs = GridSpec.from_grid(grid, torch.float64)
    base = precompute_table(gs, geom.ray_starts, geom.rays, device="cpu")
    for method, platform in (("ranked", ""), ("sorted", "tpu")):
        got = precompute_table(gs, geom.ray_starts, geom.rays, 8192,
                               np.int32, method, platform, device="cpu")
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
        assert got[2:] == base[2:]


def test_fused_pallas_project():
    """The JAX entry's name and signature over ``prep_rays`` and
    ``fused_project``: the image and its gradient are the fused
    operator's with ``fused_bwd='retrace'`` on the same rays."""
    grid, geom, x = _parity_case()
    op = prt.Operator(grid, geom, mode="fused", device="cpu",
                      config=TraceConfig(fused_bwd="retrace"))
    d = torch.tensor(x, dtype=torch.float32)
    dl = d.clone().requires_grad_(True)
    want = op(dl)
    torch.sum(want ** 2).backward()
    df = d.reshape(-1).clone().requires_grad_(True)
    got = fp.fused_pallas_project(op.gs, df, geom.ray_starts, geom.rays,
                                  "int32", False)
    assert got.shape == tuple(geom.shape)
    torch.sum(got ** 2).backward()
    assert torch.equal(got.detach(), want.detach())
    assert torch.equal(df.grad, dl.grad.reshape(-1))
