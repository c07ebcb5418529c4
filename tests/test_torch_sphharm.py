"""Port ``SphHarmModel`` / ``real_sph_harm_basis`` vs the JAX package.

Coefficients and volumes are made with numpy from a seed and handed to
both packages at float64 (the counterparts of tests/test_models.py's
spherical-harmonic tests); the port runs on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_raytracer_tpu as srt
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu.models import SphHarmModel as JaxSphHarm
from sph_raytracer_tpu.models import real_sph_harm_basis as jax_basis
from sph_raytracer_tpu_torch.models import SphHarmModel, real_sph_harm_basis

torch.set_num_threads(2)

GRIDS = {
    "static": dict(shape=(5, 12, 16)),
    "dynamic": dict(shape=(4, 5, 6, 8), size_t=(0, 3)),
}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-12)


def test_basis_matches_jax():
    e = (np.arange(9) + 0.5) * np.pi / 9
    a = -np.pi + (np.arange(14) + 0.5) * 2 * np.pi / 14
    got, want = real_sph_harm_basis(4, e, a), jax_basis(4, e, a)
    assert got.shape == want.shape == (25, 9, 14)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_model_matches_jax(name):
    """Forward, ``coeffs_shape`` (a leading time axis on a dynamic grid),
    the basis on the model's device and ``fit``'s round trip."""
    kw = GRIDS[name]
    jm = JaxSphHarm(srt.SphericalGrid(**kw), lmax=3, dtype=jnp.float64)
    pm = SphHarmModel(prt.SphericalGrid(**kw), lmax=3, dtype=torch.float64,
                      device="cpu")
    assert pm.coeffs_shape == jm.coeffs_shape
    assert pm._Y.shape == jm._Y.shape and pm._Y.device.type == "cpu"
    c0 = np.random.default_rng(0).standard_normal(pm.coeffs_shape)
    vol = pm(torch.tensor(c0))
    assert vol.dtype == torch.float64
    assert tuple(vol.shape) == tuple(pm.grid.shape)
    _close(vol.numpy(), jm(jnp.asarray(c0)))
    c1 = pm.fit(vol)
    assert isinstance(c1, torch.Tensor) and c1.dtype == torch.float64
    np.testing.assert_allclose(c1.numpy(), c0, rtol=0, atol=1e-8)
    _close(c1.numpy(), jm.fit(np.asarray(vol)))
    assert repr(pm) == repr(jm)


def test_model_float32_and_gradient():
    """The float32 default: an f32 volume, and autograd reaches the
    coefficients (the path ``gd`` and ``cg`` take)."""
    grid = prt.SphericalGrid(shape=(6, 8, 10))
    m = SphHarmModel(grid, lmax=0, device="cpu")
    assert m.coeffs_shape == (1, 6) and m._Y.dtype == torch.float32
    c = torch.ones(m.coeffs_shape, requires_grad=True)
    vol = m(c)
    assert vol.dtype == torch.float32
    np.testing.assert_allclose(vol.detach().numpy(), 1 / np.sqrt(4 * np.pi),
                               atol=1e-6)
    vol.sum().backward()
    np.testing.assert_allclose(c.grad.numpy(),
                               8 * 10 / np.sqrt(4 * np.pi), rtol=1e-5)


def test_model_without_card_raises(monkeypatch):
    """``SphHarmModel(grid)`` asks for the card, as ``Operator`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SphHarmModel(prt.SphericalGrid(shape=(4, 4, 4)))
