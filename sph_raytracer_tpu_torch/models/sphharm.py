"""Spherical-harmonic volume model (port of
``sph_raytracer_tpu/models/sphharm.py``).

The volume is a low-order angular expansion with free radial profiles,

    v[r, e, a] = sum_k  c[k, r] * Y_k(e, a),       k = (l, m), l <= lmax

which bandlimits the angular structure of a retrieval and shrinks its
unknowns from Nr*Ne*Na voxels to K*Nr (50^3 -> 25*50 at lmax=4).
Evaluating it is one dense (K x Nr) by (K x Ne*Na) matrix product, which
PyTorch computes on the model's device; the real orthonormal basis is
built on the host in numpy (associated-Legendre recursion, the same code
as the JAX package's) at construction.
"""
from __future__ import annotations

from math import factorial

import numpy as np
import torch

from ..config import as_torch_dtype
from ..operator import resolve_device
from .base import Model

__all__ = ["SphHarmModel", "real_sph_harm_basis"]


def _assoc_legendre(lmax: int, x: np.ndarray) -> np.ndarray:
    """All associated Legendre P_l^m(x) for 0 <= m <= l <= lmax.

    Returns (lmax+1, lmax+1, *x.shape) with [l, m] slots (m > l zero).
    No Condon-Shortley phase (it cancels in a real fitting basis).
    Standard stable recursions:
      P_m^m     = (2m-1)!! (1-x^2)^{m/2}
      P_{m+1}^m = (2m+1) x P_m^m
      P_l^m     = ((2l-1) x P_{l-1}^m - (l+m-1) P_{l-2}^m) / (l-m)
    """
    x = np.asarray(x, np.float64)
    P = np.zeros((lmax + 1, lmax + 1) + x.shape)
    s = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    pmm = np.ones_like(x)
    for m in range(lmax + 1):
        P[m, m] = pmm
        if m + 1 <= lmax:
            P[m + 1, m] = (2 * m + 1) * x * pmm
        for l in range(m + 2, lmax + 1):
            P[l, m] = ((2 * l - 1) * x * P[l - 1, m]
                       - (l + m - 1) * P[l - 2, m]) / (l - m)
        pmm = pmm * s * (2 * m + 1)
    return P


def real_sph_harm_basis(lmax: int, e: np.ndarray, a: np.ndarray
                        ) -> np.ndarray:
    """Real orthonormal spherical harmonics on an (elevation, azimuth) grid.

    Args:
        lmax: maximum degree; K = (lmax+1)^2 basis functions.
        e: elevation angles from +Z in [0, pi], shape (Ne,).
        a: azimuth angles in [-pi, pi), shape (Na,).

    Returns (K, Ne, Na) float64, ordered (l, m) = (0,0), (1,-1), (1,0),
    (1,1), (2,-2), ...  Orthonormal under the sphere measure
    sin(e) de da: integral(Y_i * Y_j) = delta_ij.
    """
    e = np.asarray(e, np.float64).reshape(-1)
    a = np.asarray(a, np.float64).reshape(-1)
    P = _assoc_legendre(lmax, np.cos(e))  # (L+1, L+1, Ne)
    K = (lmax + 1) ** 2
    Y = np.zeros((K, e.size, a.size))
    k = 0
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            N = np.sqrt((2 * l + 1) / (4 * np.pi)
                        * factorial(l - am) / factorial(l + am))
            pl = N * P[l, am][:, None]  # (Ne, 1)
            if m == 0:
                Y[k] = pl
            elif m > 0:
                Y[k] = np.sqrt(2.0) * pl * np.cos(m * a)[None, :]
            else:
                Y[k] = np.sqrt(2.0) * pl * np.sin(am * a)[None, :]
            k += 1
    return Y


class SphHarmModel(Model):
    """Bandlimited-angle volume model: ``coeffs[k, r]`` weight the real
    spherical harmonic ``Y_k`` on the grid's angular bin centers, with a
    free radial profile per harmonic.

    For dynamic (4D) grids coefficients grow a leading time axis:
    ``coeffs_shape == (T, K, Nr)``.  The basis ``_Y`` is a ``(K, Ne·Na)``
    tensor of ``dtype`` on ``device`` (``None`` means ``"cuda"``).
    """

    def __init__(self, grid, lmax: int = 4, dtype=torch.float32,
                 device=None):
        self.grid = grid
        self.lmax = int(lmax)
        self.device = resolve_device(device)
        Y = real_sph_harm_basis(self.lmax, np.asarray(grid.e),
                                np.asarray(grid.a))
        self._Y = torch.as_tensor(Y.reshape(Y.shape[0], -1),
                                  dtype=as_torch_dtype(dtype),
                                  device=self.device)

    def __call__(self, coeffs):
        coeffs = torch.as_tensor(coeffs, device=self.device)
        dt = torch.promote_types(coeffs.dtype, self._Y.dtype)
        vol = torch.einsum("...kr,kp->...rp", coeffs.to(dt),
                           self._Y.to(dt))
        return vol.reshape(tuple(self.grid.shape))

    @property
    def coeffs_shape(self):
        shape = tuple(self.grid.shape)
        K = (self.lmax + 1) ** 2
        return shape[:-3] + (K, shape[-3])

    def fit(self, volume):
        """Least-squares projection of a voxel volume onto the model
        (host-side numpy; useful for initializing retrievals).  Returns a
        tensor of the basis' dtype on the model's device."""
        if isinstance(volume, torch.Tensor):
            volume = volume.detach().cpu().numpy()
        shape = tuple(self.grid.shape)
        nr = shape[-3]
        # (..., Nr, P) -> (P, ...*Nr): one batched lstsq against Y^T
        v = np.asarray(volume, np.float64).reshape(-1, nr,
                                                   shape[-2] * shape[-1])
        Y = self._Y.detach().cpu().double().numpy()  # (K, P)
        sol = np.linalg.lstsq(Y.T, v.reshape(-1, v.shape[-1]).T,
                              rcond=None)[0]  # (K, batch*Nr)
        K = sol.shape[0]
        c = np.moveaxis(sol.reshape(K, -1, nr), 0, 1)  # (batch, K, Nr)
        return torch.as_tensor(c.reshape(self.coeffs_shape),
                               dtype=self._Y.dtype, device=self.device)

    def __repr__(self):
        return (f"SphHarmModel(grid={tuple(self.grid.shape)}, "
                f"lmax={self.lmax})")
