"""Loss functions for tomographic retrieval.

Port of ``sph_raytracer_tpu/loss.py`` (reference loss.py:1-161): a ``Loss``
base with ``projection_mask`` / ``volume_mask`` / weight ``lam`` /
``kind ∈ {fidelity, regularizer, oracle}``, scalar weighting via
``5 * MyLoss()`` (which returns a new Loss), and ``use_grad=False`` losses
logged but detached from the gradient.  Masks may be scalars, arrays or
tensors; arrays move to the data's device and dtype.
"""
from __future__ import annotations

import copy

import torch

__all__ = [
    "Loss",
    "SquareLoss",
    "SquareRelLoss",
    "AbsLoss",
    "CheaterLoss",
    "NegRegularizer",
    "NegSumRegularizer",
    "TVRegularizer",
    "PoissonLoss",
]


def _like(x, ref):
    """``x`` (scalar, array or tensor) as a tensor on ``ref``'s device and
    dtype; Python scalars pass through."""
    if isinstance(x, (int, float)):
        return x
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


class Loss:
    """Loss function for tomographic retrieval.

    Args:
        projection_mask: multiplicative mask over column densities.
        volume_mask: multiplicative mask over voxels.
        lam: loss weight (also settable as ``lam * MyLoss()``).
        use_grad: whether this loss contributes to the optimization
            gradient; when False its value is logged but detached.

    Usage::

        gd(..., loss_fns=[5 * SquareLoss(), 0.1 * NegRegularizer()])
    """

    kind = "regularizer"

    def __init__(self, *args, projection_mask=1, volume_mask=1, lam=1,
                 use_grad=True, **kwargs):
        self.projection_mask = projection_mask
        self.volume_mask = volume_mask
        self.lam = lam
        self.use_grad = use_grad

    def compute(self, f, y, d, c):
        """Raw scalar loss of forward operator ``f``, measurements ``y``,
        density ``d`` and model coefficients ``c``."""
        raise NotImplementedError

    def __call__(self, f, y, d, c):
        result = self.compute(f, y, d, c)
        if result is None:
            return None
        if not self.use_grad:
            result = result.detach()
        return self.lam * result

    def __mul__(self, other):
        new = copy.copy(self)
        new.lam = self.lam * other
        return new

    def __rmul__(self, other):
        return self.__mul__(other)

    def __repr__(self):
        return f"{self.lam:.0e} * {type(self).__name__}"


class SquareLoss(Loss):
    """Mean L2 loss on projections (reference loss.py:87-95)."""

    kind = "fidelity"

    def compute(self, f, y, d, c):
        obs = f(d * _like(self.volume_mask, d))
        return torch.mean(_like(self.projection_mask, obs) * (y - obs) ** 2)


class SquareRelLoss(Loss):
    """Mean squared relative error, zero-measurement pixels masked out
    (reference loss.py:98-114)."""

    kind = "fidelity"

    def compute(self, f, y, d, c):
        obs = f(d * _like(self.volume_mask, d))
        nonzero = y != 0
        rel_err = torch.where(
            nonzero, (y - obs) / torch.where(nonzero, y, 1.0), 0.0)
        return torch.mean((_like(self.projection_mask, obs) * rel_err) ** 2)


class AbsLoss(Loss):
    """Mean L1 loss on projections (reference loss.py:117-124)."""

    kind = "fidelity"

    def compute(self, f, y, d, c):
        obs = f(d * _like(self.volume_mask, d))
        return torch.mean(_like(self.projection_mask, obs)
                          * torch.abs(y - obs))


class CheaterLoss(Loss):
    """Oracle L2 loss against a known ground-truth density (reference
    loss.py:128-147); ``kind='oracle'`` keeps it out of the objective."""

    kind = "oracle"

    def __init__(self, density_truth, *args, **kwargs):
        self.density_truth = density_truth
        super().__init__(**kwargs)

    def compute(self, f, y, d, c):
        return torch.mean(_like(self.volume_mask, d)
                          * (d - _like(self.density_truth, d)) ** 2)


class NegRegularizer(Loss):
    """Mean magnitude of negative voxels (reference loss.py:150-156)."""

    def compute(self, f, y, d, c):
        return torch.mean(torch.abs(_like(self.volume_mask, d)
                                    * torch.clamp(d, max=0)))


class NegSumRegularizer(Loss):
    """Sum magnitude of negative voxels (reference loss.py:158-161)."""

    def compute(self, f, y, d, c):
        return torch.sum(torch.abs(_like(self.volume_mask, d)
                                   * torch.clamp(d, max=0)))


class TVRegularizer(Loss):
    """Anisotropic total-variation regularizer over the voxel axes, with a
    periodic wrap on the azimuth axis."""

    def __init__(self, *args, periodic_azimuth=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.periodic_azimuth = periodic_azimuth

    def compute(self, f, y, d, c):
        d = d * _like(self.volume_mask, d)
        tv = (torch.mean(torch.abs(torch.diff(d, dim=-3)))
              + torch.mean(torch.abs(torch.diff(d, dim=-2))))
        if self.periodic_azimuth:
            tv = tv + torch.mean(torch.abs(d - torch.roll(d, 1, dims=-1)))
        else:
            tv = tv + torch.mean(torch.abs(torch.diff(d, dim=-1)))
        return tv


class PoissonLoss(Loss):
    """Poisson negative log-likelihood on projections:
    mean(rate - y·log(rate)) with the predicted rate floored at ``eps``;
    ``scale`` converts line integrals to expected counts."""

    kind = "fidelity"

    def __init__(self, *args, scale=1.0, eps=1e-12, **kwargs):
        super().__init__(*args, **kwargs)
        self.scale = scale
        self.eps = eps

    def compute(self, f, y, d, c):
        rate = torch.clamp(self.scale * f(d * _like(self.volume_mask, d)),
                           min=self.eps)
        nll = rate - y * torch.log(rate)
        return torch.mean(_like(self.projection_mask, nll) * nll)
