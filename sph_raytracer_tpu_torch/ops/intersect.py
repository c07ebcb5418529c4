"""Ray / spherical-boundary intersection math (PyTorch, branchless).

Port of ``sph_raytracer_tpu/ops/intersect.py``.  The formulas are kept
exactly — including the numerically stable forms (|xs × ray|² for the
closest-approach distance, the factor-2 discriminant snap) that the
reference goldens' 1e-6 margin depends on — with ``torch.where`` selects
in place of ``jnp.where``.  Region-index conventions (reference
geometry.py:77-104):

  * ``regions[i]`` is the voxel index *entered* at crossing i.
  * -1 (``OUTSIDE``) = outside the grid.
  * -2 (``INVALID``) = glancing hit / "no change on this axis".

All functions take ``xs``/``rays`` tensors with matching (broadcastable)
leading ray dimensions and compute on their device.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "isclose",
    "sphere_crossings",
    "cone_crossings",
    "plane_crossings",
    "find_starts",
    "cart2sph",
    "sph2cart",
]

INVALID = -2
OUTSIDE = -1


def isclose(a, b, factor: int = 3):
    """Dtype-scaled closeness test |a-b| < resolution(dtype)**(1/factor)
    (reference ``isclose``, raytracer.py:233-246)."""
    tol = float(torch.finfo(a.dtype).resolution) ** (1.0 / factor)
    return torch.abs(a - b) < tol


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _prep(xs, rays, bounds, ftype):
    ftype = ftype or torch.as_tensor(xs).dtype
    if not ftype.is_floating_point:
        ftype = torch.float32
    xs = torch.as_tensor(xs, dtype=ftype)
    rays = torch.as_tensor(rays, dtype=ftype, device=xs.device)
    shape = torch.broadcast_shapes(xs.shape, rays.shape)
    xs = xs.expand(shape)
    rays = rays.expand(shape)
    rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
    bounds = torch.as_tensor(bounds, dtype=ftype, device=xs.device)
    return xs, rays, bounds, ftype


def sphere_crossings(r_b, xs, rays, itype=torch.int32, ftype=None):
    """Ray crossings with concentric spheres of radii ``r_b``.

    Returns ``(t, regions, inds, neg)``: t (*rays, 2B) distances (near hits
    then far hits; misses are +inf), the voxel region entered at each
    crossing, the boundary index of each crossing and the inward flag.
    """
    xs, rays, r_b, ftype = _prep(xs, rays, r_b, ftype)
    B = r_b.shape[0]

    tc = -_dot(xs, rays)
    # stable |closest-approach|²: |xs × ray|² has no cancellation
    d2 = torch.sum(torch.linalg.cross(xs, rays, dim=-1) ** 2, dim=-1)

    t1c = torch.sqrt(r_b ** 2 - d2[..., None])  # NaN where missed
    t = torch.cat([tc[..., None] - t1c, tc[..., None] + t1c], dim=-1)

    ind = torch.arange(B, dtype=itype, device=t.device)
    neg_near = (t1c > 0).to(itype)
    neg = torch.cat([neg_near, torch.zeros_like(neg_near)], dim=-1)
    inds = torch.cat([ind, ind]).expand(t.shape).to(itype)
    regions = inds - neg

    regions = torch.where(regions == B - 1, OUTSIDE, regions)
    t = torch.where(torch.isnan(t), math.inf, t)
    return t, regions, inds, neg


def cone_crossings(e_b, xs, rays, itype=torch.int32, ftype=None):
    """Ray crossings with coaxial cones of half-angle ``e_b`` from +Z
    (two-root, single-root and on-cone cases, glancing hits and
    shadow-cone filtering with the e=π/2 exemption, reference
    raytracer.py:328-468)."""
    xs, rays, e_b, ftype = _prep(xs, rays, e_b, ftype)
    B = e_b.shape[0]
    zero = torch.zeros((), dtype=ftype, device=xs.device)

    cos2 = torch.cos(e_b) ** 2
    rz = rays[..., 2:3]
    xz = xs[..., 2:3]
    rx = _dot(rays, xs)[..., None]
    xx = _dot(xs, xs)[..., None]

    aa = rz ** 2 - cos2
    bb = 2 * (rz * xz - rx * cos2)
    cc = xz ** 2 - xx * cos2
    aa = torch.where(isclose(aa, zero), 0.0, aa)

    # tighter snap than the reference (factor 2): see the JAX module
    delta = bb ** 2 - 4 * aa * cc
    delta = torch.where(isclose(delta, zero, factor=2), 0.0, delta)
    sq = torch.sqrt(delta)

    t1 = (-bb + sq) / (2 * aa)
    t2 = (-bb - sq) / (2 * aa)

    is_single = isclose(aa, zero) & ~isclose(bb, zero)
    th_near = torch.where(is_single, -cc / bb, t1)
    th_far = torch.where(is_single, math.inf, t2)

    on_cone = (aa == 0) & (bb == 0) & (cc == 0)
    th_near = torch.where(on_cone, math.inf, th_near)
    th_far = torch.where(on_cone, math.inf, th_far)

    t = torch.cat([th_near, th_far], dim=-1)

    px = xs[..., 0:1] + t * rays[..., 0:1]
    py = xs[..., 1:2] + t * rays[..., 1:2]
    pz = xz + t * rz
    prod = (-pz * (rays[..., 0:1] * px + rays[..., 1:2] * py)
            + rz * (px ** 2 + py ** 2))

    neg = (prod > 0).to(itype)
    ind = torch.arange(B, dtype=itype, device=t.device)
    inds = torch.cat([ind, ind]).expand(t.shape).to(itype)
    regions = inds - neg
    regions = torch.where(isclose(prod, zero), INVALID, regions)

    e2 = torch.cat([e_b, e_b])
    cone_up = torch.cos(e2) >= 0
    shadow = (pz >= 0) != cone_up
    half_pi = torch.tensor(math.pi / 2, dtype=ftype, device=xs.device)
    shadow = shadow & ~isclose(e2, half_pi)
    t = torch.where(shadow, math.inf, t)

    regions = torch.where(regions == B - 1, OUTSIDE, regions)
    t = torch.where(torch.isnan(t), math.inf, t)
    return t, regions, inds, neg


def plane_crossings(a_b, xs, rays, full_azimuth: bool = False,
                    itype=torch.int32, ftype=None):
    """Ray crossings with azimuth half-planes at angles ``a_b``; region
    indices wrap periodically when ``full_azimuth`` (reference
    raytracer.py:471-552)."""
    xs, rays, a_b, ftype = _prep(xs, rays, a_b, ftype)
    B = a_b.shape[0]

    sin_a = torch.sin(a_b)
    cos_a = torch.cos(a_b)

    nx = -sin_a * xs[..., 0:1] + cos_a * xs[..., 1:2]
    nr = -sin_a * rays[..., 0:1] + cos_a * rays[..., 1:2]
    t = -nx / nr

    cross_z = cos_a * rays[..., 1:2] - sin_a * rays[..., 0:1]
    is_parallel = torch.abs(cross_z) <= float(torch.finfo(ftype).resolution)
    t = torch.where(is_parallel, math.inf, t)

    neg = (cross_z < 0).to(itype)
    inds = torch.arange(B, dtype=itype, device=t.device).expand(t.shape)
    regions = inds - neg

    if full_azimuth:
        # jnp.mod semantics (sign of the divisor) = torch.remainder
        regions = torch.remainder(regions, B - 1)
    else:
        regions = torch.where(regions == B - 1, OUTSIDE, regions)

    px = xs[..., 0:1] + t * rays[..., 0:1]
    py = xs[..., 1:2] + t * rays[..., 1:2]
    shadow = cos_a * px + sin_a * py < 0
    t = torch.where(shadow, math.inf, t)

    t = torch.where(torch.isnan(t), math.inf, t)
    return t, regions, inds, neg


def cart2sph(xyz):
    """Cartesian → spherical (radius, elevation from +Z in [0,π], azimuth
    from +X in [-π,π]) (reference raytracer.py:555-578)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    xy_sq = x ** 2 + y ** 2
    r = torch.sqrt(xy_sq + z ** 2)
    e = torch.atan2(torch.sqrt(xy_sq), z)
    a = torch.atan2(y, x)
    return torch.stack([r, e, a], dim=-1)


def sph2cart(rea):
    """Spherical → cartesian (reference raytracer.py:581-602)."""
    r, e, a = rea[..., 0], rea[..., 1], rea[..., 2]
    return torch.stack(
        [r * torch.sin(e) * torch.cos(a), r * torch.sin(e) * torch.sin(a),
         r * torch.cos(e)], dim=-1)


def find_starts(r_b, e_b, a_b, xs, itype=torch.int32, ftype=None):
    """Voxel region triplet containing each ray start (reference
    find_starts, raytracer.py:605-644): (3, *rays) int, -1 outside the
    grid; points exactly on the outer boundary count as the last voxel."""
    xs = torch.as_tensor(xs)
    ftype = ftype or (xs.dtype if xs.dtype.is_floating_point
                      else torch.float32)
    xs = xs.to(ftype)
    sph = cart2sph(xs)

    def bin_axis(bounds, vals):
        bounds = torch.as_tensor(bounds, dtype=ftype, device=xs.device)
        n = bounds.shape[0] - 1
        reg = torch.searchsorted(bounds, vals.contiguous(),
                                 right=True).to(itype) - 1
        reg = torch.where(vals == bounds[-1], n - 1, reg)
        return torch.where(reg == n, OUTSIDE, reg)

    return torch.stack([bin_axis(r_b, sph[..., 0]),
                        bin_axis(e_b, sph[..., 1]),
                        bin_axis(a_b, sph[..., 2])], dim=0)
