"""Matrix-free linear solvers for tomographic retrieval (port of
``sph_raytracer_tpu/solve.py``).

The forward projection is linear in the density, so quadratic-fidelity
retrievals are linear least-squares problems

    min_x ||M (A x - y)||² + damp ||x||²

:func:`cg` runs preconditioned CGNR on the damped normal equations
``(AᵀMᵀMA + damp·I) x = AᵀMᵀM y``; :func:`mlem` runs the multiplicative
Poisson EM iteration, with ordered subsets (OS-EM); and
:func:`sart_preconditioner` gives :func:`cg` its Jacobi diagonal.

``A`` is an :class:`~sph_raytracer_tpu_torch.operator.Operator` (solve
for the voxel volume) or the operator composed with a *linear* model such
as :class:`~sph_raytracer_tpu_torch.models.SphHarmModel` (solve for model
coefficients, which may be a dict, list or tuple of tensors).  For a bare
operator the adjoint is ``op.T``, so an iteration is one forward and one
adjoint kernel; with a model, or for a plain callable, it is
``torch.autograd.grad`` on the graph of the forward map, again one
forward and one backward an iteration since the map is linear.

The loops run eagerly.  Every per-iteration quantity (the step sizes, the
``tol`` freeze, the iteration count) stays a device tensor, combined with
``torch.where`` as the JAX package's compiled scan combines it, so the
host reads the device once a ``chunk`` of iterations: for the history,
the ``tol`` break and the progress bar.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .operator import resolve_device
from .utils import tree
from .viewgeom import ViewGeomCollection

__all__ = ["cg", "mlem", "sart_preconditioner"]


def _op_ftype(f, default=torch.float32):
    """The operator's compute dtype (lives at ``f.config.ftype``)."""
    cfg = getattr(f, "config", None)
    ft = getattr(cfg, "ftype", None)
    return default if ft is None else ft


def _device(f, y=None) -> torch.device:
    """The operator's device; for a bare callable, ``y``'s if it is a
    tensor, else the card."""
    dev = getattr(f, "device", None)
    if dev is None and isinstance(y, torch.Tensor):
        dev = y.device
    return resolve_device(dev)


def _chunk(chunk, device) -> int:
    """Iterations between host reads: 16 on the CPU, 50 on the card, as
    the JAX package's scan chunks."""
    if chunk is None:
        return 16 if device.type == "cpu" else 50
    return int(chunk)


def _vjp(f, model, mask, x):
    """``(A x, Aᵀ)`` of the linear map ``A v = mask · f(model(v))`` at
    ``x``, as ``jax.vjp`` gives them.

    A bare operator (no model, an ``.T``) takes ``Aᵀ c = f.T(mask · c)``.
    Otherwise ``Aᵀ`` is ``torch.autograd.grad`` on the graph of the
    forward at ``x``; the map is linear, so that graph is the one true
    transpose, kept for every call of ``Aᵀ``."""
    if model is None and hasattr(f, "T"):
        Ax = f(x)
        if mask is not None:
            Ax = Ax * mask

        def adjoint(ct):
            return f.T(ct if mask is None else ct * mask)

        return Ax, adjoint
    xs = [leaf.detach().requires_grad_(True) for leaf in tree.leaves(x)]
    with torch.enable_grad():
        v = tree.unflatten(x, xs)
        Ax = f(v) if model is None else f(model(v))
        if mask is not None:
            Ax = Ax * mask

    def adjoint(ct):
        gs = torch.autograd.grad(Ax, xs, ct, retain_graph=True,
                                 allow_unused=True)
        return tree.unflatten(x, [torch.zeros_like(leaf) if g is None else g
                                  for leaf, g in zip(xs, gs)])

    return Ax.detach(), adjoint


def _progress(progress_bar, total):
    if not progress_bar:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total)


@torch.no_grad()
def sart_preconditioner(f, model=None, projection_mask=None,
                        eps: float = 1e-6):
    """Diagonal (Cimmino/SART-style) preconditioner ``r ↦ r / Aᵀ(A·1)``.

    ``Aᵀ(A·1)`` (one forward and one adjoint) is the row-sum of the normal
    matrix; for the raytracing operator (nonnegative entries: segment
    lengths) it upper-bounds and tracks the diagonal, equalizing the
    wildly different total chord lengths through inner and outer voxels.
    Entries below ``eps · max`` (voxels no ray touches) are set to the max
    so the preconditioner stays positive definite and leaves dead voxels
    unscaled-ish.

    Returns the diagonal, a tree of tensors shaped like the unknowns, to
    pass as :func:`cg`'s ``precond=``.  Helps most on overdetermined
    problems (measurements ≥ unknowns, the usual tomography setup); on
    strongly *under*determined systems the reweighting can slow CGNR
    instead, so compare against ``precond=None`` there.
    """
    device = _device(f)
    shape = tuple(f.grid.shape) if model is None else model.coeffs_shape
    ones = torch.ones(shape, dtype=_op_ftype(f), device=device)
    # the mask in the forward's dtype, as the JAX package casts it
    mask = (None if projection_mask is None else torch.as_tensor(
        projection_mask, dtype=_op_ftype(f), device=device))
    Av, adjoint = _vjp(f, model, mask, ones)
    d = tree.tree_map(torch.abs, adjoint(Av))
    dmax = max(float(leaf.max()) for leaf in tree.leaves(d))
    dmax = dmax if np.isfinite(dmax) and dmax > 0 else 1.0
    # untouched / barely-touched voxels get the *largest* diagonal value:
    # dividing their residual by dmax suppresses those near-null search
    # directions instead of amplifying them by 1/eps
    return tree.tree_map(
        lambda leaf: torch.where(leaf < eps * dmax, dmax, leaf), d)


@torch.no_grad()
def mlem(f, y, x0=None, num_iterations: int = 50, scale: float = 1.0,
         projection_mask=None, subsets: int = 1, eps: float = 1e-12,
         chunk: Optional[int] = None, progress_bar: bool = False):
    """Maximum-likelihood EM (MLEM) for Poisson-distributed measurements.

    The classic multiplicative tomography iteration (Shepp & Vardi 1982)

        x ← x · Aᵀ(m·y / max(s·Ax, eps)) / Aᵀm

    which monotonically decreases the Poisson NLL that
    :class:`~sph_raytracer_tpu_torch.loss.PoissonLoss` scores (``s·Ax`` is
    the predicted count rate, ``s=scale`` the counts-per-line-integral
    sensitivity) and keeps the volume nonnegative.  Volume-space only.

    Args:
        f: forward operator with nonnegative entries (segment lengths).
        y: measured counts, matching ``f``'s output shape.
        x0: initial volume, strictly positive (default ones; voxels the
            rays never touch are forced to 0, the MLEM convention).
        num_iterations: EM sweeps (one forward + one adjoint each).
        scale: counts per unit line integral, as in
            ``PoissonLoss(scale=...)``.
        projection_mask: optional nonnegative weight/mask ``m`` on the
            measurement space (0 drops a pixel/view).
        subsets: ordered-subsets acceleration (OS-EM, Hudson & Larkin
            1994): a sweep is ``subsets`` sequential updates, each on every
            ``subsets``-th view (an interleaved partition of the leading
            view axis).  Requires a static (non-4D) ``Operator`` over a
            ``ViewGeomCollection``; the sub-operators are built once with
            ``f``'s config on ``f``'s device.  The ``nll`` history is then
            the per-sweep NLL assembled from each subset's pre-update
            rates (exact monotonicity only at ``subsets=1``).
        eps: floor for the predicted rate.
        chunk: sweeps between host reads (default 16 on the CPU, 50 on
            the card).
        progress_bar: tqdm over chunks with the live mean NLL.

    Returns:
        ``(x, f(x), info)`` with ``info['nll']`` the per-iteration mean
        Poisson NLL history, ``info['iterations']`` the sweeps run and
        ``info['sensitivity']`` the summed ``Aᵀm``.
    """
    device = _device(f, y)
    chunk = _chunk(chunk, device)
    y = torch.as_tensor(y, device=device)
    fdtype = y.dtype if y.is_floating_point() else _op_ftype(f)
    if x0 is None:
        if not hasattr(f, "grid"):
            raise ValueError("f has no .grid; pass x0 explicitly")
        x0 = torch.ones(tuple(f.grid.shape), dtype=fdtype, device=device)
    x = torch.as_tensor(x0, device=device)
    mask = (None if projection_mask is None else
            torch.as_tensor(projection_mask, dtype=fdtype, device=device))
    scale = float(scale)
    subsets = int(subsets)

    if subsets > 1:
        geom = getattr(f, "geom", None)
        if (not isinstance(geom, ViewGeomCollection)
                or len(geom) < subsets):
            raise ValueError(
                "subsets>1 requires an Operator over a ViewGeomCollection"
                f" with at least {subsets} views")
        if getattr(f, "dynamic", False):
            raise ValueError("subsets>1 does not support 4D operators "
                             "(views are bound to time bins)")
        # interleaved view partition k::K — balanced angular coverage
        subops = [type(f)(f.grid,
                          ViewGeomCollection(*geom.geoms[k::subsets]),
                          config=f.config, device=f.device)
                  for k in range(subsets)]
    else:
        subops = [f]

    ym_full = y.to(fdtype)
    yms = [ym_full[k::subsets] for k in range(subsets)]
    masks = [None if mask is None else mask[k::subsets]
             for k in range(subsets)]
    npix_total = float(ym_full.numel())

    def cotangent_mask(k, like):
        return (torch.ones_like(like) if masks[k] is None
                else masks[k].to(like.dtype))

    # per-subset sensitivity s_k = A_kᵀ m_k (m defaults to ones)
    ss = []
    for k, fk in enumerate(subops):
        Ax, adjoint = _vjp(fk, None, None, x)
        ss.append(adjoint(cotangent_mask(k, Ax)))

    def sweep(x):
        # one pass = `subsets` sequential multiplicative updates; voxels a
        # subset doesn't see keep their value (OS-EM convention)
        nll_sum = torch.zeros((), dtype=x.dtype, device=device)
        for k, fk in enumerate(subops):
            Ax, adjoint = _vjp(fk, None, None, x)
            rate = torch.clamp_min(scale * Ax, eps)
            m = cotangent_mask(k, rate)
            nll_sum = nll_sum + torch.sum(
                m * (rate - yms[k] * torch.log(rate)))
            num = adjoint(m * yms[k] / rate)
            sk = ss[k]
            x = torch.where(sk > 0, x * num / torch.where(sk > 0, sk, 1.0),
                            x)
        return x, nll_sum / npix_total

    pbar = _progress(progress_bar, num_iterations)
    nlls = []
    it = 0
    try:
        while it < num_iterations:
            n = min(chunk, num_iterations - it)
            nl = []
            for _ in range(n):
                x, nll = sweep(x)
                nl.append(nll)
            nl = torch.stack(nl).cpu().numpy()  # the chunk's one host read
            nlls.extend(nl.tolist())
            it += n
            if pbar is not None:
                pbar.set_description(f"NLL:{nl[-1]:.4e}")
                pbar.update(n)
    except KeyboardInterrupt:
        pass
    finally:
        if pbar is not None:
            pbar.close()

    # voxels no (kept) ray touches carry no likelihood information:
    # force them to 0, the MLEM convention
    s_total = sum(ss[1:], start=ss[0])
    x = torch.where(s_total > 0, x, 0.0)
    info = {"nll": np.asarray(nlls), "iterations": it,
            "sensitivity": s_total}
    return x, f(x), info


@torch.no_grad()
def cg(f, y, model=None, x0=None, num_iterations: int = 50,
       damp: float = 0.0, precond=None, projection_mask=None,
       tol: float = 0.0, chunk: Optional[int] = None,
       progress_bar: bool = False):
    """Solve ``min ||mask·(f(model(x)) - y)||² + damp·||x||²`` by CGNR.

    Args:
        f: forward operator, linear in its input.
        y: measurement stack matching ``f``'s output shape.
        model: optional *linear* coefficient model (``model(x)`` linear in
            ``x``, e.g. ``FullyDenseModel``, ``SphHarmModel``).  ``None``
            solves directly for the voxel volume.
        x0: initial iterate (default zeros of ``y``'s floating dtype, or
            float32; a dict, list or tuple of tensors allowed).
        num_iterations: maximum CG iterations (one forward + one adjoint
            application each).
        damp: Tikhonov damping λ — solves the regularized normal
            equations ``(AᵀA + λI) x = Aᵀ y``.
        precond: optional positive-definite preconditioner — either a
            callable ``z = precond(r)`` in coefficient space, or a tree of
            positive tensors read as a Jacobi diagonal (``z = r /
            precond``; see :func:`sart_preconditioner`).
        projection_mask: optional weight/mask on the measurement space,
            matching ``y``'s shape — the ``M`` above (the convention of
            :class:`~sph_raytracer_tpu_torch.loss.Loss`'s
            ``projection_mask``).
        tol: relative-residual stopping threshold: iteration freezes once
            ``||Aᵀ(y - Ax) - damp·x|| <= tol · ||Aᵀy||`` (checked on the
            device each iteration; the loop breaks at the end of the
            chunk; 0 disables).
        chunk: iterations between host reads (default 16 on the CPU, 50
            on the card).
        progress_bar: tqdm over chunks with the live relative residual.

    Returns:
        ``(x, f(model(x)), info)`` where ``info['rnorm']`` is the
        normal-equations residual-norm history (one entry per iteration
        run), ``info['iterations']`` counts iterations before the ``tol``
        freeze (== iterations run when it never triggered) and
        ``info['bnorm']`` is ``||Aᵀy||``.
    """
    device = _device(f, y)
    chunk = _chunk(chunk, device)
    y = torch.as_tensor(y, device=device)
    x0dtype = y.dtype if y.is_floating_point() else torch.float32
    if x0 is None:
        if model is None:
            if not hasattr(f, "grid"):
                raise ValueError("f has no .grid; pass model= explicitly")
            x0 = torch.zeros(tuple(f.grid.shape), dtype=x0dtype,
                             device=device)
        else:
            x0 = torch.zeros(model.coeffs_shape, dtype=x0dtype,
                             device=device)
    x = tree.tree_map(lambda leaf: torch.as_tensor(leaf, device=device), x0)
    mask = (None if projection_mask is None else
            torch.as_tensor(projection_mask, device=device))
    damp = float(damp)

    if precond is None:
        def M(r):
            return r
    elif callable(precond):
        M = precond
    else:  # a tree Jacobi diagonal
        pdiag = tree.tree_map(
            lambda leaf: torch.as_tensor(leaf, device=device), precond)

        def M(r):
            return tree.tree_map(torch.div, r, pdiag)

    # init: one forward, two adjoints.  r = Aᵀ(y - Ax) - damp·x (the
    # normal-equations residual) and b = Aᵀy share the forward's graph
    Ax, adjoint = _vjp(f, model, mask, x)
    ym = y.to(Ax.dtype)
    ym = ym if mask is None else ym * mask.to(Ax.dtype)
    r = tree.axpy(-damp, x, adjoint(ym - Ax))
    b = adjoint(ym)
    del Ax, adjoint
    bnorm = torch.sqrt(tree.vdot(b, b))
    z = M(r)
    rz = tree.vdot(r, z)
    p = z
    niter = torch.zeros((), dtype=torch.int32, device=device)
    never = torch.zeros((), dtype=torch.bool, device=device)

    def step(x, r, p, rz, niter):
        rnorm = torch.sqrt(tree.vdot(r, r))
        done = rnorm <= tol * bnorm if tol > 0 else never
        Ap, adjoint = _vjp(f, model, mask, p)
        q = tree.axpy(damp, p, adjoint(Ap))
        pq = tree.vdot(p, q)
        alpha = torch.where((pq > 0) & ~done,
                            rz / torch.where(pq > 0, pq, 1.0), 0.0)
        x = tree.axpy(alpha, p, x)
        r = tree.axpy(-alpha, q, r)
        z2 = M(r)
        rz2 = tree.vdot(r, z2)
        beta = torch.where((rz > 0) & ~done,
                           rz2 / torch.where(rz > 0, rz, 1.0), 0.0)
        p = tree.where(done, p, tree.axpy(beta, p, z2))
        niter = niter + (~done).to(torch.int32)
        return x, r, p, torch.where(done, rz, rz2), niter, rnorm

    pbar = _progress(progress_bar, num_iterations)
    rnorms = []
    it = 0
    try:
        while it < num_iterations:
            n = min(chunk, num_iterations - it)
            rn = []
            for _ in range(n):
                x, r, p, rz, niter, rnorm = step(x, r, p, rz, niter)
                rn.append(rnorm)
            # the chunk's one host read: its residual norms and ||Aᵀy||
            rn = torch.stack(rn + [bnorm]).cpu().numpy()
            rn, bnorm_h = rn[:-1], float(rn[-1])
            rnorms.extend(rn.tolist())
            it += n
            if pbar is not None:
                pbar.set_description(
                    f"|r|/|b|:{rn[-1] / max(bnorm_h, 1e-30):.2e}")
                pbar.update(n)
            if tol > 0 and rn[-1] <= tol * bnorm_h:
                break
    except KeyboardInterrupt:
        pass
    finally:
        if pbar is not None:
            pbar.close()

    info = {"rnorm": np.asarray(rnorms),
            "iterations": int(niter),
            "bnorm": float(bnorm)}
    vol = x if model is None else model(x)
    return x, f(vol), info
