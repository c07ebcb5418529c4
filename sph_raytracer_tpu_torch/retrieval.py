"""Tomographic retrieval: gradient-descent driver.

Port of ``sph_raytracer_tpu/retrieval.py`` (reference retrieval.py:24-127):
``gd(f, y, model, ...)`` minimizes a weighted sum of loss functions over
the model coefficients and returns ``(best_coeffs, f(model(best_coeffs)),
losses)`` with a per-iteration per-loss history dict, best-so-far
tracking, Ctrl-C early stop, the ``model.proj`` hook and checkpoint /
resume.  The optimizer is ``torch.optim.Adam`` (lr 1e-3) and the loop runs
eagerly, one step per iteration; the loss history and the best-so-far
state stay on the device until the loop ends, so a step does not wait
for the host.
"""
from __future__ import annotations

import math

import torch

from .loss import SquareLoss
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.interop import adam_state_from_jax, adam_state_to_jax

__all__ = ["gd", "detach_loss"]


def detach_loss(loss):
    """Convert a loss tensor to a plain float (reference
    retrieval.py:11-22)."""
    return float(loss) if loss is not None else loss


def gd(f, y, model, coeffs=None, num_iterations=100, loss_fns=None,
       optim=torch.optim.Adam, progress_bar=True, chunk=None,
       checkpoint_path=None, checkpoint_every: int = 0,
       resume: bool = False, **kwargs):
    """Gradient descent to minimize a weighted sum of losses.

    Minimizes ``sum(loss_fn(f, y, model(coeffs), coeffs))`` over the
    non-oracle loss functions with respect to ``coeffs``.  Use Ctrl-C to
    stop early and return the best result so far.

    Args:
        f: forward operator (density → projections) with ``.grid`` and
            ``.device``.
        y: measurement stack matching ``f``'s output shape.
        model: :class:`~sph_raytracer_tpu_torch.models.Model` instance.
        coeffs: initial coefficient tensor (default
            ``ones(model.coeffs_shape)`` in float32 on ``f.device``).
        num_iterations: gradient steps.
        loss_fns: list of :class:`~sph_raytracer_tpu_torch.loss.Loss`
            (default ``[SquareLoss()]``).
        optim: a ``torch.optim.Optimizer`` class, instantiated with
            ``**kwargs`` (default Adam, lr 1e-3; ``learning_rate=`` is
            accepted as an alias of ``lr``).
        progress_bar: show tqdm progress with F/R/O loss buckets.
        chunk: accepted and ignored, so calls written for the JAX package
            run unchanged: there it sets the iterations of one compiled
            scan; here the loop is eager, one step an iteration.
        checkpoint_path / checkpoint_every: if set, save (coeffs, Adam
            state, iteration) every N iterations in the JAX package's
            checkpoint format; ``resume=True`` restarts from the checkpoint,
            which either package may have written.  Adam only.

    Returns:
        (best_coeffs, f(model(best_coeffs)), losses) where ``losses`` maps
        each loss_fn to its per-iteration float history.
    """
    if "optim_vars" in kwargs:
        raise TypeError("optim_vars is not supported: make every optimized "
                        "tensor part of `coeffs`")
    if loss_fns is None:
        loss_fns = [SquareLoss()]
    if hasattr(f, "grid") and hasattr(model, "grid") and f.grid != model.grid:
        raise ValueError("f and model must have same grid")
    if "learning_rate" in kwargs:
        kwargs["lr"] = kwargs.pop("learning_rate")
    kwargs.setdefault("lr", 1e-3)
    if checkpoint_path and optim is not torch.optim.Adam:
        raise ValueError("checkpoint/resume is defined for torch.optim.Adam "
                         "(the JAX package's optax.adam state)")

    device = getattr(f, "device", None)
    if coeffs is None:
        coeffs = torch.ones(model.coeffs_shape, dtype=torch.float32,
                            device=device)
    c = torch.as_tensor(coeffs, device=device).detach().clone()
    c.requires_grad_(True)
    if y is not None:
        y = torch.as_tensor(y, dtype=c.dtype, device=c.device)
    opt = optim([c], **kwargs)

    start_iter = 0
    if resume and checkpoint_path:
        state = load_checkpoint(checkpoint_path)
        if state is not None:
            leaves, start_iter = state
            c_ck, st = adam_state_from_jax(leaves, device=c.device)
            with torch.no_grad():
                c.copy_(c_ck)
            opt.state[c] = {k: v if k == "step" else v.to(c.dtype)
                            for k, v in st.items()}

    grad_mask = [lf.use_grad and lf.kind != "oracle" for lf in loss_fns]
    proj = getattr(model, "proj", None)

    pbar = None
    if progress_bar:
        try:
            from tqdm import tqdm

            pbar = tqdm(total=num_iterations, initial=start_iter)
        except ImportError:
            pbar = None

    history = []  # per-iteration (n_losses,) float32 tensors, on device
    best_loss = torch.tensor(math.inf, dtype=c.dtype, device=c.device)
    best_c = c.detach().clone()
    it = start_iter
    try:
        while it < num_iterations:
            opt.zero_grad(set_to_none=True)
            d = model(c)
            vals = [lf(f, y, d, c) for lf in loss_fns]
            tot = sum((v for v, m in zip(vals, grad_mask) if m),
                      start=torch.zeros((), dtype=c.dtype, device=c.device))
            # best-so-far of the coefficients each loss was evaluated at
            # (reference retrieval.py:111-113), kept on the device
            better = tot.detach() < best_loss
            best_loss = torch.where(better, tot.detach(), best_loss)
            best_c = torch.where(better, c.detach(), best_c)
            if tot.requires_grad:
                tot.backward()
            opt.step()
            if proj is not None:
                with torch.no_grad():
                    c.copy_(proj(c))
            history.append(torch.stack(
                [torch.as_tensor(v).detach().to(torch.float32) for v in vals]))
            it += 1
            if pbar is not None:
                last = history[-1].tolist()
                stat = {k: sum(v for v, lf in zip(last, loss_fns)
                               if lf.kind == k)
                        for k in ("fidelity", "regularizer", "oracle")}
                pbar.set_description(
                    f"F:{stat['fidelity']:.1e} R:{stat['regularizer']:.1e} "
                    f"O:{stat['oracle'] * 100:.0f}")
                pbar.update(1)
            if checkpoint_path and checkpoint_every and (
                    it % checkpoint_every == 0):
                save_checkpoint(checkpoint_path,
                                adam_state_to_jax(c, opt.state[c]), it)
    except KeyboardInterrupt:
        pass
    finally:
        if pbar is not None:
            pbar.close()

    losses = {lf: [] for lf in loss_fns}
    if history:
        vals = torch.stack(history).cpu().numpy()
        for j, lf in enumerate(loss_fns):
            losses[lf] = vals[:, j].tolist()
    if not math.isfinite(float(best_loss)):
        best_c = c.detach()
    with torch.no_grad():
        y_result = f(model(best_c))
    return best_c, y_result, losses
