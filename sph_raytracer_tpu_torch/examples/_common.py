"""What the example modules share: the ``SPH_TPU_EXAMPLE_*`` knobs, the
command line, seconds on a synchronised device, matplotlib, and the
process group of the sharded examples."""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch


def knob(name: str, default: int) -> int:
    """``SPH_TPU_EXAMPLE_<name>`` as an int, else ``default`` (the JAX
    scripts' knobs, which shrink a run)."""
    return int(os.environ.get(f"SPH_TPU_EXAMPLE_{name}", default))


def parse_args(doc: str, argv=None):
    """``--device`` (default: the card; the CPU only when asked) and
    ``--outdir`` (where the figures go)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, which "
                    "raises when there is none; 'cpu' only when asked)")
    ap.add_argument("--outdir", default=".", help="where figures go")
    return ap.parse_args(argv)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """An example's setup seconds (operator constructions, timed with
    :meth:`build`) and run seconds (the rest since the clock started), the
    device synchronised at each mark."""

    def __init__(self, device):
        self.device = device
        self.setup_s = 0.0
        sync(device)
        self._t0 = time.perf_counter()

    def build(self, make, *args, **kw):
        sync(self.device)
        t0 = time.perf_counter()
        out = make(*args, **kw)
        sync(self.device)
        self.setup_s += time.perf_counter() - t0
        return out

    def seconds(self) -> dict:
        sync(self.device)
        total = time.perf_counter() - self._t0
        return {"setup_s": self.setup_s, "run_s": total - self.setup_s}


def pyplot():
    """matplotlib's pyplot on the Agg backend (the scripts write files);
    raises ImportError where matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def step_fn(op, y):
    """One eager gradient step of ``mean((op(d) - y)²)``: returns ``d ↦
    (loss, gradient)``, the counterpart of the JAX scripts'
    ``jax.value_and_grad``."""
    def loss_grad(d):
        v = d.detach().requires_grad_(True)
        loss = torch.mean((op(v) - y) ** 2)
        (g,) = torch.autograd.grad(loss, v)
        return loss.detach(), g
    return loss_grad


def timed_steps(loss_grad, x, iters, device):
    """One warm call of ``loss_grad(x)``, then the seconds a call over
    ``iters`` more, the device synchronised; returns (loss, grad, s)."""
    loss, g = loss_grad(x)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, g = loss_grad(x)
    sync(device)
    return loss, g, (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def process_group(device=None):
    """The default process group of a sharded example's ``main()``:
    ``torchrun``'s (``env://``) where its environment is set, else one rank
    over a ``file://`` store in a temporary directory.  A group made here
    is destroyed on exit; one that exists already is left as it is."""
    import torch.distributed as dist

    from ..parallel import distributed_init

    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as store:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            distributed_init(device=device)
        else:
            distributed_init(f"file://{store}/store", num_processes=1,
                             process_id=0, device=device)
        try:
            yield
        finally:
            dist.destroy_process_group()
