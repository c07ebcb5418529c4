"""On-card training-step times of the flagship's routed and fused configs,
and the kernels of the routed configs::

    python -m sph_raytracer_tpu_torch.tools.step_times

One ``Operator`` a config on the flagship (50³ grid, 50 views of 50×100
pixels; ``wfwd_probe.CONFIGS['flagship']``); its step is ``bench.py``'s
(forward → mean-square loss → gradient → update), timed with CUDA events
over 30 steps after 5 warm-up ones.  Beside the steps, the forward and the
backward kernel of the ``'auto'``, ``'off'``, ``'both'``, ``'hist'``
(``routed_fwd_reduce='hist'``) and window configs (``routed_fwd`` (B1),
``routed_bwd_gather`` (B2), ``routed_bwd_scatter`` (B3),
``routed_fwd_dense`` (B5), ``routed_fwd_hist`` (B6), ``routed_fwd_window``
(B7a), ``routed_bwd_window`` (B7b)), each on the tables of the first of
those configs that runs it (B1 and B2 on ``'auto'``'s), the mean of 20
launches after 3.  It reaches the package only
through names that checkouts from the window-major probe on have too, so
that one call can time two checkouts in turns: ``PYTHONPATH=<checkout>
python <this file>``.  Prints one JSON object.  Runs on the card only.
"""
import json

import torch

import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.tools.wfwd_probe import CONFIGS as PROBE
from sph_raytracer_tpu_torch.tools.wfwd_probe import _orbit, cuda_ms

CONFIGS = {  # name: Operator keyword arguments
    "auto": dict(),
    "off": dict(config=prt.TraceConfig(routed_dense="off")),
    "both": dict(config=prt.TraceConfig(routed_dense="both")),
    "fwd": dict(config=prt.TraceConfig(routed_dense="fwd")),
    "hist": dict(config=prt.TraceConfig(routed_fwd_reduce="hist")),
    "window": dict(config=prt.TraceConfig(routed_banded=False)),
    "fused": dict(mode="fused"),
    "fused_off": dict(config=prt.TraceConfig(mode="fused",
                                             routed_dense="off")),
}


def main():
    dev = torch.device("cuda")
    vshape, n_views, det = PROBE["flagship"]
    grid = prt.SphericalGrid(shape=vshape)
    geom = _orbit(n_views, det)
    gen = torch.Generator().manual_seed(0)
    truth = torch.rand(tuple(grid.shape), generator=gen).to(dev)
    out = {"device": torch.cuda.get_device_name(0), "package":
           prt.__file__, "step_ms": {}, "kernel_ms": {}}
    for name, kw in CONFIGS.items():
        op = prt.Operator(grid, geom, device=dev, **kw)
        with torch.no_grad():
            target = op(truth)
        state = {"v": truth * 0.5}

        def step():
            v = state["v"].detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(
                torch.mean((op(v) - target) ** 2), v)
            state["v"] = (v - 1e-3 * grad).detach()

        out["step_ms"][name] = cuda_ms(step, n=30, warm=5)
        t = op._tables
        if name in ("auto", "off", "both", "hist", "window"):
            d = torch.rand(t.n_vox, generator=gen).to(dev)
            dy = torch.randn(t.n_rays, generator=gen).to(dev)
            for kern, x in ((op._fwd, d), (op._bwd, dy)):
                if kern.__name__ not in out["kernel_ms"]:
                    out["kernel_ms"][kern.__name__] = cuda_ms(
                        lambda: kern(t, x))
        del op
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
