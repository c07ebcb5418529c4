"""On-card stage split of the fused forward ``fused_fwd`` (B4): where its
time goes, stage by stage, in the kernel as first ported and in the shipped
one, at the flagship and on the dynamic ``view_times`` (lerp)
configuration::

    python -m sph_raytracer_tpu_torch.tools.fused_sweep [flagship] [lerp] \
        > fused_sweep.jsonl
    PYTHONPATH=<checkout> python \
        sph_raytracer_tpu_torch/tools/fused_sweep.py --public

The split reaches the kernel's designs through the entry
``fused_fwd_sweep`` (``csrc/fused_sweep.cu``; :data:`DESIGNS`, in the
entry's order): ``parent``, the kernel as first ported (by row, the full
Mp-wide sort, the per-lane walk, 4,096 striding blocks), and ``shipped``,
the kernel ``fused_fwd`` launches.  Each stops after each stage of
:data:`STAGES` (a truncated kernel writes a fold of what it computed, not
y).  Each design runs whole first and is checked against the plain
version ``fused_fwd_ref`` (rays outside rtol 1e-5 / atol 1e-5 of the
largest counted, as ``chip_smoke.py``'s ``check_rays`` does; exit 1 when
more than 1e-4 of the rays miss) and run to run; then each stage is timed,
the mean of :data:`wfwd_probe.N_TIMED` launches after 3 (CUDA events).
One JSON record a line: the per-ray statistics of each config
(:func:`ray_stats`), the shipped kernel ``fused_fwd`` itself, then one a
design.

``--public`` times only the public ``fused_fwd`` (flagship and lerp) and
the fused training step, through names that older checkouts have too, so
that one call can time a parent and a change in turns.  Runs on the card
only, except :func:`ray_stats`, :func:`kernel_order` and
:func:`edge_rays`, which take tensors on any device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import fused_project as fp
from sph_raytracer_tpu_torch.tools.wfwd_probe import N_TIMED, _orbit, cuda_ms

__all__ = ["DESIGNS", "STAGES", "CONFIGS", "build", "sweep_fwd",
           "stage_split", "ray_stats", "shipped_ops", "kernel_order",
           "edge_rays", "main"]

# fused_fwd_sweep's designs, in its order (csrc/fused_kernel.cuh enum Design)
DESIGNS = ("parent", "shipped")
STAGES = ("crossings", "sort", "labels", "all")
# the configs' padded crossing count (fused_fwd_sweep takes only this one)
SWEEP_MP = 256
# at most this share of rays may miss the tolerance (knife-edge labels),
# as chip_smoke.py's KNIFE_KERNEL
KNIFE = 1e-4
SEED = 0
CONFIGS = ("flagship", "lerp")


def build(config, device):
    """``(gs, rays, d)`` of a config: the fused operator's grid spec and
    rays, and a seeded density on ``device``.  'flagship': the 50³ grid,
    50 views of ``ConeRectGeom((50, 100))`` (250,000 rays); 'lerp':
    ``examples/dynamic_measurements.py``'s (20, 50, 50, 50) grid, 40
    ``ConeCircGeom((100, 50))`` views at interpolated times (200,000
    rays)."""
    if config == "flagship":
        op = prt.Operator(prt.SphericalGrid(shape=(50, 50, 50)),
                          _orbit(50, (50, 100)), mode="fused", device=device)
    elif config == "lerp":
        grid = prt.SphericalGrid(shape=(20, 50, 50, 50))
        n = 2 * grid.shape.t
        geom = sum(prt.ConeCircGeom(shape=(100, 50),
                                    pos=(5 * np.cos(th), 5 * np.sin(th), 1),
                                    fov=(0, 45))
                   for th in np.linspace(0, 2 * np.pi, n))
        op = prt.Operator(grid, geom, mode="fused", device=device,
                          view_times=np.linspace(float(grid.t[0]),
                                                 float(grid.t[-1]), n))
    else:
        raise ValueError(f"unknown config {config!r}")
    d = torch.rand(op._flat_size,
                   generator=torch.Generator().manual_seed(SEED)).to(device)
    return op.gs, op._frays, d


def sweep_fwd(gs, rays, d, design, stage="all"):
    """y (R,) of design ``design`` (a name of :data:`DESIGNS`) stopped
    after ``stage``; at a stage before 'all' a fold of what it computed."""
    from sph_raytracer_tpu_torch.ops._cuda import launch

    if fp.padded_crossings(gs) != SWEEP_MP:
        raise ValueError(f"the sweep's kernels take Mp = {SWEEP_MP}")
    y = torch.empty(rays.n, dtype=torch.float32, device=d.device)
    launch("fused_fwd_sweep",
           (rays.xs, rays.dirs, rays.off0, rays.off1, rays.w,
            fp.boundary_table(gs, d.device), d, y),
           (rays.n, gs.nr, gs.ne, gs.na, SWEEP_MP, DESIGNS.index(design),
            STAGES.index(stage)))
    return y


def stage_split(gs, rays, d, design, n=N_TIMED):
    """{stage: ms} of ``design`` stopped after each stage (cumulative; the
    mean of ``n`` launches), and {stage: ms} of each stage alone (the
    differences)."""
    cum = {s: cuda_ms(lambda s=s: sweep_fwd(gs, rays, d, design, s), n=n)
           for s in STAGES}
    alone = {s: cum[s] - (cum[STAGES[i - 1]] if i else 0.0)
             for i, s in enumerate(STAGES)}
    return cum, alone


def _pow2(n):
    """The sort size S = pow2(n), at least 32, per element of ``n``."""
    s = torch.full_like(n, 32)
    while bool((s < n).any()):
        s = torch.where(s < n, 2 * s, s)
    return s


def ray_stats(gs, rays, block=8192):
    """Per-ray counts of the kernel's work, from the plain version's
    crossings: the finite crossings (mean, median, 90th percentile, max),
    the rays whose sort size S = pow2(count) is 32 … 512, the compare-
    exchanges of those sorts and of the full Mp-wide one, the negative
    crossings, the live segments, the dense walk's steps (ceil((count - 1
    - negatives) / 32)) and the 32-wide slices of the sorted row that hold
    a live segment."""
    tab = fp.boundary_table(gs, rays.xs.device)
    mp = fp.padded_crossings(gs)
    width = max(mp, 32)  # the kernel's slots: Mp, at least a warp
    counts, negs, lives, slices = [], [], [], []
    for i in range(0, rays.n, block):
        c = fp._crossings(gs, tab, rays.xs[i:i + block],
                          rays.dirs[i:i + block])
        fin = torch.isfinite(c)
        counts.append(fin.sum(1))
        negs.append((fin & (c < 0)).sum(1))
        live = fp._segments(torch.sort(c, dim=1).values)[1]
        lives.append(live.sum(1))
        live = torch.nn.functional.pad(live, (0, width - mp))
        slices.append(live.reshape(live.shape[0], -1, 32).any(2).sum(1))
    n, neg = torch.cat(counts), torch.cat(negs)
    live, sl = torch.cat(lives), torch.cat(slices)
    S = _pow2(n)
    L = torch.log2(S.double()).round()
    walk = torch.clamp(n - 1 - neg, min=0)
    nf = n.double()
    Lw = int(np.log2(width))
    return {
        "rays": rays.n, "mp": mp,
        "finite_mean": float(nf.mean()), "finite_median": float(nf.median()),
        "finite_p90": float(torch.quantile(nf, 0.9)),
        "finite_max": int(n.max()),
        "sort_size_rays": {int(s): int((S == s).sum())
                           for s in (32, 64, 128, 256, 512) if s <= width},
        "cx_compact": int((S.double() * L * (L + 1) / 4).sum()),
        "cx_full": rays.n * width * Lw * (Lw + 1) // 4,
        "negative_mean": float(neg.double().mean()),
        "live": int(live.sum()), "live_mean": float(live.double().mean()),
        "walked": int(walk.sum()),
        "walk_steps_mean": float(((walk + 31) // 32).double().mean()),
        "live_slices_mean": float(sl.double().mean()),
    }


def shipped_ops(gs, stats, lerp):
    """f32 operations of the shipped design, counted from
    ``csrc/fused_kernel.cuh`` as ``chip_smoke.py``'s ``fused_ops`` counts
    the first port's: per ray the prologue (30), a sphere boundary's two
    roots (8), a
    cone boundary's (45), an azimuth plane (25) and the warp reduce (160);
    2 per compare-exchange of the S-wide sorts (``stats['cx_compact']``); 5
    per walked segment (length, live test); per live segment the midpoint
    and |p| (14), the three searches (56) and the gather-multiply-add (2,
    lerp 7)."""
    per_ray = (30 + 8 * (gs.nr + 1) + 45 * (gs.ne + 1) + 25 * (gs.na + 1)
               + 160)
    return (stats["rays"] * per_ray + 2 * stats["cx_compact"]
            + 5 * stats["walked"] + stats["live"] * (70 + (7 if lerp else 2)))


def kernel_order(gs, rays, d):
    """The shipped kernel's order in plain torch ops: compact each ray's
    finite crossings, sort only the first S = pow2(count) slots, walk the
    segments from the first t >= 0 to the last finite value 32 at a time
    (segment e on lane (e - negatives) % 32), one accumulator a lane, then
    the shuffle tree of offsets 16 … 1.  Returns ``(ts, code, valid, y)``:
    the sorted rows padded with +inf to Mp, the labels (without the time
    offset) and their validity (live, inside the grid and inside the walk),
    and y (R,)."""
    tab = fp.boundary_table(gs, d.device)
    mp = fp.padded_crossings(gs)
    c = fp._crossings(gs, tab, rays.xs, rays.dirs)
    fin = torch.isfinite(c)
    n, neg = fin.sum(1), (fin & (c < 0)).sum(1)
    # compaction: the finite values first (their order does not matter)
    c = torch.gather(c, 1, torch.argsort((~fin).to(torch.int8), dim=1,
                                         stable=True))
    S = _pow2(n)
    ts = torch.full_like(c, fp.INF)
    for s in torch.unique(S).tolist():
        rows = S == s
        ts[rows, :s] = torch.sort(c[rows, :s], dim=1).values
    lens, live = fp._segments(ts)
    code, valid = fp._codes(gs, tab, rays.xs, rays.dirs, ts, lens, live)
    e = torch.arange(mp, device=d.device)
    walked = (e >= neg[:, None]) & (e < n[:, None] - 1)
    valid = valid & walked
    wl = torch.where(valid, lens, 0.0)
    off0 = 0 if rays.off0 is None else rays.off0[:, None].long()
    terms = [d[code + off0] * wl]
    if rays.w is not None:
        wr = rays.w[:, None]
        code1 = code + rays.off1[:, None].long()
        terms = [d[code + off0] * (wl * (1.0 - wr)), d[code1] * (wl * wr)]
    # segment e sits on step (e - neg) // 32, lane (e - neg) % 32; a row
    # of fewer than 32 slots is padded to one step
    width = max(mp, 32)
    j = torch.clamp(e[None, :] + neg[:, None], max=mp - 1)
    walked = torch.nn.functional.pad(walked.gather(1, j), (0, width - mp))
    terms = [torch.nn.functional.pad(t.gather(1, j), (0, width - mp))
             for t in terms]
    acc = torch.zeros(rays.n, 32, dtype=torch.float32, device=d.device)
    for step in range(width // 32):
        cols = slice(step * 32, (step + 1) * 32)
        for t in terms:
            acc = acc + torch.where(walked[:, cols], t[:, cols], 0.0)
    lane = torch.arange(32, device=d.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    return ts, code, valid, acc[:, 0]


def edge_rays(gs, counts, n=20000, seed=0, device="cpu"):
    """Rays with the given finite crossing counts, the first of each found
    in a seeded set of ``n`` rays (starts on spheres of radius 1.05 to 3
    times the grid's, aimed at points inside a ball of 1.2 times its
    radius; one with a live segment where there is one), then a ray that
    misses the outer sphere (finite cone and plane crossings only) and one
    that passes 1e-6 from the cones' apex.  Raises when a count is not in
    the set."""
    rng = np.random.default_rng(seed)
    r_max = float(gs.r_b[-1])
    u = rng.normal(size=(n, 3))
    start = u / np.linalg.norm(u, axis=1, keepdims=True) \
        * rng.uniform(1.05, 3.0, (n, 1)) * r_max
    v = rng.normal(size=(n, 3))
    aim = v / np.linalg.norm(v, axis=1, keepdims=True) \
        * rng.uniform(0, 1.2, (n, 1)) ** 2 * r_max
    xs, dirs = start, aim - start
    pool = fp.prep_rays(xs, dirs)
    got = fp._crossings(gs, fp.boundary_table(gs, "cpu"), pool.xs, pool.dirs)
    have = torch.isfinite(got).sum(1)
    # rays with a live segment first
    live = fp._segments(torch.sort(got, dim=1).values)[1].any(1)
    pick = []
    for k in counts:
        hit = torch.nonzero((have == k) & live)
        if not len(hit):
            hit = torch.nonzero(have == k)
        if not len(hit):
            raise ValueError(f"no ray of {k} finite crossings among {n}")
        pick.append(int(hit[0]))
    xs = np.r_[xs[pick], [[0.0, 2.0 * r_max, 0.5 * r_max],
                          [2.0 * r_max, 1e-6, 1e-6]]]
    dirs = np.r_[dirs[pick], [[1.0, 0.1, 0.0], [-1.0, 0.0, 0.0]]]
    return fp.prep_rays(xs, dirs, device=device)


def _outside(got, want):
    tol = 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()
    return int(((got.double() - want.double()).abs() > tol).sum())


def sweep(config):
    """The records of one config (see the module docstring)."""
    dev = torch.device("cuda")
    gs, rays, d = build(config, dev)
    want = fp.fused_fwd_ref(gs, rays, d)
    stats = ray_stats(gs, rays)
    lerp = rays.w is not None
    yield {"config": config, "stats": stats,
           "ops_shipped": shipped_ops(gs, stats, lerp)}
    y = fp.fused_fwd(gs, rays, d)
    yield {"config": config, "design": "fused_fwd", "outside_tol":
           _outside(y, want), "bitwise_run_to_run": bool(torch.equal(
               y, fp.fused_fwd(gs, rays, d))),
           "ms": cuda_ms(lambda: fp.fused_fwd(gs, rays, d))}
    for name in DESIGNS:
        y = sweep_fwd(gs, rays, d, name)
        out = _outside(y, want)
        cum, alone = stage_split(gs, rays, d, name)
        yield {"config": config, "design": name, "outside_tol": out,
               "bad": out > KNIFE * rays.n,
               "bitwise_run_to_run": bool(torch.equal(
                   y, sweep_fwd(gs, rays, d, name))),
               "ms": cum["all"], "stage_ms": cum, "stage_alone_ms": alone}


def public():
    """The public ``fused_fwd`` at the flagship and on the lerp config and
    the fused training step (forward, mean-square loss, gradient through
    the lazy backward, update): one JSON object."""
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "package": prt.__file__}
    for config in CONFIGS:
        gs, rays, d = build(config, dev)
        out[f"fused_fwd_{config}_ms"] = cuda_ms(
            lambda: fp.fused_fwd(gs, rays, d))
    grid = prt.SphericalGrid(shape=(50, 50, 50))
    op = prt.Operator(grid, _orbit(50, (50, 100)), mode="fused", device=dev)
    truth = torch.rand(tuple(grid.shape),
                       generator=torch.Generator().manual_seed(SEED)).to(dev)
    with torch.no_grad():
        target = op(truth)
    state = {"v": truth * 0.5}

    def step():
        v = state["v"].detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(torch.mean((op(v) - target) ** 2), v)
        state["v"] = (v - 1e-3 * grad).detach()

    out["fused_step_ms"] = cuda_ms(step, n=30, warm=5)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", metavar="config",
                    help=f"of {CONFIGS} (default: all)")
    ap.add_argument("--public", action="store_true",
                    help="time only the public fused_fwd and the step")
    args = ap.parse_args(argv)
    for config in args.configs:
        if config not in CONFIGS:
            ap.error(f"unknown config {config!r}")
    if not torch.cuda.is_available():
        print("fused_sweep: no CUDA device available", file=sys.stderr)
        return 2
    if args.public:
        print(json.dumps(public()), flush=True)
        return 0
    bad = 0
    for config in args.configs or CONFIGS:
        for rec in sweep(config):
            bad += bool(rec.get("bad"))
            print(json.dumps(rec), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
