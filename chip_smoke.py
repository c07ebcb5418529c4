#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --profile DIR    # adds torch.profiler windows over
                                           # the routed and the fused step
                                           # and the solver runs; their
                                           # traces go to DIR

Phases (any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``sph_raytracer_tpu_torch/csrc`` (nvcc),
   with each source's seconds and ``-Xptxas -v`` register / spill lines;
3. the flagship operator: 50³ ``SphericalGrid``, a 50-view orbit of
   ``ConeRectGeom((50, 100))`` detectors (250,000 rays), ``mode='auto'``
   on CUDA (= routed), float32 — the configuration of ``bench.py``;
4. each kernel against its plain PyTorch version on the same CUDA tensors
   at the flagship's shapes, plus the adjoint identity; the global atomics
   ``routed_bwd_scatter`` issues (its own counts: one a distinct (ray tile,
   voxel) pair, plus any crossing that overflowed its tile's shared
   table) against one a crossing before the tiles; ``routed_fwd`` and
   ``routed_bwd_gather`` bitwise equal over two launches, and both, f32
   and bf16, on synthetic rows of 0 to 2,000 crossings at every start
   offset mod 4 (against their plain versions, run to run, adjoint with
   each partner) and refusing tables not on 16 B (``csr_walk_checks``);
5. goldens on the card: ``tests/goldens/collection_orbit.npz`` through the
   CUDA kernels (float64 trace, float32 tables), and the float32 routed
   ``Operator`` on the card against the same operator on the CPU;
6. the main path: ``retrieval.gd`` (FullyDenseModel + SquareLoss, Adam)
   for 20 iterations on the flagship, launch counters reset just before
   and read just after; then the ``routed_dense='off'`` path (scatter
   backward) the same way;
7. the ``bench.py`` training step (forward → MSE → grad → update) timed
   with CUDA events, and per-kernel times beside their plain versions,
   one PyTorch library call (``torch.sparse`` CSR mv) and the bound;
8. fused mode on the flagship, forward only: ``Operator(mode='fused')``
   builds no tables; the ``fused_fwd`` kernel against its plain version
   and against the routed kernel's image of the same rays, rays outside
   the tolerance counted (knife-edge midpoint ties), bitwise equal over
   two launches, its peak memory beside the routed tables' bytes;
9. fused mode's main path: ``retrieval.gd`` for 20 iterations through
   ``fused_fwd`` + ``routed_bwd_gather`` on lazily built backward-only
   tables, counters reset just before and read just after; then 5
   iterations with ``routed_dense='off'`` (``routed_bwd_scatter``);
10. the dynamic ``view_times`` configuration of
   ``examples/dynamic_measurements.py`` at full size (20 time bins of
   50³, 40 ``ConeCircGeom((100, 50))`` views, 200,000 rays): the lerp
   kernel against its plain version, bitwise equal over two launches, and
   one gradient through the lazy backward on the doubled tables;
11. fused timings: the fused training step first, then per config
   (flagship, ``view_times``) ``fused_fwd`` beside its plain version and
   its bound (operations: the shipped design's own count on this run's
   rays, ``tools.fused_sweep.shipped_ops``; the first port's full Mp-wide
   network, the TPU kernel's work, printed beside it), its rays by sort
   size S = 32 … 512 and the dense walk's mean steps; the shipped
   kernel's stage split at the flagship (``tools.fused_sweep``:
   crossings, sort, labels, the gather);
12. the routed engine's variants on the flagship, one ``Operator`` each
   (its setup seconds and table bytes printed): ``routed_dense='both'``
   (``routed_fwd_dense`` + ``routed_bwd_gather`` on the transpose alone),
   ``'fwd'`` (``routed_fwd_dense`` + ``routed_bwd_scatter``),
   ``routed_fwd_reduce='hist'`` (``routed_fwd_hist`` + the gather) and
   ``routed_banded=False`` (``routed_fwd_window`` + ``routed_bwd_window`` on
   the window chunk table).  ``routed_bwd_window``'s work items: their
   count, the largest, ``K``; ``routed_fwd_window``'s pieces: their count,
   the largest, ``KF``; ``routed_fwd_dense``'s global atomics at atomic
   width 1, 2 and 4 (counted from the table) against one a crossing;
   ``routed_fwd_hist``'s merge-path shares: their count, the most
   crossings and rays in one, ``HIST_SHARE``, its cut table's bytes.  From
   those operators' tables: each new
   kernel against its plain version, the adjoint identity of each pair,
   each variant's image against ``routed_fwd``'s; then ``retrieval.gd``
   for 5 iterations through each, counters reset just before and read
   just after;
13. variant timings: each config's training step, each new kernel beside
   its plain version, its bound and one PyTorch call (``torch.mv`` on the
   CSR of A, or of Aᵀ for ``routed_bwd_window``);
14. the window-major forward ``routed_fwd_densew`` (B8) on phase 12's
   chunk table (one CTA a work item of phase 12's): against its plain
   version, its image against ``routed_fwd``'s, the adjoint identity with
   ``routed_bwd_window``, its atomics counted from the table; then its path,
   ``tools.wfwd_probe.probe('vol100')`` (100³ grid, the flagship's views),
   counters reset just before and read just after, its setup seconds, and
   B8 there against its plain version and B1's image; B8's time beside its
   plain version, its bound and ``torch.mv`` at the flagship;
15. ``routed_w_dtype='bf16'`` on the flagship: for ``routed_dense``
   'auto', 'off', 'both', 'fwd', ``routed_fwd_reduce='hist'`` and fused
   mode, an f32 and a bf16 operator (setup seconds, table bytes and the
   build's peak device memory of each); each ``<name>_bf16`` kernel
   against its plain version on the bf16 tables, the bf16 image and
   ``.T`` against the f32 operator's (rtol 2e-2, the largest relative
   difference printed), the adjoint identity of each pair; ``retrieval.gd``
   for 5 iterations through each, counters reset just before and read
   just after (every bf16 entry of the pair launched, no f32 routed
   kernel); each config's bf16 and f32 step in turns.  B8 on the flagship
   chunk table in bf16, and its path ``tools.wfwd_probe.probe('vol100',
   w_dtype='bf16')``;
16. bf16 timings: each bf16 kernel beside its f32 kernel (same config, in
   turns), its plain version, its bound and ``torch.mv`` on the CSR of
   the widened weights (the same function; torch has no sparse mv of
   bf16 weights by an f32 vector);
17. the solver path on the flagship (``solver_checks``), on a smooth
   seeded phantom, counters reset just before and read just after each
   run and held to the formula the code gives: ``sart_preconditioner`` +
   30 iterations of ``solve.cg`` (B1 1 + 1 + 30 + 1, B2 1 + 2 + 30; the
   residual and the reprojection's misfit); 10 iterations of ``cg`` at
   ``'auto'`` against ``mode='precomputed'`` on the card (the plain
   table path, no kernel launched), x and each residual norm within 1e-3
   relative; ``solve.mlem`` on seeded Poisson counts, 20 sweeps (NLL
   non-increasing, x >= 0, its sensitivity ``op.T(ones)``, against
   ``'precomputed'`` at 1e-3) and OS-EM at 5 subsets for 4 sweeps (each
   sub-operator's setup seconds and table bytes, the summed sensitivity
   against ``op.T(ones)`` at rtol 1e-4); ``retrieval.gd`` with
   ``SphHarmModel(lmax=4)`` (coefficients (25, 50)) and with dict
   coefficients, ``cg`` in SphHarm coefficient space; ``cg`` through
   fused mode (B4 + B2) and ``routed_dense='off'`` (B1 + B3); then one
   ``cg`` iteration, one ``mlem`` sweep and one SphHarm ``gd`` step timed
   (CUDA events, the difference of two run lengths) beside phase 7's
   training step and the card's name and power limit: reported, not
   claimed.

18. the rest of the ``Operator`` surface (``surface_checks``), counters
   reset just before and read just after each path, their launches added
   to the kernels' line: ``routed_voxel_order='r'`` against ``'a'`` at
   ``'auto'`` on the flagship and on a 100³ grid (the image bitwise equal;
   the gradient and ``.T`` bitwise equal on every voxel whose row of the
   transpose starts at the same offset mod 4 in both tables, which fixes
   ``routed_bwd_gather``'s split of the row over its lanes, and within
   rtol 1e-5 elsewhere), ``'off'`` and ``routed_banded=False`` within rtol
   1e-5, B1 and B2 at ``'r'`` beside ``'a'`` in turns, each setup's
   seconds; ``regs`` (its warning, and ``pack_linear(regs)`` against the
   precomputed ``lin`` on 1,000 rays); ``Operator(debug=True)`` (the
   central LOS, its f64 lengths against ``op(ones)`` at rtol 1e-5) and the
   ``view_times`` operator's lerp header; ``with_payload(payload)`` for
   ``'auto'``, fused and ``'precomputed'`` (no allocation, bitwise equal
   forward, gradient and ``.T``); ``export_operator`` of the ``'auto'``
   forward and gradient step and of a fused forward, loaded in a fresh
   process that constructs no ``Operator``, traces nothing and builds no
   table (bitwise equal, one launch a kernel a call), the archives' bytes
   beside the tables'; ``plotting.preview3d`` of a seeded phantom, 50
   frames of 256x256, fused (B4) against ``'auto'`` (B1), and, where
   matplotlib is installed, ``image_stack`` and ``Operator.plot`` to PNG
   files; ``utils.profiling.time_fn`` of phase 7's step beside CUDA events
   and a ``trace`` of 5 steps that names ``routed_fwd``; ``autotune`` of
   the default candidates at the flagship (each candidate's ms a step, a
   second call reads the sidecar with no launch, ``cached_only`` on
   another geometry returns the base config, the chosen config's image
   within rtol 1e-5 of ``'auto'``'s) and of ``GRID_CANDIDATES`` on the
   100³ grid.

Before the last line: the card's name and power limit, then the
``{"kernels": [...]}`` line (15 kernels: 9 f32, 6 bf16); the last line is
``{"ok": true, "device": {...}}``.  The run's wall seconds, and its
seconds by phase, are printed before them.  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside tensor cores
REPLACES = {
    "routed_fwd": "sph_raytracer_tpu/ops/routed_project.py:581",
    "routed_bwd_gather": "sph_raytracer_tpu/ops/routed_project.py:905",
    "routed_bwd_scatter": "sph_raytracer_tpu/ops/routed_project.py:1142",
    "fused_fwd": "sph_raytracer_tpu/ops/fused_pallas.py:138",
    "routed_fwd_dense": "sph_raytracer_tpu/ops/routed_project.py:820",
    "routed_fwd_hist": "sph_raytracer_tpu/ops/routed_project.py:670",
    "routed_fwd_window": "sph_raytracer_tpu/ops/routed_project.py:200",
    "routed_bwd_window": "sph_raytracer_tpu/ops/routed_project.py:312",
    "routed_fwd_densew": "sph_raytracer_tpu/ops/routed_project.py:1041",
}
SOURCE = "sph_raytracer_tpu_torch/csrc/routed_project.cu"
FUSED_SOURCE = "sph_raytracer_tpu_torch/csrc/fused_project.cu"
VARIANTS_SOURCE = "sph_raytracer_tpu_torch/csrc/routed_variants.cu"
# kernel vs plain version, and fused vs routed image (two f32 traces): a
# ray whose segment midpoint lies on a boundary may label either
# neighbour (fused_pallas.py:32-38); at most this share of rays may
# miss the tolerance, and each run prints how many did and by how much
KNIFE_KERNEL = 1e-4
KNIFE_ROUTED = 1e-3


def log(*a):
    print(*a, flush=True)


def check_close(name, got, want, rtol, atol):
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    n_bad = int((diff > atol + rtol * want.double().abs()).sum())
    ok = n_bad == 0
    log(f"[check] {name}: max_abs_err={err:.3e}, {n_bad} of {got.numel()} "
        f"outside (rtol={rtol}, atol={atol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its reference")
    return err


def check_rays(name, got, want, rtol, atol, allow_frac):
    """Per-ray check that lets at most ``allow_frac`` of the rays miss the
    tolerance (knife-edge labels); prints how many did and by how much."""
    diff = (got.double() - want.double()).abs()
    bad = diff > atol + rtol * want.double().abs()
    n_bad, allow = int(bad.sum()), int(allow_frac * got.numel())
    err = float(diff.max())
    worst = float(diff[bad].max()) if n_bad else 0.0
    log(f"[check] {name}: max_abs_err={err:.3e}; {n_bad} of {got.numel()} "
        f"rays outside rtol={rtol}, atol={atol:.3e} (largest miss "
        f"{worst:.3e}, at most {allow} allowed) "
        f"{'ok' if n_bad <= allow else 'FAIL'}")
    if n_bad > allow:
        raise AssertionError(f"{name}: {n_bad} rays outside the tolerance")
    return err


def fused_ops(gs, n_rays, mp, live, lerp):
    """f32 operations (arithmetic, compares, min/max) of ``fused_fwd`` as
    first ported (one lane a row, the full Mp-wide sort): the per-ray
    prologue (30), a sphere row (4), a cone row (38), an azimuth row (25),
    the bitonic network (Mp·L(L+1)/4 compare-exchanges of 2 ops,
    L = log2 Mp), 5 per sorted element (length, live test), the warp
    reduce (5 adds on 32 lanes); per live segment the midpoint and |p| (14), the three 7-step
    searches (7 + 14 + 35) and the gather-multiply-add (2, lerp 7)."""
    L = mp.bit_length() - 1
    per_ray = (30 + 4 * 2 * (gs.nr + 1) + 38 * 2 * (gs.ne + 1)
               + 25 * (gs.na + 1) + mp * L * (L + 1) // 2 + 5 * mp + 160)
    return n_rays * per_ray + live * (14 + 56 + (7 if lerp else 2))


def fused_bytes(n_rays, n_flat, off0, lerp):
    """Bytes ``fused_fwd`` must move: xs, dirs (12 B each), y (4 B),
    off0 / off1 / w (4 B each where present) per ray, the density and
    the 5,120 B boundary table once."""
    per_ray = 28 + 4 * off0 + 8 * lerp
    return n_rays * per_ray + 4 * n_flat + 5120


def csr_walk_checks(torch, rp, csr_case, dev):
    """``routed_fwd`` (B1) and ``routed_bwd_gather`` (B2), f32 and bf16, on
    rows of 0 to 2,000 crossings at every start offset mod 4
    (``tools.bwd_sweep.csr_case``) at R = V ≡ 1, 2, 3 (mod 32): against
    their plain versions at rtol 1e-5, bitwise equal over two launches,
    adjoint (rel ≤ 1e-8, x, y ≥ 0) with B2 and B3 (B1) and with B5 and B6
    (B2) on the same rounded lengths; then each refuses an index or weight
    table that does not start on 16 B."""
    for w_dtype in (torch.float32, torch.bfloat16):
        for residue in (1, 2, 3):
            n = 80000 + residue
            lin, lens = csr_case(residue, n, n, dev)
            t = rp.build_tables(lin, lens, n, w_dtype=w_dtype)
            del lin, lens
            gen = torch.Generator().manual_seed(residue)
            x = torch.rand(n, generator=gen).to(dev)
            y = torch.rand(n, generator=gen).to(dev)
            for kern, inp in ((rp.routed_fwd, x), (rp.routed_bwd_gather, y)):
                name = rp._entry(kern.__name__, t.val)
                got = kern(t, inp)
                want = getattr(rp, f"{kern.__name__}_ref")(t, inp)
                check_close(f"{name} rows of 0-2,000 (R = V = {n})", got,
                            want, 1e-5, 1e-5 * float(want.abs().max()))
                if not torch.equal(got, kern(t, inp)):
                    raise AssertionError(f"{name} differs run to run")
            rels = []
            ax = float(torch.dot(rp.routed_fwd(t, x).double(), y.double()))
            aty = float(torch.dot(x.double(),
                                  rp.routed_bwd_gather(t, y).double()))
            for fwd, bwd in ((rp.routed_fwd, rp.routed_bwd_gather),
                             (rp.routed_fwd, rp.routed_bwd_scatter),
                             (rp.routed_fwd_dense, rp.routed_bwd_gather),
                             (rp.routed_fwd_hist, rp.routed_bwd_gather)):
                lhs = ax if fwd is rp.routed_fwd else float(
                    torch.dot(fwd(t, x).double(), y.double()))
                rhs = aty if bwd is rp.routed_bwd_gather else float(
                    torch.dot(x.double(), bwd(t, y).double()))
                rels.append(abs(lhs - rhs) / abs(lhs))
                if not rels[-1] <= 1e-8:
                    raise AssertionError(f"adjoint identity fails for "
                                         f"{fwd.__name__}/{bwd.__name__}")
            log(f"[check] {w_dtype} R = V = {n}: both bitwise equal run to "
                f"run; adjoint rel B1/B2 {rels[0]:.3e}, B1/B3 {rels[1]:.3e},"
                f" B5/B2 {rels[2]:.3e}, B6/B2 {rels[3]:.3e}")
    before = dict(rp.LAUNCHES)
    for kern, inp, names in ((rp.routed_fwd, x, ("col", "val")),
                             (rp.routed_bwd_gather, y, ("ray", "valT"))):
        for name in names:
            a = getattr(t, name)
            buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
            buf[1:] = a
            try:
                kern(t._replace(**{name: buf[1:]}), inp)
            except ValueError:
                continue
            raise AssertionError(f"{kern.__name__} took a {name} table 4 B "
                                 "past a 16 B boundary")
    if dict(rp.LAUNCHES) != before:
        raise AssertionError("a refused table launched a kernel")
    log("[check] routed_fwd / routed_bwd_gather refuse tables not on 16 B")


def orbit(prt, views, det, z=0.3):
    return sum(prt.ConeRectGeom(det, pos=(2 * np.cos(t), 2 * np.sin(t), z),
                                fov=(45, 45))
               for t in np.linspace(0, 2 * np.pi, views, endpoint=False))


def smooth_phantom(grid, seed):
    """A smooth positive volume made from a seed: 0.05 plus four Gaussian
    blobs (seeded centers inside the grid, widths 0.15-0.35 of its outer
    radius) at the voxel centers."""
    rng = np.random.default_rng(seed)
    r, e, a = np.meshgrid(grid.r, grid.e, grid.a, indexing="ij")
    xyz = np.stack([r * np.sin(e) * np.cos(a), r * np.sin(e) * np.sin(a),
                    r * np.cos(e)], -1)
    rmax = float(grid.r_b[-1])
    vol = np.full(r.shape, 0.05)
    for _ in range(4):
        c = rng.uniform(-0.5, 0.5, 3) * rmax
        w = rng.uniform(0.15, 0.35) * rmax
        vol += np.exp(-((xyz - c) ** 2).sum(-1) / (2 * w * w))
    return vol


def solver_checks(torch, prt, rp, op, opf, dev, timer, step, label):
    """The solver path (``solve.cg``, ``sart_preconditioner``, ``mlem`` /
    OS-EM, ``SphHarmModel``) on ``op`` ('auto': B1 + B2) and ``opf``
    (fused: B4 + B2): each run's launches held to the formula the code
    gives (counters set to 0 just before, read just after), ``'auto'``
    against ``mode='precomputed'`` (plain PyTorch) on the same device at
    ≤ 1e-3 relative, then the timings, printed beside ``label`` (the
    card's name and power limit) and ``step`` (phase 7's training step).
    Reported, not claimed.  ``timer(fn)`` gives a call's milliseconds.
    Returns the solver runs that ``--profile`` traces, by name."""
    from sph_raytracer_tpu_torch import solve
    from sph_raytracer_tpu_torch.models import SphHarmModel

    grid, geom = op.grid, op.geom

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def launches(name, fn, want):
        """Run ``fn`` with the counters set to 0 just before and read just
        after; every kernel in ``want`` launched that often, no other."""
        sync()
        rp.reset_launches()
        out = fn()
        sync()
        got = {k: v for k, v in rp.LAUNCHES.items() if v}
        log(f"[solver {name}] launches {got}, want {want}")
        if got != want:
            raise AssertionError(f"{name}: launches {got}, want {want}")
        return out

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.double() - b.double())
                     / torch.linalg.vector_norm(b.double()))

    def check_rel(name, a, b, bound=1e-3):
        err = rel(a, b)
        log(f"[solver {name}] relative L2 {err:.3e} (bound {bound})")
        if not err <= bound:
            raise AssertionError(f"{name}: relative L2 {err} > {bound}")

    def check_hist(name, a, b, bound=1e-3):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = float(np.max(np.abs(a - b) / np.abs(b))) if len(a) else 0.0
        log(f"[solver {name}] largest relative difference {err:.3e} over "
            f"{len(a)} entries (bound {bound})")
        if len(a) != len(b) or not err <= bound:
            raise AssertionError(f"{name}: history differs: {err}")

    fwd, bwd = rp.routed_fwd.__name__, rp.routed_bwd_gather.__name__
    truth = torch.tensor(smooth_phantom(grid, 17), dtype=torch.float32,
                         device=dev)
    with torch.no_grad():
        y = op(truth)
    op_pre = prt.Operator(grid, geom, mode="precomputed", device=dev)

    # a. SART-preconditioned cg, 30 iterations: the preconditioner's
    # forward and adjoint, cg's init (one forward, two adjoints), one of
    # each an iteration, the reprojection's forward
    n = 30

    def cg_a():
        P = solve.sart_preconditioner(op)
        return solve.cg(op, y, num_iterations=n, damp=1e-3, precond=P)

    x, reproj, info = launches("cg", cg_a, {fwd: 1 + 1 + n + 1,
                                            bwd: 1 + 2 + n})
    rn = info["rnorm"]
    misfit = rel(reproj, y)
    log(f"[solver cg] rnorm[0] {rn[0]:.6g}, rnorm[-1] {rn[-1]:.6g}, "
        f"bnorm {info['bnorm']:.6g}, iterations {info['iterations']}, "
        f"reprojection misfit {misfit:.6g}")
    if not (len(rn) == n and info["iterations"] == n
            and np.all(np.isfinite(rn)) and rn[-1] < 1e-2 * rn[0]
            and bool(torch.isfinite(x).all()) and misfit < 0.05):
        raise AssertionError("cg did not converge")

    # b. the same solve on the plain table path, 10 iterations
    n = 10
    xa, _, ia = launches("cg auto", lambda: solve.cg(
        op, y, num_iterations=n, damp=1e-3), {fwd: 1 + n + 1, bwd: 2 + n})
    xp, _, ip = launches("cg precomputed", lambda: solve.cg(
        op_pre, y, num_iterations=n, damp=1e-3), {})
    check_rel("cg auto vs precomputed x", xa, xp)
    check_hist("cg auto vs precomputed rnorm", ia["rnorm"], ip["rnorm"])

    # c. mlem on seeded Poisson counts, 20 sweeps: the sensitivity's
    # forward and adjoint, one of each a sweep, the reprojection
    scale = 500.0
    counts = torch.tensor(np.random.default_rng(18).poisson(
        scale * y.double().cpu().numpy()), device=dev)
    n = 20
    xm, _, im = launches("mlem", lambda: solve.mlem(
        op, counts, num_iterations=n, scale=scale),
        {fwd: 1 + n + 1, bwd: 1 + n})
    nll = im["nll"]
    ones = torch.ones(tuple(geom.shape), device=dev)
    sens = op.T(ones)
    log(f"[solver mlem] nll {nll[0]:.8g} -> {nll[-1]:.8g}, x in "
        f"[{float(xm.min()):.4g}, {float(xm.max()):.4g}]")
    if not (len(nll) == n and np.all(nll[1:] <= nll[:-1] * (1 + 1e-6))
            and bool((xm >= 0).all())
            and torch.equal(im["sensitivity"], sens)):
        raise AssertionError("mlem: NLL rose, x < 0 or sensitivity wrong")
    xmp, _, imp = launches("mlem precomputed", lambda: solve.mlem(
        op_pre, counts, num_iterations=n, scale=scale), {})
    check_rel("mlem auto vs precomputed x", xm, xmp)
    check_hist("mlem auto vs precomputed nll", nll, imp["nll"])

    class TimedOperator(prt.Operator):
        """An Operator that records each construction's seconds and table
        bytes: OS-EM builds its sub-operators as ``type(f)(...)``."""
        built = []

        def __init__(self, *args, **kw):
            sync()
            t0 = time.time()
            super().__init__(*args, **kw)
            sync()
            self.built.append((time.time() - t0, self._nrays,
                               self._tables.nbytes))

    op_t = TimedOperator(grid, geom, config=op.config, device=dev)
    k, n = 5, 4  # subsets, sweeps
    xo, _, io = launches("osem", lambda: solve.mlem(
        op_t, counts, num_iterations=n, scale=scale, subsets=k),
        {fwd: k + k * n + 1, bwd: k + k * n})
    for i, (sec, rays, nb) in enumerate(TimedOperator.built[1:]):
        log(f"[solver osem] sub-operator {i}: setup {sec:.3f} s, {rays} "
            f"rays, table bytes {nb}")
    log(f"[solver osem] nll {io['nll'][0]:.8g} -> {io['nll'][-1]:.8g}")
    check_close("osem summed sensitivity vs op.T(ones)",
                io["sensitivity"], sens, 1e-4,
                1e-4 * float(sens.abs().max()))
    if not (len(TimedOperator.built) == 1 + k and bool((xo >= 0).all())):
        raise AssertionError("osem: sub-operators or x < 0")
    del op_t

    # d. models: SphHarm gd (coefficients (25, 50)) and cg, dict gd
    sph = SphHarmModel(grid, lmax=4, device=dev)
    if sph.coeffs_shape != (25, grid.shape[0]):
        raise AssertionError(f"SphHarm coeffs {sph.coeffs_shape}")
    n = 20
    _, _, lh = launches("sphharm gd", lambda: prt.retrieval.gd(
        op, y, sph, num_iterations=n, progress_bar=False),
        {fwd: n + 1, bwd: n})
    h = next(iter(lh.values()))
    log(f"[solver sphharm gd] loss {h[0]:.6g} -> {h[-1]:.6g}")
    if not (len(h) == n and np.all(np.isfinite(h)) and h[-1] < h[0]):
        raise AssertionError("SphHarm gd: the loss did not fall")
    n = 10
    cs, _, ics = launches("sphharm cg", lambda: solve.cg(
        op, y, model=sph, num_iterations=n), {fwd: 1 + n + 1, bwd: 2 + n})
    log(f"[solver sphharm cg] rnorm {ics['rnorm'][0]:.6g} -> "
        f"{ics['rnorm'][-1]:.6g}")
    if not (tuple(cs.shape) == sph.coeffs_shape
            and ics["rnorm"][-1] < ics["rnorm"][0]):
        raise AssertionError("SphHarm cg: the residual did not fall")

    class Scaled(prt.models.Model):
        def __init__(self, grid):
            self.grid = grid

        def __call__(self, c):
            return c["vol"] * c["scale"]

    init = {"vol": torch.full(tuple(grid.shape), 0.5, device=dev),
            "scale": torch.ones((), device=dev)}
    n = 5
    cd, _, ld = launches("dict gd", lambda: prt.retrieval.gd(
        op, y, Scaled(grid), coeffs=init, num_iterations=n, lr=0.05,
        progress_bar=False), {fwd: n + 1, bwd: n})
    h = next(iter(ld.values()))
    log(f"[solver dict gd] loss {h[0]:.6g} -> {h[-1]:.6g}, scale "
        f"{float(cd['scale']):.6g}")
    if not (set(cd) == {"vol", "scale"} and h[-1] < h[0]):
        raise AssertionError("dict gd: the loss did not fall")

    # e. the other kernel pairs: fused (B4 + B2 on the backward-only
    # tables), routed_dense='off' (B1 + B3)
    n = 10
    _, _, ifu = launches("cg fused", lambda: solve.cg(
        opf, y, num_iterations=n, damp=1e-3),
        {"fused_fwd": 1 + n + 1, bwd: 2 + n})
    op_off = prt.Operator(grid, geom, device=dev,
                          config=op.config.replace(routed_dense="off"))
    _, _, ioff = launches("cg off", lambda: solve.cg(
        op_off, y, num_iterations=n, damp=1e-3),
        {fwd: 1 + n + 1, rp.routed_bwd_scatter.__name__: 2 + n})
    for name, i in (("fused", ifu), ("off", ioff)):
        check_hist(f"cg {name} vs precomputed rnorm", i["rnorm"],
                   ip["rnorm"], 1e-2)
    del op_off

    # f. times: the difference of two runs over the difference of their
    # iterations (init and reprojection cancel), beside phase 7's step
    def per_iter(run, n0, n1):
        return (timer(lambda: run(n1)) - timer(lambda: run(n0))) / (n1 - n0)

    times = {
        "cg iteration": per_iter(lambda k: solve.cg(
            op, y, num_iterations=k, damp=1e-3), 10, 30),
        "mlem sweep": per_iter(lambda k: solve.mlem(
            op, counts, num_iterations=k, scale=scale), 5, 15),
        "SphHarm gd step": per_iter(lambda k: prt.retrieval.gd(
            op, y, sph, num_iterations=k, progress_bar=False), 5, 15),
        "FullyDense gd step": per_iter(lambda k: prt.retrieval.gd(
            op, y, prt.models.FullyDenseModel(grid), coeffs=truth,
            num_iterations=k, progress_bar=False), 5, 15),
        "training step (phase 7's)": timer(step),
    }
    c = torch.ones(sph.coeffs_shape, device=dev, requires_grad=True)
    times["SphHarm model forward + backward"] = timer(
        lambda: torch.autograd.grad(sph(c).sum(), c))
    for name, ms in times.items():
        log(f"[solver time] {name}: {ms:.4f} ms ({label})")
    # what --profile traces: 10 iterations of each loop timed above
    return {
        "cg_10_iterations": lambda: solve.cg(op, y, num_iterations=10,
                                             damp=1e-3),
        "mlem_10_sweeps": lambda: solve.mlem(op, counts, num_iterations=10,
                                             scale=scale),
        "sphharm_gd_10_steps": lambda: prt.retrieval.gd(
            op, y, sph, num_iterations=10, progress_bar=False),
    }


# the export check's fresh process: constructs no Operator, traces nothing,
# builds no table (each of those raises there), loads the archives named on
# its command line and holds each output to the live operator's, bitwise
EXPORT_CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import fused_project, project, trace
from sph_raytracer_tpu_torch.ops import routed_project as rp


def refuse(*a, **k):
    raise AssertionError("the exported program traced or built something")


prt.Operator.__init__ = refuse
for mod, name in ((trace, "trace_crossings"), (project, "trace_crossings"),
                  (project, "precompute_table"),
                  (fused_project, "trace_crossings"),
                  (prt.operator, "precompute_table"),
                  (prt.operator, "trace_crossings"),
                  (prt.operator, "build_for"), (rp, "build_for"),
                  (rp, "build_tables"), (rp, "build_window_tables")):
    setattr(mod, name, refuse)
from sph_raytracer_tpu_torch.utils.export import load_exported

dev = sys.argv[2]
data = torch.load(sys.argv[3], map_location=dev, weights_only=True)
out = {}
for name, path in json.loads(sys.argv[4]).items():
    t0 = time.time()
    f = load_exported(path, device=dev)
    load_s = time.time() - t0
    args = (data["x"], data["y"]) if name == "grad_step" else (data["x"],)
    if dev == "cuda":
        torch.cuda.synchronize()
    rp.reset_launches()
    got = f(*args)
    if dev == "cuda":
        torch.cuda.synchronize()
    out[name] = {"load_s": load_s,
                 "equal": bool(torch.equal(got, data[name])),
                 "launches": {k: v for k, v in rp.LAUNCHES.items() if v}}
print(json.dumps(out))
"""


def plot_pngs(plotting, op, image):
    """``plotting.image_stack`` of ``image`` and ``op.plot()`` written to
    PNG files with the Agg backend; fails on an empty file."""
    import tempfile
    import warnings

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with tempfile.TemporaryDirectory() as tdir:
        files = {"image_stack.png": lambda: plotting.image_stack(
            image, colorbar=True), "operator_plot.png": op.plot}
        for fname, draw in files.items():
            with warnings.catch_warnings():
                # Operator.plot of a collection returns an animation, saved
                # here as one still frame
                warnings.filterwarnings("ignore", "Animation was deleted")
                art = draw()
                plt.savefig(os.path.join(tdir, fname))
                plt.close("all")
                del art
            size = os.path.getsize(os.path.join(tdir, fname))
            log(f"[surface plot] {fname}: {size} B")
            if not size > 0:
                raise AssertionError(f"{fname} is empty")


def surface_checks(torch, prt, rp, op, opd, big_grid, dev, timer, step,
                   label, preview=(256, 256)):
    """Phase 18: the rest of the ``Operator`` surface and the modules on it,
    at ``op``'s size (``'auto'``: B1 + B2), ``opd`` a ``view_times``
    operator and ``big_grid`` a denser grid for the voxel orders.  Each
    path's launches are counted with the counters set to 0 just before and
    read just after; returns their sums by kernel.  ``timer(fn)`` gives a
    call's milliseconds; ``step`` is phase 7's training step; ``preview``
    the image shape of ``preview3d``."""
    import contextlib
    import importlib.util
    import io
    import tempfile
    import warnings

    from sph_raytracer_tpu_torch import plotting
    from sph_raytracer_tpu_torch.ops.trace import (pack_linear,
                                                   voxel_order_flat,
                                                   voxel_order_lin)
    from sph_raytracer_tpu_torch.utils import profiling
    from sph_raytracer_tpu_torch.utils.debug import debug_trace
    from sph_raytracer_tpu_torch.utils.export import export_operator

    grid, geom = op.grid, op.geom
    gshape, R = tuple(grid.shape), op._nrays
    total = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def counted(name, fn):
        """``fn()`` with the counters set to 0 just before and read just
        after; adds them to the phase's sums."""
        sync()
        rp.reset_launches()
        out = fn()
        sync()
        got = {k: v for k, v in rp.LAUNCHES.items() if v}
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        log(f"[surface {name}] launches {got}")
        return out, got

    def built(name, *args, **kw):
        sync()
        t0 = time.time()
        o = prt.Operator(*args, device=dev, **kw)
        sync()
        log(f"[surface {name}] setup {time.time() - t0:.3f} s")
        return o

    gen = torch.Generator().manual_seed(18)
    x = torch.rand(gshape, generator=gen).to(dev)
    yt = torch.rand(tuple(geom.shape), generator=gen).to(dev)

    def fgt(o, xx=x, yy=yt):
        """(image, gradient of mean((image - y)**2), op.T(y)), flat."""
        v = xx.clone().requires_grad_(True)
        img = o(v)
        (g,) = torch.autograd.grad(torch.mean((img - yy) ** 2), v)
        return img.detach().reshape(-1), g.reshape(-1), o.T(yy).reshape(-1)

    # a. routed_voxel_order='r' against 'a' ------------------------------
    # B1 reads the same ray-major rows, relabelled: the image is bitwise
    # equal.  B2 splits a voxel's row over its lanes by the row's start
    # mod 4, which the relabel moves: bitwise equal where the start mod 4
    # is the same (or the row holds at most one crossing), elsewhere the
    # same sum in another order (rtol 1e-5)
    def same_start(ta, tr, vshape):
        ids = torch.arange(ta.n_vox, dtype=torch.int32, device=dev)
        rid = voxel_order_lin(ids, vshape, "r").long()
        return ((ta.vox_ptr[:-1] % 4 == tr.vox_ptr[:-1][rid] % 4)
                | (torch.diff(ta.vox_ptr) <= 1))

    def order_check(name, op_a, op_r, xx, yy):
        a = fgt(op_a, xx, yy)
        r, _ = counted(f"r {name}", lambda: fgt(op_r, xx, yy))
        if not torch.equal(r[0], a[0]):
            raise AssertionError(f"{name}: 'r' image differs from 'a'")
        same = same_start(op_a._tables, op_r._tables, op_a.grid.vshape)
        for what, got, want in (("gradient", r[1], a[1]),
                                (".T", r[2], a[2])):
            if not torch.equal(got[same], want[same]):
                raise AssertionError(f"{name} {what}: 'r' differs from 'a' "
                                     "on a voxel whose row starts at the "
                                     "same offset mod 4")
            n_diff = int((got != want).sum())
            log(f"[surface r {name}] image bitwise equal; {what} bitwise "
                f"equal on {int(same.sum())} of {same.numel()} voxels (same "
                f"row start mod 4, or at most one crossing); {n_diff} "
                "voxels differ in all")
            check_close(f"'r' {name} {what} vs 'a'", got, want, 1e-5,
                        1e-6 * float(want.abs().max()))

    op_r = built("r auto", grid, geom, config=prt.TraceConfig(
        mode="routed", routed_voxel_order="r"))
    order_check("flagship auto", op, op_r, x, yt)
    for name, cfg in (("off", dict(routed_dense="off")),
                      ("window", dict(routed_banded=False))):
        op_va = built(f"a {name}", grid, geom, config=prt.TraceConfig(
            mode="routed", **cfg))
        op_vr = built(f"r {name}", grid, geom, config=prt.TraceConfig(
            mode="routed", routed_voxel_order="r", **cfg))
        a = fgt(op_va)
        r, _ = counted(f"r {name}", lambda: fgt(op_vr))
        for what, got, want in zip(("image", "gradient", ".T"), r, a):
            check_close(f"'r' {name} {what} vs 'a'", got, want, 1e-5,
                        1e-6 * float(want.abs().max()))
        del op_va, op_vr

    def order_times(name, op_a, op_r):
        ta, tr = op_a._tables, op_r._tables
        da = torch.rand(ta.n_vox, generator=gen).to(dev)
        dr = voxel_order_flat(da, op_a.grid.vshape, "r").contiguous()
        dy_ = torch.randn(R, generator=gen).to(dev)
        runs = {("B1", "a"): lambda: rp.routed_fwd(ta, da),
                ("B1", "r"): lambda: rp.routed_fwd(tr, dr),
                ("B2", "a"): lambda: rp.routed_bwd_gather(ta, dy_),
                ("B2", "r"): lambda: rp.routed_bwd_gather(tr, dy_)}
        for kern in ("B1", "B2"):
            ms = [timer(runs[kern, vo]) for vo in "arra"]
            log(f"[surface r {name}] {kern}: 'a' {ms[0]:.4f} / {ms[3]:.4f} "
                f"ms, 'r' {ms[1]:.4f} / {ms[2]:.4f} ms (in turns a, r, r, a; "
                f"{label})")

    order_times("flagship", op, op_r)
    del op_r
    big = {vo: built(f"{vo} vol100", big_grid, geom, config=prt.TraceConfig(
        mode="routed", routed_voxel_order=vo)) for vo in "ar"}
    xb = torch.rand(tuple(big_grid.shape), generator=gen).to(dev)
    order_check("vol100 auto", big["a"], big["r"], xb, yt)
    order_times("vol100", big["a"], big["r"])
    del big, xb

    # b. regs -------------------------------------------------------------
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        regs = op.regs
    if not any("regs materializes" in str(w.message) for w in caught):
        raise AssertionError("regs did not warn at the flagship")
    M = op.gs.num_crossings
    log(f"[surface regs] {tuple(regs.shape)} {regs.dtype}, "
        f"{regs.numel() * regs.element_size()} B; warned: "
        f"{next(str(w.message) for w in caught)[:80]}")
    packed = pack_linear(regs, op.gs).reshape(R, M)
    del regs
    opp = built("precomputed", grid, geom, mode="precomputed")
    rows = torch.randperm(R, generator=gen)[:1000].to(dev)
    live = opp.lens[rows] > 0
    if not (torch.equal(packed[rows][live], opp.lin[rows][live])
            and int(live.sum()) > 0):
        raise AssertionError("pack_linear(regs) differs from the "
                             "precomputed table")
    log(f"[surface regs] pack_linear(regs) equals Operator(mode="
        f"'precomputed').lin on {int(live.sum())} live crossings of 1000 "
        "sampled rays")
    del packed

    # c. debug --------------------------------------------------------------
    # Operator(debug=True) prints the central LOS; the view_times LOS is
    # the middle view's brightest pixel under op(ones) (the central one of
    # its circular detectors misses the grid)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        opg = prt.Operator(grid, geom, device=dev, debug=True)
    printed = buf.getvalue()
    for name, o in (("flagship", opg), ("view_times", opd)):
        with torch.no_grad():
            ones = o(torch.ones(tuple(o.grid.shape), device=dev))
        los = tuple(s // 2 for s in o.geom.shape)
        if name == "view_times":
            v = los[0]
            los = (v, *np.unravel_index(int(torch.argmax(ones[v])),
                                        tuple(ones.shape[1:])))
        los = tuple(int(i) for i in los)
        _, lens, _ = debug_trace(o, los, out=(buf := io.StringIO()))
        text = buf.getvalue()
        if name == "flagship" and printed != text:
            raise AssertionError("Operator(debug=True) printed another "
                                 "table than debug_trace")
        at = float(ones[los])
        head = text.split("\n idx")[0].splitlines()  # above the table
        log(f"[surface debug {name}] " + " | ".join(head))
        err = abs(float(lens.sum()) - at) / abs(at) if at else float("inf")
        log(f"[surface debug {name}] sum of the f64 trace's lengths "
            f"{float(lens.sum()):.7g}, op(ones) there {at:.7g} (f32 kernel), "
            f"relative {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"debug {name}: lengths disagree")
        if name == "view_times" and not any(
                h.startswith("time lerp:") for h in head):
            raise AssertionError("the view_times LOS printed no lerp header")
    del opg

    # d. payload / with_payload ------------------------------------------
    opf2 = built("fused", grid, geom, mode="fused")
    for name, o in (("auto", op), ("fused", opf2), ("precomputed", opp)):
        pl = o.payload
        sync()
        before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        o2 = o.with_payload(pl)
        sync()
        after = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        # the precomputed gradient scatters by atomics: made deterministic
        # for this comparison
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(was or name == "precomputed")
        try:
            want = fgt(o)
            got, _ = counted(f"with_payload {name}", lambda: fgt(o2))
        finally:
            torch.use_deterministic_algorithms(was)
        nbytes = sum(t.numel() * t.element_size() for v in pl.values()
                     for t in (v if isinstance(v, tuple) else (v,))
                     if isinstance(t, torch.Tensor))
        log(f"[surface payload {name}] keys {sorted(pl)}, {nbytes} B; "
            f"with_payload allocated {after - before} B")
        if after != before or not all(torch.equal(a, b)
                                      for a, b in zip(got, want)):
            raise AssertionError(f"with_payload {name}: allocated or differs")

    # e. export, loaded in a fresh process --------------------------------
    with tempfile.TemporaryDirectory() as tdir:
        paths = {n: os.path.join(tdir, f"{n}.zip")
                 for n in ("forward", "grad_step", "fused_forward")}
        export_operator(op, paths["forward"], what="forward")
        export_operator(op, paths["grad_step"], what="grad_step", loss_y=yt)
        export_operator(opf2, paths["fused_forward"], what="forward")
        img, g, _ = fgt(op)
        with torch.no_grad():
            fimg = opf2(x)
        torch.save({"x": x, "y": yt, "forward": img.reshape(geom.shape),
                    "grad_step": g.reshape(gshape),
                    "fused_forward": fimg},
                   os.path.join(tdir, "io.pt"))
        for n, pth in paths.items():
            tb = (opf2._fused_btd if n.startswith("fused") else op._tables)
            log(f"[surface export] {n}: archive {os.path.getsize(pth)} B, "
                f"tables {tb.nbytes} B")
        t0 = time.time()
        child = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, HERE, dev.type,
             os.path.join(tdir, "io.pt"), json.dumps(paths)],
            capture_output=True, text=True, timeout=300)
    if child.returncode != 0:
        raise AssertionError(f"export child failed:\n{child.stderr}")
    res = json.loads(child.stdout.strip().splitlines()[-1])
    want = {"forward": {"routed_fwd": 1},
            "grad_step": {"routed_fwd": 1, "routed_bwd_gather": 1},
            "fused_forward": {"fused_fwd": 1}}
    for n, r in res.items():
        log(f"[surface export] {n} in a fresh process (no Operator, no "
            f"trace, no table build): load {r['load_s']:.3f} s, bitwise "
            f"equal {r['equal']}, launches {r['launches']}")
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
        if not r["equal"] or (dev.type == "cuda" and r["launches"] != want[n]):
            raise AssertionError(f"exported {n}: differs or launched "
                                 f"{r['launches']}")
    log(f"[surface export] child process {time.time() - t0:.1f} s")

    # f. preview3d, image_stack and Operator.plot -------------------------
    vol = smooth_phantom(grid, 17)
    frames = gshape[-1]
    prev = {}
    for mode, kern in (("fused", "fused_fwd"), ("auto", "routed_fwd")):
        t0 = time.time()
        prev[mode], got = counted(f"preview3d {mode}", lambda: (
            plotting.preview3d(vol, grid, shape=preview, mode=mode,
                               device=dev)))
        ms = (time.time() - t0) * 1e3
        log(f"[surface preview3d] mode={mode}: {ms:.1f} ms for {frames} "
            f"frames of {preview} (operator construction included; "
            f"{label})")
        if prev[mode].shape != (frames, *preview) or (
                dev.type == "cuda" and got.get(kern) != frames):
            raise AssertionError(f"preview3d {mode}: shape or launches")
    pf, pa = (torch.from_numpy(prev[m]) for m in ("fused", "auto"))
    filled = pa > 0
    check_rays("preview3d fused vs auto, filled pixels", pf[filled],
               pa[filled], 1e-4, 2e-5, KNIFE_ROUTED)
    # image_stack and Operator.plot draw on the host with matplotlib, which
    # the card's machine may lack (preview3d above needs none of it)
    if importlib.util.find_spec("matplotlib") is None:
        log("[surface plot] matplotlib is not installed here: image_stack "
            "and Operator.plot not rendered (host-side drawing; "
            "tests/test_torch_surface.py renders both on the CPU)")
    else:
        plot_pngs(plotting, op, prev["fused"][0])

    # g. profiling ----------------------------------------------------------
    fn_ms = profiling.time_fn(step, iters=20) * 1e3
    log(f"[surface profiling] time_fn of phase 7's step {fn_ms:.4f} ms, "
        f"CUDA events {timer(step):.4f} ms ({label})")
    with tempfile.TemporaryDirectory() as tdir:
        def five():
            with profiling.trace(tdir):
                for _ in range(5):
                    step()

        counted("profiling trace", five)
        (fname,) = os.listdir(tdir)
        with open(os.path.join(tdir, fname)) as fh:
            body = fh.read()
        log(f"[surface profiling] trace {fname}: {len(body)} B, names "
            f"routed_fwd {'routed_fwd' in body}")
        if dev.type == "cuda" and "routed_fwd" not in body:
            raise AssertionError("the profiler's trace names no routed_fwd")

    # h. autotune -----------------------------------------------------------
    old = os.environ.get("SPH_TPU_TUNE_CACHE")
    with tempfile.TemporaryDirectory() as tdir:
        os.environ["SPH_TPU_TUNE_CACHE"] = tdir
        try:
            t0 = time.time()
            cfg, _ = counted("autotune", lambda: prt.autotune(
                grid, geom, device=dev))
            tune_s = time.time() - t0
            (side,) = os.listdir(tdir)
            with open(os.path.join(tdir, side)) as fh:
                rec = json.load(fh)
            for r in rec["all"]:
                log(f"[surface autotune] {r['fields']}: {r['ms']:.4f} "
                    f"ms/step ({label})")
            for c in rec["confirm"]:
                log(f"[surface autotune] confirm {c['fields']}: "
                    f"{c['ms'][0]:.4f} then {c['ms'][1]:.4f} ms/step")
            log(f"[surface autotune] chose {rec['fields']} in "
                f"{tune_s:.1f} s")
            again, got = counted("autotune cached", lambda: prt.autotune(
                grid, geom, device=dev))
            other = orbit(prt, 50, (50, 100), z=0.2)
            base = prt.autotune(grid, other, cached_only=True, device=dev)
            # the wider sweep on the denser grid: every pair in both orders
            t0 = time.time()
            counted("autotune vol100", lambda: prt.autotune(
                big_grid, geom, candidates=prt.tune.GRID_CANDIDATES,
                device=dev))
            side = [f for f in os.listdir(tdir) if f != side]
            with open(os.path.join(tdir, side[0])) as fh:
                big_rec = json.load(fh)
            for r in big_rec["all"]:
                log(f"[surface autotune vol100] {r['fields']}: "
                    f"{r['ms']:.4f} ms/step ({label})")
            log(f"[surface autotune vol100] chose {big_rec['fields']} in "
                f"{time.time() - t0:.1f} s")
        finally:
            if old is None:
                os.environ.pop("SPH_TPU_TUNE_CACHE", None)
            else:
                os.environ["SPH_TPU_TUNE_CACHE"] = old
    if again != cfg or got or base != prt.TraceConfig(mode="routed"):
        raise AssertionError("autotune's sidecar was not read back, or a "
                             "cached call launched a kernel")
    best = built("autotuned", grid, geom, config=cfg)
    with torch.no_grad():
        check_close(f"autotuned {rec['fields']} image vs 'auto'", best(x),
                    op(x), 1e-5, 1e-6 * float(op(x).abs().max()))
    return total


def main(argv):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="profile 5 training steps of each routed config "
                    "and of fused mode, and 5 calls of each solver run of "
                    "phase 17; write the traces to DIR")
    profile_dir = ap.parse_args(argv).profile
    t_start = time.time()
    marks = [("imports", t_start)]  # (phase, time it started)

    def mark(phase):
        marks.append((phase, time.time()))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import sph_raytracer_tpu_torch as prt
    from sph_raytracer_tpu_torch.ops import fused_project as fp
    from sph_raytracer_tpu_torch.ops import routed_project as rp
    from sph_raytracer_tpu_torch.ops.project import precompute_table
    from sph_raytracer_tpu_torch.ops.trace import GridSpec
    from sph_raytracer_tpu_torch.tools import fused_sweep, wfwd_probe
    from sph_raytracer_tpu_torch.tools.bwd_sweep import csr_case
    from sph_raytracer_tpu_torch.tools.wfwd_probe import (HBM_BYTES_PER_S,
                                                          cuda_ms)

    # f32 stays f32 (no TF32 anywhere on the path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    mark(1)
    # 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind}")

    mark(2)
    # 2. build -------------------------------------------------------------
    t0 = time.time()
    _, build_log = rp.load_library()
    log(f"[build] {time.time() - t0:.2f} s")
    for line in build_log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line or line.endswith(" s")):
            log(f"[build] {line.strip()}")

    mark(3)
    # 3. the flagship operator ---------------------------------------------
    grid = prt.SphericalGrid(shape=(50, 50, 50))
    geom = orbit(prt, 50, (50, 100))
    torch.cuda.synchronize()
    t0 = time.time()
    op = prt.Operator(grid, geom, mode="auto")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    tab = op._tables
    assert op._mode == "routed" and op._bwd is rp.routed_bwd_gather
    R, V, nnz = tab.n_rays, tab.n_vox, tab.nnz
    log(f"[flagship] setup {setup_s:.3f} s, R={R}, V={V}, nnz={nnz}, "
        f"table bytes={tab.nbytes}")

    mark(4)
    # 4. kernels vs plain versions at the flagship's shapes -----------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    d = torch.rand(V, generator=gen).to(dev)
    dy = torch.randn(R, generator=gen).to(dev)
    dyp = torch.rand(R, generator=gen).to(dev)
    errs = {}
    y_ref = rp.routed_fwd_ref(tab, d)
    errs["routed_fwd"] = check_close(
        "routed_fwd", rp.routed_fwd(tab, d), y_ref, 1e-5,
        1e-5 * float(y_ref.abs().max()))
    g_ref = rp.routed_bwd_gather_ref(tab, dy)
    errs["routed_bwd_gather"] = check_close(
        "routed_bwd_gather", rp.routed_bwd_gather(tab, dy), g_ref, 1e-5,
        1e-5 * float(g_ref.abs().max()))
    s_ref = rp.routed_bwd_scatter_ref(tab, dy)
    # atomics sum in a run-to-run order
    errs["routed_bwd_scatter"] = check_close(
        "routed_bwd_scatter", rp.routed_bwd_scatter(tab, dy), s_ref, 1e-4,
        1e-5 * float(s_ref.abs().max()))
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    rp.routed_bwd_scatter(tab, dy, counts=counts)
    issued, over = counts.tolist()
    pairs = rp.scatter_atomics(tab)
    log(f"[scatter] {issued} global atomics issued, {over} of them for "
        f"crossings that overflowed a {rp.SCATTER_SLOTS}-slot table; "
        f"{pairs} distinct ({rp.SCATTER_TILE}-ray tile, voxel) pairs; one a "
        f"crossing before the tiles: {nnz}")
    if not (pairs <= issued < nnz and (over > 0 or issued == pairs)):
        raise AssertionError("routed_bwd_scatter's atomics disagree with "
                             "its tiles' (tile, voxel) pairs")
    lhs = float(torch.dot(rp.routed_fwd(tab, d).double(), dyp.double()))
    for bwd in (rp.routed_bwd_gather, rp.routed_bwd_scatter):
        rhs = float(torch.dot(d.double(), bwd(tab, dyp).double()))
        rel = abs(lhs - rhs) / abs(lhs)
        log(f"[check] adjoint <Ax,y>=<x,A'y> {bwd.__name__}: rel {rel:.3e}")
        if not rel <= 1e-8:
            raise AssertionError(f"adjoint identity fails for {bwd.__name__}")
    # the forward and the gather sum in a fixed order: bitwise run to run
    for kern, x in ((rp.routed_fwd, d), (rp.routed_bwd_gather, dy)):
        if not torch.equal(kern(tab, x), kern(tab, x)):
            raise AssertionError(f"{kern.__name__} differs run to run")
        log(f"[check] {kern.__name__}: two launches bitwise equal")
    # the synthetic tables (~1.3 GB) stay out of the peak memory of [step]
    peak = torch.cuda.max_memory_allocated()
    csr_walk_checks(torch, rp, csr_case, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    mark(5)
    # 5. goldens on the card -------------------------------------------------
    g = np.load(os.path.join(HERE, "tests", "goldens",
                             "collection_orbit.npz"))
    ggrid = prt.SphericalGrid(shape=(8, 8, 8))
    ggeom = sum(
        prt.ConeRectGeom((6, 6), pos=(2 * np.cos(t), 2 * np.sin(t), 0.5),
                         lookdir=(0.35 - 2 * np.cos(t), 0.2 - 2 * np.sin(t),
                                  -0.5), fov=(45, 45))
        for t in np.linspace(0, 2 * np.pi, 5, endpoint=False))
    lin, lens, _, rs = precompute_table(
        GridSpec.from_grid(ggrid, torch.float64), ggeom.ray_starts,
        ggeom.rays, device=dev)
    gt = rp.build_tables(lin, lens, int(np.prod(ggrid.shape)))
    gd_ = torch.tensor(g["density"], dtype=torch.float32,
                       device=dev).reshape(-1).requires_grad_(True)
    img = rp.routed_project(gd_, gt).reshape(rs)
    loss = torch.mean((img - torch.tensor(g["grad_target"],
                                          dtype=torch.float32,
                                          device=dev)) ** 2)
    loss.backward()
    check_close("golden collection_orbit image", img.detach().cpu(),
                torch.tensor(g["image"]), 1e-4, 1e-6)
    check_close("golden collection_orbit grad",
                gd_.grad.cpu().reshape(g["grad"].shape),
                torch.tensor(g["grad"]), 1e-4, 1e-6)
    op_c = prt.Operator(ggrid, ggeom, mode="routed")
    op_h = prt.Operator(ggrid, ggeom, mode="routed", device="cpu")
    ref = op_h(g["density"])
    check_close("collection_orbit f32 routed card vs cpu", op_c(
        g["density"]).cpu(), ref, 1e-4, 1e-4 * float(ref.abs().max()))
    torch.cuda.synchronize()

    mark(6)
    # 6. the main path: gd on the flagship ----------------------------------
    truth = torch.rand(tuple(grid.shape), generator=gen).to(dev)
    with torch.no_grad():
        y = op(truth)
    model = prt.models.FullyDenseModel(grid)
    torch.cuda.synchronize()
    rp.reset_launches()
    t0 = time.time()
    _, reproj, losses = prt.retrieval.gd(op, y, model, num_iterations=20,
                                         progress_bar=False)
    torch.cuda.synchronize()
    gd_s = time.time() - t0
    main_launches = dict(rp.LAUNCHES)
    hist = next(iter(losses.values()))
    log(f"[main] gd 20 iterations {gd_s:.3f} s, loss {hist[0]:.6g} -> "
        f"{hist[-1]:.6g}, launches {main_launches}")
    if not (len(hist) == 20 and np.all(np.isfinite(hist))
            and hist[-1] < hist[0]
            and bool(torch.isfinite(reproj).all())
            and tuple(reproj.shape) == tuple(geom.shape)):
        raise AssertionError("gd loss history not finite and decreasing")
    if (main_launches["routed_fwd"] < 20
            or main_launches["routed_bwd_gather"] < 20):
        raise AssertionError(f"main path missed a kernel: {main_launches}")

    op_off = prt.Operator(grid, geom, config=prt.TraceConfig(
        routed_dense="off"))
    assert op_off._bwd is rp.routed_bwd_scatter
    torch.cuda.synchronize()
    rp.reset_launches()
    _, _, losses_off = prt.retrieval.gd(op_off, y, model, num_iterations=5,
                                        progress_bar=False)
    torch.cuda.synchronize()
    off_launches = dict(rp.LAUNCHES)
    hist_off = next(iter(losses_off.values()))
    log(f"[off] gd 5 iterations, loss {hist_off[0]:.6g} -> "
        f"{hist_off[-1]:.6g}, launches {off_launches}")
    if off_launches["routed_bwd_scatter"] < 5 or not (
            hist_off[-1] < hist_off[0]):
        raise AssertionError(f"routed_dense='off' path failed: "
                             f"{off_launches}")
    del op_off

    mark(7)
    # 7. timings -------------------------------------------------------------
    def make_step(o, target):
        """One training step of operator ``o`` (forward → MSE → grad →
        update), its state carried from call to call."""
        state = {"v": truth * 0.5}

        def one():
            v = state["v"].detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(
                torch.mean((o(v) - target) ** 2), v)
            state["v"] = (v - 1e-3 * grad).detach()

        return one

    one = make_step(op, y)
    step_ms = cuda_ms(one, n=30, warm=5)
    peak = max(peak, torch.cuda.max_memory_allocated())
    log(f"[step] {step_ms:.4f} ms/step, {R / (step_ms * 1e-3):.6g} rays/s "
        f"(fwd+bwd, {R} rays), peak memory {peak / 2**30:.3f} GiB")

    A = torch.sparse_csr_tensor(tab.row_ptr, tab.col, tab.val, size=(R, V),
                                check_invariants=False)
    AT = torch.sparse_csr_tensor(tab.vox_ptr, tab.ray, tab.valT,
                                 size=(V, R), check_invariants=False)
    ptr_b, idx_b = 4, 8  # per row pointer / per crossing (index + length)
    bytes_ = {
        "routed_fwd": (R + 1) * ptr_b + nnz * idx_b + 4 * V + 4 * R,
        "routed_bwd_gather": (V + 1) * ptr_b + nnz * idx_b + 4 * R + 4 * V,
        "routed_bwd_scatter": (R + 1) * ptr_b + nnz * idx_b + 4 * R + 4 * V,
    }
    timed = {
        "routed_fwd": (lambda: rp.routed_fwd(tab, d),
                       lambda: rp.routed_fwd_ref(tab, d),
                       lambda: torch.mv(A, d)),
        "routed_bwd_gather": (lambda: rp.routed_bwd_gather(tab, dy),
                              lambda: rp.routed_bwd_gather_ref(tab, dy),
                              lambda: torch.mv(AT, dy)),
        "routed_bwd_scatter": (lambda: rp.routed_bwd_scatter(tab, dy),
                               lambda: rp.routed_bwd_scatter_ref(tab, dy),
                               lambda: torch.mv(AT, dy)),
    }
    launches = {"routed_fwd": main_launches["routed_fwd"],
                "routed_bwd_gather": main_launches["routed_bwd_gather"],
                "routed_bwd_scatter": off_launches["routed_bwd_scatter"]}
    kernels = []
    for name, (kern, plain, lib) in timed.items():
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        lib_ms = cuda_ms(lib)
        byte_ms = bytes_[name] / HBM_BYTES_PER_S * 1e3
        op_ms = 2 * nnz / F32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": lib_ms})
        log(f"[kernel] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {max(byte_ms, op_ms):.4f} ms "
            f"({bytes_[name]} bytes), {byte_ms / ms:.1%} of the bound")

    mark(8)
    # 8. fused mode on the flagship, forward only ---------------------------
    torch.cuda.synchronize()
    t0 = time.time()
    opf = prt.Operator(grid, geom, mode="fused")
    torch.cuda.synchronize()
    fsetup_s = time.time() - t0
    if not (opf._engine and opf._fused_bwd_lazy and opf._fused_btd is None
            and opf._tables is None and opf.lin is None):
        raise AssertionError("fused operator built tables or left the engine")
    frays, fgs = opf._frays, opf.gs
    mp = fp.padded_crossings(fgs)
    log(f"[fused] construction {fsetup_s:.3f} s, no tables; "
        f"M={fgs.num_crossings}, Mp={mp}")
    y_fk = fp.fused_fwd(fgs, frays, d)
    y_fr = fp.fused_fwd_ref(fgs, frays, d)
    errs["fused_fwd"] = check_rays(
        "fused_fwd vs its plain version", y_fk, y_fr, 1e-5,
        1e-5 * float(y_fr.abs().max()), KNIFE_KERNEL)
    # the routed kernel's image of the same rays (the port's f32 trace,
    # atan2 labels) at tests/test_fused_pallas.py's tolerances
    check_rays("fused_fwd vs routed_fwd image", y_fk, rp.routed_fwd(tab, d),
               1e-4, 2e-5, KNIFE_ROUTED)
    if not torch.equal(y_fk, fp.fused_fwd(fgs, frays, d)):
        raise AssertionError("fused_fwd differs run to run")
    log("[check] fused_fwd: two launches bitwise equal")
    with torch.no_grad():
        y_op = opf(d.reshape(tuple(grid.shape)))
    if opf._fused_btd is not None or not torch.equal(
            y_op.reshape(-1), y_fk):
        raise AssertionError("fused forward built tables or differs")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fp.fused_fwd(fgs, frays, d)
    torch.cuda.synchronize()
    ray_bytes = sum(t.numel() * t.element_size() for t in frays
                    if t is not None)
    log(f"[fused] forward peak memory above resident "
        f"{torch.cuda.max_memory_allocated() - base} B, per-ray inputs "
        f"{ray_bytes} B; routed tables {tab.nbytes} B")

    mark(9)
    # 9. fused mode's main path: gd through fused_fwd + the lazy backward ---
    with torch.no_grad():
        yf = opf(truth)
    torch.cuda.synchronize()
    rp.reset_launches()
    t0 = time.time()
    _, reproj_f, losses_f = prt.retrieval.gd(opf, yf, model,
                                             num_iterations=20,
                                             progress_bar=False)
    torch.cuda.synchronize()
    gdf_s = time.time() - t0
    fused_launches = dict(rp.LAUNCHES)
    hist_f = next(iter(losses_f.values()))
    btd = opf._fused_btd
    log(f"[fused main] gd 20 iterations {gdf_s:.3f} s (lazy table build "
        f"included), loss {hist_f[0]:.6g} -> {hist_f[-1]:.6g}, launches "
        f"{fused_launches}; backward-only tables {btd.nbytes} B")
    if not (len(hist_f) == 20 and np.all(np.isfinite(hist_f))
            and hist_f[-1] < hist_f[0]
            and bool(torch.isfinite(reproj_f).all())
            and tuple(reproj_f.shape) == tuple(geom.shape)):
        raise AssertionError("fused gd loss history not finite and "
                             "decreasing")
    if (fused_launches["fused_fwd"] < 21
            or fused_launches["routed_bwd_gather"] < 20
            or fused_launches["routed_fwd"] != 0 or btd.row_ptr is not None):
        raise AssertionError(f"fused main path missed a kernel or kept a "
                             f"forward table: {fused_launches}")

    opf_off = prt.Operator(grid, geom, config=prt.TraceConfig(
        mode="fused", routed_dense="off"))
    torch.cuda.synchronize()
    rp.reset_launches()
    _, _, losses_foff = prt.retrieval.gd(opf_off, yf, model,
                                         num_iterations=5,
                                         progress_bar=False)
    torch.cuda.synchronize()
    foff_launches = dict(rp.LAUNCHES)
    hist_foff = next(iter(losses_foff.values()))
    log(f"[fused off] gd 5 iterations, loss {hist_foff[0]:.6g} -> "
        f"{hist_foff[-1]:.6g}, launches {foff_launches}")
    if (foff_launches["routed_bwd_scatter"] < 5
            or foff_launches["fused_fwd"] < 5
            or not hist_foff[-1] < hist_foff[0]):
        raise AssertionError(f"fused routed_dense='off' path failed: "
                             f"{foff_launches}")
    del opf_off

    mark(10)
    # 10. the dynamic view_times configuration at full size -----------------
    # examples/dynamic_measurements.py:23-28,75-83
    dgrid = prt.SphericalGrid(shape=(20, 50, 50, 50))
    nviews = 2 * dgrid.shape.t
    dgeom = sum(prt.ConeCircGeom(shape=(100, 50),
                                 pos=(5 * np.cos(th), 5 * np.sin(th), 1),
                                 fov=(0, 45))
                for th in np.linspace(0, 2 * np.pi, nviews))
    times = np.linspace(float(dgrid.t[0]), float(dgrid.t[-1]), nviews)
    torch.cuda.synchronize()
    t0 = time.time()
    opd = prt.Operator(dgrid, dgeom, mode="fused", view_times=times)
    torch.cuda.synchronize()
    dsetup_s = time.time() - t0
    drays = opd._frays
    if not (opd._engine and drays.w is not None and opd._fused_btd is None):
        raise AssertionError("view_times operator left the lerp engine")
    dd = torch.rand(opd._flat_size, generator=gen).to(dev)
    ddy = torch.randn(drays.n, generator=gen).to(dev)
    y_dk = fp.fused_fwd(opd.gs, drays, dd)
    check_rays(
        "fused_fwd lerp vs its plain version", y_dk,
        fp.fused_fwd_ref(opd.gs, drays, dd), 1e-5,
        1e-5 * float(y_dk.abs().max()), KNIFE_KERNEL)
    if not torch.equal(y_dk, fp.fused_fwd(opd.gs, drays, dd)):
        raise AssertionError("fused_fwd lerp differs run to run")
    log("[check] fused_fwd lerp: two launches bitwise equal")
    v = dd.reshape(tuple(dgrid.shape)).clone().requires_grad_(True)
    rp.reset_launches()
    torch.sum(opd(v).reshape(-1) * ddy).backward()
    torch.cuda.synchronize()
    dbtd = opd._fused_btd
    log(f"[dynamic] R={drays.n}, flat={opd._flat_size}, construction "
        f"{dsetup_s:.3f} s; first gradient launches {dict(rp.LAUNCHES)}, "
        f"doubled backward-only tables {dbtd.nbytes} B, nnz {dbtd.nnz}")
    if (rp.LAUNCHES["fused_fwd"] != 1
            or rp.LAUNCHES["routed_bwd_gather"] != 1
            or dbtd.row_ptr is not None):
        raise AssertionError("view_times gradient missed the lazy backward")
    gref = rp.routed_bwd_gather_ref(dbtd, ddy)
    check_close("view_times gradient (routed_bwd_gather on the doubled "
                "tables)", v.grad.reshape(-1), gref, 1e-5,
                1e-5 * float(gref.abs().max()))
    # the fused labels (half-plane bins) and the trace's (atan2) may part
    # on knife-edge segments, so the adjoint holds to 1e-4 here
    for name, (yy, gg, dens, cot) in {
            "flagship": (y_fk, rp.routed_bwd_gather(opf._fused_btd, dyp), d,
                         dyp),
            "view_times": (y_dk, v.grad.reshape(-1), dd, ddy)}.items():
        lhs = float(torch.dot(yy.double(), cot.double()))
        rhs = float(torch.dot(dens.double(), gg.double()))
        rel = abs(lhs - rhs) / abs(lhs)
        log(f"[check] fused adjoint <Ax,y>=<x,A'y> {name}: rel {rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"fused adjoint identity fails ({name})")

    mark(11)
    # 11. fused timings -------------------------------------------------------
    # the step first, so that no work of this phase runs before it
    fone = make_step(opf, yf)
    fstep_ms = cuda_ms(fone, n=30, warm=5)
    log(f"[fused step] {fstep_ms:.4f} ms/step, "
        f"{R / (fstep_ms * 1e-3):.6g} rays/s (fused_fwd + "
        f"routed_bwd_gather, {R} rays)")
    fcfg = {"flagship": (fgs, frays, d, V, False),
            "view_times": (opd.gs, drays, dd, opd._flat_size, True)}
    ftimes = {}
    for name, (gs_, rays_, dens, n_flat, lerp_) in fcfg.items():
        st = fused_sweep.ray_stats(gs_, rays_)
        ms = cuda_ms(lambda: fp.fused_fwd(gs_, rays_, dens))
        plain = cuda_ms(lambda: fp.fused_fwd_ref(gs_, rays_, dens), n=5,
                        warm=1)
        # the bound: the shipped design's own operations on this run's
        # rays; the first port's Mp-wide network (the TPU kernel's work)
        # printed beside it
        ops = fused_sweep.shipped_ops(gs_, st, lerp_)
        net = fused_ops(gs_, rays_.n, fp.padded_crossings(gs_), st["live"],
                        lerp_)
        op_ms = ops / F32_FLOPS * 1e3
        byte_ms = fused_bytes(rays_.n, n_flat, off0=lerp_, lerp=lerp_) \
            / HBM_BYTES_PER_S * 1e3
        ftimes[name] = (ms, plain, op_ms, byte_ms)
        log(f"[kernel] fused_fwd {name} ({rays_.n} rays): {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {max(op_ms, byte_ms):.4f} ms "
            f"({ops} f32 ops of the shipped design; the first port's "
            f"network "
            f"{net}, {net / F32_FLOPS * 1e3:.4f} ms; {st['live']} live "
            f"segments; bytes bound {byte_ms:.4f} ms), "
            f"{max(op_ms, byte_ms) / ms:.1%} of the bound"
            + (f"; routed_fwd on the same rays {kernels[0]['ms']:.4f} ms"
               if not lerp_ else ""))
        log(f"[fused {name}] rays by sort size S {st['sort_size_rays']}, "
            f"finite crossings mean {st['finite_mean']:.2f} (max "
            f"{st['finite_max']}), dense walk steps mean "
            f"{st['walk_steps_mean']:.3f} ({st['live_slices_mean']:.3f} "
            f"32-wide slices hold a live segment)")
    # the shipped kernel's stage split at the flagship (tools/fused_sweep.py
    # splits both designs on both configs)
    _, alone = fused_sweep.stage_split(fgs, frays, d, "shipped", n=5)
    log("[fused flagship] shipped stage split (ms, each stage alone, 5 "
        "launches each): " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in alone.items()))
    f_ms, f_plain, f_op_ms, f_byte_ms = ftimes["flagship"]
    kernels.append({
        "name": "fused_fwd", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": REPLACES["fused_fwd"],
        "launches": fused_launches["fused_fwd"],
        "max_abs_err": errs["fused_fwd"], "ms": f_ms, "plain_ms": f_plain,
        "bound_ms": max(f_op_ms, f_byte_ms),
        "bound_by": "operations" if f_op_ms >= f_byte_ms else "bytes",
        "library_ms": None})

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    mark(12)
    # 12. the routed engine's variants on the flagship ----------------------
    variants = {  # name -> (TraceConfig fields, forward, backward)
        "both": (dict(routed_dense="both"), rp.routed_fwd_dense,
                 rp.routed_bwd_gather),
        "fwd": (dict(routed_dense="fwd"), rp.routed_fwd_dense,
                rp.routed_bwd_scatter),
        "hist": (dict(routed_fwd_reduce="hist"), rp.routed_fwd_hist,
                 rp.routed_bwd_gather),
        "window": (dict(routed_banded=False), rp.routed_fwd_window,
                   rp.routed_bwd_window),
    }
    vops = {}
    for name, (cfg, fwd, bwd) in variants.items():
        torch.cuda.synchronize()
        t0 = time.time()
        vops[name] = prt.Operator(grid, geom, config=prt.TraceConfig(**cfg))
        torch.cuda.synchronize()
        vt = vops[name]._tables
        log(f"[variant {name}] setup {time.time() - t0:.3f} s, "
            f"{fwd.__name__} + {bwd.__name__}, nnz {vt.nnz}, table bytes "
            f"{vt.nbytes}")
        if (vops[name]._fwd, vops[name]._bwd) != (fwd, bwd):
            raise AssertionError(f"{name}: resolved to another kernel pair")
    t_both, t_fwd = vops["both"]._tables, vops["fwd"]._tables
    t_hist, t_win = vops["hist"]._tables, vops["window"]._tables
    if t_both.row_ptr is not None:
        raise AssertionError("routed_dense='both' kept the ray-major CSR")
    # crossings per CTA of each window kernel (its load balance)
    per_tile = (t_win.cptr[t_win.tile_ptr[1:].long()]
                - t_win.cptr[t_win.tile_ptr[:-1].long()]).double()
    cs = torch.cumsum(torch.diff(t_win.cptr)[t_win.bwd_order.long()], 0)
    cs = torch.cat([cs.new_zeros(1), cs])
    per_win = (cs[t_win.win_ptr[1:].long()]
               - cs[t_win.win_ptr[:-1].long()]).double()
    log(f"[variant window] {t_win.n_tiles} tiles of {t_win.G} rays, "
        f"{t_win.n_win} windows of {t_win.W} voxels, "
        f"{len(t_win.ckey)} non-empty chunks; crossings per tile max "
        f"{int(per_tile.max())} mean {float(per_tile.mean()):.1f}, per "
        f"window max {int(per_win.max())} mean {float(per_win.mean()):.1f}")
    ip = t_win.item_ptr.long()
    per_item = (cs[ip[1:]] - cs[ip[:-1]]).double()
    log(f"[variant window] routed_bwd_window: {t_win.n_items} work items of "
        f"at most K={t_win.K} crossings (a larger chunk alone), largest "
        f"{int(per_item.max())}, mean {float(per_item.mean()):.1f}; "
        f"{int(torch.unique(t_win.item_win).numel())} non-empty windows; "
        f"item list {nbytes(t_win.item_ptr, t_win.item_win)} B")
    sizes = torch.diff(t_win.piece_ptr)
    log(f"[variant window] routed_fwd_window: {t_win.n_pieces} pieces of at "
        f"most KF={t_win.KF} crossings, largest {int(sizes.max())}, mean "
        f"{float(sizes.double().mean()):.1f}, {rp.WIN_FWD_THREADS} threads a "
        f"CTA; piece list {nbytes(t_win.piece_ptr, t_win.piece_chunk)} B")
    cut = rp.hist_cut(t_hist)
    log(f"[variant hist] routed_fwd_hist: {cut.shape[0] - 1} shares of "
        f"HIST_SHARE={rp.HIST_SHARE} merge-path steps, at most "
        f"{int(torch.diff(cut[:, 1]).max())} crossings and "
        f"{int(torch.diff(cut[:, 0]).max()) + 1} rays a share; cut table "
        f"{nbytes(cut)} B")
    if t_hist.cut is None or not torch.equal(t_hist.cut, cut):
        raise AssertionError("the 'hist' tables lack routed_fwd_hist's cut "
                             "table")
    dense_atomics = {w: rp.dense_fwd_atomics(t_both, w) for w in (1, 2, 4)}
    log(f"[variant both] routed_fwd_dense: global atomics at width 1 / 2 / 4 "
        f"{dense_atomics[1]} / {dense_atomics[2]} / {dense_atomics[4]} "
        f"(width {rp.DENSE_WIDTH} runs, warp spread {rp.DENSE_SPREAD}); one "
        f"a crossing {t_both.nnz}")
    # shared or global atomics sum in a run-to-run order: rtol 1e-4
    new_checks = {
        "routed_fwd_dense": (t_both, d, rp.routed_fwd_dense_ref),
        "routed_fwd_hist": (t_hist, d, rp.routed_fwd_hist_ref),
        "routed_fwd_window": (t_win, d, rp.routed_fwd_window_ref),
        "routed_bwd_window": (t_win, dy, rp.routed_bwd_window_ref),
    }
    for name, (t, x, ref) in new_checks.items():
        want = ref(t, x)
        errs[name] = check_close(name, getattr(rp, name)(t, x), want, 1e-4,
                                 1e-5 * float(want.abs().max()))
    for label, t, fwd, bwd in (
            ("routed_fwd_dense/routed_bwd_gather", t_both,
             rp.routed_fwd_dense, rp.routed_bwd_gather),
            ("routed_fwd_dense/routed_bwd_scatter", t_fwd,
             rp.routed_fwd_dense, rp.routed_bwd_scatter),
            ("routed_fwd_hist/routed_bwd_gather", t_hist,
             rp.routed_fwd_hist, rp.routed_bwd_gather),
            ("routed_fwd_window/routed_bwd_window", t_win,
             rp.routed_fwd_window, rp.routed_bwd_window)):
        lhs = float(torch.dot(fwd(t, d).double(), dyp.double()))
        rhs = float(torch.dot(d.double(), bwd(t, dyp).double()))
        rel = abs(lhs - rhs) / abs(lhs)
        log(f"[check] adjoint <Ax,y>=<x,A'y> {label}: rel {rel:.3e}")
        if not rel <= 1e-5:
            raise AssertionError(f"adjoint identity fails for {label}")
    y_routed = rp.routed_fwd(tab, d)
    for name in ("routed_fwd_dense", "routed_fwd_hist", "routed_fwd_window"):
        t = new_checks[name][0]
        check_close(f"{name} image vs routed_fwd", getattr(rp, name)(t, d),
                    y_routed, 1e-4, 1e-6 * float(y_routed.abs().max()))
    torch.cuda.synchronize()

    var_launches = {}
    for name, (_, fwd, bwd) in variants.items():
        torch.cuda.synchronize()
        rp.reset_launches()
        t0 = time.time()
        _, reproj_v, losses_v = prt.retrieval.gd(
            vops[name], y, model, num_iterations=5, progress_bar=False)
        torch.cuda.synchronize()
        var_launches[name] = lv = dict(rp.LAUNCHES)
        hist_v = next(iter(losses_v.values()))
        log(f"[variant {name} main] gd 5 iterations {time.time() - t0:.3f} "
            f"s, loss {hist_v[0]:.6g} -> {hist_v[-1]:.6g}, launches "
            f"{ {k: n for k, n in lv.items() if n} }")
        if not (len(hist_v) == 5 and np.all(np.isfinite(hist_v))
                and hist_v[-1] < hist_v[0]
                and bool(torch.isfinite(reproj_v).all())
                and tuple(reproj_v.shape) == tuple(geom.shape)):
            raise AssertionError(f"{name}: gd loss history not finite and "
                                 "decreasing")
        if (lv[fwd.__name__] < 5 or lv[bwd.__name__] < 5
                or lv["routed_fwd"] != 0):
            raise AssertionError(f"{name} main path missed a kernel: {lv}")

    mark(13)
    # 13. variant timings ----------------------------------------------------
    vsteps = {}
    for name, vop in vops.items():
        vsteps[name] = make_step(vop, y)
        v_ms = cuda_ms(vsteps[name], n=30, warm=5)
        log(f"[variant {name} step] {v_ms:.4f} ms/step, "
            f"{R / (v_ms * 1e-3):.6g} rays/s (fwd+bwd, {R} rays); "
            f"routed_dense='auto' step {step_ms:.4f} ms")

    win_common = nbytes(t_win.ckey, t_win.cptr, t_win.loc, t_win.val)
    var_bytes = {
        "routed_fwd_dense": nbytes(t_both.vox_ptr, t_both.ray, t_both.valT)
        + 4 * V + 4 * R,
        "routed_fwd_hist": nbytes(t_hist.row_ptr, t_hist.col, t_hist.val,
                                  t_hist.cut) + 4 * V + 4 * R,
        "routed_fwd_window": nbytes(t_win.tile_ptr, t_win.piece_ptr,
                                    t_win.piece_chunk) + win_common
        + 4 * V + 4 * R,
        "routed_bwd_window": nbytes(t_win.win_ptr, t_win.bwd_order,
                                    t_win.item_ptr, t_win.item_win)
        + win_common + 4 * R + 4 * V,
    }
    var_launch = {"routed_fwd_dense": var_launches["both"],
                  "routed_fwd_hist": var_launches["hist"],
                  "routed_fwd_window": var_launches["window"],
                  "routed_bwd_window": var_launches["window"]}
    for name, (t, x, ref) in new_checks.items():
        kern = getattr(rp, name)
        ms = cuda_ms(lambda: kern(t, x))
        plain_ms = cuda_ms(lambda: ref(t, x))
        mat = AT if name == "routed_bwd_window" else A
        lib_ms = cuda_ms(lambda: torch.mv(mat, x))
        byte_ms = var_bytes[name] / HBM_BYTES_PER_S * 1e3
        op_ms = 2 * t.nnz / F32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": VARIANTS_SOURCE,
            "replaces": REPLACES[name], "launches": var_launch[name][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": lib_ms})
        extra = (f", {dense_atomics[rp.DENSE_WIDTH]} global atomics"
                 if name == "routed_fwd_dense" else "")
        log(f"[kernel] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {max(byte_ms, op_ms):.4f} ms "
            f"({var_bytes[name]} bytes), {byte_ms / ms:.1%} of the "
            f"bound{extra}")

    mark(14)
    # 14. the window-major forward (B8) on phase 12's chunk table, then the
    # path that runs it: the probe at vol100 ------------------------------
    name = "routed_fwd_densew"
    y_dw = rp.routed_fwd_densew(t_win, d)
    want = rp.routed_fwd_densew_ref(t_win, d)
    # global atomics sum in a run-to-run order: rtol 1e-4
    errs[name] = check_close(name, y_dw, want, 1e-4,
                             1e-5 * float(want.abs().max()))
    check_close(f"{name} image vs routed_fwd", y_dw, y_routed, 1e-4,
                1e-6 * float(y_routed.abs().max()))
    lhs = float(torch.dot(y_dw.double(), dyp.double()))
    rhs = float(torch.dot(d.double(), rp.routed_bwd_window(t_win,
                                                           dyp).double()))
    log(f"[check] adjoint <Ax,y>=<x,A'y> {name}/routed_bwd_window: rel "
        f"{abs(lhs - rhs) / abs(lhs):.3e}")
    if not abs(lhs - rhs) <= 1e-5 * abs(lhs):
        raise AssertionError(f"adjoint identity fails for {name}")
    runs, atomics = wfwd_probe.densew_atomics(t_win)
    log(f"[densew] flagship: {t_win.n_items} work items; {runs} (ray, "
        f"chunk) runs, {atomics} atomics issued; routed_fwd_dense issues "
        f"one a crossing, {t_win.nnz}")

    torch.cuda.synchronize()
    rp.reset_launches()
    probe = wfwd_probe.probe("vol100")
    torch.cuda.synchronize()
    probe_launches = dict(rp.LAUNCHES)
    log(f"[probe vol100] R={probe['n_rays']} V={probe['n_vox']} "
        f"nnz={probe['nnz']}, setup {probe['setup_s']:.3f} s (trace and "
        f"both tables), {probe['runs']} runs, {probe['atomics']} atomics; "
        f"launches { {k: n for k, n in probe_launches.items() if n} }")
    for r in probe["kernels"]:
        log(f"[probe vol100] {r['name']}: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes), tables {r['table_bytes']} B, "
            f"chunks {r['chunks']}, max diff vs routed_fwd "
            f"{r['max_abs_diff_vs_routed_fwd']:.3e}")
        if probe_launches[r["name"]] < 1:
            raise AssertionError(f"the probe missed {r['name']}")
    pw, pd, py = probe["win"], probe["d"], probe["y"]
    check_close(f"{name} vol100", py[name], rp.routed_fwd_densew_ref(pw, pd),
                1e-4, 1e-5 * float(py[name].abs().max()))
    for other in ("routed_fwd_window", name):
        check_close(f"{other} vol100 image vs routed_fwd", py[other],
                    py["routed_fwd"], 1e-4,
                    1e-6 * float(py["routed_fwd"].abs().max()))
    del probe, pw, pd, py

    ms = cuda_ms(lambda: rp.routed_fwd_densew(t_win, d))
    plain_ms = cuda_ms(lambda: rp.routed_fwd_densew_ref(t_win, d))
    lib_ms = cuda_ms(lambda: torch.mv(A, d))
    dw_bytes = nbytes(t_win.item_ptr, t_win.item_win, t_win.bwd_order) \
        + win_common + 4 * V + 4 * R
    byte_ms = dw_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * t_win.nnz / F32_FLOPS * 1e3
    kernels.append({
        "name": name, "route": "cuda", "source": VARIANTS_SOURCE,
        "replaces": REPLACES[name], "launches": probe_launches[name],
        "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": lib_ms})
    log(f"[kernel] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {max(byte_ms, op_ms):.4f} ms "
        f"({dw_bytes} bytes), {byte_ms / ms:.1%} of the bound, {atomics} "
        f"global atomics")

    mark(15)
    # 15. routed_w_dtype='bf16' on the flagship -----------------------------
    # each banded pair and fused mode's backward on bf16 tables, beside the
    # same config in f32 built here
    bf16_cfgs = {  # name -> (TraceConfig fields, forward, backward)
        "auto": (dict(), rp.routed_fwd, rp.routed_bwd_gather),
        "off": (dict(routed_dense="off"), rp.routed_fwd,
                rp.routed_bwd_scatter),
        "both": (dict(routed_dense="both"), rp.routed_fwd_dense,
                 rp.routed_bwd_gather),
        "fwd": (dict(routed_dense="fwd"), rp.routed_fwd_dense,
                rp.routed_bwd_scatter),
        "hist": (dict(routed_fwd_reduce="hist"), rp.routed_fwd_hist,
                 rp.routed_bwd_gather),
        "fused": (dict(mode="fused"), None, rp.routed_bwd_gather),
    }
    bf16 = torch.bfloat16

    def build(cfg, w_dtype):
        """An operator, its banded tables (fused: the backward's, built
        now), its build seconds and the peak device memory of the build
        above what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        o = prt.Operator(grid, geom, config=prt.TraceConfig(
            routed_w_dtype=w_dtype, **cfg))
        t = o._ensure_fused_btd() if o._mode == "fused" else o._tables
        torch.cuda.synchronize()
        return (o, t, time.time() - t0,
                torch.cuda.max_memory_allocated() - base)

    def max_rel(got, want):
        nz = want != 0
        return float(((got - want).abs()[nz] / want.abs()[nz]).max())

    t16s, t32s, errs16, launches16 = {}, {}, {}, {}
    d3 = d.reshape(tuple(grid.shape))
    for name, (cfg, fwd, bwd) in bf16_cfgs.items():
        o32, t32, s32, p32 = build(cfg, "f32")
        o16, t16, s16, p16 = build(cfg, "bf16")
        kept = [x for x in (t16.val, t16.valT) if x is not None]
        log(f"[bf16 {name}] setup {s32:.3f} s f32 / {s16:.3f} s bf16, "
            f"table bytes {t32.nbytes} / {t16.nbytes}, build peak memory "
            f"{p32} / {p16} B")
        if (o16._w_dtype != bf16 or not kept
                or any(x.dtype != bf16 for x in kept)
                or (fwd is not None and (o16._fwd, o16._bwd) != (fwd, bwd))
                or o16._bwd is not bwd):
            raise AssertionError(f"bf16 {name}: not bf16 tables or another "
                                 "kernel pair")
        # each bf16 instantiation against its plain version on these tables
        for kern, x in ((fwd, d), (bwd, dy)):
            if kern is None:
                continue
            want = getattr(rp, f"{kern.__name__}_ref")(t16, x)
            err = check_close(f"{kern.__name__}_bf16 ({name})", kern(t16, x),
                              want, 1e-4, 1e-5 * float(want.abs().max()))
            errs16.setdefault(f"{kern.__name__}_bf16", err)
        # the images against the f32 operator's (d, dyp >= 0: every term of
        # a sum moves by at most 2^-8 relative, the bf16 rounding)
        with torch.no_grad():
            y16, y32 = o16(d3).reshape(-1), o32(d3).reshape(-1)
            b16, b32 = (o.T(dyp.reshape(tuple(geom.shape))).reshape(-1)
                        for o in (o16, o32))
        check_close(f"bf16 {name} image vs f32", y16, y32, 2e-2,
                    1e-6 * float(y32.abs().max()))
        check_close(f"bf16 {name} .T vs f32", b16, b32, 2e-2,
                    1e-6 * float(b32.abs().max()))
        log(f"[bf16 {name}] max relative difference from f32: image "
            f"{max_rel(y16, y32):.3e}, .T {max_rel(b16, b32):.3e}")
        # the adjoint identity: both directions read the same rounded
        # lengths.  Fused: its forward traces f32 lengths, so with d, dyp
        # >= 0 the two sums part by at most the bf16 rounding, 2^-8
        # relative a length, beside phase 10's 1e-4 for its labels
        lhs = float(torch.dot(y16.double(), dyp.double()))
        rel = abs(lhs - float(torch.dot(d.double(), b16.double()))) / abs(lhs)
        bound = 2.0 ** -8 + 1e-4 if name == "fused" else 1e-6
        log(f"[check] adjoint <Ax,y>=<x,A'y> bf16 {name}: rel {rel:.3e} "
            f"(at most {bound:g})")
        if not rel <= bound:
            raise AssertionError(f"bf16 {name}: adjoint identity fails")
        # the path: gd through the bf16 instantiations, no f32 kernel
        torch.cuda.synchronize()
        rp.reset_launches()
        t0 = time.time()
        _, reproj16, losses16 = prt.retrieval.gd(
            o16, y, model, num_iterations=5, progress_bar=False)
        torch.cuda.synchronize()
        launches16[name] = lv = dict(rp.LAUNCHES)
        hist16 = next(iter(losses16.values()))
        log(f"[bf16 {name} main] gd 5 iterations {time.time() - t0:.3f} s, "
            f"loss {hist16[0]:.6g} -> {hist16[-1]:.6g}, launches "
            f"{ {k: n for k, n in lv.items() if n} }")
        want_k = [f"{bwd.__name__}_bf16"] + (
            [f"{fwd.__name__}_bf16"] if fwd is not None else ["fused_fwd"])
        f32_k = [k for k in rp.LAUNCHES if not k.endswith("_bf16")
                 and k != "fused_fwd"]
        if (any(lv[k] < 5 for k in want_k) or any(lv[k] for k in f32_k)
                or not (len(hist16) == 5 and np.all(np.isfinite(hist16))
                        and hist16[-1] < hist16[0]
                        and bool(torch.isfinite(reproj16).all()))):
            raise AssertionError(f"bf16 {name} main path missed a bf16 "
                                 f"kernel or ran an f32 one: {lv}")
        s32_ms = cuda_ms(make_step(o32, y), n=30, warm=5)
        s16_ms = cuda_ms(make_step(o16, y), n=30, warm=5)
        log(f"[bf16 {name} step] {s16_ms:.4f} ms/step bf16, {s32_ms:.4f} "
            f"ms/step f32 (fwd+bwd, {R} rays, in turns in this call)")
        t16s[name], t32s[name] = t16, t32
        del o32, o16

    # B8 on the flagship chunk table with each length rounded, as a bf16
    # build makes it; its adjoint partner is B3's bf16 instantiation (same
    # crossings, same rounded lengths, another table)
    t_win16 = t_win._replace(val=t_win.val.to(bf16))
    name = "routed_fwd_densew"
    y_dw16 = rp.routed_fwd_densew(t_win16, d)
    want = rp.routed_fwd_densew_ref(t_win16, d)
    errs16[f"{name}_bf16"] = check_close(f"{name}_bf16", y_dw16, want, 1e-4,
                                         1e-5 * float(want.abs().max()))
    y_b1 = rp.routed_fwd(t16s["auto"], d)
    check_close(f"{name}_bf16 image vs routed_fwd_bf16", y_dw16, y_b1, 1e-4,
                1e-6 * float(y_b1.abs().max()))
    lhs = float(torch.dot(y_dw16.double(), dyp.double()))
    rhs = float(torch.dot(d.double(), rp.routed_bwd_scatter(
        t16s["off"], dyp).double()))
    log(f"[check] adjoint <Ax,y>=<x,A'y> {name}_bf16/routed_bwd_scatter_bf16"
        f": rel {abs(lhs - rhs) / abs(lhs):.3e}")
    if not abs(lhs - rhs) <= 1e-6 * abs(lhs):
        raise AssertionError(f"adjoint identity fails for {name}_bf16")
    torch.cuda.synchronize()
    rp.reset_launches()
    probe16 = wfwd_probe.probe("vol100", w_dtype="bf16")
    torch.cuda.synchronize()
    probe16_launches = dict(rp.LAUNCHES)
    log(f"[probe vol100 bf16] setup {probe16['setup_s']:.3f} s; launches "
        f"{ {k: n for k, n in probe16_launches.items() if n} }")
    for r in probe16["kernels"]:
        log(f"[probe vol100 bf16] {r['name']}: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes), tables {r['table_bytes']} B, "
            f"max diff vs routed_fwd {r['max_abs_diff_vs_routed_fwd']:.3e}")
    pw, pd, py = probe16["win"], probe16["d"], probe16["y"]
    if (pw.val.dtype != bf16 or probe16["csr"].val.dtype != bf16
            or probe16_launches[f"{name}_bf16"] < 1
            or probe16_launches["routed_fwd_bf16"] < 1
            or probe16_launches["routed_fwd_window"] < 1
            or probe16_launches[name] or probe16_launches["routed_fwd"]):
        raise AssertionError(f"bf16 probe missed a kernel: "
                             f"{probe16_launches}")
    check_close(f"{name}_bf16 vol100", py[name],
                rp.routed_fwd_densew_ref(pw, pd), 1e-4,
                1e-5 * float(py[name].abs().max()))
    check_close(f"{name}_bf16 vol100 image vs routed_fwd_bf16", py[name],
                py["routed_fwd"], 1e-4,
                1e-6 * float(py["routed_fwd"].abs().max()))
    check_close("routed_fwd_window (f32) vol100 image vs routed_fwd_bf16",
                py["routed_fwd_window"], py["routed_fwd"], 2e-2,
                1e-6 * float(py["routed_fwd"].abs().max()))
    del probe16, pw, pd, py

    mark(16)
    # 16. bf16 timings: each instantiation beside its f32 kernel on the
    # f32 tables of the same config, its plain version, its bound and
    # torch.mv on the CSR of the widened weights (the same function: torch
    # has no sparse mv of bf16 weights by an f32 vector), in this call
    timed16 = {  # bf16 entry -> (wrapper, bf16 table, f32 table, input)
        "routed_fwd_bf16": (rp.routed_fwd, t16s["auto"], t32s["auto"], d),
        "routed_bwd_gather_bf16": (rp.routed_bwd_gather, t16s["auto"],
                                   t32s["auto"], dy),
        "routed_bwd_scatter_bf16": (rp.routed_bwd_scatter, t16s["off"],
                                    t32s["off"], dy),
        "routed_fwd_dense_bf16": (rp.routed_fwd_dense, t16s["both"],
                                  t32s["both"], d),
        "routed_fwd_hist_bf16": (rp.routed_fwd_hist, t16s["hist"],
                                 t32s["hist"], d),
        "routed_fwd_densew_bf16": (rp.routed_fwd_densew, t_win16, t_win, d),
    }
    launch16 = {"routed_fwd_bf16": launches16["auto"],
                "routed_bwd_gather_bf16": launches16["auto"],
                "routed_bwd_scatter_bf16": launches16["off"],
                "routed_fwd_dense_bf16": launches16["both"],
                "routed_fwd_hist_bf16": launches16["hist"],
                "routed_fwd_densew_bf16": probe16_launches}
    t_auto16 = t16s["auto"]
    A16 = torch.sparse_csr_tensor(t_auto16.row_ptr, t_auto16.col,
                                  t_auto16.val.float(), size=(R, V),
                                  check_invariants=False)
    AT16 = torch.sparse_csr_tensor(t_auto16.vox_ptr, t_auto16.ray,
                                   t_auto16.valT.float(), size=(V, R),
                                   check_invariants=False)
    for entry, (kern, t16, t32, x) in timed16.items():
        ref = getattr(rp, f"{kern.__name__}_ref")
        ms = cuda_ms(lambda: kern(t16, x))
        f32_ms = cuda_ms(lambda: kern(t32, x))
        plain_ms = cuda_ms(lambda: ref(t16, x))
        mat = AT16 if "bwd" in entry else A16
        lib_ms = cuda_ms(lambda: torch.mv(mat, x))
        if isinstance(t16, rp.WindowTables):
            reads = (t16.item_ptr, t16.item_win, t16.bwd_order, t16.ckey,
                     t16.cptr, t16.loc, t16.val)
        elif kern in (rp.routed_fwd_dense, rp.routed_bwd_gather):
            reads = (t16.vox_ptr, t16.ray, t16.valT)
        elif kern is rp.routed_fwd_hist:
            reads = (t16.row_ptr, t16.col, t16.val, t16.cut)
        else:
            reads = (t16.row_ptr, t16.col, t16.val)
        b16 = nbytes(*reads) + 4 * V + 4 * R
        byte_ms = b16 / HBM_BYTES_PER_S * 1e3
        op_ms = 2 * t16.nnz / F32_FLOPS * 1e3
        kernels.append({
            "name": entry, "route": "cuda",
            "source": (VARIANTS_SOURCE if "dense" in entry
                       or "hist" in entry else SOURCE),
            "replaces": REPLACES[kern.__name__],
            "launches": launch16[entry][entry], "max_abs_err": errs16[entry],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": lib_ms})
        log(f"[kernel] {entry}: {ms:.4f} ms (f32 {kern.__name__} {f32_ms:.4f}"
            f" ms in turn), plain {plain_ms:.4f} ms, library (torch.mv, "
            f"widened weights) {lib_ms:.4f} ms, bound "
            f"{max(byte_ms, op_ms):.4f} ms ({b16} bytes), "
            f"{byte_ms / ms:.1%} of the bound")

    mark(17)
    # 17. the solver path on the flagship: cg, mlem / OS-EM, SphHarmModel --
    t0 = time.time()
    solver_runs = solver_checks(torch, prt, rp, op, opf, dev,
                                lambda fn: cuda_ms(fn, n=5, warm=2), one,
                                smi)
    log(f"[solver] phase {time.time() - t0:.1f} s")

    mark(18)
    # 18. the rest of the Operator surface and the modules on it ----------
    t0 = time.time()
    surface = surface_checks(torch, prt, rp, op, opd,
                             prt.SphericalGrid(shape=(100, 100, 100)), dev,
                             cuda_ms, one, smi)
    log(f"[surface] phase {time.time() - t0:.1f} s; launches by kernel "
        f"{surface}")
    # each kernel's launches: its earlier paths' and phase 18's
    for k in kernels:
        k["launches"] += surface.get(k["name"], 0)

    if profile_dir:
        mark("profile")
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        for label, fn in (("step", one), ("fused_step", fone),
                          *((f"{n}_step", f) for n, f in vsteps.items()),
                          *solver_runs.items()):
            torch.cuda.synchronize()
            t0 = time.time()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            wall = (time.time() - t0) / 5 * 1e3
            # the device's own events (kernels, copies): an operator's
            # self device time repeats its kernels', and a range's span on
            # the device (Adam's step) holds its idle gaps; both left out
            busy = sum(e.self_device_time_total
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation) / 5e3
            log(f"[profile] {label}, 5 calls: device busy {busy:.4f} ms a "
                f"call, wall {wall:.4f} ms a call under the profiler "
                f"({smi})")
            log(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=15))
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  f"{label}_trace.json"))

    marks.append(("end", time.time()))
    log(f"[run] wall {time.time() - t_start:.1f} s; seconds by phase: "
        + ", ".join(f"{p} {t1 - t0:.1f}"
                    for (p, t0), (_, t1) in zip(marks, marks[1:])))
    log(f"[card] {smi}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
