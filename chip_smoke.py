#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --profile DIR    # adds torch.profiler windows over
                                           # the routed and the fused step;
                                           # their traces go to DIR

Phases (any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``sph_raytracer_tpu_torch/csrc`` (nvcc),
   with ``-Xptxas -v`` register / spill lines;
3. the flagship operator: 50³ ``SphericalGrid``, a 50-view orbit of
   ``ConeRectGeom((50, 100))`` detectors (250,000 rays), ``mode='auto'``
   on CUDA (= routed), float32 — the configuration of ``bench.py``;
4. each kernel against its plain PyTorch version on the same CUDA tensors
   at the flagship's shapes, plus the adjoint identity; the global atomics
   ``routed_bwd_scatter`` issues (its own counts: one a distinct (ray tile,
   voxel) pair, plus any crossing that overflowed its tile's shared
   table) against one a crossing before the tiles;
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
   the tolerance counted (knife-edge midpoint ties), its peak memory
   beside the routed tables' bytes;
9. fused mode's main path: ``retrieval.gd`` for 20 iterations through
   ``fused_fwd`` + ``routed_bwd_gather`` on lazily built backward-only
   tables, counters reset just before and read just after; then 5
   iterations with ``routed_dense='off'`` (``routed_bwd_scatter``);
10. the dynamic ``view_times`` configuration of
   ``examples/dynamic_measurements.py`` at full size (20 time bins of
   50³, 40 ``ConeCircGeom((100, 50))`` views, 200,000 rays): the lerp
   kernel against its plain version and one gradient through the lazy
   backward on the doubled tables;
11. fused timings: ``fused_fwd`` beside its plain version and its bound
   (operations), the fused training step;
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
   bf16 weights by an f32 vector).

Before the last line: the card's name and power limit, then the
``{"kernels": [...]}`` line (15 kernels: 9 f32, 6 bf16); the last line is
``{"ok": true, "device": {...}}``.  The run's wall seconds are printed
before them.  Imports nothing of JAX.
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


def fused_live(torch, fp, gs, rays, block=8192):
    """Live segments (finite, > 0, t >= 0) over all rays: the segments
    whose voxel ``fused_fwd`` searches for, counted on this run's rays."""
    tab = fp.boundary_table(gs, rays.xs.device)
    n = 0
    for i in range(0, rays.n, block):
        ts = torch.sort(fp._crossings(gs, tab, rays.xs[i:i + block],
                                      rays.dirs[i:i + block]), dim=1).values
        n += int(fp._segments(ts)[1].sum())
    return n


def fused_ops(gs, n_rays, mp, live, lerp):
    """f32 operations (arithmetic, compares, min/max) of ``fused_fwd``,
    counted from csrc/fused_project.cu: the per-ray prologue (30), a
    sphere row (4), a cone row (38), an azimuth row (25), the bitonic
    network (Mp·L(L+1)/4 compare-exchanges of 2 ops, L = log2 Mp), 5 per
    sorted element (length, live test), the warp reduce (5 adds on 32
    lanes); per live segment the midpoint and |p| (14), the three 7-step
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


def orbit(prt, views, det, z=0.3):
    return sum(prt.ConeRectGeom(det, pos=(2 * np.cos(t), 2 * np.sin(t), z),
                                fov=(45, 45))
               for t in np.linspace(0, 2 * np.pi, views, endpoint=False))


def main(argv):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="profile 5 training steps of each routed config "
                    "and of fused mode; write the traces to DIR")
    profile_dir = ap.parse_args(argv).profile
    t_start = time.time()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import sph_raytracer_tpu_torch as prt
    from sph_raytracer_tpu_torch.ops import fused_project as fp
    from sph_raytracer_tpu_torch.ops import routed_project as rp
    from sph_raytracer_tpu_torch.ops.project import precompute_table
    from sph_raytracer_tpu_torch.ops.trace import GridSpec
    from sph_raytracer_tpu_torch.tools import wfwd_probe
    from sph_raytracer_tpu_torch.tools.wfwd_probe import (HBM_BYTES_PER_S,
                                                          cuda_ms)

    # f32 stays f32 (no TF32 anywhere on the path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind}")

    # 2. build -------------------------------------------------------------
    t0 = time.time()
    _, build_log = rp.load_library()
    log(f"[build] {time.time() - t0:.2f} s")
    for line in build_log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"[build] {line.strip()}")

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
        if not rel <= 1e-5:
            raise AssertionError(f"adjoint identity fails for {bwd.__name__}")
    torch.cuda.synchronize()

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
    log(f"[step] {step_ms:.4f} ms/step, {R / (step_ms * 1e-3):.6g} rays/s "
        f"(fwd+bwd, {R} rays), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

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
    errs_lerp = check_rays(
        "fused_fwd lerp vs its plain version", y_dk,
        fp.fused_fwd_ref(opd.gs, drays, dd), 1e-5,
        1e-5 * float(y_dk.abs().max()), KNIFE_KERNEL)
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

    # 11. fused timings -------------------------------------------------------
    live = fused_live(torch, fp, fgs, frays)
    f_ms = cuda_ms(lambda: fp.fused_fwd(fgs, frays, d))
    f_plain = cuda_ms(lambda: fp.fused_fwd_ref(fgs, frays, d), n=5,
                      warm=1)
    f_ops = fused_ops(fgs, frays.n, mp, live, lerp=False)
    f_bytes = fused_bytes(frays.n, V, off0=False, lerp=False)
    f_op_ms, f_byte_ms = f_ops / F32_FLOPS * 1e3, f_bytes / HBM_BYTES_PER_S * 1e3
    dlive = fused_live(torch, fp, opd.gs, drays)
    d_ms = cuda_ms(lambda: fp.fused_fwd(opd.gs, drays, dd))
    d_plain = cuda_ms(lambda: fp.fused_fwd_ref(opd.gs, drays, dd),
                      n=5, warm=1)
    d_op_ms = fused_ops(opd.gs, drays.n, fp.padded_crossings(opd.gs), dlive,
                        lerp=True) / F32_FLOPS * 1e3
    d_byte_ms = fused_bytes(drays.n, opd._flat_size, True, True) \
        / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] fused_fwd: {f_ms:.4f} ms, plain {f_plain:.4f} ms, bound "
        f"{max(f_op_ms, f_byte_ms):.4f} ms ({f_ops} f32 ops, {live} live "
        f"segments, bytes bound {f_byte_ms:.4f} ms), "
        f"{max(f_op_ms, f_byte_ms) / f_ms:.1%} of the bound; routed_fwd on "
        f"the same rays {kernels[0]['ms']:.4f} ms")
    log(f"[kernel] fused_fwd lerp (view_times, {drays.n} rays): {d_ms:.4f} "
        f"ms, plain {d_plain:.4f} ms, bound {max(d_op_ms, d_byte_ms):.4f} ms "
        f"({dlive} live segments, bytes bound {d_byte_ms:.4f} ms), max abs "
        f"err {errs_lerp:.3e}")
    kernels.append({
        "name": "fused_fwd", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": REPLACES["fused_fwd"],
        "launches": fused_launches["fused_fwd"],
        "max_abs_err": errs["fused_fwd"], "ms": f_ms, "plain_ms": f_plain,
        "bound_ms": max(f_op_ms, f_byte_ms),
        "bound_by": "operations" if f_op_ms >= f_byte_ms else "bytes",
        "library_ms": None})

    fone = make_step(opf, yf)
    fstep_ms = cuda_ms(fone, n=30, warm=5)
    log(f"[fused step] {fstep_ms:.4f} ms/step, "
        f"{R / (fstep_ms * 1e-3):.6g} rays/s (fused_fwd + "
        f"routed_bwd_gather, {R} rays)")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

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

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        for label, fn in (("step", one), ("fused_step", fone),
                          *((f"{n}_step", f) for n, f in vsteps.items())):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            log(f"[profile] {label}, 5 steps")
            log(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=15))
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  f"{label}_trace.json"))

    log(f"[run] wall {time.time() - t_start:.1f} s")
    log(f"[card] {smi}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
