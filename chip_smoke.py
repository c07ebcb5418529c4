#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --profile DIR    # adds a torch.profiler window;
                                           # its trace goes to DIR

Phases (any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``sph_raytracer_tpu_torch/csrc`` (nvcc),
   with ``-Xptxas -v`` register / spill lines;
3. the flagship operator: 50³ ``SphericalGrid``, a 50-view orbit of
   ``ConeRectGeom((50, 100))`` detectors (250,000 rays), ``mode='auto'``
   on CUDA (= routed), float32 — the configuration of ``bench.py``;
4. each kernel against its plain PyTorch version on the same CUDA tensors
   at the flagship's shapes, plus the adjoint identity;
5. goldens on the card: ``tests/goldens/collection_orbit.npz`` through the
   CUDA kernels (float64 trace, float32 tables), and the float32 routed
   ``Operator`` on the card against the same operator on the CPU;
6. the main path: ``retrieval.gd`` (FullyDenseModel + SquareLoss, Adam)
   for 20 iterations on the flagship, launch counters reset just before
   and read just after; then the ``routed_dense='off'`` path (scatter
   backward) the same way;
7. the ``bench.py`` training step (forward → MSE → grad → update) timed
   with CUDA events, and per-kernel times beside their plain versions,
   one PyTorch library call (``torch.sparse`` CSR mv) and the bound.

Before the last line: the card's name and power limit, then the
``{"kernels": [...]}`` line; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside tensor cores
REPLACES = {
    "routed_fwd": "sph_raytracer_tpu/ops/routed_project.py:581",
    "routed_bwd_gather": "sph_raytracer_tpu/ops/routed_project.py:905",
    "routed_bwd_scatter": "sph_raytracer_tpu/ops/routed_project.py:1142",
}
SOURCE = "sph_raytracer_tpu_torch/csrc/routed_project.cu"


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, n=20, warm=3):
    """Mean milliseconds per call of ``fn`` over ``n`` calls (CUDA
    events, after ``warm`` untimed calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def check_close(name, got, want, rtol, atol):
    err = float((got.double() - want.double()).abs().max())
    ok = bool(((got.double() - want.double()).abs()
               <= atol + rtol * want.double().abs()).all())
    log(f"[check] {name}: max_abs_err={err:.3e} (rtol={rtol}, "
        f"atol={atol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its reference")
    return err


def orbit(prt, views, det, z=0.3):
    return sum(prt.ConeRectGeom(det, pos=(2 * np.cos(t), 2 * np.sin(t), z),
                                fov=(45, 45))
               for t in np.linspace(0, 2 * np.pi, views, endpoint=False))


def main(argv):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="profile 5 training steps; write the trace to DIR")
    profile_dir = ap.parse_args(argv).profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import sph_raytracer_tpu_torch as prt
    from sph_raytracer_tpu_torch.ops import routed_project as rp
    from sph_raytracer_tpu_torch.ops.project import precompute_table
    from sph_raytracer_tpu_torch.ops.trace import GridSpec

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
    def step(v):
        v = v.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(torch.mean((op(v) - y) ** 2), v)
        return (v - 1e-3 * grad).detach()

    state = {"v": truth * 0.5}

    def one():
        state["v"] = step(state["v"])

    step_ms = cuda_ms(torch, one, n=30, warm=5)
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
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        lib_ms = cuda_ms(torch, lib)
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

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                one()
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=15))
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "step_trace.json"))

    log(f"[card] {smi}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
