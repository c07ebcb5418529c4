"""The fused kernel's order of work, in plain torch ops, against its plain
version (CPU; no JAX call).

``tools/fused_sweep.kernel_order`` mirrors what the shipped ``fused_fwd``
design does per ray: it compacts the finite crossings, sorts only the
first S = pow2(count) slots, walks the segments from the first t >= 0 to
the last finite value 32 at a time and sums one accumulator a lane, then
the shuffle tree.  On one grid per sort width (Mp = 32, 256 and 512) its
sorted rows and its labels must equal ``fused_fwd_ref``'s bitwise (the
walk skips no live segment), and its sums agree within rtol 1e-6 (another
order of f32 adds of positive terms).  ``ray_stats`` counts S per ray.
The three grids are one test case: under ``pytest-xdist --dist load`` the
suite's case count sets its chunks, and with them the tier-1 wall.
"""
import numpy as np
import torch

import sph_raytracer_tpu_torch as prt
from sph_raytracer_tpu_torch.ops import fused_project as fp
from sph_raytracer_tpu_torch.ops.trace import GridSpec
from sph_raytracer_tpu_torch.tools import fused_sweep

torch.set_num_threads(2)


# one grid per sort width: Mp = 32, 256 and 512
GRIDS = (((4, 4, 4), 32), ((50, 50, 50), 256), ((100, 60, 60), 512))


def test_kernel_order_matches_plain_version():
    geom = sum(prt.ConeRectGeom((6, 7), pos=(2 * np.cos(t), 2 * np.sin(t),
                                             0.3), fov=(45, 45))
               for t in np.linspace(0, 2 * np.pi, 3, endpoint=False))
    rays = fp.prep_rays(geom.ray_starts, geom.rays)
    for shape, mp in GRIDS:
        gs = GridSpec.from_grid(prt.SphericalGrid(shape=shape))
        assert fp.padded_crossings(gs) == mp
        d = torch.rand(int(np.prod(shape)),
                       generator=torch.Generator().manual_seed(5))
        ts, code, valid, y = fused_sweep.kernel_order(gs, rays, d)

        tab = fp.boundary_table(gs, "cpu")
        want_ts = torch.sort(fp._crossings(gs, tab, rays.xs, rays.dirs),
                             dim=1).values
        lens, live = fp._segments(want_ts)
        want_code, want_valid = fp._codes(gs, tab, rays.xs, rays.dirs,
                                          want_ts, lens, live)
        assert torch.equal(ts, want_ts), shape
        assert torch.equal(valid, want_valid) and bool(valid.any()), shape
        assert torch.equal(code[valid], want_code[want_valid]), shape
        torch.testing.assert_close(y, fp.fused_fwd_ref(gs, rays, d),
                                   rtol=1e-6, atol=0.0)

        stats = fused_sweep.ray_stats(gs, rays)
        n = torch.isfinite(want_ts).sum(1)
        S = torch.clamp(2 ** torch.ceil(torch.log2(n.double())), min=32)
        assert stats["sort_size_rays"] == {
            s: int((S == s).sum()) for s in (32, 64, 128, 256, 512)
            if s <= max(mp, 32)}, shape
        assert sum(stats["sort_size_rays"].values()) == rays.n
        assert stats["finite_max"] == int(n.max())
        assert stats["live"] == int(live.sum())
