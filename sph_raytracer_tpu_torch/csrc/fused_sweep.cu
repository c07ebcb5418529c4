// The sweep's entry of the fused kernel (tools/fused_sweep.py): either
// design of fused_kernel.cuh stopped after any stage, at Mp = 256 only;
// the shipped design's kernels here, the first port's in
// fused_sweep_parent.cu.

#include "fused_kernel.cuh"

// fused_fwd's arguments (mp must be 256), then `design` (a Design: 0 the
// kernel as first ported, 1 the shipped one) and `stage` (a Stage).
extern "C" int fused_fwd_sweep(const void* xs, const void* dirs,
                               const void* off0, const void* off1,
                               const void* w, const void* table,
                               const void* d, void* y, int n_rays, int nr,
                               int ne, int na, int mp, int design, int stage,
                               void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = check_args(off1, w, nr, ne, na);
  if (e == cudaSuccess && mp != 8 * kWarp) e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a = make_args(xs, dirs, off0, off1, w, table, d, y, n_rays, nr,
                           ne, na);
  const bool lerp = off1 != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case kParent: e = launch_parent_stage(a, lerp, stage, s); break;
    case kShipped: e = launch_stage<kShipped>(a, lerp, stage, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
