// Fused projection for NVIDIA Hopper (sm_90a): the whole crossing trace of
// a ray runs inside the kernel, so the forward y = A.d needs no tables at
// all.  Bound through a plain C interface and loaded with ctypes
// (sph_raytracer_tpu_torch/ops/_cuda.py builds it with nvcc at first use,
// with -fmad=false so each float op rounds as the plain version's does).
// The kernel, what it replaces and its design: fused_kernel.cuh.  The
// entry below launches the shipped design at every padded crossing count
// (Mp = 32 ... 512), its lerp kernels compiled in fused_project_lerp.cu;
// fused_sweep.cu holds the sweep's entry.

#include "fused_kernel.cuh"

// C interface: device pointers and the stream as void*, sizes as int.
// `mp` is the padded crossing count (a power of two, <= 512); off0, off1
// and w may be null (no time offset / no lerp; lerp needs both).  Returns
// cudaGetLastError() right after the launch (0 = ok).
extern "C" int fused_fwd(const void* xs, const void* dirs, const void* off0,
                         const void* off1, const void* w, const void* table,
                         const void* d, void* y, int n_rays, int nr, int ne,
                         int na, int mp, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t bad = check_args(off1, w, nr, ne, na);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  const Args a = make_args(xs, dirs, off0, off1, w, table, d, y, n_rays, nr,
                           ne, na);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = off1 != nullptr
                            ? launch_shipped_lerp(a, mp, s)
                            : launch_mp<kShipped, false>(a, mp, s);
  return static_cast<int>(e);
}
