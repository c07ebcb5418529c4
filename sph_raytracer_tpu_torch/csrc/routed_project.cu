// Routed projection kernels for NVIDIA Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (sph_raytracer_tpu_torch/ops/
// routed_project.py builds this file with nvcc at first use).
//
// The operator is a sparse matrix A (rays x voxels) whose nonzeros are the
// traced segment lengths: y = A.d is the forward projection, dD = A^T.dy
// the backward.  The tables are GPU-native CSR built on the device by the
// wrapper module: a ray-major CSR (row_ptr, col, val) and, for the
// deterministic backward, its voxel-major transpose (vox_ptr, ray, valT),
// made with a stable sort so every voxel row lists its rays in ascending
// order and the summation order is fixed run to run.
//
// Replaces (sph_raytracer_tpu/ops/routed_project.py):
//   routed_fwd          <- _fwd_banded_pallas        (B1, the forward)
//   routed_bwd_gather   <- _bwd_banded_dense_pallas  (B2, the dense backward:
//                          deterministic, no scatter)
//   routed_bwd_scatter  <- _bwd_banded_pallas        (B3, the ray-grouped
//                          backward)
// The TPU kernels' 128-lane int8 routes, 8-row bands, superchunk pointers
// and SMEM bit-packing existed only because a TPU vector gather reaches 128
// lanes; an SM gathers from global memory directly, so none of it is kept.
//
// What bounds them on this card: bytes.  Each pass streams 8 B of table per
// live crossing (a 4 B index and a 4 B length) plus the row pointers, and
// does 2 flops per crossing (~0.25 flop/B, far below the H100's ~20 flop/B
// f32 balance point).  The gathered vector (the density or dy, at most a
// few MB) stays resident in the 50 MB L2, so its random reads cost L2, not
// HBM, bandwidth.  Design against that bound: one warp per CSR row, lanes
// striding over the row so each warp's table reads are coalesced 128 B
// transactions; the gathered vector goes through the read-only path
// (__ldg); the row sum is a register shuffle tree; one store per row.
// No shared memory, no atomics in the gather kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;  // 8 warps (rows) per block
constexpr unsigned kFull = 0xffffffffu;

// out[r] = sum over k in [ptr[r], ptr[r+1]) of x[idx[k]] * w[k].
// One warp per row; the whole warp leaves together, so the full-mask
// shuffle below always has 32 active lanes.
__device__ __forceinline__ void csr_row_dot(
    const int* __restrict__ ptr, const int* __restrict__ idx,
    const float* __restrict__ w, const float* __restrict__ x,
    float* __restrict__ out, int n_rows) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= n_rows) return;
  const int beg = __ldg(ptr + row);
  const int end = __ldg(ptr + row + 1);
  float acc = 0.f;
  for (int k = beg + lane; k < end; k += kWarp)
    acc = fmaf(__ldg(x + __ldg(idx + k)), __ldg(w + k), acc);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off);
  if (lane == 0) out[row] = acc;
}

// y = A.d over the ray-major CSR (one warp per ray).
__global__ void __launch_bounds__(kBlock)
routed_fwd_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ col,
                  const float* __restrict__ val,
                  const float* __restrict__ d, float* __restrict__ y,
                  int n_rays) {
  csr_row_dot(row_ptr, col, val, d, y, n_rays);
}

// dD = A^T.dy over the voxel-major CSR (one warp per voxel): every output
// is written once by one warp, in a fixed order — deterministic.
__global__ void __launch_bounds__(kBlock)
routed_bwd_gather_kernel(const int* __restrict__ vox_ptr,
                         const int* __restrict__ ray,
                         const float* __restrict__ valT,
                         const float* __restrict__ dy,
                         float* __restrict__ dD, int n_vox) {
  csr_row_dot(vox_ptr, ray, valT, dy, dD, n_vox);
}

// dD += A^T.dy over the ray-major CSR (one warp per ray, dy[ray] read
// once): no transpose is needed, but the atomic order varies run to run.
__global__ void __launch_bounds__(kBlock)
routed_bwd_scatter_kernel(const int* __restrict__ row_ptr,
                          const int* __restrict__ col,
                          const float* __restrict__ val,
                          const float* __restrict__ dy,
                          float* __restrict__ dD, int n_rays) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= n_rays) return;
  const float g = __ldg(dy + row);
  const int beg = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  for (int k = beg + lane; k < end; k += kWarp)
    atomicAdd(dD + __ldg(col + k), g * __ldg(val + k));
}

unsigned blocks_for(int n_rows) {
  return static_cast<unsigned>(
      (static_cast<long long>(n_rows) * kWarp + kBlock - 1) / kBlock);
}

}  // namespace

// C interface: device pointers and the stream as void*, sizes as int.
// Each entry returns cudaGetLastError() right after its launch (0 = ok).
extern "C" {

int routed_fwd(const void* row_ptr, const void* col, const void* val,
               const void* d, void* y, int n_rays, void* stream) {
  if (n_rays > 0)
    routed_fwd_kernel<<<blocks_for(n_rays), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const float*>(val), static_cast<const float*>(d),
        static_cast<float*>(y), n_rays);
  return static_cast<int>(cudaGetLastError());
}

int routed_bwd_gather(const void* vox_ptr, const void* ray,
                      const void* valT, const void* dy, void* dD, int n_vox,
                      void* stream) {
  if (n_vox > 0)
    routed_bwd_gather_kernel<<<blocks_for(n_vox), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(vox_ptr), static_cast<const int*>(ray),
        static_cast<const float*>(valT), static_cast<const float*>(dy),
        static_cast<float*>(dD), n_vox);
  return static_cast<int>(cudaGetLastError());
}

int routed_bwd_scatter(const void* row_ptr, const void* col, const void* val,
                       const void* dy, void* dD, int n_rays, int n_vox,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dD, 0, sizeof(float) * n_vox, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays > 0)
    routed_bwd_scatter_kernel<<<blocks_for(n_rays), kBlock, 0, s>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const float*>(val), static_cast<const float*>(dy),
        static_cast<float*>(dD), n_rays);
  return static_cast<int>(cudaGetLastError());
}

const char* routed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
