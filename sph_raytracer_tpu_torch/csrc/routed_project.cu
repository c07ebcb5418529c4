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
//
// routed_bwd_scatter reads the same ray-major CSR and no transpose, so it
// must scatter: one global atomicAdd a crossing (17.1 M onto 125,000
// voxels at the flagship) held it at 4x torch.mv's time on the transpose
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
// Neighbouring rays (adjacent pixels of one view) cross mostly the same
// voxels, so it runs one CTA per tile of consecutive rays (each warp takes
// whole rays, its lanes striding the ray's crossings, coalesced) and adds
// each crossing's dy[ray]·val into an open-addressing table in shared
// memory keyed by voxel (atomicCAS claims a slot, a shared atomicAdd sums
// into it).  The CTA then issues one global atomicAdd per occupied slot.
// A crossing whose voxel finds no slot within kProbes goes straight to a
// global atomic, so a tile with more distinct voxels than slots stays
// right; the optional counts (int32 x 2) gather the global atomics issued
// and those overflowed crossings.  On the card the shared-table work, not
// the global atomics, now sets its time (PERF.md section 6).

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

constexpr int kScatterBlock = 512;
constexpr int kScatterWarps = kScatterBlock / kWarp;
constexpr int kScatterUnroll = 4;  // crossings a lane loads before adding
constexpr int kProbes = 8;         // slots a crossing tries before overflow
constexpr int kEmpty = -1;         // the key of a free slot

// Add v into the slot of voxel `key` in the shared table (keys_s, vals_s)
// of mask + 1 slots, probing linearly from slot key & mask (a ray's
// neighbouring voxels land in neighbouring banks).  A slot's key goes from
// kEmpty to a voxel once, by atomicCAS, and never changes again.  Returns
// false when kProbes slots in a row hold other voxels.
__device__ __forceinline__ bool table_add(int* keys_s, float* vals_s,
                                          unsigned mask, int key, float v) {
  unsigned h = static_cast<unsigned>(key) & mask;
  for (int p = 0; p < kProbes; ++p, h = (h + 1) & mask) {
    int cur = static_cast<volatile int*>(keys_s)[h];
    if (cur == kEmpty) cur = atomicCAS(keys_s + h, kEmpty, key);
    if (cur == kEmpty || cur == key) {
      atomicAdd(vals_s + h, v);
      return true;
    }
  }
  return false;
}

// dD += A^T.dy over the ray-major CSR, one CTA per tile of `tile` rays.
// Shared memory: keys_s[slots], vals_s[slots], the tile's row pointers
// ptr_s[tile + 1] and its dy_s[tile].  Each warp takes whole rays (r =
// warp, warp + kScatterWarps, ...), its lanes striding the ray's
// crossings (coalesced), dy[r] one shared read a ray.  The atomics (shared
// and global) sum in a run-to-run order.
__global__ void __launch_bounds__(kScatterBlock)
routed_bwd_scatter_kernel(const int* __restrict__ row_ptr,
                          const int* __restrict__ col,
                          const float* __restrict__ val,
                          const float* __restrict__ dy,
                          float* __restrict__ dD, int* __restrict__ counts,
                          int n_rays, int tile, int slots) {
  extern __shared__ int smem[];
  int* keys_s = smem;
  float* vals_s = reinterpret_cast<float*>(smem + slots);
  int* ptr_s = smem + 2 * slots;
  float* dy_s = reinterpret_cast<float*>(ptr_s + tile + 1);
  const int r0 = blockIdx.x * tile;
  const int n = min(tile, n_rays - r0);
  for (int i = threadIdx.x; i < slots; i += kScatterBlock) {
    keys_s[i] = kEmpty;
    vals_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i <= n; i += kScatterBlock)
    ptr_s[i] = __ldg(row_ptr + r0 + i);
  for (int i = threadIdx.x; i < n; i += kScatterBlock)
    dy_s[i] = __ldg(dy + r0 + i);
  __syncthreads();
  const unsigned mask = static_cast<unsigned>(slots) - 1u;
  const int lane = threadIdx.x & (kWarp - 1);
  int n_over = 0;
  for (int r = threadIdx.x / kWarp; r < n; r += kScatterWarps) {
    const float g = dy_s[r];
    const int end = ptr_s[r + 1];
    for (int k0 = ptr_s[r] + lane; k0 < end; k0 += kScatterUnroll * kWarp) {
      int c[kScatterUnroll];
      float x[kScatterUnroll];
#pragma unroll
      for (int u = 0; u < kScatterUnroll; ++u) {
        const int k = k0 + u * kWarp;
        c[u] = k < end ? __ldg(col + k) : kEmpty;
        x[u] = k < end ? __ldg(val + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kScatterUnroll; ++u) {
        if (c[u] == kEmpty) break;
        const float v = g * x[u];
        if (!table_add(keys_s, vals_s, mask, c[u], v)) {
          atomicAdd(dD + c[u], v);
          ++n_over;
        }
      }
    }
  }
  __syncthreads();
  int n_flush = 0;
  for (int i = threadIdx.x; i < slots; i += kScatterBlock) {
    const int key = keys_s[i];
    if (key != kEmpty) {
      atomicAdd(dD + key, vals_s[i]);
      ++n_flush;
    }
  }
  if (counts) {
    int issued = n_flush + n_over;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      issued += __shfl_down_sync(kFull, issued, off);
      n_over += __shfl_down_sync(kFull, n_over, off);
    }
    if (lane == 0) {
      atomicAdd(counts, issued);
      atomicAdd(counts + 1, n_over);
    }
  }
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

// tile rays a CTA, slots (a power of two) in its table; counts (nullable,
// int32 x 2, not zeroed here) gathers the global atomics issued and the
// crossings that overflowed the table.
int routed_bwd_scatter(const void* row_ptr, const void* col, const void* val,
                       const void* dy, void* dD, void* counts, int n_rays,
                       int n_vox, int tile, int slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dD, 0, sizeof(float) * n_vox, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(slots)
                                     + 2 * static_cast<size_t>(tile) + 1);
  err = cudaFuncSetAttribute(routed_bwd_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  routed_bwd_scatter_kernel<<<
      static_cast<unsigned>((static_cast<long long>(n_rays) + tile - 1) /
                            tile),
      kScatterBlock, smem, s>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const float*>(dy),
      static_cast<float*>(dD), static_cast<int*>(counts), n_rays, tile,
      slots);
  return static_cast<int>(cudaGetLastError());
}

const char* routed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
