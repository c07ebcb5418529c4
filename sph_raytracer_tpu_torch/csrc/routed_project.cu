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
// live crossing (a 4 B index and a 4 B length; 6 B with bf16 lengths) plus
// the row pointers, and
// does 2 flops per crossing (~0.25 flop/B, far below the H100's ~20 flop/B
// f32 balance point).  The gathered vector (the density or dy, at most a
// few MB) stays resident in the 50 MB L2, so its random reads cost L2, not
// HBM, bandwidth.  No shared memory, no atomics in the gather kernels.
//
// routed_fwd and routed_bwd_gather were one warp a CSR row, its lanes
// striding the row one 4 B index and one length at a time, and latency,
// not bytes, held them at 45-61 % of the bound (1.43x and 1.10x torch.mv's
// time, PERF.md section 6): each step of a lane was a chain of an index
// load, the gather it addresses and one FMA, with 8 B of table in flight a
// lane, and the flagship's rays (a mean of 68.6 crossings) filled a warp's
// 32-crossing steps 81 %.  So a row now takes a group of L lanes (a warp
// holds 32 / L rows, its row pointers one coalesced load), and each lane
// walks the row in aligned quads (one 16 B index load, one 16 B or 8 B
// weight load, the row's unaligned head and tail masked): 32 B of table in
// flight a lane and 4 L crossings a group step.  The group sums its lanes
// by shuffles in a fixed tree and one lane stores the row, so the sums keep
// a fixed order (two launches are bitwise equal) and each output is written
// once.  The sweep (tools/fwd_sweep.py, tools/bwd_sweep.py) set L by the
// rows' lengths: 8 lanes a ray, 16 a voxel (a mean of 147.2 crossings),
// about two quads a lane a row; fewer lanes leave long chains, more leave
// lanes empty.
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
//
// Each kernel is a template on its weight type Weight: float, or
// __nv_bfloat16 for routed_w_dtype='bf16' (the C entries <name>_bf16),
// whose tables store 2 B a length instead of 4.  The weight is widened to
// f32 at its load (load_w, weight.cuh); the arithmetic and the order of
// the sums do not change with the type.

#include <cuda_runtime.h>

#include "weight.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// The settings of the two gathers, from tools/fwd_sweep.py and
// tools/bwd_sweep.py on an H100 at the flagship (PERF.md section 6): lanes
// a row (a live ray holds 68.6 crossings on average, a live voxel 147.2)
// and quads a lane a step.  CTAs of 128 threads, and the next step's loads
// issued before this step's FMAs, moved them by 3 % or less.
constexpr int kFwdLanes = 8, kFwdQuads = 1;
constexpr int kBwdLanes = 16, kBwdQuads = 1;
constexpr int kBlock = 256;

// out[r] = sum over k in [ptr[r], ptr[r+1]) of x[idx[k]] * w[k] for the
// kWarp / L rows of this thread's warp, a group of L lanes a row.  The
// warp loads its rows' kWarp / L + 1 row pointers in one coalesced load
// and hands them out by shuffles; rows past n_rows read the empty row
// [nnz, nnz) and store nothing.  Lane g of a group walks its row in
// aligned quads (4-aligned crossing offsets; load_quad: one 16 B index
// load, one 16 B or 8 B weight load), quads g, g + L, g + 2L, ... of the
// row, U a step: it issues the step's quad loads, then its gathers of x,
// then its FMAs.  The crossings of a quad outside [ptr[r], ptr[r+1]) (the
// row's unaligned head and tail) are masked: no gather, no FMA.  The group
// then sums its lanes by log2 L shuffles in a fixed tree and lane 0 stores
// the row: each output written once, in an order fixed run to run.  All 32
// lanes reach the shuffles.
template <int L, int U, typename Weight>
__device__ __forceinline__ void csr_group_dot(
    const int* __restrict__ ptr, const int* __restrict__ idx,
    const Weight* __restrict__ w, const float* __restrict__ x,
    float* __restrict__ out, int n_rows) {
  static_assert(L >= 2 && L <= kWarp && (L & (L - 1)) == 0, "lanes a row");
  constexpr int kRows = kWarp / L;  // rows a warp
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int g = lane & (L - 1);
  const long long r0 = warp * kRows;
  const int p = lane <= kRows
      ? __ldg(ptr + min(r0 + lane, static_cast<long long>(n_rows)))
      : 0;
  const int nnz = __ldg(ptr + n_rows);
  const int beg = __shfl_sync(kFull, p, lane / L);
  const int end = __shfl_sync(kFull, p, lane / L + 1);
  float acc = 0.f;
  for (int q = (beg & ~3) + 4 * g; q < end; q += 4 * L * U) {
    int c[U][4];
    float v[U][4], xs[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q + 4 * L * u < end) {
        load_quad(idx, w, q + 4 * L * u, nnz, c[u], v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) c[u][i] = 0, v[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = q + 4 * L * u + i;
        xs[u][i] = k >= beg && k < end ? __ldg(x + c[u][i]) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = q + 4 * L * u + i;
        if (k >= beg && k < end) acc = fmaf(xs[u][i], v[u][i], acc);
      }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off, L);
  const long long row = r0 + lane / L;
  if (g == 0 && row < n_rows) out[row] = acc;
}

// y = A.d over the ray-major CSR (a group of kFwdLanes lanes a ray).
template <typename Weight>
__global__ void __launch_bounds__(kBlock)
routed_fwd_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ col,
                  const Weight* __restrict__ val,
                  const float* __restrict__ d, float* __restrict__ y,
                  int n_rays) {
  csr_group_dot<kFwdLanes, kFwdQuads>(row_ptr, col, val, d, y, n_rays);
}

// dD = A^T.dy over the voxel-major CSR (a group of kBwdLanes lanes a
// voxel): every output is written once by one group, in a fixed order —
// deterministic.
template <typename Weight>
__global__ void __launch_bounds__(kBlock)
routed_bwd_gather_kernel(const int* __restrict__ vox_ptr,
                         const int* __restrict__ ray,
                         const Weight* __restrict__ valT,
                         const float* __restrict__ dy,
                         float* __restrict__ dD, int n_vox) {
  csr_group_dot<kBwdLanes, kBwdQuads>(vox_ptr, ray, valT, dy, dD, n_vox);
}

// The same walk at other lanes and quads (the sweeps' entry
// routed_csr_dot).
template <int L, int U, typename Weight>
__global__ void __launch_bounds__(kBlock)
csr_dot_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
               const Weight* __restrict__ w, const float* __restrict__ x,
               float* __restrict__ out, int n_rows) {
  csr_group_dot<L, U>(ptr, idx, w, x, out, n_rows);
}

// CTAs of kBlock threads for n_rows rows of L lanes
unsigned blocks_for(int n_rows, int L) {
  return static_cast<unsigned>(
      (static_cast<long long>(n_rows) * L + kBlock - 1) / kBlock);
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
template <typename Weight>
__global__ void __launch_bounds__(kScatterBlock)
routed_bwd_scatter_kernel(const int* __restrict__ row_ptr,
                          const int* __restrict__ col,
                          const Weight* __restrict__ val,
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
        x[u] = k < end ? load_w(val + k) : 0.f;
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

// The launches behind the C entries, one instantiation a weight type.
// Each returns cudaGetLastError() right after its launch (0 = ok).
template <typename Weight>
int launch_fwd(const void* row_ptr, const void* col, const void* val,
               const void* d, void* y, int n_rays, void* stream) {
  if (n_rays > 0)
    routed_fwd_kernel<Weight><<<blocks_for(n_rays, kFwdLanes), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const Weight*>(val), static_cast<const float*>(d),
        static_cast<float*>(y), n_rays);
  return static_cast<int>(cudaGetLastError());
}

template <typename Weight>
int launch_bwd_gather(const void* vox_ptr, const void* ray, const void* valT,
                      const void* dy, void* dD, int n_vox, void* stream) {
  if (n_vox > 0)
    routed_bwd_gather_kernel<Weight><<<blocks_for(n_vox, kBwdLanes), kBlock,
                                       0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(vox_ptr), static_cast<const int*>(ray),
        static_cast<const Weight*>(valT), static_cast<const float*>(dy),
        static_cast<float*>(dD), n_vox);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int U, typename Weight>
int launch_dot(const void* ptr, const void* idx, const void* w,
               const void* x, void* out, int n_rows, void* stream) {
  if (n_rows > 0)
    csr_dot_kernel<L, U, Weight><<<blocks_for(n_rows, L), kBlock, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(idx),
        static_cast<const Weight*>(w), static_cast<const float*>(x),
        static_cast<float*>(out), n_rows);
  return static_cast<int>(cudaGetLastError());
}

// lanes 2, 4, 8, 16 or 32 a row; quads 1 or 2 a lane a step
template <int U, typename Weight>
int launch_dot_lanes(const void* ptr, const void* idx, const void* w,
                     const void* x, void* out, int n_rows, int lanes,
                     void* stream) {
  switch (lanes) {
    case 2: return launch_dot<2, U, Weight>(ptr, idx, w, x, out, n_rows,
                                            stream);
    case 4: return launch_dot<4, U, Weight>(ptr, idx, w, x, out, n_rows,
                                            stream);
    case 8: return launch_dot<8, U, Weight>(ptr, idx, w, x, out, n_rows,
                                            stream);
    case 16: return launch_dot<16, U, Weight>(ptr, idx, w, x, out, n_rows,
                                              stream);
    case 32: return launch_dot<32, U, Weight>(ptr, idx, w, x, out, n_rows,
                                              stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Weight>
int launch_csr_dot(const void* ptr, const void* idx, const void* w,
                   const void* x, void* out, int n_rows, int lanes,
                   int quads, void* stream) {
  if (quads == 1)
    return launch_dot_lanes<1, Weight>(ptr, idx, w, x, out, n_rows, lanes,
                                       stream);
  if (quads == 2)
    return launch_dot_lanes<2, Weight>(ptr, idx, w, x, out, n_rows, lanes,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tile rays a CTA, slots (a power of two) in its table; counts (nullable,
// int32 x 2, not zeroed here) gathers the global atomics issued and the
// crossings that overflowed the table.
template <typename Weight>
int launch_bwd_scatter(const void* row_ptr, const void* col, const void* val,
                       const void* dy, void* dD, void* counts, int n_rays,
                       int n_vox, int tile, int slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dD, 0, sizeof(float) * n_vox, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(slots)
                                     + 2 * static_cast<size_t>(tile) + 1);
  err = cudaFuncSetAttribute(routed_bwd_scatter_kernel<Weight>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  routed_bwd_scatter_kernel<Weight><<<
      static_cast<unsigned>((static_cast<long long>(n_rays) + tile - 1) /
                            tile),
      kScatterBlock, smem, s>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const Weight*>(val), static_cast<const float*>(dy),
      static_cast<float*>(dD), static_cast<int*>(counts), n_rays, tile,
      slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: device pointers and the stream as void*, sizes as int.
// <name> reads float32 weights, <name>_bf16 bfloat16 ones.
extern "C" {

int routed_fwd(const void* row_ptr, const void* col, const void* val,
               const void* d, void* y, int n_rays, void* stream) {
  return launch_fwd<float>(row_ptr, col, val, d, y, n_rays, stream);
}

int routed_fwd_bf16(const void* row_ptr, const void* col, const void* val,
                    const void* d, void* y, int n_rays, void* stream) {
  return launch_fwd<__nv_bfloat16>(row_ptr, col, val, d, y, n_rays, stream);
}

int routed_bwd_gather(const void* vox_ptr, const void* ray,
                      const void* valT, const void* dy, void* dD, int n_vox,
                      void* stream) {
  return launch_bwd_gather<float>(vox_ptr, ray, valT, dy, dD, n_vox,
                                  stream);
}

int routed_bwd_gather_bf16(const void* vox_ptr, const void* ray,
                           const void* valT, const void* dy, void* dD,
                           int n_vox, void* stream) {
  return launch_bwd_gather<__nv_bfloat16>(vox_ptr, ray, valT, dy, dD, n_vox,
                                          stream);
}

// routed_fwd's and routed_bwd_gather's walk at `lanes` lanes a row and
// `quads` quads a lane a step (the sweeps' entry; 1 = cudaErrorInvalidValue
// for another setting)
int routed_csr_dot(const void* ptr, const void* idx, const void* w,
                   const void* x, void* out, int n_rows, int lanes,
                   int quads, void* stream) {
  return launch_csr_dot<float>(ptr, idx, w, x, out, n_rows, lanes, quads,
                               stream);
}

int routed_csr_dot_bf16(const void* ptr, const void* idx, const void* w,
                        const void* x, void* out, int n_rows, int lanes,
                        int quads, void* stream) {
  return launch_csr_dot<__nv_bfloat16>(ptr, idx, w, x, out, n_rows, lanes,
                                       quads, stream);
}

int routed_bwd_scatter(const void* row_ptr, const void* col, const void* val,
                       const void* dy, void* dD, void* counts, int n_rays,
                       int n_vox, int tile, int slots, void* stream) {
  return launch_bwd_scatter<float>(row_ptr, col, val, dy, dD, counts,
                                   n_rays, n_vox, tile, slots, stream);
}

int routed_bwd_scatter_bf16(const void* row_ptr, const void* col,
                            const void* val, const void* dy, void* dD,
                            void* counts, int n_rays, int n_vox, int tile,
                            int slots, void* stream) {
  return launch_bwd_scatter<__nv_bfloat16>(row_ptr, col, val, dy, dD, counts,
                                           n_rays, n_vox, tile, slots,
                                           stream);
}

const char* routed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
