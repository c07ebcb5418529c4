// The routed engine's other forward / backward variants for NVIDIA Hopper
// (sm_90a), bound through the same plain C interface and ctypes loader as
// routed_project.cu (sph_raytracer_tpu_torch/ops/_cuda.py builds both with
// one nvcc call at first use).
//
// All five compute the same sparse matrix A (rays x voxels) of traced
// segment lengths as routed_project.cu, in f32 with f32 accumulation, each
// over a different table layout built by ops/routed_project.py:
//
//   routed_fwd_dense   <- _fwd_banded_dense_pallas (B5): y = A.d over the
//                         voxel-major transpose (vox_ptr, ray, valT)
//   routed_fwd_hist    <- _fwd_banded_hist_pallas  (B6): y = A.d over the
//                         ray-major CSR (row_ptr, col, val), one CTA per
//                         tile of rays
//   routed_fwd_window  <- _fwd_pallas              (B7a): y = A.d over the
//                         window chunk table
//   routed_bwd_window  <- _bwd_pallas              (B7b): dD = A^T.dy over
//                         the same chunk table
//   routed_fwd_densew  <- _fwd_banded_densew_pallas (B8): y = A.d over the
//                         same chunk table, window-major
//
// (all in sph_raytracer_tpu/ops/routed_project.py).  As in
// routed_project.cu, the TPU kernels' int8 lane routes, 8-row bands,
// superchunk pointers and SMEM bit-packing are dropped: an SM gathers from
// global or shared memory directly.
//
// What bounds them on this card: bytes.  Each streams 8 B of table per
// live crossing (an index and a length) and does 2 flops per crossing, far
// below the H100's f32 balance point; the gathered vector (d or dy, at
// most a few MB) stays in the 50 MB L2.  What each design does about it:
//
// * routed_fwd_dense: the TPU kernel's idea is "slot = density window:
//   each density value is fetched once".  Here one warp per voxel reads
//   d[v] once into a register and strides the voxel's rays with coalesced
//   table reads, adding valT[k]*d[v] into y[ray[k]] with global atomics
//   (the C entry zeroes y first).  It reads the gather backward's tables,
//   so routed_dense='both' trains on the transpose alone.  The atomics sum
//   in a run-to-run order.
// * routed_fwd_hist: the TPU kernel's idea is a reduce whose cost barely
//   depends on how many crossings each ray has.  Here one CTA owns a tile
//   of kHistTile rays and walks the tile's crossing range kBlock crossings
//   at a time, one per thread, so every table load is coalesced and ragged
//   rows leave no lane idle.  Each thread advances its ray through the
//   tile's row pointers (staged in shared memory); each warp sums every
//   ray's run in registers (a segmented shuffle scan), and the run's last
//   lane adds the total into a shared-memory y tile, flushed once with
//   coalesced stores.  No global atomics; the shared adds sum in a
//   run-to-run order.
// * routed_fwd_window / routed_bwd_window: the TPU kernels' idea is chunks
//   of (ray tile, density window), with the window's density (forward) or
//   the tile's dy (backward) staged in fast memory.  The chunk table holds
//   the live crossings sorted by chunk, 8 B each: one int32 packing the
//   ray's offset in its tile (high 16 bits) and the voxel's offset in its
//   window (low 16 bits), and one f32 length.  The forward runs one CTA per
//   ray tile over its chunks in window order: it stages the window's slice
//   of d in shared memory, sums each ray's run in the warp and adds it into
//   a shared y tile, and writes the tile once (no global atomics).  Tile
//   (G rays) and window (W voxels) sizes come from the wrapper
//   (ops/routed_project.py WIN_G = 1024, WIN_W = 256): at the flagship
//   (250,000 rays, 125,000 voxels) 245 tiles, so the forward launches more
//   CTAs than the card's 132 SMs.  With that few CTAs an SM, a chunk of a
//   few hundred crossings is too little work to hide its barrier and load
//   latency: each CTA is kGroups groups that walk different chunks at once,
//   each with its own staging buffer, so a CTA holds G + kGroups·W floats
//   of shared memory (12 KB).
//   The backward was one CTA per window too, and three things held it at
//   4x torch.mv's time (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
//   section 6): the hottest window holds 4x the mean window's
//   crossings, and its CTA set the kernel's tail; each chunk staged its
//   tile's whole dy slice (1,024 floats for a mean of 421 crossings: more
//   bytes than the table); and the crossings of a chunk, sorted by ray,
//   land ~3.8 to a voxel in the shared adds.  So it walks work items
//   instead (built with the table: each window's chunks in bwd_order cut
//   at chunk boundaries into runs of at most K crossings, K = WIN_K =
//   4096), one CTA an item, the item's chunks laid end to end so that every
//   thread takes one crossing a step whatever the chunk sizes; dy is read
//   at each crossing through the read-only path (a chunk's rays lie in one
//   4 KB tile slice, hot in L1 / L2), with no staging and no barrier a
//   chunk; a window split into several items is flushed with one global
//   atomic a voxel an item.  The balance is what moved its time; summing
//   a warp's equal voxels before the shared add (__match_any_sync) cost
//   more than the collisions it saved, so the shared adds stay plain
//   (PERF.md section 6).  The shared and global atomics sum in a
//   run-to-run order.
// * routed_fwd_densew: the TPU kernel's idea is a window-major forward:
//   each density window is fetched once (one DMA a superchunk), and the
//   whole y stays resident in VMEM, accumulated across the sequential grid.
//   Here one CTA per voxel window stages the window's W density values in
//   shared memory once and walks the window's chunks in tile order
//   (bwd_order, as routed_bwd_window), its kGroups groups on different
//   chunks; a warp sums each ray's run (crossings of a chunk are sorted by
//   ray) and adds the total into the global y, which the C entry zeroes
//   first.  A y resident on chip does not carry over: CTAs run in
//   parallel and in no order, and each (tile, window) pair is one chunk,
//   so a shared y tile would collect nothing across chunks.  The resident
//   y is the global one (1 MB at the flagship), kept in L2, one atomic per
//   (ray, chunk, 32-crossing slice) run instead of B5's one per crossing.
//   The atomics sum in a run-to-run order; the hottest window's CTA holds
//   about 4x the mean window's crossings at the flagship.
//
// routed_fwd_dense, routed_fwd_hist and routed_fwd_densew are templates on
// their weight type Weight, as routed_project.cu's kernels are: float, or
// __nv_bfloat16 for routed_w_dtype='bf16' (the C entries <name>_bf16),
// widened to f32 at the load (load_w, weight.cuh).  The window engine's
// pair takes float32 weights only: the JAX package never runs it on bf16
// tables (routed_w_dtype applies to the banded engine alone).

#include <cuda_runtime.h>

#include "weight.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kHistTile = 256;  // rays per CTA of routed_fwd_hist
constexpr unsigned kFull = 0xffffffffu;

// y += A.d over the voxel-major transpose: one warp per voxel.
template <typename Weight>
__global__ void __launch_bounds__(kBlock)
routed_fwd_dense_kernel(const int* __restrict__ vox_ptr,
                        const int* __restrict__ ray,
                        const Weight* __restrict__ valT,
                        const float* __restrict__ d, float* __restrict__ y,
                        int n_vox) {
  const long long v =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  if (v >= n_vox) return;
  const int beg = __ldg(vox_ptr + v);
  const int end = __ldg(vox_ptr + v + 1);
  if (beg == end) return;
  const float dv = __ldg(d + v);
  for (int k = beg + lane; k < end; k += kWarp)
    atomicAdd(y + __ldg(ray + k), load_w(valT + k) * dv);
}

// Inclusive sum of x over the lanes of this warp that hold the same key,
// for keys non-decreasing across the warp's valid lanes (invalid lanes hold
// key -1 at the warp's tail); returns whether this lane is the last of its
// run, which then holds the run's total.  All 32 lanes must call it.
__device__ __forceinline__ bool warp_run_sum(int key, float& x) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const float xo = __shfl_up_sync(kFull, x, off);
    const int ko = __shfl_up_sync(kFull, key, off);
    if (lane >= off && ko == key) x += xo;
  }
  const int next = __shfl_down_sync(kFull, key, 1);
  return key >= 0 && (lane == kWarp - 1 || next != key);
}

// y = A.d over the ray-major CSR, one CTA per kHistTile rays.  The tile's
// crossings are taken kBlock at a time, one per thread (coalesced); each
// thread advances its ray through the tile's row pointers (kept in shared
// memory), a warp sums each ray's run in registers (warp_run_sum), and the
// run's last lane adds the total into the shared y tile.
template <typename Weight>
__global__ void __launch_bounds__(kBlock)
routed_fwd_hist_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col,
                       const Weight* __restrict__ val,
                       const float* __restrict__ d, float* __restrict__ y,
                       int n_rays) {
  __shared__ float y_s[kHistTile];
  __shared__ int ptr_s[kHistTile + 1];
  const int r0 = blockIdx.x * kHistTile;
  const int n = min(kHistTile, n_rays - r0);
  for (int i = threadIdx.x; i <= n; i += kBlock)
    ptr_s[i] = __ldg(row_ptr + r0 + i);
  for (int i = threadIdx.x; i < kHistTile; i += kBlock) y_s[i] = 0.f;
  __syncthreads();
  const int end = ptr_s[n];
  int r = 0;  // this thread's ray in the tile, advanced as k grows
  for (int k = ptr_s[0] + threadIdx.x; k - threadIdx.x < end; k += kBlock) {
    int key = -1;
    float x = 0.f;
    if (k < end) {
      while (ptr_s[r + 1] <= k) ++r;
      key = r;
      x = __ldg(d + __ldg(col + k)) * load_w(val + k);
    }
    if (warp_run_sum(key, x)) atomicAdd(y_s + key, x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kBlock) y[r0 + i] = y_s[i];
}

// The window forwards (routed_fwd_window, routed_fwd_densew): a CTA of
// kWinBlock threads is kGroups groups of
// kGroupThreads, each walking its own share of the CTA's chunks (chunk
// c, c + kGroups, ...) with its own staging buffer and its own named
// barrier, so that several chunks' loads are in flight at once (one CTA a
// tile or window is only about two CTAs an SM at the flagship).  Each
// thread issues kUnroll crossings' table loads before it updates shared
// memory.  The groups add into the CTA's one output tile in shared memory.
constexpr int kWinBlock = 1024;
constexpr int kGroups = 8;
constexpr int kGroupThreads = kWinBlock / kGroups;
constexpr int kUnroll = 4;

// barrier of the kGroupThreads threads of group g (named barrier g + 1;
// barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(kGroupThreads)
               : "memory");
}

// y = A.d over the window chunk table: one CTA per ray tile, its chunks in
// window order.  Shared memory: y_s[G], then one d_s[W] a group.  The
// crossings of a chunk are sorted by ray, so a warp sums each ray's run
// before one shared add.
__global__ void __launch_bounds__(kWinBlock)
routed_fwd_window_kernel(const int* __restrict__ tile_ptr,
                         const int* __restrict__ ckey,
                         const int* __restrict__ cptr,
                         const int* __restrict__ loc,
                         const float* __restrict__ val,
                         const float* __restrict__ d, float* __restrict__ y,
                         int n_win, int n_rays, int n_vox, int G, int W) {
  extern __shared__ float smem[];
  const int g = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;
  float* y_s = smem;
  float* d_s = smem + G + g * W;
  const int t = blockIdx.x;
  const int r0 = t * G;
  const int nr = min(G, n_rays - r0);
  for (int i = threadIdx.x; i < nr; i += kWinBlock) y_s[i] = 0.f;
  __syncthreads();
  const int c_end = __ldg(tile_ptr + t + 1);
  for (int c = __ldg(tile_ptr + t) + g; c < c_end; c += kGroups) {
    const int v0 = (__ldg(ckey + c) % n_win) * W;
    const int nv = min(W, n_vox - v0);
    group_sync(g);  // the group's previous chunk is done with d_s
    for (int i = gt; i < nv; i += kGroupThreads) d_s[i] = __ldg(d + v0 + i);
    group_sync(g);
    const int k_beg = __ldg(cptr + c), k_end = __ldg(cptr + c + 1);
    for (int k0 = k_beg; k0 < k_end; k0 += kUnroll * kGroupThreads) {
      unsigned p[kUnroll];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kGroupThreads + gt;
        p[u] = k < k_end ? static_cast<unsigned>(__ldg(loc + k)) : 0u;
        w[u] = k < k_end ? __ldg(val + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = k0 + u * kGroupThreads + gt < k_end;
        const int key = live ? static_cast<int>(p[u] >> 16) : -1;
        float x = live ? w[u] * d_s[p[u] & 0xffffu] : 0.f;
        if (warp_run_sum(key, x)) atomicAdd(y_s + key, x);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr; i += kWinBlock) y[r0 + i] = y_s[i];
}

// routed_bwd_window: one CTA of kItemBlock threads per work item of the
// chunk table (item_ptr / item_win: a run of one window's chunks in
// bwd_order of at most K crossings, or one larger chunk), kUnroll crossings
// a thread a step.
constexpr int kItemBlock = 256;
constexpr int kItemWarps = kItemBlock / kWarp;

// Exclusive prefix sum of n over the CTA's threads in thread order; total
// gets the sum over all of them.  Every thread must call it; warp_s holds
// kItemWarps ints.
__device__ __forceinline__ int block_exclusive_sum(int n, int* warp_s,
                                                   int& total) {
  const int lane = threadIdx.x & (kWarp - 1), wid = threadIdx.x / kWarp;
  int incl = n;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == kWarp - 1) warp_s[wid] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kItemWarps; ++i) {
    const int s = warp_s[i];
    if (i < wid) before += s;
    total += s;
  }
  return before + incl - n;
}

// dD = A^T.dy over the same chunk table, one CTA per work item.  The
// item's chunks are taken kItemBlock at a time: each thread loads one
// chunk's first crossing and tile, a CTA prefix sum lays the chunks end to
// end, and the CTA walks that concatenation kItemBlock crossings at a time
// (each thread advancing its chunk as its position grows), reading dy at
// each crossing's ray through the read-only path and adding val·dy into
// the shared window dD_s[W].  The CTA then writes its window (the item is
// the whole window) or adds it with one global atomic a voxel (the window
// is split; the C entry zeroes dD).  Shared and global atomics sum in a
// run-to-run order.
__global__ void __launch_bounds__(kItemBlock)
routed_bwd_window_kernel(const int* __restrict__ win_ptr,
                         const int* __restrict__ item_ptr,
                         const int* __restrict__ item_win,
                         const int* __restrict__ bwd_order,
                         const int* __restrict__ ckey,
                         const int* __restrict__ cptr,
                         const int* __restrict__ loc,
                         const float* __restrict__ val,
                         const float* __restrict__ dy,
                         float* __restrict__ dD, int n_win, int n_vox, int G,
                         int W) {
  extern __shared__ float dD_s[];
  __shared__ int beg_s[kItemBlock + 1];  // each chunk's start in the walk
  __shared__ int src_s[kItemBlock];      // its first crossing
  __shared__ int r0_s[kItemBlock];       // its tile's first ray
  __shared__ int warp_s[kItemWarps];
  const int tid = threadIdx.x;
  const int w = __ldg(item_win + blockIdx.x);
  const int j_beg = __ldg(item_ptr + blockIdx.x);
  const int j_end = __ldg(item_ptr + blockIdx.x + 1);
  const int v0 = w * W;
  const int nv = min(W, n_vox - v0);
  for (int i = tid; i < nv; i += kItemBlock) dD_s[i] = 0.f;
  for (int j0 = j_beg; j0 < j_end; j0 += kItemBlock) {
    const int nc = min(kItemBlock, j_end - j0);
    __syncthreads();  // the previous batch is done with the chunk lists
    int n = 0;
    if (tid < nc) {
      const int c = __ldg(bwd_order + j0 + tid);
      const int s = __ldg(cptr + c);
      n = __ldg(cptr + c + 1) - s;
      src_s[tid] = s;
      r0_s[tid] = (__ldg(ckey + c) / n_win) * G;
    }
    int total;
    const int beg = block_exclusive_sum(n, warp_s, total);
    if (tid < nc) beg_s[tid] = beg;
    if (tid == 0) beg_s[nc] = total;
    __syncthreads();
    int q = 0;  // this thread's chunk in the batch, advanced as f grows
    for (int f0 = tid; f0 - tid < total; f0 += kUnroll * kItemBlock) {
      unsigned p[kUnroll];
      float x[kUnroll];
      int r0[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int f = f0 + u * kItemBlock;
        p[u] = 0u;
        x[u] = 0.f;
        r0[u] = -1;
        if (f < total) {
          while (beg_s[q + 1] <= f) ++q;
          const int k = src_s[q] + (f - beg_s[q]);
          p[u] = static_cast<unsigned>(__ldg(loc + k));
          x[u] = __ldg(val + k);
          r0[u] = r0_s[q];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r0[u] >= 0) x[u] *= __ldg(dy + r0[u] + (p[u] >> 16));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r0[u] >= 0) atomicAdd(dD_s + (p[u] & 0xffffu), x[u]);
    }
  }
  __syncthreads();
  if (j_beg == __ldg(win_ptr + w) && j_end == __ldg(win_ptr + w + 1)) {
    for (int i = tid; i < nv; i += kItemBlock) dD[v0 + i] = dD_s[i];
  } else {
    for (int i = tid; i < nv; i += kItemBlock) atomicAdd(dD + v0 + i, dD_s[i]);
  }
}

// y += A.d over the same chunk table, window-major: one CTA per voxel
// window, its chunks in tile order (bwd_order).  Shared memory: d_s[W],
// staged once.  Each ray's run is summed in the warp and added into the
// global y.
template <typename Weight>
__global__ void __launch_bounds__(kWinBlock)
routed_fwd_densew_kernel(const int* __restrict__ win_ptr,
                         const int* __restrict__ bwd_order,
                         const int* __restrict__ ckey,
                         const int* __restrict__ cptr,
                         const int* __restrict__ loc,
                         const Weight* __restrict__ val,
                         const float* __restrict__ d, float* __restrict__ y,
                         int n_win, int n_vox, int G, int W) {
  extern __shared__ float d_s[];
  const int g = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;
  const int w = blockIdx.x;
  const int j_beg = __ldg(win_ptr + w), j_end = __ldg(win_ptr + w + 1);
  if (j_beg == j_end) return;  // an empty window (the whole CTA returns)
  const int v0 = w * W;
  const int nv = min(W, n_vox - v0);
  for (int i = threadIdx.x; i < nv; i += kWinBlock)
    d_s[i] = __ldg(d + v0 + i);
  __syncthreads();
  for (int j = j_beg + g; j < j_end; j += kGroups) {
    const int c = __ldg(bwd_order + j);
    float* y_t = y + static_cast<long long>(__ldg(ckey + c) / n_win) * G;
    const int k_beg = __ldg(cptr + c), k_end = __ldg(cptr + c + 1);
    for (int k0 = k_beg; k0 < k_end; k0 += kUnroll * kGroupThreads) {
      unsigned p[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kGroupThreads + gt;
        p[u] = k < k_end ? static_cast<unsigned>(__ldg(loc + k)) : 0u;
        v[u] = k < k_end ? load_w(val + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = k0 + u * kGroupThreads + gt < k_end;
        const int key = live ? static_cast<int>(p[u] >> 16) : -1;
        float x = live ? v[u] * d_s[p[u] & 0xffffu] : 0.f;
        if (warp_run_sum(key, x)) atomicAdd(y_t + key, x);
      }
    }
  }
}

unsigned cdiv(long long n, long long m) {
  return static_cast<unsigned>((n + m - 1) / m);
}

// The launches behind the weight-templated C entries, one instantiation a
// weight type.  Each returns cudaGetLastError() right after its launch.
template <typename Weight>
int launch_fwd_dense(const void* vox_ptr, const void* ray, const void* valT,
                     const void* d, void* y, int n_vox, int n_rays,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, sizeof(float) * n_rays, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_vox > 0)
    routed_fwd_dense_kernel<Weight><<<cdiv(static_cast<long long>(n_vox) * kWarp,
                                      kBlock), kBlock, 0, s>>>(
        static_cast<const int*>(vox_ptr), static_cast<const int*>(ray),
        static_cast<const Weight*>(valT), static_cast<const float*>(d),
        static_cast<float*>(y), n_vox);
  return static_cast<int>(cudaGetLastError());
}

template <typename Weight>
int launch_fwd_hist(const void* row_ptr, const void* col, const void* val,
                    const void* d, void* y, int n_rays, void* stream) {
  if (n_rays > 0)
    routed_fwd_hist_kernel<Weight><<<cdiv(n_rays, kHistTile), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const Weight*>(val), static_cast<const float*>(d),
        static_cast<float*>(y), n_rays);
  return static_cast<int>(cudaGetLastError());
}

template <typename Weight>
int launch_fwd_densew(const void* win_ptr, const void* bwd_order,
                      const void* ckey, const void* cptr, const void* loc,
                      const void* val, const void* d, void* y, int n_win,
                      int n_rays, int n_vox, int G, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, sizeof(float) * n_rays, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_win > 0)
    routed_fwd_densew_kernel<Weight><<<n_win, kWinBlock, sizeof(float) * W, s>>>(
        static_cast<const int*>(win_ptr),
        static_cast<const int*>(bwd_order), static_cast<const int*>(ckey),
        static_cast<const int*>(cptr), static_cast<const int*>(loc),
        static_cast<const Weight*>(val), static_cast<const float*>(d),
        static_cast<float*>(y), n_win, n_vox, G, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: device pointers and the stream as void*, sizes as int.
// Each entry returns cudaGetLastError() right after its launch (0 = ok);
// <name> reads float32 weights, <name>_bf16 bfloat16 ones.
extern "C" {

int routed_fwd_dense(const void* vox_ptr, const void* ray, const void* valT,
                     const void* d, void* y, int n_vox, int n_rays,
                     void* stream) {
  return launch_fwd_dense<float>(vox_ptr, ray, valT, d, y, n_vox, n_rays,
                                 stream);
}

int routed_fwd_dense_bf16(const void* vox_ptr, const void* ray,
                          const void* valT, const void* d, void* y,
                          int n_vox, int n_rays, void* stream) {
  return launch_fwd_dense<__nv_bfloat16>(vox_ptr, ray, valT, d, y, n_vox,
                                         n_rays, stream);
}

int routed_fwd_hist(const void* row_ptr, const void* col, const void* val,
                    const void* d, void* y, int n_rays, void* stream) {
  return launch_fwd_hist<float>(row_ptr, col, val, d, y, n_rays, stream);
}

int routed_fwd_hist_bf16(const void* row_ptr, const void* col,
                         const void* val, const void* d, void* y, int n_rays,
                         void* stream) {
  return launch_fwd_hist<__nv_bfloat16>(row_ptr, col, val, d, y, n_rays,
                                        stream);
}

int routed_fwd_window(const void* tile_ptr, const void* ckey,
                      const void* cptr, const void* loc, const void* val,
                      const void* d, void* y, int n_win, int n_rays,
                      int n_vox, int G, int W, void* stream) {
  if (n_rays > 0)
    routed_fwd_window_kernel<<<cdiv(n_rays, G), kWinBlock,
                               sizeof(float) * (G + kGroups * W),
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile_ptr), static_cast<const int*>(ckey),
        static_cast<const int*>(cptr), static_cast<const int*>(loc),
        static_cast<const float*>(val), static_cast<const float*>(d),
        static_cast<float*>(y), n_win, n_rays, n_vox, G, W);
  return static_cast<int>(cudaGetLastError());
}

int routed_bwd_window(const void* win_ptr, const void* item_ptr,
                      const void* item_win, const void* bwd_order,
                      const void* ckey, const void* cptr, const void* loc,
                      const void* val, const void* dy, void* dD, int n_win,
                      int n_vox, int n_items, int G, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dD, 0, sizeof(float) * n_vox, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items > 0)
    routed_bwd_window_kernel<<<n_items, kItemBlock, sizeof(float) * W, s>>>(
        static_cast<const int*>(win_ptr), static_cast<const int*>(item_ptr),
        static_cast<const int*>(item_win),
        static_cast<const int*>(bwd_order), static_cast<const int*>(ckey),
        static_cast<const int*>(cptr), static_cast<const int*>(loc),
        static_cast<const float*>(val), static_cast<const float*>(dy),
        static_cast<float*>(dD), n_win, n_vox, G, W);
  return static_cast<int>(cudaGetLastError());
}

int routed_fwd_densew(const void* win_ptr, const void* bwd_order,
                      const void* ckey, const void* cptr, const void* loc,
                      const void* val, const void* d, void* y, int n_win,
                      int n_rays, int n_vox, int G, int W, void* stream) {
  return launch_fwd_densew<float>(win_ptr, bwd_order, ckey, cptr, loc, val,
                                  d, y, n_win, n_rays, n_vox, G, W, stream);
}

int routed_fwd_densew_bf16(const void* win_ptr, const void* bwd_order,
                           const void* ckey, const void* cptr,
                           const void* loc, const void* val, const void* d,
                           void* y, int n_win, int n_rays, int n_vox, int G,
                           int W, void* stream) {
  return launch_fwd_densew<__nv_bfloat16>(win_ptr, bwd_order, ckey, cptr,
                                          loc, val, d, y, n_win, n_rays,
                                          n_vox, G, W, stream);
}

}  // extern "C"
