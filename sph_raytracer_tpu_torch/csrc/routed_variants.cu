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
//                         equal share of rays and crossings
//   routed_fwd_window  <- _fwd_pallas              (B7a): y = A.d over the
//                         window chunk table
//   routed_bwd_window  <- _bwd_pallas              (B7b): dD = A^T.dy over
//                         the same chunk table
//   routed_fwd_densew  <- _fwd_banded_densew_pallas (B8): y = A.d over the
//                         same chunk table, window-major, one CTA per
//                         work item (B7b's)
//
// (all in sph_raytracer_tpu/ops/routed_project.py).  As in
// routed_project.cu, the TPU kernels' int8 lane routes, 8-row bands,
// superchunk pointers and SMEM bit-packing are dropped: an SM gathers from
// global or shared memory directly.
//
// What bounds them on this card: bytes.  Each streams 8 B of table per
// live crossing (an index and a length) and does 2 flops per crossing, far
// below the H100's f32 balance point; the gathered vector (d or dy, at
// most a few MB) stays in the 50 MB L2.  What each design does about it
// (a float atomicAdd into shared memory compiles to a compare-and-swap
// loop on sm_90a; into global memory it is one reduction):
//
// * routed_fwd_dense: the TPU kernel's idea is "slot = density window:
//   each density value is fetched once".  Here one warp per voxel reads
//   d[v] once into a register and strides the voxel's rays with coalesced
//   table reads, adding valT[k]*d[v] into y[ray[k]] with global atomics
//   (the C entry zeroes y first).  It reads the gather backward's tables,
//   so routed_dense='both' trains on the transpose alone.  One atomic a
//   crossing (17.1 M at the flagship) held it at 2.2x torch.mv's time, yet
//   the atomics' count does not set its pace: with Hopper's float4 atomics
//   over aligned 4-ray groups (a voxel's rays ascend and neighbouring
//   pixels cross the same voxels) it issues half as many (8.8 M) and runs
//   1.5-5 % faster, and plain stores in their place run slower (NVIDIA H100
//   80GB HBM3, 700.00 W; PERF.md section 6).  What costs is the scatter:
//   a voxel's rays come from every view that sees it, so each warp's 32
//   adds spread over many 32 B sectors of y, and the L2 takes each sector
//   whatever the adds in it.  The width-4 groups stay (kW = DENSE_WIDTH
//   from the wrapper), and the warps in flight take distant voxels (the
//   warp order's spread, DENSE_SPREAD), which moved it 7-10 %: presumably
//   because neighbouring voxels share rays, so their warps' adds met on
//   the same sectors.  The atomics sum in a run-to-run order.
// * routed_fwd_hist: the TPU kernel's idea is a reduce whose cost barely
//   depends on how many crossings each ray has.  It was one CTA per tile
//   of 256 rays, one crossing a thread a step, and it was latency-bound
//   (1.6x torch.mv's time, PERF.md section 6): the largest tile took 92
//   dependent steps of a row-pointer advance, a 4 B index load, a gather
//   of d and a 10-shuffle scan, with 2 KB of table in flight a CTA.  So it
//   takes equal shares of the merge path of the rays' ends and the
//   crossings instead (Merrill & Garland, "Merge-based parallel sparse
//   matrix-vector multiplication", SC 2016), so a share bounds both its
//   crossings and the rays it writes (a run of empty rays costs steps, not
//   crossings).  Each CTA reads its share's ends from a cut table built
//   with the CSR (8 B a share, 67,808 B at the flagship): a warp-wide
//   search of row_ptr in the kernel cost 8-10 % of its time.  Each thread
//   takes an aligned quad of col and val a step (16 B each, 8 B of bf16)
//   and sums its quad's crossings of one ray in registers: rays are long
//   (68.6 crossings a live ray at the flagship), so a quad almost always
//   holds one ray, and the warp's scan and the shared adds run once a quad,
//   not once a crossing.  A ray wholly inside a share is stored, a ray that
//   a share's end cuts is added into y with one global atomic a share (the
//   C entry zeroes y).  The kernel stays latency-bound: a CTA's chain of
//   dependent loads (its ends, the row pointers, a step's quad, its gathers
//   of d) sets its pace, so CTAs of 256 at 32 registers (full occupancy)
//   take two steps of one quad at the wrapper's share (HIST_SHARE); two or
//   four quads a step cost registers and occupancy and read slower
//   (tools/fwd_sweep.py, PERF.md section 6).  The shared and global adds
//   sum in a run-to-run order.
// * routed_fwd_window / routed_bwd_window: the TPU kernels' idea is chunks
//   of (ray tile, density window), with the window's density (forward) or
//   the tile's dy (backward) staged in fast memory.  The chunk table holds
//   the live crossings sorted by chunk, 8 B each: one int32 packing the
//   ray's offset in its tile (high 16 bits) and the voxel's offset in its
//   window (low 16 bits), and one f32 length.  Tile (G rays) and window (W
//   voxels) sizes come from the wrapper (ops/routed_project.py WIN_G =
//   1024, WIN_W = 256): at the flagship (250,000 rays, 125,000 voxels) 245
//   tiles and 489 windows.
//   The forward was one CTA per ray tile, its 8 groups each staging a
//   chunk's window of d in shared memory between two barriers, and three
//   things held it at 2.3x torch.mv's time (PERF.md section 6): chunks of
//   a median 286 crossings filled a group's 512-crossing step 57 %; each
//   chunk staged 1 KB of d (41.6 MB in all, beside 137 MB of table) behind
//   two barriers; and the largest tile holds 1.25x the mean's crossings.
//   So it walks pieces instead (built with the table: each tile's
//   crossings cut into ceil(n / K_f) near-equal runs, K_f = WIN_KF = 4096),
//   one CTA a piece, the piece's crossings taken flat, one aligned quad
//   (16 B of loc, 16 B of val) a thread a step whatever the chunk sizes; d
//   is read at each crossing through the read-only path (0.5 MB, in L2),
//   with no staging and no barrier a chunk.  A thread sums its quad's
//   crossings of one ray before its add into the CTA's shared y tile (G
//   floats), which is stored, or added into y with global atomics when the
//   tile is split.  Two quads a thread a step, strided or side by side,
//   read slower than one (PERF.md section 6).  The shared adds (a
//   compare-and-swap loop on this card) and the global ones sum in a
//   run-to-run order.
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
//   A y resident on chip does not carry over: CTAs run in parallel and in
//   no order, and each (tile, window) pair is one chunk, so a shared y tile
//   would collect nothing across chunks.  The resident y is the global one
//   (1 MB at the flagship), kept in L2, one atomic per (ray, chunk) run of
//   a warp's step instead of B5's one per crossing.  It was one CTA per
//   window, 8 groups of 128 threads on different chunks, and three things
//   held it at 2.1x torch.mv's time (PERF.md section 6): the hottest
//   window holds 4x the mean window's crossings, and its CTA set the tail;
//   chunks of a median 286 crossings filled a group's 512-crossing step
//   57 %; and each thread loaded 4 B of loc and of val a crossing.  So it
//   walks B7b's work items instead (each window's chunks in bwd_order cut
//   into runs of at most WIN_K crossings), one CTA an item, the item's
//   chunks laid end to end as in routed_bwd_window, so that every step is
//   full whatever the chunk sizes, 4 crossings a thread a step in CTAs of
//   128, the window's d staged in shared memory once an item.  The sweep
//   (tools/fwd_sweep.py, PERF.md section 6) chose it: a (ray, chunk) run is
//   ~2 crossings, so a walk of aligned quads added ~2 runs a quad on their
//   own, issued more atomics (10.5 M against 9.0 M) and read 20-55 %
//   slower; d read through L2 read 5 % slower, larger CTAs slower still;
//   plain stores in place of the atomics read as fast, so the walk, not
//   the atomics, sets its pace.  The atomics sum in a run-to-run order.
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
constexpr unsigned kFull = 0xffffffffu;
// crossings a thread takes a step in the crossing walks (routed_bwd_window,
// routed_fwd_densew)
constexpr int kUnroll = 4;

// y[kW·g .. kW·g + kW) += a: one kW-wide global atomic (float2 / float4
// atomics exist for global memory on compute capability 9.x), or scalar
// ones for the rays of a last group that n_rays cuts short.
template <int kW>
__device__ __forceinline__ void add_group(float* __restrict__ y, int g,
                                          const float (&a)[kW], int n_rays) {
  float* p = y + static_cast<long long>(g) * kW;
  if (static_cast<long long>(g) * kW + kW <= n_rays) {
    if constexpr (kW == 4) {
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(a[0], a[1], a[2], a[3]));
    } else if constexpr (kW == 2) {
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
    } else {
      atomicAdd(p, a[0]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kW; ++j)
    if (static_cast<long long>(g) * kW + j < n_rays) atomicAdd(p + j, a[j]);
}

// a[c] += x, c < kW held in a register (no local-memory index)
template <int kW>
__device__ __forceinline__ void add_to(float (&a)[kW], int c, float x) {
#pragma unroll
  for (int j = 0; j < kW; ++j)
    if (c == j) a[j] += x;
}

// y += A.d over the voxel-major transpose: one warp per voxel, 32
// consecutive crossings a step, one a lane; warp w takes voxel
// (w % spread)·ceil(n_vox / spread) + w / spread, so that the warps in
// flight add into the rays of distant voxels.  At kW = 1 each lane adds
// its crossing with one global atomic.  At kW = 2 or 4 the lanes whose
// rays lie in one aligned group g (rays kW·g .. kW·g + kW - 1; a voxel's
// rays ascend, so they are consecutive lanes) are cut into runs of at most
// kW lanes; the last lane of each gathers the run's values (kW - 1
// shuffles of value and ray), sums them component by component and adds
// them with one kW-wide atomic.  kW = 0 stores instead (a race whose
// output is wrong: tools/fwd_sweep.py times the scatter without atomics).
template <int kW, typename Weight>
__global__ void __launch_bounds__(kBlock)
routed_fwd_dense_kernel(const int* __restrict__ vox_ptr,
                        const int* __restrict__ ray,
                        const Weight* __restrict__ valT,
                        const float* __restrict__ d, float* __restrict__ y,
                        int n_vox, int n_rays, int spread) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  const long long per = (n_vox + spread - 1) / spread;
  const long long v = (w % spread) * per + w / spread;
  const int lane = threadIdx.x & (kWarp - 1);
  if (v >= n_vox) return;  // (the whole warp)
  const int beg = __ldg(vox_ptr + v);
  const int end = __ldg(vox_ptr + v + 1);
  if (beg == end) return;
  const float dv = __ldg(d + v);
  for (int k = beg + lane; k - lane < end; k += kWarp) {
    const bool live = k < end;
    const int r = live ? __ldg(ray + k) : -1;
    const float x = live ? load_w(valT + k) * dv : 0.f;
    if constexpr (kW == 0) {
      if (live) y[r] = x;  // plain stores, a race: the sweep's timing only
    } else if constexpr (kW == 1) {
      if (live) atomicAdd(y + r, x);
    } else {
      const int g = live ? r / kW : -1;  // dead lanes: the warp's tail
      const int g_up = __shfl_up_sync(kFull, g, 1);
      const unsigned starts = __ballot_sync(kFull, lane == 0 || g_up != g);
      // this lane's place in its run of one group, then in its kW-run
      const int pos =
          (lane - (31 - __clz(starts & (kFull >> (31 - lane))))) % kW;
      float a[kW] = {};
      add_to<kW>(a, r % kW, x);
#pragma unroll
      for (int off = 1; off < kW; ++off) {
        const float xo = __shfl_up_sync(kFull, x, off);
        const int ro = __shfl_up_sync(kFull, r, off);
        if (off <= pos) add_to<kW>(a, ro % kW, xo);
      }
      const bool last = lane == kWarp - 1 || ((starts >> (lane + 1)) & 1u) ||
                        pos == kW - 1;
      if (live && last) add_group<kW>(y, g, a, n_rays);
    }
  }
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

// The CTA size of routed_fwd_hist: 8 crossings a thread in two steps of
// one quad at the default share, at 32 registers (full occupancy)
constexpr int kHistBlock = 256;

// y = A.d over the ray-major CSR: one CTA of kHistBlock per share of
// `share` steps of the merge path of the rays' ends and the crossings.  The
// CTA reads the share's two ends (i0, k0) and (i1, k1) (crossings [k0, k1),
// the ends of rays [i0, i1)) from the cut table (cut: the (ray, crossing)
// pair of each share's start, and the end), then stages the share's row
// pointers in shared memory with its first quad already in flight.  Each
// thread takes one aligned quad of col and val a step, finds the quad's
// first ray by a binary search in the row pointers (from its last ray: its
// quads ascend) and sums the quad's crossings of each ray in registers: a
// ray that ends inside the quad goes into the shared y_s at once, the
// quad's last run through the warp's merge (warp_run_sum).  Then each ray
// that lies wholly in the share is stored, and the (at most two) rays that
// the share's ends cut are added into y with one global atomic each (the C
// entry zeroes y).
template <typename Weight>
__global__ void __launch_bounds__(kHistBlock)
routed_fwd_hist_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col,
                       const Weight* __restrict__ val,
                       const int* __restrict__ cut,
                       const float* __restrict__ d, float* __restrict__ y,
                       int n_rays, int nnz, int share) {
  extern __shared__ int ptr_s[];  // the share's row pointers (share + 2 ints),
                                  // then its rays' sums y_s (share + 1)
  const int tid = threadIdx.x;
  const int2 c0 = __ldg(reinterpret_cast<const int2*>(cut) + blockIdx.x);
  const int2 c1 = __ldg(reinterpret_cast<const int2*>(cut) + blockIdx.x + 1);
  const int i0 = c0.x, k0 = c0.y, i1 = c1.x, k1 = c1.y;
  const int nr = min(i1, n_rays - 1) - i0 + 1;  // the rays the share touches
  float* y_s = reinterpret_cast<float*>(ptr_s + share + 2);
  int c[4];
  float x[4];
  const int q_first = (k0 & ~3) + 4 * tid;
  // in flight while the row pointers are staged
  if (q_first < k1) load_quad(col, val, q_first, nnz, c, x);
  for (int j = tid; j <= nr; j += kHistBlock)
    ptr_s[j] = __ldg(row_ptr + i0 + j);
  for (int j = tid; j < nr; j += kHistBlock) y_s[j] = 0.f;
  __syncthreads();
  int r = 0;  // this thread's last ray in the share
  for (int q0 = q_first; q0 - 4 * tid < k1; q0 += 4 * kHistBlock) {
    int key = -1;
    float acc = 0.f;
    if (q0 < k1) {
      if (q0 != q_first) load_quad(col, val, q0, nnz, c, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = q0 + i;
        if (k >= k0 && k < k1) x[i] = __ldg(d + c[i]) * x[i];
      }
      const int ka = max(q0, k0);
      for (int hi = nr - 1; r < hi;) {  // the last ray starting <= ka
        const int mid = (r + hi + 1) >> 1;
        if (ptr_s[mid] <= ka) {
          r = mid;
        } else {
          hi = mid - 1;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = q0 + i;
        if (k < k0 || k >= k1) continue;
        while (ptr_s[r + 1] <= k) ++r;  // a ray ended inside the quad
        if (r != key) {
          if (key >= 0) atomicAdd(y_s + key, acc);
          key = r;
          acc = x[i];
        } else {
          acc += x[i];
        }
      }
    }
    if (warp_run_sum(key, acc)) atomicAdd(y_s + key, acc);
  }
  __syncthreads();
  for (int j = tid; j < nr; j += kHistBlock) {
    const int ray = i0 + j;
    if (ray < i1 && ptr_s[j] >= k0) {
      y[ray] = y_s[j];  // the ray lies wholly in the share
    } else if (y_s[j] != 0.f) {
      atomicAdd(y + ray, y_s[j]);  // one of the share's ends cuts it
    }
  }
}

// y = A.d over the window chunk table: one CTA of kThreads per piece (a
// run of at most K_f crossings of one ray tile; piece_ptr / piece_chunk:
// its first crossing and the chunk that holds it).  The piece's crossings
// are walked flat, one aligned quad a thread a step, whatever the chunk
// sizes: the chunks' ends and window offsets sit in shared memory kThreads
// at a time, each thread advances its chunk as its position grows and
// reads d at each crossing through the read-only path.  A thread sums its
// quad's consecutive crossings of one ray (a chunk's crossings are sorted
// by ray) before one add into the shared y tile.  The CTA then stores its
// tile (the piece is the whole tile) or adds it into y with one global
// atomic a nonzero ray (the tile is split; the C entry zeroes y).
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
routed_fwd_window_kernel(const int* __restrict__ tile_ptr,
                         const int* __restrict__ ckey,
                         const int* __restrict__ cptr,
                         const int* __restrict__ loc,
                         const float* __restrict__ val,
                         const int* __restrict__ piece_ptr,
                         const int* __restrict__ piece_chunk,
                         const float* __restrict__ d, float* __restrict__ y,
                         int n_win, int n_rays, int n_chunks, int G, int W) {
  extern __shared__ float y_s[];
  __shared__ int end_s[kThreads];  // each chunk's end, cut at the piece's
  __shared__ int v0_s[kThreads];   // its window's first voxel
  const int tid = threadIdx.x;
  const int k_beg = __ldg(piece_ptr + blockIdx.x);
  const int k_end = __ldg(piece_ptr + blockIdx.x + 1);
  const int c_beg = __ldg(piece_chunk + blockIdx.x);
  const int t = __ldg(ckey + c_beg) / n_win;
  const int r0 = t * G;
  const int nr = min(G, n_rays - r0);
  const int nnz = __ldg(cptr + n_chunks);
  for (int i = tid; i < nr; i += kThreads) y_s[i] = 0.f;
  for (int cb = c_beg, b_beg = k_beg; b_beg < k_end; cb += kThreads) {
    __syncthreads();  // y_s is zeroed; the last batch is done with end_s
    if (cb + tid < n_chunks) {
      end_s[tid] = min(__ldg(cptr + cb + tid + 1), k_end);
      v0_s[tid] = (__ldg(ckey + cb + tid) % n_win) * W;
    } else {
      end_s[tid] = k_end;
    }
    __syncthreads();
    const int b_end = end_s[kThreads - 1];
    int q = 0;  // this thread's chunk in the batch, advanced as k grows
    for (int k0 = (b_beg & ~3) + 4 * tid; k0 < b_end; k0 += 4 * kThreads) {
      int p[4];
      float x[4];
      load_quad(loc, val, k0, nnz, p, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i;
        if (k < b_beg || k >= b_end) {
          p[i] = -1;
          continue;
        }
        while (end_s[q] <= k) ++q;
        x[i] *= __ldg(d + v0_s[q] + (p[i] & 0xffff));
        p[i] >>= 16;  // the ray's offset in the tile
      }
      int key = -1;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (p[i] < 0) continue;
        if (p[i] != key) {
          if (key >= 0) atomicAdd(y_s + key, acc);
          key = p[i];
          acc = x[i];
        } else {
          acc += x[i];
        }
      }
      if (key >= 0) atomicAdd(y_s + key, acc);
    }
    b_beg = b_end;
  }
  __syncthreads();
  if (k_beg == __ldg(cptr + __ldg(tile_ptr + t)) &&
      k_end == __ldg(cptr + __ldg(tile_ptr + t + 1))) {
    for (int i = tid; i < nr; i += kThreads) y[r0 + i] = y_s[i];
  } else {
    for (int i = tid; i < nr; i += kThreads)
      if (y_s[i] != 0.f) atomicAdd(y + r0 + i, y_s[i]);
  }
}

// routed_bwd_window: one CTA of kItemBlock threads per work item of the
// chunk table (item_ptr / item_win: a run of one window's chunks in
// bwd_order of at most K crossings, or one larger chunk), kUnroll crossings
// a thread a step.
constexpr int kItemBlock = 256;

// Exclusive prefix sum of n over the CTA's kThreads threads in thread
// order; total gets the sum over all of them.  Every thread must call it;
// warp_s holds kThreads / 32 ints.
template <int kThreads>
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
  for (int i = 0; i < kThreads / kWarp; ++i) {
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
  __shared__ int warp_s[kItemBlock / kWarp];
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
    const int beg = block_exclusive_sum<kItemBlock>(n, warp_s, total);
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

// The CTA size of routed_fwd_densew
constexpr int kDensewBlock = 128;

// y = A.d over the same chunk table, window-major: one CTA of kDensewBlock
// per work item (B7b's: item_ptr / item_win, a run of one window's chunks
// in bwd_order of at most K crossings, or one larger chunk).  The CTA
// stages the window's W values of d in shared memory once; then, as in
// routed_bwd_window, it takes the item's chunks kDensewBlock at a time,
// lays them end to end by a CTA prefix sum and walks that concatenation
// kUnroll crossings a thread a step, whatever the chunk sizes.  A warp sums
// each ray's run across its lanes (warp_run_sum: a chunk's crossings are
// sorted by ray and a window's chunks ascend by tile, so the global ray
// ascends along the walk) and the run's last lane adds it into y with one
// global atomic (the C entry zeroes y).
template <typename Weight>
__global__ void __launch_bounds__(kDensewBlock)
routed_fwd_densew_kernel(const int* __restrict__ item_ptr,
                         const int* __restrict__ item_win,
                         const int* __restrict__ bwd_order,
                         const int* __restrict__ ckey,
                         const int* __restrict__ cptr,
                         const int* __restrict__ loc,
                         const Weight* __restrict__ val,
                         const float* __restrict__ d, float* __restrict__ y,
                         int n_win, int n_vox, int G, int W) {
  extern __shared__ float d_s[];           // the window's density
  __shared__ int beg_s[kDensewBlock + 1];  // each chunk's start in the walk
  __shared__ int src_s[kDensewBlock];      // its first crossing
  __shared__ int r0_s[kDensewBlock];       // its tile's first ray
  __shared__ int warp_s[kDensewBlock / kWarp];
  const int tid = threadIdx.x;
  const int j_beg = __ldg(item_ptr + blockIdx.x);
  const int j_end = __ldg(item_ptr + blockIdx.x + 1);
  const int v0 = __ldg(item_win + blockIdx.x) * W;
  for (int i = tid; i < min(W, n_vox - v0); i += kDensewBlock)
    d_s[i] = __ldg(d + v0 + i);
  for (int j0 = j_beg; j0 < j_end; j0 += kDensewBlock) {
    const int nc = min(kDensewBlock, j_end - j0);
    __syncthreads();  // d_s is staged; the last batch is done with the lists
    int n = 0;
    if (tid < nc) {
      const int c = __ldg(bwd_order + j0 + tid);
      const int s = __ldg(cptr + c);
      n = __ldg(cptr + c + 1) - s;
      src_s[tid] = s;
      r0_s[tid] = (__ldg(ckey + c) / n_win) * G;
    }
    int total;
    const int beg = block_exclusive_sum<kDensewBlock>(n, warp_s, total);
    if (tid < nc) beg_s[tid] = beg;
    if (tid == 0) beg_s[nc] = total;
    __syncthreads();
    int q = 0;  // this thread's chunk in the batch, advanced as f grows
    for (int f0 = tid; f0 - tid < total; f0 += kUnroll * kDensewBlock) {
      int p[kUnroll];
      float x[kUnroll];
      int r0[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int f = f0 + u * kDensewBlock;
        p[u] = 0;
        x[u] = 0.f;
        r0[u] = -1;
        if (f < total) {
          while (beg_s[q + 1] <= f) ++q;
          const int k = src_s[q] + (f - beg_s[q]);
          p[u] = __ldg(loc + k);
          x[u] = load_w(val + k);
          r0[u] = r0_s[q];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = r0[u] >= 0 ? r0[u] + (p[u] >> 16) : -1;
        float xd = r0[u] >= 0 ? x[u] * d_s[p[u] & 0xffff] : 0.f;
        if (warp_run_sum(key, xd)) atomicAdd(y + key, xd);
      }
    }
  }
}

unsigned cdiv(long long n, long long m) {
  return static_cast<unsigned>((n + m - 1) / m);
}

// The launches behind the weight-templated C entries, one instantiation a
// weight type.  Each returns cudaGetLastError() right after its launch.
template <int kW, typename Weight>
void launch_fwd_dense_w(const void* vox_ptr, const void* ray,
                        const void* valT, const void* d, void* y, int n_vox,
                        int n_rays, int spread, cudaStream_t s) {
  const long long warps = (n_vox + spread - 1) / spread * spread;
  routed_fwd_dense_kernel<kW, Weight>
      <<<cdiv(warps * kWarp, kBlock), kBlock, 0, s>>>(
          static_cast<const int*>(vox_ptr), static_cast<const int*>(ray),
          static_cast<const Weight*>(valT), static_cast<const float*>(d),
          static_cast<float*>(y), n_vox, n_rays, spread);
}

// width: the atomic width kW, 1, 2 or 4 (another is refused)
template <typename Weight>
int launch_fwd_dense(const void* vox_ptr, const void* ray, const void* valT,
                     const void* d, void* y, int n_vox, int n_rays,
                     int width, int spread, void* stream) {
  if ((width < 0 || width > 4 || width == 3) || spread < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, sizeof(float) * n_rays, s);
  if (err != cudaSuccess || n_vox == 0) return static_cast<int>(err);
  if (width == 4)
    launch_fwd_dense_w<4, Weight>(vox_ptr, ray, valT, d, y, n_vox, n_rays,
                                  spread, s);
  else if (width == 2)
    launch_fwd_dense_w<2, Weight>(vox_ptr, ray, valT, d, y, n_vox, n_rays,
                                  spread, s);
  else if (width == 1)
    launch_fwd_dense_w<1, Weight>(vox_ptr, ray, valT, d, y, n_vox, n_rays,
                                  spread, s);
  else
    launch_fwd_dense_w<0, Weight>(vox_ptr, ray, valT, d, y, n_vox, n_rays,
                                  spread, s);
  return static_cast<int>(cudaGetLastError());
}

// cut: (n_rays + nnz) / share rounded up, plus one, (ray, crossing) int
// pairs (ops/routed_project.py hist_cut at this share); share: the
// merge-path steps a CTA takes, 1 to 6,140 (its row pointers and sums in
// 48 KB of shared memory; another is refused)
template <typename Weight>
int launch_fwd_hist(const void* row_ptr, const void* col, const void* val,
                    const void* cut, const void* d, void* y, int n_rays,
                    int nnz, int share, void* stream) {
  if (share < 1 || share > 6140 || cut == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, sizeof(float) * n_rays, s);
  if (err != cudaSuccess || n_rays == 0) return static_cast<int>(err);
  routed_fwd_hist_kernel<Weight>
      <<<cdiv(static_cast<long long>(n_rays) + nnz, share), kHistBlock,
         sizeof(int) * (2 * share + 3), s>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(col),
          static_cast<const Weight*>(val), static_cast<const int*>(cut),
          static_cast<const float*>(d), static_cast<float*>(y), n_rays, nnz,
          share);
  return static_cast<int>(cudaGetLastError());
}

template <typename Weight>
int launch_fwd_densew(const void* item_ptr, const void* item_win,
                      const void* bwd_order, const void* ckey,
                      const void* cptr, const void* loc, const void* val,
                      const void* d, void* y, int n_win, int n_rays,
                      int n_vox, int n_items, int G, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, sizeof(float) * n_rays, s);
  if (err != cudaSuccess || n_items == 0) return static_cast<int>(err);
  routed_fwd_densew_kernel<Weight>
      <<<n_items, kDensewBlock, sizeof(float) * W, s>>>(
          static_cast<const int*>(item_ptr),
          static_cast<const int*>(item_win),
          static_cast<const int*>(bwd_order), static_cast<const int*>(ckey),
          static_cast<const int*>(cptr), static_cast<const int*>(loc),
          static_cast<const Weight*>(val), static_cast<const float*>(d),
          static_cast<float*>(y), n_win, n_vox, G, W);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
void launch_fwd_window_t(const void* tile_ptr, const void* ckey,
                         const void* cptr, const void* loc, const void* val,
                         const void* piece_ptr, const void* piece_chunk,
                         const void* d, void* y, int n_win, int n_rays,
                         int n_chunks, int n_pieces, int G, int W,
                         cudaStream_t s) {
  routed_fwd_window_kernel<kThreads>
      <<<n_pieces, kThreads, sizeof(float) * G, s>>>(
          static_cast<const int*>(tile_ptr), static_cast<const int*>(ckey),
          static_cast<const int*>(cptr), static_cast<const int*>(loc),
          static_cast<const float*>(val),
          static_cast<const int*>(piece_ptr),
          static_cast<const int*>(piece_chunk), static_cast<const float*>(d),
          static_cast<float*>(y), n_win, n_rays, n_chunks, G, W);
}

}  // namespace

// C interface: device pointers and the stream as void*, sizes as int.
// Each entry returns cudaGetLastError() right after its launch (0 = ok);
// <name> reads float32 weights, <name>_bf16 bfloat16 ones.
extern "C" {

int routed_fwd_dense(const void* vox_ptr, const void* ray, const void* valT,
                     const void* d, void* y, int n_vox, int n_rays, int width,
                     int spread, void* stream) {
  return launch_fwd_dense<float>(vox_ptr, ray, valT, d, y, n_vox, n_rays,
                                 width, spread, stream);
}

int routed_fwd_dense_bf16(const void* vox_ptr, const void* ray,
                          const void* valT, const void* d, void* y,
                          int n_vox, int n_rays, int width, int spread,
                          void* stream) {
  return launch_fwd_dense<__nv_bfloat16>(vox_ptr, ray, valT, d, y, n_vox,
                                         n_rays, width, spread, stream);
}

int routed_fwd_hist(const void* row_ptr, const void* col, const void* val,
                    const void* cut, const void* d, void* y, int n_rays,
                    int nnz, int share, void* stream) {
  return launch_fwd_hist<float>(row_ptr, col, val, cut, d, y, n_rays, nnz,
                                share, stream);
}

int routed_fwd_hist_bf16(const void* row_ptr, const void* col,
                         const void* val, const void* cut, const void* d,
                         void* y, int n_rays, int nnz, int share,
                         void* stream) {
  return launch_fwd_hist<__nv_bfloat16>(row_ptr, col, val, cut, d, y, n_rays,
                                        nnz, share, stream);
}

// threads: the CTA size, 128, 256, 512 or 1024 (another is refused)
int routed_fwd_window(const void* tile_ptr, const void* ckey,
                      const void* cptr, const void* loc, const void* val,
                      const void* piece_ptr, const void* piece_chunk,
                      const void* d, void* y, int n_win, int n_rays,
                      int n_chunks, int n_pieces, int G, int W, int threads,
                      void* stream) {
  if (threads != 128 && threads != 256 && threads != 512 && threads != 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, sizeof(float) * n_rays, s);
  if (err != cudaSuccess || n_pieces == 0) return static_cast<int>(err);
  auto* launch = threads == 128   ? launch_fwd_window_t<128>
                 : threads == 256 ? launch_fwd_window_t<256>
                 : threads == 512 ? launch_fwd_window_t<512>
                                  : launch_fwd_window_t<1024>;
  launch(tile_ptr, ckey, cptr, loc, val, piece_ptr, piece_chunk, d, y, n_win,
         n_rays, n_chunks, n_pieces, G, W, s);
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

int routed_fwd_densew(const void* item_ptr, const void* item_win,
                      const void* bwd_order, const void* ckey,
                      const void* cptr, const void* loc, const void* val,
                      const void* d, void* y, int n_win, int n_rays,
                      int n_vox, int n_items, int G, int W, void* stream) {
  return launch_fwd_densew<float>(item_ptr, item_win, bwd_order, ckey, cptr,
                                  loc, val, d, y, n_win, n_rays, n_vox,
                                  n_items, G, W, stream);
}

int routed_fwd_densew_bf16(const void* item_ptr, const void* item_win,
                           const void* bwd_order, const void* ckey,
                           const void* cptr, const void* loc,
                           const void* val, const void* d, void* y,
                           int n_win, int n_rays, int n_vox, int n_items,
                           int G, int W, void* stream) {
  return launch_fwd_densew<__nv_bfloat16>(item_ptr, item_win, bwd_order,
                                          ckey, cptr, loc, val, d, y, n_win,
                                          n_rays, n_vox, n_items, G, W,
                                          stream);
}

}  // extern "C"
