// Fused projection kernel for NVIDIA Hopper (sm_90a): the whole crossing
// trace of a ray runs inside the kernel, so the forward y = A.d needs no
// tables at all.  Bound through a plain C interface and loaded with ctypes
// (sph_raytracer_tpu_torch/ops/_cuda.py builds it with nvcc at first use,
// with -fmad=false so each float op rounds as the plain version's does).
//
// Replaces (sph_raytracer_tpu/ops/fused_pallas.py):
//   fused_fwd  <- _make_kernel, launched by _fused_pallas_call  (B4)
// It computes what B4 computes, per ray:
//   1. all M boundary-crossing distances: row 0 is the ray start (t = 0),
//      then sphere near / far, cone near / far (with the tol3 / tol2 snaps,
//      the single-root and on-cone cases and the cone shadow), azimuth
//      half-planes (with their shadow); NaN -> +inf; pad rows +inf;
//   2. an ascending sort;
//   3. segment lengths next - cur (+inf after the last), live segments
//      (finite, > 0, t >= 0), each labelled by the voxel of its midpoint
//      through three binary searches over the boundary tables (r^2,
//      pz <= |p| cos e, the azimuth half-plane test: no atan2);
//   4. y = sum of d[code] * len, code = (r*NE + e)*NA + a + off0; with lerp
//      (time-interpolated 4D) (1-w)*len at code and w*len at
//      code - off0 + off1.
// The formulas are fused_pallas.py:156-336's, operation for operation, so
// that this kernel and its plain version (ops/fused_project.py) label the
// same way.  What B4 did only for want of a general gather on a TPU -- the
// (8,128) geometry blocks, the 8-row density-window sweep and its streamed
// DMA variant -- is dropped: the density is gathered straight from global
// memory through the read-only path (0.5 MB at the flagship, 10 MB with 20
// time bins: it stays in the 50 MB L2).
//
// What bounds it on this card: operations.  Per ray it reads 28-40 bytes
// and does ~10^4 flops (the crossing math, Mp log2 Mp (log2 Mp + 1) / 4
// compare-exchanges of the sort, three 7-step searches per live segment).
// Design against that: one warp per ray, Mp/32 distances per lane held in
// registers (8 at the flagship, 16 at the Mp = 512 cap).  The sort is a
// warp bitonic network: compare-exchanges in registers for strides inside a
// lane, __shfl_xor_sync for strides across lanes.  A lane's last segment
// takes its end from the next lane's first distance by one shuffle.
// Labels, the gather and the sum run per lane; one shuffle reduce and one
// store per ray.  The boundary tables (<= 127 entries a row) sit in shared
// memory; a block's warps walk the rays with a grid stride.

#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;  // rays in flight per block
constexpr int kBlock = kWarp * kWarps;
constexpr int kMaxBlocks = 4096;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = std::numeric_limits<float>::infinity();

// Boundary table: kRows rows of kW floats (ops/fused_project.py
// boundary_table builds it).  Rows R2C..NOT_EQ are indexed by the boundary
// whose crossing a row computes, rows R2S..A_NEG by the binary searches
// (padded so a search never moves past the last boundary), TOL holds
// (ftol, tol3, tol2).
constexpr int kW = 128;
enum Row { R2C, COS2, COS_UP, NOT_EQ, R2S, COS_E, SIN_A, COS_A, A_NEG, TOL,
           kRows };

struct Args {
  const float* xs;    // (R, 3) ray starts
  const float* dirs;  // (R, 3) unit directions
  const int* off0;    // (R,) linear offset of the time bin, or null
  const int* off1;    // (R,) second time bin (lerp), or null
  const float* w;     // (R,) lerp weight of off1, or null
  const float* table; // (kRows, kW)
  const float* d;     // flat density
  float* y;           // (R,)
  int n_rays, nr, ne, na;
};

// Per-ray quantities shared by every crossing row.
struct Ray {
  float xx, xy, xz, rx, ry, rz;
  float tc, d2, rdx, xx2;
};

__device__ __forceinline__ float nonneg(float x) {
  return x < 0.f ? 0.f : x;  // jnp.maximum(x, 0) for non-NaN x, NaN kept
}

// Crossing distance of table row `row` (fused_pallas.py:156-225).
__device__ float crossing(int row, const Ray& g, const float* tab, int nrb,
                          int neb, int nab) {
  const float ftol = tab[TOL * kW], tol3 = tab[TOL * kW + 1],
              tol2 = tab[TOL * kW + 2];
  float t;
  if (row == 0) return 0.f;
  int j = row - 1;
  if (j < 2 * nrb) {  // spheres: near rows, then far rows
    const bool near = j < nrb;
    const float disc = tab[R2C * kW + (near ? j : j - nrb)] - g.d2;
    if (disc < 0.f) return kInf;
    const float t1c = sqrtf(nonneg(disc));
    t = near ? g.tc - t1c : g.tc + t1c;
  } else if ((j -= 2 * nrb) < 2 * neb) {  // cones: near rows, then far
    const bool near = j < neb;
    const int b = near ? j : j - neb;
    const float c2 = tab[COS2 * kW + b];
    float aa = g.rz * g.rz - c2;
    const float bb = 2.f * (g.rz * g.xz - g.rdx * c2);
    const float cc = g.xz * g.xz - g.xx2 * c2;
    if (fabsf(aa) < tol3) aa = 0.f;
    float delta = bb * bb - 4.f * aa * cc;
    if (fabsf(delta) < tol2) delta = 0.f;
    const bool neg = delta < 0.f;
    const float sq = sqrtf(nonneg(delta));
    const float safe_aa = aa == 0.f ? 1.f : aa;
    const float t1 = neg ? kInf : (-bb + sq) / (2.f * safe_aa);
    const float t2 = neg ? kInf : (-bb - sq) / (2.f * safe_aa);
    const bool single = aa == 0.f && fabsf(bb) >= tol3;
    const bool on_cone = aa == 0.f && fabsf(bb) < tol3;
    if (on_cone || (aa != 0.f && neg)) return kInf;
    t = near ? (single ? -cc / (bb == 0.f ? 1.f : bb) : t1)
             : (single ? kInf : t2);
    if (isfinite(t)) {  // the cone's shadow (the other nappe)
      const float pz = g.xz + t * g.rz;
      if (((pz >= 0.f) != (tab[COS_UP * kW + b] > 0.f))
          && tab[NOT_EQ * kW + b] > 0.f)
        t = kInf;
    }
  } else if ((j -= 2 * neb) < nab) {  // azimuth half-planes
    const float s = tab[SIN_A * kW + j], c = tab[COS_A * kW + j];
    const float nxv = -s * g.xx + c * g.xy;
    const float nrv = -s * g.rx + c * g.ry;
    const float cross_z = c * g.ry - s * g.rx;
    t = fabsf(cross_z) <= ftol ? kInf : -nxv / (nrv == 0.f ? 1.f : nrv);
    if (isfinite(t)) {  // the plane's shadow (the other half-plane)
      const float pxa = g.xx + t * g.rx;
      const float pya = g.xy + t * g.ry;
      if (c * pxa + s * pya < 0.f) t = kInf;
    }
  } else {
    return kInf;  // pad row
  }
  return isnan(t) ? kInf : t;
}

// Ascending bitonic sort of the warp's K*32 values, element e = lane*K + k.
__host__ __device__ constexpr int log2i(int n) {
  return n > 1 ? 1 + log2i(n >> 1) : 0;
}

template <int K>
__device__ __forceinline__ void warp_bitonic(float (&v)[K], int lane) {
  // integer-counted loops so that every one unrolls and v stays in
  // registers
#pragma unroll
  for (int ls = 1; ls <= log2i(K * kWarp); ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int stride = 1 << lj;
      if (stride >= K) {  // partner in lane ^ (stride / K), same k
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int e = lane * K + k;
          const float o = __shfl_xor_sync(kFull, v[k], stride / K);
          const bool up = (e & size) == 0, lower = (e & stride) == 0;
          v[k] = lower == up ? fminf(v[k], o) : fmaxf(v[k], o);
        }
      } else {  // partner in this lane's registers
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k & stride) continue;
          const bool up = ((lane * K + k) & size) == 0;
          const float a = v[k], b = v[k | stride];
          v[k] = up ? fminf(a, b) : fmaxf(a, b);
          v[k | stride] = up ? fmaxf(a, b) : fminf(a, b);
        }
      }
    }
  }
}

// pos = (number of leading boundaries i with ok(i)) - 1, in [-1, nb - 1]:
// the 7-step search of fused_pallas.py:243-254 (nb <= 127).
template <typename Ok>
__device__ __forceinline__ int search(int nb, Ok ok) {
  int pos = -1;
#pragma unroll
  for (int step = 64; step; step >>= 1) {
    const int cand = pos + step;
    if (cand < nb && ok(cand)) pos = cand;
  }
  return pos;
}

template <int K, bool LERP>
__global__ void __launch_bounds__(kBlock) fused_fwd_kernel(Args a) {
  __shared__ float tab[kRows * kW];
  for (int i = threadIdx.x; i < kRows * kW; i += kBlock)
    tab[i] = __ldg(a.table + i);
  __syncthreads();

  const int lane = threadIdx.x & (kWarp - 1);
  const int nrb = a.nr + 1, neb = a.ne + 1, nab = a.na + 1;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  // the whole warp walks the same rays, so every shuffle below has 32
  // active lanes
  for (long long ray = static_cast<long long>(blockIdx.x) * kWarps
                       + threadIdx.x / kWarp;
       ray < a.n_rays; ray += n_warps) {
    Ray g;
    g.xx = __ldg(a.xs + 3 * ray);
    g.xy = __ldg(a.xs + 3 * ray + 1);
    g.xz = __ldg(a.xs + 3 * ray + 2);
    g.rx = __ldg(a.dirs + 3 * ray);
    g.ry = __ldg(a.dirs + 3 * ray + 1);
    g.rz = __ldg(a.dirs + 3 * ray + 2);
    g.tc = -(g.xx * g.rx + g.xy * g.ry + g.xz * g.rz);
    const float cxx = g.xy * g.rz - g.xz * g.ry;
    const float cyy = g.xz * g.rx - g.xx * g.rz;
    const float czz = g.xx * g.ry - g.xy * g.rx;
    g.d2 = cxx * cxx + cyy * cyy + czz * czz;
    g.rdx = g.rx * g.xx + g.ry * g.xy + g.rz * g.xz;
    g.xx2 = g.xx * g.xx + g.xy * g.xy + g.xz * g.xz;

    // crossing rows go to the slots striped (row = k*32 + lane), so a
    // warp's lanes mostly take the same boundary family; the sort does
    // not care where a value starts
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = crossing(k * kWarp + lane, g, tab, nrb, neb, nab);
    warp_bitonic<K>(v, lane);

    const float next0 = __shfl_down_sync(kFull, v[0], 1);
    const int off0 = a.off0 ? __ldg(a.off0 + ray) : 0;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = v[k];
      const float tn = k + 1 < K ? v[k + 1]
                                 : (lane == kWarp - 1 ? kInf : next0);
      const float len = tn - t;
      // sorted: the dead (+inf) tail is skipped segment by segment
      if (!(isfinite(len) && len > 0.f && t >= 0.f && isfinite(t)))
        continue;
      const float tm = t + len * 0.5f;
      const float px = g.xx + tm * g.rx;
      const float py = g.xy + tm * g.ry;
      const float pz = g.xz + tm * g.rz;
      const float p2 = px * px + py * py + pz * pz;
      const float pn = sqrtf(p2);
      const int rb = search(nrb, [&](int i) {
        return p2 >= tab[R2S * kW + i]; });
      const int eb = search(neb, [&](int i) {
        return pz <= pn * tab[COS_E * kW + i]; });
      const int ab = search(nab, [&](int i) {
        const bool alneg = tab[A_NEG * kW + i] > 0.5f;
        const bool crossge =
            tab[COS_A * kW + i] * py - tab[SIN_A * kW + i] * px >= 0.f;
        return py >= 0.f ? (alneg || crossge) : (alneg && crossge);
      });
      if (rb < 0 || rb > a.nr - 1 || eb < 0 || eb > a.ne - 1 || ab < 0
          || ab > a.na - 1)
        continue;
      const int code = (rb * a.ne + eb) * a.na + ab + off0;
      if (LERP) {
        const float wr = __ldg(a.w + ray);
        const int code1 = code - off0 + __ldg(a.off1 + ray);
        acc += __ldg(a.d + code) * (len * (1.f - wr));
        acc += __ldg(a.d + code1) * (len * wr);
      } else {
        acc += __ldg(a.d + code) * len;
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) a.y[ray] = acc;
  }
}

template <int K>
cudaError_t launch_k(const Args& a, bool lerp, cudaStream_t s) {
  const long long want = (static_cast<long long>(a.n_rays) + kWarps - 1)
                         / kWarps;
  const unsigned blocks = static_cast<unsigned>(
      want < kMaxBlocks ? want : kMaxBlocks);
  if (lerp)
    fused_fwd_kernel<K, true><<<blocks, kBlock, 0, s>>>(a);
  else
    fused_fwd_kernel<K, false><<<blocks, kBlock, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface: device pointers and the stream as void*, sizes as int.
// `mp` is the padded crossing count (a power of two, <= 512); off0, off1
// and w may be null (no time offset / no lerp; lerp needs both).  Returns
// cudaGetLastError() right after the launch (0 = ok).
extern "C" int fused_fwd(const void* xs, const void* dirs, const void* off0,
                         const void* off1, const void* w, const void* table,
                         const void* d, void* y, int n_rays, int nr, int ne,
                         int na, int mp, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if ((off1 == nullptr) != (w == nullptr) || nr < 1 || ne < 1 || na < 1
      || nr + 1 > kW - 1 || ne + 1 > kW - 1 || na + 1 > kW - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(xs),
               static_cast<const float*>(dirs),
               static_cast<const int*>(off0),
               static_cast<const int*>(off1),
               static_cast<const float*>(w),
               static_cast<const float*>(table),
               static_cast<const float*>(d),
               static_cast<float*>(y),
               n_rays, nr, ne, na};
  const bool lerp = off1 != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mp <= kWarp ? 1 : mp / kWarp) {
    case 1: return static_cast<int>(launch_k<1>(a, lerp, s));
    case 2: return static_cast<int>(launch_k<2>(a, lerp, s));
    case 4: return static_cast<int>(launch_k<4>(a, lerp, s));
    case 8: return static_cast<int>(launch_k<8>(a, lerp, s));
    case 16: return static_cast<int>(launch_k<16>(a, lerp, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
