// The fused projection kernel for NVIDIA Hopper (sm_90a), as a template on
// its design, its truncation stage and the padded crossing count.  Included
// by fused_project.cu and fused_project_lerp.cu (the shipped design at
// every Mp, the entry fused_fwd) and by fused_sweep.cu and
// fused_sweep_parent.cu (each design at every stage, Mp = 256, the entry
// fused_fwd_sweep that tools/fused_sweep.py times).  Each source compiles
// its own instantiations: everything that launches a kernel lives in an
// unnamed namespace.
//
// Replaces (sph_raytracer_tpu/ops/fused_pallas.py):
//   fused_fwd  <- _make_kernel, launched by _fused_pallas_call  (B4)
// It computes what B4 computes, per ray:
//   1. all M boundary-crossing distances: the ray start (t = 0), sphere
//      near / far, cone near / far (with the tol3 / tol2 snaps, the
//      single-root and on-cone cases and the cone shadow), azimuth
//      half-planes (with their shadow); NaN -> +inf;
//   2. an ascending sort;
//   3. segment lengths next - cur (+inf after the last), live segments
//      (finite, > 0, t >= 0), each labelled by the voxel of its midpoint
//      through three binary searches over the boundary tables (r^2,
//      pz <= |p| cos e, the azimuth half-plane test: no atan2);
//   4. y = sum of d[code] * len, code = (r*NE + e)*NA + a + off0; with lerp
//      (time-interpolated 4D) (1-w)*len at code and w*len at
//      code - off0 + off1.
// The formulas are fused_pallas.py:156-336's, operation for operation, so
// that the kernel and its plain version (ops/fused_project.py) label the
// same way: built with -fmad=false, IEEE '/' and sqrtf.  What B4 did only
// for want of a general gather on a TPU (the (8,128) geometry blocks, the
// density-window sweep) is dropped: the density is gathered from global
// memory through the read-only path (it stays in the 50 MB L2).
//
// What bounds it on this card: operations (per ray 28-40 bytes, ~10^4
// float ops); the sweeps found it instruction-bound (more warps an SM or
// two segments a lane a step did not help, fewer instructions did).  One
// warp a ray; the boundary tables (<= 127 entries a row) in shared memory;
// 8 warps a block.  Two designs (enum Design):
//   kParent   the kernel as first ported: each lane computes its rows'
//             crossings (row = k*32 + lane), sorts all Mp in registers and
//             walks its own Mp/32 sorted slots; 4,096 blocks striding over
//             the rays, no register cap.  Kept so that the sweep can split
//             its time by stage;
//   kShipped  what fused_fwd launches:
//             - by boundary: a lane takes one sphere or cone boundary and
//               yields both roots from one computation of the shared terms
//               (the cone's aa, bb, cc, delta, sqrt and two IEEE quotients
//               once, not once a root); each step is one family, so no
//               warp runs two families' code;
//             - compacted: only the finite values are staged (a ballot and
//               a popcount give each lane its write slot in a per-warp
//               shared buffer) and only S = pow2(count) of them are
//               sorted, at S / 32 values a lane (the +inf tail is the same
//               in every sort);
//             - the dense walk: the sorted values go back to the buffer and
//               the segments from the first t >= 0 to the last finite one
//               are walked 32 at a time, one a lane, reading t and its
//               successor from the buffer (~3 steps a ray on 32 lanes at
//               the flagship, where the per-lane walk takes 8 serial slots
//               on ~12 live lanes);
//             - 64 registers a thread at most (32 warps an SM) and one warp
//               a ray (a grid as large as the rays).
// PERF.md holds what each of these was worth and the variants tried.
// The sort is a warp bitonic network on KS values a lane, element
// e = lane*KS + k: compare-exchanges in registers for strides inside a
// lane, __shfl_xor_sync across lanes.  The sum is one accumulator a lane
// and a fixed shuffle tree: bitwise equal run to run.

#pragma once

#include <cuda_runtime.h>

#include <limits>

namespace fused {

constexpr int kWarp = 32;
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

// Where a launch stops (tools/fused_sweep.py's stage split): after the
// crossings, the sort, the labels, or not at all.  A truncated launch
// writes per ray a fold of what its last stage produced (so that no work
// is dropped) in place of y, and reads no lerp input.
enum Stage { kCrossings, kSort, kLabels, kAll };

// The designs, in the order of fused_fwd_sweep's `design` argument
// (tools/fused_sweep.py DESIGNS).
enum Design { kParent, kShipped };

constexpr int kWarps = 8;  // rays in flight a block
// kParent's grid: at most this many blocks (kShipped: one warp a ray)
constexpr int kParentBlocks = 4096;
// kShipped's register cap of 64 a thread, as __launch_bounds__' minimum
// blocks an SM: 32 warps an SM, half the card's 64.  A truncated stage
// held to the whole kernel's cap runs at its occupancy.  (Mp = 512 holds
// 16 values a lane in the sort: that kernel keeps the registers it needs.)
constexpr int kShippedMinBlocks = 65536 / (64 * kWarps * kWarp);

// Launches that each compile in a source of their own, so that the four
// sources build in parallel: the shipped design's whole kernel with lerp
// at padded crossing count mp (fused_project_lerp.cu; fused_project.cu
// holds it without), and the first port's design at Mp = 256 stopped
// after `stage` (fused_sweep_parent.cu; fused_sweep.cu holds the shipped
// design's).
cudaError_t launch_shipped_lerp(const Args& a, int mp, cudaStream_t s);
cudaError_t launch_parent_stage(const Args& a, bool lerp, int stage,
                                cudaStream_t s);

}  // namespace fused

namespace {

using namespace fused;

// Per-ray quantities shared by every crossing.
struct Ray {
  float xx, xy, xz, rx, ry, rz;
  float tc, d2, rdx, xx2;
};

__device__ __forceinline__ float nonneg(float x) {
  return x < 0.f ? 0.f : x;  // jnp.maximum(x, 0) for non-NaN x, NaN kept
}

__device__ __forceinline__ float finite_or_inf(float t) {
  return isnan(t) ? kInf : t;
}

__device__ __forceinline__ Ray load_ray(const Args& a, long long ray) {
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
  return g;
}

// The cone's shadow (the other nappe) of a finite root t of cone b.
__device__ __forceinline__ float cone_shadow(float t, int b, const Ray& g,
                                             const float* tab) {
  if (isfinite(t)) {
    const float pz = g.xz + t * g.rz;
    if (((pz >= 0.f) != (tab[COS_UP * kW + b] > 0.f))
        && tab[NOT_EQ * kW + b] > 0.f)
      t = kInf;
  }
  return t;
}

// What both roots of cone b share (fused_pallas.py:176-212): the two
// quotients; `none` when the ray has no root (on the cone, or no real
// root), `single` when it has one (-cc / bb, the near root).
struct ConeTerms {
  float bb, cc, t1, t2;
  bool none, single;
};

__device__ __forceinline__ ConeTerms cone_terms(int b, const Ray& g,
                                                const float* tab) {
  const float tol3 = tab[TOL * kW + 1], tol2 = tab[TOL * kW + 2];
  const float c2 = tab[COS2 * kW + b];
  float aa = g.rz * g.rz - c2;
  ConeTerms c;
  c.bb = 2.f * (g.rz * g.xz - g.rdx * c2);
  c.cc = g.xz * g.xz - g.xx2 * c2;
  if (fabsf(aa) < tol3) aa = 0.f;
  float delta = c.bb * c.bb - 4.f * aa * c.cc;
  if (fabsf(delta) < tol2) delta = 0.f;
  const bool neg = delta < 0.f;
  const float sq = sqrtf(nonneg(delta));
  const float safe_aa = aa == 0.f ? 1.f : aa;
  c.t1 = neg ? kInf : (-c.bb + sq) / (2.f * safe_aa);
  c.t2 = neg ? kInf : (-c.bb - sq) / (2.f * safe_aa);
  c.single = aa == 0.f && fabsf(c.bb) >= tol3;
  const bool on_cone = aa == 0.f && fabsf(c.bb) < tol3;
  c.none = on_cone || (aa != 0.f && neg);
  return c;
}

// The near or far root of cone b from its terms, shadow and NaN -> +inf
// applied.
__device__ __forceinline__ float cone_root(const ConeTerms& c, bool near,
                                           int b, const Ray& g,
                                           const float* tab) {
  if (c.none) return kInf;
  const float t = near ? (c.single ? -c.cc / (c.bb == 0.f ? 1.f : c.bb)
                                   : c.t1)
                       : (c.single ? kInf : c.t2);
  return finite_or_inf(cone_shadow(t, b, g, tab));
}

// Both roots of cone b, (near, far), from one computation of their terms.
__device__ __forceinline__ void cone_roots(int b, const Ray& g,
                                           const float* tab, float& tn,
                                           float& tf) {
  const ConeTerms c = cone_terms(b, g, tab);
  tn = cone_root(c, true, b, g, tab);
  tf = cone_root(c, false, b, g, tab);
}

// Both roots of sphere j, (near, far).
__device__ __forceinline__ void sphere_roots(int j, const Ray& g,
                                             const float* tab, float& tn,
                                             float& tf) {
  const float disc = tab[R2C * kW + j] - g.d2;
  if (disc < 0.f) {
    tn = tf = kInf;
    return;
  }
  const float t1c = sqrtf(nonneg(disc));
  tn = finite_or_inf(g.tc - t1c);
  tf = finite_or_inf(g.tc + t1c);
}

// The crossing of azimuth half-plane j (fused_pallas.py:213-225).
__device__ __forceinline__ float plane_root(int j, const Ray& g,
                                            const float* tab) {
  const float ftol = tab[TOL * kW];
  const float s = tab[SIN_A * kW + j], c = tab[COS_A * kW + j];
  const float nxv = -s * g.xx + c * g.xy;
  const float nrv = -s * g.rx + c * g.ry;
  const float cross_z = c * g.ry - s * g.rx;
  float t = fabsf(cross_z) <= ftol ? kInf : -nxv / (nrv == 0.f ? 1.f : nrv);
  if (isfinite(t)) {  // the plane's shadow (the other half-plane)
    const float pxa = g.xx + t * g.rx;
    const float pya = g.xy + t * g.ry;
    if (c * pxa + s * pya < 0.f) t = kInf;
  }
  return finite_or_inf(t);
}

// Crossing distance of table row `row` (fused_pallas.py:156-225): row 0
// is the ray start, then sphere near / far rows, cone near / far rows,
// azimuth rows, pad rows (+inf).  The parent design's crossings, by row,
// through the by-boundary design's formulas (the same ops, so the same
// rounding): a sphere row takes its root of the pair, a cone row computes
// the cone's terms and its own root.
__device__ float crossing(int row, const Ray& g, const float* tab, int nrb,
                          int neb, int nab) {
  if (row == 0) return 0.f;
  int j = row - 1;
  float tn, tf;
  if (j < 2 * nrb) {  // spheres: near rows, then far rows
    const bool near = j < nrb;
    sphere_roots(near ? j : j - nrb, g, tab, tn, tf);
    return near ? tn : tf;
  }
  if ((j -= 2 * nrb) < 2 * neb) {  // cones: near rows, then far rows
    const bool near = j < neb;
    const int b = near ? j : j - neb;
    return cone_root(cone_terms(b, g, tab), near, b, g, tab);
  }
  if ((j -= 2 * neb) < nab) return plane_root(j, g, tab);  // azimuth
  return kInf;  // pad row
}

// Appends the lanes' finite values t to the warp's buffer wb at n (a
// ballot and a popcount give each lane its slot); counts the negatives.
__device__ __forceinline__ void put(float t, float* wb, unsigned lt, int& n,
                                   int& n_neg) {
  const bool fin = isfinite(t);
  const unsigned m = __ballot_sync(kFull, fin);
  if (fin) wb[n + __popc(m & lt)] = t;
  n += __popc(m);
  n_neg += __popc(__ballot_sync(kFull, fin && t < 0.f));
}

// The finite crossings of the ray, a boundary a lane, staged in wb in no
// particular order; returns their count, n_neg the count of those < 0.
__device__ __forceinline__ int stage_crossings(const Ray& g, const float* tab,
                                               float* wb, int lane, int nrb,
                                               int neb, int nab, int& n_neg) {
  const unsigned lt = (1u << lane) - 1u;
  n_neg = 0;
  if (lane == 0) wb[0] = 0.f;  // the ray start
  int n = 1;
  for (int b0 = 0; b0 < nrb; b0 += kWarp) {  // warp-uniform steps
    float tn = kInf, tf = kInf;
    if (b0 + lane < nrb) sphere_roots(b0 + lane, g, tab, tn, tf);
    put(tn, wb, lt, n, n_neg);
    put(tf, wb, lt, n, n_neg);
  }
  for (int b0 = 0; b0 < neb; b0 += kWarp) {
    float tn = kInf, tf = kInf;
    if (b0 + lane < neb) cone_roots(b0 + lane, g, tab, tn, tf);
    put(tn, wb, lt, n, n_neg);
    put(tf, wb, lt, n, n_neg);
  }
  for (int b0 = 0; b0 < nab; b0 += kWarp)
    put(b0 + lane < nab ? plane_root(b0 + lane, g, tab) : kInf, wb, lt, n,
        n_neg);
  return n;
}

// Ascending bitonic sort of the warp's KS*32 values, element e = lane*KS + k.
__host__ __device__ constexpr int log2i(int n) {
  return n > 1 ? 1 + log2i(n >> 1) : 0;
}

template <int KS>
__device__ __forceinline__ void warp_bitonic(float (&v)[KS], int lane) {
  // integer-counted loops so that every one unrolls and v stays in
  // registers
#pragma unroll
  for (int ls = 1; ls <= log2i(KS * kWarp); ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int stride = 1 << lj;
      if (stride >= KS) {  // partner in lane ^ (stride / KS), same k
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int e = lane * KS + k;
          const float o = __shfl_xor_sync(kFull, v[k], stride / KS);
          const bool up = (e & size) == 0, lower = (e & stride) == 0;
          v[k] = lower == up ? fminf(v[k], o) : fmaxf(v[k], o);
        }
      } else {  // partner in this lane's registers
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          if (k & stride) continue;
          const bool up = ((lane * KS + k) & size) == 0;
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

// What the walks need of the ray besides t, its successor, the launch's
// arguments and the ray's geometry.
struct Walk {
  const float* tab;
  long long ray;
  int off0, nrb, neb, nab;
};

// The ray's Walk, made after its sort (so that off0 is not held through
// it).
__device__ __forceinline__ Walk walk(const Args& a, const float* tab,
                                     long long ray, int nrb, int neb,
                                     int nab) {
  return Walk{tab, ray, a.off0 ? __ldg(a.off0 + ray) : 0, nrb, neb, nab};
}

// Adds the segment (t, tn)'s term to acc when it is live and labelled
// inside the grid (fused_pallas.py:273-336); stopped after the labels, its
// code times its length, without the gather.
template <int STAGE, bool LERP>
__device__ __forceinline__ void segment(float t, float tn, const Args& a,
                                        const Ray& g, const Walk& s,
                                        float& acc) {
  const float len = tn - t;
  if (!(isfinite(len) && len > 0.f && t >= 0.f && isfinite(t))) return;
  const float* tab = s.tab;
  const float tm = t + len * 0.5f;
  const float px = g.xx + tm * g.rx;
  const float py = g.xy + tm * g.ry;
  const float pz = g.xz + tm * g.rz;
  const float p2 = px * px + py * py + pz * pz;
  const float pn = sqrtf(p2);
  const int rb = search(s.nrb, [&](int i) {
    return p2 >= tab[R2S * kW + i]; });
  const int eb = search(s.neb, [&](int i) {
    return pz <= pn * tab[COS_E * kW + i]; });
  const int ab = search(s.nab, [&](int i) {
    const bool alneg = tab[A_NEG * kW + i] > 0.5f;
    const bool crossge =
        tab[COS_A * kW + i] * py - tab[SIN_A * kW + i] * px >= 0.f;
    return py >= 0.f ? (alneg || crossge) : (alneg && crossge);
  });
  if (rb < 0 || rb > a.nr - 1 || eb < 0 || eb > a.ne - 1 || ab < 0
      || ab > a.na - 1)
    return;
  const int code = (rb * a.ne + eb) * a.na + ab + s.off0;
  if constexpr (STAGE == kLabels) {
    acc += static_cast<float>(code) * len;
  } else if constexpr (LERP) {
    const float wr = __ldg(a.w + s.ray);
    const int code1 = code - s.off0 + __ldg(a.off1 + s.ray);
    acc += __ldg(a.d + code) * (len * (1.f - wr));
    acc += __ldg(a.d + code1) * (len * wr);
  } else {
    acc += __ldg(a.d + code) * len;
  }
}

// The per-lane walk: each lane its KS sorted slots, the last one's end
// from the next lane's first value.
template <int KS, int STAGE, bool LERP>
__device__ __forceinline__ float lane_walk(const float (&v)[KS], int lane,
                                           const Args& a, const Ray& g,
                                           const Walk& s) {
  const float next0 = __shfl_down_sync(kFull, v[0], 1);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float tn = k + 1 < KS ? v[k + 1]
                                : (lane == kWarp - 1 ? kInf : next0);
    // sorted: the dead (+inf) tail is skipped segment by segment
    segment<STAGE, LERP>(v[k], tn, a, g, s, acc);
  }
  return acc;
}

// The dense walk over the sorted values in wb: segment e (from wb[e] to
// wb[e + 1]) for e in [n_neg, n - 2], 32 at a time, one a lane.  Below
// n_neg t < 0; from n - 1 on the successor is +inf.
template <int STAGE, bool LERP>
__device__ __forceinline__ float dense_walk(const float* wb, int n, int n_neg,
                                            int lane, const Args& a,
                                            const Ray& g, const Walk& s) {
  float acc = 0.f;
  for (int e = n_neg + lane; e < n - 1; e += kWarp)
    segment<STAGE, LERP>(wb[e], wb[e + 1], a, g, s, acc);
  return acc;
}

// A fold of sorted values that depends on their order (stage kSort).
template <int KS>
__device__ __forceinline__ float fold_sorted(const float (&v)[KS]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < KS; ++k)
    if (isfinite(v[k])) acc += v[k] * static_cast<float>(k + 1);
  return acc;
}

// Sorts the staged values as the KS*32-wide sort's elements (lane-major,
// +inf from n on) and writes them back to wb; with FOLD returns a fold of
// the sorted values instead (stage kSort).
template <int KS, bool FOLD>
__device__ __forceinline__ float sort_staged(float* wb, int n, int lane) {
  float v[KS];
  float* src = wb + lane * KS;
  if constexpr (KS % 4 == 0) {
#pragma unroll
    for (int k = 0; k < KS; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else if constexpr (KS == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = src[0];
  }
#pragma unroll
  for (int k = 0; k < KS; ++k)
    if (lane * KS + k >= n) v[k] = kInf;
  warp_bitonic<KS>(v, lane);
  if constexpr (FOLD) return fold_sorted<KS>(v);
  __syncwarp();  // every lane has read its values
  if constexpr (KS % 4 == 0) {
#pragma unroll
    for (int k = 0; k < KS; k += 4)
      *reinterpret_cast<float4*>(src + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (KS == 2) {
    *reinterpret_cast<float2*>(src) = make_float2(v[0], v[1]);
  } else {
    src[0] = v[0];
  }
  __syncwarp();
  return 0.f;
}

// sort_staged at KS = ks, a power of two in [KS, K] known at run time.
template <int KS, int K, bool FOLD>
__device__ __forceinline__ float sort_staged_at(int ks, float* wb, int n,
                                                int lane) {
  if constexpr (KS < K) {
    if (ks > KS) return sort_staged_at<2 * KS, K, FOLD>(ks, wb, n, lane);
  }
  return sort_staged<KS, FOLD>(wb, n, lane);
}

template <int K, bool LERP, int STAGE, Design D>
__global__ void __launch_bounds__(kWarps * kWarp,
                                  K > 8 || D == kParent ? 1
                                                        : kShippedMinBlocks)
fused_fwd_kernel(Args a) {
  constexpr int kBlock = kWarps * kWarp;
  __shared__ float tab[kRows * kW];
  // kShipped: per warp Mp floats, the staged crossings, then the sorted ones
  __shared__ __align__(16) float buf[D == kShipped ? kWarps * K * kWarp : 4];
  for (int i = threadIdx.x; i < kRows * kW; i += kBlock)
    tab[i] = __ldg(a.table + i);
  __syncthreads();

  const int lane = threadIdx.x & (kWarp - 1);
  float* wb = buf + (D == kShipped ? (threadIdx.x / kWarp) * K * kWarp : 0);
  const int nrb = a.nr + 1, neb = a.ne + 1, nab = a.na + 1;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  // the whole warp walks the same rays, so every shuffle and ballot below
  // has 32 active lanes
  for (long long ray = static_cast<long long>(blockIdx.x) * kWarps
                       + threadIdx.x / kWarp;
       ray < a.n_rays; ray += n_warps) {
    const Ray g = load_ray(a, ray);
    float acc = 0.f;
    if constexpr (D == kParent) {
      // crossing rows go to the slots striped (row = k*32 + lane), so a
      // warp's lanes mostly take the same boundary family; the sort does
      // not care where a value starts
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] = crossing(k * kWarp + lane, g, tab, nrb, neb, nab);
      if constexpr (STAGE == kCrossings) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (isfinite(v[k])) acc += v[k];
      } else {
        warp_bitonic<K>(v, lane);
        if constexpr (STAGE == kSort)
          acc = fold_sorted<K>(v);
        else
          acc = lane_walk<K, STAGE, LERP>(v, lane, a, g,
                                          walk(a, tab, ray, nrb, neb, nab));
      }
    } else {
      int n_neg;
      const int n = stage_crossings(g, tab, wb, lane, nrb, neb, nab, n_neg);
      __syncwarp();
      if constexpr (STAGE == kCrossings) {
        for (int e = lane; e < n; e += kWarp) acc += wb[e];
      } else {
        // S = pow2(n) >= 32, warp-uniform: KS = S / 32 values a lane
        const int ks = n <= kWarp ? 1 : (1 << (32 - __clz(n - 1))) / kWarp;
        if constexpr (STAGE == kSort) {
          acc = sort_staged_at<1, K, true>(ks, wb, n, lane);
        } else {
          // one walk for every sort size
          sort_staged_at<1, K, false>(ks, wb, n, lane);
          acc = dense_walk<STAGE, LERP>(wb, n, n_neg, lane, a, g,
                                        walk(a, tab, ray, nrb, neb, nab));
        }
      }
      __syncwarp();  // the next ray's staging overwrites wb
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) a.y[ray] = acc;
  }
}

// Launches design D's kernel for K = Mp / 32, stopped after STAGE, with or
// without lerp, on stream s.
template <int K, int STAGE, Design D, bool LERP>
cudaError_t launch_design(const Args& a, cudaStream_t s) {
  const long long want = (static_cast<long long>(a.n_rays) + kWarps - 1)
                         / kWarps;
  const long long cap = D == kParent ? kParentBlocks : want;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  fused_fwd_kernel<K, LERP, STAGE, D><<<blocks, kWarps * kWarp, 0, s>>>(a);
  return cudaGetLastError();
}

// Design D's whole kernel at padded crossing count mp (a power of two,
// <= 512).
template <Design D, bool LERP>
cudaError_t launch_mp(const Args& a, int mp, cudaStream_t s) {
  switch (mp <= kWarp ? 1 : mp / kWarp) {
    case 1: return launch_design<1, kAll, D, LERP>(a, s);
    case 2: return launch_design<2, kAll, D, LERP>(a, s);
    case 4: return launch_design<4, kAll, D, LERP>(a, s);
    case 8: return launch_design<8, kAll, D, LERP>(a, s);
    case 16: return launch_design<16, kAll, D, LERP>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Design D at Mp = 256 stopped after `stage` (a truncation reads no lerp
// input, so it runs without).
template <Design D>
cudaError_t launch_stage(const Args& a, bool lerp, int stage,
                         cudaStream_t s) {
  switch (stage) {
    case kCrossings: return launch_design<8, kCrossings, D, false>(a, s);
    case kSort: return launch_design<8, kSort, D, false>(a, s);
    case kLabels: return launch_design<8, kLabels, D, false>(a, s);
    case kAll:
      return lerp ? launch_design<8, kAll, D, true>(a, s)
                  : launch_design<8, kAll, D, false>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t check_args(const void* off1, const void* w, int nr, int ne,
                       int na) {
  if ((off1 == nullptr) != (w == nullptr) || nr < 1 || ne < 1 || na < 1
      || nr + 1 > kW - 1 || ne + 1 > kW - 1 || na + 1 > kW - 1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

Args make_args(const void* xs, const void* dirs, const void* off0,
               const void* off1, const void* w, const void* table,
               const void* d, void* y, int n_rays, int nr, int ne, int na) {
  return Args{static_cast<const float*>(xs),
              static_cast<const float*>(dirs),
              static_cast<const int*>(off0),
              static_cast<const int*>(off1),
              static_cast<const float*>(w),
              static_cast<const float*>(table),
              static_cast<const float*>(d),
              static_cast<float*>(y),
              n_rays, nr, ne, na};
}

}  // namespace
