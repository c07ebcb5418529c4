// The weight (segment length) load shared by the routed kernels.
//
// A weight table holds float32 or, with routed_w_dtype='bf16', bfloat16
// lengths (sph_raytracer_tpu_torch/ops/routed_project.py build_tables /
// build_window_tables round them to nearest even once, at the build).  A
// kernel templated on its weight type W reads every weight through load_w,
// which widens it to f32 (exact for bf16); everything after the load,
// the f32 accumulation included, is the same for both types.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Four consecutive weights from a 4-aligned index: one 16 B load (float) or
// one 8 B load (bfloat16, each widened by placing its bits in the top half
// of an f32).  The table's base must be 16 B aligned (the wrappers check).
__device__ __forceinline__ void load_w4(const float* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

__device__ __forceinline__ void load_w4(const __nv_bfloat16* p,
                                        float (&w)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  w[0] = __uint_as_float(v.x << 16), w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16), w[3] = __uint_as_float(v.y & 0xffff0000u);
}
