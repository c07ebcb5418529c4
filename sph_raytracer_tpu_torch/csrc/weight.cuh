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
