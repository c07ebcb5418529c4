// The sweep's kernels of the first port's design (kParent) at every stage,
// Mp = 256, compiled apart from fused_sweep.cu so that the two build in
// parallel.

#include "fused_kernel.cuh"

cudaError_t fused::launch_parent_stage(const Args& a, bool lerp, int stage,
                                       cudaStream_t s) {
  return launch_stage<kParent>(a, lerp, stage, s);
}
