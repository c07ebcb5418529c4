// fused_fwd's lerp (view_times) kernels: the shipped design at every
// padded crossing count, compiled apart from fused_project.cu so that the
// two build in parallel.

#include "fused_kernel.cuh"

cudaError_t fused::launch_shipped_lerp(const Args& a, int mp,
                                       cudaStream_t s) {
  return launch_mp<kShipped, true>(a, mp, s);
}
