// Fixed-order sums of per-block or per-split f32 partials, shared by the
// backward kernels that avoid f32 atomics (ln_mlp_wgrad.cuh, ln_mlp_bwd.cu,
// attend_project_bwd.cu).
//
// `reduce_partials_kernel<R>`: out[i] = sum over s of part[s][i], with the
// splits cut into R fixed ranges (8 unless stated) summed by R threads, then
// added in range order. The order depends only on the shapes, so the result
// is the same from run to run.
#pragma once

#include "common.cuh"

namespace dcvit {

// out[i] = sum_s part[s * count + i], s in [0, splits), in a fixed order.
template <int R>
__global__ void __launch_bounds__(32 * R)
    reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                           long long count) {
  __shared__ float sh[R][32];
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  const int s0 = (int)((long long)splits * threadIdx.y / R);
  const int s1 = (int)((long long)splits * (threadIdx.y + 1) / R);
  float acc = 0.f;
  if (i < count) {
#pragma unroll 8
    for (int s = s0; s < s1; ++s) acc += part[(long long)s * count + i];
  }
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < count) {
    float tot = sh[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < R; ++y) tot += sh[y][threadIdx.x];
    out[i] = tot;
  }
}

// Returns the launch's cudaError_t.
template <int R = 8>
inline cudaError_t launch_reduce(const float* part, float* out, int splits, long long count,
                                 cudaStream_t stream) {
  const long long blocks = (count + 31) / 32;
  reduce_partials_kernel<R><<<(unsigned)blocks, dim3(32, R), 0, stream>>>(part, out, splits,
                                                                         count);
  return cudaGetLastError();
}

}  // namespace dcvit
