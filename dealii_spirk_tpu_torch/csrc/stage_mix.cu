// K2: out_i = sum_j mat[i, j] W_j over the stage axis of a (q_in, n)
// block — the T^-1 and T basis changes around each V-cycle.
//
// Replaces the Pallas kernel of stage_mix_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py, _make_kernel_stage_mix).
// Streaming: each thread reads all q_in stages of one spatial point into
// registers and writes all q_out outputs, so every element moves once.
//
// Bound on the H100: DRAM (2 field passes, 2 q flops per point); the
// GEMM form reads the block through cuBLAS at a similar cost.  Measured
// 42% of the DRAM roof at q=4, m=127 (PERF.md).
#include "common.cuh"

namespace spirk {

__global__ void __launch_bounds__(NTHREADS)
stage_mix_kernel(const float* __restrict__ W, float* __restrict__ out,
                 const float* __restrict__ mat, int qo, int qi, long long n) {
  __shared__ float ms[QMAX * QMAX];
  if (threadIdx.x < qo * qi) ms[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * NTHREADS;
  for (long long g = (long long)blockIdx.x * NTHREADS + threadIdx.x; g < n; g += stride) {
    float w[QMAX];
#pragma unroll
    for (int j = 0; j < QMAX; ++j) w[j] = (j < qi) ? __ldg(W + j * n + g) : 0.f;
#pragma unroll
    for (int i = 0; i < QMAX; ++i) {
      if (i < qo) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < QMAX; ++j)
          if (j < qi) s += ms[i * qi + j] * w[j];
        out[i * n + g] = s;
      }
    }
  }
}

}  // namespace spirk

extern "C" int spirk_stage_mix(const float* W, float* out, const float* mat, int qo, int qi,
                               long long n, void* stream) {
  if (qo < 1 || qi < 1 || qo > spirk::QMAX || qi > spirk::QMAX) return cudaErrorInvalidValue;
  long long blocks = (n + spirk::NTHREADS - 1) / spirk::NTHREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  if (blocks < 1) blocks = 1;
  spirk::stage_mix_kernel<<<(unsigned)blocks, spirk::NTHREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(W, out, mat, qo, qi, n);
  return cudaGetLastError();
}
