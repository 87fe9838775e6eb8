// K2: out_i = sum_j mat[i, j] W_j over the stage axis of a (q_in, n)
// block — the T^-1 and T basis changes around each V-cycle, the A^-1 mix
// of the vmult and the complex schemes' maps.
//
// Replaces the Pallas kernel of stage_mix_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py, _make_kernel_stage_mix).
//
// Bound on the H100: DRAM.  It is a pure stream: q_in reads and q_out
// writes of 4 bytes per point against 2 q_in q_out flops, far below the
// f32 rate.  What keeps a stream from the DRAM roof is latency: too few
// bytes in flight per SM.  So each thread issues the loads of all q_in
// stages at MIX_PTS points (MIX_PTS q_in independent loads) before any
// arithmetic; the points of one load instruction are consecutive across
// the warp, so every load and store is coalesced.  Vector loads are out of
// reach: stage j starts at j n floats, and n = m^2 or m^3 is odd for every
// m = 2^r - 1.  The matrix sits in registers, loaded once per thread (the
// same address in every lane), with no shared memory and no barrier.  The
// grid is one wave of resident blocks (the occupancy the card reports for
// this instantiation), each walking its chunks with a grid stride.  At
// P3's shape (q=4, n=1023^2) it measured 0.0093-0.0098 ms per launch on
// the device, 0.0143 ms L2-cold, against a 0.0100 ms bound; 52-58% of the
// DRAM roof at P4's 6x5 and 5x6 maps (PERF.md).
#include "common.cuh"

namespace spirk {

constexpr int MIX_THREADS = 256;
constexpr int MIX_PTS = 4;  // points per thread per chunk
constexpr long long MIX_CHUNK = (long long)MIX_THREADS * MIX_PTS;

template <int QI>
__global__ void __launch_bounds__(MIX_THREADS)
stage_mix_kernel(const float* __restrict__ W, float* __restrict__ out,
                 const float* __restrict__ mat, int qo, long long n) {
  float mr[QMAX][QI];
#pragma unroll
  for (int i = 0; i < QMAX; ++i)
#pragma unroll
    for (int j = 0; j < QI; ++j) mr[i][j] = (i < qo) ? __ldg(mat + i * QI + j) : 0.f;
  const long long stride = (long long)gridDim.x * MIX_CHUNK;
  for (long long c0 = blockIdx.x * MIX_CHUNK + threadIdx.x; c0 < n; c0 += stride) {
    float w[MIX_PTS][QI];
#pragma unroll
    for (int v = 0; v < MIX_PTS; ++v) {
      const long long g = c0 + v * MIX_THREADS;
#pragma unroll
      for (int j = 0; j < QI; ++j) w[v][j] = (g < n) ? __ldg(W + j * n + g) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < QMAX; ++i) {
      if (i < qo) {
#pragma unroll
        for (int v = 0; v < MIX_PTS; ++v) {
          const long long g = c0 + v * MIX_THREADS;
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < QI; ++j) s = fmaf(mr[i][j], w[v][j], s);
          if (g < n) out[i * n + g] = s;
        }
      }
    }
  }
}

// blocks of stage_mix_kernel<QI> that the card holds at once (asked once)
template <int QI>
int resident_mix_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage_mix_kernel<QI>, MIX_THREADS, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <int QI>
cudaError_t launch_stage_mix(const float* W, float* out, const float* mat, int qo, long long n,
                             cudaStream_t stream) {
  const long long chunks = (n + MIX_CHUNK - 1) / MIX_CHUNK;
  const long long resident = resident_mix_blocks<QI>();
  const long long blocks = chunks < resident ? chunks : resident;
  stage_mix_kernel<QI><<<(unsigned)(blocks > 0 ? blocks : 1), MIX_THREADS, 0, stream>>>(
      W, out, mat, qo, n);
  return cudaGetLastError();
}

}  // namespace spirk

extern "C" int spirk_stage_mix(const float* W, float* out, const float* mat, int qo, int qi,
                               long long n, void* stream) {
  if (qo < 1 || qo > spirk::QMAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qi) {
    case 1: return spirk::launch_stage_mix<1>(W, out, mat, qo, n, s);
    case 2: return spirk::launch_stage_mix<2>(W, out, mat, qo, n, s);
    case 3: return spirk::launch_stage_mix<3>(W, out, mat, qo, n, s);
    case 4: return spirk::launch_stage_mix<4>(W, out, mat, qo, n, s);
    case 5: return spirk::launch_stage_mix<5>(W, out, mat, qo, n, s);
    case 6: return spirk::launch_stage_mix<6>(W, out, mat, qo, n, s);
    case 7: return spirk::launch_stage_mix<7>(W, out, mat, qo, n, s);
    case 8: return spirk::launch_stage_mix<8>(W, out, mat, qo, n, s);
    default: return cudaErrorInvalidValue;
  }
}
