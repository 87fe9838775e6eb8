// K1: out_i = sum_j Ainv[i, j] (M u_j) + tau (K u_i) for all q stages —
// the outer GMRES vmult of irk_batched.
//
// Replaces the Pallas kernel of fused_ms_mix_apply_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py,
// _make_kernel_ms_mix_3d_canon_yb).  One block owns a spatial tile for
// ALL stages: it walks the stages j, stages u_j's haloed tile once,
// computes M u_j and K u_j there (z: Zm, Zk; y: Cm = My Zm,
// Ck = My Zk + Ky Zm; x: M u = Mx Cm, K u = Mx Ck + Kx Cm) and adds them
// into q accumulators per output point held in registers.  Each field
// element is read once and written once.
//
// Bound on the H100: by design DRAM (2 field passes); the unfused
// alternative (M and K applies, then a q x q mix) moves about 3x the
// bytes.  Measured 12% of the DRAM roof at q=4, m=127 (PERF.md): two
// stencils per stage in shared memory and 128 registers per thread (2
// blocks per SM) bind this simple version.
#include "common.cuh"

namespace spirk {

// mw: (q + 1, q) row-major; rows 0..q-1 = Ainv, row q = tau per stage.
template <int P>
__global__ void __launch_bounds__(NTHREADS)
ms_mix_kernel(const float* __restrict__ u, float* __restrict__ out,
              const float* __restrict__ mband, const float* __restrict__ kband,
              const float* __restrict__ mw, int q, int m) {
  using T = Tile<P>;
  extern __shared__ float smem[];
  float* in = smem;
  float* Zm = in + T::IN;
  float* Zk = Zm + T::ZP;
  float* Cm = Zk + T::ZP;
  float* Ck = Cm + T::YP;
  float* bands = Ck + T::YP;
  __shared__ float mws[(QMAX + 1) * QMAX];

  const int z0 = blockIdx.z * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const long long n = (long long)m * m * m;
  for (int i = threadIdx.x; i < (q + 1) * q; i += NTHREADS) mws[i] = mw[i];
  Bands<P> bd = load_bands<P>(bands, mband, kband, m, whole_field(m), z0, y0, x0);

  float acc[QMAX][T::PTS];
#pragma unroll
  for (int i = 0; i < QMAX; ++i)
#pragma unroll
    for (int s = 0; s < T::PTS; ++s) acc[i][s] = 0.f;

  for (int j = 0; j < q; ++j) {
    load_tile<P>(in, u + j * n, m, whole_field(m), z0, y0, x0);
    __syncthreads();
    mass_stiff_zy<P>(in, Zm, Zk, Cm, Ck, bd);
    // coefficients of stage j: Ainv[i, j] on M u_j for every i, tau on
    // K u_j for i == j (constant register indices after unrolling)
    float cM[QMAX], cK[QMAX];
#pragma unroll
    for (int i = 0; i < QMAX; ++i) {
      cM[i] = (i < q) ? mws[i * q + j] : 0.f;
      cK[i] = (i == j) ? mws[q * q + j] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < T::PTS; ++s) {
      int lz, ly, lx;
      out_point(s, lz, ly, lx);
      float mu, ku;
      mass_stiff_x<P>(Cm, Ck, bd, lz, ly, lx, mu, ku);
#pragma unroll
      for (int i = 0; i < QMAX; ++i) acc[i][s] += cM[i] * mu + cK[i] * ku;
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < T::PTS; ++s) {
    int lz, ly, lx;
    out_point(s, lz, ly, lx);
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    if (gz < m && gy < m && gx < m) {
      long long g = ((long long)gz * m + gy) * m + gx;
#pragma unroll
      for (int i = 0; i < QMAX; ++i)
        if (i < q) out[i * n + g] = acc[i][s];
    }
  }
}

template <int P>
cudaError_t launch_ms_mix(const float* u, float* out, const float* mband, const float* kband,
                          const float* mw, int q, int m, cudaStream_t stream) {
  const int bytes = Tile<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(ms_mix_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  ms_mix_kernel<P><<<tile_grid(m, 1), NTHREADS, bytes, stream>>>(u, out, mband, kband, mw, q, m);
  return cudaGetLastError();
}

}  // namespace spirk

extern "C" int spirk_ms_mix_apply(const float* u, float* out, const float* mband,
                                  const float* kband, const float* mw, int q, int m, int p,
                                  void* stream) {
  if (q < 1 || q > spirk::QMAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return spirk::launch_ms_mix<1>(u, out, mband, kband, mw, q, m, s);
    case 2: return spirk::launch_ms_mix<2>(u, out, mband, kband, mw, q, m, s);
    case 3: return spirk::launch_ms_mix<3>(u, out, mband, kband, mw, q, m, s);
    case 4: return spirk::launch_ms_mix<4>(u, out, mband, kband, mw, q, m, s);
    default: return cudaErrorInvalidValue;
  }
}
