// K4: out_i = (a_i M + b K) u_i for every stage i of a (q, m, m, m) block.
//
// Replaces the Pallas kernel of fused_stencil_apply_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py, _make_kernel_3d with
// canon=True and _make_kernel_3d_canon_yb).  Same sum-factorised form:
// Zm = Mz u, Zk = Kz u; E = a Zm + b Zk, F = b Zm; C = My E + Ky F,
// D = My F; out = Mx C + Kx D.  See common.cuh for the tile design.
//
// Bound on the H100: by design DRAM (one read, one write of the block,
// ~50 flops per point at p=1).  This simple version reads each input once
// from DRAM (halo re-reads hit L2) but measured 18% of the DRAM roof at
// q=4, m=127 (PERF.md): its three barrier-separated shared-memory passes
// over haloed tiles bind it, the next thing to streamline.
#include "common.cuh"

namespace spirk {

// w: (q, 2) per-stage [a, b]
template <int P>
__global__ void __launch_bounds__(NTHREADS)
stencil_apply_kernel(const float* __restrict__ u, float* __restrict__ out,
                     const float* __restrict__ mband, const float* __restrict__ kband,
                     const float* __restrict__ w, int m) {
  using T = Tile<P>;
  extern __shared__ float smem[];
  float* in = smem;
  float* E = in + T::IN;
  float* F = E + T::ZP;
  float* C = F + T::ZP;
  float* D = C + T::YP;
  float* bands = D + T::YP;

  const int nzt = (m + TZ - 1) / TZ;
  const int iq = blockIdx.z / nzt;
  const int z0 = (blockIdx.z % nzt) * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const long long stage = (long long)iq * m * m * m;

  Bands<P> bd = load_bands<P>(bands, mband, kband, m, z0, y0, x0);
  load_tile<P>(in, u + stage, m, z0, y0, x0);
  __syncthreads();
  shifted_zy<P>(in, E, F, C, D, bd, w[2 * iq], w[2 * iq + 1]);
#pragma unroll
  for (int s = 0; s < T::PTS; ++s) {
    int lz, ly, lx;
    out_point(s, lz, ly, lx);
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    if (gz < m && gy < m && gx < m)
      out[stage + ((long long)gz * m + gy) * m + gx] = shifted_x<P>(C, D, bd, lz, ly, lx);
  }
}

template <int P>
cudaError_t launch_stencil_apply(const float* u, float* out, const float* mband,
                                 const float* kband, const float* w, int q, int m,
                                 cudaStream_t stream) {
  const int bytes = Tile<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(stencil_apply_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  stencil_apply_kernel<P><<<tile_grid(m, q), NTHREADS, bytes, stream>>>(u, out, mband, kband, w, m);
  return cudaGetLastError();
}

}  // namespace spirk

extern "C" int spirk_stencil_apply(const float* u, float* out, const float* mband,
                                   const float* kband, const float* w, int q, int m, int p,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return spirk::launch_stencil_apply<1>(u, out, mband, kband, w, q, m, s);
    case 2: return spirk::launch_stencil_apply<2>(u, out, mband, kband, w, q, m, s);
    case 3: return spirk::launch_stencil_apply<3>(u, out, mband, kband, w, q, m, s);
    case 4: return spirk::launch_stencil_apply<4>(u, out, mband, kband, w, q, m, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* spirk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
