// K3: one Chebyshev smoother step per stage i of a (q, m, m, m) block,
//   r' = r - (a_i M + b K) d;  d' = c1_i d + c2_i D^-1 r';  x' = x + d'.
//
// Replaces the Pallas kernel of fused_cheb_iter_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py, _make_kernel_cheb_3d with
// canon=True and _make_kernel_cheb_3d_canon_yb, invd variant).  The apply
// on d is K4's tile code (common.cuh); the centre values of d come from
// the staged input tile, so d is read once.  d' goes to a new buffer
// (neighbouring blocks still read d's halo); r' and x' are separate
// outputs as well.
//
// Bound on the H100: DRAM — 7 field passes (d, r, x, D^-1 in; r', d', x'
// out) per point against K4's stencil work.  Fusing the update into the
// apply is what saves the 4 extra passes an apply + elementwise chain
// would take; measured 46% of the DRAM roof at q=4, m=127 (PERF.md).
#include "common.cuh"

namespace spirk {

// w: (q, 4) per-stage [a, b, c1, c2]
template <int P>
__global__ void __launch_bounds__(NTHREADS)
cheb_iter_kernel(const float* __restrict__ d, const float* __restrict__ r,
                 const float* __restrict__ x, const float* __restrict__ invd,
                 float* __restrict__ r_out, float* __restrict__ d_out,
                 float* __restrict__ x_out, const float* __restrict__ mband,
                 const float* __restrict__ kband, const float* __restrict__ w, int m) {
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
  const float c1 = w[4 * iq + 2], c2 = w[4 * iq + 3];

  Bands<P> bd = load_bands<P>(bands, mband, kband, m, z0, y0, x0);
  load_tile<P>(in, d + stage, m, z0, y0, x0);
  __syncthreads();
  shifted_zy<P>(in, E, F, C, D, bd, w[4 * iq], w[4 * iq + 1]);
#pragma unroll
  for (int s = 0; s < T::PTS; ++s) {
    int lz, ly, lx;
    out_point(s, lz, ly, lx);
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    if (gz < m && gy < m && gx < m) {
      long long g = stage + ((long long)gz * m + gy) * m + gx;
      float ad = shifted_x<P>(C, D, bd, lz, ly, lx);
      float rn = r[g] - ad;
      float dc = in[((lz + P) * T::HY + ly + P) * T::HX + lx + P];
      float dn = c1 * dc + c2 * (invd[g] * rn);
      r_out[g] = rn;
      d_out[g] = dn;
      x_out[g] = x[g] + dn;
    }
  }
}

template <int P>
cudaError_t launch_cheb_iter(const float* d, const float* r, const float* x,
                             const float* invd, float* r_out, float* d_out, float* x_out,
                             const float* mband, const float* kband, const float* w, int q,
                             int m, cudaStream_t stream) {
  const int bytes = Tile<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(cheb_iter_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  cheb_iter_kernel<P><<<tile_grid(m, q), NTHREADS, bytes, stream>>>(
      d, r, x, invd, r_out, d_out, x_out, mband, kband, w, m);
  return cudaGetLastError();
}

}  // namespace spirk

extern "C" int spirk_cheb_iter(const float* d, const float* r, const float* x,
                               const float* invd, float* r_out, float* d_out, float* x_out,
                               const float* mband, const float* kband, const float* w, int q,
                               int m, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
#define SPIRK_CASE(P)                                                                     \
  case P:                                                                                 \
    return spirk::launch_cheb_iter<P>(d, r, x, invd, r_out, d_out, x_out, mband, kband, \
                                      w, q, m, s);
    SPIRK_CASE(1)
    SPIRK_CASE(2)
    SPIRK_CASE(3)
    SPIRK_CASE(4)
#undef SPIRK_CASE
    default: return cudaErrorInvalidValue;
  }
}
