// K3 / K3dg: one Chebyshev smoother step per stage i of a (q, m, m, m) block,
//   r' = r - (a_i M + b K) d;  d' = c1_i d + c2_i D^-1 r';  x' = x + d'.
//
// K3 (spirk_cheb_iter) reads D^-1 as a field.  It replaces the Pallas
// kernel of fused_cheb_iter_canon (dealii_spirk_tpu/ops/pallas/stencil.py,
// _make_kernel_cheb_3d with canon=True and _make_kernel_cheb_3d_canon_yb,
// invd variant).
//
// K3dg (spirk_cheb_iter_dg) rebuilds the Jacobi diagonal per point from
// the level's 1D mass/stiffness diagonals instead,
//   diag = (a zm ym + b (zk ym + zm yk)) xm + b zm ym xk,
// and divides by it, so the D^-1 field is never read.  It replaces
// _fused_cheb_canon_dg (the same file, diag=True kernels, _dg_z).
//
// The apply on d is K4's tile code (common.cuh); the centre values of d
// come from the staged input tile, so d is read once.  d' goes to a new
// buffer (neighbouring blocks still read d's halo); r' and x' are separate
// outputs as well.
//
// K9c / K9d (spirk_cheb_iter_halo, spirk_cheb_iter_dg_halo) are K3 / K3dg on
// one z slab of a space-sharded block (ZSlab, common.cuh): only d, the
// operand of the apply, is (q, nzl + 2p, m, m) with p planes of each z
// neighbour; r, x, D^-1 and the three outputs are the slab's (q, nzl, m, m),
// and K9d reads the 1D diagonals at the slab's global rows z_off + k.  They
// replace sharded_cheb_iter_canon (dealii_spirk_tpu/ops/pallas/sharded.py:
// fused_cheb_iter_canon with halo_z=True, with and without diag_tables) and
// equal the whole-field kernels bit for bit.
//
// Bound on the H100: DRAM — K3 moves 7 field passes (d, r, x, D^-1 in;
// r', d', x' out) per point against K4's stencil work, K3dg 6 (the 1D
// factors are 2m floats, served from L1/L2).  Fusing the update into the
// apply is what saves the 4 extra passes an apply + elementwise chain
// would take; K3 measured 46% of the DRAM roof at q=4, m=127 (PERF.md).
#include "common.cuh"

namespace spirk {

// w: (q, 4) per-stage [a, b, c1, c2].  DG = false: jac is D^-1 as a
// (q, m, m, m) field and kdiag is unused; DG = true: jac and kdiag are the
// (m,) 1D mass and stiffness diagonals.
template <int P, bool DG>
__global__ void __launch_bounds__(NTHREADS)
cheb_iter_kernel(const float* __restrict__ d, const float* __restrict__ r,
                 const float* __restrict__ x, const float* __restrict__ jac,
                 const float* __restrict__ kdiag, float* __restrict__ r_out,
                 float* __restrict__ d_out, float* __restrict__ x_out,
                 const float* __restrict__ mband, const float* __restrict__ kband,
                 const float* __restrict__ w, int m, ZSlab zs) {
  using T = Tile<P>;
  extern __shared__ float smem[];
  float* in = smem;
  float* E = in + T::IN;
  float* F = E + T::ZP;
  float* C = F + T::ZP;
  float* D = C + T::YP;
  float* bands = D + T::YP;

  const int nzt = (zs.nz + TZ - 1) / TZ;
  const int iq = blockIdx.z / nzt;
  const int z0 = (blockIdx.z % nzt) * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const long long stage = iq * zs.out_stride(m);
  const float a = w[4 * iq], b = w[4 * iq + 1];
  const float c1 = w[4 * iq + 2], c2 = w[4 * iq + 3];

  Bands<P> bd = load_bands<P>(bands, mband, kband, m, zs, z0, y0, x0);
  load_tile<P>(in, d + iq * zs.in_stride(m), m, zs, z0, y0, x0);
  __syncthreads();
  shifted_zy<P>(in, E, F, C, D, bd, a, b);
#pragma unroll
  for (int s = 0; s < T::PTS; ++s) {
    int lz, ly, lx;
    out_point(s, lz, ly, lx);
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    if (gz < zs.nz && gy < m && gx < m) {
      long long g = stage + ((long long)gz * m + gy) * m + gx;
      float ad = shifted_x<P>(C, D, bd, lz, ly, lx);
      float rn = r[g] - ad;
      float z;
      if constexpr (DG) {
        float zm = __ldg(jac + zs.z_off + gz), zk = __ldg(kdiag + zs.z_off + gz);
        float ym = __ldg(jac + gy), yk = __ldg(kdiag + gy);
        float xm = __ldg(jac + gx), xk = __ldg(kdiag + gx);
        float zmym = zm * ym;
        z = rn / ((a * zmym + b * (zk * ym + zm * yk)) * xm + (b * zmym) * xk);
      } else {
        z = jac[g] * rn;
      }
      float dc = in[((lz + P) * T::HY + ly + P) * T::HX + lx + P];
      float dn = c1 * dc + c2 * z;
      r_out[g] = rn;
      d_out[g] = dn;
      x_out[g] = x[g] + dn;
    }
  }
}

template <int P, bool DG>
cudaError_t launch_cheb_iter(const float* d, const float* r, const float* x,
                             const float* jac, const float* kdiag, float* r_out,
                             float* d_out, float* x_out, const float* mband,
                             const float* kband, const float* w, int q, int m, ZSlab zs,
                             cudaStream_t stream) {
  const int bytes = Tile<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(cheb_iter_kernel<P, DG>, bytes);
  if (err != cudaSuccess) return err;
  cheb_iter_kernel<P, DG><<<tile_grid(m, zs.nz, q), NTHREADS, bytes, stream>>>(
      d, r, x, jac, kdiag, r_out, d_out, x_out, mband, kband, w, m, zs);
  return cudaGetLastError();
}

template <bool DG>
int cheb_iter_entry(const float* d, const float* r, const float* x, const float* jac,
                    const float* kdiag, float* r_out, float* d_out, float* x_out,
                    const float* mband, const float* kband, const float* w, int q, int m,
                    ZSlab zs, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
#define SPIRK_CASE(P)                                                                \
  case P:                                                                            \
    return launch_cheb_iter<P, DG>(d, r, x, jac, kdiag, r_out, d_out, x_out, mband, \
                                   kband, w, q, m, zs, s);
    SPIRK_CASE(1)
    SPIRK_CASE(2)
    SPIRK_CASE(3)
    SPIRK_CASE(4)
#undef SPIRK_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace spirk

extern "C" int spirk_cheb_iter(const float* d, const float* r, const float* x,
                               const float* invd, float* r_out, float* d_out, float* x_out,
                               const float* mband, const float* kband, const float* w, int q,
                               int m, int p, void* stream) {
  return spirk::cheb_iter_entry<false>(d, r, x, invd, nullptr, r_out, d_out, x_out, mband,
                                       kband, w, q, m, spirk::whole_field(m), p, stream);
}

// d: (q, nzl + 2p, m, m); every other field (q, nzl, m, m)
extern "C" int spirk_cheb_iter_halo(const float* d, const float* r, const float* x,
                                    const float* invd, float* r_out, float* d_out,
                                    float* x_out, const float* mband, const float* kband,
                                    const float* w, int q, int m, int nzl, int z_off, int p,
                                    void* stream) {
  return spirk::cheb_iter_entry<false>(d, r, x, invd, nullptr, r_out, d_out, x_out, mband,
                                       kband, w, q, m, spirk::ZSlab{nzl, p, z_off}, p,
                                       stream);
}

extern "C" int spirk_cheb_iter_dg(const float* d, const float* r, const float* x,
                                  const float* mdiag, const float* kdiag, float* r_out,
                                  float* d_out, float* x_out, const float* mband,
                                  const float* kband, const float* w, int q, int m, int p,
                                  void* stream) {
  return spirk::cheb_iter_entry<true>(d, r, x, mdiag, kdiag, r_out, d_out, x_out, mband,
                                      kband, w, q, m, spirk::whole_field(m), p, stream);
}

// mdiag, kdiag: the level's whole (m,) 1D diagonals
extern "C" int spirk_cheb_iter_dg_halo(const float* d, const float* r, const float* x,
                                       const float* mdiag, const float* kdiag, float* r_out,
                                       float* d_out, float* x_out, const float* mband,
                                       const float* kband, const float* w, int q, int m,
                                       int nzl, int z_off, int p, void* stream) {
  return spirk::cheb_iter_entry<true>(d, r, x, mdiag, kdiag, r_out, d_out, x_out, mband,
                                      kband, w, q, m, spirk::ZSlab{nzl, p, z_off}, p,
                                      stream);
}
