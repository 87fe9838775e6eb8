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
// K9c / K9d (spirk_cheb_iter_halo, spirk_cheb_iter_dg_halo) are K3 / K3dg on
// one z slab of a space-sharded block (ZSlab, common.cuh): only d, the
// operand of the apply, is (q, nzl + 2p, m, m) with p planes of each z
// neighbour; r, x, D^-1 and the three outputs are the slab's (q, nzl, m, m),
// and K9d reads the 1D diagonals at the slab's global rows z_off + k.  They
// replace sharded_cheb_iter_canon (dealii_spirk_tpu/ops/pallas/sharded.py:
// fused_cheb_iter_canon with halo_z=True, with and without diag_tables) and
// equal the whole-field kernels bit for bit.
//
// All four are the z march (march.cuh): K3 and K9c its ChebInvd mode, which
// copies r, x and D^-1 of a plane into per-thread slots beside the ring of d
// planes, K3dg and K9d its ChebDiag mode (the arithmetic of the first z
// march, cheb_dg_march, bit for bit).  Bound on the H100: DRAM.  K3dg moves 6 field passes per point
// (d, r, x in; r', d', x' out; the 1D factors are 2m floats, served from
// L1/L2), K3 7 (D^-1 too), against about 60 flops per point at p = 1.
#include "march.cuh"

namespace spirk {

// d: the operand; r, x: the step's fields; invd: D^-1 (K3, K9c) or null;
// mdiag, kdiag: the level's 1D diagonals (K3dg, K9d) or null
template <class Mode, int ARM = 0>
int cheb_entry(const float* d, const float* r, const float* x, const float* invd,
               const float* mdiag, const float* kdiag, float* r_out, float* d_out,
               float* x_out, const float* mband, const float* kband, const float* a, float b,
               const float* c1, const float* c2, int q, int m, ZSlab zs, int chunk,
               int p, void* stream) {
  MarchArgs g{};
  g.d = d;
  g.r = r;
  g.x = x;
  g.invd = invd;
  g.mdiag = mdiag;
  g.kdiag = kdiag;
  g.out = r_out;
  g.d_out = d_out;
  g.x_out = x_out;
  g.mband = mband;
  g.kband = kband;
  g.a = a;
  g.c1 = c1;
  g.c2 = c2;
  g.b = b;
  g.m = m;
  g.chunk = chunk;
  g.zs = zs;
  return march_entry<Mode, ARM>(g, q, p, stream);
}

}  // namespace spirk

// a, c1, c2: (q,); chunk: z planes per block, 1..MZC
extern "C" int spirk_cheb_iter(const float* d, const float* r, const float* x,
                               const float* invd, float* r_out, float* d_out, float* x_out,
                               const float* mband, const float* kband, const float* a, float b,
                               const float* c1, const float* c2, int q, int m, int chunk,
                               int p, void* stream) {
  return spirk::cheb_entry<spirk::ChebInvd>(d, r, x, invd, nullptr, nullptr, r_out, d_out,
                                            x_out, mband, kband, a, b, c1, c2, q, m,
                                            spirk::whole_field(m), chunk, p, stream);
}

// d: (q, nzl + 2p, m, m); every other field (q, nzl, m, m)
extern "C" int spirk_cheb_iter_halo(const float* d, const float* r, const float* x,
                                    const float* invd, float* r_out, float* d_out,
                                    float* x_out, const float* mband, const float* kband,
                                    const float* a, float b, const float* c1, const float* c2,
                                    int q, int m, int nzl, int z_off, int chunk, int p,
                                    void* stream) {
  return spirk::cheb_entry<spirk::ChebInvd>(d, r, x, invd, nullptr, nullptr, r_out, d_out,
                                            x_out, mband, kband, a, b, c1, c2, q, m,
                                            spirk::ZSlab{nzl, p, z_off}, chunk, p, stream);
}

extern "C" int spirk_cheb_iter_dg(const float* d, const float* r, const float* x,
                                  const float* mdiag, const float* kdiag, float* r_out,
                                  float* d_out, float* x_out, const float* mband,
                                  const float* kband, const float* a, float b, const float* c1,
                                  const float* c2, int q, int m, int chunk, int p,
                                  void* stream) {
  return spirk::cheb_entry<spirk::ChebDiag>(d, r, x, nullptr, mdiag, kdiag, r_out, d_out,
                                            x_out, mband, kband, a, b, c1, c2, q, m,
                                            spirk::whole_field(m), chunk, p, stream);
}

// mdiag, kdiag: the level's whole (m,) 1D diagonals
extern "C" int spirk_cheb_iter_dg_halo(const float* d, const float* r, const float* x,
                                       const float* mdiag, const float* kdiag, float* r_out,
                                       float* d_out, float* x_out, const float* mband,
                                       const float* kband, const float* a, float b,
                                       const float* c1, const float* c2, int q, int m, int nzl,
                                       int z_off, int chunk, int p, void* stream) {
  return spirk::cheb_entry<spirk::ChebDiag>(d, r, x, nullptr, mdiag, kdiag, r_out, d_out,
                                            x_out, mband, kband, a, b, c1, c2, q, m,
                                            spirk::ZSlab{nzl, p, z_off}, chunk, p, stream);
}

// K3's and K3dg's diagnostic arms (march.cuh ARM; not a kernel of any path,
// and no LAUNCHES count): arm 1 the passes alone on resident planes, arm 2
// the copies and stores alone; the arguments of spirk_cheb_iter (K3) or
// spirk_cheb_iter_dg (K3dg), then arm
template <class Mode>
int cheb_arm(const float* d, const float* r, const float* x, const float* invd,
             const float* mdiag, const float* kdiag, float* r_out, float* d_out, float* x_out,
             const float* mband, const float* kband, const float* a, float b, const float* c1,
             const float* c2, int q, int m, int chunk, int p, int arm, void* stream) {
  const spirk::ZSlab zs = spirk::whole_field(m);
  if (arm == spirk::PASSES)
    return spirk::cheb_entry<Mode, spirk::PASSES>(d, r, x, invd, mdiag, kdiag, r_out, d_out,
                                                  x_out, mband, kband, a, b, c1, c2, q, m, zs,
                                                  chunk, p, stream);
  if (arm == spirk::COPIES)
    return spirk::cheb_entry<Mode, spirk::COPIES>(d, r, x, invd, mdiag, kdiag, r_out, d_out,
                                                  x_out, mband, kband, a, b, c1, c2, q, m, zs,
                                                  chunk, p, stream);
  return cudaErrorInvalidValue;
}

extern "C" int spirk_cheb_iter_arm(const float* d, const float* r, const float* x,
                                   const float* invd, float* r_out, float* d_out, float* x_out,
                                   const float* mband, const float* kband, const float* a,
                                   float b, const float* c1, const float* c2, int q, int m,
                                   int chunk, int p, int arm, void* stream) {
  return cheb_arm<spirk::ChebInvd>(d, r, x, invd, nullptr, nullptr, r_out, d_out, x_out, mband,
                                   kband, a, b, c1, c2, q, m, chunk, p, arm, stream);
}

extern "C" int spirk_cheb_iter_dg_arm(const float* d, const float* r, const float* x,
                                      const float* mdiag, const float* kdiag, float* r_out,
                                      float* d_out, float* x_out, const float* mband,
                                      const float* kband, const float* a, float b,
                                      const float* c1, const float* c2, int q, int m,
                                      int chunk, int p, int arm, void* stream) {
  return cheb_arm<spirk::ChebDiag>(d, r, x, nullptr, mdiag, kdiag, r_out, d_out, x_out, mband,
                                   kband, a, b, c1, c2, q, m, chunk, p, arm, stream);
}
