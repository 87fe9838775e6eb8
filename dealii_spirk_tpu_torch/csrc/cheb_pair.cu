// K8: two Chebyshev smoother steps per stage i of a (q, m, m, m) block in one
// pass, the Jacobi diagonal rebuilt per point from the level's 1D diagonals
// as in K3dg:
//   r1 = r - (a_i M + b K) d;    d1 = c1a_i d + c2a_i r1 / diag;
//   r2 = r1 - (a_i M + b K) d1;  d2 = c1b_i d1 + c2b_i r2 / diag;
//   x2 = x + d1 + d2;  returns (r2, d2, x2).
// It replaces fused_cheb_pair_canon (dealii_spirk_tpu/ops/pallas/stencil.py,
// _fused_cheb2_canon and its body _make_kernel_cheb2_3d_canon_yb).  The TPU
// kernel's y blocking and aligned 24-row loads size it to VMEM and are not
// carried over.
//
// The kernel is the z march's pair form (march.cuh, pair_march): stage 1 on
// the tile grown by p over a ring of 2p-haloed d planes, stage 2 p planes
// behind it over a ring of the grown d1 planes (zero outside the domain),
// both with K3dg's sums in K3dg's order, so one K8 launch gives what two
// K3dg launches give.  Bound on the H100: DRAM — 6 field passes (d, r, x in;
// r2, d2, x2 out) for two steps, against 12 for two K3dg launches; stage 1's
// recompute (the grown tile, 2p more planes per chunk) stays under the
// byte bound (chip_smoke.py::bound).  At P4's 255 level (q=6, m=255) it
// measured 1.72 ms per launch on the device against 2.13 ms for two K3dg
// launches and a 0.71 ms bound: the passes, not the bytes, hold it there
// (8-row tiles with 3-4 blocks per SM ran slower; PERF.md).
#include "march.cuh"

// d, r, x and the three outputs (q, m, m, m); mdiag, kdiag the level's (m,)
// 1D diagonals; a, c1a, c2a, c1b, c2b (q,); ty: the tile height
// (ops/cuda/stencil.py::pair_tile); chunk: z planes per block, 1..PAIR_MZC
extern "C" int spirk_cheb_pair_dg(const float* d, const float* r, const float* x,
                                  const float* mdiag, const float* kdiag, float* r_out,
                                  float* d_out, float* x_out, const float* mband,
                                  const float* kband, const float* a, float b, const float* c1a,
                                  const float* c2a, const float* c1b, const float* c2b, int q,
                                  int m, int ty, int chunk, int p, void* stream) {
  spirk::PairArgs g{d,     r,    x,    mdiag, kdiag, r_out, d_out, x_out, mband,
                    kband, a,    c1a,  c2a,   c1b,   c2b,   b,     m,     chunk};
  return spirk::pair_entry(g, q, ty, p, stream);
}
