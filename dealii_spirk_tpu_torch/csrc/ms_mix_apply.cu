// K1: out_i = sum_j Ainv[i, j] (M u_j) + tau (K u_i) for all q stages —
// the outer GMRES vmult of 3D irk_batched.
//
// Replaces the Pallas kernel of fused_ms_mix_apply_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py,
// _make_kernel_ms_mix_3d_canon_yb), whose point it keeps: u is read once
// and out written once (the unfused alternative, K5 then K2 and an add,
// moves about 3x the bytes).
//
// spirk_ms_mix_apply is the z march's Mix<TY, QA> mode (march.cuh): one block
// owns a TY x 64 (y, x) tile column of EVERY stage and marches over a chunk
// of z planes, with a cp.async ring of 2p + 2 haloed planes per stage.  Per
// plane and input stage j it runs K5's passes (MassStiff: z E = Kz u_j,
// F = Mz u_j; y C = My E + Ky F, D = My F; x K u_j = Mx C + Kx D and
// M u_j = Mx D, mass and stiffness taps summed apart) and adds
// Ainv[i, j] M u_j, and tau_j K u_j to i = j, into q sums per output point
// held in registers (QA = 4 where q <= 4, else QMAX); the sums are stored
// once every stage is in.  The q rings set the block's shared memory, so the
// tile height TY (16 or 8) is the launch plan's choice per (p, q)
// (ops/cuda/stencil.py::mix_tile); QMAX sums live in registers only on the
// 8-row tile (2 output points per thread), so above 4 stages TY is 8.  On
// the 16-row tile at p = 3 (P16's K1) the z and y passes of each stage run
// in runs (march.cuh March::RUNS), one block per SM (its four rings take
// 221,216 B), chunks from stencil.py::runs_chunk counted without q; each
// point keeps its taps, weights and order of sums, so K1 keeps its bytes.
//
// Where no tile height fits the q rings (p = 3 with q >= 7), and at p = 4
// wherever no tile lets two blocks share an SM (q >= 3: one Mix<8, 4> block
// per SM read 0.100 of its bound at q = 4), the plan routes K1 through K2
// (stage_mix.cu: v = Ainv u) and spirk_ms_mix_apply_split, the march's
// MixSplit mode: a block marches one stage with two rings, v_i and u_i; z
// pass E = Mz v_i + tau Kz u_i, F = tau Mz u_i, then Apply's y and x passes
// (the y pass at p >= 3 from registers, march.cuh March::RUNS, y_run) give
// out_i = M v_i + tau K u_i.
//
// Bound on the H100: DRAM (Mix 2 field passes per point, MixSplit 3, against
// about 60 + 2q flops per point at p = 1).
#include "march.cuh"

namespace spirk {

MarchArgs mix_args(const float* d, float* out, const float* mband, const float* kband, int m,
                   int chunk) {
  MarchArgs g{};
  g.d = d;
  g.out = out;
  g.mband = mband;
  g.kband = kband;
  g.m = m;
  g.chunk = chunk;
  g.zs = whole_field(m);
  return g;
}

// the Mix form of q stages on the ty-row tile; the arms (ARM > 0) only on
// the 16-row tile of up to 4 stages
template <int ARM = 0>
int mix_entry(const MarchArgs& g, int q, int ty, int p, void* stream) {
  if (q < 1 || q > QMAX) return cudaErrorInvalidValue;
  // the sums a thread keeps per output point: 4, or QMAX on the 8-row tile
  if (q <= 4 && ty == 16) return march_entry<Mix<16, 4>, ARM>(g, q, p, stream);
  if constexpr (ARM == 0) {
    if (q <= 4 && ty == 8) return march_entry<Mix<8, 4>>(g, q, p, stream);
    if (ty == 8) return march_entry<Mix<8, QMAX>>(g, q, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace spirk

// mw: (q + 1, q) row-major, rows 0..q-1 Ainv, row q tau per stage; ty: the
// tile height (16 or 8); chunk: z planes per block, 1..MZC
extern "C" int spirk_ms_mix_apply(const float* u, float* out, const float* mband,
                                  const float* kband, const float* mw, int q, int m, int ty,
                                  int chunk, int p, void* stream) {
  spirk::MarchArgs g = spirk::mix_args(u, out, mband, kband, m, chunk);
  g.mw = mw;
  return spirk::mix_entry(g, q, ty, p, stream);
}

// K1's diagnostic arms on the 16-row tile (march.cuh ARM; not a kernel of
// any path, and no LAUNCHES count): arm 1 the passes alone on resident
// planes, arm 2 the copies and stores alone (out = u); the arguments of
// spirk_ms_mix_apply, then arm
extern "C" int spirk_ms_mix_apply_arm(const float* u, float* out, const float* mband,
                                      const float* kband, const float* mw, int q, int m, int ty,
                                      int chunk, int p, int arm, void* stream) {
  spirk::MarchArgs g = spirk::mix_args(u, out, mband, kband, m, chunk);
  g.mw = mw;
  if (arm == spirk::PASSES) return spirk::mix_entry<spirk::PASSES>(g, q, ty, p, stream);
  if (arm == spirk::COPIES) return spirk::mix_entry<spirk::COPIES>(g, q, ty, p, stream);
  return cudaErrorInvalidValue;
}

// out_i = M v_i + tau K u_i; v, u, out: (q, m, m, m)
extern "C" int spirk_ms_mix_apply_split(const float* v, const float* u, float* out,
                                        const float* mband, const float* kband, float tau,
                                        int q, int m, int chunk, int p, void* stream) {
  spirk::MarchArgs g = spirk::mix_args(v, out, mband, kband, m, chunk);
  g.u = u;
  g.b = tau;
  return spirk::march_entry<spirk::MixSplit>(g, q, p, stream);
}
