// K5: (M u_i, K u_i) for every stage i of a (q, m, m, m) or (q, m, m)
// block, from one read of u — the outer vmult of the sequential `irk`
// scheme, of the complex schemes and of 2D `irk_batched` (the stage mix and
// + tau K u follow as K2 and one elementwise pass).
//
// Replaces the Pallas kernels of fused_mass_stiffness_apply_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py, _make_kernel_ms_3d with
// canon=True, _make_kernel_ms_3d_canon_yb, _make_kernel_ms_2d) and of
// fused_mass_stiffness_apply (_make_kernel_ms_3d_yb and the 2D kernel on
// the compact layout): the port keeps one compact layout, so one kernel
// stands for both families.
//
// 3D: the z march's MassStiff mode (march.cuh): a block marches a chunk of
// z planes of one stage's 16 x 64 (y, x) tile over a cp.async ring of
// haloed u planes; z pass E = Kz u, F = Mz u; y pass C = My E + Ky F,
// D = My F; x pass K u = Mx C + Kx D and M u = Mx D, each sum of mass taps
// apart from the stiffness taps' (the earlier tile kernel added
// My Zk + Ky Zm and Mx Ck + Kx Cm in one accumulator each).  At p >= 3 the
// z and y passes run in runs (march.cuh March::RUNS: 4-point groups, 4-row
// runs from registers, chunks of up to 32 / 64 planes from
// ops/cuda/stencil.py::runs_chunk), as Apply's do; each point keeps its
// taps, weights and order of sums, so K5 keeps its bytes.  Bound on the
// H100: DRAM (one field read, two written, about 60 flops per point at
// p = 1).
//
// K9b (spirk_mass_stiffness_apply_halo) is the same launch on one z slab of
// a space-sharded block (ZSlab, common.cuh): u (q, nzl + 2p, m, m) with p
// planes of each z neighbour, outputs (q, nzl, m, m).  It replaces
// sharded_mass_stiffness_apply_canon (dealii_spirk_tpu/ops/pallas/sharded.py:
// fused_mass_stiffness_apply_canon with halo_z=True) and equals the
// whole-field kernel bit for bit.
//
// 2D (the tile kernel of common.cuh): A = My u, B = Ky u; M u = Mx A,
// K u = Mx B + Kx A, the stiffness taps in an accumulator of their own
// (mass_stiff_x2).
#include "march.cuh"

namespace spirk {

template <int P>
__global__ void __launch_bounds__(NTHREADS)
mass_stiffness_2d_kernel(const float* __restrict__ u, float* __restrict__ mu_out,
                         float* __restrict__ ku_out, const float* __restrict__ mband,
                         const float* __restrict__ kband, int m) {
  using T = Tile2<P>;
  extern __shared__ float smem[];
  float* in = smem;
  float* A = in + T::IN;
  float* B = A + T::YP;
  float* bands = B + T::YP;

  const int iq = blockIdx.z;
  const int y0 = blockIdx.y * TY2, x0 = blockIdx.x * TX2;
  const long long stage = (long long)iq * m * m;

  Bands2<P> bd = load_bands2<P>(bands, mband, kband, m, y0, x0);
  load_tile2<P>(in, u + stage, m, y0, x0);
  __syncthreads();
  mass_stiff_y2<P>(in, A, B, bd);
#pragma unroll
  for (int s = 0; s < T::PTS; ++s) {
    int ly, lx;
    out_point2(s, ly, lx);
    int gy = y0 + ly, gx = x0 + lx;
    if (gy < m && gx < m) {
      long long g = stage + (long long)gy * m + gx;
      float mu, ku;
      mass_stiff_x2<P>(A, B, bd, ly, lx, mu, ku);
      mu_out[g] = mu;
      ku_out[g] = ku;
    }
  }
}

template <int ARM = 0>
int mass_stiffness_entry(const float* u, float* mu, float* ku, const float* mband,
                         const float* kband, int q, int m, ZSlab zs, int chunk, int p,
                         void* stream) {
  MarchArgs g{};
  g.d = u;
  g.out = mu;
  g.d_out = ku;
  g.mband = mband;
  g.kband = kband;
  g.m = m;
  g.chunk = chunk;
  g.zs = zs;
  return march_entry<MassStiff, ARM>(g, q, p, stream);
}

template <int P>
cudaError_t launch_mass_stiffness_2d(const float* u, float* mu, float* ku,
                                     const float* mband, const float* kband, int q, int m,
                                     cudaStream_t stream) {
  const int bytes = Tile2<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(mass_stiffness_2d_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  mass_stiffness_2d_kernel<P><<<tile_grid2(m, q), NTHREADS, bytes, stream>>>(u, mu, ku, mband,
                                                                             kband, m);
  return cudaGetLastError();
}

}  // namespace spirk

// chunk: z planes per block, 1..MZC
extern "C" int spirk_mass_stiffness_apply(const float* u, float* mu, float* ku,
                                          const float* mband, const float* kband, int q,
                                          int m, int chunk, int p, void* stream) {
  return spirk::mass_stiffness_entry(u, mu, ku, mband, kband, q, m, spirk::whole_field(m),
                                     chunk, p, stream);
}

// u: (q, nzl + 2p, m, m), mu and ku: (q, nzl, m, m)
extern "C" int spirk_mass_stiffness_apply_halo(const float* u, float* mu, float* ku,
                                               const float* mband, const float* kband,
                                               int q, int m, int nzl, int z_off, int chunk,
                                               int p, void* stream) {
  return spirk::mass_stiffness_entry(u, mu, ku, mband, kband, q, m,
                                     spirk::ZSlab{nzl, p, z_off}, chunk, p, stream);
}

// K5's diagnostic arms (march.cuh ARM; not a kernel of any path, and no
// LAUNCHES count): arm 1 the passes alone on resident planes, arm 2 the
// copies and stores alone (M u = K u = u); the arguments of
// spirk_mass_stiffness_apply, then arm
extern "C" int spirk_mass_stiffness_apply_arm(const float* u, float* mu, float* ku,
                                              const float* mband, const float* kband, int q,
                                              int m, int chunk, int p, int arm, void* stream) {
  const spirk::ZSlab zs = spirk::whole_field(m);
  if (arm == spirk::PASSES)
    return spirk::mass_stiffness_entry<spirk::PASSES>(u, mu, ku, mband, kband, q, m, zs, chunk,
                                                      p, stream);
  if (arm == spirk::COPIES)
    return spirk::mass_stiffness_entry<spirk::COPIES>(u, mu, ku, mband, kband, q, m, zs, chunk,
                                                      p, stream);
  return cudaErrorInvalidValue;
}

extern "C" int spirk_mass_stiffness_apply_2d(const float* u, float* mu, float* ku,
                                             const float* mband, const float* kband, int q,
                                             int m, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return spirk::launch_mass_stiffness_2d<1>(u, mu, ku, mband, kband, q, m, s);
    case 2: return spirk::launch_mass_stiffness_2d<2>(u, mu, ku, mband, kband, q, m, s);
    case 3: return spirk::launch_mass_stiffness_2d<3>(u, mu, ku, mband, kband, q, m, s);
    case 4: return spirk::launch_mass_stiffness_2d<4>(u, mu, ku, mband, kband, q, m, s);
    default: return cudaErrorInvalidValue;
  }
}
