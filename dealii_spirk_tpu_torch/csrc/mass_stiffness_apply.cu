// K5: (M u_i, K u_i) for every stage i of a (q, m, m, m) or (q, m, m)
// block, from one read of u — the outer vmult of the sequential `irk`
// scheme and of 2D `irk_batched` (the stage mix and + tau K u follow as K2
// and one elementwise pass).
//
// Replaces the Pallas kernels of fused_mass_stiffness_apply_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py, _make_kernel_ms_3d with
// canon=True, _make_kernel_ms_3d_canon_yb, _make_kernel_ms_2d) and of
// fused_mass_stiffness_apply (_make_kernel_ms_3d_yb and the 2D kernel on
// the compact layout): the port keeps one compact layout, so one kernel
// stands for both families.  3D is K4's tile (common.cuh) with the shared
// intermediates of K1: Zm = Mz u, Zk = Kz u; Cm = My Zm,
// Ck = My Zk + Ky Zm; M u = Mx Cm, K u = Mx Ck + Kx Cm.  2D: A = My u,
// B = Ky u; M u = Mx A, K u = Mx B + Kx A.
//
// K9b (spirk_mass_stiffness_apply_halo) is the 3D kernel on one z slab of a
// space-sharded block (ZSlab, common.cuh): u (q, nzl + 2p, m, m) with p
// planes of each z neighbour, outputs (q, nzl, m, m).  It replaces
// sharded_mass_stiffness_apply_canon (dealii_spirk_tpu/ops/pallas/sharded.py:
// fused_mass_stiffness_apply_canon with halo_z=True) and equals the
// whole-field kernel bit for bit.
//
// Bound on the H100: by design DRAM (one field read, two written, about
// 60 flops per point at p=1).  Two outputs per point are computed and
// stored at once, so the register state is K4's plus one float.
#include "common.cuh"

namespace spirk {

template <int P>
__global__ void __launch_bounds__(NTHREADS)
mass_stiffness_kernel(const float* __restrict__ u, float* __restrict__ mu_out,
                      float* __restrict__ ku_out, const float* __restrict__ mband,
                      const float* __restrict__ kband, int m, ZSlab zs) {
  using T = Tile<P>;
  extern __shared__ float smem[];
  float* in = smem;
  float* Zm = in + T::IN;
  float* Zk = Zm + T::ZP;
  float* Cm = Zk + T::ZP;
  float* Ck = Cm + T::YP;
  float* bands = Ck + T::YP;

  const int nzt = (zs.nz + TZ - 1) / TZ;
  const int iq = blockIdx.z / nzt;
  const int z0 = (blockIdx.z % nzt) * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const long long stage = iq * zs.out_stride(m);

  Bands<P> bd = load_bands<P>(bands, mband, kband, m, zs, z0, y0, x0);
  load_tile<P>(in, u + iq * zs.in_stride(m), m, zs, z0, y0, x0);
  __syncthreads();
  mass_stiff_zy<P>(in, Zm, Zk, Cm, Ck, bd);
#pragma unroll
  for (int s = 0; s < T::PTS; ++s) {
    int lz, ly, lx;
    out_point(s, lz, ly, lx);
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    if (gz < zs.nz && gy < m && gx < m) {
      long long g = stage + ((long long)gz * m + gy) * m + gx;
      float mu, ku;
      mass_stiff_x<P>(Cm, Ck, bd, lz, ly, lx, mu, ku);
      mu_out[g] = mu;
      ku_out[g] = ku;
    }
  }
}

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

template <int P>
cudaError_t launch_mass_stiffness(const float* u, float* mu, float* ku, const float* mband,
                                  const float* kband, int q, int m, ZSlab zs,
                                  cudaStream_t stream) {
  const int bytes = Tile<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(mass_stiffness_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  mass_stiffness_kernel<P><<<tile_grid(m, zs.nz, q), NTHREADS, bytes, stream>>>(
      u, mu, ku, mband, kband, m, zs);
  return cudaGetLastError();
}

int mass_stiffness_entry(const float* u, float* mu, float* ku, const float* mband,
                         const float* kband, int q, int m, ZSlab zs, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_mass_stiffness<1>(u, mu, ku, mband, kband, q, m, zs, s);
    case 2: return launch_mass_stiffness<2>(u, mu, ku, mband, kband, q, m, zs, s);
    case 3: return launch_mass_stiffness<3>(u, mu, ku, mband, kband, q, m, zs, s);
    case 4: return launch_mass_stiffness<4>(u, mu, ku, mband, kband, q, m, zs, s);
    default: return cudaErrorInvalidValue;
  }
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

extern "C" int spirk_mass_stiffness_apply(const float* u, float* mu, float* ku,
                                          const float* mband, const float* kband, int q,
                                          int m, int p, void* stream) {
  return spirk::mass_stiffness_entry(u, mu, ku, mband, kband, q, m, spirk::whole_field(m), p,
                                     stream);
}

// u: (q, nzl + 2p, m, m), mu and ku: (q, nzl, m, m)
extern "C" int spirk_mass_stiffness_apply_halo(const float* u, float* mu, float* ku,
                                               const float* mband, const float* kband,
                                               int q, int m, int nzl, int z_off, int p,
                                               void* stream) {
  return spirk::mass_stiffness_entry(u, mu, ku, mband, kband, q, m,
                                     spirk::ZSlab{nzl, p, z_off}, p, stream);
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
