// K4: out_i = (a_i M + b K) u_i for every stage i of a (q, m, m, m) or a
// (q, m, m) block.
//
// Replaces the Pallas kernel of fused_stencil_apply_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py, _make_kernel_3d with
// canon=True and _make_kernel_3d_canon_yb; 2D _make_kernel_2d).  Same
// sum-factorised form: Zm = Mz u, Zk = Kz u; E = a Zm + b Zk, F = b Zm;
// C = My E + Ky F, D = My F; out = Mx C + Kx D.  In 2D the y pass is
// K5's (A = My u, B = Ky u) and out = a Mx A + b (Mx B + Kx A).  The TPU
// kernel holds a whole plane per grid step in VMEM; here one block owns a
// 32 x 64 tile with its p-halo (common.cuh).
//
// K9a (spirk_stencil_apply_halo) is the same kernel on one z slab of a
// space-sharded block: u is (q, nzl + 2p, m, m) with p planes of each z
// neighbour (zeros at the domain ends), out the slab's (q, nzl, m, m), the
// z band rows those of global planes z_off .. z_off + nzl (ZSlab,
// common.cuh).  It replaces sharded_stencil_apply_canon
// (dealii_spirk_tpu/ops/pallas/sharded.py), i.e. fused_stencil_apply_canon
// with halo_z=True, and equals the whole-field kernel bit for bit.
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

  Bands<P> bd = load_bands<P>(bands, mband, kband, m, zs, z0, y0, x0);
  load_tile<P>(in, u + iq * zs.in_stride(m), m, zs, z0, y0, x0);
  __syncthreads();
  shifted_zy<P>(in, E, F, C, D, bd, w[2 * iq], w[2 * iq + 1]);
#pragma unroll
  for (int s = 0; s < T::PTS; ++s) {
    int lz, ly, lx;
    out_point(s, lz, ly, lx);
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    if (gz < zs.nz && gy < m && gx < m)
      out[stage + ((long long)gz * m + gy) * m + gx] = shifted_x<P>(C, D, bd, lz, ly, lx);
  }
}

template <int P>
__global__ void __launch_bounds__(NTHREADS)
stencil_apply_2d_kernel(const float* __restrict__ u, float* __restrict__ out,
                        const float* __restrict__ mband, const float* __restrict__ kband,
                        const float* __restrict__ w, int m) {
  using T = Tile2<P>;
  extern __shared__ float smem[];
  float* in = smem;
  float* A = in + T::IN;
  float* B = A + T::YP;
  float* bands = B + T::YP;

  const int iq = blockIdx.z;
  const int y0 = blockIdx.y * TY2, x0 = blockIdx.x * TX2;
  const long long stage = (long long)iq * m * m;
  const float a = w[2 * iq], b = w[2 * iq + 1];

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
      float mu, ku;
      mass_stiff_x2<P>(A, B, bd, ly, lx, mu, ku);
      out[stage + (long long)gy * m + gx] = a * mu + b * ku;
    }
  }
}

template <int P>
cudaError_t launch_stencil_apply_2d(const float* u, float* out, const float* mband,
                                    const float* kband, const float* w, int q, int m,
                                    cudaStream_t stream) {
  const int bytes = Tile2<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(stencil_apply_2d_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  stencil_apply_2d_kernel<P><<<tile_grid2(m, q), NTHREADS, bytes, stream>>>(u, out, mband,
                                                                            kband, w, m);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_stencil_apply(const float* u, float* out, const float* mband,
                                 const float* kband, const float* w, int q, int m,
                                 ZSlab zs, cudaStream_t stream) {
  const int bytes = Tile<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(stencil_apply_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  stencil_apply_kernel<P><<<tile_grid(m, zs.nz, q), NTHREADS, bytes, stream>>>(
      u, out, mband, kband, w, m, zs);
  return cudaGetLastError();
}

int stencil_apply_entry(const float* u, float* out, const float* mband, const float* kband,
                        const float* w, int q, int m, ZSlab zs, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_stencil_apply<1>(u, out, mband, kband, w, q, m, zs, s);
    case 2: return launch_stencil_apply<2>(u, out, mband, kband, w, q, m, zs, s);
    case 3: return launch_stencil_apply<3>(u, out, mband, kband, w, q, m, zs, s);
    case 4: return launch_stencil_apply<4>(u, out, mband, kband, w, q, m, zs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace spirk

extern "C" int spirk_stencil_apply(const float* u, float* out, const float* mband,
                                   const float* kband, const float* w, int q, int m, int p,
                                   void* stream) {
  return spirk::stencil_apply_entry(u, out, mband, kband, w, q, m, spirk::whole_field(m), p,
                                    stream);
}

// u: (q, nzl + 2p, m, m), out: (q, nzl, m, m)
extern "C" int spirk_stencil_apply_halo(const float* u, float* out, const float* mband,
                                        const float* kband, const float* w, int q, int m,
                                        int nzl, int z_off, int p, void* stream) {
  return spirk::stencil_apply_entry(u, out, mband, kband, w, q, m,
                                    spirk::ZSlab{nzl, p, z_off}, p, stream);
}

extern "C" int spirk_stencil_apply_2d(const float* u, float* out, const float* mband,
                                      const float* kband, const float* w, int q, int m,
                                      int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return spirk::launch_stencil_apply_2d<1>(u, out, mband, kband, w, q, m, s);
    case 2: return spirk::launch_stencil_apply_2d<2>(u, out, mband, kband, w, q, m, s);
    case 3: return spirk::launch_stencil_apply_2d<3>(u, out, mband, kband, w, q, m, s);
    case 4: return spirk::launch_stencil_apply_2d<4>(u, out, mband, kband, w, q, m, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* spirk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
