// K4: out_i = (a_i M + b K) u_i for every stage i of a (q, m, m, m) or a
// (q, m, m) block; a (q,) by pointer, b by value, so a launch is one
// device op.
//
// Replaces the Pallas kernel of fused_stencil_apply_canon
// (dealii_spirk_tpu/ops/pallas/stencil.py, _make_kernel_3d with
// canon=True and _make_kernel_3d_canon_yb; 2D _make_kernel_2d).  Same
// sum-factorised form: Zm = Mz u, Zk = Kz u; E = a Zm + b Zk, F = b Zm;
// C = My E + Ky F, D = My F; out = Mx C + Kx D.  In 2D the y pass is
// K5's (A = My u, B = Ky u) and out = Mx (a A + b B) + b Kx A.  The TPU
// kernel holds a whole plane per grid step in VMEM (in 2D its x pass is an
// MXU product with a banded matrix).
//
// 3D: the z march's Apply mode (march.cuh): a block marches a chunk of z
// planes of one stage's (y, x) tile over a cp.async ring of haloed u planes
// and writes out, the stiffness taps summed apart from the mass taps in the
// y and x passes (out = Mx C + Kx D as two sums; the earlier tile kernel
// added them in one accumulator); at p >= 3 its passes run in runs
// (March::RUNS: the z pass over 4-point groups, the y pass over 4-row runs,
// chunks of up to 32 / 64 planes planned by stencil.py::runs_chunk); with
// z_sums and y_sums per point it reached 0.17 of its DRAM bound at p = 4
// (PERF.md).  K9a (spirk_stencil_apply_halo) is the same
// launch on one z slab of a space-sharded block: u is (q, nzl + 2p, m, m)
// with p planes of each z neighbour (zeros at the domain ends), out the
// slab's (q, nzl, m, m), the z band rows those of global planes z_off ..
// z_off + nzl (ZSlab, common.cuh).  It replaces sharded_stencil_apply_canon
// (dealii_spirk_tpu/ops/pallas/sharded.py), i.e. fused_stencil_apply_canon
// with halo_z=True, and equals the whole-field kernel bit for bit.
//
// Bound on the H100: by design DRAM (one read, one write of the block,
// ~40 flops per point at p=1).
//
// 2D (the Hopper design of K4-2D): a warp owns a strip of 64 columns of
// one stage (a lane holds one column of each of two 32-column slices) and
// walks 16 rows down y (8 on levels below m = 512, where a launch is
// latency and more, shorter tasks fill the card).  Nothing is shared
// between warps: no shared memory, no barrier.  Each lane keeps the 2p + 1
// rows of u of its columns that the y pass needs in registers and loads
// the next S2_G rows at once before any arithmetic (2 S2_G independent
// coalesced loads in flight per lane, zero outside the domain by masks,
// no integer division in the loop).  The y pass gives A = My u and
// B = Ky u of the row in registers; the x pass takes the +-p neighbours
// of S = a A + b B and of A from warp shuffles (one shuffle per slice,
// offset and field: each lane first selects the slice its reader needs)
// and forms Mx S + b Kx A, the plain version's order, with the stiffness
// taps in an accumulator of their own (mass_stiff_x2, common.cuh, says
// why).  The strip's outer p columns on each side are computed for their
// neighbours only, so a warp writes 64 - 2p columns.  The x band weights
// of a lane's columns are loaded once per task; the y band weights of a
// group of rows once, spread over the warp's lanes, and broadcast by
// shuffles.  Each input is read once from DRAM (the 2p halo rows of a task
// and the 2p halo columns of a strip come again, from L2), each output
// written once.  At P3's finest level (q=4, m=1023) it measured 0.0130 ms
// per launch on the device, 0.0165 ms L2-cold, against a 0.0100 ms DRAM
// bound (PERF.md); it takes 119 registers at p=1 (64 forced by launch
// bounds spilled and ran slower).
#include "march.cuh"

namespace spirk {

constexpr int S2_WARPS = 4;  // warps per block, each on a task of its own
constexpr int S2_G = 8;      // rows loaded at once; a task's rows are a multiple

template <int P>
struct Strip2 {
  static constexpr int NB = 2 * P + 1;
  static constexpr int K = 2;               // 32-column slices per warp
  static constexpr int W = 32 * K - 2 * P;  // output columns per warp
  static constexpr int YW = (NB * S2_G + 31) / 32;  // registers per band of a group's y weights
};

// One row of u at this lane's K columns (zero outside the domain).
template <int K>
__device__ __forceinline__ void load_row2(float (&dst)[K], const float* __restrict__ us, int m,
                                          int y, int c0, const bool (&inx)[K]) {
  const bool iny = y >= 0 && y < m;
#pragma unroll
  for (int k = 0; k < K; ++k)
    dst[k] = (iny && inx[k]) ? __ldg(us + (long long)y * m + c0 + 32 * k) : 0.f;
}

// The value at column offset d (|d| <= P < 32) of this lane's column in
// slice k: v[k] of lane + d, from slice k + 1 (k - 1) where lane + d leaves
// the warp.  Each lane offers the slice its reader needs, then one shuffle.
template <int K>
__device__ __forceinline__ float neighbour2(const float (&v)[K], int k, int d, int lane) {
  if (d == 0) return v[k];
  float offer = v[k];
  if (d > 0 && k + 1 < K && lane < d) offer = v[k + 1];
  if (d < 0 && k > 0 && lane >= 32 + d) offer = v[k - 1];
  return __shfl_sync(0xffffffffu, offer, (lane + d) & 31);
}

template <int P>
__global__ void __launch_bounds__(32 * S2_WARPS)
stencil_apply_2d_kernel(const float* __restrict__ u, float* __restrict__ out,
                        const float* __restrict__ mband, const float* __restrict__ kband,
                        const float* __restrict__ a, float b, int m, int rows, int nstrip,
                        int nseg, int ntask) {
  using S = Strip2<P>;
  constexpr int NB = S::NB, K = S::K, G = S2_G, YW = S::YW;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * S2_WARPS + (threadIdx.x >> 5);
  if (task >= ntask) return;  // the whole warp
  const int seg = task % nseg;
  const int strip = (task / nseg) % nstrip;
  const int iq = task / (nseg * nstrip);
  const float* us = u + (long long)iq * m * m;
  float* os = out + (long long)iq * m * m;
  const float av = __ldg(a + iq);
  const int c0 = strip * S::W - P + lane;  // this lane's column in slice 0

  bool inx[K], outx[K];
  float xm[K][NB], xk[K][NB];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + 32 * k, li = 32 * k + lane;
    inx[k] = c >= 0 && c < m;
    outx[k] = inx[k] && li >= P && li < 32 * K - P;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      xm[k][j] = inx[k] ? __ldg(mband + j * m + c) : 0.f;
      xk[k][j] = inx[k] ? __ldg(kband + j * m + c) : 0.f;
    }
  }

  const int y0 = seg * rows;
  const int y1 = min(m, y0 + rows);
  // rows y - P .. y + G - 1 + P of the group at y; the first 2P carry over
  float buf[2 * P + G][K];
#pragma unroll
  for (int r = 0; r < 2 * P; ++r) load_row2<K>(buf[r], us, m, y0 - P + r, c0, inx);
  for (int y = y0; y < y1; y += G) {
    // the group's y band weights spread over the warp: entry j G + g of a
    // band (tap j, row y + g) in register (j G + g) / 32 of lane (j G + g) % 32
    float wym[YW], wyk[YW];
#pragma unroll
    for (int r = 0; r < YW; ++r) {
      const int e = 32 * r + lane, j = e / G, g = e % G;
      const bool ok = e < NB * G && y + g < y1;
      wym[r] = ok ? __ldg(mband + j * m + y + g) : 0.f;
      wyk[r] = ok ? __ldg(kband + j * m + y + g) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) load_row2<K>(buf[2 * P + g], us, m, y + P + g, c0, inx);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int yy = y + g;
      float wm[NB], wk[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        wm[j] = __shfl_sync(0xffffffffu, wym[(j * G + g) / 32], (j * G + g) % 32);
        wk[j] = __shfl_sync(0xffffffffu, wyk[(j * G + g) / 32], (j * G + g) % 32);
      }
      // y pass A = My u, B = Ky u; then S = a A + b B, as the plain version
      // forms Mx (a A + b B) + b Kx A: the stiffness taps of the x pass
      // keep an accumulator of their own (see mass_stiff_x2, common.cuh)
      float A[K], Sx[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float am = 0.f, bk = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          am = fmaf(wm[j], buf[g + j][k], am);
          bk = fmaf(wk[j], buf[g + j][k], bk);
        }
        A[k] = am;
        Sx[k] = fmaf(b, bk, av * am);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float ms = 0.f, kx = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          ms = fmaf(xm[k][j], neighbour2<K>(Sx, k, j - P, lane), ms);
          kx = fmaf(xk[k][j], neighbour2<K>(A, k, j - P, lane), kx);
        }
        if (yy < y1 && outx[k]) os[(long long)yy * m + c0 + 32 * k] = fmaf(b, kx, ms);
      }
    }
#pragma unroll
    for (int r = 0; r < 2 * P; ++r)
#pragma unroll
      for (int k = 0; k < K; ++k) buf[r][k] = buf[G + r][k];
  }
}

template <int P>
cudaError_t launch_stencil_apply_2d(const float* u, float* out, const float* mband,
                                    const float* kband, const float* a, float b, int q, int m,
                                    cudaStream_t stream) {
  // 16 rows per task on large levels, 8 (one group) where the level is
  // small and a launch is latency: more, shorter tasks
  const int rows = m >= 512 ? 2 * S2_G : S2_G;
  const int nstrip = (m + Strip2<P>::W - 1) / Strip2<P>::W;
  const int nseg = (m + rows - 1) / rows;
  const long long ntask = (long long)q * nstrip * nseg;
  const long long blocks = (ntask + S2_WARPS - 1) / S2_WARPS;
  stencil_apply_2d_kernel<P><<<(unsigned)blocks, 32 * S2_WARPS, 0, stream>>>(
      u, out, mband, kband, a, b, m, rows, nstrip, nseg, (int)ntask);
  return cudaGetLastError();
}

template <int ARM = 0>
int apply_entry(const float* u, float* out, const float* mband, const float* kband,
                const float* a, float b, int q, int m, ZSlab zs, int chunk, int p,
                void* stream) {
  MarchArgs g{};
  g.d = u;
  g.out = out;
  g.mband = mband;
  g.kband = kband;
  g.a = a;
  g.b = b;
  g.m = m;
  g.chunk = chunk;
  g.zs = zs;
  return march_entry<Apply, ARM>(g, q, p, stream);
}

}  // namespace spirk

// chunk: z planes per block, 1..MZC
extern "C" int spirk_stencil_apply(const float* u, float* out, const float* mband,
                                   const float* kband, const float* a, float b, int q, int m,
                                   int chunk, int p, void* stream) {
  return spirk::apply_entry(u, out, mband, kband, a, b, q, m, spirk::whole_field(m), chunk, p,
                            stream);
}

// u: (q, nzl + 2p, m, m), out: (q, nzl, m, m)
extern "C" int spirk_stencil_apply_halo(const float* u, float* out, const float* mband,
                                        const float* kband, const float* a, float b, int q,
                                        int m, int nzl, int z_off, int chunk, int p,
                                        void* stream) {
  return spirk::apply_entry(u, out, mband, kband, a, b, q, m, spirk::ZSlab{nzl, p, z_off},
                            chunk, p, stream);
}

// K4's diagnostic arms (march.cuh ARM; not a kernel of any path, and no
// LAUNCHES count): arm 1 the passes alone on resident planes, arm 2 the
// copies and stores alone (out = u); the arguments of spirk_stencil_apply,
// then arm
extern "C" int spirk_stencil_apply_arm(const float* u, float* out, const float* mband,
                                       const float* kband, const float* a, float b, int q,
                                       int m, int chunk, int p, int arm, void* stream) {
  const spirk::ZSlab zs = spirk::whole_field(m);
  if (arm == spirk::PASSES)
    return spirk::apply_entry<spirk::PASSES>(u, out, mband, kband, a, b, q, m, zs, chunk, p,
                                             stream);
  if (arm == spirk::COPIES)
    return spirk::apply_entry<spirk::COPIES>(u, out, mband, kband, a, b, q, m, zs, chunk, p,
                                             stream);
  return cudaErrorInvalidValue;
}

extern "C" int spirk_stencil_apply_2d(const float* u, float* out, const float* mband,
                                      const float* kband, const float* a, float b, int q, int m,
                                      int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return spirk::launch_stencil_apply_2d<1>(u, out, mband, kband, a, b, q, m, s);
    case 2: return spirk::launch_stencil_apply_2d<2>(u, out, mband, kband, a, b, q, m, s);
    case 3: return spirk::launch_stencil_apply_2d<3>(u, out, mband, kband, a, b, q, m, s);
    case 4: return spirk::launch_stencil_apply_2d<4>(u, out, mband, kband, a, b, q, m, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* spirk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
