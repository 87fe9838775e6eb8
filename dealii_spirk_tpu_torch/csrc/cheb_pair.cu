// K8: two Chebyshev smoother steps per stage i of a (q, m, m, m) block in one
// pass, the Jacobi diagonal rebuilt per point from the level's 1D diagonals
// as in K3dg:
//   r1 = r - (a_i M + b K) d;    d1 = c1a_i d + c2a_i r1 / diag;
//   r2 = r1 - (a_i M + b K) d1;  d2 = c1b_i d1 + c2b_i r2 / diag;
//   x2 = x + d1 + d2;  returns (r2, d2, x2).
// It replaces fused_cheb_pair_canon (dealii_spirk_tpu/ops/pallas/stencil.py,
// _fused_cheb2_canon and its body _make_kernel_cheb2_3d_canon_yb).
//
// Design (temporal blocking): one block owns one (stage, output tile).  It
// stages d with a 2p halo and r with a p halo in shared memory (zeros
// outside [0, m)^3), runs stage 1 on the tile grown by p on every side and
// sets r1 and d1 to exactly zero at every grown point outside the domain,
// so stage 2's taps read zeros there (the Pallas kernel gets the same from
// the zero rows of its pair tables).  After a block-wide barrier stage 2
// runs on the core tile and writes r2, d2 and x2 once.  The TPU kernel's
// y blocking and aligned 24-row loads size it to VMEM and are not carried
// over.  The sum-factorised passes are K3dg's (march.cuh), in the tile
// kernels' summation order (pair_zy), so two K3dg launches and one K8
// launch agree to f32 round-off.
//
// Shared memory: d's 2p-haloed tile, r's p-haloed grown tile, the stage-1
// z-pass and y-pass fields over the grown tile, and the band rows; stage 2
// reuses the dead stage-1 buffers.  That outgrows the 48 KB static limit
// at p = 1 (99 KB) and, at K3's 8 x 8 x 32 tile, the 227 KB a block can
// have at p = 3 and 4, so the tile shrinks with p (PairTile) and a
// (p, tile) that does not fit is refused at compile time and, against the
// device's opt-in limit, at launch (cudaErrorInvalidConfiguration).
//
// Bound on the H100: DRAM — 6 field passes (d, r, x in; r2, d2, x2 out)
// for two steps, against 12 for two K3dg launches; stage 1's recompute on
// the grown tile adds about two thirds of a step's arithmetic at p = 1,
// which stays under the byte bound (chip_smoke.py::bound).
#include "common.cuh"

namespace spirk {

template <int P>
struct PairTile;
template <>
struct PairTile<1> { static constexpr int Z = 8, Y = 8, X = 32; };
template <>
struct PairTile<2> { static constexpr int Z = 8, Y = 8, X = 32; };
template <>
struct PairTile<3> { static constexpr int Z = 4, Y = 8, X = 32; };
template <>
struct PairTile<4> { static constexpr int Z = 4, Y = 8, X = 16; };

constexpr int MAX_SMEM_BYTES = 232448;  // 227 KB, the H100's per-block opt-in limit

template <int P>
struct Pair {
  static constexpr int NB = 2 * P + 1;
  static constexpr int Z = PairTile<P>::Z, Y = PairTile<P>::Y, X = PairTile<P>::X;
  static constexpr int GZ = Z + 2 * P, GY = Y + 2 * P, GX = X + 2 * P;  // grown tile
  static constexpr int DZ = Z + 4 * P, DY = Y + 4 * P, DX = X + 4 * P;  // d's operand
  static constexpr int DIN = DZ * DY * DX;
  static constexpr int G = GZ * GY * GX;
  static constexpr int E1 = GZ * DY * DX;  // one stage-1 field after the z pass
  static constexpr int C1 = GZ * GY * DX;  // one stage-1 field after the y pass
  static constexpr int BANDS = 2 * NB * (GZ + GY + GX);
  static constexpr int FLOATS = DIN + G + 2 * E1 + 2 * C1 + BANDS;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
  static_assert(BYTES <= MAX_SMEM_BYTES, "the pair tile does not fit one block's shared memory");
  // stage 2 reuses stage-1 buffers: d1 in E1's, its z pass in F1's and d's,
  // its y pass in C1's and D1's
  static_assert(G <= E1 && Z * GY * GX <= E1 && Z * GY * GX <= DIN && Z * Y * GX <= C1,
                "stage-2 fields must fit the stage-1 buffers they reuse");
};

// Band weights [which(0=mass,1=stiff)][k][row] of n rows from global row g0
// on (rows outside [0, m) weigh zero).
template <int NB>
__device__ inline void load_rows(float* dst, const float* __restrict__ mband,
                                 const float* __restrict__ kband, int m, int g0, int n) {
  for (int i = threadIdx.x; i < 2 * NB * n; i += NTHREADS) {
    int r = i % n;
    int k = (i / n) % NB;
    int which = i / (n * NB);
    int g = g0 + r;
    const float* band = which ? kband : mband;
    dst[i] = (g >= 0 && g < m) ? band[k * m + g] : 0.f;
  }
}

// An nz x ny x nx box of one stage field from global point (z0, y0, x0) on,
// zero outside the domain.
__device__ inline void load_box(float* dst, const float* __restrict__ u, int m, int z0, int y0,
                                int x0, int nz, int ny, int nx) {
  for (int i = threadIdx.x; i < nz * ny * nx; i += NTHREADS) {
    int lx = i % nx;
    int t = i / nx;
    int ly = t % ny;
    int lz = t / ny;
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    float v = 0.f;
    if (gz >= 0 && gz < m && gy >= 0 && gy < m && gx >= 0 && gx < m)
      v = __ldg(u + ((long long)gz * m + gy) * m + gx);
    dst[i] = v;
  }
}

// z and y passes of (a M + b K) from an (OZ+2P) x (OY+2P) x (OX+2P) operand
// to OZ x OY x OX outputs, in the tile kernels' order (one accumulator for
// the y pass's mass and stiffness taps; the march sums them apart,
// march.cuh): E = a Zm + b Zk, F = b Zm over OZ x (OY+2P) x (OX+2P);
// C = My E + Ky F, D = My F over OZ x OY x (OX+2P).  Output row oz takes
// band row off + oz of the grown tile's tables (GZ, GY rows each).
template <int P, int OZ, int OY, int OX>
__device__ inline void pair_zy(const float* in, float* E, float* F, float* C, float* D,
                               const float* bz, const float* by, int off, float a, float b) {
  using S = Pair<P>;
  constexpr int IY = OY + 2 * P, IX = OX + 2 * P;
  for (int i = threadIdx.x; i < OZ * IY * IX; i += NTHREADS) {
    int ix = i % IX;
    int t = i / IX;
    int iy = t % IY;
    int oz = t / IY;
    float zm = 0.f, zk = 0.f;
#pragma unroll
    for (int k = 0; k < S::NB; ++k) {
      float v = in[((oz + k) * IY + iy) * IX + ix];
      zm += bz[k * S::GZ + off + oz] * v;
      zk += bz[(S::NB + k) * S::GZ + off + oz] * v;
    }
    E[i] = a * zm + b * zk;
    F[i] = b * zm;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < OZ * OY * IX; i += NTHREADS) {
    int ix = i % IX;
    int t = i / IX;
    int oy = t % OY;
    int oz = t / OY;
    float c = 0.f, d = 0.f;
#pragma unroll
    for (int k = 0; k < S::NB; ++k) {
      int j = (oz * IY + oy + k) * IX + ix;
      float e = E[j], f = F[j];
      float wm = by[k * S::GY + off + oy], wk = by[(S::NB + k) * S::GY + off + oy];
      c += wm * e + wk * f;
      d += wm * f;
    }
    C[i] = c;
    D[i] = d;
  }
  __syncthreads();
}

// x pass at output (oz, oy, ox): Mx C + Kx D.
template <int P, int OY, int OX>
__device__ inline float pair_x(const float* C, const float* D, const float* bx, int off, int oz,
                               int oy, int ox) {
  using S = Pair<P>;
  constexpr int IX = OX + 2 * P;
  float out = 0.f;
  int base = (oz * OY + oy) * IX + ox;
#pragma unroll
  for (int k = 0; k < S::NB; ++k)
    out += bx[k * S::GX + off + ox] * C[base + k] + bx[(S::NB + k) * S::GX + off + ox] * D[base + k];
  return out;
}

// K3dg's Jacobi diagonal at a global point.
__device__ inline float pair_diag(const float* __restrict__ md, const float* __restrict__ kd,
                                  float a, float b, int gz, int gy, int gx) {
  float zm = __ldg(md + gz), zk = __ldg(kd + gz);
  float ym = __ldg(md + gy), yk = __ldg(kd + gy);
  float xm = __ldg(md + gx), xk = __ldg(kd + gx);
  float zmym = zm * ym;
  return (a * zmym + b * (zk * ym + zm * yk)) * xm + (b * zmym) * xk;
}

// w: (q, 6) per-stage [a, b, c1a, c2a, c1b, c2b].
template <int P>
__global__ void __launch_bounds__(NTHREADS)
cheb_pair_kernel(const float* __restrict__ d, const float* __restrict__ r,
                 const float* __restrict__ x, const float* __restrict__ mdiag,
                 const float* __restrict__ kdiag, float* __restrict__ r_out,
                 float* __restrict__ d_out, float* __restrict__ x_out,
                 const float* __restrict__ mband, const float* __restrict__ kband,
                 const float* __restrict__ w, int m) {
  using S = Pair<P>;
  extern __shared__ float smem[];
  float* din = smem;          // d, 2p halo; stage 2: F of the z pass
  float* rr = din + S::DIN;   // r on the grown tile; r1 in place
  float* e1 = rr + S::G;      // stage-1 E; then d1 on the grown tile
  float* f1 = e1 + S::E1;     // stage-1 F; stage 2: E of the z pass
  float* c1 = f1 + S::E1;     // stage-1 C; stage 2: C
  float* dd = c1 + S::C1;     // stage-1 D; stage 2: D
  float* bz = dd + S::C1;     // band rows of the grown tile
  float* by = bz + 2 * S::NB * S::GZ;
  float* bx = by + 2 * S::NB * S::GY;

  const int nzt = (m + S::Z - 1) / S::Z;
  const int iq = blockIdx.z / nzt;
  const int z0 = (blockIdx.z % nzt) * S::Z, y0 = blockIdx.y * S::Y, x0 = blockIdx.x * S::X;
  const long long stage = (long long)iq * m * m * m;
  const float a = w[6 * iq], b = w[6 * iq + 1];
  const float c1a = w[6 * iq + 2], c2a = w[6 * iq + 3];
  const float c1b = w[6 * iq + 4], c2b = w[6 * iq + 5];

  load_rows<S::NB>(bz, mband, kband, m, z0 - P, S::GZ);
  load_rows<S::NB>(by, mband, kband, m, y0 - P, S::GY);
  load_rows<S::NB>(bx, mband, kband, m, x0 - P, S::GX);
  load_box(din, d + stage, m, z0 - 2 * P, y0 - 2 * P, x0 - 2 * P, S::DZ, S::DY, S::DX);
  load_box(rr, r + stage, m, z0 - P, y0 - P, x0 - P, S::GZ, S::GY, S::GX);
  __syncthreads();

  // stage 1 on the grown tile; exact zeros outside the domain
  pair_zy<P, S::GZ, S::GY, S::GX>(din, e1, f1, c1, dd, bz, by, 0, a, b);
  for (int i = threadIdx.x; i < S::G; i += NTHREADS) {
    int gx = i % S::GX;
    int t = i / S::GX;
    int gy = t % S::GY;
    int gz = t / S::GY;
    int Zg = z0 - P + gz, Yg = y0 - P + gy, Xg = x0 - P + gx;
    float r1 = 0.f, d1 = 0.f;
    if (Zg >= 0 && Zg < m && Yg >= 0 && Yg < m && Xg >= 0 && Xg < m) {
      r1 = rr[i] - pair_x<P, S::GY, S::GX>(c1, dd, bx, 0, gz, gy, gx);
      float z = r1 / pair_diag(mdiag, kdiag, a, b, Zg, Yg, Xg);
      float dc = din[((gz + P) * S::DY + gy + P) * S::DX + gx + P];
      d1 = c1a * dc + c2a * z;
    }
    rr[i] = r1;
    e1[i] = d1;
  }
  __syncthreads();

  // stage 2 on the core tile, operand d1
  pair_zy<P, S::Z, S::Y, S::X>(e1, f1, din, c1, dd, bz, by, P, a, b);
  for (int i = threadIdx.x; i < S::Z * S::Y * S::X; i += NTHREADS) {
    int lx = i % S::X;
    int t = i / S::X;
    int ly = t % S::Y;
    int lz = t / S::Y;
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    if (gz < m && gy < m && gx < m) {
      long long g = stage + ((long long)gz * m + gy) * m + gx;
      int c = ((lz + P) * S::GY + ly + P) * S::GX + lx + P;
      float r2 = rr[c] - pair_x<P, S::Y, S::X>(c1, dd, bx, P, lz, ly, lx);
      float z = r2 / pair_diag(mdiag, kdiag, a, b, gz, gy, gx);
      float d1 = e1[c];
      float d2 = c1b * d1 + c2b * z;
      r_out[g] = r2;
      d_out[g] = d2;
      x_out[g] = x[g] + d1 + d2;
    }
  }
}

template <int P>
cudaError_t launch_cheb_pair(const float* d, const float* r, const float* x, const float* mdiag,
                             const float* kdiag, float* r_out, float* d_out, float* x_out,
                             const float* mband, const float* kband, const float* w, int q,
                             int m, cudaStream_t stream) {
  using S = Pair<P>;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (S::BYTES > optin) return cudaErrorInvalidConfiguration;
  err = allow_smem(cheb_pair_kernel<P>, S::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((m + S::X - 1) / S::X, (m + S::Y - 1) / S::Y, ((m + S::Z - 1) / S::Z) * q);
  cheb_pair_kernel<P><<<grid, NTHREADS, S::BYTES, stream>>>(d, r, x, mdiag, kdiag, r_out, d_out,
                                                           x_out, mband, kband, w, m);
  return cudaGetLastError();
}

}  // namespace spirk

// d, r, x and the three outputs (q, m, m, m); mdiag, kdiag the level's (m,)
// 1D diagonals; w (q, 6)
extern "C" int spirk_cheb_pair_dg(const float* d, const float* r, const float* x,
                                  const float* mdiag, const float* kdiag, float* r_out,
                                  float* d_out, float* x_out, const float* mband,
                                  const float* kband, const float* w, int q, int m, int p,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
#define SPIRK_CASE(P)                                                                       \
  case P:                                                                                   \
    return spirk::launch_cheb_pair<P>(d, r, x, mdiag, kdiag, r_out, d_out, x_out, mband,   \
                                      kband, w, q, m, s);
    SPIRK_CASE(1)
    SPIRK_CASE(2)
    SPIRK_CASE(3)
    SPIRK_CASE(4)
#undef SPIRK_CASE
    default: return cudaErrorInvalidValue;
  }
}
