// Shared tile machinery of the separable a*M + b*K stencil kernels.
//
// Layout: a stage block is (q, m, m, m) f32, contiguous, x fastest.  The
// 1D operators are banded tables band[(p + k) * m + i] = Op[i, i + k]
// (k in [-p, p]), with zero weights for every coupling that leaves
// [0, m) — the convention of dealii_spirk_tpu/ops/banded.py.
//
// One block of NTHREADS threads owns a TZ x TY x TX output tile of one
// stage.  It stages the input tile with a p-point halo on every side in
// shared memory (zero outside the domain, loaded with masks — nothing
// relies on wrap-around), then runs the three sum-factorised 1D passes
// there (z, then y, then x), keeping every intermediate on chip.  The
// per-row band weights of the tile are staged in shared memory too.
#pragma once

#include <cuda_runtime.h>

namespace spirk {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int TZ = 8;
constexpr int NTHREADS = 256;
constexpr int QMAX = 8;  // most stages a stage-coupled kernel holds

template <int P>
struct Tile {
  static constexpr int NB = 2 * P + 1;
  static constexpr int HX = TX + 2 * P;  // haloed extents
  static constexpr int HY = TY + 2 * P;
  static constexpr int HZ = TZ + 2 * P;
  static constexpr int IN = HZ * HY * HX;  // haloed input tile
  static constexpr int ZP = TZ * HY * HX;  // one field after the z pass
  static constexpr int YP = TZ * TY * HX;  // one field after the y pass
  static constexpr int BANDS = 2 * NB * (TZ + TY + TX);
  static constexpr int PTS = TZ * TY * TX / NTHREADS;  // outputs per thread
  // shared floats: input tile, two z-pass fields, two y-pass fields, bands
  static constexpr int SMEM_FLOATS = IN + 2 * ZP + 2 * YP + BANDS;
  static_assert(TZ * TY * TX % NTHREADS == 0, "tile must split evenly");
};

// Band weights of the tile's rows: [which(0=mass,1=stiff)][k][row] per
// axis, zero for rows outside [0, m).
template <int P>
struct Bands {
  float* z;  // 2 * NB * TZ
  float* y;  // 2 * NB * TY
  float* x;  // 2 * NB * TX
  __device__ float zm(int k, int r) const { return z[k * TZ + r]; }
  __device__ float zk(int k, int r) const { return z[(Tile<P>::NB + k) * TZ + r]; }
  __device__ float ym(int k, int r) const { return y[k * TY + r]; }
  __device__ float yk(int k, int r) const { return y[(Tile<P>::NB + k) * TY + r]; }
  __device__ float xm(int k, int r) const { return x[k * TX + r]; }
  __device__ float xk(int k, int r) const { return x[(Tile<P>::NB + k) * TX + r]; }
};

template <int T>
__device__ inline void load_band_rows(float* dst, const float* __restrict__ mband,
                                      const float* __restrict__ kband, int nb, int m,
                                      int r0) {
  for (int i = threadIdx.x; i < 2 * nb * T; i += NTHREADS) {
    int r = i % T;
    int k = (i / T) % nb;
    int which = i / (T * nb);
    int g = r0 + r;
    const float* band = which ? kband : mband;
    dst[i] = (g < m) ? band[k * m + g] : 0.f;
  }
}

template <int P>
__device__ inline Bands<P> load_bands(float* smem_bands, const float* __restrict__ mband,
                                      const float* __restrict__ kband, int m, int z0,
                                      int y0, int x0) {
  constexpr int NB = Tile<P>::NB;
  Bands<P> b{smem_bands, smem_bands + 2 * NB * TZ, smem_bands + 2 * NB * (TZ + TY)};
  load_band_rows<TZ>(b.z, mband, kband, NB, m, z0);
  load_band_rows<TY>(b.y, mband, kband, NB, m, y0);
  load_band_rows<TX>(b.x, mband, kband, NB, m, x0);
  return b;
}

// Haloed input tile of one stage field, zero outside the domain.
template <int P>
__device__ inline void load_tile(float* in, const float* __restrict__ u, int m, int z0,
                                 int y0, int x0) {
  using T = Tile<P>;
  for (int i = threadIdx.x; i < T::IN; i += NTHREADS) {
    int lx = i % T::HX;
    int t = i / T::HX;
    int ly = t % T::HY;
    int lz = t / T::HY;
    int gx = x0 + lx - P, gy = y0 + ly - P, gz = z0 + lz - P;
    float v = 0.f;
    if (gx >= 0 && gx < m && gy >= 0 && gy < m && gz >= 0 && gz < m)
      v = __ldg(u + ((long long)gz * m + gy) * m + gx);
    in[i] = v;
  }
}

// Decompose the k-th output point of this thread into tile coordinates.
__device__ inline void out_point(int s, int& lz, int& ly, int& lx) {
  int i = threadIdx.x + s * NTHREADS;
  lx = i % TX;
  int t = i / TX;
  ly = t % TY;
  lz = t / TY;
}

// Shifted operator (a M + b K) of the tile's stage: z pass E = a Zm + b Zk,
// F = b Zm; y pass C = My E + Ky F, D = My F (written to C, D); the caller
// finishes with the x pass out = Mx C + Kx D (shifted_x).
template <int P>
__device__ inline void shifted_zy(const float* in, float* E, float* F, float* C, float* D,
                                  const Bands<P>& bd, float a, float b) {
  using T = Tile<P>;
  for (int i = threadIdx.x; i < T::ZP; i += NTHREADS) {
    int lx = i % T::HX;
    int t = i / T::HX;
    int ly = t % T::HY;
    int lz = t / T::HY;
    float zm = 0.f, zk = 0.f;
#pragma unroll
    for (int k = 0; k < T::NB; ++k) {
      float v = in[((lz + k) * T::HY + ly) * T::HX + lx];
      zm += bd.zm(k, lz) * v;
      zk += bd.zk(k, lz) * v;
    }
    E[i] = a * zm + b * zk;
    F[i] = b * zm;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T::YP; i += NTHREADS) {
    int lx = i % T::HX;
    int t = i / T::HX;
    int ly = t % TY;
    int lz = t / TY;
    float c = 0.f, d = 0.f;
#pragma unroll
    for (int k = 0; k < T::NB; ++k) {
      int j = (lz * T::HY + ly + k) * T::HX + lx;
      float e = E[j], f = F[j];
      float wm = bd.ym(k, ly), wk = bd.yk(k, ly);
      c += wm * e + wk * f;
      d += wm * f;
    }
    C[i] = c;
    D[i] = d;
  }
  __syncthreads();
}

template <int P>
__device__ inline float shifted_x(const float* C, const float* D, const Bands<P>& bd,
                                  int lz, int ly, int lx) {
  using T = Tile<P>;
  float out = 0.f;
  int base = (lz * TY + ly) * T::HX + lx;
#pragma unroll
  for (int k = 0; k < T::NB; ++k)
    out += bd.xm(k, lx) * C[base + k] + bd.xk(k, lx) * D[base + k];
  return out;
}

// Dynamic shared memory beyond 48 KB needs the opt-in attribute once per
// kernel instantiation.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline dim3 tile_grid(int m, int q) {
  return dim3((m + TX - 1) / TX, (m + TY - 1) / TY, ((m + TZ - 1) / TZ) * q);
}

}  // namespace spirk
