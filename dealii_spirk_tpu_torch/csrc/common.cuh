// Shared machinery of the separable a*M + b*K stencil kernels.
//
// Layout: a 3D stage block is (q, m, m, m) f32, contiguous, x fastest
// (the 2D tiles are at the end of this file).  The
// 1D operators are banded tables band[(p + k) * m + i] = Op[i, i + k]
// (k in [-p, p]), with zero weights for every coupling that leaves
// [0, m) — the convention of dealii_spirk_tpu/ops/banded.py.
//
// The 3D kernels march over z (march.cuh: K1, K3, K3dg, K4, K5, K8 and the
// slab forms K9a-K9d).  The z extent
// of a launch is a ZSlab: a whole field (nz = m planes, no halo, rows from
// 0), or one slab of a field that is split over z between the slots of a
// (stage, space) mesh.  A slab's outputs are its own nz planes, global rows
// z_off .. z_off + nz; its operand holds them between `halo` planes of each
// neighbour (exact zeros at the domain ends), so it has nz + 2 * halo
// planes.  Only the plane loader, the z band rows and the output offsets
// read the ZSlab: taps, weights and summation order per output point are
// the same in both forms, so a slab's result equals the whole field's bit
// for bit.
#pragma once

#include <cuda_runtime.h>

namespace spirk {

constexpr int NTHREADS = 256;
constexpr int QMAX = 8;  // most stages a stage-coupled kernel holds

struct ZSlab {
  int nz;     // output planes
  int halo;   // neighbour planes on each side of the operand
  int z_off;  // global row of output plane 0
  __host__ __device__ long long out_stride(int m) const { return (long long)nz * m * m; }
  __host__ __device__ long long in_stride(int m) const {
    return (long long)(nz + 2 * halo) * m * m;
  }
};

__host__ __device__ inline ZSlab whole_field(int m) { return ZSlab{m, 0, 0}; }

// the band rows [mass, stiff][k][row] of T rows from global row r0 on
// (rows outside [0, m) weigh zero)
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
    dst[i] = (g >= 0 && g < m) ? band[k * m + g] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 2D: a stage block is (q, m, m), x fastest.  One block of NTHREADS
// threads owns a TY2 x TX2 output tile of one stage: it stages the tile
// with its p-halo (zero outside the domain), runs the y pass over the
// haloed x extent into shared memory (A = My u, B = Ky u), then the x
// pass per output point (M u = Mx A, K u = Mx B + Kx A).
// ---------------------------------------------------------------------------

constexpr int TX2 = 64;
constexpr int TY2 = 32;

template <int P>
struct Tile2 {
  static constexpr int NB = 2 * P + 1;
  static constexpr int HX = TX2 + 2 * P;
  static constexpr int HY = TY2 + 2 * P;
  static constexpr int IN = HY * HX;   // haloed input tile
  static constexpr int YP = TY2 * HX;  // one field after the y pass
  static constexpr int BANDS = 2 * NB * (TY2 + TX2);
  static constexpr int PTS = TY2 * TX2 / NTHREADS;  // outputs per thread
  // shared floats: input tile, two y-pass fields, bands
  static constexpr int SMEM_FLOATS = IN + 2 * YP + BANDS;
  static_assert(TY2 * TX2 % NTHREADS == 0, "tile must split evenly");
};

template <int P>
struct Bands2 {
  float* y;  // 2 * NB * TY2
  float* x;  // 2 * NB * TX2
  __device__ float ym(int k, int r) const { return y[k * TY2 + r]; }
  __device__ float yk(int k, int r) const { return y[(Tile2<P>::NB + k) * TY2 + r]; }
  __device__ float xm(int k, int r) const { return x[k * TX2 + r]; }
  __device__ float xk(int k, int r) const { return x[(Tile2<P>::NB + k) * TX2 + r]; }
};

template <int P>
__device__ inline Bands2<P> load_bands2(float* smem_bands, const float* __restrict__ mband,
                                        const float* __restrict__ kband, int m, int y0,
                                        int x0) {
  constexpr int NB = Tile2<P>::NB;
  Bands2<P> b{smem_bands, smem_bands + 2 * NB * TY2};
  load_band_rows<TY2>(b.y, mband, kband, NB, m, y0);
  load_band_rows<TX2>(b.x, mband, kband, NB, m, x0);
  return b;
}

template <int P>
__device__ inline void load_tile2(float* in, const float* __restrict__ u, int m, int y0,
                                  int x0) {
  using T = Tile2<P>;
  for (int i = threadIdx.x; i < T::IN; i += NTHREADS) {
    int lx = i % T::HX;
    int ly = i / T::HX;
    int gx = x0 + lx - P, gy = y0 + ly - P;
    float v = 0.f;
    if (gx >= 0 && gx < m && gy >= 0 && gy < m) v = __ldg(u + (long long)gy * m + gx);
    in[i] = v;
  }
}

__device__ inline void out_point2(int s, int& ly, int& lx) {
  int i = threadIdx.x + s * NTHREADS;
  lx = i % TX2;
  ly = i / TX2;
}

// y pass: A = My u, B = Ky u over the tile rows and the haloed x extent.
template <int P>
__device__ inline void mass_stiff_y2(const float* in, float* A, float* B,
                                     const Bands2<P>& bd) {
  using T = Tile2<P>;
  for (int i = threadIdx.x; i < T::YP; i += NTHREADS) {
    int lx = i % T::HX;
    int ly = i / T::HX;
    float am = 0.f, bk = 0.f;
#pragma unroll
    for (int k = 0; k < T::NB; ++k) {
      float v = in[(ly + k) * T::HX + lx];
      am += bd.ym(k, ly) * v;
      bk += bd.yk(k, ly) * v;
    }
    A[i] = am;
    B[i] = bk;
  }
  __syncthreads();
}

// x pass at one output point: mu = Mx A, ku = Kx A + Mx B, the stiffness
// taps summed in an accumulator of their own.  For a smooth field Kx A is a
// 1e-5 share of its terms at m = 1023: adding each small mass term into the
// same accumulator rounded every partial sum at the terms' scale, an error
// biased with the field (mean 7e-9 of max|K u| against 8e-11 kept apart, an
// f32 model of both orders), which GMRES takes into the solution: P3's L2
// came out 2.5x the f64 value (PERF.md, section 6).
template <int P>
__device__ inline void mass_stiff_x2(const float* A, const float* B, const Bands2<P>& bd,
                                     int ly, int lx, float& mu, float& ku) {
  using T = Tile2<P>;
  int base = ly * T::HX + lx;
  float kx = 0.f, mb = 0.f;
  mu = 0.f;
#pragma unroll
  for (int k = 0; k < T::NB; ++k) {
    float wm = bd.xm(k, lx), wk = bd.xk(k, lx);
    mu = fmaf(wm, A[base + k], mu);
    kx = fmaf(wk, A[base + k], kx);
    mb = fmaf(wm, B[base + k], mb);
  }
  ku = kx + mb;
}

// Dynamic shared memory beyond 48 KB needs the opt-in attribute once per
// kernel instantiation.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline dim3 tile_grid2(int m, int q) {
  return dim3((m + TX2 - 1) / TX2, (m + TY2 - 1) / TY2, q);
}

}  // namespace spirk
