// The z march: one template for the 3D stencil kernels, one instantiation
// per degree and mode:
//
//   Apply     (K4, K9a):   out = (a_i M + b K) d;
//   ChebInvd  (K3, K9c):   r' = r - (a_i M + b K) d;  d' = c1_i d + c2_i D^-1 r';
//                          x' = x + d', D^-1 read as a field;
//   ChebDiag  (K3dg, K9d): the same with D^-1 r' = r' / diag, the Jacobi
//                          diagonal rebuilt per point from the level's 1D
//                          diagonals: diag = (a zm ym + b (zk ym + zm yk)) xm
//                          + b zm ym xk;
//   MassStiff (K5, K9b):   M d and K d, two outputs;
//   Mix<TY, QA> (K1):      out_i = sum_j A^-1[i, j] M d_j + tau_i K d_i, every
//                          stage of the block at once (a ring per stage), on
//                          a TY x 64 tile;
//   MixSplit  (K1's route where the stages' rings do not fit):
//                          out_i = M v_i + tau K d_i, v = A^-1 d from K2.
//
// One block of NTHREADS threads owns one stage's TY x MX = 16 x 64 (y, x)
// output tile (Mix: every stage's, TY x 64) and marches over a chunk of z
// planes (at most MZC; the wrapper picks the chunk per launch so that a
// launch has at least two blocks per SM where the field allows,
// ops/cuda/stencil.py::march_plan).  It keeps a ring of 2p + 2 haloed
// planes of each operand in shared memory (MixSplit two, Mix one per
// stage): the 2p + 1 that the z pass of the current plane reads and the
// next one, which cp.async copies in while the block computes the current
// plane, together with that plane's per-point fields (r and x, and D^-1
// for ChebInvd; none for the others) into per-thread slots.  So each
// operand plane is read once per tile column (plus p planes at each chunk
// end) and no block waits on its own loads before it computes.  The copies
// are 4-byte cp.async: a row of a field is m * 4 bytes (1020 at m = 255), so
// neither TMA nor 16-byte copies fit the compact layout.  The domain halo is
// the zero-fill form (source size 0), so the loader has no masked branch.
//
// Per plane (Mix: per plane and input stage j): the z pass over the haloed
// plane into E and F (Apply, Cheb: E = a Zm d + b Zk d, F = b Zm d;
// MassStiff, Mix: E = Zk d, F = Zm d; MixSplit: E = Zm v + b Zk d,
// F = b Zm d), the y pass over the tile rows and the haloed x extent
// (C = My E + Ky F, D = My F), the x pass per output point (Mx C + Kx D;
// MassStiff and Mix also M d = Mx D) and the mode's update (Mix: adds
// A^-1[i, j] M d_j + [i = j] tau_j K d_j into q accumulators per point,
// stored once every stage is in).  The y and x passes sum the stiffness
// taps apart from the mass taps and add the two sums, the plain version's
// order: one accumulator for both (the earlier tile kernels) gave K3dg's r'
// on a smooth field at P4's 255 level a mean error against f64 ten times the
// f32 plain version's (chip_smoke.py::smooth_bias), the rounding K5-2D had
// (common.cuh::mass_stiff_x2).  Taps, weights and summation order per output
// point do not depend on the chunk or the z extent (ZSlab), so every launch
// of a mode gives the same value at a point.
//
// The coefficients come by pointer (a, c1, c2, (q,) each; Mix's (q + 1, q)
// table) and by value (b; MixSplit's tau): a launch is one device op.  Bound
// on the H100: DRAM (2 field passes per point for Apply and Mix, 3 for
// MassStiff and MixSplit, 7 for ChebInvd, 6 for ChebDiag, against 40-80
// flops per point at p = 1).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace spirk {

// A mode: the per-point fields it copies besides its operands, its operand
// rings (0: one per stage of the launch, Mix), its output tile's height and
// the sums it keeps per output point (Mix: at least the launch's stages).
template <int F, int R = 1, int T = 16, int A = 1>
struct ModeOf {
  static constexpr int FIELDS = F;
  static constexpr int RINGS = R;
  static constexpr int TY = T;
  static constexpr int ACC = A;
};
struct Apply : ModeOf<0> {};
struct ChebInvd : ModeOf<3> {};  // r, x, D^-1
struct ChebDiag : ModeOf<2> {};  // r, x
struct MassStiff : ModeOf<0> {};
struct MixSplit : ModeOf<0, 2> {};  // v, d
// QA: 4 for launches of up to 4 stages, else QMAX on the 8-row tile (the
// sums live in registers: QMAX sums for 4 stages on the 16-row tile spilled
// at p = 1 and took 0.097 ms at P1's shape against 0.069 with 4, PERF.md)
template <int T, int QA>
struct Mix : ModeOf<0, 0, T, QA> {};

constexpr int MX = 64;   // output tile along x (stencil.py MARCH_TILE)
constexpr int MZC = 16;  // most z planes one block marches (stencil.py MARCH_MAX_CHUNK)
constexpr int MROWS = NTHREADS / MX;  // tile rows between a thread's points
static_assert(NTHREADS % MX == 0, "threads must tile the plane");

template <int P, class Mode>
struct March {
  static constexpr int TY = Mode::TY;
  static constexpr int NB = 2 * P + 1;
  static constexpr int HX = MX + 2 * P;  // haloed extents
  static constexpr int HY = TY + 2 * P;
  static constexpr int PLANE = HY * HX;  // one haloed plane of an operand
  static constexpr int RING = 2 * P + 2;  // planes z - p .. z + p and the next one
  static constexpr int LOADS = (PLANE + NTHREADS - 1) / NTHREADS;  // a plane's copies per thread
  static constexpr int YP = TY * HX;      // one field after the y pass
  static constexpr int MOUT = TY * MX / NTHREADS;  // output points of a thread per plane
  static constexpr int RX = 2 * Mode::FIELDS * MOUT * NTHREADS;  // the fields of two planes
  static constexpr int ZW = 2 * NB * MZC;  // z band rows of a chunk
  static constexpr int YW = 2 * NB * TY;   // y band rows of the tile
  static constexpr bool DIAG = std::is_same<Mode, ChebDiag>::value;
  static constexpr bool MIX = Mode::RINGS == 0;
  static constexpr int DG = DIAG ? 2 * MZC + 2 * TY : 0;  // 1D diagonals at the chunk's z, tile's y
  static_assert(TY % MROWS == 0, "threads must tile the plane");
  // shared floats: the rings, the z-pass fields E, F, the y-pass fields C,
  // D, the per-point fields, the band rows, the 1D diagonals (Mix: with one
  // stage's ring; a launch adds a ring per further stage)
  static constexpr int REST = 2 * PLANE + 2 * YP + RX + ZW + YW + DG;
  static constexpr int SMEM_FLOATS = (MIX ? 1 : Mode::RINGS) * RING * PLANE + REST;
  static_assert(SMEM_FLOATS * 4 <= 232448, "the march does not fit a block's shared memory");
  // resident blocks per SM that the shared memory allows (228 KB, 1 KB of
  // it reserved per block), at most 4, and so the register budget ptxas is
  // held to; Mix (q rings) is held to 2
  static constexpr int BLOCKS = MIX ? 2
                                : 233472 / (SMEM_FLOATS * 4 + 1024) < 4
                                    ? 233472 / (SMEM_FLOATS * 4 + 1024)
                                    : 4;
};

// A launch's arguments; the fields a mode does not read may be null.
struct MarchArgs {
  const float* d;      // the operand, (q, nz + 2 halo, m, m); MixSplit: v
  const float* u;      // MixSplit: the operand of K (q, m, m, m)
  const float* r;      // Cheb: (q, nz, m, m) each
  const float* x;
  const float* invd;   // ChebInvd: D^-1
  const float* mdiag;  // ChebDiag: the level's (m,) 1D diagonals
  const float* kdiag;
  float* out;          // Apply, Mix, MixSplit: the result; Cheb: r'; MassStiff: M d
  float* d_out;        // Cheb: d', x'; MassStiff: K d
  float* x_out;
  const float* mband;  // the level's (2p + 1, m) band tables
  const float* kband;
  const float* a;      // (q,) per-stage coefficients (c1, c2: Cheb)
  const float* c1;
  const float* c2;
  const float* mw;     // Mix: (q + 1, q) row-major, rows A^-1, then tau per stage
  float b;             // MixSplit: tau
  int m;
  int q;      // stages of the launch (Mix: of every block)
  int chunk;  // z planes per block, 1..MZC
  ZSlab zs;
};

// 4-byte asynchronous copy global -> shared; `full` false writes a zero
// (source size 0: nothing is read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// grid (ceil(m / MX), ceil(m / TY), ceil(zs.nz / chunk) per stage, times q
// but for Mix)
template <int P, class Mode>
__global__ void __launch_bounds__(NTHREADS, (March<P, Mode>::BLOCKS))
march(const MarchArgs g) {
  using G = March<P, Mode>;
  constexpr int NB = G::NB, HX = G::HX, PLANE = G::PLANE, RING = G::RING;
  constexpr int TY = G::TY, MOUT = G::MOUT;
  constexpr int NF = Mode::FIELDS, NQ = Mode::ACC;
  constexpr bool MS = std::is_same<Mode, MassStiff>::value;
  constexpr bool SPLIT = std::is_same<Mode, MixSplit>::value;
  constexpr bool MIX = G::MIX;
  constexpr bool SHIFTED = !(MS || SPLIT || MIX);  // reads the (q,) table a
  extern __shared__ float smem[];
  const int nrings = MIX ? g.q : Mode::RINGS;
  float* ring = smem;                    // [ring][RING][HY][HX]
  float* E = ring + nrings * RING * PLANE;  // [HY][HX]
  float* F = E + PLANE;
  float* C = F + PLANE;                  // [TY][HX]
  float* D = C + G::YP;
  float* rx = D + G::YP;                 // [plane & 1][field][point][thread]
  float* zw = rx + G::RX;                // [mass, stiff][k][chunk plane]
  float* yw = zw + G::ZW;                // [mass, stiff][k][tile row]
  float* zdg = yw + G::YW;               // ChebDiag: [mass, stiff][chunk plane]
  float* ydg = zdg + 2 * MZC;            // ChebDiag: [mass, stiff][tile row]

  const int tid = threadIdx.x;
  const int m = g.m;
  const ZSlab zs = g.zs;
  const int nch = (zs.nz + g.chunk - 1) / g.chunk;
  const int iq = MIX ? 0 : blockIdx.z / nch;
  const int z0 = (blockIdx.z % nch) * g.chunk;
  const int nzc = min(g.chunk, zs.nz - z0);
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * MX;
  const float a = SHIFTED ? g.a[iq] : 0.f, b = g.b;
  const float c1 = NF ? g.c1[iq] : 0.f, c2 = NF ? g.c2[iq] : 0.f;
  const long long mm = (long long)m * m;
  const long long oq = iq * zs.out_stride(m);
  const int nz_in = zs.nz + 2 * zs.halo;
  const float* fields[NF > 0 ? NF : 1] = {g.r};
  if constexpr (NF > 1) fields[1] = g.x;
  if constexpr (NF > 2) fields[2] = g.invd;

  // this thread's copies of a haloed plane: offset in a global plane, -1
  // outside [0, m)^2
  int goff[G::LOADS];
#pragma unroll
  for (int s = 0; s < G::LOADS; ++s) {
    const int i = tid + s * NTHREADS;
    const int gy = y0 + i / HX - P, gx = x0 + i % HX - P;
    goff[s] = (i < PLANE && gy >= 0 && gy < m && gx >= 0 && gx < m) ? gy * m + gx : -1;
  }
  // this thread's output points: column ocol, rows orow + s * MROWS
  const int ocol = tid % MX, orow = tid / MX;
  const int gx = x0 + ocol;

  // the operand of ring rg: stage iq's (Mix: stage rg's; MixSplit: v, then d)
  auto operand = [&](int rg) {
    if constexpr (MIX) return g.d + rg * zs.in_stride(m);
    if constexpr (SPLIT) return (rg ? g.u : g.d) + iq * zs.in_stride(m);
    return g.d + iq * zs.in_stride(m);
  };
  // plane j of the chunk (operand plane z0 + j + halo; zeros beyond the
  // operand) of every operand into ring slot (j + p) % RING
  auto load_d = [&](int j) {
    const int gz = z0 + j + zs.halo;
    const bool zin = gz >= 0 && gz < nz_in;
    for (int rg = 0; rg < nrings; ++rg) {
      const float* src = operand(rg) + (zin ? gz : 0) * mm;
      float* dst = ring + (rg * RING + (j + P) % RING) * PLANE;
#pragma unroll
      for (int s = 0; s < G::LOADS; ++s) {
        const int i = tid + s * NTHREADS;
        if (s + 1 < G::LOADS || i < PLANE)
          cp_async4(dst + i, src + max(goff[s], 0), zin && goff[s] >= 0);
      }
    }
  };
  // the per-point fields at this thread's points of plane j into buffer j & 1
  auto load_fields = [&](int j) {
    if constexpr (NF > 0) {
      const long long base = oq + (long long)(z0 + j) * mm;
      float* dst = rx + (j & 1) * NF * MOUT * NTHREADS;
#pragma unroll
      for (int s = 0; s < MOUT; ++s) {
        const int gy = y0 + orow + s * MROWS;
        const bool in = gy < m && gx < m;
        const long long gi = in ? base + (long long)gy * m + gx : 0;
#pragma unroll
        for (int f = 0; f < NF; ++f)
          cp_async4(dst + (f * MOUT + s) * NTHREADS + tid, fields[f] + gi, in);
      }
    }
  };

  // prologue: planes -p .. p of the operands and the fields of plane 0 in
  // flight, then the band rows (and diagonals) of the chunk and tile
  for (int j = -P; j <= P; ++j) load_d(j);
  load_fields(0);
  cp_async_commit();
  load_band_rows<MZC>(zw, g.mband, g.kband, NB, m, zs.z_off + z0);
  load_band_rows<TY>(yw, g.mband, g.kband, NB, m, y0);
  float xdm = 0.f, xdk = 0.f;
  if constexpr (G::DIAG) {
    for (int i = tid; i < 2 * MZC; i += NTHREADS) {
      const int gi = zs.z_off + z0 + i % MZC;
      zdg[i] = gi < m ? __ldg((i < MZC ? g.mdiag : g.kdiag) + gi) : 0.f;
    }
    for (int i = tid; i < 2 * TY; i += NTHREADS) {
      const int gi = y0 + i % TY;
      ydg[i] = gi < m ? __ldg((i < TY ? g.mdiag : g.kdiag) + gi) : 0.f;
    }
    xdm = gx < m ? __ldg(g.mdiag + gx) : 0.f;
    xdk = gx < m ? __ldg(g.kdiag + gx) : 0.f;
  }
  float xwm[NB], xwk[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    xwm[k] = gx < m ? __ldg(g.mband + k * m + gx) : 0.f;
    xwk[k] = gx < m ? __ldg(g.kband + k * m + gx) : 0.f;
  }
  // Mix: the q sums of every output point of this thread
  float acc[NQ][MIX ? MOUT : 1];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int s = 0; s < (MIX ? MOUT : 1); ++s) acc[i][s] = 0.f;

  // z pass of plane k over ring rg's haloed plane into E and F
  auto z_pass = [&](int k, int rg) {
    const float* pl[NB];
    float wzm[NB], wzk[NB];
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      pl[kk] = ring + (rg * RING + (k + kk) % RING) * PLANE;  // plane k - p + kk
      wzm[kk] = zw[kk * MZC + k];
      wzk[kk] = zw[(NB + kk) * MZC + k];
    }
#pragma unroll
    for (int s = 0; s < G::LOADS; ++s) {
      const int i = tid + s * NTHREADS;
      if (s + 1 < G::LOADS || i < PLANE) {
        float zm = 0.f, zk = 0.f;
#pragma unroll
        for (int kk = 0; kk < NB; ++kk) {
          const float v = pl[kk][i];
          zm += wzm[kk] * v;
          zk += wzk[kk] * v;
        }
        if constexpr (SPLIT) {  // zm is Zm v; Zm d and Zk d from ring 1
          float um = 0.f, uk = 0.f;
#pragma unroll
          for (int kk = 0; kk < NB; ++kk) {
            const float v = pl[kk][RING * PLANE + i];
            um += wzm[kk] * v;
            uk += wzk[kk] * v;
          }
          E[i] = zm + b * uk;
          F[i] = b * um;
        } else if constexpr (MS || MIX) {
          E[i] = zk;
          F[i] = zm;
        } else {
          E[i] = a * zm + b * zk;
          F[i] = b * zm;
        }
      }
    }
  };
  // y pass over the tile rows and the haloed x extent: C = My E + Ky F,
  // D = My F, the stiffness taps Ky F summed apart from the mass taps
  auto y_pass = [&]() {
    for (int i = tid; i < G::YP; i += NTHREADS) {
      const int ly = i / HX;
      float cm = 0.f, ck = 0.f, dd = 0.f;
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const int j = i + kk * HX;
        const float e = E[j], f = F[j];
        const float wm = yw[kk * TY + ly], wk = yw[(NB + kk) * TY + ly];
        cm = fmaf(wm, e, cm);
        ck = fmaf(wk, f, ck);
        dd = fmaf(wm, f, dd);
      }
      C[i] = cm + ck;
      D[i] = dd;
    }
  };
  // x pass and the mode's update at this thread's points of plane k (Mix:
  // of input stage j)
  auto x_pass = [&](int k, int j) {
    const float* centre = ring + ((k + P) % RING) * PLANE + P * HX + P;
    const float* fk = rx + (k & 1) * NF * MOUT * NTHREADS + tid;
    const long long base = oq + (long long)(z0 + k) * mm;
    float cm[NQ];  // Mix: A^-1[i, j] for every output stage i
    float tj = 0.f;             // Mix: tau_j
    if constexpr (MIX) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) cm[i] = i < g.q ? __ldg(g.mw + i * g.q + j) : 0.f;
      tj = __ldg(g.mw + g.q * g.q + j);
    }
#pragma unroll
    for (int s = 0; s < MOUT; ++s) {
      const int ly = orow + s * MROWS, gy = y0 + ly;
      if (gy < m && gx < m) {
        const int c0 = ly * HX + ocol;
        float mx = 0.f, kx = 0.f;  // the mass taps and the stiffness taps apart
        float mu = 0.f;            // MassStiff, Mix: M d
#pragma unroll
        for (int kk = 0; kk < NB; ++kk) {
          mx = fmaf(xwm[kk], C[c0 + kk], mx);
          kx = fmaf(xwk[kk], D[c0 + kk], kx);
          if constexpr (MS || MIX) mu = fmaf(xwm[kk], D[c0 + kk], mu);
        }
        const float ad = mx + kx;
        const long long gi = base + (long long)gy * m + gx;
        if constexpr (MIX) {
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            acc[i][s] = fmaf(cm[i], mu, acc[i][s]);
            if (i == j) acc[i][s] = fmaf(tj, ad, acc[i][s]);
          }
        } else if constexpr (MS) {
          g.out[gi] = mu;
          g.d_out[gi] = ad;
        } else if constexpr (NF == 0) {
          g.out[gi] = ad;
        } else {
          const float rn = fk[s * NTHREADS] - ad;
          float z;
          if constexpr (G::DIAG) {
            const float zdm = zdg[k], zdk = zdg[MZC + k];
            const float ym = ydg[ly], yk = ydg[TY + ly];
            const float zmym = zdm * ym;
            z = rn / ((a * zmym + b * (zdk * ym + zdm * yk)) * xdm + (b * zmym) * xdk);
          } else {
            z = fk[(2 * MOUT + s) * NTHREADS] * rn;
          }
          const float dn = c1 * centre[c0] + c2 * z;
          g.out[gi] = rn;
          g.d_out[gi] = dn;
          g.x_out[gi] = fk[(MOUT + s) * NTHREADS] + dn;
        }
      }
    }
  };
  // Mix: the q sums of plane k stored, and cleared
  auto store_mix = [&](int k) {
    const long long base = (long long)(z0 + k) * mm;
#pragma unroll
    for (int s = 0; s < MOUT; ++s) {
      const int gy = y0 + orow + s * MROWS;
      const bool in = gy < m && gx < m;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (in && i < g.q) g.out[i * zs.out_stride(m) + base + (long long)gy * m + gx] = acc[i][s];
        acc[i][s] = 0.f;
      }
    }
  };

  for (int k = 0; k < nzc; ++k) {
    cp_async_wait_all();
    __syncthreads();  // plane k's copies are in; every thread left plane k - 1
    if (k + 1 < nzc) {
      load_d(k + 1 + P);
      load_fields(k + 1);
    }
    cp_async_commit();
    if constexpr (MIX) {
      // per input stage: E, F are last read by the y pass before the barrier
      // that precedes the x pass, C, D by the x pass before the next stage's
      // first barrier, so two barriers per stage suffice
      for (int j = 0; j < g.q; ++j) {
        z_pass(k, j);
        __syncthreads();
        y_pass();
        __syncthreads();
        x_pass(k, j);
      }
      store_mix(k);
    } else {
      z_pass(k, 0);
      __syncthreads();
      y_pass();
      __syncthreads();
      x_pass(k, 0);
    }
  }
}

template <int P, class Mode>
cudaError_t launch_march(const MarchArgs& g, int q, cudaStream_t stream) {
  using G = March<P, Mode>;
  const int bytes = ((G::MIX ? q : Mode::RINGS) * G::RING * G::PLANE + G::REST) * sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(march<P, Mode>, bytes);
  if (err != cudaSuccess) return err;
  const int nch = (g.zs.nz + g.chunk - 1) / g.chunk;
  const dim3 grid((g.m + MX - 1) / MX, (g.m + G::TY - 1) / G::TY, G::MIX ? nch : q * nch);
  MarchArgs args = g;
  args.q = q;
  march<P, Mode><<<grid, NTHREADS, bytes, stream>>>(args);
  return cudaGetLastError();
}

// p: 1..4
template <class Mode>
int march_entry(const MarchArgs& g, int q, int p, void* stream) {
  if (g.chunk < 1 || g.chunk > MZC) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_march<1, Mode>(g, q, s);
    case 2: return launch_march<2, Mode>(g, q, s);
    case 3: return launch_march<3, Mode>(g, q, s);
    case 4: return launch_march<4, Mode>(g, q, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace spirk
