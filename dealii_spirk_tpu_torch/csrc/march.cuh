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
//                          out_i = M v_i + tau K d_i, v = A^-1 d from K2;
//
// and its pair form pair_march (K8, the end of this file): two ChebDiag
// steps in one pass, stage 2 marching p planes behind stage 1.
//
// One block of NTHREADS threads owns one stage's TY x MX = 16 x 64 (y, x)
// output tile (Mix: every stage's, TY x 64) and marches over a chunk of z
// planes (at most March::ZC; the wrapper picks the chunk per launch so that
// a launch has at least two blocks per SM where the field allows,
// ops/cuda/stencil.py::march_plan; K3, K9c, K4, K9a, K5, K9b and K1 in runs
// so that the busiest SM has the least work, runs_chunk).  It keeps a ring
// of 2p + 2 haloed planes of each operand in shared memory (MixSplit two,
// Mix one per stage): the 2p + 1 that the z pass of the current plane
// reads and the next one, which cp.async copies in while the block
// computes the current plane, together with that plane's per-point fields
// (r and x, and D^-1 for ChebInvd; none for the others) into per-thread
// slots.  So each operand plane is read once per tile column (plus p planes
// at each chunk end) and no block waits on its own loads before it computes.  The copies
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
// stored once every stage is in).  Each pass reads its 2p + 1 taps from
// shared memory, so above p = 1 the passes set as much of the time as the
// copies: at P17's shape (p = 4) K3dg's passes alone took 0.70 ms and its
// copies alone 0.74, against 1.11 for the kernel and a DRAM bound of 0.48
// (PERF.md).  So K3, K3dg, K9c, K9d, MixSplit and, since the same passes held
// K4 at 0.17 of its bound at p = 4, Apply (K4, K9a) and MassStiff (K5, K9b)
// at p >= 3, and K1's Mix<16, 4> at p = 3 (March::RUNS) take the z pass over
// groups of 4 adjacent points in 16-byte loads (on the H100 2.7-3.6% off
// each at p = 4 against z_sums per point, PERF.md), the y
// pass in runs of 4 tile rows of a column summed from the 4 + 2p entries
// read once (y_run), each thread one run (the last 2p columns a row each),
// and chunks of up to 32 (p = 3) or 64 (p = 4) planes.  Every point keeps its
// taps, weights and order of sums, so these modes keep their bytes.
// ChebInvd copies three fields per point, which at p = 4 with two planes of
// them cost it the second resident block; in runs it keeps the fields of
// one plane (March::RX1), copied in by each thread into its own slots once
// its x pass of the plane before has read them, and waited for only before
// the x pass that reads them, so the copy hides behind the z and y passes
// (110,592 B at p = 4: two blocks per SM).  The y and x passes sum the
// stiffness taps apart from the mass taps and add the two sums, the plain version's
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
// MassStiff and MixSplit, 7 for ChebInvd, 6 for ChebDiag and for K8's two
// steps, against 40-80 flops per point and step at p = 1).
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
  static constexpr bool DIAG = std::is_same<Mode, ChebDiag>::value;
  static constexpr bool MIX = Mode::RINGS == 0;
  // K3, K3dg, K9c, K9d, K4, K9a, K5, K9b and K1's split march at p >= 3, and K1
  // on the 16-row tile (Mix<16, 4>) at p = 3 (RUNS): the z pass
  // over groups of 4 adjacent points in 16-byte loads and stores (z_pass),
  // the y pass in runs (y_run: a thread sums RY tile rows of one column from
  // registers, its rows' weights in 16-byte loads of [mass, stiff][row][k]
  // rows of NBP = NB rounded up to 4 floats; the last 2p columns a row per
  // thread) and chunks of up to ZC = 2 MZC planes at p = 3, 4 MZC at p = 4
  // (the z halo of 2p planes is read once per chunk; stencil.py
  // MARCH_RUNS_MAX_CHUNK); the other modes and degrees keep z_sums and
  // y_sums per point over [mass, stiff][k][row] and chunks of MZC
  static constexpr bool INVD = std::is_same<Mode, ChebInvd>::value;
  static constexpr bool RUNS = ((DIAG || INVD || std::is_same<Mode, MixSplit>::value ||
                                 std::is_same<Mode, Apply>::value ||
                                 std::is_same<Mode, MassStiff>::value) &&
                                P >= 3) ||
                               (MIX && TY == 16 && P == 3);
  // ChebInvd in runs: the per-point fields of one plane, not two (the
  // header; stencil.py::RUNS_BLOCKS)
  static constexpr bool RX1 = INVD && RUNS;
  static constexpr int RING = 2 * P + 2;  // planes z - p .. z + p and the next one
  static constexpr int LOADS = (PLANE + NTHREADS - 1) / NTHREADS;  // a plane's copies per thread
  static constexpr int YP = TY * HX;      // one field after the y pass
  static constexpr int MOUT = TY * MX / NTHREADS;  // output points of a thread per plane
  static constexpr int RXP = Mode::FIELDS * MOUT * NTHREADS;  // the fields of one plane
  static constexpr int RX = (RX1 ? 1 : 2) * RXP;
  static constexpr int ZC = RUNS ? (P >= 4 ? 4 : 2) * MZC : MZC;  // most z planes a block marches
  static constexpr int ZW = 2 * NB * ZC;  // z band rows of a chunk
  static constexpr int DG = DIAG ? 2 * ZC + 2 * TY : 0;  // 1D diagonals at the chunk's z, tile's y
  static constexpr int RY = 4;
  static constexpr int NBP = (NB + 3) / 4 * 4;
  static constexpr int YW = RUNS ? 2 * TY * NBP : 2 * NB * TY;  // y band rows of the tile
  static_assert(TY % MROWS == 0 && TY % RY == 0, "threads must tile the plane");
  static_assert(!RUNS || (TY / RY * MX == NTHREADS && 2 * P * TY <= NTHREADS &&
                          PLANE % 4 == 0),
                "the runs take 16 x 64 tiles and planes of whole 4-point groups");
  // shared floats: the rings, the z-pass fields E, F, the y-pass fields C,
  // D, the per-point fields, the band rows, the 1D diagonals (Mix: with one
  // stage's ring; a launch adds a ring per further stage)
  static constexpr int REST = 2 * PLANE + 2 * YP + RX + ZW + YW + DG;
  static_assert(!RUNS || (Mode::RINGS * RING * PLANE + 2 * PLANE + 2 * YP + RX + ZW) % 4 == 0,
                "the y band rows must be 16-byte aligned");
  static constexpr int SMEM_FLOATS = (MIX ? 1 : Mode::RINGS) * RING * PLANE + REST;
  // resident blocks per SM that the shared memory allows (228 KB, 1 KB of
  // it reserved per block), at most 4, and so the register budget ptxas is
  // held to.  Mix per point is held to 2; Mix in runs counts the rings of
  // its QA stages (Mix<16, 4> at p = 3: 221,216 B, one block per SM)
  static constexpr int SM_FLOATS =
      SMEM_FLOATS + (MIX && RUNS ? (Mode::ACC - 1) * RING * PLANE : 0);
  static_assert(SM_FLOATS * 4 <= 232448, "the march does not fit a block's shared memory");
  static constexpr int FIT = 233472 / (SM_FLOATS * 4 + 1024);
  static constexpr int BLOCKS = MIX && !RUNS ? 2 : FIT < 4 ? FIT : 4;
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
  int chunk;  // z planes per block, 1..March::ZC
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

// every group of this thread's copies in but the newest
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The pieces every mode and the pair march share: a haloed plane's copies,
// the sums of the z, y and x passes at one point, the Jacobi diagonal and
// the Chebyshev update.  Their products and sums are written as the fused
// (fmaf) or separate operations the earlier kernels were compiled to, so a
// value does not depend on how nvcc contracts an expression where it is
// inlined: the modes keep the earlier kernels' bytes (the A/B digests of
// scripts/torch_kernel_ab.py), and one K8 launch equals two K3dg launches.

// this thread's copies of an HY x HX haloed plane whose first row and
// column are the global (y0, x0): the offset in a global m x m plane, -1
// outside [0, m)^2
template <int HY, int HX, int LOADS>
__device__ __forceinline__ void plane_offsets(int (&goff)[LOADS], int y0, int x0, int m) {
#pragma unroll
  for (int s = 0; s < LOADS; ++s) {
    const int i = threadIdx.x + s * NTHREADS;
    const int gy = y0 + i / HX, gx = x0 + i % HX;
    goff[s] = (i < HY * HX && gy >= 0 && gy < m && gx >= 0 && gx < m) ? gy * m + gx : -1;
  }
}

// a haloed plane's copies from the global plane src into dst; zeros where
// zin is false (a plane outside the operand) or outside [0, m)^2
template <int PLANE, int LOADS>
__device__ __forceinline__ void load_plane(float* dst, const float* src, const int (&goff)[LOADS],
                                           bool zin) {
#pragma unroll
  for (int s = 0; s < LOADS; ++s) {
    const int i = threadIdx.x + s * NTHREADS;
    if (s + 1 < LOADS || i < PLANE) cp_async4(dst + i, src + max(goff[s], 0), zin && goff[s] >= 0);
  }
}

// z pass at entry i of the planes pl: the mass and the stiffness sums
template <int NB>
__device__ __forceinline__ void z_sums(const float* const (&pl)[NB], const float (&wzm)[NB],
                                       const float (&wzk)[NB], int i, float& zm, float& zk) {
  zm = 0.f;
  zk = 0.f;
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    const float v = pl[kk][i];
    zm = fmaf(wzm[kk], v, zm);
    zk = fmaf(wzk[kk], v, zk);
  }
}

// E of the z pass of a M + b K: a Zm + b Zk
__device__ __forceinline__ float shifted_e(float a, float b, float zm, float zk) {
  return fmaf(a, zm, b * zk);
}

// y pass at entry i of E and F (rows `stride` apart), band row ly of a
// table of `rows` rows ([mass, stiff][k][row]): c = My E + Ky F, d = My F,
// the stiffness taps Ky F summed apart from the mass taps
template <int NB>
__device__ __forceinline__ void y_sums(const float* E, const float* F, const float* yw, int rows,
                                       int ly, int i, int stride, float& c, float& d) {
  float cm = 0.f, ck = 0.f, dd = 0.f;
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    const int j = i + kk * stride;
    const float e = E[j], f = F[j];
    const float wm = yw[kk * rows + ly], wk = yw[(NB + kk) * rows + ly];
    cm = fmaf(wm, e, cm);
    ck = fmaf(wk, f, ck);
    dd = fmaf(wm, f, dd);
  }
  c = cm + ck;
  d = dd;
}

// y pass of RY tile rows r0 .. r0 + RY - 1 at column col of E and F (rows
// HX apart): the RY + NB - 1 entries each row reads, once, into registers,
// then per row y_sums' three sums in its order from the row's weights (yw:
// [mass, stiff][row][NBP], 16-byte loads); so a point's C and D are those
// of y_sums
template <int NB, int NBP, int RY, int TY, int HX>
__device__ __forceinline__ void y_run(const float* E, const float* F, const float* yw, int r0,
                                      int col, float* C, float* D) {
  constexpr int NW = RY + NB - 1;
  float e[NW], f[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    e[j] = E[(r0 + j) * HX + col];
    f[j] = F[(r0 + j) * HX + col];
  }
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    float wm[NBP], wk[NBP];
    const float4* m4 = reinterpret_cast<const float4*>(yw + (r0 + r) * NBP);
    const float4* k4 = reinterpret_cast<const float4*>(yw + (TY + r0 + r) * NBP);
#pragma unroll
    for (int v = 0; v < NBP / 4; ++v) {
      const float4 a = m4[v], b = k4[v];
      wm[4 * v] = a.x, wm[4 * v + 1] = a.y, wm[4 * v + 2] = a.z, wm[4 * v + 3] = a.w;
      wk[4 * v] = b.x, wk[4 * v + 1] = b.y, wk[4 * v + 2] = b.z, wk[4 * v + 3] = b.w;
    }
    float cm = 0.f, ck = 0.f, dd = 0.f;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      cm = fmaf(wm[kk], e[r + kk], cm);
      ck = fmaf(wk[kk], f[r + kk], ck);
      dd = fmaf(wm[kk], f[r + kk], dd);
    }
    C[(r0 + r) * HX + col] = cm + ck;
    D[(r0 + r) * HX + col] = dd;
  }
}

// x pass over C and D from entry c0 on: Mx C + Kx D, the mass taps and the
// stiffness taps in sums of their own; MU: mu = Mx D too (M d)
template <int NB, bool MU>
__device__ __forceinline__ float x_sums(const float* C, const float* D, int c0,
                                        const float (&xwm)[NB], const float (&xwk)[NB],
                                        float& mu) {
  float mx = 0.f, kx = 0.f;
  mu = 0.f;
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    mx = fmaf(xwm[kk], C[c0 + kk], mx);
    kx = fmaf(xwk[kk], D[c0 + kk], kx);
    if constexpr (MU) mu = fmaf(xwm[kk], D[c0 + kk], mu);
  }
  return mx + kx;
}

// the Jacobi diagonal of a M + b K at a point from the 1D diagonals at its
// z, y and x (mass, stiffness), in the plain version's order (cheb_diag)
__device__ __forceinline__ float jacobi_diag(float a, float b, float zdm, float zdk, float ym,
                                             float yk, float xdm, float xdk) {
  const float zmym = zdm * ym;
  const float stiff = fmaf(zdk, ym, zdm * yk);
  return fmaf(b * zmym, xdk, fmaf(a, zmym, b * stiff) * xdm);
}

// the Chebyshev update d' = c1 d + c2 z
__device__ __forceinline__ float cheb_d(float c1, float d, float c2, float z) {
  return fmaf(c1, d, c2 * z);
}

// ARM (a diagnostic of ChebDiag, ChebInvd, Apply, MassStiff and Mix<16, 4>:
// cheb_iter.cu::spirk_cheb_iter_dg_arm, spirk_cheb_iter_arm,
// stencil_apply.cu::spirk_stencil_apply_arm, mass_stiffness_apply.cu::
// spirk_mass_stiffness_apply_arm, ms_mix_apply.cu::spirk_ms_mix_apply_arm):
// 0 the kernel; PASSES the three passes and the update on planes already
// resident in shared memory (zeros), with no cp.async and no global store;
// COPIES the copies and stores alone (r' = r, d' = d at the centre, x' = x;
// Apply: out = d at the centre; MassStiff: both outputs d at the centre;
// Mix: out_i = d_i at the centre), no pass
constexpr int PASSES = 1, COPIES = 2;

// grid (ceil(m / MX), ceil(m / TY), ceil(zs.nz / chunk) per stage, times q
// but for Mix)
template <int P, class Mode, int ARM = 0>
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
  extern __shared__ float smem[];  // 16-byte aligned: the dynamic block starts it
  const int nrings = MIX ? g.q : Mode::RINGS;
  float* ring = smem;                    // [ring][RING][HY][HX]
  float* E = ring + nrings * RING * PLANE;  // [HY][HX]
  float* F = E + PLANE;
  float* C = F + PLANE;                  // [TY][HX]
  float* D = C + G::YP;
  float* rx = D + G::YP;                 // [plane & 1 (RX1: 0)][field][point][thread]
  float* zw = rx + G::RX;                // [mass, stiff][k][chunk plane]
  float* yw = zw + G::ZW;                // [mass, stiff][k][tile row]
  float* zdg = yw + G::YW;               // ChebDiag: [mass, stiff][chunk plane]
  float* ydg = zdg + 2 * G::ZC;          // ChebDiag: [mass, stiff][tile row]

  constexpr bool RESIDENT = ARM == PASSES;  // no copy
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

  // this thread's copies of a haloed plane
  int goff[G::LOADS];
  plane_offsets<G::HY, HX, G::LOADS>(goff, y0 - P, x0 - P, m);
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
    if constexpr (RESIDENT) return;
    const int gz = z0 + j + zs.halo;
    const bool zin = gz >= 0 && gz < nz_in;
    for (int rg = 0; rg < nrings; ++rg)
      load_plane<PLANE, G::LOADS>(ring + (rg * RING + (j + P) % RING) * PLANE,
                                  operand(rg) + (zin ? gz : 0) * mm, goff, zin);
  };
  // the per-point fields at this thread's points of plane j into buffer j & 1
  // (RX1: the one buffer)
  auto load_fields = [&](int j) {
    if constexpr (NF > 0 && !RESIDENT) {
      const long long base = oq + (long long)(z0 + j) * mm;
      float* dst = rx + (G::RX1 ? 0 : (j & 1) * G::RXP);
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

  if constexpr (RESIDENT) {  // resident planes and fields: zeros
    for (int i = tid; i < nrings * RING * PLANE; i += NTHREADS) ring[i] = 0.f;
    for (int i = tid; i < G::RX; i += NTHREADS) rx[i] = 0.f;
  }
  // prologue: planes -p .. p of the operands and the fields of plane 0 in
  // flight (RX1: in a group of their own, the newest), then the band rows
  // (and diagonals) of the chunk and tile
  for (int j = -P; j <= P; ++j) load_d(j);
  if constexpr (G::RX1) cp_async_commit();
  load_fields(0);
  cp_async_commit();
  load_band_rows<G::ZC>(zw, g.mband, g.kband, NB, m, zs.z_off + z0);
  if constexpr (G::RUNS) {  // [mass, stiff][row][NBP], zero past NB and m
    for (int i = tid; i < G::YW; i += NTHREADS) {
      const int k = i % G::NBP, r = (i / G::NBP) % TY, gy = y0 + r;
      const float* band = i < TY * G::NBP ? g.mband : g.kband;
      yw[i] = k < NB && gy < m ? band[k * m + gy] : 0.f;
    }
  } else {
    load_band_rows<TY>(yw, g.mband, g.kband, NB, m, y0);
  }
  float xdm = 0.f, xdk = 0.f;
  if constexpr (G::DIAG) {
    for (int i = tid; i < 2 * G::ZC; i += NTHREADS) {
      const int gi = zs.z_off + z0 + i % G::ZC;
      zdg[i] = gi < m ? __ldg((i < G::ZC ? g.mdiag : g.kdiag) + gi) : 0.f;
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
      wzm[kk] = zw[kk * G::ZC + k];
      wzk[kk] = zw[(NB + kk) * G::ZC + k];
    }
    if constexpr (G::RUNS) {  // groups of 4 points: z_sums' sums in its order
      for (int v = tid; v < PLANE / 4; v += NTHREADS) {
        float zm[4] = {}, zk[4] = {}, um[4] = {}, uk[4] = {};
#pragma unroll
        for (int kk = 0; kk < NB; ++kk) {
          const float4 d4 = reinterpret_cast<const float4*>(pl[kk])[v];
          const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            zm[c] = fmaf(wzm[kk], dv[c], zm[c]);
            if constexpr (!SPLIT) zk[c] = fmaf(wzk[kk], dv[c], zk[c]);
          }
          if constexpr (SPLIT) {  // zm is Zm v; Zm d and Zk d from ring 1
            const float4 u4 = reinterpret_cast<const float4*>(pl[kk] + RING * PLANE)[v];
            const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              um[c] = fmaf(wzm[kk], uv[c], um[c]);
              uk[c] = fmaf(wzk[kk], uv[c], uk[c]);
            }
          }
        }
        float e[4], f[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (SPLIT) {
            e[c] = zm[c] + b * uk[c];
            f[c] = b * um[c];
          } else if constexpr (MS || MIX) {
            e[c] = zk[c];
            f[c] = zm[c];
          } else {
            e[c] = shifted_e(a, b, zm[c], zk[c]);
            f[c] = b * zm[c];
          }
        }
        reinterpret_cast<float4*>(E)[v] = make_float4(e[0], e[1], e[2], e[3]);
        reinterpret_cast<float4*>(F)[v] = make_float4(f[0], f[1], f[2], f[3]);
      }
      return;
    }
#pragma unroll
    for (int s = 0; s < G::LOADS; ++s) {
      const int i = tid + s * NTHREADS;
      if (s + 1 < G::LOADS || i < PLANE) {
        float zm, zk;
        z_sums<NB>(pl, wzm, wzk, i, zm, zk);
        if constexpr (SPLIT) {  // zm is Zm v; Zm d and Zk d from ring 1
          float um, uk;
          z_sums<NB>(pl, wzm, wzk, RING * PLANE + i, um, uk);
          E[i] = zm + b * uk;
          F[i] = b * um;
        } else if constexpr (MS || MIX) {
          E[i] = zk;
          F[i] = zm;
        } else {
          E[i] = shifted_e(a, b, zm, zk);
          F[i] = b * zm;
        }
      }
    }
  };
  // y pass over the tile rows and the haloed x extent: C = My E + Ky F,
  // D = My F, the stiffness taps Ky F summed apart from the mass taps
  auto y_pass = [&]() {
    if constexpr (G::RUNS) {  // a run of RY rows of one of the first MX columns per thread,
      // then a row of one of the last 2p columns for the first 2p TY threads
      y_run<NB, G::NBP, G::RY, TY, HX>(E, F, yw, tid / MX * G::RY, tid % MX, C, D);
      if (tid < 2 * P * TY)
        y_run<NB, G::NBP, 1, TY, HX>(E, F, yw, tid / (2 * P), MX + tid % (2 * P), C, D);
    } else {
      for (int i = tid; i < G::YP; i += NTHREADS)
        y_sums<NB>(E, F, yw, TY, i / HX, i, HX, C[i], D[i]);
    }
  };
  // x pass and the mode's update at this thread's points of plane k (Mix:
  // of input stage j)
  auto x_pass = [&](int k, int j) {
    const float* centre = ring + (j * RING + (k + P) % RING) * PLANE + P * HX + P;
    const float* fk = rx + (G::RX1 ? 0 : (k & 1) * G::RXP) + tid;
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
        float mu;  // MassStiff, Mix: M d
        const float ad = x_sums<NB, MS || MIX>(C, D, c0, xwm, xwk, mu);
        const long long gi = base + (long long)gy * m + gx;
        if constexpr (MIX && ARM == COPIES) {
#pragma unroll
          for (int i = 0; i < NQ; ++i)
            if (i == j) acc[i][s] = centre[c0];
        } else if constexpr (MIX) {
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            acc[i][s] = fmaf(cm[i], mu, acc[i][s]);
            if (i == j) acc[i][s] = fmaf(tj, ad, acc[i][s]);
          }
        } else if constexpr (MS && ARM == COPIES) {
          g.out[gi] = centre[c0];
          g.d_out[gi] = centre[c0];
        } else if constexpr (MS) {
          if (ARM == PASSES && zs.nz > 0) continue;  // (always): no store
          g.out[gi] = mu;
          g.d_out[gi] = ad;
        } else if constexpr (NF == 0 && ARM == COPIES) {
          g.out[gi] = centre[c0];
        } else if constexpr (NF == 0) {
          if (ARM == PASSES && zs.nz > 0) continue;  // (always): no store
          g.out[gi] = ad;
        } else if constexpr (ARM == COPIES) {
          g.out[gi] = fk[s * NTHREADS];
          g.d_out[gi] = centre[c0];
          g.x_out[gi] = fk[(MOUT + s) * NTHREADS];
        } else {
          const float rn = fk[s * NTHREADS] - ad;
          float z;
          if constexpr (G::DIAG) {
            z = rn / jacobi_diag(a, b, zdg[k], zdg[G::ZC + k], ydg[ly], ydg[TY + ly], xdm, xdk);
          } else {
            z = fk[(2 * MOUT + s) * NTHREADS] * rn;
          }
          const float dn = cheb_d(c1, centre[c0], c2, z);
          if (ARM == PASSES && zs.nz > 0) continue;  // (always): no store
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
        if (in && i < g.q && !(ARM == PASSES && zs.nz > 0))  // PASSES: no store
          g.out[i * zs.out_stride(m) + base + (long long)gy * m + gx] = acc[i][s];
        acc[i][s] = 0.f;
      }
    }
  };

  // RX1: the groups of a thread are, oldest first, the operand plane k + p
  // (issued at plane k - 1), the fields of plane k (issued after the x pass
  // of plane k - 1), the operand plane k + 1 + p; so the operand planes wait
  // at the barrier and a thread's own fields only before its x pass
  for (int k = 0; k < nzc; ++k) {
    if constexpr (G::RX1) {
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // plane k's copies are in; every thread left plane k - 1
    if (k + 1 < nzc) {
      load_d(k + 1 + P);
      if constexpr (!G::RX1) load_fields(k + 1);
    }
    cp_async_commit();
    if constexpr (MIX) {
      // per input stage: E, F are last read by the y pass before the barrier
      // that precedes the x pass, C, D by the x pass before the next stage's
      // first barrier, so two barriers per stage suffice
      for (int j = 0; j < g.q; ++j) {
        if constexpr (ARM != COPIES) z_pass(k, j);
        __syncthreads();
        if constexpr (ARM != COPIES) y_pass();
        __syncthreads();
        x_pass(k, j);
      }
      store_mix(k);
    } else {
      if constexpr (ARM != COPIES) z_pass(k, 0);
      __syncthreads();
      if constexpr (ARM != COPIES) y_pass();
      __syncthreads();
      if constexpr (G::RX1) cp_async_wait_prior();  // this thread's fields of plane k
      x_pass(k, 0);
      if constexpr (G::RX1) {  // the fields of plane k + 1 into the slots just read
        if (k + 1 < nzc) load_fields(k + 1);
        cp_async_commit();
      }
    }
  }
}

template <int P, class Mode, int ARM = 0>
cudaError_t launch_march(const MarchArgs& g, int q, cudaStream_t stream) {
  using G = March<P, Mode>;
  if (g.chunk < 1 || g.chunk > G::ZC) return cudaErrorInvalidValue;
  const int bytes = ((G::MIX ? q : Mode::RINGS) * G::RING * G::PLANE + G::REST) * sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(march<P, Mode, ARM>, bytes);
  if (err != cudaSuccess) return err;
  const int nch = (g.zs.nz + g.chunk - 1) / g.chunk;
  const dim3 grid((g.m + MX - 1) / MX, (g.m + G::TY - 1) / G::TY, G::MIX ? nch : q * nch);
  MarchArgs args = g;
  args.q = q;
  march<P, Mode, ARM><<<grid, NTHREADS, bytes, stream>>>(args);
  return cudaGetLastError();
}

// p: 1..4
template <class Mode, int ARM = 0>
int march_entry(const MarchArgs& g, int q, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_march<1, Mode, ARM>(g, q, s);
    case 2: return launch_march<2, Mode, ARM>(g, q, s);
    case 3: return launch_march<3, Mode, ARM>(g, q, s);
    case 4: return launch_march<4, Mode, ARM>(g, q, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K8 (pair_march): two ChebDiag steps per pass, with (c1a, c2a) and then
// (c1b, c2b):
//   r1 = r - (a_i M + b K) d;   d1 = c1a_i d + c2a_i r1 / diag;
//   r2 = r1 - (a_i M + b K) d1; d2 = c1b_i d1 + c2b_i r2 / diag;
//   x2 = x + d1 + d2.
// A block owns one stage's TY x 64 (y, x) output column and marches its
// chunk with two pipelines, stage 2 p planes behind stage 1.  Stage 1 at
// plane z: a cp.async ring of 2p + 2 planes of d with a 2p halo in y and x,
// ChebDiag's z, y and x passes on the tile grown by p, r at the grown
// points (a p-haloed plane of r, two buffers), and so r1 and d1 there; d1
// goes into a ring of 2p + 1 grown planes, exactly zero at every grown
// point outside [0, m)^3 (planes outside the domain too), so stage 2's taps
// read zeros there, as the Pallas kernel's pair tables and two K3dg
// launches give; r1 at the core waits p planes in a ring of p + 1.  Stage 2
// at plane z - p: the z pass over the d1 ring, the y and x passes on the
// core, the step with r1, the diagonal and x, and one write of r2, d2 and
// x2.  So d, r and x are read once and r2, d2, x2 written once: 6 field
// passes for two steps, against 12 for two K3dg launches; stage 1 runs 2p
// more planes per chunk than stage 2, on the tile grown by p.  Both steps
// take ChebDiag's sums in its order (z_sums, y_sums, x_sums, jacobi_diag)
// at the same taps and weights, so a point's r2, d2 and x2 are those of
// two K3dg launches.  Per step six barriers: the stage-2 fields E, F, C
// and D reuse stage 1's (dead by then).  The tile height shrinks with p so
// that the rings fit (pair_tile below; ops/cuda/stencil.py::pair_tile).
// ---------------------------------------------------------------------------

// most z planes one K8 block marches (stencil.py PAIR_MAX_CHUNK): stage 1
// runs 2p more planes per chunk, and at P4's 255 level chunks of 32 planes
// took 1.718 ms against 1.769-1.774 with 16 on the H100 (PERF.md)
constexpr int PAIR_MZC = 2 * MZC;

template <int P, int TY_>
struct PairMarch {
  static constexpr int TY = TY_;
  static constexpr int NB = 2 * P + 1;
  static constexpr int GY = TY + 2 * P, GX = MX + 2 * P;  // the grown tile of stage 1
  static constexpr int DY = TY + 4 * P, DX = MX + 4 * P;  // a plane of d, a 2p halo
  static constexpr int DPLANE = DY * DX;
  static constexpr int GPLANE = GY * GX;
  static constexpr int CORE = TY * MX;
  static constexpr int RING = 2 * P + 2;    // d planes z - p .. z + p and the next one
  static constexpr int D1RING = 2 * P + 1;  // d1 planes of stage 2's z pass
  static constexpr int R1RING = P + 1;      // r1 at the core: planes z - p .. z
  static constexpr int DLOADS = (DPLANE + NTHREADS - 1) / NTHREADS;
  static constexpr int GLOADS = (GPLANE + NTHREADS - 1) / NTHREADS;
  static constexpr int MOUT = CORE / NTHREADS;  // core points of a thread per plane
  static constexpr int ZC = PAIR_MZC + 2 * P;   // stage-1 planes of a chunk
  static_assert(TY % MROWS == 0, "threads must tile the plane");
  // shared floats: the d ring, E and F over a d plane, C and D over the
  // grown rows, the d1 ring, two r planes, the r1 ring, x in per-thread
  // slots for two planes, the band rows and the 1D diagonals of the chunk's
  // stage-1 planes and the grown rows and columns (stencil.py::pair_smem_bytes)
  static constexpr int SMEM_FLOATS = RING * DPLANE + 2 * DPLANE + 2 * GY * DX +
                                     D1RING * GPLANE + 2 * GPLANE + R1RING * CORE + 2 * CORE +
                                     (2 * NB + 2) * (ZC + GY + GX);
  static constexpr bool FITS = SMEM_FLOATS * 4 <= 232448;
  static constexpr int BLOCKS = 233472 / (SMEM_FLOATS * 4 + 1024) < 4
                                    ? 233472 / (SMEM_FLOATS * 4 + 1024)
                                    : 4;
};

struct PairArgs {
  const float* d;  // (q, m, m, m) each
  const float* r;
  const float* x;
  const float* mdiag;  // the level's (m,) 1D diagonals
  const float* kdiag;
  float* r_out;
  float* d_out;
  float* x_out;
  const float* mband;  // the level's (2p + 1, m) band tables
  const float* kband;
  const float* a;  // (q,) each
  const float* c1a;
  const float* c2a;
  const float* c1b;
  const float* c2b;
  float b;
  int m;
  int chunk;  // z planes per block, 1..PAIR_MZC
};

// the 1D diagonals (mass, stiffness) of n rows from global row r0 on, zero
// outside [0, m)
__device__ __forceinline__ void load_diag_rows(float* dst, const float* __restrict__ md,
                                               const float* __restrict__ kd, int m, int r0,
                                               int n) {
  for (int i = threadIdx.x; i < 2 * n; i += NTHREADS) {
    const int gi = r0 + i % n;
    dst[i] = gi >= 0 && gi < m ? __ldg((i < n ? md : kd) + gi) : 0.f;
  }
}

// grid (ceil(m / MX), ceil(m / TY), ceil(m / chunk) per stage, times q)
template <int P, int TY>
__global__ void __launch_bounds__(NTHREADS, (PairMarch<P, TY>::BLOCKS))
pair_march(const PairArgs g) {
  using G = PairMarch<P, TY>;
  constexpr int NB = G::NB, GY = G::GY, GX = G::GX, DX = G::DX, ZC = G::ZC;
  constexpr int DPLANE = G::DPLANE, GPLANE = G::GPLANE, CORE = G::CORE, MOUT = G::MOUT;
  extern __shared__ float smem[];
  float* ring = smem;                   // [RING][DY][DX] planes of d
  float* E = ring + G::RING * DPLANE;   // [DY][DX]; stage 2 [GY][GX]
  float* F = E + DPLANE;
  float* C = F + DPLANE;                // [GY][DX]; stage 2 [TY][GX]
  float* D = C + GY * DX;
  float* d1 = D + GY * DX;              // [D1RING][GY][GX]
  float* rg = d1 + G::D1RING * GPLANE;  // [step & 1][GY][GX] r at the grown points
  float* r1 = rg + 2 * GPLANE;          // [R1RING][TY][MX]
  float* xs = r1 + G::R1RING * CORE;    // [plane & 1][point][thread] x at the core
  float* zw = xs + 2 * CORE;            // [mass, stiff][k][stage-1 plane]
  float* yw = zw + 2 * NB * ZC;         // [mass, stiff][k][grown row]
  float* xw = yw + 2 * NB * GY;         // [mass, stiff][k][grown column]
  float* zdg = xw + 2 * NB * GX;        // [mass, stiff][stage-1 plane]
  float* ydg = zdg + 2 * ZC;            // [mass, stiff][grown row]
  float* xdg = ydg + 2 * GY;            // [mass, stiff][grown column]

  const int tid = threadIdx.x;
  const int m = g.m;
  const int nch = (m + g.chunk - 1) / g.chunk;
  const int iq = blockIdx.z / nch;
  const int z0 = (blockIdx.z % nch) * g.chunk;
  const int nzc = min(g.chunk, m - z0);
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * MX;
  const float a = g.a[iq], b = g.b;
  const float c1a = g.c1a[iq], c2a = g.c2a[iq], c1b = g.c1b[iq], c2b = g.c2b[iq];
  const long long mm = (long long)m * m;
  const long long oq = iq * (long long)m * mm;

  int doff[G::DLOADS], roff[G::GLOADS];
  plane_offsets<G::DY, DX, G::DLOADS>(doff, y0 - 2 * P, x0 - 2 * P, m);
  plane_offsets<GY, GX, G::GLOADS>(roff, y0 - P, x0 - P, m);
  // this thread's core points: column ocol, rows orow + s * MROWS
  const int ocol = tid % MX, orow = tid / MX;
  const int gx = x0 + ocol;

  // d plane j of the chunk (global z0 - 2p + j) into ring slot j % RING
  auto load_d = [&](int j) {
    const int gz = z0 - 2 * P + j;
    const bool zin = gz >= 0 && gz < m;
    load_plane<DPLANE, G::DLOADS>(ring + (j % G::RING) * DPLANE, g.d + oq + (zin ? gz : 0) * mm,
                                  doff, zin);
  };
  // r at the grown points of stage-1 step k (global plane z0 - p + k)
  auto load_r = [&](int k) {
    const int gz = z0 - P + k;
    const bool zin = gz >= 0 && gz < m;
    load_plane<GPLANE, G::GLOADS>(rg + (k & 1) * GPLANE, g.r + oq + (zin ? gz : 0) * mm, roff,
                                  zin);
  };
  // x at this thread's core points of output plane j (global z0 + j)
  auto load_x = [&](int j) {
    const long long base = oq + (long long)(z0 + j) * mm;
    float* dst = xs + (j & 1) * CORE + tid;
#pragma unroll
    for (int s = 0; s < MOUT; ++s) {
      const int gy = y0 + orow + s * MROWS;
      const bool in = gy < m && gx < m;
      cp_async4(dst + s * NTHREADS, g.x + (in ? base + (long long)gy * m + gx : 0), in);
    }
  };

  // prologue: d planes z0 - 2p .. z0 and r of step 0 in flight, then the
  // band rows and diagonals of the stage-1 planes, grown rows and columns
  for (int j = 0; j <= 2 * P; ++j) load_d(j);
  load_r(0);
  cp_async_commit();
  load_band_rows<ZC>(zw, g.mband, g.kband, NB, m, z0 - P);
  load_band_rows<GY>(yw, g.mband, g.kband, NB, m, y0 - P);
  load_band_rows<GX>(xw, g.mband, g.kband, NB, m, x0 - P);
  load_diag_rows(zdg, g.mdiag, g.kdiag, m, z0 - P, ZC);
  load_diag_rows(ydg, g.mdiag, g.kdiag, m, y0 - P, GY);
  load_diag_rows(xdg, g.mdiag, g.kdiag, m, x0 - P, GX);
  // stage 2's x weights and diagonals at this thread's column
  float xwm[NB], xwk[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    xwm[k] = gx < m ? __ldg(g.mband + k * m + gx) : 0.f;
    xwk[k] = gx < m ? __ldg(g.kband + k * m + gx) : 0.f;
  }
  const float xdm = gx < m ? __ldg(g.mdiag + gx) : 0.f;
  const float xdk = gx < m ? __ldg(g.kdiag + gx) : 0.f;

  // step k: stage 1 at plane z0 - p + k, stage 2 (k >= 2p) at z0 + k - 2p
  const int nk = nzc + 2 * P;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_all();
    __syncthreads();  // step k's copies are in; every thread left step k - 1
    if (k + 1 < nk) {
      load_d(k + 1 + 2 * P);
      load_r(k + 1);
      if (k + 1 >= 2 * P) load_x(k + 1 - 2 * P);
    }
    cp_async_commit();
    const int z1 = z0 - P + k;
    const bool live = z1 >= 0 && z1 < m;  // else d1 = 0 on the whole plane
    if (live) {  // stage 1's z pass over d planes z1 - p .. z1 + p
      const float* pl[NB];
      float wzm[NB], wzk[NB];
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        pl[kk] = ring + ((k + kk) % G::RING) * DPLANE;
        wzm[kk] = zw[kk * ZC + k];
        wzk[kk] = zw[(NB + kk) * ZC + k];
      }
#pragma unroll
      for (int s = 0; s < G::DLOADS; ++s) {
        const int i = tid + s * NTHREADS;
        if (s + 1 < G::DLOADS || i < DPLANE) {
          float zm, zk;
          z_sums<NB>(pl, wzm, wzk, i, zm, zk);
          E[i] = shifted_e(a, b, zm, zk);
          F[i] = b * zm;
        }
      }
    }
    __syncthreads();
    if (live)  // stage 1's y pass over the grown rows and d's x extent
      for (int i = tid; i < GY * DX; i += NTHREADS) y_sums<NB>(E, F, yw, GY, i / DX, i, DX, C[i], D[i]);
    __syncthreads();
    {  // stage 1's x pass and step at the grown points: r1 (core), d1
      const float* rk = rg + (k & 1) * GPLANE;
      const float* centre = ring + ((k + P) % G::RING) * DPLANE;
      float* d1k = d1 + (k % G::D1RING) * GPLANE;
      float* r1k = r1 + (k % G::R1RING) * CORE;
      const float zdm = zdg[k], zdk = zdg[ZC + k];
#pragma unroll
      for (int s = 0; s < G::GLOADS; ++s) {
        const int i = tid + s * NTHREADS;
        if (s + 1 < G::GLOADS || i < GPLANE) {
          const int ly = i / GX, lx = i % GX;
          const int gy = y0 - P + ly, gxx = x0 - P + lx;
          float dn = 0.f;
          if (live && gy >= 0 && gy < m && gxx >= 0 && gxx < m) {
            float wm[NB], wk[NB], unused;
#pragma unroll
            for (int kk = 0; kk < NB; ++kk) {
              wm[kk] = xw[kk * GX + lx];
              wk[kk] = xw[(NB + kk) * GX + lx];
            }
            const float rn = rk[i] - x_sums<NB, false>(C, D, ly * DX + lx, wm, wk, unused);
            const float z =
                rn / jacobi_diag(a, b, zdm, zdk, ydg[ly], ydg[GY + ly], xdg[lx], xdg[GX + lx]);
            dn = cheb_d(c1a, centre[(ly + P) * DX + lx + P], c2a, z);
            if (ly >= P && ly < P + TY && lx >= P && lx < P + MX) r1k[(ly - P) * MX + lx - P] = rn;
          }
          d1k[i] = dn;
        }
      }
    }
    if (k >= 2 * P) {  // stage 2 at output plane j
      const int j = k - 2 * P;
      __syncthreads();  // d1 of plane z1 is in
      {  // z pass over the d1 planes of steps k - 2p .. k
        const float* pl[NB];
        float wzm[NB], wzk[NB];
#pragma unroll
        for (int kk = 0; kk < NB; ++kk) {
          pl[kk] = d1 + ((j + kk) % G::D1RING) * GPLANE;
          wzm[kk] = zw[kk * ZC + k - P];
          wzk[kk] = zw[(NB + kk) * ZC + k - P];
        }
#pragma unroll
        for (int s = 0; s < G::GLOADS; ++s) {
          const int i = tid + s * NTHREADS;
          if (s + 1 < G::GLOADS || i < GPLANE) {
            float zm, zk;
            z_sums<NB>(pl, wzm, wzk, i, zm, zk);
            E[i] = shifted_e(a, b, zm, zk);
            F[i] = b * zm;
          }
        }
      }
      __syncthreads();
      // y pass over the core rows (grown rows p ..) and the grown x extent
      for (int i = tid; i < TY * GX; i += NTHREADS)
        y_sums<NB>(E, F, yw + P, GY, i / GX, i, GX, C[i], D[i]);
      __syncthreads();
      // x pass and the second step at this thread's core points
      const float* d1c = d1 + ((k - P) % G::D1RING) * GPLANE;
      const float* r1c = r1 + ((k - P) % G::R1RING) * CORE;
      const float* xk = xs + (j & 1) * CORE + tid;
      const float zdm = zdg[k - P], zdk = zdg[ZC + k - P];
      const long long base = oq + (long long)(z0 + j) * mm;
#pragma unroll
      for (int s = 0; s < MOUT; ++s) {
        const int ly = orow + s * MROWS, gy = y0 + ly;
        if (gy < m && gx < m) {
          float unused;
          const float rn = r1c[ly * MX + ocol] - x_sums<NB, false>(C, D, ly * GX + ocol, xwm, xwk,
                                                                   unused);
          const float z =
              rn / jacobi_diag(a, b, zdm, zdk, ydg[P + ly], ydg[GY + P + ly], xdm, xdk);
          const float dc = d1c[(ly + P) * GX + ocol + P];
          const float dn = cheb_d(c1b, dc, c2b, z);
          const long long gi = base + (long long)gy * m + gx;
          g.r_out[gi] = rn;
          g.d_out[gi] = dn;
          g.x_out[gi] = xk[s * NTHREADS] + dc + dn;
        }
      }
    }
  }
}

// K8's tile height at degree P: the tallest of 16 and 8 rows whose block
// lets two blocks share an SM, else the tallest that fits one block (16 at
// p = 1 and 3, 8 at p = 2 and 4; stencil.py::pair_tile)
template <int P>
constexpr int pair_tile() {
  return PairMarch<P, 16>::BLOCKS >= 2  ? 16
         : PairMarch<P, 8>::BLOCKS >= 2 ? 8
         : PairMarch<P, 16>::FITS       ? 16
                                        : 8;
}

// a launch at another tile height than pair_tile<P>() is refused
template <int P>
cudaError_t launch_pair(const PairArgs& g, int q, int ty, cudaStream_t stream) {
  constexpr int TY = pair_tile<P>();
  using G = PairMarch<P, TY>;
  static_assert(G::FITS, "K8's block does not fit a block's shared memory");
  if (ty != TY) return cudaErrorInvalidValue;
  const int bytes = G::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(pair_march<P, TY>, bytes);
  if (err != cudaSuccess) return err;
  const int nch = (g.m + g.chunk - 1) / g.chunk;
  const dim3 grid((g.m + MX - 1) / MX, (g.m + TY - 1) / TY, q * nch);
  pair_march<P, TY><<<grid, NTHREADS, bytes, stream>>>(g);
  return cudaGetLastError();
}

// ty: the tile height (pair_tile); p: 1..4
inline int pair_entry(const PairArgs& g, int q, int ty, int p, void* stream) {
  if (g.chunk < 1 || g.chunk > PAIR_MZC) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_pair<1>(g, q, ty, s);
    case 2: return launch_pair<2>(g, q, ty, s);
    case 3: return launch_pair<3>(g, q, ty, s);
    case 4: return launch_pair<4>(g, q, ty, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace spirk
