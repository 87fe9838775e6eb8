// K10: the V-cycle's grid transfers, 3D, per lane i of a (q, m, m, m) block:
//
//   spirk_transfer_restrict:  rc_i = (P^T (x) P^T (x) P^T)(rl_i - ax_i)
//   spirk_transfer_prolong:   x'_i = x_i + (P (x) P (x) P) xc_i
//
// with P (m_f, m_c) the level pair's 1D prolongation: the Lagrange
// interpolation of any degree (fem/assembly.py::prolongation_1d) or AMG's
// aggregation (solvers/amg.py).  K10 replaces no TPU kernel: the JAX package
// leaves the transfers to XLA's dense dot, and K10 stands in for
// dealii_spirk_tpu/ops/banded.py::apply_dense_1d, which the port's plain
// version (ops/transfer.py) repeats as a dense tensordot and a movedim per
// axis, with rl - ax and x + P xc as two more passes around it.
//
// P comes in its row-run form (ops/cuda/transfer.py::row_runs): row r of a
// matrix holds its nonzeros in columns start[r] .. start[r] + W - 1, zeros
// padding the run to W, the template width (P^T's rows 3, 7, 11, 15: 4p - 1
// at degree p, AMG's 2 padded to 3; P's 2 .. 5: p + 1, AMG's 1 padded).  One
// table serves the three axes.  A tap outside the field reads a zero.
// transfer_runs decides once per level pair that a P fits the tiles and the
// ring below (kernel_fits); nothing here checks it again.
//
// Bound on the H100: bytes.  Restriction reads two fine fields and writes a
// coarse one, prolongation reads a fine and a coarse field and writes a fine
// one: at 511^3 <- 255^3 (one lane) 1.13 GB each, 0.34 ms at 3.35 TB/s,
// against 2 W FMAs per output per axis.  So each kernel reads every fine
// value from DRAM once (plus a few halo planes at a chunk's ends), keeps
// every intermediate on chip, and writes each output once.
//
// Order of the sums: the plain version's.  It contracts z, then y, then x,
// each output of a pass summed over the column in ascending order with
// FMAs (cuBLAS's f32 GEMM), so both kernels contract z first, then y, then
// x, each sum from zero over its run's nonzero taps in ascending order: a
// zero weight adds nothing, so a run's sum is the dense column's.  On the
// H100 both equal the plain version bit for bit wherever cuBLAS sums in
// that order: every restriction, and every prolongation but the smallest
// pairs' (15 <- 7, 31 <- 15, at one lane 63 <- 31), where cuBLAS takes its
// small-matrix or split-K kernels and 1 or 2 ulps part them.  A path's L2
// at the f32 floor moves with any such difference (chip_smoke.py, ARM_L2).
//
// * restriction: a block owns a 16 x 32 tile of coarse (y, x) outputs and a
//   chunk of coarse z planes, and marches over the fine planes those read.
//   Each thread owns fixed points of the fine tile (the runs' span, at most
//   42 x 80) and loads rl and ax there one plane ahead into registers; it
//   adds each fine plane's rl - ax (the residual is never written to DRAM),
//   with the plane's z weight, into the sums of the open coarse planes at
//   its own points: a ring of TRING planes in shared memory (a weight is
//   the block's, so a zero one is skipped uniformly), no barrier.  Once the
//   fine plane of a coarse plane's last nonzero tap has passed, the block
//   runs its y pass (a warp on two coarse rows, its lanes on the fine
//   columns, the row's weights in registers, its zero taps, 8 or 9 of 15 at
//   p = 4, skipped by a uniform branch) and its x pass (a thread on one
//   coarse column, its weights in registers, and two rows: lanes on 16
//   columns of two rows, as the columns' runs start two fine points apart
//   and a row pitch of 97 = 1 mod 32 puts the second row on the other
//   banks), stores the plane and clears its slot.  Closing at the last
//   nonzero tap, not the padded run's end, keeps at most p + 1 planes open
//   (5 at p = 4, against 8), so the ring of 6 is 81 KB and two blocks share
//   an SM: while one runs a plane's passes between its barriers, the other
//   streams.  A thread holds 14 points and two planes of loads in
//   registers.  The tile's halo rows and columns (7 of 32 fine rows, 7 of
//   64 columns at p = 4) are read again by the neighbouring tile, mostly
//   from L2.
// * prolongation, the mirror: a block owns a 16 x 64 tile of fine (y, x)
//   outputs and a chunk of fine z planes.  It keeps the coarse planes its
//   planes read (at most 16 x 40 coarse points of each, loaded one plane
//   ahead) in a ring of TRING slots in shared memory, a plane loaded once a
//   fine plane's nonzero taps reach it, and for each fine plane sums the
//   slots of its nonzero taps with their z weights on the coarse tile, runs
//   the y pass onto the fine rows and the x pass onto the fine columns, and
//   writes x (loaded two planes ahead) plus that.  Three barriers a fine
//   plane; four blocks per SM.
//
// Precision: f32 FMAs, the same operators and the same order of the sums as
// the plain version, held to 1e-5 max|plain| by chip_smoke.py.
#include <climits>

#include "common.cuh"

namespace spirk {

constexpr int TT = 256;   // threads of a K10 block
constexpr int TW = TT / 32;
constexpr int TRING = 6;  // ring planes (transfer.py TRANSFER_RING)
constexpr int TCH = 64;   // most planes a block marches (TRANSFER_MAX_CHUNK)

// restriction: the coarse output tile, the most fine rows and columns it
// reads (transfer.py RESTRICT_TILE, RESTRICT_SPAN), the y-pass field's row
// pitch
constexpr int RTY = 16, RTX = 32;
constexpr int RFY = 42, RFX = 80;
constexpr int RGP = 97;
constexpr int RPLANE = RFY * RFX;
constexpr int RLOADS = (RPLANE + TT - 1) / TT;  // a thread's points of the fine tile
constexpr int RYCOLS = (RFX + 31) / 32;  // a lane's fine columns in the y pass
constexpr int ROUT = RTY * RTX / TT;     // a thread's coarse rows in the x pass
static_assert(RTY == 2 * TW, "the y pass: two coarse rows per warp");
static_assert(RTX == 2 * 16 && ROUT == 2, "the x pass: 16 columns of two rows per warp");
static_assert(RGP >= RFX && RGP % 32 == 1, "the x pass's second row on the other banks");

template <int W>
struct RestrictSmem {
  static constexpr int FLOATS = TRING * RPLANE + RTY * RGP + (RTY + RTX + TCH) * W;
  static constexpr int INTS = RTY + RTX + 2 * TCH + 6;
  static constexpr int BYTES = 4 * (FLOATS + INTS);
};

// prolongation: the fine output tile, the most coarse rows and columns it
// reads (PROLONG_TILE, PROLONG_SPAN)
constexpr int PTY = 16, PTX = 64;
constexpr int PCY = 16, PCX = 40;
constexpr int PC = PCY * PCX;
constexpr int PROWS = TT / PTX;  // rows between a thread's points
constexpr int PPTS = PTY / PROWS;
constexpr int PCLOADS = (PC + TT - 1) / TT;
constexpr int PYLOADS = (PTY * PCX + TT - 1) / TT;
static_assert(PTX % 32 == 0, "the x pass: a warp on one fine row");

struct TransferArgs {
  const float* fine;    // restriction rl, prolongation x
  const float* other;   // restriction ax, prolongation xc
  float* out;           // rc, x'
  const int* start;     // the runs' first columns
  const float* w;       // the runs' weights, W per row
  int mf, mc, chunk;
};

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// T consecutive rows' run tables from row r0 on (n of them inside the
// matrix; T <= 64): rel[r] = start[r0 + r] - origin (0 past the n rows), the
// weights (zeros past them), and org = (origin, span), the least start and
// the most start + W - origin over the n rows, computed by warp `warp`.
template <int W, int T>
__device__ __forceinline__ void tile_runs(int* rel, float* wt, int* org, const int* start,
                                          const float* w, int r0, int n, int warp) {
  if (threadIdx.x / 32 == warp) {
    const int l = threadIdx.x % 32;
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = l; r < n; r += 32) {
      const int s = __ldg(start + r0 + r);
      lo = min(lo, s);
      hi = max(hi, s + W);
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    for (int r = l; r < T; r += 32) rel[r] = r < n ? __ldg(start + r0 + r) - lo : 0;
    if (l == 0) {
      org[0] = lo;
      org[1] = hi - lo;
    }
  }
  for (int i = threadIdx.x; i < T * W; i += TT)
    wt[i] = i / W < n ? __ldg(w + (long long)(r0 + i / W) * W + i % W) : 0.f;
}

template <int W>
__global__ void __launch_bounds__(TT, 2) transfer_restrict_kernel(TransferArgs g) {
  extern __shared__ float smem[];
  float* S = smem;                // the ring: open coarse planes' z sums on the fine tile
  float* G = S + TRING * RPLANE;  // a closed plane after the y pass
  float* wy = G + RTY * RGP;      // the tile's y and x runs and the chunk's z runs
  float* wx = wy + RTY * W;
  float* wz = wx + RTX * W;
  int* sy = reinterpret_cast<int*>(wz + TCH * W);
  int* sx = sy + RTY;
  int* sz = sx + RTX;
  int* ez = sz + TCH;  // where each coarse plane's sum closes: its last nonzero tap
  int* org = ez + TCH;
  const int tid = threadIdx.x, warp = tid / 32, l32 = tid % 32, mf = g.mf, mc = g.mc;
  const int Y0 = blockIdx.y * RTY, X0 = blockIdx.x * RTX;
  const int nch = (mc + g.chunk - 1) / g.chunk;
  const int lane = blockIdx.z / nch, J0 = blockIdx.z % nch * g.chunk;
  const int nJ = min(g.chunk, mc - J0);
  tile_runs<W, RTY>(sy, wy, org, g.start, g.w, Y0, min(RTY, mc - Y0), 0);
  tile_runs<W, RTX>(sx, wx, org + 2, g.start, g.w, X0, min(RTX, mc - X0), 1);
  tile_runs<W, TCH>(sz, wz, org + 4, g.start, g.w, J0, nJ, 2);
  __syncthreads();
  if (warp == 3) {  // the fine planes the chunk reads end past its last nonzero tap
    int last = 0;
    for (int j = l32; j < nJ; j += 32) {
      int e = sz[j];
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (wz[j * W + k] != 0.f) e = sz[j] + k;
      ez[j] = e;
      last = max(last, e + 1);
    }
    last = warp_max(last);
    if (l32 == 0) org[5] = last;
  }
  // this thread's points of the fine tile (idx < RPLANE), cleared in every slot
#pragma unroll
  for (int s = 0; s < TRING; ++s)
#pragma unroll
    for (int t = 0; t < RLOADS; ++t) {
      const int idx = tid + t * TT;
      if (t + 1 < RLOADS || idx < RPLANE) S[s * RPLANE + idx] = 0.f;
    }
  __syncthreads();
  const int fy0 = org[0], ny = org[1], fx0 = org[2], nx = org[3], fz0 = org[4];
  const int fz1 = fz0 + org[5];
  const int nY = min(RTY, mc - Y0), nX = min(RTX, mc - X0);
  // the points' offsets in a global plane, -1 outside the field or the span
  const long long plane = (long long)mf * mf;
  const float* rl = g.fine + (long long)lane * mf * plane;
  const float* ax = g.other + (long long)lane * mf * plane;
  int goff[RLOADS];
#pragma unroll
  for (int t = 0; t < RLOADS; ++t) {
    const int idx = tid + t * TT, r = idx / RFX, c = idx % RFX;
    const bool in = r < ny && c < nx && fy0 + r < mf && fx0 + c < mf;
    goff[t] = in ? (fy0 + r) * mf + fx0 + c : -1;
  }
  float nr[RLOADS], na[RLOADS];  // rl and ax of the next fine plane
  auto load = [&](int z) {
#pragma unroll
    for (int t = 0; t < RLOADS; ++t) {
      nr[t] = goff[t] >= 0 ? __ldg(rl + z * plane + goff[t]) : 0.f;
      na[t] = goff[t] >= 0 ? __ldg(ax + z * plane + goff[t]) : 0.f;
    }
  };
  // the x pass's point: coarse column xX, rows xY + 8 o; its weights
  const int xX = l32 % 16 + 16 * (warp % 2), xY = 2 * (warp / 2) + l32 / 16;
  float wxr[W];
#pragma unroll
  for (int k = 0; k < W; ++k) wxr[k] = wx[xX * W + k];
  const int sxX = sx[xX];
  float* const rc = g.out + (((long long)lane * mc) * mc + Y0 + xY) * mc + X0 + xX;
  // the ring: slot s sums coarse plane J0 + jj[s] (s, then every TRING on)
  int jj[TRING];
#pragma unroll
  for (int s = 0; s < TRING; ++s) jj[s] = s;
  if (fz0 < fz1) load(fz0);
  for (int z = fz0; z < fz1; ++z) {
    float res[RLOADS];
#pragma unroll
    for (int t = 0; t < RLOADS; ++t) res[t] = nr[t] - na[t];
    if (z + 1 < fz1) load(z + 1);
    const int zr = z - fz0;
    // z pass: the open planes' sums at this thread's points, fine planes in order
#pragma unroll
    for (int s = 0; s < TRING; ++s) {
      const int j = jj[s], k = j < nJ ? zr - sz[j] : -1;
      const float w = k >= 0 && k < W ? wz[j * W + k] : 0.f;
      if (w != 0.f) {  // the block's weight: a uniform branch
        float* a = S + s * RPLANE + tid;
#pragma unroll
        for (int t = 0; t < RLOADS; ++t)
          if (t + 1 < RLOADS || tid + t * TT < RPLANE) a[t * TT] = fmaf(w, res[t], a[t * TT]);
      }
    }
#pragma unroll
    for (int s = 0; s < TRING; ++s) {
      const int j = jj[s];
      if (j < nJ && zr == ez[j]) {  // the plane's last fine plane
        __syncthreads();  // every thread's sums in
        const float* F = S + s * RPLANE;
        // y pass: G[Y][c] = sum_k wy[Y][k] F[sy[Y] + k][c], a warp on rows 2w, 2w + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int Y = 2 * warp + h;
          float wr[W];
#pragma unroll
          for (int k = 0; k < W; ++k) wr[k] = wy[Y * W + k];
          const float* f = F + sy[Y] * RFX + l32;
          float sum[RYCOLS];
#pragma unroll
          for (int c = 0; c < RYCOLS; ++c) sum[c] = 0.f;
#pragma unroll
          for (int k = 0; k < W; ++k) {
            if (wr[k] != 0.f) {  // the warp's row: a uniform branch past the run's zeros
#pragma unroll
              for (int c = 0; c < RYCOLS; ++c)
                if (l32 + 32 * c < RFX) sum[c] = fmaf(wr[k], f[k * RFX + 32 * c], sum[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < RYCOLS; ++c)
            if (l32 + 32 * c < nx) G[Y * RGP + l32 + 32 * c] = sum[c];
        }
        __syncthreads();  // G in; the slot read
        if (xX < nX) {
#pragma unroll
          for (int o = 0; o < ROUT; ++o) {
            const float* gr = G + (xY + 8 * o) * RGP + sxX;
            float sum = 0.f;
#pragma unroll
            for (int k = 0; k < W; ++k) sum = fmaf(wxr[k], gr[k], sum);
            if (xY + 8 * o < nY) rc[(J0 + j) * (long long)mc * mc + 8 * o * mc] = sum;
          }
        }
        float* a = S + s * RPLANE + tid;
#pragma unroll
        for (int t = 0; t < RLOADS; ++t)
          if (t + 1 < RLOADS || tid + t * TT < RPLANE) a[t * TT] = 0.f;
        jj[s] = j + TRING;
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(TT, 4) transfer_prolong_kernel(TransferArgs g) {
  __shared__ float C[TRING * PC];  // the ring of coarse planes' tile rows and columns
  __shared__ float T[PC];          // a fine plane's z pass on the coarse tile
  __shared__ float H[PTY * PCX];   // then its y pass
  __shared__ float wy[PTY * W], wx[PTX * W];
  __shared__ int sy[PTY], sx[PTX], org[4];
  const int tid = threadIdx.x, mf = g.mf, mc = g.mc;
  const int y0 = blockIdx.y * PTY, x0 = blockIdx.x * PTX;
  const int nch = (mf + g.chunk - 1) / g.chunk;
  const int lane = blockIdx.z / nch, i0 = blockIdx.z % nch * g.chunk;
  const int i1 = min(i0 + g.chunk, mf);
  const int nY = min(PTY, mf - y0), nX = min(PTX, mf - x0);
  tile_runs<W, PTY>(sy, wy, org, g.start, g.w, y0, nY, 0);
  tile_runs<W, PTX>(sx, wx, org + 2, g.start, g.w, x0, nX, 1);
  // the coarse planes the chunk's fine planes read
  int a0 = INT_MAX, a1 = 0;
  for (int i = i0; i < i1; ++i) {
    const int s = __ldg(g.start + i);
    a0 = min(a0, s);
    a1 = max(a1, s + W);
  }
  a1 = min(a1, mc);
  __syncthreads();
  const int cy0 = org[0], ncy = org[1], cx0 = org[2], ncx = org[3];
  const float* xc = g.other + (long long)lane * mc * mc * mc;
  const long long fplane = (long long)mf * mf;
  const int fx = tid % PTX, fyb = tid / PTX;
  const long long fbase = (long long)lane * mf * fplane + (long long)(y0 + fyb) * mf + x0 + fx;
  const float* xf = g.fine + fbase;
  float* outf = g.out + fbase;
  float wxr[W];
#pragma unroll
  for (int k = 0; k < W; ++k) wxr[k] = wx[fx * W + k];
  const int sxf = sx[fx];
  float cpf[PCLOADS];  // the next coarse plane's tile
  auto issue_c = [&](int a) {
#pragma unroll
    for (int s = 0; s < PCLOADS; ++s) {
      const int idx = tid + s * TT, r = idx / PCX, c = idx % PCX;
      const bool in = r < ncy && c < ncx && cy0 + r < mc && cx0 + c < mc;
      cpf[s] = in ? __ldg(xc + ((long long)a * mc + cy0 + r) * mc + cx0 + c) : 0.f;
    }
  };
  float xn[PPTS], xn2[PPTS];  // x of the next two fine planes
  auto issue_x = [&](float(&dst)[PPTS], int i) {
#pragma unroll
    for (int o = 0; o < PPTS; ++o) {
      const bool in = fyb + PROWS * o < nY && fx < nX;
      dst[o] = in ? __ldg(xf + i * fplane + (long long)PROWS * o * mf) : 0.f;
    }
  };
  int loaded = a0, need = 0;
  if (a0 < a1) issue_c(a0);
  if (i0 < i1) issue_x(xn, i0);
  if (i0 + 1 < i1) issue_x(xn2, i0 + 1);
  for (int i = i0; i < i1; ++i) {
    const int si = __ldg(g.start + i);
    float wzr[W];
    int e = si;  // the run's last nonzero tap
#pragma unroll
    for (int k = 0; k < W; ++k) {
      wzr[k] = __ldg(g.w + (long long)i * W + k);
      if (wzr[k] != 0.f) e = si + k;
    }
    need = max(need, e + 1);
    while (loaded < need) {  // coarse plane `loaded` into its slot
      float* c = C + (loaded - a0) % TRING * PC;
#pragma unroll
      for (int s = 0; s < PCLOADS; ++s) {
        const int idx = tid + s * TT;
        if (s + 1 < PCLOADS || idx < PC) c[idx] = cpf[s];
      }
      if (loaded + 1 < a1) issue_c(loaded + 1);
      ++loaded;
    }
    __syncthreads();  // the run's slots in; the last plane's y pass has read T
    // z pass on the coarse tile: T = sum_k w_k C[slot of si + k] over the run's
    // nonzero taps (the plane's: uniform branches)
#pragma unroll
    for (int s = 0; s < PCLOADS; ++s) {
      const int idx = tid + s * TT;
      if (s + 1 < PCLOADS || idx < PC) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (wzr[k] != 0.f) sum = fmaf(wzr[k], C[(si + k - a0) % TRING * PC + idx], sum);
        T[idx] = sum;
      }
    }
    __syncthreads();  // T in; the last plane's x pass has read H
    // y pass onto the fine rows: H[fy][c] = sum_k wy[fy][k] T[sy[fy] + k][c]
#pragma unroll
    for (int s = 0; s < PYLOADS; ++s) {
      const int idx = tid + s * TT, fy = idx / PCX, c = idx % PCX;
      if (s + 1 < PYLOADS || idx < PTY * PCX) {
        const float* tc = T + sy[fy] * PCX + c;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < W; ++k) sum = fmaf(wy[fy * W + k], tc[k * PCX], sum);
        H[idx] = sum;
      }
    }
    __syncthreads();  // H in
    float xv[PPTS];
#pragma unroll
    for (int o = 0; o < PPTS; ++o) {
      xv[o] = xn[o];
      xn[o] = xn2[o];
    }
    if (i + 2 < i1) issue_x(xn2, i + 2);
    // x pass onto the fine columns, plus x
#pragma unroll
    for (int o = 0; o < PPTS; ++o) {
      const int fy = fyb + PROWS * o;
      const float* hr = H + fy * PCX + sxf;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) sum = fmaf(wxr[k], hr[k], sum);
      if (fy < nY && fx < nX) outf[i * fplane + (long long)PROWS * o * mf] = xv[o] + sum;
    }
  }
}

template <int W>
cudaError_t launch_restrict(const TransferArgs& g, int q, cudaStream_t s) {
  if (g.chunk > TCH) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(transfer_restrict_kernel<W>, RestrictSmem<W>::BYTES);
  if (err != cudaSuccess) return err;
  const int nch = (g.mc + g.chunk - 1) / g.chunk;
  dim3 grid((g.mc + RTX - 1) / RTX, (g.mc + RTY - 1) / RTY, q * nch);
  transfer_restrict_kernel<W><<<grid, TT, RestrictSmem<W>::BYTES, s>>>(g);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_prolong(const TransferArgs& g, int q, cudaStream_t s) {
  const int nch = (g.mf + g.chunk - 1) / g.chunk;
  dim3 grid((g.mf + PTX - 1) / PTX, (g.mf + PTY - 1) / PTY, q * nch);
  transfer_prolong_kernel<W><<<grid, TT, 0, s>>>(g);
  return cudaGetLastError();
}

}  // namespace spirk

// rl, ax -> rc; the run tables of P^T (m_c rows of `width`); q lanes; the
// coarse planes per block
extern "C" int spirk_transfer_restrict(const float* rl, const float* ax, float* rc,
                                       const int* start, const float* w, int q, int mf, int mc,
                                       int width, int chunk, void* stream) {
  if (q < 1 || mf < 1 || mc < 1 || chunk < 1) return cudaErrorInvalidValue;
  const spirk::TransferArgs g{rl, ax, rc, start, w, mf, mc, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 3: return spirk::launch_restrict<3>(g, q, s);
    case 7: return spirk::launch_restrict<7>(g, q, s);
    case 11: return spirk::launch_restrict<11>(g, q, s);
    case 15: return spirk::launch_restrict<15>(g, q, s);
    default: return cudaErrorInvalidValue;
  }
}

// x, xc -> x'; the run tables of P (m_f rows of `width`); q lanes; the fine
// planes per block
extern "C" int spirk_transfer_prolong(const float* x, const float* xc, float* out,
                                      const int* start, const float* w, int q, int mf, int mc,
                                      int width, int chunk, void* stream) {
  if (q < 1 || mf < 1 || mc < 1 || chunk < 1) return cudaErrorInvalidValue;
  const spirk::TransferArgs g{x, xc, out, start, w, mf, mc, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 2: return spirk::launch_prolong<2>(g, q, s);
    case 3: return spirk::launch_prolong<3>(g, q, s);
    case 4: return spirk::launch_prolong<4>(g, q, s);
    case 5: return spirk::launch_prolong<5>(g, q, s);
    default: return cudaErrorInvalidValue;
  }
}
