// K3 / K3dg: one Chebyshev smoother step per stage i of a (q, m, m, m) block,
//   r' = r - (a_i M + b K) d;  d' = c1_i d + c2_i D^-1 r';  x' = x + d'.
//
// K3 (spirk_cheb_iter) reads D^-1 as a field.  It replaces the Pallas
// kernel of fused_cheb_iter_canon (dealii_spirk_tpu/ops/pallas/stencil.py,
// _make_kernel_cheb_3d with canon=True and _make_kernel_cheb_3d_canon_yb,
// invd variant).
//
// K3dg (spirk_cheb_iter_dg) rebuilds the Jacobi diagonal per point from
// the level's 1D mass/stiffness diagonals instead,
//   diag = (a zm ym + b (zk ym + zm yk)) xm + b zm ym xk,
// and divides by it, so the D^-1 field is never read.  It replaces
// _fused_cheb_canon_dg (the same file, diag=True kernels, _dg_z).
//
// K9c / K9d (spirk_cheb_iter_halo, spirk_cheb_iter_dg_halo) are K3 / K3dg on
// one z slab of a space-sharded block (ZSlab, common.cuh): only d, the
// operand of the apply, is (q, nzl + 2p, m, m) with p planes of each z
// neighbour; r, x, D^-1 and the three outputs are the slab's (q, nzl, m, m),
// and K9d reads the 1D diagonals at the slab's global rows z_off + k.  They
// replace sharded_cheb_iter_canon (dealii_spirk_tpu/ops/pallas/sharded.py:
// fused_cheb_iter_canon with halo_z=True, with and without diag_tables) and
// equal the whole-field kernels bit for bit.
//
// Bound on the H100: DRAM.  K3dg moves 6 field passes per point (d, r, x
// in; r', d', x' out; the 1D factors are 2m floats, served from L1/L2), K3
// 7 (D^-1 too), against about 60 flops per point at p = 1.
//
// K3dg and K9d: the z-marching design (cheb_dg_march).  One block owns one
// stage's 16 x 64 (y, x) tile and marches over a chunk of z planes (at
// most 16; the wrapper picks the chunk per launch so that a launch has at
// least two blocks per SM where the field allows, ops/cuda/stencil.py::
// march_plan).  It keeps a ring of 2p + 2 haloed d planes in shared
// memory: the 2p + 1 that the z pass of the current plane reads and the
// next one, which cp.async copies in while the block computes the current
// plane, together with that plane's r and x.  So each d plane is read once
// per tile column (plus p planes at each chunk end), where the 8 x 8 x 32
// tiles of cheb_iter_kernel stage 1.66x the points they write, and no block waits on its own
// loads before it computes.  The copies are 4-byte cp.async: a row of a
// field is m * 4 bytes (1020 at m = 255), so neither TMA nor 16-byte copies
// fit the compact layout.  The domain halo is the zero-fill form (source
// size 0), so the loader has no masked branch.  Per plane: the z pass over
// the haloed plane, the y pass over the tile rows and the haloed x extent,
// the x pass and the update per output point (rn / diag in IEEE division).
// The y and x passes sum the stiffness taps apart from the mass taps and
// add the two sums, the plain version's order: one accumulator for both
// (cheb_iter_kernel's order) left K3dg's r' on a smooth field at P4's 255 level with a mean error
// against f64 ten times the f32 plain version's (chip_smoke.py::
// smooth_bias), the rounding K5-2D had (common.cuh::mass_stiff_x2).
// The coefficients come by pointer (a, c1, c2, (q,) each) and by value
// (b): a launch is one device op.
//
// K3 and K9c stay on the tile design (cheb_iter_kernel: one block per stage
// and 8 x 8 x 32 tile, the haloed tile staged synchronously, w a (q, 4)
// table), the next candidates for the z-marching loop.
#include "common.cuh"

namespace spirk {

// ---------------------------------------------------------------------------
// K3, K9c: one block per (stage, 8 x 8 x 32 tile); w (q, 4) per-stage
// [a, b, c1, c2]; invd the (q, m, m, m) D^-1 field (the slab's rows for K9c)
// ---------------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(NTHREADS)
cheb_iter_kernel(const float* __restrict__ d, const float* __restrict__ r,
                 const float* __restrict__ x, const float* __restrict__ invd,
                 float* __restrict__ r_out, float* __restrict__ d_out,
                 float* __restrict__ x_out, const float* __restrict__ mband,
                 const float* __restrict__ kband, const float* __restrict__ w, int m,
                 ZSlab zs) {
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
  const float a = w[4 * iq], b = w[4 * iq + 1];
  const float c1 = w[4 * iq + 2], c2 = w[4 * iq + 3];

  Bands<P> bd = load_bands<P>(bands, mband, kband, m, zs, z0, y0, x0);
  load_tile<P>(in, d + iq * zs.in_stride(m), m, zs, z0, y0, x0);
  __syncthreads();
  shifted_zy<P>(in, E, F, C, D, bd, a, b);
#pragma unroll
  for (int s = 0; s < T::PTS; ++s) {
    int lz, ly, lx;
    out_point(s, lz, ly, lx);
    int gz = z0 + lz, gy = y0 + ly, gx = x0 + lx;
    if (gz < zs.nz && gy < m && gx < m) {
      long long g = stage + ((long long)gz * m + gy) * m + gx;
      float ad = shifted_x<P>(C, D, bd, lz, ly, lx);
      float rn = r[g] - ad;
      float dc = in[((lz + P) * T::HY + ly + P) * T::HX + lx + P];
      float dn = c1 * dc + c2 * (invd[g] * rn);
      r_out[g] = rn;
      d_out[g] = dn;
      x_out[g] = x[g] + dn;
    }
  }
}

template <int P>
cudaError_t launch_cheb_iter(const float* d, const float* r, const float* x,
                             const float* invd, float* r_out, float* d_out, float* x_out,
                             const float* mband, const float* kband, const float* w, int q,
                             int m, ZSlab zs, cudaStream_t stream) {
  const int bytes = Tile<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(cheb_iter_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  cheb_iter_kernel<P><<<tile_grid(m, zs.nz, q), NTHREADS, bytes, stream>>>(
      d, r, x, invd, r_out, d_out, x_out, mband, kband, w, m, zs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3dg, K9d: the z-marching step
// ---------------------------------------------------------------------------
constexpr int MX = 64;   // output tile along x
constexpr int MY = 16;   // output tile along y
constexpr int MZC = 16;  // most z planes one block marches (stencil.py MARCH_MAX_CHUNK)
constexpr int MOUT = MY * MX / NTHREADS;  // output points of a thread per plane
constexpr int MROWS = NTHREADS / MX;      // tile rows between a thread's points
static_assert(NTHREADS % MX == 0 && MY % MROWS == 0, "threads must tile the plane");

template <int P>
struct March {
  static constexpr int NB = 2 * P + 1;
  static constexpr int HX = MX + 2 * P;  // haloed extents
  static constexpr int HY = MY + 2 * P;
  static constexpr int PLANE = HY * HX;  // one haloed plane of d
  static constexpr int RING = 2 * P + 2;  // planes z - p .. z + p and the next one
  static constexpr int LOADS = (PLANE + NTHREADS - 1) / NTHREADS;  // a plane's copies per thread
  static constexpr int YP = MY * HX;      // one field after the y pass
  static constexpr int RX = 2 * 2 * MOUT * NTHREADS;  // r and x of two planes
  static constexpr int ZW = 2 * NB * MZC;  // z band rows of a chunk
  static constexpr int YW = 2 * NB * MY;   // y band rows of the tile
  // shared floats: the ring, the z-pass fields E, F, the y-pass fields C, D,
  // r and x, the band rows, the 1D diagonals at the chunk's z and the tile's
  // y rows
  static constexpr int SMEM_FLOATS =
      RING * PLANE + 2 * PLANE + 2 * YP + RX + ZW + YW + 2 * MZC + 2 * MY;
  static_assert(SMEM_FLOATS * 4 <= 232448, "the march does not fit a block's shared memory");
  // resident blocks per SM that the shared memory allows (228 KB, 1 KB of
  // it reserved per block), and so the register budget ptxas is held to
  static constexpr int BLOCKS = 233472 / (SMEM_FLOATS * 4 + 1024) < 4
                                    ? 233472 / (SMEM_FLOATS * 4 + 1024)
                                    : 4;
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

// av, c1v, c2v: (q,) per-stage coefficients; mdiag, kdiag: the level's (m,)
// 1D diagonals; grid (ceil(m / MX), ceil(m / MY), q * ceil(zs.nz / chunk))
template <int P>
__global__ void __launch_bounds__(NTHREADS, March<P>::BLOCKS)
cheb_dg_march(const float* __restrict__ d, const float* __restrict__ r,
              const float* __restrict__ x, const float* __restrict__ mdiag,
              const float* __restrict__ kdiag, float* __restrict__ r_out,
              float* __restrict__ d_out, float* __restrict__ x_out,
              const float* __restrict__ mband, const float* __restrict__ kband,
              const float* __restrict__ av, float b, const float* __restrict__ c1v,
              const float* __restrict__ c2v, int m, ZSlab zs, int chunk) {
  using G = March<P>;
  constexpr int NB = G::NB, HX = G::HX, PLANE = G::PLANE, RING = G::RING;
  extern __shared__ float smem[];
  float* ring = smem;                    // [RING][HY][HX]
  float* E = ring + RING * PLANE;        // [HY][HX]
  float* F = E + PLANE;
  float* C = F + PLANE;                  // [MY][HX]
  float* D = C + G::YP;
  float* rx = D + G::YP;                 // [plane & 1][r, x][point][thread]
  float* zw = rx + G::RX;                // [mass, stiff][k][chunk plane]
  float* yw = zw + G::ZW;                // [mass, stiff][k][tile row]
  float* zdg = yw + G::YW;               // [mass, stiff][chunk plane]
  float* ydg = zdg + 2 * MZC;            // [mass, stiff][tile row]

  const int tid = threadIdx.x;
  const int nch = (zs.nz + chunk - 1) / chunk;
  const int iq = blockIdx.z / nch;
  const int z0 = (blockIdx.z % nch) * chunk;
  const int nzc = min(chunk, zs.nz - z0);
  const int y0 = blockIdx.y * MY, x0 = blockIdx.x * MX;
  const float a = av[iq], c1 = c1v[iq], c2 = c2v[iq];
  const long long mm = (long long)m * m;
  const float* dq = d + iq * zs.in_stride(m);
  const long long oq = iq * zs.out_stride(m);
  const int nz_in = zs.nz + 2 * zs.halo;

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

  // d's plane j of the chunk (operand plane z0 + j + halo; zeros beyond the
  // operand) into ring slot (j + p) % RING
  auto load_d = [&](int j) {
    const int gz = z0 + j + zs.halo;
    const bool zin = gz >= 0 && gz < nz_in;
    const float* src = dq + (zin ? gz : 0) * mm;
    float* dst = ring + ((j + P) % RING) * PLANE;
#pragma unroll
    for (int s = 0; s < G::LOADS; ++s) {
      const int i = tid + s * NTHREADS;
      if (s + 1 < G::LOADS || i < PLANE)
        cp_async4(dst + i, src + max(goff[s], 0), zin && goff[s] >= 0);
    }
  };
  // r and x at this thread's points of plane j into buffer j & 1
  auto load_rx = [&](int j) {
    const long long base = oq + (long long)(z0 + j) * mm;
    float* dst = rx + (j & 1) * 2 * MOUT * NTHREADS;
#pragma unroll
    for (int s = 0; s < MOUT; ++s) {
      const int gy = y0 + orow + s * MROWS;
      const bool in = gy < m && gx < m;
      const long long g = in ? base + (long long)gy * m + gx : 0;
      cp_async4(dst + s * NTHREADS + tid, r + g, in);
      cp_async4(dst + (MOUT + s) * NTHREADS + tid, x + g, in);
    }
  };

  // prologue: planes -p .. p of d and r, x of plane 0 in flight, then the
  // band rows and diagonals of the chunk and tile
  for (int j = -P; j <= P; ++j) load_d(j);
  load_rx(0);
  cp_async_commit();
  load_band_rows<MZC>(zw, mband, kband, NB, m, zs.z_off + z0);
  load_band_rows<MY>(yw, mband, kband, NB, m, y0);
  for (int i = tid; i < 2 * MZC; i += NTHREADS) {
    const int g = zs.z_off + z0 + i % MZC;
    zdg[i] = g < m ? __ldg((i < MZC ? mdiag : kdiag) + g) : 0.f;
  }
  for (int i = tid; i < 2 * MY; i += NTHREADS) {
    const int g = y0 + i % MY;
    ydg[i] = g < m ? __ldg((i < MY ? mdiag : kdiag) + g) : 0.f;
  }
  float xwm[NB], xwk[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    xwm[k] = gx < m ? __ldg(mband + k * m + gx) : 0.f;
    xwk[k] = gx < m ? __ldg(kband + k * m + gx) : 0.f;
  }
  const float xdm = gx < m ? __ldg(mdiag + gx) : 0.f;
  const float xdk = gx < m ? __ldg(kdiag + gx) : 0.f;

  for (int k = 0; k < nzc; ++k) {
    cp_async_wait_all();
    __syncthreads();  // plane k's copies are in; every thread left plane k - 1
    if (k + 1 < nzc) {
      load_d(k + 1 + P);
      load_rx(k + 1);
    }
    cp_async_commit();

    // z pass over the haloed plane: E = a Zm d + b Zk d, F = b Zm d
    const float* pl[NB];
    float wzm[NB], wzk[NB];
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      pl[kk] = ring + ((k + kk) % RING) * PLANE;  // plane k - p + kk
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
        E[i] = a * zm + b * zk;
        F[i] = b * zm;
      }
    }
    __syncthreads();
    // y pass over the tile rows and the haloed x extent: C = My E + Ky F,
    // D = My F, the stiffness taps Ky F summed apart from the mass taps
    for (int i = tid; i < G::YP; i += NTHREADS) {
      const int ly = i / HX;
      float cm = 0.f, ck = 0.f, dd = 0.f;
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const int j = i + kk * HX;
        const float e = E[j], f = F[j];
        const float wm = yw[kk * MY + ly], wk = yw[(NB + kk) * MY + ly];
        cm = fmaf(wm, e, cm);
        ck = fmaf(wk, f, ck);
        dd = fmaf(wm, f, dd);
      }
      C[i] = cm + ck;
      D[i] = dd;
    }
    __syncthreads();
    // x pass and the update at this thread's points
    const float zdm = zdg[k], zdk = zdg[MZC + k];
    const float* centre = ring + ((k + P) % RING) * PLANE + P * HX + P;
    const float* rxk = rx + (k & 1) * 2 * MOUT * NTHREADS + tid;
    const long long base = oq + (long long)(z0 + k) * mm;
#pragma unroll
    for (int s = 0; s < MOUT; ++s) {
      const int ly = orow + s * MROWS, gy = y0 + ly;
      if (gy < m && gx < m) {
        const int c0 = ly * HX + ocol;
        float mx = 0.f, kx = 0.f;  // the mass taps and the stiffness taps apart
#pragma unroll
        for (int kk = 0; kk < NB; ++kk) {
          mx = fmaf(xwm[kk], C[c0 + kk], mx);
          kx = fmaf(xwk[kk], D[c0 + kk], kx);
        }
        const float ad = mx + kx;
        const float rn = rxk[s * NTHREADS] - ad;
        const float ym = ydg[ly], yk = ydg[MY + ly];
        const float zmym = zdm * ym;
        const float z = rn / ((a * zmym + b * (zdk * ym + zdm * yk)) * xdm + (b * zmym) * xdk);
        const float dn = c1 * centre[c0] + c2 * z;
        const long long g = base + (long long)gy * m + gx;
        r_out[g] = rn;
        d_out[g] = dn;
        x_out[g] = rxk[(MOUT + s) * NTHREADS] + dn;
      }
    }
  }
}

template <int P>
cudaError_t launch_cheb_dg(const float* d, const float* r, const float* x,
                           const float* mdiag, const float* kdiag, float* r_out,
                           float* d_out, float* x_out, const float* mband,
                           const float* kband, const float* a, float b, const float* c1,
                           const float* c2, int q, int m, ZSlab zs, int chunk,
                           cudaStream_t stream) {
  const int bytes = March<P>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(cheb_dg_march<P>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + MX - 1) / MX, (m + MY - 1) / MY, q * ((zs.nz + chunk - 1) / chunk));
  cheb_dg_march<P><<<grid, NTHREADS, bytes, stream>>>(
      d, r, x, mdiag, kdiag, r_out, d_out, x_out, mband, kband, a, b, c1, c2, m, zs, chunk);
  return cudaGetLastError();
}

int cheb_iter_entry(const float* d, const float* r, const float* x, const float* invd,
                    float* r_out, float* d_out, float* x_out, const float* mband,
                    const float* kband, const float* w, int q, int m, ZSlab zs, int p,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
#define SPIRK_CASE(P) \
  case P:             \
    return launch_cheb_iter<P>(d, r, x, invd, r_out, d_out, x_out, mband, kband, w, q, m, zs, s);
    SPIRK_CASE(1)
    SPIRK_CASE(2)
    SPIRK_CASE(3)
    SPIRK_CASE(4)
#undef SPIRK_CASE
    default: return cudaErrorInvalidValue;
  }
}

int cheb_dg_entry(const float* d, const float* r, const float* x, const float* mdiag,
                  const float* kdiag, float* r_out, float* d_out, float* x_out,
                  const float* mband, const float* kband, const float* a, float b,
                  const float* c1, const float* c2, int q, int m, ZSlab zs, int chunk, int p,
                  void* stream) {
  if (chunk < 1 || chunk > MZC) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
#define SPIRK_CASE(P)                                                                       \
  case P:                                                                                   \
    return launch_cheb_dg<P>(d, r, x, mdiag, kdiag, r_out, d_out, x_out, mband, kband, a, b, \
                             c1, c2, q, m, zs, chunk, s);
    SPIRK_CASE(1)
    SPIRK_CASE(2)
    SPIRK_CASE(3)
    SPIRK_CASE(4)
#undef SPIRK_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace spirk

extern "C" int spirk_cheb_iter(const float* d, const float* r, const float* x,
                               const float* invd, float* r_out, float* d_out, float* x_out,
                               const float* mband, const float* kband, const float* w, int q,
                               int m, int p, void* stream) {
  return spirk::cheb_iter_entry(d, r, x, invd, r_out, d_out, x_out, mband, kband, w, q, m,
                                spirk::whole_field(m), p, stream);
}

// d: (q, nzl + 2p, m, m); every other field (q, nzl, m, m)
extern "C" int spirk_cheb_iter_halo(const float* d, const float* r, const float* x,
                                    const float* invd, float* r_out, float* d_out,
                                    float* x_out, const float* mband, const float* kband,
                                    const float* w, int q, int m, int nzl, int z_off, int p,
                                    void* stream) {
  return spirk::cheb_iter_entry(d, r, x, invd, r_out, d_out, x_out, mband, kband, w, q, m,
                                spirk::ZSlab{nzl, p, z_off}, p, stream);
}

// a, c1, c2: (q,); chunk: z planes per block, 1..MZC
extern "C" int spirk_cheb_iter_dg(const float* d, const float* r, const float* x,
                                  const float* mdiag, const float* kdiag, float* r_out,
                                  float* d_out, float* x_out, const float* mband,
                                  const float* kband, const float* a, float b, const float* c1,
                                  const float* c2, int q, int m, int chunk, int p,
                                  void* stream) {
  return spirk::cheb_dg_entry(d, r, x, mdiag, kdiag, r_out, d_out, x_out, mband, kband, a, b,
                              c1, c2, q, m, spirk::whole_field(m), chunk, p, stream);
}

// mdiag, kdiag: the level's whole (m,) 1D diagonals
extern "C" int spirk_cheb_iter_dg_halo(const float* d, const float* r, const float* x,
                                       const float* mdiag, const float* kdiag, float* r_out,
                                       float* d_out, float* x_out, const float* mband,
                                       const float* kband, const float* a, float b,
                                       const float* c1, const float* c2, int q, int m, int nzl,
                                       int z_off, int chunk, int p, void* stream) {
  return spirk::cheb_dg_entry(d, r, x, mdiag, kdiag, r_out, d_out, x_out, mband, kband, a, b,
                              c1, c2, q, m, spirk::ZSlab{nzl, p, z_off}, chunk, p, stream);
}
