// Per-shard flag-masked red-black SOR of a 3-D mesh, for Hopper (sm_90a):
// kernel K16.
//
// rb_sor_obsdist3d replaces pampi_tpu/ops/sor_obsdist3d.py
//   _obsdist3d_kernel (make_rb_iters_obsdist_3d): n red-black iterations,
//   each with the globally gated 6-face homogeneous-Neumann refresh, on one
//   shard's (kl+2H, jl+2H, il+2H) deep block p (H = 2n), with
//   per-direction fluid coefficients formed from the shard's uint8 deep
//   flag block. It reads p and writes the new block into out. It is K15
//   (sor_obsdist.cu) one dimension up, with K14's three offsets.
//
// Deep cell (a, b, c) is global extended cell
//   (gk, gj, gi) = (a - H + koff + 1, b - H + joff + 1, c - H + ioff + 1),
// where (koff, joff, ioff) are the shard's global offsets, passed as
// arguments (the TPU kernel takes them by scalar prefetch). What each cell
// does follows from that position alone:
//   - update when it lies off the block's outermost shell (which stays
//     frozen: its neighbours are not stored), in the global interior, in
//     the colour (gi + gj + gk) mod 2 of the half-sweep (odd first), and
//     is fluid;
//   - the six wall selects, gated by global position and clipped
//     tangentially to the global interior, off the frozen shell;
//   - count r^2 of the LAST iteration when it lies in the shard's owned
//     region (ghost cells are the neighbours' cells, recomputed here).
// pampi_tpu_torch/ops/sor_obsdist3d.obsdist3d_masks holds the same
// formulas; keep the two in lockstep.
//
// Coefficients (sor3d_pallas.masked_stencil_ops_3d): eps_* are the six
// neighbours' flags,
//   denom = (eps_e + eps_w)*idx2 + (eps_n + eps_s)*idy2 + (eps_b + eps_f)*idz2,
//   fac   = (denom > 0 ? omega/denom : 0) * flag,
//   r     = rhs - ((eps_e*(e - c) + eps_w*(w - c))*idx2
//                  + (eps_n*(n - c) + eps_s*(s - c))*idy2
//                  + (eps_b*(b - c) + eps_f*(f - c))*idz2),
//   p     = c - fac*r,
// the masked mode of K5 (sor3d_rb.cu) term for term. Built with
// --fmad=false, so no multiply-add is contracted and the kernel equals its
// plain version bit for bit.
//
// What bounds it on the H100: memory bandwidth at the least (~30 flops per
// cell update). The least any implementation moves per call is p, rhs and
// the flags read once and p written once: 13 bytes a cell at float32, 142
// MB for a (128, 128, 512) shard at n = 4 (a 144x144x528 deep block), ~42
// us at 3.35 TB/s.
//
// Design: temporal blocking in shared memory, as the TPU kernel streams
// slabs of planes through VMEM. The block's (j, i) plane is cut into owned
// tiles, and k into a few slabs where the tiles alone leave SMs idle
// (ops/sor_obsdist3d.obsdist3d_tiles); the tiles partition the block, its
// frozen shell included. A CTA streams its tile's box (the tile and ht =
// 2n + 1 cells a side in j, i and k, clipped to the block: the sweeps
// reach 2n cells in, a wall-ghost cell's copy one more; the box's shell
// stays frozen, so it is a deep block of its own and its owned cells come
// out exactly as the block's) through a ring of 2n + 2 planes of p, rhs
// and the flags in shared memory, one plane a step, the next plane's loads
// in flight in registers. The 2n colour stages of the n iterations advance
// as a wavefront, stage s on the plane s + 1 behind the newest (odd colour
// first): a colour's cells read only the other colour's, whose newer state
// lies on the planes ahead and whose older state no stage needs, so the
// ring is updated in place. After each even-colour stage the j/i wall
// selects run on its plane, and the k-face selects (planes gk = 0 and
// kmax+1, from gk = 1 and kmax) when that plane is gk = 1 or kmax; they
// need no barrier before the next stage, which reads only interior cells
// of that plane. A plane leaves the ring for out when its slot is
// reloaded (its last write came a step earlier).
//
// Each thread owns one column pair (rows 2m and 2m + 1 at column b) of
// every plane of the box: it loads it, updates it in both colours (the
// pair holds one cell of each, and in one step every stage takes the same
// row, as the plane's parity and the colour change together, so
// neighbouring lanes read neighbouring words, on other banks), keeps the
// relaxation factors of its cells on the 2n planes in flight in registers
// (formed once a plane, not once a sweep; n is a template parameter, so
// the window is indexed statically) and writes the pair out. A cell whose
// own flag and six neighbours' are all 1 (every fluid cell off an
// obstacle) skips the eps products: eps*d is d for eps = 1, so the result
// is the same bits. The residual keeps masked K5's fixed order: on the
// last iteration each owned cell writes its r^2
// (0 on an obstacle) into an owned-sized buffer, row_sums sums each (k, j)
// row from the low i up (32 rows a block staged through shared memory, so
// its loads coalesce), and one block sums the rows as sum_partials does.
// No float atomics, so the residual and every iteration count are
// reproducible, and on a one-shard mesh it equals masked K5's bitwise.
// Three launches a call; a call of n > 5 runs as passes of at most 5 (the
// ring outgrows shared memory), each with its residual launches skipped
// but the last's. What bounds it now: the issue rate of the stages'
// instructions over the halo's share of the cells each CTA streams (3.2x
// the owned cells at the timed shape: 32x64 boxes, one CTA an SM), with
// 2n + 2 barriers a plane.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TX = 32;
constexpr int FIN = 1024;

struct Geom {
  int ek, ej, ei;          // stored deep block: l + 2H per axis
  int kl, jl, il;          // owned extents
  int n, H;                // iterations of this pass, deep-halo depth
  int kmax, jmax, imax;    // global interior extents
  int koff, joff, ioff;    // the shard's global offsets
  int ht;                  // the tiles' halo: 2n + 1 of this pass
  int tk, tj, ti;          // owned tile extents
  int rs;                  // planes in the ring: 2n + 2
  int rows;                // rows of a ring plane (the largest box's j)
  int P, Pf;               // row pitches: p and rhs (elements), flags
};

// N iterations (the ring holds 2N + 2 planes); TY rows of 32 threads: row
// pair m = ty % 16 and column b = tx + 32 * (ty / 16) of every plane of
// the box (rows 2m and 2m + 1) belong to the thread, which loads them,
// updates them in both colours, keeps their relaxation factors of the 2N
// planes in flight in registers and writes them out
template <typename T, int N, int TY>
__global__ void __launch_bounds__(TX * TY, 1)
od3_fused(const T* __restrict__ p, const T* __restrict__ rhs,
          const uint8_t* __restrict__ fl, T* __restrict__ out, Geom g,
          T omega, T idx2, T idy2, T idz2, T* __restrict__ r2) {
  constexpr int RS = 2 * N + 2, NT = TX * TY;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = g.P, Pf = g.Pf;
  const int PS = g.rows * P, PSF = g.rows * Pf;
  T* sp = reinterpret_cast<T*>(smem);
  T* sr = sp + (size_t)RS * PS;
  uint8_t* sf = reinterpret_cast<uint8_t*>(sr + (size_t)RS * PS);
  const int tid = threadIdx.y * TX + threadIdx.x;
  // the owned tile and its box (the tile and ht cells a side, clipped)
  const int k0 = blockIdx.z * g.tk, k1 = min(g.ek, k0 + g.tk);
  const int j0 = blockIdx.y * g.tj, j1 = min(g.ej, j0 + g.tj);
  const int i0 = blockIdx.x * g.ti, i1 = min(g.ei, i0 + g.ti);
  const int bk0 = max(0, k0 - g.ht), KB = min(g.ek, k1 + g.ht) - bk0;
  const int bj0 = max(0, j0 - g.ht), R = min(g.ej, j1 + g.ht) - bj0;
  const int bi0 = max(0, i0 - g.ht), W = min(g.ei, i1 + g.ht) - bi0;
  const size_t SW = g.ei, SP = (size_t)g.ej * g.ei;
  // global index of box cell (0, 0, 0)
  const int gk0 = bk0 - g.H + g.koff + 1, gj0 = bj0 - g.H + g.joff + 1;
  const int gi0 = bi0 - g.H + g.ioff + 1;
  // the cells that update: off the box's frozen shell, global interior
  const int alo = max(1, 1 - gj0), ahi = min(R - 2, g.jmax - gj0);
  const int blo = max(1, 1 - gi0), bhi = min(W - 2, g.imax - gi0);
  const int qlo = max(1, 1 - gk0), qhi = min(KB - 2, g.kmax - gk0);
  // this thread's column pair
  const int a0 = 2 * (threadIdx.y % 16);
  const int b = threadIdx.x + TX * (threadIdx.y / 16);
  const bool mine = b < W;
  const bool ab_upd[2] = {a0 >= alo && a0 <= ahi && b >= blo && b <= bhi,
                          a0 + 1 >= alo && a0 + 1 <= ahi && b >= blo &&
                              b <= bhi};
  // ... and whether its cells are owned by the tile and by the shard
  const bool ab_tile[2] = {
      mine && a0 >= j0 - bj0 && a0 < j1 - bj0 && b >= i0 - bi0 && b < i1 - bi0,
      mine && a0 + 1 >= j0 - bj0 && a0 + 1 < j1 - bj0 && b >= i0 - bi0 &&
          b < i1 - bi0};
  const int dj = bj0 + a0 - g.H, di = bi0 + b - g.H;
  const bool ab_own[2] = {ab_tile[0] && dj >= 0 && dj < g.jl && di >= 0 &&
                              di < g.il,
                          ab_tile[1] && dj + 1 >= 0 && dj + 1 < g.jl &&
                              di >= 0 && di < g.il};
  const int x0 = a0 * P + b, xf0 = a0 * Pf + b;
  // the next plane's two cells, in flight while the stages run
  T vp[2] = {}, vr[2] = {};
  unsigned vf[2] = {};
  auto fetch = [&](int q) {
    const size_t base = (size_t)(bk0 + q) * SP + (size_t)(bj0 + a0) * SW +
                        bi0 + b;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (mine && a0 + r < R) {
        vp[r] = p[base + r * SW];
        vr[r] = rhs[base + r * SW];
        vf[r] = fl[base + r * SW];
      }
  };
  // fac of the thread's cells of the planes z-1 .. z-2N (index s: the
  // plane stage s updates); bit 2s+r of upd: that cell updates, of one:
  // its flag and its six neighbours' are 1 (all eps are 1, and eps*d is d)
  T fac[2 * N][2] = {};
  unsigned upd = 0, one = 0;
  // fac of a fluid cell whose six neighbours are fluid (all flags 1),
  // formed as every cell's is
  const T f1 = T(1u);
  const T denom_one = (f1 + f1) * idx2 + (f1 + f1) * idy2 + (f1 + f1) * idz2;
  const T fac_one = (denom_one > T(0) ? omega / denom_one : T(0)) * f1;
  fetch(0);
  for (int z = 0, zs = 0; z < KB + RS; ++z, zs = zs == RS - 1 ? 0 : zs + 1) {
    // zs = z % RS: the plane z - RS leaves the ring for out, plane z takes
    // its slot
    {
      const int qo = z - RS;
      T* cp = sp + zs * PS;
      const size_t obase = (size_t)(bk0 + qo) * SP + (size_t)(bj0 + a0) * SW +
                           bi0 + b;
      const bool oq = qo >= k0 - bk0 && qo < k1 - bk0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!mine || a0 + r >= R) continue;
        if (oq && ab_tile[r]) out[obase + r * SW] = cp[x0 + r * P];
        if (z < KB) {
          cp[x0 + r * P] = vp[r];
          sr[zs * PS + x0 + r * P] = vr[r];
          sf[zs * PSF + xf0 + r * Pf] = (uint8_t)vf[r];
        }
      }
    }
    if (z + 1 < KB) fetch(z + 1);
    // the window moves one plane: the factors of plane z - 1 enter it
#pragma unroll
    for (int s = 2 * N - 1; s > 0; --s) {
      fac[s][0] = fac[s - 1][0];
      fac[s][1] = fac[s - 1][1];
    }
    upd = (upd << 2) & ((1u << (4 * N)) - 1);
    one = (one << 2) & ((1u << (4 * N)) - 1);
    __syncthreads();
    // ring slots of the planes z - 2, z - 1
    const int s1 = zs == 0 ? RS - 1 : zs - 1, s2 = s1 == 0 ? RS - 1 : s1 - 1;
    if (z - 1 >= qlo && z - 1 <= qhi) {
      const uint8_t* cf = sf + s1 * PSF;
      const uint8_t* cfm = sf + s2 * PSF;
      const uint8_t* cfq = sf + zs * PSF;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int xf = xf0 + r * Pf;
        const unsigned fc = ab_upd[r] ? cf[xf] : 0u;
        if (fc == 0) continue;
        const unsigned fe = cf[xf + 1], fw = cf[xf - 1], fn = cf[xf + Pf],
                       fs = cf[xf - Pf], fb = cfq[xf], ff = cfm[xf];
        upd |= 1u << r;
        if (((fc ^ 1u) | (fe ^ 1u) | (fw ^ 1u) | (fn ^ 1u) | (fs ^ 1u) |
             (fb ^ 1u) | (ff ^ 1u)) == 0) {
          fac[0][r] = fac_one;
          one |= 1u << r;
          continue;
        }
        const T ee = T(fe), ew = T(fw);
        const T en = T(fn), es = T(fs);
        const T eb = T(fb), ef = T(ff);
        const T denom = (ee + ew) * idx2 + (en + es) * idy2 + (eb + ef) * idz2;
        fac[0][r] = (denom > T(0) ? omega / denom : T(0)) * T(fc);
      }
    }
    // the row of the thread's pair that the stages of this step update:
    // the same in every stage, as the plane's parity and the colour change
    // together
    const int rz = (gk0 + z + gj0 + gi0 + a0 + b) & 1;
    const int x = x0 + rz * P, xf = xf0 + rz * Pf;
    const bool own = rz ? ab_own[1] : ab_own[0];
#pragma unroll
    for (int s = 0; s < 2 * N; ++s) {
      // stage s: colour odd (s even) or even (s odd) on plane q = z - 1 - s
      const int q = z - 1 - s;
      const bool on = q >= qlo && q <= qhi;
      int sq = zs - 1 - s;  // ring slots of planes q, q - 1, q + 1
      if (sq < 0) sq += RS;
      const int sm = sq == 0 ? RS - 1 : sq - 1;
      const int sn = sq == RS - 1 ? 0 : sq + 1;
      T* cp = sp + sq * PS;
      if (on) {
        const bool last = s >= 2 * N - 2 && r2 != nullptr && own;
        const int dq = bk0 + q - g.H;
        const bool own_q = last && q >= k0 - bk0 && q < k1 - bk0 && dq >= 0 &&
                           dq < g.kl;
        T rr = T(0);
        if ((upd >> (2 * s + rz)) & 1u) {
          const T* cm = sp + sm * PS;
          const T* cq = sp + sn * PS;
          const T cv = cp[x];
          const T de = cp[x + 1] - cv, dw = cp[x - 1] - cv;
          const T dn = cp[x + P] - cv, ds = cp[x - P] - cv;
          const T db = cq[x] - cv, df = cm[x] - cv;
          T lap;
          if ((one >> (2 * s + rz)) & 1u) {
            lap = (de + dw) * idx2 + (dn + ds) * idy2 + (db + df) * idz2;
          } else {
            const uint8_t* cf = sf + sq * PSF;
            const T ee = T(cf[xf + 1]), ew = T(cf[xf - 1]);
            const T en = T(cf[xf + Pf]), es = T(cf[xf - Pf]);
            const T eb = T(sf[sn * PSF + xf]), ef = T(sf[sm * PSF + xf]);
            lap = (ee * de + ew * dw) * idx2 + (en * dn + es * ds) * idy2 +
                  (eb * db + ef * df) * idz2;
          }
          const T res = sr[sq * PS + x] - lap;
          cp[x] = cv - (rz ? fac[s][1] : fac[s][0]) * res;
          rr = res * res;
        }
        // the last iteration: each owned cell's r^2 (0 on an obstacle)
        if (own_q) r2[((size_t)dq * g.jl + dj + rz) * g.il + di] = rr;
      }
      __syncthreads();
      if (on && (s & 1)) {
        // the wall selects that follow plane q's even stage: the j and i
        // faces on the plane, and the k face gk = 0 (kmax + 1) from gk = 1
        // (kmax); each copies the inward interior neighbour, clipped
        // tangentially to the global interior and off the box's shell
        const int nrow = max(0, bhi - blo + 1), ncol = max(0, ahi - alo + 1);
        for (int u = tid; u < 2 * (nrow + ncol); u += NT) {
          int a, bb, src;
          if (u < 2 * nrow) {
            const int hi = u >= nrow;
            a = hi ? g.jmax + 1 - gj0 : -gj0;
            bb = blo + u - hi * nrow;
            if (a < 1 || a > R - 2) continue;
            src = (hi ? a - 1 : a + 1) * P + bb;
          } else {
            const int v = u - 2 * nrow, hi = v >= ncol;
            bb = hi ? g.imax + 1 - gi0 : -gi0;
            a = alo + v - hi * ncol;
            if (bb < 1 || bb > W - 2) continue;
            src = a * P + (hi ? bb - 1 : bb + 1);
          }
          cp[a * P + bb] = cp[src];
        }
        const int gk = gk0 + q;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int dst = side == 0 ? q - 1 : q + 1;
          if (gk != (side == 0 ? 1 : g.kmax) || dst < 1 || dst > KB - 2)
            continue;
          T* cd = sp + (side == 0 ? sm : sn) * PS;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (ab_upd[r]) cd[x0 + r * P] = cp[x0 + r * P];
        }
      }
    }
    __syncthreads();
  }
}

// out[row] = the sum of the row's n values from the first up: 32 rows a
// block, staged 32 columns at a time through shared memory, lane r of the
// first warp summing row r
template <typename T>
__global__ void row_sums(const T* __restrict__ v, int rows, int n,
                         T* __restrict__ out) {
  __shared__ T sh[32][33];
  const int r0 = blockIdx.x * 32;
  T s = T(0);
  for (int c0 = 0; c0 < n; c0 += 32) {
    for (int rr = threadIdx.y; rr < 32; rr += blockDim.y) {
      const int r = r0 + rr, c = c0 + threadIdx.x;
      sh[rr][threadIdx.x] =
          r < rows && c < n ? v[(size_t)r * n + c] : T(0);
    }
    __syncthreads();
    if (threadIdx.y == 0) {
      const int m = min(32, n - c0);
      for (int c = 0; c < m; ++c) s += sh[threadIdx.x][c];
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && r0 + threadIdx.x < rows) out[r0 + threadIdx.x] = s;
}

// one block: out[0] = sum of n partials, in a fixed order
template <typename T>
__global__ void sum_partials(const T* __restrict__ partial, int n,
                             T* __restrict__ out) {
  __shared__ T sh[FIN];
  T s = T(0);
  for (int k = threadIdx.x; k < n; k += FIN) s += partial[k];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int st = FIN / 2; st > 0; st >>= 1) {
    if (threadIdx.x < st) sh[threadIdx.x] += sh[threadIdx.x + st];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = sh[0];
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int N, int TY>
cudaError_t launch_fused(const T* p, const T* rhs, const uint8_t* fl, T* out,
                         Geom g, int smem, double omega, double idx2,
                         double idy2, double idz2, T* r2, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      od3_fused<T, N, TY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grd(ceil_div(g.ei, g.ti), ceil_div(g.ej, g.tj),
                 ceil_div(g.ek, g.tk));
  od3_fused<T, N, TY><<<grd, dim3(TX, TY), smem, st>>>(
      p, rhs, fl, out, g, T(omega), T(idx2), T(idy2), T(idz2), r2);
  return cudaGetLastError();
}

// TY: 32 rows of threads (a plane box of up to 32x64) at float32, 16 (up
// to 32x32) at float64 (ops/sor_obsdist3d._BOX3)
template <typename T, int TY>
int run_obsdist3d(int dev, const T* p, const T* rhs, const uint8_t* fl,
                  T* out, Geom g, int smem, double omega, double idx2,
                  double idy2, double idz2, T* r2, T* rows, T* res,
                  cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  // the box must fit the threads' column pairs, the ring 2n + 2 planes
  if (g.rows > 32 || min(g.ei, g.ti + 2 * g.ht) > TX * (TY / 16) ||
      g.rs != 2 * g.n + 2)
    return (int)cudaErrorInvalidValue;
#define OD3_CASE(NN)                                                  \
  case NN:                                                            \
    e = launch_fused<T, NN, TY>(p, rhs, fl, out, g, smem, omega, idx2, \
                                idy2, idz2, r2, st);                   \
    break;
  switch (g.n) {
    OD3_CASE(1)
    OD3_CASE(2)
    OD3_CASE(3)
    OD3_CASE(4)
    OD3_CASE(5)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OD3_CASE
  if (e != cudaSuccess) return (int)e;
  if (r2 != nullptr) {
    const int nrows = g.kl * g.jl;
    row_sums<T><<<ceil_div(nrows, 32), dim3(32, 8), 0, st>>>(r2, nrows, g.il,
                                                           rows);
    sum_partials<T><<<1, FIN, 0, st>>>(rows, nrows, res);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// geo = [ek, ej, ei, kl, jl, il, n, H, kmax, jmax, imax, koff, joff, ioff,
//        ht, tk, tj, ti, rs, rows, P, Pf, smem bytes]
// (ops/sor_obsdist3d.pass_plan_3d; n <= 5); r2 == nullptr skips the
// residual (a pass before the last)
#define OBSDIST3D_ENTRY(NAME, T, TY)                                          \
  int NAME(int dev, const void* p, const void* rhs, const void* fl,           \
           void* out, const int* geo, double omega, double idx2, double idy2, \
           double idz2, void* r2, void* rows, void* res, void* stream) {      \
    const Geom g{geo[0],  geo[1],  geo[2],  geo[3],  geo[4],  geo[5],         \
                 geo[6],  geo[7],  geo[8],  geo[9],  geo[10], geo[11],        \
                 geo[12], geo[13], geo[14], geo[15], geo[16], geo[17],        \
                 geo[18], geo[19], geo[20], geo[21]};                         \
    return run_obsdist3d<T, TY>(                                              \
        dev, (const T*)p, (const T*)rhs, (const uint8_t*)fl, (T*)out, g,      \
        geo[22], omega, idx2, idy2, idz2, (T*)r2, (T*)rows, (T*)res,          \
        (cudaStream_t)stream);                                                \
  }

OBSDIST3D_ENTRY(rb_sor_obsdist3d_f32, float, 32)
OBSDIST3D_ENTRY(rb_sor_obsdist3d_f64, double, 16)

}  // extern "C"
