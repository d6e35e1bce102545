// 3-D red-black SOR for Hopper (sm_90a): the port's two NS-3D solve kernels.
//
// rb_sor3d_checkerboard (K5) replaces pampi_tpu/ops/sor3d_pallas.py
//   _tblock3d_kernel (make_rb_iter_tblock_3d, plain mode) on the natural
//   (K+2, J+2, I+2) layout.
// rb_sor3d_octants (K6) replaces pampi_tpu/ops/sor3d_pallas.py
//   _tblock3d_octants_kernel (make_rb_iter_tblock_3d_octants) on the eight
//   stacked parity octants (8, (K+2)/2, (J+2)/2, (I+2)/2) in BITS order
//   (pampi_tpu_torch/ops/sor_octants.py: octant index 4*pk + 2*pj + pi).
//
// Both compute n_inner red-black iterations of the 7-point stencil, each an
// ODD-parity half-sweep ((i+j+k) odd, the reference's first pass), an even
// half-sweep that sees the odd one's updates, and the 6-face homogeneous-
// Neumann ghost refresh (faces tangentially clipped to the interior, edges
// and corners untouched), and return the sum of r^2 over both half-sweeps
// of the LAST iteration.
//
// What bounds them on the H100: memory bandwidth (~13 flops per cell
// update). The least any implementation must move per call is p and rhs
// read once and p written once, 3 field-sizes: at 128^3 f32 (130^3 * 4 B =
// 8.8 MB a field) ~7.9 us at 3.35 TB/s, at 256^3 ~61.5 us, whatever n_inner
// is. At 128^3, p and rhs fit the 50 MB L2, so that bound is no floor there.
//
// Design (simple and right first, as the 2-D kernels of sor_rb.cu): the TPU
// kernels run their grid steps in order and carry the residual across them
// in SMEM; CUDA blocks run in no order, so every ordering point is a launch
// boundary. Per iteration: one launch per colour (in place; within a colour
// every cell reads only the other colour), then one Neumann launch (the six
// faces are disjoint and read only interior planes, which no thread of that
// launch writes). On the last iteration each block writes its partial sum
// of r^2 (a fixed-order shared-memory tree) and a one-block launch sums the
// partials in a fixed order. No float atomics, so the residual, and every
// iteration count, is reproducible. In the octant layout every neighbour is
// a uniform shift of a dense array, so a thread updates the same index of
// its colour's four octants with unit-stride, coalesced reads, and the
// Neumann refresh is 24 same-index plane copies in one launch. Temporal
// blocking of these two (several iterations per pass through memory, as
// the TPU kernels do) is later work; the masked mode below streams its
// passes through shared memory.
//
// Arithmetic keeps the reference association term for term:
//   r = rhs - ((e - 2c + w)*idx2 + (n - 2c + s)*idy2 + (b - 2c + f)*idz2)
//   p = c - factor*r
// built with --fmad=false so no multiply-add is contracted.
//
// rb_sor3d_masked (K5's masked mode) replaces the masked mode of the same
//   TPU kernel (_tblock3d_kernel(masked=True), the NS-3D obstacle solve,
//   pampi_tpu/ops/obstacle3d.make_obstacle_solver_fn_3d): a cell updates
//   only where it is interior, of the colour and fluid (flag != 0), with
//   per-direction coefficients formed from the uint8 flags in the kernel
//   (sor3d_pallas.masked_stencil_ops_3d's order):
//     eps_* = the six neighbours' flags,
//     denom = (eps_e + eps_w)*idx2 + (eps_n + eps_s)*idy2
//             + (eps_b + eps_f)*idz2,
//     fac   = (denom > 0 ? omega/denom : 0) * flag,
//     r     = rhs - ((eps_e*(e - c) + eps_w*(w - c))*idx2
//                    + (eps_n*(n - c) + eps_s*(s - c))*idy2
//                    + (eps_b*(b - c) + eps_f*(f - c))*idz2),
//     p     = c - fac*r.
//   The flags add 1 byte a cell: the bound is 13 bytes a cell at float32
//   (p and rhs read, p written, the flags read; 0.0337 ms at 512x128x128,
//   whatever n is).
//
//   Design of the masked mode: K16's streaming (csrc/sor_obsdist3d.cu) on
//   the whole field, one iteration a pass, one launch each (a call of n
//   iterations runs n passes; of the depths m = 1, 2, 4 iterations a pass
//   measured on the card, m = 1 was fastest: a pass moves about the bound,
//   and the ring and the halo, 2m + 1 cells a side, grow with m; PERF.md
//   §6). The field is cut into owned (j, i) tiles, 32 columns wide,
//   and k slabs that partition it, wall shell included (ops/sor3d_kernels.
//   masked_tiles); a CTA, two an SM, streams its tile's box (the tile and
//   3 cells a side, clipped to the field) along k through a ring of 5
//   planes of p, rhs and the flags in shared memory: the 4 planes that the
//   two colour stages read and the next one, in flight while the stages
//   run (p and rhs by cp.async, a cell a copy; the flag bytes in
//   registers until the next step). The odd stage runs one plane behind
//   the newest, the even one two, followed on its plane by the j/i wall
//   selects and, on planes 1 and K, the k-face ones.
//   The box's shell stays frozen where it lies inside the field (its cells
//   are not owned); where it is the field's wall shell, the edge tiles
//   write it, edges and corners untouched, as cb3_neumann does. It reads p
//   and writes out (out of place: a CTA reads its neighbours' cells while
//   they write); p is never written. A cell whose own flag and six
//   neighbours' are all 1 skips the eps products (the same bits). The
//   residual keeps its fixed order, which a plain PyTorch version can
//   repeat bit for bit: the last pass writes each owned interior cell's
//   r^2 (0 on an obstacle) into an interior-sized buffer, and one launch
//   (r2_total) sums each (k, j) row from i = 1 up, staged through shared
//   memory so its loads coalesce, and its last block (an integer ticket)
//   sums the rows as sum_partials does (ops/sor_kernels.ordered_r2_sum is
//   the plain form). The per-shard kernel K16 reduces its owned cells the
//   same way, so on a one-shard mesh the two residuals agree bitwise.
//   Launches a call: n + 1. What bounds it: a CTA's plane steps, each
//   ~5 us on the H100 whatever the box (1.6x the field streamed at
//   512x128x128, tiles and slabs together); neither the copies' issue nor
//   the memory's latency sets that cost (copying 16-byte blocks, and
//   fetching two planes ahead, made the pass slower: PERF.md §6).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int FIN = 1024;

template <typename T>
__device__ T block_sum(T v, T* sh) {
  const int tid = threadIdx.y * BX + threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  return sh[0];
}

template <typename T>
__device__ __forceinline__ T resid3(T c, T rhs, T w, T e, T s, T n, T f, T b,
                                    T idx2, T idy2, T idz2) {
  return rhs - ((e - T(2) * c + w) * idx2 + (n - T(2) * c + s) * idy2 +
                (b - T(2) * c + f) * idz2);
}

template <typename T>
__device__ __forceinline__ void write_partial(T rr, T* sh, T* partial) {
  const T s = block_sum(rr, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
            blockIdx.x] = s;
}

// one colour of the 3-D checkerboard, in place: cells (i+j+k)%2 == par,
// 1 <= i <= I, 1 <= j <= J, k = 1 + blockIdx.z; thread (t, row) takes the
// t-th cell of its colour in row (k, j)
template <typename T>
__global__ void cb3_color(T* __restrict__ p, const T* __restrict__ rhs, int K,
                          int J, int I, int par, T factor, T idx2, T idy2,
                          T idz2, T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t W = I + 2;
  const size_t P = (size_t)(J + 2) * W;
  const int k = 1 + blockIdx.z;
  const int j = 1 + blockIdx.y * BY + threadIdx.y;
  const int t = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (j <= J) {
    const int i = (((1 + j + k) & 1) == par ? 1 : 2) + 2 * t;
    if (i <= I) {
      const size_t x = k * P + j * W + i;
      const T c = p[x];
      const T r = resid3(c, rhs[x], p[x - 1], p[x + 1], p[x - W], p[x + W],
                         p[x - P], p[x + P], idx2, idy2, idz2);
      p[x] = c - factor * r;
      rr = r * r;
    }
  }
  if (partial != nullptr) write_partial(rr, sh, partial);
}

// ---- the masked mode: streamed passes ----------------------------------

constexpr int MTX = 32;  // a warp takes 32 columns of a row pair
constexpr int HT5 = 3;   // the tiles' halo (ops/sor3d_kernels.HALO5)
constexpr int RS5 = 4;   // ring planes that the two colour stages read
constexpr int NS5 = 5;   // and the next one, in flight (RING5)

struct MGeom {
  int ek, ej, ei;  // the field: K + 2, J + 2, I + 2
  int tk, tj, ti;  // owned tile extents
  int rows;        // rows of a ring plane (the largest box's j)
  int P, Pf;       // row pitches: p and rhs (elements), flags (bytes)
};

// One iteration of the masked mode on the box of one owned tile, read from
// p, the tile's cells written into out. The ring holds NS5 planes of p,
// rhs and the flags: the RS5 that the two colour stages read and the next
// one, whose p and rhs arrive by cp.async while the stages run (its flags,
// bytes that cp.async cannot take one by one, in flight in registers).
// TY rows of MTX threads; thread (tx, ty) owns column b = tx of the box
// (at most MTX wide) and the row pairs a0 = 2 (ty + TY kk), a0 + 1, kk <
// KK, of every plane: it loads them, updates them in both colours (in one
// step both stages take the same row of a pair, as the plane's parity and
// the colour change together, so neighbouring lanes read neighbouring
// words) and writes them out. On the last pass (r2 != nullptr) each owned
// interior cell writes its r^2 (0 on an obstacle) at its interior index.
template <typename T, int TY, int KK, int MINB>
__global__ void __launch_bounds__(MTX * TY, MINB)
cb3m_pass(const T* __restrict__ p, const T* __restrict__ rhs,
          const uint8_t* __restrict__ fl, T* __restrict__ out, MGeom g,
          T omega, T idx2, T idy2, T idz2, T* __restrict__ r2) {
  constexpr int RS = RS5, NS = NS5, NT = MTX * TY;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = g.P, Pf = g.Pf;
  const int PS = g.rows * P, PSF = g.rows * Pf;
  T* sp = reinterpret_cast<T*>(smem);
  T* sr = sp + (size_t)NS * PS;
  uint8_t* sf = reinterpret_cast<uint8_t*>(sr + (size_t)NS * PS);
  const int b = threadIdx.x, tid = threadIdx.y * MTX + b;
  const int K = g.ek - 2, J = g.ej - 2, I = g.ei - 2;
  // the owned tile and its box (the tile and ht cells a side, clipped)
  const int k0 = blockIdx.z * g.tk, k1 = min(g.ek, k0 + g.tk);
  const int j0 = blockIdx.y * g.tj, j1 = min(g.ej, j0 + g.tj);
  const int i0 = blockIdx.x * g.ti, i1 = min(g.ei, i0 + g.ti);
  const int bk0 = max(0, k0 - HT5), KB = min(g.ek, k1 + HT5) - bk0;
  const int bj0 = max(0, j0 - HT5), R = min(g.ej, j1 + HT5) - bj0;
  const int bi0 = max(0, i0 - HT5), W = min(g.ei, i1 + HT5) - bi0;
  const size_t SW = g.ei, SP = (size_t)g.ej * g.ei;
  // the cells that update: off the box's shell (which stays frozen where
  // it lies inside the field, and is the wall shell where it does not),
  // in the interior: box rows 1..ahi, columns 1..bhi, planes 1..qhi
  const int ahi = min(R - 2, J - bj0), bhi = min(W - 2, I - bi0);
  const int qhi = min(KB - 2, K - bk0);
  // the tile's cells in box coordinates
  const int ta0 = j0 - bj0, ta1 = j1 - bj0, tb0 = i0 - bi0, tb1 = i1 - bi0;
  const int tq0 = k0 - bk0, tq1 = k1 - bk0;
  const bool col = b < W, tcol = b >= tb0 && b < tb1;
  const bool ucol = b >= 1 && b <= bhi;  // the column updates
  // box plane q's p and rhs into ring slot `slot` by cp.async, its flags
  // into registers, one byte each, untouched until the next step (zeroed:
  // a loop-carried register array left uninitialised was miscompiled)
  unsigned vf[KK][2] = {};
  auto fetch = [&](int q, int slot) {
    const size_t x0 = (size_t)(bk0 + q) * SP + (size_t)bj0 * SW + bi0 + b;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int a = 2 * (threadIdx.y + TY * kk) + r;
        if (!col || a >= R) continue;
        const size_t x = x0 + (size_t)a * SW;
        const int y = slot * PS + a * P + b;
        vf[kk][r] = fl[x];
        __pipeline_memcpy_async(sp + y, p + x, sizeof(T));
        __pipeline_memcpy_async(sr + y, rhs + x, sizeof(T));
      }
  };
  // fac of a fluid cell whose six neighbours are fluid (all flags 1),
  // formed as every cell's is
  const T f1 = T(1u);
  const T denom_one = (f1 + f1) * idx2 + (f1 + f1) * idy2 + (f1 + f1) * idz2;
  const T fac_one = (denom_one > T(0) ? omega / denom_one : T(0)) * f1;
  fetch(0, 0);
  __pipeline_commit();
  // the last stage runs in step KB + 1 (on plane KB - 1); the planes that
  // have not left the ring by then go out after the loop
  const int ZE = KB + 2;
  for (int z = 0, zs = 0; z < ZE; ++z, zs = zs == NS - 1 ? 0 : zs + 1) {
    // zs = z % NS: plane z's slot. Its flags go in from the registers;
    // then, once its p and rhs have landed and every thread is past step
    // z - 1, the plane z - RS leaves the ring for out (its last read and
    // write came in step z - 1) from the slot that plane z + 1 then takes
    if (z < KB) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int a = 2 * (threadIdx.y + TY * kk) + r;
          if (col && a < R) sf[zs * PSF + a * Pf + b] = (uint8_t)vf[kk][r];
        }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    const int so = zs == NS - 1 ? 0 : zs + 1;
    {
      const int qo = z - RS;
      if (qo >= tq0 && qo < tq1 && tcol) {
        const size_t xo = (size_t)(bk0 + qo) * SP + (size_t)bj0 * SW + bi0 + b;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int a = 2 * (threadIdx.y + TY * kk) + r;
            if (a >= ta0 && a < ta1)
              out[xo + (size_t)a * SW] = sp[so * PS + a * P + b];
          }
      }
    }
    if (z + 1 < KB) fetch(z + 1, so);
    __pipeline_commit();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // stage s: colour odd (s = 0) or even (s = 1) on plane q = z - 1 - s
      const int q = z - 1 - s;
      const bool on = q >= 1 && q <= qhi;
      int sq = zs - 1 - s;  // ring slots of planes q, q - 1, q + 1
      if (sq < 0) sq += NS;
      const int sm = sq == 0 ? NS - 1 : sq - 1;
      const int sn = sq == NS - 1 ? 0 : sq + 1;
      T* cp = sp + sq * PS;
      if (on && ucol) {
        const T* cm = sp + sm * PS;
        const T* cq = sp + sn * PS;
        const uint8_t* fq = sf + sq * PSF;
        const bool last = r2 != nullptr && q >= tq0 && q < tq1 && tcol;
        // the row of each pair in the stage's colour
        const int rz = (z + bk0 + bj0 + bi0 + b) & 1;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const int a = 2 * (threadIdx.y + TY * kk) + rz;
          if (a < 1 || a > ahi) continue;
          const int x = a * P + b, xf = a * Pf + b;
          const unsigned fc = fq[xf];
          T rr = T(0);
          if (fc != 0) {
            const unsigned fe = fq[xf + 1], fw = fq[xf - 1],
                           fn = fq[xf + Pf], fs = fq[xf - Pf],
                           fb = sf[sn * PSF + xf], ff = sf[sm * PSF + xf];
            const T cv = cp[x];
            const T de = cp[x + 1] - cv, dw = cp[x - 1] - cv;
            const T dn = cp[x + P] - cv, ds = cp[x - P] - cv;
            const T db = cq[x] - cv, df = cm[x] - cv;
            T lap, fac;
            // all seven flags 1: eps*d is d, the same bits
            if (((fc ^ 1u) | (fe ^ 1u) | (fw ^ 1u) | (fn ^ 1u) | (fs ^ 1u) |
                 (fb ^ 1u) | (ff ^ 1u)) == 0) {
              fac = fac_one;
              lap = (de + dw) * idx2 + (dn + ds) * idy2 + (db + df) * idz2;
            } else {
              const T ee = T(fe), ew = T(fw), en = T(fn), es = T(fs);
              const T eb = T(fb), ef = T(ff);
              const T denom =
                  (ee + ew) * idx2 + (en + es) * idy2 + (eb + ef) * idz2;
              fac = (denom > T(0) ? omega / denom : T(0)) * T(fc);
              lap = (ee * de + ew * dw) * idx2 + (en * dn + es * ds) * idy2 +
                    (eb * db + ef * df) * idz2;
            }
            const T res = sr[sq * PS + x] - lap;
            cp[x] = cv - fac * res;
            rr = res * res;
          }
          if (last && a >= ta0 && a < ta1)
            r2[((size_t)(bk0 + q - 1) * J + (bj0 + a - 1)) * I + bi0 + b -
               1] = rr;
        }
      }
      __syncthreads();
      if (on && s == 1) {
        // the wall selects that follow plane q's even stage: the j and i
        // faces on the plane, and the k face 0 (K + 1) from 1 (K); each
        // copies its inward interior neighbour, clipped tangentially to
        // the interior. A face row or column that the box holds lies on
        // the field's wall shell (an edge tile's), else off the box. No
        // barrier before the next stage: it reads only interior cells of
        // this plane, and the k faces' planes do not update.
        const int nrow = max(0, bhi), ncol = max(0, ahi);
        for (int u = tid; u < 2 * (nrow + ncol); u += NT) {
          int a, bb, src;
          if (u < 2 * nrow) {
            const int hi = u >= nrow;
            a = hi ? J + 1 - bj0 : -bj0;
            bb = 1 + u - hi * nrow;
            if (a < 0 || a >= R) continue;
            src = (hi ? a - 1 : a + 1) * P + bb;
          } else {
            const int v = u - 2 * nrow, hi = v >= ncol;
            bb = hi ? I + 1 - bi0 : -bi0;
            a = 1 + v - hi * ncol;
            if (bb < 0 || bb >= W) continue;
            src = a * P + (hi ? bb - 1 : bb + 1);
          }
          cp[a * P + bb] = cp[src];
        }
        // the k faces: each thread its own cells, as it writes them out
        const int gk = bk0 + q;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          if (gk != (side == 0 ? 1 : K) || !ucol) continue;
          T* cd = sp + (side == 0 ? sm : sn) * PS;
#pragma unroll
          for (int kk = 0; kk < KK; ++kk)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int a = 2 * (threadIdx.y + TY * kk) + r;
              if (a >= 1 && a <= ahi) cd[a * P + b] = cp[a * P + b];
            }
        }
      }
    }
  }
  __syncthreads();
  for (int qo = max(0, ZE - RS); qo < KB; ++qo) {
    if (qo < tq0 || qo >= tq1 || !tcol) continue;
    const size_t xo = (size_t)(bk0 + qo) * SP + (size_t)bj0 * SW + bi0 + b;
    const int so = qo % NS;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int a = 2 * (threadIdx.y + TY * kk) + r;
        if (a >= ta0 && a < ta1)
          out[xo + (size_t)a * SW] = sp[so * PS + a * P + b];
      }
  }
}

// The residual of the last pass, one launch: block b sums the rows 32 b ..
// 32 b + 31 of v (rows x n) from their first value up, 32 columns at a time
// staged through shared memory so that its loads coalesce (lane r of the
// first warp sums row r), into rsum; the last block to take the ticket
// sums the rows as sum_partials does (thread t adds rows t, t + FIN, ...,
// then the halving tree) into res[0] and resets the ticket
template <typename T>
__global__ void __launch_bounds__(FIN)
r2_total(const T* __restrict__ v, int rows, int n, T* __restrict__ rsum,
         unsigned* __restrict__ ticket, T* __restrict__ res) {
  __shared__ T sh[32][33];
  __shared__ T tree[FIN];
  __shared__ bool last_block;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;
  const int r0 = blockIdx.x * 32;
  T s = T(0);
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int r = r0 + ty, c = c0 + tx;
    sh[ty][tx] = r < rows && c < n ? v[(size_t)r * n + c] : T(0);
    __syncthreads();
    if (ty == 0) {
      const int m = min(32, n - c0);
      for (int cc = 0; cc < m; ++cc) s += sh[tx][cc];
    }
    __syncthreads();
  }
  if (ty == 0 && r0 + tx < rows) {
    rsum[r0 + tx] = s;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  T a = T(0);
  for (int k = tid; k < rows; k += FIN) a += __ldcg(rsum + k);
  tree[tid] = a;
  __syncthreads();
  for (int st = FIN / 2; st > 0; st >>= 1) {
    if (tid < st) tree[tid] += tree[tid + st];
    __syncthreads();
  }
  if (tid == 0) {
    res[0] = tree[0];
    *ticket = 0u;
  }
}

// the six Neumann faces; blockIdx.z picks the axis (0: front/back, 1:
// bottom/top, 2: left/right), (a, b) = 1 + the thread's (y, x) position on
// the face's tangential interior
template <typename T>
__global__ void cb3_neumann(T* __restrict__ p, int K, int J, int I) {
  const size_t W = I + 2;
  const size_t P = (size_t)(J + 2) * W;
  const int a = 1 + blockIdx.y * BY + threadIdx.y;
  const int b = 1 + blockIdx.x * BX + threadIdx.x;
  if (blockIdx.z == 0) {  // (j, i)
    if (a <= J && b <= I) {
      const size_t x = a * W + b;
      p[x] = p[P + x];
      p[(K + 1) * P + x] = p[K * P + x];
    }
  } else if (blockIdx.z == 1) {  // (k, i)
    if (a <= K && b <= I) {
      const size_t x = a * P + b;
      p[x] = p[x + W];
      p[x + (J + 1) * W] = p[x + J * W];
    }
  } else {  // (k, j)
    if (a <= K && b <= J) {
      const size_t x = a * P + b * W;
      p[x] = p[x + 1];
      p[x + I + 1] = p[x + I];
    }
  }
}

// octant B = 4*pk + 2*pj + pi at index (s, r, c): on its interior (parity-0
// axes drop index 0, parity-1 axes drop the last) update it in place from
// its three partners (bit flipped) and return r^2, else return 0
template <typename T, int B>
__device__ __forceinline__ T oct_update(T* __restrict__ q,
                                        const T* __restrict__ f, size_t S,
                                        int K2, int J2, int I2, int s, int r,
                                        int c, T factor, T idx2, T idy2,
                                        T idz2) {
  constexpr int pk = B >> 2, pj = (B >> 1) & 1, pi = B & 1;
  if (pk == 0 ? s < 1 : s > K2 - 2) return T(0);
  if (pj == 0 ? r < 1 : r > J2 - 2) return T(0);
  if (pi == 0 ? c < 1 : c > I2 - 2) return T(0);
  const size_t P = (size_t)J2 * I2;
  const size_t x = s * P + (size_t)r * I2 + c;
  const T* qi = q + (B ^ 1) * S;
  const T* qj = q + (B ^ 2) * S;
  const T* qk = q + (B ^ 4) * S;
  // bit 0: minus = partner[idx-1], plus = partner[idx]; bit 1: minus =
  // partner[idx], plus = partner[idx+1]
  const T w = qi[x - (pi == 0 ? 1 : 0)];
  const T e = qi[x + (pi == 1 ? 1 : 0)];
  const T so = qj[x - (pj == 0 ? (size_t)I2 : 0)];
  const T no = qj[x + (pj == 1 ? (size_t)I2 : 0)];
  const T fr = qk[x - (pk == 0 ? P : 0)];
  const T bk = qk[x + (pk == 1 ? P : 0)];
  T* o = q + B * S;
  const T cv = o[x];
  const T res = resid3(cv, f[B * S + x], w, e, so, no, fr, bk, idx2, idy2,
                       idz2);
  o[x] = cv - factor * res;
  return res * res;
}

// one colour in octant space: odd = octants 1, 2, 4, 7 (read 0, 3, 5, 6),
// even = 0, 3, 5, 6; thread (c, r, s) takes index (s, r, c) of all four
template <typename T>
__global__ void oct_color(T* __restrict__ q, const T* __restrict__ f, int K2,
                          int J2, int I2, int odd, T factor, T idx2, T idy2,
                          T idz2, T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t S = (size_t)K2 * J2 * I2;
  const int s = blockIdx.z;
  const int r = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (r < J2 && c < I2) {
    if (odd) {
      rr += oct_update<T, 1>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 2>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 4>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 7>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
    } else {
      rr += oct_update<T, 0>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 3>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 5>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 6>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
    }
  }
  if (partial != nullptr) write_partial(rr, sh, partial);
}

__device__ __forceinline__ bool inside(int bit, int idx, int n) {
  return bit == 0 ? idx >= 1 : idx <= n - 2;
}

// the 24 same-index ghost-plane copies (pampi_tpu_torch/ops/sor_octants.py
// ghost_pairs); blockIdx.z is the face axis (0: k, 1: j, 2: i) and the
// thread's (y, x) its position on the two tangential axes
template <typename T>
__global__ void oct_neumann(T* __restrict__ q, int K2, int J2, int I2) {
  const size_t S = (size_t)K2 * J2 * I2;
  const size_t P = (size_t)J2 * I2;
  const int a = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.x * BX + threadIdx.x;
  const int ax = blockIdx.z;
  const int na = ax == 0 ? J2 : K2;  // extent of the y tangential axis
  const int nb = ax == 2 ? J2 : I2;  // extent of the x tangential axis
  if (a >= na || b >= nb) return;
  const int n = ax == 0 ? K2 : (ax == 1 ? J2 : I2);  // normal extent
  for (int o = 0; o < 8; ++o) {
    const int pk = o >> 2, pj = (o >> 1) & 1, pi = o & 1;
    int pn, pa, pb;  // bits along the normal, y and x axes
    if (ax == 0) { pn = pk; pa = pj; pb = pi; }
    else if (ax == 1) { pn = pj; pa = pk; pb = pi; }
    else { pn = pi; pa = pk; pb = pj; }
    if (!inside(pa, a, na) || !inside(pb, b, nb)) continue;
    const int plane = pn == 0 ? 0 : n - 1;  // lo ghost at 0, hi at the last
    size_t x;
    if (ax == 0) x = plane * P + (size_t)a * I2 + b;
    else if (ax == 1) x = a * P + (size_t)plane * I2 + b;
    else x = a * P + (size_t)b * I2 + plane;
    const int partner = o ^ (ax == 0 ? 4 : (ax == 1 ? 2 : 1));
    q[o * S + x] = q[partner * S + x];
  }
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

dim3 cb3_grid(int K, int J, int I) {
  return dim3(((I + 1) / 2 + BX - 1) / BX, (J + BY - 1) / BY, K);
}

dim3 oct_grid(int K2, int J2, int I2) {
  return dim3((I2 + BX - 1) / BX, (J2 + BY - 1) / BY, K2);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int run_checkerboard3d(int dev, T* p, const T* rhs, int K, int J, int I,
                       int n_inner, double factor, double idx2, double idy2,
                       double idz2, T* partial, T* out, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = cb3_grid(K, J, I);
  const dim3 blk(BX, BY);
  const size_t nb = (size_t)grd.x * grd.y * grd.z;
  const dim3 ngrd(ceil_div(I > J ? I : J, BX), ceil_div(J > K ? J : K, BY), 3);
  for (int t = 0; t < n_inner; ++t) {
    const bool last = t == n_inner - 1;
    cb3_color<T><<<grd, blk, 0, st>>>(p, rhs, K, J, I, 1, T(factor), T(idx2),
                                      T(idy2), T(idz2),
                                      last ? partial : nullptr);
    cb3_color<T><<<grd, blk, 0, st>>>(p, rhs, K, J, I, 0, T(factor), T(idx2),
                                      T(idy2), T(idz2),
                                      last ? partial + nb : nullptr);
    cb3_neumann<T><<<ngrd, blk, 0, st>>>(p, K, J, I);
  }
  sum_partials<T><<<1, FIN, 0, st>>>(partial, (int)(2 * nb), out);
  return (int)cudaGetLastError();
}

template <typename T, int TY, int KK, int MINB>
cudaError_t launch_masked_pass(const T* p, const T* rhs, const uint8_t* fl,
                               T* out, const MGeom& g, int smem,
                               double omega, double idx2, double idy2,
                               double idz2, T* r2, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      cb3m_pass<T, TY, KK, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grd(ceil_div(g.ei, g.ti), ceil_div(g.ej, g.tj),
                 ceil_div(g.ek, g.tk));
  cb3m_pass<T, TY, KK, MINB><<<grd, dim3(MTX, TY), smem, st>>>(
      p, rhs, fl, out, g, T(omega), T(idx2), T(idy2), T(idz2), r2);
  return cudaGetLastError();
}

// one pass of the masked mode (geo: ops/sor3d_kernels.masked_geometry)
// and, on the last pass (r2 != nullptr), the residual's one launch. Two
// CTAs an SM, each of 16 rows of threads with 3 row pairs at float32
// (boxes of up to 96 rows) or 2 at float64 (64 rows)
template <typename T>
int run_masked3d(int dev, const T* p, const T* rhs, const uint8_t* fl,
                 T* out, const int* geo, double omega, double idx2,
                 double idy2, double idz2, T* r2, T* rsum, unsigned* ticket,
                 T* res, cudaStream_t st) {
  constexpr int TY = 16, KK = sizeof(T) == 4 ? 3 : 2;
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const MGeom g{geo[0], geo[1], geo[2], geo[3], geo[4],
                geo[5], geo[6], geo[7], geo[8]};
  const int smem = geo[9];
  // the box must fit the threads' columns and row pairs
  if (g.rows > 2 * TY * KK || min(g.ei, g.ti + 2 * HT5) > MTX)
    return (int)cudaErrorInvalidValue;
  e = launch_masked_pass<T, TY, KK, 2>(p, rhs, fl, out, g, smem, omega,
                                       idx2, idy2, idz2, r2, st);
  if (e != cudaSuccess) return (int)e;
  if (r2 != nullptr) {
    const int K = g.ek - 2, J = g.ej - 2, I = g.ei - 2;
    r2_total<T><<<ceil_div(K * J, 32), dim3(32, 32), 0, st>>>(
        r2, K * J, I, rsum, ticket, res);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_octants(int dev, T* q, const T* f, int K2, int J2, int I2,
                int n_inner, double factor, double idx2, double idy2,
                double idz2, T* partial, T* out, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = oct_grid(K2, J2, I2);
  const dim3 blk(BX, BY);
  const size_t nb = (size_t)grd.x * grd.y * grd.z;
  const dim3 ngrd(ceil_div(I2 > J2 ? I2 : J2, BX),
                  ceil_div(J2 > K2 ? J2 : K2, BY), 3);
  for (int t = 0; t < n_inner; ++t) {
    const bool last = t == n_inner - 1;
    oct_color<T><<<grd, blk, 0, st>>>(q, f, K2, J2, I2, 1, T(factor),
                                      T(idx2), T(idy2), T(idz2),
                                      last ? partial : nullptr);
    oct_color<T><<<grd, blk, 0, st>>>(q, f, K2, J2, I2, 0, T(factor),
                                      T(idx2), T(idy2), T(idz2),
                                      last ? partial + nb : nullptr);
    oct_neumann<T><<<ngrd, blk, 0, st>>>(q, K2, J2, I2);
  }
  sum_partials<T><<<1, FIN, 0, st>>>(partial, (int)(2 * nb), out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-sum buffer each entry point needs
int rb_sor3d_checkerboard_partials(int K, int J, int I) {
  const dim3 g = cb3_grid(K, J, I);
  return 2 * (int)(g.x * g.y * g.z);
}

int rb_sor3d_octants_partials(int K2, int J2, int I2) {
  const dim3 g = oct_grid(K2, J2, I2);
  return 2 * (int)(g.x * g.y * g.z);
}

#define SOR3_ENTRY(NAME, RUN, T)                                             \
  int NAME(int dev, void* p, const void* rhs, int a, int b, int c,           \
           int n_inner, double factor, double idx2, double idy2,             \
           double idz2, void* partial, void* out, void* stream) {            \
    return RUN<T>(dev, (T*)p, (const T*)rhs, a, b, c, n_inner, factor, idx2, \
                  idy2, idz2, (T*)partial, (T*)out, (cudaStream_t)stream);   \
  }

// geo = [K+2, J+2, I+2, tk, tj, ti, rows, P, Pf, smem bytes]
// (ops/sor3d_kernels.masked_geometry); r2 == nullptr skips the residual (a
// pass before the last); ticket is an unsigned 0 that the residual leaves
// at 0
#define MASKED3_ENTRY(NAME, T)                                      \
  int NAME(int dev, const void* p, const void* rhs, const void* fl,          \
           void* out, const int* geo, double omega, double idx2,             \
           double idy2, double idz2, void* r2, void* rsum, void* ticket,     \
           void* res, void* stream) {                                        \
    return run_masked3d<T>(                                                  \
        dev, (const T*)p, (const T*)rhs, (const uint8_t*)fl, (T*)out, geo,   \
        omega, idx2, idy2, idz2, (T*)r2, (T*)rsum, (unsigned*)ticket,        \
        (T*)res, (cudaStream_t)stream);                                      \
  }

MASKED3_ENTRY(rb_sor3d_masked_f32, float)
MASKED3_ENTRY(rb_sor3d_masked_f64, double)
SOR3_ENTRY(rb_sor3d_checkerboard_f32, run_checkerboard3d, float)
SOR3_ENTRY(rb_sor3d_checkerboard_f64, run_checkerboard3d, double)
SOR3_ENTRY(rb_sor3d_octants_f32, run_octants, float)
SOR3_ENTRY(rb_sor3d_octants_f64, run_octants, double)

}  // extern "C"
