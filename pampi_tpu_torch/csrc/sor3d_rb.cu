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
// Design of K5 and of K6's multi-launch design (simple and right first, as
// the 2-D kernels of sor_rb.cu; K6's on-chip design follows below): the TPU
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
// Neumann refresh is 24 same-index plane copies in one launch. The masked
// mode below streams its passes through shared memory.
//
// K6's on-chip design (rb_sor3d_octants_onchip; the wrapper takes it
// wherever ops/sor3d_kernels.octant_tiles, the capacity rule, finds a
// plan: both main-path fields, 128^3 f32 and canal3d's 200x50x50 f64): one
// cooperative launch a call, one CTA an SM. Each CTA owns a fixed tile
// (ts, tr, tc) of octant space, all eight slots, and holds it in shared
// memory for the whole call: p in a box of (ts+1)(tr+1)(tc+1) per slot (the
// tile and one face per axis, on the side the slot is read from: a slot
// with bit b along an axis sits at box offset b there, so every update
// reads its partners at box offsets 0 and +1) and rhs on the tile. In
// octant space a slot reads the other colour at its own index and one cell
// away on one side per axis, so a half-sweep of a colour needs only the
// faces of the other colour's slots that the neighbouring tiles updated
// last: after each half-sweep a CTA writes its own boundary planes of the
// colour it updated to p in device memory (the exchange; no cell is
// written there by two CTAs, and in a half-sweep no CTA reads the colour
// that is being written), the CTA waits for its six face neighbours to
// have written theirs (an epoch word a tile: wait_epoch; no grid-wide
// barrier), and it refreshes its box faces of that colour from p. A face
// never holds a ghost cell that an update reads (those lie at the reader's
// own index), so the 24 Neumann copies stay in the tile, after the even
// half-sweep. 2n - 1 exchanges replace the 3n + 1 launches; p crosses
// device memory once each way (8 loads a thread in flight), plus the faces
// (cells of a tile's surface per half-sweep). The last iteration stashes
// each update's r^2 (0 on a cell that does not update) in the rhs slot;
// each CTA sums its tile's 8 ts tr tc stash cells, in (slot, s, r, c)
// order, as consecutive runs a thread, then the threads' sums of each warp
// in lane order and the warps' in warp order (seq_sum), and the
// last CTA to take an integer ticket adds the tiles' partials in tile
// order. The order depends on the shape and dtype alone, and sor3d_kernels.
// octant_tile_residual repeats it bit for bit. No float atomics.
//   What bounds it at 128^3 f32 (n = 4, 125 tiles of 13^3 octant cells;
// clock64 sections of one CTA on the H100, PERF.md section 6): filling the
// boxes (~16 us: 4-byte reads of 14-cell rows, ~2 TB/s from the L2) and
// writing the tile back (~7 us), each half-sweep (~4 us: 17 updates a
// thread of 512, each a chain of dependent adds on 8 shared-memory reads)
// and each exchange (~4.5 us: the faces out, a fence, the neighbours'
// epochs, the faces in), not the device memory: the bound (p and rhs read,
// p written once) is 0.008 ms. One CTA an SM of 512 threads: a tile's
// boxes take 158 KB, and at 1024 threads the registers spilled.
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

// ---- K6 on chip: one cooperative launch a call --------------------------

constexpr int OT = 512;  // a tile's CTA (ops/sor3d_kernels.OCT_THREADS)
constexpr int OLD = 8;  // loads of a thread in flight while the boxes fill

// the octant extents, the tile extents and the tiles per axis; tile t is
// (t / (nr nc), t / nc % nr, t % nc) (ops/sor3d_kernels.octant_tiles)
struct OTiles {
  int K2, J2, I2;
  int ts, tr, tc;
  int ns, nr, nc;
};

// The exchange's synchronisation: after writing its faces for exchange k
// of a call, a CTA publishes epoch base + k in its word of `ep`, and waits
// until each of its (at most six) face neighbours has published that
// epoch before it reads their faces. base is the host's count of epochs
// before this call (the words of earlier calls are older, compared in
// wrapping 32-bit arithmetic). A CTA writes a colour's faces again two
// exchanges later, after its own wait for its neighbours' next epoch, so
// they have read the faces of the one before; no grid-wide barrier. All
// CTAs must be resident together (the cooperative launch sees to it).
__device__ __forceinline__ void publish_epoch(unsigned* ep, unsigned e) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *(volatile unsigned*)(ep + blockIdx.x) = e;
  }
}

__device__ __forceinline__ void wait_epoch(unsigned* ep, int nb,
                                           unsigned e) {
  if (nb >= 0) {
    volatile unsigned* w = ep + nb;
    while ((int)(*w - e) < 0) __nanosleep(20);
    __threadfence();
  }
  __syncthreads();
}

// the tile's sum of its n stash cells in a fixed, sequential order:
// thread t adds cells t c .. t c + c - 1 (c = ceil(n / OT)) from the
// first, lane 0 of each warp adds its 32 threads' sums in lane order, and
// thread 0 the warp sums in warp order. The total in thread 0; ws holds
// OT / 32 values. (A CPU emulation is three sequential accumulations:
// sor3d_kernels._seq_sum.)
template <typename T>
__device__ __forceinline__ T seq_sum(const T* v, int n, T* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (n + OT - 1) / OT, e0 = threadIdx.x * c;
  T acc = T(0);
  for (int e = e0; e < min(n, e0 + c); ++e) acc += v[e];
  T wsum = T(0);
  for (int l = 0; l < 32; ++l) wsum += __shfl_sync(0xffffffffu, acc, l);
  if (lane == 0) ws[warp] = wsum;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < OT / 32; ++w) total += ws[w];
  return total;
}

// a CTA's tile and its boxes in shared memory
struct OBox {
  int s0, r0, c0;  // the tile's first index
  int es, er, ec;  // its extents inside the octants
  int BR, BC, BV;  // box pitches: rows (tr + 1), columns (tc + 1), a slot
  int TV;          // a slot's tile: ts tr tc
};

// cell (a, b, c) of slot o's box lies at octant index (s0 - pk + a,
// r0 - pj + b, c0 - pi + c)
__device__ __forceinline__ int obox(const OBox& x, int o, int a, int b,
                                    int c) {
  return o * x.BV + (a * x.BR + b) * x.BC + c;
}

// slot sl (0..3) of a colour, in BITS order: odd 1, 2, 4, 7; even 0, 3, 5, 6
__device__ __forceinline__ int colour_slot(int odd, int sl) {
  return odd ? (sl == 3 ? 7 : 1 << sl) : (sl == 0 ? 0 : 7 - (1 << (3 - sl)));
}

// The rows (o, a, b) of 8 slots of na x nb rows, walked by the CTA: a warp
// takes 32 / cw rows at once (lane = sub * cw + col, cw the least power of
// two >= the row length), the warps stepping by 32 * 32 / cw rows; the
// thread's row advances by carries, without a division.
struct RowWalk {
  int o, a, b, na, nb, do_, da, db, col, r, rows, step;
  __device__ RowWalk(int na_, int nb_, int len) : na(na_), nb(nb_) {
    int cw = 1;
    while (cw < len) cw <<= 1;
    const int lane = threadIdx.x & 31, rpw = 32 / cw;
    col = lane & (cw - 1);
    r = (threadIdx.x >> 5) * rpw + lane / cw;
    rows = 8 * na * nb;
    step = (OT / 32) * rpw;
    o = r / (na * nb);
    a = r / nb - o * na;
    b = r - (o * na + a) * nb;
    do_ = step / (na * nb);
    da = step / nb - do_ * na;
    db = step - (do_ * na + da) * nb;
  }
  __device__ void next() {
    r += step;
    b += db;
    if (b >= nb) {
      b -= nb;
      ++a;
    }
    a += da;
    if (a >= na) {
      a -= na;
      ++o;
    }
    o += do_;
  }
};

// a thread's face cells (at most OFE a colour): slot index, axis and the
// two tangential tile coordinates, packed, decoded once a call
constexpr int OFE = 4;
__device__ __forceinline__ int face_pack(int sl, int ax, int d1, int d2) {
  return sl | ax << 2 | d1 << 4 | d2 << 18;
}

// the box index and the octant offset of a face cell of slot o: the halo
// face (halo = true) on the side the slot is read from, or the tile's own
// plane that the neighbour there reads; false where it lies outside
__device__ __forceinline__ bool face_cell(const OTiles& g, const OBox& x,
                                          int code, int odd, bool halo,
                                          int& bx, int& gx) {
  const int o = colour_slot(odd, code & 3), ax = (code >> 2) & 3;
  const int d1 = (code >> 4) & 0x3fff, d2 = code >> 18;
  const int pk = o >> 2, pj = (o >> 1) & 1, pi = o & 1;
  int ds, dr, dc;
  if (ax == 0) {
    ds = halo ? (pk ? -1 : x.es) : (pk ? x.es - 1 : 0);
    dr = d1;
    dc = d2;
  } else if (ax == 1) {
    ds = d1;
    dr = halo ? (pj ? -1 : x.er) : (pj ? x.er - 1 : 0);
    dc = d2;
  } else {
    ds = d1;
    dr = d2;
    dc = halo ? (pi ? -1 : x.ec) : (pi ? x.ec - 1 : 0);
  }
  const int s = x.s0 + ds, r = x.r0 + dr, c = x.c0 + dc;
  if (s < 0 || s >= g.K2 || r < 0 || r >= g.J2 || c < 0 || c >= g.I2)
    return false;
  bx = obox(x, o, ds + pk, dr + pj, dc + pi);
  gx = ((o * g.K2 + s) * g.J2 + r) * g.I2 + c;
  return true;
}

// the colour's faces out (halo = false: the tile's boundary planes to p)
// or in (halo = true: the box faces from p), all loads of a thread in
// flight together
template <typename T>
__device__ __forceinline__ void oct_faces(T* __restrict__ q, T* sp,
                                          const OTiles& g, const OBox& x,
                                          const int* code, int nf, int odd,
                                          bool halo) {
  T v[OFE];
  int bx[OFE];
  int gx[OFE];
  bool in[OFE];
#pragma unroll
  for (int k = 0; k < OFE; ++k) {
    in[k] = k < nf && face_cell(g, x, code[k], odd, halo, bx[k], gx[k]);
    if (in[k]) {
      if (halo) v[k] = __ldcg(q + gx[k]);
      else __stcg(q + gx[k], sp[bx[k]]);
    }
  }
  if (halo) {
#pragma unroll
    for (int k = 0; k < OFE; ++k)
      if (in[k]) sp[bx[k]] = v[k];
  }
}

// one column segment of a half-sweep, in place: slot o's cells xo, xo + PS,
// ... (n of them; those off the slot's interior keep their value) from its
// three partners' boxes, rhs at xf, xf + FS, ...; on the last iteration
// each cell's r^2 (0 where it does not update) replaces its rhs. The
// partners are the other colour's slots, so no cell read is written here:
// the restrict pointers and a body without branches let the loads of
// later cells start early (every read stays inside the boxes, so a cell
// that does not update computes on box values and keeps its own).
template <typename T>
__device__ __forceinline__ void oct_column(
    T* __restrict__ own, const T* __restrict__ p1, const T* __restrict__ p2,
    const T* __restrict__ p4, T* __restrict__ fo, int xo, int xi, int xj,
    int xk, int xf, int n, int PS, int FS, int BC, int s, int slo, int shi,
    bool col, bool last, T factor, T idx2, T idy2, T idz2) {
  // the k partner below the first cell; each cell's upper one is the
  // next cell's lower
  T lo = n > 0 ? p4[xk] : T(0);
#pragma unroll 2
  for (int k = 0; k < n; ++k, ++s) {
    const bool upd = col && s >= slo && s <= shi;
    const T cv = own[xo], hi = p4[xk + PS];
    const T res = resid3(cv, fo[xf], p1[xi], p1[xi + 1], p2[xj],
                         p2[xj + BC], lo, hi, idx2, idy2, idz2);
    own[xo] = upd ? cv - factor * res : cv;
    if (last) fo[xf] = upd ? res * res : T(0);
    lo = hi;
    xo += PS;
    xi += PS;
    xj += PS;
    xk += PS;
    xf += FS;
  }
}

// one column segment of a half-sweep (slot index sl of the colour, tile
// row dr, column dc, planes ds0..ds1 - 1)
template <typename T>
__device__ __forceinline__ void oct_sweep(T* sp, T* sf, const OTiles& g,
                                          const OBox& x, int odd, int sl,
                                          int dr, int dc, int ds0, int ds1,
                                          bool last, T factor, T idx2,
                                          T idy2, T idz2) {
  const int o = colour_slot(odd, sl);
  const int pk = o >> 2, pj = (o >> 1) & 1, pi = o & 1;
  const int r = x.r0 + dr, c = x.c0 + dc;
  const bool col = (pj == 0 ? r >= 1 : r <= g.J2 - 2) &&
                   (pi == 0 ? c >= 1 : c <= g.I2 - 2);
  oct_column(sp + o * x.BV, sp + (o ^ 1) * x.BV, sp + (o ^ 2) * x.BV,
             sp + (o ^ 4) * x.BV, sf + o * x.TV,
             obox(x, 0, ds0 + pk, dr + pj, dc + pi),
             obox(x, 0, ds0 + pk, dr + pj, dc), obox(x, 0, ds0 + pk, dr, dc + pi),
             obox(x, 0, ds0, dr + pj, dc + pi), (ds0 * g.tr + dr) * g.tc + dc,
             ds1 - ds0, x.BR * x.BC, g.tr * g.tc, x.BC, x.s0 + ds0,
             pk == 0 ? 1 : 0, pk == 0 ? g.K2 : g.K2 - 2, col, last, factor,
             idx2, idy2, idz2);
}

// a half-sweep of the colour: its 4 er ec columns (slot index, tile row
// and column), each cut into segments along s where the columns are
// fewer than the threads, over the CTA's threads
template <typename T>
__device__ __forceinline__ void oct_half(T* sp, T* sf, const OTiles& g,
                                         const OBox& x, int odd, bool last,
                                         T factor, T idx2, T idy2, T idz2) {
  const int area = x.er * x.ec, ncol = 4 * area;
  const int nseg = ncol >= OT ? 1 : min(x.es, OT / ncol);
  const int slen = (x.es + nseg - 1) / nseg;
  for (int u = threadIdx.x; u < ncol * nseg; u += OT) {
    const int seg = u / ncol, col = u - seg * ncol;
    const int sl = col / area, rc = col - sl * area;
    const int dr = rc / x.ec, dc = rc - dr * x.ec;
    const int ds0 = min(x.es, seg * slen);
    oct_sweep(sp, sf, g, x, odd, sl, dr, dc, ds0, min(x.es, ds0 + slen),
              last, factor, idx2, idy2, idz2);
  }
}

// the Neumann copies that fall in the tile: on each octant face the tile
// touches (axis ax, lo or hi), the four slots whose bit along ax is hi's
// copy their ghost plane (tangentially clipped to their interior) from
// the partner across the face at the same index
template <typename T>
__device__ __forceinline__ void oct_neumann_tile(T* sp, const OTiles& g,
                                                 const OBox& x) {
  const int st[3] = {x.s0, x.r0, x.c0};
  const int ext[3] = {x.es, x.er, x.ec};
  const int n[3] = {g.K2, g.J2, g.I2};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int plane = (hi ? n[ax] - 1 : 0) - st[ax];
      if (plane < 0 || plane >= ext[ax]) continue;
      const int a1 = ax == 0 ? 1 : 0, a2 = ax == 2 ? 1 : 2;
      const int n2 = ext[a2], area = ext[a1] * n2;
      for (int u = threadIdx.x; u < 4 * area; u += OT) {
        const int sl = u / area, v = u - sl * area;
        const int t1 = v / n2, t2 = v - t1 * n2;
        // the four slots with bit hi along ax, in BITS order
        const int lo_bits = ((sl >> 1) << (ax == 0 ? 1 : 2)) |
                            ((sl & 1) << (ax == 2 ? 1 : 0));
        const int o = lo_bits | (hi << (2 - ax));
        const int bit[3] = {o >> 2, (o >> 1) & 1, o & 1};
        const int g1 = st[a1] + t1, g2 = st[a2] + t2;
        if ((bit[a1] == 0 ? g1 < 1 : g1 > n[a1] - 2) ||
            (bit[a2] == 0 ? g2 < 1 : g2 > n[a2] - 2))
          continue;
        int d[3];
        d[ax] = plane;
        d[a1] = t1;
        d[a2] = t2;
        const int p = o ^ (4 >> ax);
        sp[obox(x, o, d[0] + bit[0], d[1] + bit[1], d[2] + bit[2])] =
            sp[obox(x, p, d[0] + (p >> 2), d[1] + ((p >> 1) & 1),
                    d[2] + (p & 1))];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(OT, 1)
oct_onchip(T* __restrict__ q, const T* __restrict__ f, OTiles g, int n_inner,
           T factor, T idx2, T idy2, T idz2, T* __restrict__ partial,
           unsigned* __restrict__ bar, unsigned base, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  OBox x;
  const int t = blockIdx.x;
  x.s0 = t / (g.nr * g.nc) * g.ts;
  x.r0 = t / g.nc % g.nr * g.tr;
  x.c0 = t % g.nc * g.tc;
  x.es = min(g.ts, g.K2 - x.s0);
  x.er = min(g.tr, g.J2 - x.r0);
  x.ec = min(g.tc, g.I2 - x.c0);
  x.BR = g.tr + 1;
  x.BC = g.tc + 1;
  x.BV = (g.ts + 1) * x.BR * x.BC;
  x.TV = g.ts * g.tr * g.tc;
  T* sp = reinterpret_cast<T*>(smem);  // 8 boxes of p
  T* sf = sp + 8 * x.BV;               // 8 tiles of rhs, then r^2
  T* ws = sf + 8 * x.TV;               // 32 warp sums
  // 32-bit offsets: an on-chip plan's octants hold at most a few million
  // cells (they fit the card's shared memory)
  const int S = g.K2 * g.J2 * g.I2, PL = g.J2 * g.I2;
  // the boxes of p (tile and faces; cells outside the octants 0) and rhs
  // on the tile (0 past the octants), rows of cells, OLD loads of a
  // thread in flight at once
  for (RowWalk w(g.ts + 1, x.BR, x.BC); w.r < w.rows;) {
    T v[OLD];
    int y[OLD];
#pragma unroll
    for (int k = 0; k < OLD; ++k, w.next()) {
      y[k] = -1;
      if (w.r >= w.rows || w.col >= x.BC) continue;
      const int s = x.s0 - (w.o >> 2) + w.a,
                r = x.r0 - ((w.o >> 1) & 1) + w.b,
                c = x.c0 - (w.o & 1) + w.col;
      y[k] = w.r * x.BC + w.col;
      v[k] = s >= 0 && s < g.K2 && r >= 0 && r < g.J2 && c >= 0 && c < g.I2
                 ? __ldcg(q + (w.o * S + s * PL + r * g.I2 + c))
                 : T(0);
    }
#pragma unroll
    for (int k = 0; k < OLD; ++k)
      if (y[k] >= 0) sp[y[k]] = v[k];
  }
  for (RowWalk w(g.ts, g.tr, g.tc); w.r < w.rows;) {
    T v[OLD];
    int y[OLD];
#pragma unroll
    for (int k = 0; k < OLD; ++k, w.next()) {
      y[k] = -1;
      if (w.r >= w.rows || w.col >= g.tc) continue;
      const int s = x.s0 + w.a, r = x.r0 + w.b, c = x.c0 + w.col;
      y[k] = w.r * g.tc + w.col;
      v[k] = s < g.K2 && r < g.J2 && c < g.I2
                 ? __ldcg(f + (w.o * S + s * PL + r * g.I2 + c))
                 : T(0);
    }
#pragma unroll
    for (int k = 0; k < OLD; ++k)
      if (y[k] >= 0) sf[y[k]] = v[k];
  }
  // the thread's face cells: u = tid + k OT of the colour's 4 (er ec +
  // es ec + es er) cells, decoded once
  int code[OFE];
  int nf = 0;
  {
    const int n0 = x.er * x.ec, n1 = x.es * x.ec, n2 = x.es * x.er;
    const int per = n0 + n1 + n2;
#pragma unroll
    for (int k = 0; k < OFE; ++k) {
      const int u = threadIdx.x + k * OT;
      code[k] = 0;
      if (u >= 4 * per) continue;
      const int sl = u / per;
      int v = u - sl * per;
      if (v < n0) {
        code[k] = face_pack(sl, 0, v / x.ec, v % x.ec);
      } else if (v < n0 + n1) {
        v -= n0;
        code[k] = face_pack(sl, 1, v / x.ec, v % x.ec);
      } else {
        v -= n0 + n1;
        code[k] = face_pack(sl, 2, v / x.er, v % x.er);
      }
      nf = k + 1;
    }
  }
  // the face neighbour that thread k < 6 watches: tile -s, +s, -r, +r,
  // -c, +c (-1 past the octants)
  int nb = -1;
  if (threadIdx.x < 6) {
    const int ax = threadIdx.x >> 1, dir = threadIdx.x & 1 ? 1 : -1;
    int i3[3] = {t / (g.nr * g.nc), t / g.nc % g.nr, t % g.nc};
    const int n3[3] = {g.ns, g.nr, g.nc};
    i3[ax] += dir;
    if (i3[ax] >= 0 && i3[ax] < n3[ax])
      nb = (i3[0] * g.nr + i3[1]) * g.nc + i3[2];
  }
  unsigned* ep = bar + 1;
  unsigned epoch = base;
  __syncthreads();
  for (int it = 0; it < n_inner; ++it) {
    const bool last = it == n_inner - 1;
    // the odd half-sweep, then its faces out and back in
    oct_half(sp, sf, g, x, 1, last, factor, idx2, idy2, idz2);
    __syncthreads();
    oct_faces(q, sp, g, x, code, nf, 1, false);
    publish_epoch(ep, ++epoch);
    wait_epoch(ep, nb, epoch);
    oct_faces(q, sp, g, x, code, nf, 1, true);
    __syncthreads();
    // the even half-sweep and the tile's Neumann copies
    oct_half(sp, sf, g, x, 0, last, factor, idx2, idy2, idz2);
    __syncthreads();
    oct_neumann_tile(sp, g, x);
    __syncthreads();
    if (!last) {
      oct_faces(q, sp, g, x, code, nf, 0, false);
      publish_epoch(ep, ++epoch);
      wait_epoch(ep, nb, epoch);
      oct_faces(q, sp, g, x, code, nf, 0, true);
      __syncthreads();
    }
  }
  // the tile's own cells back to p, rows of tc cells
  for (RowWalk w(g.ts, g.tr, g.tc); w.r < w.rows; w.next()) {
    if (w.col >= x.ec || w.a >= x.es || w.b >= x.er) continue;
    __stcg(q + (w.o * S + (x.s0 + w.a) * PL + (x.r0 + w.b) * g.I2 + x.c0 +
                w.col),
           sp[obox(x, w.o, w.a + (w.o >> 2), w.b + ((w.o >> 1) & 1),
                   w.col + (w.o & 1))]);
  }
  // its partial of r^2 to partial[t]; the last CTA to take the ticket
  // (bar[0], left at 0) adds the partials in tile order
  const T acc = seq_sum(sf, 8 * x.TV, ws);
  __shared__ bool last_cta;
  if (threadIdx.x == 0) {
    __stcg(partial + t, acc);
    __threadfence();
    last_cta = atomicAdd(bar, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last_cta && threadIdx.x == 0) {
    __threadfence();
    T v = T(0);
    for (int p = 0; p < (int)gridDim.x; ++p) v += __ldcg(partial + p);
    out[0] = v;
    *bar = 0u;
  }
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

// K6 on chip: geo = [K2, J2, I2, ts, tr, tc, ns, nr, nc, smem bytes]
// (ops/sor3d_kernels.octant_geometry); partial holds ns nr nc values; bar
// is the ticket (an unsigned 0 the launch leaves at 0) and then one epoch
// word a tile, all older than base; the call uses epochs base + 1 ..
// base + 2 n_inner - 1
template <typename T>
int run_octants_onchip(int dev, T* q, const T* f, const int* geo,
                       int n_inner, double factor, double idx2, double idy2,
                       double idz2, T* partial, unsigned* bar, unsigned base,
                       T* out, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const OTiles g{geo[0], geo[1], geo[2], geo[3], geo[4],
                 geo[5], geo[6], geo[7], geo[8]};
  const int smem = geo[9];
  const int tiles = g.ns * g.nr * g.nc;
  // per card, the largest shared memory set so far and how many CTAs can
  // then be resident at once (0 without cooperative launch): queried once,
  // a call's host time is the CLI's cost at small shapes
  constexpr int CARDS = 64;
  static int smem_set[CARDS], resident[CARDS];
  if (dev < 0 || dev >= CARDS) return (int)cudaErrorInvalidDevice;
  if (smem_set[dev] < smem) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaFuncSetAttribute(oct_onchip<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, oct_onchip<T>, OT, smem)) != cudaSuccess)
      return (int)e;
    smem_set[dev] = smem;
    resident[dev] = coop ? per_sm * sms : 0;
  }
  // every tile's CTA must be resident at once (the neighbour waits)
  if (tiles > OT || tiles > resident[dev])
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const T tf = T(factor), tx = T(idx2), ty = T(idy2), tz = T(idz2);
  void* args[] = {&q,         &f,         (void*)&g, &n_inner,
                  (void*)&tf, (void*)&tx, (void*)&ty, (void*)&tz,
                  &partial,   &bar,       &base,     &out};
  e = cudaLaunchCooperativeKernel((const void*)oct_onchip<T>, dim3(tiles),
                                  dim3(OT), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

#define OCT_ONCHIP_ENTRY(NAME, T)                                            \
  int NAME(int dev, void* q, const void* f, const int* geo, int n_inner,     \
           double factor, double idx2, double idy2, double idz2,             \
           void* partial, void* bar, unsigned base, void* out,               \
           void* stream) {                                                   \
    return run_octants_onchip<T>(dev, (T*)q, (const T*)f, geo, n_inner,      \
                                 factor, idx2, idy2, idz2, (T*)partial,      \
                                 (unsigned*)bar, base, (T*)out,              \
                                 (cudaStream_t)stream);                      \
  }

OCT_ONCHIP_ENTRY(rb_sor3d_octants_onchip_f32, float)
OCT_ONCHIP_ENTRY(rb_sor3d_octants_onchip_f64, double)

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
