// The temporally blocked 2-D red-black SOR shared by kernel K15
// (csrc/sor_obsdist.cu, a shard's deep block) and the masked mode of K2
// (csrc/sor_rb.cu, a whole single-device field), and the per-tile residual
// that K13 (csrc/sor_qdist.cu) takes too. Header only; each including
// source instantiates what it launches.
//
// The block: deep cell (a, b) of an (ej, ei) block is global extended cell
//   (gj, gi) = (a - H + joff + 1, b - H + ioff + 1).
// K15 passes a shard's deep block (H = ca_halo(n) >= 2, its outermost ring
// frozen: its neighbours are not stored). Masked K2 passes the whole
// (J+2, I+2) field as a block of H = 1 at offsets 0: its outermost ring is
// the wall-ghost ring, which the wall selects write (corners untouched),
// as cb_neumann did. What each cell does follows from its position alone:
//   - update when it lies off the box's outermost ring, in the global
//     interior, in the colour (gi + gj) mod 2 of the half-sweep, and is
//     fluid (flag != 0);
//   - the four wall selects, gated by global position and clipped
//     tangentially to the global interior;
//   - count r^2 of the LAST iteration when it lies in the owned region
//     (ghost cells are the neighbours' cells, recomputed here).
// pampi_tpu_torch/ops/sor_obsdist.obsdist_masks holds the same formulas;
// keep the two in lockstep.
//
// Coefficients (sor_pallas.masked_stencil_ops): eps_E/W/N/S are the
// neighbours' flags, denom = (eps_E + eps_W)*idx2 + (eps_N + eps_S)*idy2,
// fac = (denom > 0 ? omega/denom : 0) * flag;
//   r = rhs - ((eps_E*(e - c) + eps_W*(w - c))*idx2
//              + (eps_N*(n - c) + eps_S*(s - c))*idy2);   p = c - fac*r.
// Built with --fmad=false, so no multiply-add is contracted and the kernel
// equals its plain version bit for bit.
//
// Design: temporal blocking in shared memory, one launch a call, as the
// TPU kernel keeps a band of rows in VMEM for all n iterations. The block
// is cut into owned tiles (th, tw) that partition it, outer ring included
// (ops/sor_obsdist.obsdist_tiles). A CTA loads its tile with a halo of ht
// cells per side, clipped to the block, into shared memory (p, rhs,
// flags), and runs the n iterations there: the box's outermost ring stays
// frozen where it lies inside the block, so the box is a block of its
// own. ht = 2n + 1: the sweeps reach 2n cells in from the box's edge, and
// a wall-ghost cell of the tile copies its inward neighbour after them,
// one cell further; so the owned cells come out exactly as the block's
// (the cells within ht of an inner box edge go stale and are not
// written). Each half-sweep maps the threads onto the cells of one colour
// only: a warp takes 32 columns of a pair of rows, each lane the one cell
// of the colour in its column, so neighbouring lanes read neighbouring
// words and, with an even row pitch, no two share a bank. A cell whose own
// flag and four neighbours' are all 1 takes the CTA's one fac and skips
// the eps products (eps*d is d for eps = 1: the same bits). A
// __syncthreads() after each half-sweep and after the four wall selects is
// each ordering point of the TPU kernel's in-order grid. The wall selects
// touch disjoint cells and read none that another writes. The owned cells
// go to out once (out of place: a CTA reads its neighbours' cells while
// they write).
//
// Residual: each thread adds its owned r^2 of the last iteration, a fixed
// halving tree over tid = TX ty + tx sums the threads into the CTA's
// partial, and the last CTA to finish (an integer ticket, reset by that
// CTA) adds the partials in CTA order (thread t takes partials t, t + NT,
// ..., then the tree): tile_residual, which K13 takes too. No float
// atomics, so the residual and every iteration count are reproducible.
// What a thread adds, and in which order, is FIELD's choice:
//   - FIELD = false (K15): the owned updates of the last iteration, in the
//     order the thread makes them (its plain version sums in another
//     order: the two residuals agree to rounding);
//   - FIELD = true (masked K2): in the last iteration each update leaves
//     its r^2 in its own rhs slot of the box (no other update reads that
//     rhs again; a cell off the fluid, which never updates, loads 0 there),
//     and as it writes the tile's cells out, thread (tx, ty) adds the
//     owned r^2 of its cells (ty + TY k, tx + TX m), k-major (K13: slot by
//     slot): ops/sor_kernels.tile_partials repeats that order bit for bit.
// FIELD also makes the box's outer ring frozen (false: a deep block's) or
// the field's wall-ghost ring (true), so K15's instantiation carries no
// test, load or store that only masked K2 needs. What bounds it: the issue
// rate of the half-sweeps' instructions over the box's cells (1.4x the
// owned cells at K15's timed shape), two CTAs an SM.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tiles2d {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int NT = TX * TY;

// the fixed halving tree over the block's threads; sh holds NT values
template <typename T>
__device__ T block_tree(T v, T* sh) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  return sh[0];
}

// The residual's two fixed-order sums: this CTA's thread sums `acc` into
// partial[cta], then the last CTA to take a ticket adds the partials in
// CTA order into res[0] and resets the ticket. sh holds NT values and is
// free; every thread of the CTA calls it.
template <typename T>
__device__ void tile_residual(T acc, T* sh, T* __restrict__ partial,
                              unsigned* __restrict__ ticket,
                              T* __restrict__ res) {
  __shared__ bool last_cta;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const T s = block_tree(acc, sh);
  const int nb = gridDim.x * gridDim.y;
  if (tid == 0) {
    partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
    __threadfence();
    last_cta = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (last_cta) {
    T v = T(0);
    for (int k = tid; k < nb; k += NT) v += __ldcg(partial + k);
    const T total = block_tree(v, sh);
    if (tid == 0) {
      res[0] = total;
      *ticket = 0u;
    }
  }
}

struct Geom {
  int ej, ei;        // stored block: jl + 2H, il + 2H
  int jl, il;        // owned extents
  int n, H;          // iterations of this pass, depth of the block's halo
  int jmax, imax;    // global interior extents
  int joff, ioff;    // the block's global offsets
  int ht;            // the tiles' halo
  int th, tw;        // owned tile extents
  int rows;          // rows of the largest box (the shared-memory layout)
  int P, Pf;         // row pitches: p and rhs (elements), flags (bytes)
};

template <typename T, bool FIELD>
__global__ void __launch_bounds__(NT, 2)
rb_tiled(const T* __restrict__ p, const T* __restrict__ rhs,
         const uint8_t* __restrict__ fl, T* __restrict__ out, Geom g,
         T omega, T idx2, T idy2, T* __restrict__ partial,
         unsigned* __restrict__ ticket, T* __restrict__ res) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sp = reinterpret_cast<T*>(smem);
  T* sr = sp + (size_t)g.rows * g.P;
  uint8_t* sf = reinterpret_cast<uint8_t*>(sr + (size_t)g.rows * g.P);
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int P = g.P, Pf = g.Pf;
  // the owned tile and its box (the tile and ht cells a side, clipped)
  const int j0 = blockIdx.y * g.th, j1 = min(g.ej, j0 + g.th);
  const int i0 = blockIdx.x * g.tw, i1 = min(g.ei, i0 + g.tw);
  const int bj0 = max(0, j0 - g.ht), bi0 = max(0, i0 - g.ht);
  const int R = min(g.ej, j1 + g.ht) - bj0;
  const int W = min(g.ei, i1 + g.ht) - bi0;
  for (int a = ty; a < R; a += TY) {
    const size_t row = (size_t)(bj0 + a) * g.ei + bi0;
    for (int b = tx; b < W; b += TX) {
      if (FIELD) {
        // rhs loaded before the flag that selects it is known (a load
        // that waits for the flag was slower, PERF.md); a cell off the
        // fluid never reads its rhs, and 0 there keeps it out of the
        // residual
        const T pv = p[row + b], rv = rhs[row + b];
        const uint8_t f = fl[row + b];
        sp[a * P + b] = pv;
        sr[a * P + b] = f != 0 ? rv : T(0);
        sf[a * Pf + b] = f;
      } else {
        sp[a * P + b] = p[row + b];
        sr[a * P + b] = rhs[row + b];
        sf[a * Pf + b] = fl[row + b];
      }
    }
  }
  __syncthreads();
  // global extended index of box cell (0, 0)
  const int gj0 = bj0 - g.H + g.joff + 1, gi0 = bi0 - g.H + g.ioff + 1;
  // the cells that update: off the box's frozen ring, in the global interior
  const int alo = max(1, 1 - gj0), ahi = min(R - 2, g.jmax - gj0);
  const int blo = max(1, 1 - gi0), bhi = min(W - 2, g.imax - gi0);
  // the tile's cells of the block's owned region, whose r^2 counts
  // (FIELD takes them after the iterations, where they hold no register)
  const auto owned = [&](int& a0, int& a1, int& b0, int& b1) {
    a0 = max(g.H, j0) - bj0, a1 = min(g.H + g.jl, j1) - bj0;
    b0 = max(g.H, i0) - bi0, b1 = min(g.H + g.il, i1) - bi0;
  };
  int oa0 = 0, oa1 = 0, ob0 = 0, ob1 = 0;
  if (!FIELD) owned(oa0, oa1, ob0, ob1);
  // the wall rows gj = 0, jmax+1 and columns gi = 0, imax+1 in the box;
  // they lie on the box's outer ring only where that ring is a field's
  // wall-ghost ring (FIELD), which they write
  const int arow_lo = -gj0, arow_hi = g.jmax + 1 - gj0;
  const int bcol_lo = -gi0, bcol_hi = g.imax + 1 - gi0;
  constexpr int ring = FIELD ? 0 : 1;
  const int nrow = max(0, bhi - blo + 1), ncol = max(0, ahi - alo + 1);
  // fac of a fluid cell whose four neighbours are fluid (all flags 1),
  // formed as every cell's is
  const T one = T(1u);
  const T denom_one = (one + one) * idx2 + (one + one) * idy2;
  const T fac_one = (denom_one > T(0) ? omega / denom_one : T(0)) * one;
  T rr = T(0);
  for (int t = 0; t < g.n; ++t) {
    const bool last = t == g.n - 1;
    for (int colour = 0; colour < 2; ++colour) {
      // a pair of rows holds one cell of the colour in each column
      for (int m = (alo >> 1) + ty; 2 * m <= ahi; m += TY) {
        for (int b = blo + tx; b <= bhi; b += TX) {
          const int a = 2 * m + ((gj0 + gi0 + b + colour) & 1);
          if (a < alo || a > ahi) continue;
          const int x = a * P + b, xf = a * Pf + b;
          const unsigned fc = sf[xf];
          if (fc == 0) continue;
          const unsigned fe = sf[xf + 1], fw = sf[xf - 1], fn = sf[xf + Pf],
                         fs = sf[xf - Pf];
          const T c = sp[x];
          const T de = sp[x + 1] - c, dw = sp[x - 1] - c;
          const T dn = sp[x + P] - c, ds = sp[x - P] - c;
          T fac, lap;
          if (((fc ^ 1u) | (fe ^ 1u) | (fw ^ 1u) | (fn ^ 1u) | (fs ^ 1u)) ==
              0) {
            // the flag and its neighbours' are 1: every eps is 1, eps*d
            // is d, and fac is the CTA's fac_one
            fac = fac_one;
            lap = (de + dw) * idx2 + (dn + ds) * idy2;
          } else {
            const T eps_e = T(fe), eps_w = T(fw);
            const T eps_n = T(fn), eps_s = T(fs);
            const T denom = (eps_e + eps_w) * idx2 + (eps_n + eps_s) * idy2;
            fac = (denom > T(0) ? omega / denom : T(0)) * T(fc);
            lap = (eps_e * de + eps_w * dw) * idx2 +
                  (eps_n * dn + eps_s * ds) * idy2;
          }
          const T r = sr[x] - lap;
          sp[x] = c - fac * r;
          if (FIELD) {
            if (last) sr[x] = r * r;  // this rhs is not read again
          } else if (last && a >= oa0 && a < oa1 && b >= ob0 && b < ob1) {
            rr += r * r;
          }
        }
      }
      __syncthreads();
    }
    // the Neumann wall refresh: each select copies the inward interior
    // neighbour; rows clip to the interior columns, columns to the
    // interior rows
    for (int u = tid; u < 2 * (nrow + ncol); u += NT) {
      int a, b, src;
      if (u < 2 * nrow) {
        const int hi = u >= nrow;
        a = hi ? arow_hi : arow_lo;
        b = blo + u - hi * nrow;
        if (a < ring || a > R - 1 - ring) continue;
        src = (hi ? a - 1 : a + 1) * P + b;
      } else {
        const int v = u - 2 * nrow, hi = v >= ncol;
        b = hi ? bcol_hi : bcol_lo;
        a = alo + v - hi * ncol;
        if (b < ring || b > W - 1 - ring) continue;
        src = a * P + (hi ? b - 1 : b + 1);
      }
      sp[a * P + b] = sp[src];
    }
    __syncthreads();
  }
  // the owned cells go out; FIELD: thread (tx, ty) adds the owned r^2 of
  // the same cells in the same order (the tile's order), where the field's
  // interior (the owned region, off the ring) holds the r^2 of every
  // update and 0 off the fluid
  if (FIELD) owned(oa0, oa1, ob0, ob1);
  for (int a = j0 - bj0 + ty; a < j1 - bj0; a += TY) {
    const size_t row = (size_t)(bj0 + a) * g.ei + bi0;
    const bool arow = a >= oa0 && a < oa1;
    for (int b = i0 - bi0 + tx; b < i1 - bi0; b += TX) {
      out[row + b] = sp[a * P + b];
      if (FIELD && arow && b >= ob0 && b < ob1) rr += sr[a * P + b];
    }
  }
  __syncthreads();
  tile_residual(rr, sp, partial, ticket, res);
}

template <typename T, bool FIELD>
int run_tiled(int dev, const T* p, const T* rhs, const uint8_t* fl, T* out,
              const int* geo, double omega, double idx2, double idy2,
              T* partial, unsigned* ticket, T* res, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const Geom g{geo[0],  geo[1],  geo[2],  geo[3],  geo[4],  geo[5],
               geo[6],  geo[7],  geo[8],  geo[9],  geo[10], geo[11],
               geo[12], geo[13], geo[14], geo[15]};
  const int smem = geo[16];
  e = cudaFuncSetAttribute(rb_tiled<T, FIELD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd((g.ei + g.tw - 1) / g.tw, (g.ej + g.th - 1) / g.th);
  rb_tiled<T, FIELD><<<grd, dim3(TX, TY), smem, st>>>(
      p, rhs, fl, out, g, T(omega), T(idx2), T(idy2), partial, ticket, res);
  return (int)cudaGetLastError();
}

}  // namespace tiles2d

// geo = [ej, ei, jl, il, n, H, jmax, imax, joff, ioff, ht, th, tw, rows, P,
//        Pf, smem bytes] (ops/sor_obsdist.pass_plan); partial holds one
// value per tile, ticket an unsigned 0 that the kernel leaves at 0
#define TILED2D_ENTRY(NAME, T, FIELD)                                         \
  int NAME(int dev, const void* p, const void* rhs, const void* fl,           \
           void* out, const int* geo, double omega, double idx2, double idy2, \
           void* partial, void* ticket, void* res, void* stream) {            \
    return tiles2d::run_tiled<T, FIELD>(                                      \
        dev, (const T*)p, (const T*)rhs, (const uint8_t*)fl, (T*)out, geo,    \
        omega, idx2, idy2, (T*)partial, (unsigned*)ticket, (T*)res,           \
        (cudaStream_t)stream);                                                \
  }
