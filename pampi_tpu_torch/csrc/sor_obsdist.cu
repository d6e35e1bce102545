// Per-shard flag-masked red-black SOR of a 2-D mesh, for Hopper (sm_90a):
// kernel K15.
//
// rb_sor_obsdist replaces pampi_tpu/ops/sor_obsdist.py _obsdist_kernel
//   (make_rb_iters_obsdist): n red-black iterations, each with the globally
//   gated homogeneous-Neumann wall refresh, on one shard's (jl+2H, il+2H)
//   deep block p, with per-direction fluid coefficients formed from the
//   shard's uint8 deep flag block. It reads p and writes the new block into
//   out (out of place: a CTA reads its neighbours' cells while they write).
//
// Deep cell (a, b) is global extended cell
//   (gj, gi) = (a - H + joff + 1, b - H + ioff + 1),
// where (joff, ioff) are the shard's global offsets, passed as arguments
// (the TPU kernel takes them by scalar prefetch). What each cell does
// follows from that position alone:
//   - update when it lies off the block's outermost ring (which stays
//     frozen: its neighbours are not stored), in the global interior, in
//     the colour (gi + gj) mod 2 of the half-sweep, and is fluid;
//   - the four wall selects, gated by global position and clipped
//     tangentially to the global interior, off the frozen ring;
//   - count r^2 of the LAST iteration when it lies in the shard's owned
//     region (ghost cells are the neighbours' cells, recomputed here).
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
// What bounds it on the H100: memory bandwidth at the least (~20 flops per
// cell update). The least any implementation moves per call is p, rhs and
// the flags read once and p written once: 13 bytes a cell at float32, ~22
// us for a 1366x4096 shard at n = 4 (a 1384x4114 deep block) at 3.35 TB/s.
//
// Design: temporal blocking in shared memory, one launch a call, as the
// TPU kernel keeps a band of rows in VMEM for all n iterations. The deep
// block is cut into owned tiles (th, tw) that partition it, frozen ring
// included (ops/sor_obsdist.obsdist_tiles). A CTA loads its tile with a
// halo of ht cells per side, clipped to the block, into shared memory (p,
// rhs, flags), and runs the n iterations there: the box's outermost ring
// stays frozen, as the block's does, so the box is a deep block of its
// own. ht = 2n + 1 (and at least the block's H): the sweeps reach 2n
// cells in from the box's edge, and a wall-ghost cell of the tile copies
// its inward neighbour after them, one cell further; so the owned cells
// come out exactly as the block's (the cells within ht of an inner box
// edge go stale and are not written). Each half-sweep maps the threads
// onto the cells of one colour only: a warp takes 32 columns of a pair of
// rows, each lane the one cell of the colour in its column, so
// neighbouring lanes read neighbouring words and, with an even row pitch,
// no two share a bank. A cell whose own flag and four neighbours' are all
// 1 takes the CTA's one fac and skips the eps products (eps*d is d for
// eps = 1: the same bits). A __syncthreads() after each half-sweep and
// after the four wall selects is each ordering point of the TPU kernel's
// in-order grid. The wall
// selects touch disjoint cells and read none that another writes. The
// owned cells go to out once; on the last iteration each CTA sums its
// owned r^2 in a fixed tree into a partial, and the last CTA to finish
// (an integer ticket, reset by that CTA) sums the partials in CTA order:
// no float atomics, so the residual and every iteration count are
// reproducible. What bounds it now: the issue rate of the half-sweeps'
// instructions over the box's cells (1.4x the owned cells at the timed
// shape), two CTAs an SM.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int NT = TX * TY;

struct Geom {
  int ej, ei;        // stored deep block: jl + 2H, il + 2H
  int jl, il;        // owned extents
  int n, H;          // iterations of this pass, deep-halo depth
  int jmax, imax;    // global interior extents
  int joff, ioff;    // the shard's global offsets
  int ht;            // the tiles' halo: ca_halo(n) of this pass
  int th, tw;        // owned tile extents
  int rows;          // rows of the largest box (the shared-memory layout)
  int P, Pf;         // row pitches: p and rhs (elements), flags (bytes)
};

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

template <typename T>
__global__ void __launch_bounds__(NT, 2)
od_fused(const T* __restrict__ p, const T* __restrict__ rhs,
         const uint8_t* __restrict__ fl, T* __restrict__ out, Geom g,
         T omega, T idx2, T idy2, T* __restrict__ partial,
         unsigned* __restrict__ ticket, T* __restrict__ res) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_cta;
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
      sp[a * P + b] = p[row + b];
      sr[a * P + b] = rhs[row + b];
      sf[a * Pf + b] = fl[row + b];
    }
  }
  __syncthreads();
  // global extended index of box cell (0, 0)
  const int gj0 = bj0 - g.H + g.joff + 1, gi0 = bi0 - g.H + g.ioff + 1;
  // the cells that update: off the box's frozen ring, in the global interior
  const int alo = max(1, 1 - gj0), ahi = min(R - 2, g.jmax - gj0);
  const int blo = max(1, 1 - gi0), bhi = min(W - 2, g.imax - gi0);
  // the tile's cells of the shard's owned region, whose r^2 counts
  const int oa0 = max(g.H, j0) - bj0, oa1 = min(g.H + g.jl, j1) - bj0;
  const int ob0 = max(g.H, i0) - bi0, ob1 = min(g.H + g.il, i1) - bi0;
  // the wall rows gj = 0, jmax+1 and columns gi = 0, imax+1 in the box
  const int arow_lo = -gj0, arow_hi = g.jmax + 1 - gj0;
  const int bcol_lo = -gi0, bcol_hi = g.imax + 1 - gi0;
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
          if (last && a >= oa0 && a < oa1 && b >= ob0 && b < ob1)
            rr += r * r;
        }
      }
      __syncthreads();
    }
    // the Neumann wall refresh: each select copies the inward interior
    // neighbour; rows clip to the interior columns, columns to the
    // interior rows, all four stay off the box's frozen ring
    for (int u = tid; u < 2 * (nrow + ncol); u += NT) {
      int a, b, src;
      if (u < 2 * nrow) {
        const int hi = u >= nrow;
        a = hi ? arow_hi : arow_lo;
        b = blo + u - hi * nrow;
        if (a < 1 || a > R - 2) continue;
        src = (hi ? a - 1 : a + 1) * P + b;
      } else {
        const int v = u - 2 * nrow, hi = v >= ncol;
        b = hi ? bcol_hi : bcol_lo;
        a = alo + v - hi * ncol;
        if (b < 1 || b > W - 2) continue;
        src = a * P + (hi ? b - 1 : b + 1);
      }
      sp[a * P + b] = sp[src];
    }
    __syncthreads();
  }
  for (int a = j0 - bj0 + ty; a < j1 - bj0; a += TY) {
    const size_t row = (size_t)(bj0 + a) * g.ei + bi0;
    for (int b = i0 - bi0 + tx; b < i1 - bi0; b += TX)
      out[row + b] = sp[a * P + b];
  }
  __syncthreads();
  // the residual: this CTA's partial, then the last CTA sums them in order
  const T s = block_tree(rr, sp);
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
    const T total = block_tree(v, sp);
    if (tid == 0) {
      res[0] = total;
      *ticket = 0u;
    }
  }
}

template <typename T>
int run_obsdist(int dev, const T* p, const T* rhs, const uint8_t* fl, T* out,
                Geom g, int smem, double omega, double idx2, double idy2,
                T* partial, unsigned* ticket, T* res, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(od_fused<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd((g.ei + g.tw - 1) / g.tw, (g.ej + g.th - 1) / g.th);
  od_fused<T><<<grd, dim3(TX, TY), smem, st>>>(
      p, rhs, fl, out, g, T(omega), T(idx2), T(idy2), partial, ticket, res);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// geo = [ej, ei, jl, il, n, H, jmax, imax, joff, ioff, ht, th, tw, rows, P,
//        Pf, smem bytes] (ops/sor_obsdist._pass_plan); partial holds one
// value per tile, ticket an unsigned 0 that the kernel leaves at 0
#define OBSDIST_ENTRY(NAME, T)                                                \
  int NAME(int dev, const void* p, const void* rhs, const void* fl,           \
           void* out, const int* geo, double omega, double idx2, double idy2, \
           void* partial, void* ticket, void* res, void* stream) {            \
    const Geom g{geo[0],  geo[1],  geo[2],  geo[3],  geo[4],  geo[5],         \
                 geo[6],  geo[7],  geo[8],  geo[9],  geo[10], geo[11],        \
                 geo[12], geo[13], geo[14], geo[15]};                         \
    return run_obsdist<T>(dev, (const T*)p, (const T*)rhs,                    \
                          (const uint8_t*)fl, (T*)out, g, geo[16], omega,     \
                          idx2, idy2, (T*)partial, (unsigned*)ticket,         \
                          (T*)res, (cudaStream_t)stream);                     \
  }

OBSDIST_ENTRY(rb_sor_obsdist_f32, float)
OBSDIST_ENTRY(rb_sor_obsdist_f64, double)

}  // extern "C"
