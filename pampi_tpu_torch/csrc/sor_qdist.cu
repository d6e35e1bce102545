// Per-shard red-black SOR of the distributed quarter layout, for Hopper
// (sm_90a): kernel K13.
//
// rb_sor_qdist replaces pampi_tpu/ops/sor_qdist.py _qdist_kernel
//   (make_rb_iters_qdist): n red-black iterations, each with the globally
//   gated homogeneous-Neumann wall refresh, on one shard's stacked quarter
//   plane (4, jq, iq) = [R0, R1, B0, B1] of
//   pampi_tpu_torch/parallel/quarters_dist.py. It reads the plane and writes
//   the new plane into out (out of place: a CTA reads its neighbours' cells
//   while they write).
//
// Stored cell (r, c) of every slot is global quarter cell
//   (gqr, gqc) = (r - n + qoff_j, c - n + qoff_i),
// where n is the plane's ghost depth and (qoff_j, qoff_i) are the shard's
// global quarter offsets, passed as arguments (the TPU kernel takes them by
// scalar prefetch). What each cell does follows from that position alone:
//   - update when it lies in the plane's interior (the outermost stored
//     ring stays frozen) and in the global interior of its slot's parity;
//   - the eight wall selects, gated by global position and clipped
//     tangentially to the global interior, in the TPU kernel's order;
//   - count r^2 of the LAST iteration when it lies in the shard's owned
//     region (ghost cells are the neighbours' cells, recomputed here).
// parallel/quarters_dist.q_masks holds the same formulas; keep the two in
// lockstep.
//
// What bounds it on the H100: memory bandwidth at the least (~10 flops per
// cell update). The least any implementation moves per call is the plane
// and its rhs read once and the plane written once; a 2048^2 shard at n = 4
// (4 x 1033^2 cells, float32) is 51 MB, ~15 us at 3.35 TB/s.
//
// Design: temporal blocking in shared memory, one launch a call, as the
// TPU kernel keeps a band of rows in VMEM for all n iterations
// (csrc/sor_tiles2d.cuh does the same for K15 and masked K2). The plane is
// cut into owned tiles (th, tw) of (row, column) that partition it, frozen
// ring included, each tile covering the same cells of all four slots
// (ops/sor_qdist.qdist_tiles). A CTA loads its tile with a halo of ht
// cells a side, clipped to the plane, into shared memory (the four slots of
// p and of rhs), and runs the iterations there, in the TPU kernel's order: red (R0 and R1 read
// only B0 and B1), a __syncthreads(), black (B0 and B1 read the new R0 and
// R1), a __syncthreads(), the eight same-index wall selects applied in
// order to each cell of the wall rows and columns in registers, a
// __syncthreads(). In quarter space each slot reads the other colour one
// cell away on one side per axis only (even rows below, odd rows above;
// even columns left, odd columns right), so a cell of the box updates
// wherever its stencil stays in the box, the box's outer ring included
// (the plane's own ring stays frozen); a cell that cannot update goes
// stale, and so do the cells that read it, one quarter cell further in
// each iteration; the wall selects read and write one index and reach no
// further. So ht = n: tests/test_torch_sor_tiles.py shows n enough and
// n - 1 not. The owned cells go to out once. The residual is
// csrc/sor_tiles2d.cuh's tile_residual over the tile's cells, slot by
// slot. What bounds it: the issue rate of the sweeps over
// the boxes' cells (the halo adds (th + 2ht)(tw + 2ht) / (th tw) - 1 of
// the owned cells), as K15's.
//
// Arithmetic keeps the reference association term for term:
//   r = rhs - ((e - 2c + w)*idx2 + (n - 2c + s)*idy2);  p = c - factor*r
// built with --fmad=false so no multiply-add is contracted.

#include <cuda_pipeline.h>

#include "sor_tiles2d.cuh"

namespace {

using tiles2d::NT;
using tiles2d::TX;
using tiles2d::TY;

// the box's load: each thread issues its cells' copies from device memory
// to shared memory without waiting for any (cp.async), then waits for all
// of them, and the CTA meets at a barrier
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}

__device__ __forceinline__ void copy_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

struct Geom {
  int jq, iq;        // stored plane
  int jl2, il2;      // owned quarter rows / columns per parity
  int n;             // the plane's ghost depth (quarter rows)
  int iters;         // iterations of this pass
  int jmax2, imax2;  // global quarter extents
  int qoff_j, qoff_i;
  int ht;            // the tiles' halo
  int th, tw;        // owned tile extents
  int rows, P;       // rows of the largest box, row pitch (elements)
};

template <typename T>
__device__ __forceinline__ T resid(T c, T rhs, T w, T e, T s, T n, T idx2,
                                   T idy2) {
  return rhs - ((e - T(2) * c + w) * idx2 + (n - T(2) * c + s) * idy2);
}

// global interior of a parity along one axis: even quarter rows hold
// grid rows 2*gqr (1..jmax), odd ones 2*gqr+1
__device__ __forceinline__ bool inside(int parity, int gq, int max2) {
  return parity == 0 ? (gq >= 1 && gq <= max2) : (gq >= 0 && gq <= max2 - 1);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
qd_tiled(const T* __restrict__ q, const T* __restrict__ f,
         T* __restrict__ out, Geom g, T factor, T idx2, T idy2,
         T* __restrict__ partial, unsigned* __restrict__ ticket,
         T* __restrict__ res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t S = (size_t)g.jq * g.iq;   // a slot of the plane
  const int P = g.P, SS = g.rows * g.P;   // a slot of the box
  T* sp = reinterpret_cast<T*>(smem);
  T* sr = sp + 4 * SS;  // rhs, then the last iteration's r^2
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int j0 = blockIdx.y * g.th, j1 = min(g.jq, j0 + g.th);
  const int i0 = blockIdx.x * g.tw, i1 = min(g.iq, i0 + g.tw);
  const int bj0 = max(0, j0 - g.ht), bi0 = max(0, i0 - g.ht);
  const int R = min(g.jq, j1 + g.ht) - bj0;
  const int W = min(g.iq, i1 + g.ht) - bi0;
  const int ta = j0 - bj0, tb = i0 - bi0;  // the tile's first box cell
  for (int s = 0; s < 4; ++s)
    for (int a = ty; a < R; a += TY) {
      const size_t row = s * S + (size_t)(bj0 + a) * g.iq + bi0;
      for (int b = tx; b < W; b += TX) {
        copy_async(sp + s * SS + a * P + b, q + row + b);
        copy_async(sr + s * SS + a * P + b, f + row + b);
      }
    }
  copy_wait();
  // global quarter index of box cell (0, 0)
  const int gr0 = bj0 - g.n + g.qoff_j, gc0 = bi0 - g.n + g.qoff_i;
  // per parity, the box rows and columns that update, in the global
  // interior: an even row reads the row below it and an odd row the row
  // above (even columns the column left, odd ones right), so an edge of
  // the box inside the plane stops only the parity that reads across it;
  // where the box's edge is the plane's, its ring stays frozen
  const int pj0 = bj0 == 0, pj1 = bj0 + R == g.jq;
  const int pi0 = bi0 == 0, pi1 = bi0 + W == g.iq;
  const int alo0 = max(1, 1 - gr0), ahi0 = min(R - 1 - pj1, g.jmax2 - gr0);
  const int alo1 = max(pj0, -gr0), ahi1 = min(R - 2, g.jmax2 - 1 - gr0);
  const int blo0 = max(1, 1 - gc0), bhi0 = min(W - 1 - pi1, g.imax2 - gc0);
  const int blo1 = max(pi0, -gc0), bhi1 = min(W - 2, g.imax2 - 1 - gc0);
  T* R0 = sp;
  T* R1 = sp + SS;
  T* B0 = sp + 2 * SS;
  T* B1 = sp + 3 * SS;
  // the updates of slot s over its box rows [alo_, ahi_] and columns
  // [blo_, bhi_]: X the slot, its neighbours w, e, so, no at offsets from
  // the cell in the other colour's slots; in the last iteration each r^2
  // goes where its rhs was
  auto sweep = [&](int s, T* X, int alo_, int ahi_, int blo_, int bhi_,
                   const T* Y, int dw, int de, const T* Z, int ds, int dn,
                   bool last) {
    for (int a = alo_ + ty; a <= ahi_; a += TY)
      for (int b = blo_ + tx; b <= bhi_; b += TX) {
        const int x = a * P + b;
        const T c = X[x];
        const T r = resid(c, sr[s * SS + x], Y[x + dw], Y[x + de], Z[x + ds],
                          Z[x + dn], idx2, idy2);
        X[x] = c - factor * r;
        if (last) sr[s * SS + x] = r * r;
      }
  };
  // the wall rows gqr = 0, jmax/2 and columns gqc = 0, imax/2 in the box
  const int arow_lo = -gr0, arow_hi = g.jmax2 - gr0;
  const int bcol_lo = -gc0, bcol_hi = g.imax2 - gc0;
  for (int t = 0; t < g.iters; ++t) {
    const bool last = t == g.iters - 1;
    // red: R0 (even, even) and R1 (odd, odd) read only B0 and B1
    // R0: W=B0[c-1] E=B0[c] S=B1[r-1] N=B1[r]
    sweep(0, R0, alo0, ahi0, blo0, bhi0, B0, -1, 0, B1, -P, 0, last);
    // R1: W=B1[c] E=B1[c+1] S=B0[r] N=B0[r+1]
    sweep(1, R1, alo1, ahi1, blo1, bhi1, B1, 0, 1, B0, 0, P, last);
    __syncthreads();
    // black: B0 (even, odd) and B1 (odd, even) read the new R0 and R1
    // B0: W=R0[c] E=R0[c+1] S=R1[r-1] N=R1[r]
    sweep(2, B0, alo0, ahi0, blo1, bhi1, R0, 0, 1, R1, -P, 0, last);
    // B1: W=R1[c-1] E=R1[c] S=R0[r] N=R0[r+1]
    sweep(3, B1, alo1, ahi1, blo0, bhi0, R1, -1, 0, R0, 0, P, last);
    __syncthreads();
    // the Neumann wall refresh: thread u takes one box cell of the wall
    // rows (u < 2W) or of the wall columns (cells on a wall row are left
    // to the row threads) and applies the eight same-index selects to it
    // in the TPU kernel's order
    for (int u = tid; u < 2 * (W + R); u += NT) {
      int a, b;
      if (u < 2 * W) {
        a = u < W ? arow_lo : arow_hi;
        b = u < W ? u : u - W;
      } else {
        const int v = u - 2 * W;
        b = v < R ? bcol_lo : bcol_hi;
        a = v < R ? v : v - R;
        if (a == arow_lo || a == arow_hi) continue;
      }
      if (a < 0 || a >= R || b < 0 || b >= W) continue;
      const int gqr = gr0 + a, gqc = gc0 + b;
      const bool ri0 = inside(0, gqr, g.jmax2), ri1 = inside(1, gqr, g.jmax2);
      const bool ci0 = inside(0, gqc, g.imax2), ci1 = inside(1, gqc, g.imax2);
      const int x = a * P + b;
      T r0 = R0[x], r1 = R1[x], b0 = B0[x], b1 = B1[x];
      // p[0,i] = p[1,i] (even i, odd i); p[J+1,i] = p[J,i] (odd i, even i)
      if (gqr == 0 && ci0) r0 = b1;
      if (gqr == 0 && ci1) b0 = r1;
      if (gqr == g.jmax2 && ci1) r1 = b0;
      if (gqr == g.jmax2 && ci0) b1 = r0;
      // p[j,0] = p[j,1] (even j, odd j); p[j,I+1] = p[j,I] (even j, odd j)
      if (gqc == 0 && ri0) r0 = b0;
      if (gqc == 0 && ri1) b1 = r1;
      if (gqc == g.imax2 && ri0) b0 = r0;
      if (gqc == g.imax2 && ri1) r1 = b1;
      R0[x] = r0;
      R1[x] = r1;
      B0[x] = b0;
      B1[x] = b1;
    }
    __syncthreads();
  }
  // the tile's cells go out, and thread (tx, ty) adds the owned r^2 of the
  // same cells in the same order (the tile's order, slot by slot): every
  // owned cell updates, and a slot's owned cells are one rectangle (owned
  // stored rows and columns: [n+1, n+half] even, [n, n+half-1] odd)
  T acc = T(0);
  for (int s = 0; s < 4; ++s) {
    const int r0 = g.n + (s == 0 || s == 2 ? 1 : 0) - bj0;
    const int c0 = g.n + (s == 0 || s == 3 ? 1 : 0) - bi0;
    for (int a = ta + ty; a < ta + j1 - j0; a += TY) {
      const size_t row = s * S + (size_t)(bj0 + a) * g.iq + bi0;
      const bool arow = a >= r0 && a < r0 + g.jl2;
      for (int b = tb + tx; b < tb + i1 - i0; b += TX) {
        out[row + b] = sp[s * SS + a * P + b];
        if (arow && b >= c0 && b < c0 + g.il2) acc += sr[s * SS + a * P + b];
      }
    }
  }
  __syncthreads();
  tiles2d::tile_residual(acc, sp, partial, ticket, res);
}

template <typename T>
int run_qdist(int dev, const T* q, const T* f, T* out, const int* geo,
              double factor, double idx2, double idy2, T* partial,
              unsigned* ticket, T* res, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const Geom g{geo[0], geo[1], geo[2],  geo[3],  geo[4],  geo[5],
               geo[6], geo[7], geo[8],  geo[9],  geo[10], geo[11],
               geo[12], geo[13], geo[14]};
  const int smem = geo[15];
  e = cudaFuncSetAttribute(qd_tiled<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd((g.iq + g.tw - 1) / g.tw, (g.jq + g.th - 1) / g.th);
  qd_tiled<T><<<grd, dim3(TX, TY), smem, st>>>(q, f, out, g, T(factor),
                                               T(idx2), T(idy2), partial,
                                               ticket, res);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// geo = [jq, iq, jl/2, il/2, n, iters, jmax/2, imax/2, qoff_j, qoff_i, ht,
//        th, tw, rows, P, smem bytes] (ops/sor_qdist.
// qdist_pass_plan); partial holds one value per tile, ticket an unsigned 0
// that the kernel leaves at 0
#define QDIST_ENTRY(NAME, T)                                                  \
  int NAME(int dev, const void* q, const void* f, void* out, const int* geo, \
           double factor, double idx2, double idy2, void* partial,           \
           void* ticket, void* res, void* stream) {                          \
    return run_qdist<T>(dev, (const T*)q, (const T*)f, (T*)out, geo, factor,  \
                        idx2, idy2, (T*)partial, (unsigned*)ticket, (T*)res,  \
                        (cudaStream_t)stream);                                \
  }

QDIST_ENTRY(rb_sor_qdist_f32, float)
QDIST_ENTRY(rb_sor_qdist_f64, double)

}  // extern "C"
