// Red-black SOR for Hopper (sm_90a): the port's 2-D single-device solve
// kernels K1, K2 (with its masked mode) and K17.
//
// rb_sor_checkerboard (K2) replaces pampi_tpu/ops/sor_pallas.py
//   _tblock_kernel (make_rb_iter_tblock, plain mode) on the natural
//   (J+2, I+2) layout.
// rb_sor_quarters (K1) replaces pampi_tpu/ops/sor_pallas.py
//   _tblock_quarters_kernel (make_rb_iter_tblock_quarters) on the stacked
//   quarter planes (4, (J+2)/2, (I+2)/2) = [R0, R1, B0, B1].
//
// Both compute n_inner red-black iterations, each a red half-sweep, a black
// half-sweep that sees red's updates (Gauss-Seidel order), and the
// homogeneous-Neumann ghost refresh with corners untouched, and return the
// sum of r^2 over both half-sweeps of the LAST iteration.
//
// What bounds them on the H100: memory bandwidth at the least (~10 flops
// per cell update). The least any implementation must move per call is p
// and rhs read once and p written once; at 4096^2 f32 (67 MB a field)
// that is ~60 us at 3.35 TB/s, whatever n_inner is. Plain K2's half-sweep
// reads one colour's neighbours and rhs and writes that colour, so each of
// its iterations moves about 2.5 field-sizes.
//
// Plain K2 (and K17) keep the first design: a TPU grid runs its steps in
// order and carries the residual across them in SMEM; CUDA blocks run in
// no order, so every ordering point becomes a launch boundary. Per
// iteration: one launch per colour (in place; within a colour every cell
// reads only the other colour, so there is no hazard), then one Neumann
// launch. On the last iteration each block writes its partial sum of r^2
// (a fixed-order shared-memory tree), and a one-block launch sums the
// partials in a fixed order. No float atomics: the residual, and so every
// iteration count, is reproducible run to run.
//
// K1 (q_tiled) runs all n iterations of a call in one pass, one launch,
// out of place (the solve loop swaps two planes). The plane is cut into
// owned tiles (th, tw); a CTA's box is the tile and a halo of n quarter
// cells a side (each slot reads the other colour one cell away on one
// side per axis, so staleness from a box edge moves in one quarter cell an
// iteration and the same-index wall selects reach no further:
// tests/test_torch_k1_class_tiles.py shows n enough and n - 1 not). A
// thread owns one column of the box and QK consecutive rows of it, and
// holds those cells of all four slots of p and of rhs in registers for the
// whole call: of a cell's four neighbours three are its own (the same
// column) and one lies in the next column, read from shared memory, where
// each thread publishes its cells after each colour; the rows at the ends
// of its run read one more. So an update costs ~2 shared-memory accesses
// and ~12 arithmetic instructions, against 7 accesses in a box held
// wholly in shared memory (K13's template, which K1 bf16 keeps), and a
// pass of n iterations is red, publish R, barrier, black, the eight wall
// selects on the thread's own cells (same-index: no exchange), publish B,
// barrier. A box inside the plane's inner cells (no wall, no ghost: most
// of them) drops the per-cell predicates. The CTA: 64 columns by 4 runs
// of 8 rows at float32 (of 4 at float64), 256 threads, two CTAs an SM,
// the fastest of the shapes measured (PERF.md: 0.122 ms at 4096^2
// f32, n = 4, against the multi-launch design's 0.504 and K13's template
// run at ring 0, 0.213). Each thread adds its owned r^2 of the last
// iteration in its update order, a fixed tree over the CTA gives the
// tile's partial, and the last CTA to take an integer ticket adds the
// partials in tile order (ticket_sum); ops/sor_kernels.quarters_residual
// repeats that order, so
// kernel and plain version agree bitwise, residual included. A call too
// deep for one pass (the tile keeping half the box each way) runs
// several. Bound: the plane and its rhs read once and the plane written
// once, 12 bytes a cell at float32 (4 x 2049^2 cells at 4096^2: 0.060 ms
// at 3.35 TB/s); the halo adds (box/tile - 1) of reads (0.52 at float32,
// n = 4), the sweeps' issue rate the rest.
//
// Arithmetic keeps the reference association term for term:
//   r = rhs - ((e - 2c + w)*idx2 + (n - 2c + s)*idy2);  p = c - factor*r
// built with --fmad=false so no multiply-add is contracted.
//
// rb_sor_checkerboard_masked (K2's masked mode) replaces the masked mode of
//   the same TPU kernel (_tblock_kernel(masked=True), the NS-2D obstacle
//   solve, pampi_tpu/ops/obstacle.make_obstacle_solver_fn): a cell updates
//   only where it is interior, of the colour and fluid (flag != 0), with
//   per-direction coefficients formed from the uint8 flags in the kernel
//   (sor_pallas.masked_stencil_ops' order). It is the tiled template of
//   csrc/sor_tiles2d.cuh, K15's, on the whole (J+2, I+2) field as a block
//   of H = 1 at offsets 0, whose outer ring is the wall-ghost ring that the
//   tiles at the field's edge refresh inside the pass (sor_pallas.py:
//   252-255): all n iterations of a call in one pass through shared memory,
//   one launch a call, out of place (the caller swaps two fields), the
//   residual as per-tile partials summed by the last CTA in tile order
//   (ops/sor_kernels.tile_partials repeats it, so kernel and plain version
//   agree bitwise, residual included). Its bound: 13 bytes a cell at
//   float32 (p and rhs read, p written, the flags read), ~65 us at
//   8192x2048; what bounds it in fact is the issue rate of the sweeps over
//   the boxes' cells, as K15's (PERF.md).
//
// rb_sor_blocked (K17) replaces pampi_tpu/ops/sor_pallas.py _rb_kernel
//   (make_rb_iter_pallas, the blocked kernel of
//   models/poisson.make_rb_step_padded(kernel="blocked")): ONE red-black
//   iteration in place, the sum of r^2 over both half-sweeps, then the
//   Neumann ghost copy (the TPU caller's neumann_bc_padded). The TPU kernel
//   walks a (2, nblocks) grid of row bands in order, staging each band and
//   a halo in VMEM; its black phase sees the red phase's writes only
//   because the grid runs in order. Here a CTA owns a band of BAND rows
//   and walks it in column tiles of TILE cells, staging the tile plus one
//   halo row above and below and one halo column each side in shared
//   memory; each thread takes one column of the tile and relaxes the cells
//   of the launch's colour down the band, reading its neighbours from
//   shared memory. One launch per colour is the ordering point that the
//   TPU's sequential grid gave. Within a colour every cell reads only the
//   other colour, so staging a neighbour band's rows while its CTA writes
//   them is harmless (those cells are never read). Each thread adds r^2
//   over its tiles and rows in order, the CTA reduces its threads with a
//   fixed tree into one partial, and sum_partials adds the 2*nblocks
//   partials (red, then black) in a fixed order: the plain version
//   (ops/sor_kernels.rb_sor_blocked_plain) repeats that order, so the
//   residual is bitwise too. Its fields are K2's at n_inner = 1 bit for
//   bit (the same association). Bound: memory, as K2's (p and rhs read
//   once, p written once: 12 bytes a cell at float32); each colour launch
//   reads p and the colour's rhs, so a call moves about 2.5 field-sizes.
//
// rb_sor_class (K2's dynamic-extent mode) replaces the shape-class mode of
//   the same TPU kernel (_tblock_kernel(dynamic=True), make_rb_iter_tblock(
//   dynamic=True): the fleet's padded class solve, pampi_tpu/fleet/
//   shapeclass.make_padded_class_solve). A batch of N lanes, each a
//   (jc+2, ic+2) class block whose live corner is its own (J+2, I+2) grid;
//   each lane reads its extents (J, I), its update constants (factor,
//   idx2, idy2, in T) and its `solving` flag from device arrays, so one
//   build serves every grid of a class. cls_tiled runs all n iterations of
//   a call in one launch, out of place, the lane on blockIdx.z: a CTA is
//   one owned tile of a lane's block, the tiles' side a function of the
//   dtype and n only (ops/sor_kernels.class_tile), laid from the block's
//   corner; the box is the tile and a halo of 2n + 1 clipped to the lane's
//   live corner, held in shared memory, swept as masked K2's template
//   sweeps (csrc/sor_tiles2d.cuh) with the unmasked update, the wall ring
//   refreshed at the lane's extents. A CTA of a tile past the live corner,
//   or of a lane that is not solving, copies its tile from p to out and
//   does no sweep: out is whole, so the caller may alternate two blocks.
//   The residual: per tile in the masked template's order, then the lane's
//   last CTA (a ticket per lane) adds the lane's partials in the order of
//   the lane's own tile grid. Tiles and order depend on the lane's extents,
//   the dtype and n only, never on the class or the batchmates, so a lane
//   is bitwise the same in every rung; the plain version
//   (ops/sor_kernels.rb_sor_class_plain, class_residual) repeats the order.
//   At float32, n = 4 a 64^2 lane is one CTA. Bound: p and rhs read and p
//   written once on each lane's live corner.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sor_tiles2d.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int FIN = 1024;
constexpr int BAND = 8;    // K17: rows a CTA owns
constexpr int TILE = 256;  // K17: columns of a tile, one thread each

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
__device__ __forceinline__ T resid(T c, T rhs, T w, T e, T s, T n, T idx2,
                                   T idy2) {
  return rhs - ((e - T(2) * c + w) * idx2 + (n - T(2) * c + s) * idy2);
}

// one colour of the checkerboard, in place: cells (i+j)%2 == color,
// 1 <= i <= I, 1 <= j <= J; thread (t, row) takes the t-th cell of its row
template <typename T>
__global__ void cb_color(T* __restrict__ p, const T* __restrict__ rhs, int J,
                         int I, int color, T factor, T idx2, T idy2,
                         T* __restrict__ partial) {
  __shared__ T sh[NT];
  const int W = I + 2;
  const int j = 1 + blockIdx.y * BY + threadIdx.y;
  const int t = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (j <= J) {
    const int i = (((1 + j) & 1) == color ? 1 : 2) + 2 * t;
    if (i <= I) {
      const size_t k = (size_t)j * W + i;
      const T c = p[k];
      const T r = resid(c, rhs[k], p[k - 1], p[k + 1], p[k - W], p[k + W],
                        idx2, idy2);
      p[k] = c - factor * r;
      rr = r * r;
    }
  }
  if (partial != nullptr) {
    const T s = block_sum(rr, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// ghost copy on the four walls, corners untouched; the rows read are
// interior rows/columns that no thread of this launch writes
template <typename T>
__global__ void cb_neumann(T* __restrict__ p, int J, int I) {
  const size_t W = I + 2;
  const int k = 1 + blockIdx.x * blockDim.x + threadIdx.x;
  if (k <= I) {
    p[k] = p[W + k];
    p[(size_t)(J + 1) * W + k] = p[(size_t)J * W + k];
  }
  if (k <= J) {
    p[k * W] = p[k * W + 1];
    p[k * W + I + 1] = p[k * W + I];
  }
}

// K17: one colour over CTA b's band of rows [b*BAND, b*BAND + BAND) of the
// (J+2, I+2) array, tile by tile (TILE threads, one column each); partial[b]
// = the CTA's sum of r^2 in the fixed order described at the top
template <typename T>
__global__ void blk_color(T* __restrict__ p, const T* __restrict__ rhs,
                          int J, int I, int color, T factor, T idx2, T idy2,
                          T* __restrict__ partial) {
  __shared__ T tile[BAND + 2][TILE + 2];
  __shared__ T sh[TILE];
  const size_t W = I + 2;
  const int row0 = blockIdx.x * BAND;
  const int tx = threadIdx.x;
  T acc = T(0);
  for (int c0 = 1; c0 <= I; c0 += TILE) {
    // stage rows row0-1 .. row0+BAND and columns c0-1 .. c0+TILE
    for (int q = tx; q < (BAND + 2) * (TILE + 2); q += TILE) {
      const int a = q / (TILE + 2), b = q % (TILE + 2);
      const int gr = row0 - 1 + a, gc = c0 - 1 + b;
      tile[a][b] = (gr >= 0 && gr <= J + 1 && gc <= I + 1)
                       ? p[(size_t)gr * W + gc] : T(0);
    }
    __syncthreads();
    const int i = c0 + tx;
    for (int l = 0; l < BAND; ++l) {
      const int j = row0 + l;
      if (i <= I && j >= 1 && j <= J && ((i + j) & 1) == color) {
        const T c = tile[l + 1][tx + 1];
        const T r = resid(c, rhs[(size_t)j * W + i], tile[l + 1][tx],
                          tile[l + 1][tx + 2], tile[l][tx + 1],
                          tile[l + 2][tx + 1], idx2, idy2);
        p[(size_t)j * W + i] = c - factor * r;
        acc += r * r;
      }
    }
    __syncthreads();
  }
  sh[tx] = acc;
  __syncthreads();
  for (int s = TILE / 2; s > 0; s >>= 1) {
    if (tx < s) sh[tx] += sh[tx + s];
    __syncthreads();
  }
  if (tx == 0) partial[blockIdx.x] = sh[0];
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

dim3 cb_grid(int J, int I) {
  return dim3(((I + 1) / 2 + BX - 1) / BX, (J + BY - 1) / BY);
}

template <typename T>
int run_checkerboard(int dev, T* p, const T* rhs, int J, int I, int n_inner,
                     double factor, double idx2, double idy2, T* partial,
                     T* out, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = cb_grid(J, I);
  const dim3 blk(BX, BY);
  const int nb = grd.x * grd.y;
  const int nn = ((I > J ? I : J) + 255) / 256;
  for (int t = 0; t < n_inner; ++t) {
    const bool last = t == n_inner - 1;
    cb_color<T><<<grd, blk, 0, st>>>(p, rhs, J, I, 0, T(factor), T(idx2),
                                     T(idy2), last ? partial : nullptr);
    cb_color<T><<<grd, blk, 0, st>>>(p, rhs, J, I, 1, T(factor), T(idx2),
                                     T(idy2), last ? partial + nb : nullptr);
    cb_neumann<T><<<nn, 256, 0, st>>>(p, J, I);
  }
  sum_partials<T><<<1, FIN, 0, st>>>(partial, 2 * nb, out);
  return (int)cudaGetLastError();
}

int blk_bands(int J) { return (J + 2 + BAND - 1) / BAND; }

template <typename T>
int run_blocked(int dev, T* p, const T* rhs, int J, int I, double factor,
                double idx2, double idy2, T* partial, T* out,
                cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const int nb = blk_bands(J);
  const int nn = ((I > J ? I : J) + 255) / 256;
  blk_color<T><<<nb, TILE, 0, st>>>(p, rhs, J, I, 0, T(factor), T(idx2),
                                    T(idy2), partial);
  blk_color<T><<<nb, TILE, 0, st>>>(p, rhs, J, I, 1, T(factor), T(idx2),
                                    T(idy2), partial + nb);
  cb_neumann<T><<<nn, 256, 0, st>>>(p, J, I);
  sum_partials<T><<<1, FIN, 0, st>>>(partial, 2 * nb, out);
  return (int)cudaGetLastError();
}

// -- the residual's two fixed-order sums, for NTH threads ----------------

// the fixed halving tree over the CTA's NTH threads; sh holds NTH values
template <int NTH, typename T>
__device__ T cta_tree(T v, T* sh, int tid) {
  sh[tid] = v;
  __syncthreads();
  for (int s = NTH / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  return sh[0];
}

// This CTA's threads sum `acc` into partial[idx]; the last of the nb CTAs
// to take *ticket adds partial[0 .. nb) in order (thread t takes t, t +
// NTH, ..., then the tree) into *res and resets the ticket. No float
// atomics. sh holds NTH values and is free; every thread calls it.
template <int NTH, typename T>
__device__ void ticket_sum(T acc, T* sh, int tid, T* __restrict__ partial,
                           int idx, int nb, unsigned* __restrict__ ticket,
                           T* __restrict__ res) {
  __shared__ bool last_cta;
  const T s = cta_tree<NTH>(acc, sh, tid);
  if (tid == 0) {
    partial[idx] = s;
    __threadfence();
    last_cta = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (last_cta) {
    T v = T(0);
    for (int k = tid; k < nb; k += NTH) v += __ldcg(partial + k);
    const T total = cta_tree<NTH>(v, sh, tid);
    if (tid == 0) {
      *res = total;
      *ticket = 0u;
    }
  }
}

// -- K1: the stacked quarter plane, a pass in registers and shared memory

// the global interior of a parity along one quarter axis: even quarter
// rows hold grid rows 2*gq (1..max), odd ones 2*gq+1
__device__ __forceinline__ bool q_inside(int parity, int gq, int max2) {
  return parity == 0 ? (gq >= 1 && gq <= max2) : (gq >= 0 && gq <= max2 - 1);
}

// K1's pass of `iters` iterations over owned tiles (th, tw) of the plane
// (4, J2, I2); the box of a tile is QS*QK rows by QW columns from (j0 -
// iters, i0 - iters), not clipped (its cells off the plane hold 0 and never
// update). Thread (tx, ty) = (tid % QW, tid / QW) holds column tx, rows
// ty*QK .. ty*QK + QK - 1 of the box, all four slots of p and of rhs, in
// registers, and publishes its p cells to shared memory for its
// neighbours. Per iteration: red (R0, R1 from the published B0, B1 and
// its own cells), publish R, a barrier; black (B0, B1 from the published R
// and its own), the eight same-index wall selects on its own cells,
// publish B, a barrier.
template <typename T, int QW, int QS, int QK, int MINB>
__global__ void __launch_bounds__(QW * QS, MINB)
q_tiled(const T* __restrict__ q, const T* __restrict__ f,
        T* __restrict__ out, int J2, int I2, int iters, int th, int tw,
        T factor, T idx2, T idy2, T* __restrict__ partial,
        unsigned* __restrict__ ticket, T* __restrict__ res) {
  constexpr int NTH = QW * QS, R = QS * QK, SS = R * QW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sR0 = reinterpret_cast<T*>(smem);
  T* sR1 = sR0 + SS;
  T* sB0 = sR0 + 2 * SS;
  T* sB1 = sR0 + 3 * SS;
  const int tid = threadIdx.x, tx = tid % QW, ty = tid / QW;
  const int ht = iters;
  const int gc = blockIdx.x * tw - ht + tx;  // the thread's plane column
  const int a0 = ty * QK;                    // box row of its first cell
  const int gr0 = blockIdx.y * th - ht + a0;
  const int jmax2 = J2 - 1, imax2 = I2 - 1;
  const size_t S = (size_t)J2 * I2;
  T r0[QK], r1[QK], b0[QK], b1[QK], f0[QK], f1[QK], g0[QK], g1[QK];
  // the update, row and ownership predicates (bit k: the thread's cell k)
  unsigned ok0 = 0u, ok1 = 0u, rown = 0u;
#pragma unroll
  for (int k = 0; k < QK; ++k) {
    const int gr = gr0 + k, a = a0 + k;
    r0[k] = r1[k] = b0[k] = b1[k] = T(0);
    f0[k] = f1[k] = g0[k] = g1[k] = T(0);
    if (gr >= 0 && gr < J2 && gc >= 0 && gc < I2) {
      const size_t x = (size_t)gr * I2 + gc;
      r0[k] = q[x];
      r1[k] = q[S + x];
      b0[k] = q[2 * S + x];
      b1[k] = q[3 * S + x];
      f0[k] = f[x];
      f1[k] = f[S + x];
      g0[k] = f[2 * S + x];
      g1[k] = f[3 * S + x];
    }
    // even quarter rows read the row below, odd ones the row above
    if (q_inside(0, gr, jmax2) && a >= 1) ok0 |= 1u << k;
    if (q_inside(1, gr, jmax2) && a <= R - 2) ok1 |= 1u << k;
    if (a >= ht && a < ht + th && gr < J2) rown |= 1u << k;
  }
  // even quarter columns read the column left, odd ones the column right
  const bool c0 = q_inside(0, gc, imax2) && tx >= 1;       // R0, B1
  const bool c1 = q_inside(1, gc, imax2) && tx <= QW - 2;  // R1, B0
  const bool cown = tx >= ht && tx < ht + tw && gc < I2;
  const bool ci0 = q_inside(0, gc, imax2), ci1 = q_inside(1, gc, imax2);
  const bool walls = gc == 0 || gc == imax2 ||
                     (gr0 <= 0 && gr0 + QK > 0) ||
                     (gr0 <= jmax2 && gr0 + QK > jmax2);
  // a box inside rows and columns 1 .. max2 - 1 of the plane holds no wall
  // and no ghost cell: there every cell updates, those on the box's edge
  // from the clamped neighbour offsets below, and their wrong values reach
  // the tile no sooner than stale ones would (the same reads carry them),
  // so the halo absorbs them; such a CTA drops the per-cell predicates
  const int br0 = blockIdx.y * th - ht, bc0 = blockIdx.x * tw - ht;
  const bool inner = br0 >= 1 && br0 + R <= jmax2 && bc0 >= 1 &&
                     bc0 + QW <= imax2;
  // shared-memory offsets of the neighbours across the box's columns and
  // across the thread's rows (clamped where they leave the box: those
  // cells do not update)
  const int x0 = a0 * QW + tx;
  const int dw = tx > 0 ? -1 : 0, de = tx < QW - 1 ? 1 : 0;
  const int ds = a0 > 0 ? -QW : 0, dn = a0 + QK < R ? QW : 0;
#pragma unroll
  for (int k = 0; k < QK; ++k) {
    const int x = x0 + k * QW;
    sR0[x] = r0[k];
    sR1[x] = r1[k];
    sB0[x] = b0[k];
    sB1[x] = b1[k];
  }
  __syncthreads();
  T acc = T(0);
  // one iteration; LAST adds the owned r^2 in the thread's update order
  // (red: R0, R1 of its first row, of its second, ...; black: B0, B1);
  // EDGE: the CTA's box reaches a wall or past the plane
  const auto iteration = [&](auto last_tag, auto edge_tag) {
    constexpr bool LAST = decltype(last_tag)::value;
    constexpr bool EDGE = decltype(edge_tag)::value;
#pragma unroll
    for (int k = 0; k < QK; ++k) {
      const int x = x0 + k * QW;
      {  // R0: W=B0[c-1] E=B0[c] S=B1[r-1] N=B1[r]
        const T s = k == 0 ? sB1[x + ds] : b1[k - 1];
        const T c = r0[k];
        const T r = resid(c, f0[k], sB0[x + dw], b0[k], s, b1[k], idx2, idy2);
        const bool u = !EDGE || (c0 && ((ok0 >> k) & 1u));
        r0[k] = u ? c - factor * r : c;
        if (LAST && u && cown && ((rown >> k) & 1u)) acc += r * r;
      }
      {  // R1: W=B1[c] E=B1[c+1] S=B0[r] N=B0[r+1]
        const T n = k == QK - 1 ? sB0[x + dn] : b0[k + 1];
        const T c = r1[k];
        const T r = resid(c, f1[k], b1[k], sB1[x + de], b0[k], n, idx2, idy2);
        const bool u = !EDGE || (c1 && ((ok1 >> k) & 1u));
        r1[k] = u ? c - factor * r : c;
        if (LAST && u && cown && ((rown >> k) & 1u)) acc += r * r;
      }
    }
#pragma unroll
    for (int k = 0; k < QK; ++k) {
      const int x = x0 + k * QW;
      sR0[x] = r0[k];
      sR1[x] = r1[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < QK; ++k) {
      const int x = x0 + k * QW;
      {  // B0: W=R0[c] E=R0[c+1] S=R1[r-1] N=R1[r]
        const T s = k == 0 ? sR1[x + ds] : r1[k - 1];
        const T c = b0[k];
        const T r = resid(c, g0[k], r0[k], sR0[x + de], s, r1[k], idx2, idy2);
        const bool u = !EDGE || (c1 && ((ok0 >> k) & 1u));
        b0[k] = u ? c - factor * r : c;
        if (LAST && u && cown && ((rown >> k) & 1u)) acc += r * r;
      }
      {  // B1: W=R1[c-1] E=R1[c] S=R0[r] N=R0[r+1]
        const T n = k == QK - 1 ? sR0[x + dn] : r0[k + 1];
        const T c = b1[k];
        const T r = resid(c, g1[k], sR1[x + dw], r1[k], r0[k], n, idx2, idy2);
        const bool u = !EDGE || (c0 && ((ok1 >> k) & 1u));
        b1[k] = u ? c - factor * r : c;
        if (LAST && u && cown && ((rown >> k) & 1u)) acc += r * r;
      }
    }
    if (EDGE && walls) {
      // the Neumann wall refresh: the eight same-index selects on each of
      // the thread's cells, in the TPU kernel's order
#pragma unroll
      for (int k = 0; k < QK; ++k) {
        const int gqr = gr0 + k;
        const bool ri0 = q_inside(0, gqr, jmax2);
        const bool ri1 = q_inside(1, gqr, jmax2);
        // p[0,i] = p[1,i] (even i, odd i); p[J+1,i] = p[J,i] (odd, even)
        if (gqr == 0 && ci0) r0[k] = b1[k];
        if (gqr == 0 && ci1) b0[k] = r1[k];
        if (gqr == jmax2 && ci1) r1[k] = b0[k];
        if (gqr == jmax2 && ci0) b1[k] = r0[k];
        // p[j,0] = p[j,1] (even j, odd j); p[j,I+1] = p[j,I] (even, odd)
        if (gc == 0 && ri0) r0[k] = b0[k];
        if (gc == 0 && ri1) b1[k] = r1[k];
        if (gc == imax2 && ri0) b0[k] = r0[k];
        if (gc == imax2 && ri1) r1[k] = b1[k];
      }
    }
    if (!LAST) {
      // R's wall cells reach shared memory with the next red's publish
#pragma unroll
      for (int k = 0; k < QK; ++k) {
        const int x = x0 + k * QW;
        sB0[x] = b0[k];
        sB1[x] = b1[k];
      }
      __syncthreads();
    }
  };
  if (inner) {
    for (int t = 0; t < iters - 1; ++t)
      iteration(std::false_type{}, std::false_type{});
    iteration(std::true_type{}, std::false_type{});
  } else {
    for (int t = 0; t < iters - 1; ++t)
      iteration(std::false_type{}, std::true_type{});
    iteration(std::true_type{}, std::true_type{});
  }
  // the tile's cells go out once
  if (cown) {
#pragma unroll
    for (int k = 0; k < QK; ++k) {
      if ((rown >> k) & 1u) {
        const size_t x = (size_t)(gr0 + k) * I2 + gc;
        out[x] = r0[k];
        out[S + x] = r1[k];
        out[2 * S + x] = b0[k];
        out[3 * S + x] = b1[k];
      }
    }
  }
  __syncthreads();
  ticket_sum<NTH>(acc, sR0, tid, partial, blockIdx.y * gridDim.x + blockIdx.x,
                  gridDim.x * gridDim.y, ticket, res);
}

// geo = [J2, I2, iters, th, tw, QS, QK, smem bytes]
template <typename T, int QW, int QS, int QK, int MINB>
int launch_q_tiled(const T* q, const T* f, T* out, const int* geo,
                   double factor, double idx2, double idy2, T* partial,
                   unsigned* ticket, T* res, cudaStream_t st) {
  const int smem = geo[7];
  cudaError_t e = cudaFuncSetAttribute(
      q_tiled<T, QW, QS, QK, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd((geo[1] + geo[4] - 1) / geo[4],
                 (geo[0] + geo[3] - 1) / geo[3]);
  q_tiled<T, QW, QS, QK, MINB><<<grd, QW * QS, smem, st>>>(
      q, f, out, geo[0], geo[1], geo[2], geo[3], geo[4], T(factor), T(idx2),
      T(idy2), partial, ticket, res);
  return (int)cudaGetLastError();
}

// the CTA shapes (64 columns; QS row segments of QK rows; MINB CTAs an SM
// that the registers must allow), by (QS, QK): 256 threads of 8 rows at
// float32 (107 registers), of 4 rows at float64 (115), two CTAs an SM.
// Measured at 4096^2, n = 4 (PERF.md): 512 threads of 8 rows, one
// CTA an SM (loads not beside another CTA's sweeps), 0.154 ms against
// 0.132; 512 of 4 rows 0.139; 1024 of 4 rows 0.148; at float64 8 rows or
// 8 segments spill
template <typename T>
int run_q_tiled(int dev, const T* q, const T* f, T* out, const int* geo,
                double factor, double idx2, double idy2, T* partial,
                unsigned* ticket, T* res, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const int qs = geo[5], qk = geo[6];
#define Q_SHAPE(S, K, M)                                                    \
  if (qs == S && qk == K)                                                   \
    return launch_q_tiled<T, 64, S, K, M>(q, f, out, geo, factor, idx2,     \
                                          idy2, partial, ticket, res, st);
  Q_SHAPE(4, 8, 2)
  Q_SHAPE(4, 4, 2)
#undef Q_SHAPE
  return (int)cudaErrorInvalidValue;
}

// -- K2's dynamic-extent mode: the fleet's shape-class lanes -------------

// One CTA of tiles2d's shape (TX x TY threads) per owned tile (th, tw) of
// a lane's class block, the lane on blockIdx.z. A tile past the lane's
// live corner (J+2, I+2), or of a lane that is not solving, is copied from
// p to out and does no sweep. A live tile loads its box (the tile and ht =
// 2n+1 cells a side, clipped to the live corner) of p and rhs into shared
// memory, runs the n iterations there as rb_tiled does (each half-sweep
// maps the threads onto one colour's cells; the wall ring refreshed at the
// lane's extents, clipped tangentially to its interior), and writes the
// tile out: its live cells from the box, its dead ones from p. In the last
// iteration each update leaves its r^2 in its rhs slot; thread (tx, ty)
// adds the tile's interior r^2 in (ty + TY k, tx + TX m) order, k-major,
// and the lane's last CTA (a ticket per lane) adds the lane's partials in
// the order of its own tile grid.
template <typename T>
__global__ void __launch_bounds__(tiles2d::NT, 2)
cls_tiled(const T* __restrict__ p, const T* __restrict__ rhs,
          T* __restrict__ out, const int* __restrict__ ext,
          const T* __restrict__ geo, const uint8_t* __restrict__ solving,
          int jc, int ic, int n, int th, int tw, int P,
          T* __restrict__ partial, int stride, unsigned* __restrict__ ticket,
          T* __restrict__ res) {
  using tiles2d::NT;
  using tiles2d::TX;
  using tiles2d::TY;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int lane = blockIdx.z;
  const int J = ext[2 * lane], I = ext[2 * lane + 1];
  const size_t Wc = ic + 2;
  const size_t base = (size_t)lane * (jc + 2) * Wc;
  const T* pl = p + base;
  T* ol = out + base;
  const int j0 = blockIdx.y * th, j1 = min(jc + 2, j0 + th);
  const int i0 = blockIdx.x * tw, i1 = min(ic + 2, i0 + tw);
  const int gy = (J + 2 + th - 1) / th, gx = (I + 2 + tw - 1) / tw;
  // uniform per CTA: a copying CTA never reaches a barrier
  if (!solving[lane] || (int)blockIdx.y >= gy || (int)blockIdx.x >= gx) {
    for (int a = j0 + ty; a < j1; a += TY)
      for (int b = i0 + tx; b < i1; b += TX) ol[a * Wc + b] = pl[a * Wc + b];
    if (!solving[lane] && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
      res[lane] = T(0);
    return;
  }
  const T factor = geo[3 * lane], idx2 = geo[3 * lane + 1],
          idy2 = geo[3 * lane + 2];
  const int ht = 2 * n + 1;
  // the box: the tile and ht cells a side, clipped to the live corner
  const int bj0 = max(0, j0 - ht), bi0 = max(0, i0 - ht);
  const int R = min(J + 2, j1 + ht) - bj0;
  const int W = min(I + 2, i1 + ht) - bi0;
  T* sp = reinterpret_cast<T*>(smem);
  T* sr = sp + (size_t)R * P;
  for (int a = ty; a < R; a += TY) {
    const size_t row = (size_t)(bj0 + a) * Wc + bi0;
    for (int b = tx; b < W; b += TX) {
      sp[a * P + b] = pl[row + b];
      sr[a * P + b] = rhs[base + row + b];
    }
  }
  __syncthreads();
  // the cells that update: off the box's ring (frozen where the box's edge
  // lies inside the corner, the wall ring where it is the corner's), in
  // the lane's interior
  const int alo = 1, ahi = min(R - 2, J - bj0);
  const int blo = 1, bhi = min(W - 2, I - bi0);
  // the wall rows j = 0, J+1 and columns i = 0, I+1 in the box
  const int arow_lo = -bj0, arow_hi = J + 1 - bj0;
  const int bcol_lo = -bi0, bcol_hi = I + 1 - bi0;
  const int nrow = max(0, bhi - blo + 1), ncol = max(0, ahi - alo + 1);
  for (int t = 0; t < n; ++t) {
    const bool last = t == n - 1;
    for (int colour = 0; colour < 2; ++colour) {
      // a pair of rows holds one cell of the colour in each column
      for (int m = (alo >> 1) + ty; 2 * m <= ahi; m += TY) {
        for (int b = blo + tx; b <= bhi; b += TX) {
          const int a = 2 * m + ((bj0 + bi0 + b + colour) & 1);
          if (a < alo || a > ahi) continue;
          const int x = a * P + b;
          const T c = sp[x];
          const T r = resid(c, sr[x], sp[x - 1], sp[x + 1], sp[x - P],
                            sp[x + P], idx2, idy2);
          sp[x] = c - factor * r;
          if (last) sr[x] = r * r;  // this rhs is not read again
        }
      }
      __syncthreads();
    }
    // each wall select copies the inward interior neighbour; rows clip to
    // the interior columns, columns to the interior rows (corners
    // untouched)
    for (int u = tid; u < 2 * (nrow + ncol); u += NT) {
      int a, b, src;
      if (u < 2 * nrow) {
        const int hi = u >= nrow;
        a = hi ? arow_hi : arow_lo;
        b = blo + u - hi * nrow;
        if (a < 0 || a > R - 1) continue;
        src = (hi ? a - 1 : a + 1) * P + b;
      } else {
        const int v = u - 2 * nrow, hi = v >= ncol;
        b = hi ? bcol_hi : bcol_lo;
        a = alo + v - hi * ncol;
        if (b < 0 || b > W - 1) continue;
        src = a * P + (hi ? b - 1 : b + 1);
      }
      sp[a * P + b] = sp[src];
    }
    __syncthreads();
  }
  // the tile goes out (live cells from the box, dead ones from p), and
  // thread (tx, ty) adds the interior r^2 of its cells in the same order
  T acc = T(0);
  for (int a = j0 + ty; a < j1; a += TY) {
    const bool arow = a >= 1 && a <= J;
    for (int b = i0 + tx; b < i1; b += TX) {
      if (a < J + 2 && b < I + 2) {
        const int x = (a - bj0) * P + (b - bi0);
        ol[a * Wc + b] = sp[x];
        if (arow && b >= 1 && b <= I) acc += sr[x];
      } else {
        ol[a * Wc + b] = pl[a * Wc + b];
      }
    }
  }
  __syncthreads();
  ticket_sum<NT>(acc, sp, tid, partial + (size_t)lane * stride,
                 blockIdx.y * gx + blockIdx.x, gx * gy, ticket + lane,
                 res + lane);
}

// gi = [jc, ic, n, th, tw, P, smem bytes, stride]
template <typename T>
int run_class(int dev, const T* p, const T* rhs, T* out, const int* ext,
              const T* geo, const uint8_t* solving, int lanes,
              const int* gi, T* partial, unsigned* ticket, T* res,
              cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const int jc = gi[0], ic = gi[1], th = gi[3], tw = gi[4], smem = gi[6];
  e = cudaFuncSetAttribute(cls_tiled<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd((ic + 2 + tw - 1) / tw, (jc + 2 + th - 1) / th, lanes);
  cls_tiled<T><<<grd, dim3(tiles2d::TX, tiles2d::TY), smem, st>>>(
      p, rhs, out, ext, geo, solving, jc, ic, gi[2], th, tw, gi[5], partial,
      gi[7], ticket, res);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-sum buffer each entry point needs
int rb_sor_checkerboard_partials(int J, int I) {
  const dim3 g = cb_grid(J, I);
  return 2 * (int)(g.x * g.y);
}

#define SOR_ENTRY(NAME, RUN, T)                                              \
  int NAME(int dev, void* p, const void* rhs, int a, int b, int n_inner,     \
           double factor, double idx2, double idy2, void* partial,          \
           void* out, void* stream) {                                        \
    return RUN<T>(dev, (T*)p, (const T*)rhs, a, b, n_inner, factor, idx2,    \
                  idy2, (T*)partial, (T*)out, (cudaStream_t)stream);         \
  }

SOR_ENTRY(rb_sor_checkerboard_f32, run_checkerboard, float)
SOR_ENTRY(rb_sor_checkerboard_f64, run_checkerboard, double)

int rb_sor_blocked_partials(int J) { return 2 * blk_bands(J); }

#define BLOCKED_ENTRY(NAME, T)                                               \
  int NAME(int dev, void* p, const void* rhs, int J, int I, double factor,   \
           double idx2, double idy2, void* partial, void* out,               \
           void* stream) {                                                   \
    return run_blocked<T>(dev, (T*)p, (const T*)rhs, J, I, factor, idx2,     \
                          idy2, (T*)partial, (T*)out, (cudaStream_t)stream); \
  }

// K1: q, out (4, J2, I2) planes, out != q; geo as launch_q_tiled; partial
// one value per tile, ticket an unsigned 0 that the kernel leaves at 0
#define QUARTERS_ENTRY(NAME, T)                                               \
  int NAME(int dev, const void* q, const void* f, void* out, const int* geo, \
           double factor, double idx2, double idy2, void* partial,           \
           void* ticket, void* res, void* stream) {                          \
    return run_q_tiled<T>(dev, (const T*)q, (const T*)f, (T*)out, geo,       \
                          factor, idx2, idy2, (T*)partial,                   \
                          (unsigned*)ticket, (T*)res, (cudaStream_t)stream); \
  }

QUARTERS_ENTRY(rb_sor_quarters_f32, float)
QUARTERS_ENTRY(rb_sor_quarters_f64, double)

// K2's dynamic-extent mode: p, out (N, jc+2, ic+2), out != p; ext (N, 2)
// int32, geo (N, 3), solving (N,) bytes; gi as run_class; partial `stride`
// values per lane, ticket N unsigned 0s that the kernel leaves at 0, res
// (N,)
#define CLASS_ENTRY(NAME, T)                                                  \
  int NAME(int dev, const void* p, const void* rhs, void* out,               \
           const void* ext, const void* geo, const void* solving, int lanes, \
           const int* gi, void* partial, void* ticket, void* res,            \
           void* stream) {                                                   \
    return run_class<T>(dev, (const T*)p, (const T*)rhs, (T*)out,            \
                        (const int*)ext, (const T*)geo,                      \
                        (const uint8_t*)solving, lanes, gi, (T*)partial,     \
                        (unsigned*)ticket, (T*)res, (cudaStream_t)stream);   \
  }

CLASS_ENTRY(rb_sor_class_f32, float)
CLASS_ENTRY(rb_sor_class_f64, double)

TILED2D_ENTRY(rb_sor_masked_f32, float, true)
TILED2D_ENTRY(rb_sor_masked_f64, double, true)
BLOCKED_ENTRY(rb_sor_blocked_f32, float)
BLOCKED_ENTRY(rb_sor_blocked_f64, double)

}  // extern "C"
