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
// What bounds them on the H100: memory bandwidth. One half-sweep reads one
// colour's neighbours and rhs and writes that colour, so an iteration moves
// about 2.5 field-sizes of bytes (no FLOP pressure: ~10 flops per cell).
// The least any implementation must move per call is p and rhs read once
// and p written once; at 4096^2 f32 (67 MB a field) that is ~60 us at
// 3.35 TB/s, whatever n_inner is.
//
// Design (simple and right first): a TPU grid runs its steps in order and
// carries the residual across them in SMEM; CUDA blocks run in no order, so
// every ordering point becomes a launch boundary. Per iteration: one launch
// per colour (in place; within a colour every cell reads only the other
// colour, so there is no hazard), then one Neumann launch. On the last
// iteration each block writes its partial sum of r^2 (a fixed-order
// shared-memory tree), and a one-block launch sums the partials in a fixed
// order. No float atomics: the residual, and so every iteration count, is
// reproducible run to run. In the quarter layout every neighbour is a
// uniform shift of a dense plane (pampi_tpu/ops/sor_quarters.py), so each
// colour's update is unit-stride and coalesced; the Neumann refresh is
// eight same-index edge copies between planes, all independent, in one
// launch. K1 and plain K2 keep this design; the masked mode runs all
// n_inner iterations in one pass through shared memory (below), and
// temporal blocking for K1 and plain K2 is later work.
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

#include <cuda_runtime.h>

#include <cstdint>

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

// red half-sweep in quarter space: R0 and R1 read only B0 and B1
template <typename T>
__global__ void q_red(T* __restrict__ q, const T* __restrict__ f, int J2,
                      int I2, T factor, T idx2, T idy2,
                      T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t S = (size_t)J2 * I2;
  T* R0 = q;
  T* R1 = q + S;
  const T* B0 = q + 2 * S;
  const T* B1 = q + 3 * S;
  const int r = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (r < J2 && c < I2) {
    const size_t k = (size_t)r * I2 + c;
    if (r >= 1 && c >= 1) {  // R0: W=B0[c-1] E=B0[c] S=B1[r-1] N=B1[r]
      const T x = R0[k];
      const T res = resid(x, f[k], B0[k - 1], B0[k], B1[k - I2], B1[k],
                          idx2, idy2);
      R0[k] = x - factor * res;
      rr += res * res;
    }
    if (r <= J2 - 2 && c <= I2 - 2) {  // R1: W=B1[c] E=B1[c+1] S=B0[r] N=B0[r+1]
      const T x = R1[k];
      const T res = resid(x, f[S + k], B1[k], B1[k + 1], B0[k], B0[k + I2],
                          idx2, idy2);
      R1[k] = x - factor * res;
      rr += res * res;
    }
  }
  if (partial != nullptr) {
    const T s = block_sum(rr, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// black half-sweep in quarter space: B0 and B1 read the updated R0 and R1
template <typename T>
__global__ void q_black(T* __restrict__ q, const T* __restrict__ f, int J2,
                        int I2, T factor, T idx2, T idy2,
                        T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t S = (size_t)J2 * I2;
  const T* R0 = q;
  const T* R1 = q + S;
  T* B0 = q + 2 * S;
  T* B1 = q + 3 * S;
  const int r = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (r < J2 && c < I2) {
    const size_t k = (size_t)r * I2 + c;
    if (r >= 1 && c <= I2 - 2) {  // B0: W=R0[c] E=R0[c+1] S=R1[r-1] N=R1[r]
      const T x = B0[k];
      const T res = resid(x, f[2 * S + k], R0[k], R0[k + 1], R1[k - I2],
                          R1[k], idx2, idy2);
      B0[k] = x - factor * res;
      rr += res * res;
    }
    if (r <= J2 - 2 && c >= 1) {  // B1: W=R1[c-1] E=R1[c] S=R0[r] N=R0[r+1]
      const T x = B1[k];
      const T res = resid(x, f[3 * S + k], R1[k - 1], R1[k], R0[k],
                          R0[k + I2], idx2, idy2);
      B1[k] = x - factor * res;
      rr += res * res;
    }
  }
  if (partial != nullptr) {
    const T s = block_sum(rr, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// Neumann refresh in quarter space: eight same-index edge copies
// (pampi_tpu/ops/sor_quarters.py neumann_bc_quarters); no copy reads a
// cell another one writes
template <typename T>
__global__ void q_neumann(T* __restrict__ q, int J2, int I2) {
  const size_t S = (size_t)J2 * I2;
  T* R0 = q;
  T* R1 = q + S;
  T* B0 = q + 2 * S;
  T* B1 = q + 3 * S;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t top = (size_t)(J2 - 1) * I2;
  if (k < I2) {
    if (k >= 1) {
      R0[k] = B1[k];              // p[0,i] = p[1,i], even i
      B1[top + k] = R0[top + k];  // p[J+1,i] = p[J,i], even i
    }
    if (k <= I2 - 2) {
      B0[k] = R1[k];              // p[0,i] = p[1,i], odd i
      R1[top + k] = B0[top + k];  // p[J+1,i] = p[J,i], odd i
    }
  }
  if (k < J2) {
    const size_t row = (size_t)k * I2;
    if (k >= 1) {
      R0[row] = B0[row];                    // p[j,0] = p[j,1], even j
      B0[row + I2 - 1] = R0[row + I2 - 1];  // p[j,I+1] = p[j,I], even j
    }
    if (k <= J2 - 2) {
      B1[row] = R1[row];                    // p[j,0] = p[j,1], odd j
      R1[row + I2 - 1] = B1[row + I2 - 1];  // p[j,I+1] = p[j,I], odd j
    }
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

dim3 q_grid(int J2, int I2) {
  return dim3((I2 + BX - 1) / BX, (J2 + BY - 1) / BY);
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

template <typename T>
int run_quarters(int dev, T* q, const T* f, int J2, int I2, int n_inner,
                 double factor, double idx2, double idy2, T* partial, T* out,
                 cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = q_grid(J2, I2);
  const dim3 blk(BX, BY);
  const int nb = grd.x * grd.y;
  const int nn = ((I2 > J2 ? I2 : J2) + 255) / 256;
  for (int t = 0; t < n_inner; ++t) {
    const bool last = t == n_inner - 1;
    q_red<T><<<grd, blk, 0, st>>>(q, f, J2, I2, T(factor), T(idx2), T(idy2),
                                  last ? partial : nullptr);
    q_black<T><<<grd, blk, 0, st>>>(q, f, J2, I2, T(factor), T(idx2),
                                    T(idy2), last ? partial + nb : nullptr);
    q_neumann<T><<<nn, 256, 0, st>>>(q, J2, I2);
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

int rb_sor_quarters_partials(int J2, int I2) {
  const dim3 g = q_grid(J2, I2);
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
SOR_ENTRY(rb_sor_quarters_f32, run_quarters, float)
SOR_ENTRY(rb_sor_quarters_f64, run_quarters, double)

int rb_sor_blocked_partials(int J) { return 2 * blk_bands(J); }

#define BLOCKED_ENTRY(NAME, T)                                               \
  int NAME(int dev, void* p, const void* rhs, int J, int I, double factor,   \
           double idx2, double idy2, void* partial, void* out,               \
           void* stream) {                                                   \
    return run_blocked<T>(dev, (T*)p, (const T*)rhs, J, I, factor, idx2,     \
                          idy2, (T*)partial, (T*)out, (cudaStream_t)stream); \
  }

TILED2D_ENTRY(rb_sor_masked_f32, float, true)
TILED2D_ENTRY(rb_sor_masked_f64, double, true)
BLOCKED_ENTRY(rb_sor_blocked_f32, float)
BLOCKED_ENTRY(rb_sor_blocked_f64, double)

}  // extern "C"
