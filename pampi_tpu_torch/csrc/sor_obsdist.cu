// Per-shard flag-masked red-black SOR of a 2-D mesh, for Hopper (sm_90a):
// kernel K15.
//
// rb_sor_obsdist replaces pampi_tpu/ops/sor_obsdist.py _obsdist_kernel
//   (make_rb_iters_obsdist): n red-black iterations, each with the globally
//   gated homogeneous-Neumann wall refresh, on one shard's (jl+2H, il+2H)
//   deep block p, in place, with per-direction fluid coefficients formed
//   from the shard's uint8 deep flag block.
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
// What bounds it on the H100: memory bandwidth (~20 flops per cell
// update). The least any implementation moves per call is p, rhs and the
// flags read once and p written once: 13 bytes a cell at float32, 74 MB
// for a 1366x4096 shard at n = 4 (a 1384x4114 deep block), ~22 us at
// 3.35 TB/s.
//
// Design (simple and right first): K13's, on the natural grid. CUDA
// blocks run in no order, so every ordering point is a launch: per
// iteration one launch per colour (a cell of one colour reads only cells
// of the other) and one launch for the wall refresh. Every wall select
// reads an interior cell (the row selects read gj = 1 or jmax, the column
// selects gi = 1 or imax, and tangential clipping keeps all four off the
// other walls), so the four selects touch disjoint cells and read none
// that another writes: one thread per wall cell, no order needed. The
// wall launch covers only the two stored rows gj = 0 and jmax+1 and the
// two columns gi = 0 and imax+1. On the last iteration each colour block
// writes its partial sum of r^2 (a fixed-order shared-memory tree), and a
// one-block launch sums the partials in a fixed order: no float atomics,
// so the residual and every iteration count are reproducible. 3n + 1
// launches a call (13 at n = 4). Temporal blocking in shared memory
// (several iterations per pass) and wgmma/TMA tiling are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int FIN = 1024;
constexpr int WALL_THREADS = 256;

struct Geom {
  int ej, ei;        // stored deep block: jl + 2H, il + 2H
  int jl, il;        // owned extents
  int n, H;          // iterations per call, deep-halo depth
  int jmax, imax;    // global interior extents
  int joff, ioff;    // the shard's global offsets
};

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

// one colour's half-sweep: cells with (gi + gj) % 2 == colour
template <typename T>
__global__ void od_sweep(T* __restrict__ p, const T* __restrict__ rhs,
                         const uint8_t* __restrict__ fl, Geom g, int colour,
                         T omega, T idx2, T idy2, T* __restrict__ partial) {
  __shared__ T sh[NT];
  const int a = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (a >= 1 && a <= g.ej - 2 && b >= 1 && b <= g.ei - 2) {
    const int gj = a - g.H + g.joff + 1;
    const int gi = b - g.H + g.ioff + 1;
    const size_t W = g.ei;
    const size_t k = (size_t)a * W + b;
    if (gj >= 1 && gj <= g.jmax && gi >= 1 && gi <= g.imax &&
        ((gi + gj) & 1) == colour && fl[k] != 0) {
      const T eps_e = T(fl[k + 1]), eps_w = T(fl[k - 1]);
      const T eps_n = T(fl[k + W]), eps_s = T(fl[k - W]);
      const T denom = (eps_e + eps_w) * idx2 + (eps_n + eps_s) * idy2;
      const T fac = (denom > T(0) ? omega / denom : T(0)) * T(fl[k]);
      const T c = p[k];
      const T lap = (eps_e * (p[k + 1] - c) + eps_w * (p[k - 1] - c)) * idx2 +
                    (eps_n * (p[k + W] - c) + eps_s * (p[k - W] - c)) * idy2;
      const T r = rhs[k] - lap;
      p[k] = c - fac * r;
      if (a >= g.H && a < g.H + g.jl && b >= g.H && b < g.H + g.il)
        rr = r * r;
    }
  }
  if (partial != nullptr) {
    const T s = block_sum(rr, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// the Neumann wall refresh: thread t takes one cell of the stored rows of
// gj = 0 and jmax+1 (t < 2*ei) or of the stored columns of gi = 0 and
// imax+1 (the rest); each select copies the inward interior neighbour
template <typename T>
__global__ void od_walls(T* __restrict__ p, Geom g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int alo = g.H - 1 - g.joff;  // stored row of gj == 0
  const int ahi = alo + g.jmax + 1;  // of gj == jmax + 1
  const int blo = g.H - 1 - g.ioff;
  const int bhi = blo + g.imax + 1;
  int a, b, da = 0, db = 0;
  if (t < 2 * g.ei) {
    a = t < g.ei ? alo : ahi;
    b = t % g.ei;
    da = t < g.ei ? 1 : -1;
  } else if (t < 2 * (g.ei + g.ej)) {
    const int u = t - 2 * g.ei;
    b = u < g.ej ? blo : bhi;
    a = u % g.ej;
    db = u < g.ej ? 1 : -1;
  } else {
    return;
  }
  if (a < 1 || a > g.ej - 2 || b < 1 || b > g.ei - 2) return;
  const int gj = a - g.H + g.joff + 1;
  const int gi = b - g.H + g.ioff + 1;
  // rows clip to the interior columns, columns to the interior rows
  if (da != 0 && !(gi >= 1 && gi <= g.imax)) return;
  if (db != 0 && !(gj >= 1 && gj <= g.jmax)) return;
  const size_t W = g.ei;
  p[(size_t)a * W + b] = p[(size_t)(a + da) * W + (b + db)];
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

dim3 od_grid(int ej, int ei) {
  return dim3((ei + BX - 1) / BX, (ej + BY - 1) / BY);
}

template <typename T>
int run_obsdist(int dev, T* p, const T* rhs, const uint8_t* fl, Geom g,
                double omega, double idx2, double idy2, T* partial, T* out,
                cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = od_grid(g.ej, g.ei);
  const dim3 blk(BX, BY);
  const int nb = grd.x * grd.y;
  const int nw = (2 * (g.ej + g.ei) + WALL_THREADS - 1) / WALL_THREADS;
  for (int t = 0; t < g.n; ++t) {
    const bool last = t == g.n - 1;
    od_sweep<T><<<grd, blk, 0, st>>>(p, rhs, fl, g, 0, T(omega), T(idx2),
                                     T(idy2), last ? partial : nullptr);
    od_sweep<T><<<grd, blk, 0, st>>>(p, rhs, fl, g, 1, T(omega), T(idx2),
                                     T(idy2), last ? partial + nb : nullptr);
    od_walls<T><<<nw, WALL_THREADS, 0, st>>>(p, g);
  }
  sum_partials<T><<<1, FIN, 0, st>>>(partial, 2 * nb, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-sum buffer rb_sor_obsdist_* needs
int rb_sor_obsdist_partials(int ej, int ei) {
  const dim3 g = od_grid(ej, ei);
  return 2 * (int)(g.x * g.y);
}

#define OBSDIST_ENTRY(NAME, T)                                                \
  int NAME(int dev, void* p, const void* rhs, const void* fl, int ej, int ei, \
           int jl, int il, int n, int H, int jmax, int imax, int joff,        \
           int ioff, double omega, double idx2, double idy2, void* partial,   \
           void* out, void* stream) {                                         \
    const Geom g{ej, ei, jl, il, n, H, jmax, imax, joff, ioff};               \
    return run_obsdist<T>(dev, (T*)p, (const T*)rhs, (const uint8_t*)fl, g,   \
                          omega, idx2, idy2, (T*)partial, (T*)out,            \
                          (cudaStream_t)stream);                              \
  }

OBSDIST_ENTRY(rb_sor_obsdist_f32, float)
OBSDIST_ENTRY(rb_sor_obsdist_f64, double)

}  // extern "C"
