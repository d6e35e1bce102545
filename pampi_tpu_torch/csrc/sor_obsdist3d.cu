// Per-shard flag-masked red-black SOR of a 3-D mesh, for Hopper (sm_90a):
// kernel K16.
//
// rb_sor_obsdist3d replaces pampi_tpu/ops/sor_obsdist3d.py
//   _obsdist3d_kernel (make_rb_iters_obsdist_3d): n red-black iterations,
//   each with the globally gated 6-face homogeneous-Neumann refresh, on one
//   shard's (kl+2H, jl+2H, il+2H) deep block p (H = 2n), in place, with
//   per-direction fluid coefficients formed from the shard's uint8 deep
//   flag block. It is K15 (sor_obsdist.cu) one dimension up, with K14's
//   three offsets.
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
// What bounds it on the H100: memory bandwidth (~30 flops per cell
// update). The least any implementation moves per call is p, rhs and the
// flags read once and p written once: 13 bytes a cell at float32, 142 MB
// for a (128, 128, 512) shard at n = 4 (a 144x144x528 deep block), ~42 us
// at 3.35 TB/s.
//
// Design (simple and right first): K15's, on the natural grid. CUDA blocks
// run in no order, so every ordering point is a launch: per iteration one
// launch per colour (a cell of one colour reads only cells of the other)
// and one launch for the six walls. Every wall select reads an interior
// cell (tangential clipping keeps each face off the other walls), so the
// six faces touch disjoint cells and read none that another writes: one
// thread per wall cell, no order needed. The residual takes the masked
// K5's fixed order: on the last iteration each owned cell writes its r^2
// (0 on an obstacle) into an owned-sized buffer, one thread per (k, j) row
// sums it from the low i up, and one block sums the rows as sum_partials
// does. No float atomics, so the residual and every iteration count are
// reproducible, and on a one-shard mesh it equals masked K5's bitwise.
// 3n + 3 launches a call (15 at n = 4). Temporal blocking in shared
// memory (several iterations per pass, as the TPU kernel does) is later
// work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int FIN = 1024;

struct Geom {
  int ek, ej, ei;          // stored deep block: l + 2H per axis
  int kl, jl, il;          // owned extents
  int n, H;                // iterations per call, deep-halo depth
  int kmax, jmax, imax;    // global interior extents
  int koff, joff, ioff;    // the shard's global offsets
};

__device__ __forceinline__ bool interior(int g, int gmax) {
  return g >= 1 && g <= gmax;
}

// one colour's half-sweep: cells with (gi + gj + gk) % 2 == colour; on the
// last iteration (r2 != nullptr) every owned cell of the colour writes its
// r^2 at its owned index
template <typename T>
__global__ void od3_sweep(T* __restrict__ p, const T* __restrict__ rhs,
                          const uint8_t* __restrict__ fl, Geom g, int colour,
                          T omega, T idx2, T idy2, T idz2,
                          T* __restrict__ r2) {
  const int c = blockIdx.x * BX + threadIdx.x;
  const int b = blockIdx.y * BY + threadIdx.y;
  const int a = blockIdx.z;
  if (a < 1 || a > g.ek - 2 || b < 1 || b > g.ej - 2 || c < 1 ||
      c > g.ei - 2)
    return;
  const int gk = a - g.H + g.koff + 1;
  const int gj = b - g.H + g.joff + 1;
  const int gi = c - g.H + g.ioff + 1;
  if (!interior(gk, g.kmax) || !interior(gj, g.jmax) ||
      !interior(gi, g.imax) || ((gi + gj + gk) & 1) != colour)
    return;
  const size_t W = g.ei;
  const size_t P = (size_t)g.ej * W;
  const size_t x = (size_t)a * P + (size_t)b * W + c;
  T rr = T(0);
  if (fl[x] != 0) {
    const T ee = T(fl[x + 1]), ew = T(fl[x - 1]);
    const T en = T(fl[x + W]), es = T(fl[x - W]);
    const T eb = T(fl[x + P]), ef = T(fl[x - P]);
    const T denom = (ee + ew) * idx2 + (en + es) * idy2 + (eb + ef) * idz2;
    const T fac = (denom > T(0) ? omega / denom : T(0)) * T(fl[x]);
    const T cv = p[x];
    const T lap = (ee * (p[x + 1] - cv) + ew * (p[x - 1] - cv)) * idx2 +
                  (en * (p[x + W] - cv) + es * (p[x - W] - cv)) * idy2 +
                  (eb * (p[x + P] - cv) + ef * (p[x - P] - cv)) * idz2;
    const T r = rhs[x] - lap;
    p[x] = cv - fac * r;
    rr = r * r;
  }
  if (r2 != nullptr && a >= g.H && a < g.H + g.kl && b >= g.H &&
      b < g.H + g.jl && c >= g.H && c < g.H + g.il)
    r2[((size_t)(a - g.H) * g.jl + (b - g.H)) * g.il + (c - g.H)] = rr;
}

// the Neumann wall refresh: blockIdx.z = 2*axis + side picks the face
// (front/back: k, bottom/top: j, left/right: i), the thread's (y, x) its
// stored position on the face's two tangential axes; each select copies
// the inward interior neighbour, tangentially clipped to the global
// interior and off the frozen shell
template <typename T>
__global__ void od3_walls(T* __restrict__ p, Geom g) {
  const int face = blockIdx.z;
  const int axis = face >> 1, hi = face & 1;
  const int ext[3] = {g.ek, g.ej, g.ei};
  const int off[3] = {g.koff, g.joff, g.ioff};
  const int gmax[3] = {g.kmax, g.jmax, g.imax};
  const int t1 = axis == 0 ? 1 : 0;  // the tangential axes, in order
  const int t2 = axis == 2 ? 1 : 2;
  int idx[3];
  idx[t1] = blockIdx.y * BY + threadIdx.y;
  idx[t2] = blockIdx.x * BX + threadIdx.x;
  if (idx[t1] >= ext[t1] || idx[t2] >= ext[t2]) return;
  // the stored index of the global ghost plane 0 or gmax + 1
  idx[axis] = g.H - 1 - off[axis] + (hi ? gmax[axis] + 1 : 0);
  for (int d = 0; d < 3; ++d)
    if (idx[d] < 1 || idx[d] > ext[d] - 2) return;
  for (int d = 0; d < 3; ++d) {
    if (d == axis) continue;
    if (!interior(idx[d] - g.H + off[d] + 1, gmax[d])) return;
  }
  const size_t W = g.ei;
  const size_t P = (size_t)g.ej * W;
  const size_t stride[3] = {P, W, 1};
  const size_t x = (size_t)idx[0] * P + (size_t)idx[1] * W + idx[2];
  p[x] = hi ? p[x - stride[axis]] : p[x + stride[axis]];
}

// out[row] = the sum of the row's n values from the first up
template <typename T>
__global__ void row_sums(const T* __restrict__ v, int rows, int n,
                         T* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* a = v + (size_t)r * n;
  T s = T(0);
  for (int i = 0; i < n; ++i) s += a[i];
  out[r] = s;
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

int max2(int a, int b) { return a > b ? a : b; }

template <typename T>
int run_obsdist3d(int dev, T* p, const T* rhs, const uint8_t* fl, Geom g,
                  double omega, double idx2, double idy2, double idz2, T* r2,
                  T* rows, T* out, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd(ceil_div(g.ei, BX), ceil_div(g.ej, BY), g.ek);
  const dim3 blk(BX, BY);
  // the walls' (y, x) span the larger tangential extents of any face
  const dim3 wgrd(ceil_div(max2(g.ei, g.ej), BX),
                  ceil_div(max2(g.ej, g.ek), BY), 6);
  for (int t = 0; t < g.n; ++t) {
    T* last = t == g.n - 1 ? r2 : nullptr;
    od3_sweep<T><<<grd, blk, 0, st>>>(p, rhs, fl, g, 1, T(omega), T(idx2),
                                      T(idy2), T(idz2), last);
    od3_sweep<T><<<grd, blk, 0, st>>>(p, rhs, fl, g, 0, T(omega), T(idx2),
                                      T(idy2), T(idz2), last);
    od3_walls<T><<<wgrd, blk, 0, st>>>(p, g);
  }
  const int nrows = g.kl * g.jl;
  row_sums<T><<<ceil_div(nrows, 256), 256, 0, st>>>(r2, nrows, g.il, rows);
  sum_partials<T><<<1, FIN, 0, st>>>(rows, nrows, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// geo = [ek, ej, ei, kl, jl, il, n, H, kmax, jmax, imax, koff, joff, ioff]
#define OBSDIST3D_ENTRY(NAME, T)                                              \
  int NAME(int dev, void* p, const void* rhs, const void* fl, const int* geo, \
           double omega, double idx2, double idy2, double idz2, void* r2,     \
           void* rows, void* out, void* stream) {                             \
    const Geom g{geo[0], geo[1], geo[2],  geo[3],  geo[4],  geo[5],  geo[6],  \
                 geo[7], geo[8], geo[9], geo[10], geo[11], geo[12], geo[13]}; \
    return run_obsdist3d<T>(dev, (T*)p, (const T*)rhs, (const uint8_t*)fl, g, \
                            omega, idx2, idy2, idz2, (T*)r2, (T*)rows,        \
                            (T*)out, (cudaStream_t)stream);                   \
  }

OBSDIST3D_ENTRY(rb_sor_obsdist3d_f32, float)
OBSDIST3D_ENTRY(rb_sor_obsdist3d_f64, double)

}  // extern "C"
