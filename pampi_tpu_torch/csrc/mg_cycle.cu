// The fused multigrid V-cycle for Hopper (sm_90a): its DOWN and UP halves,
// in 2-D and 3-D, float32 and float64, plain and masked (kernels K9-K12 of
// the port).
//
// mg_down_2d / mg_down_3d (and their masked entries mg_down_*_masked)
//   replace pampi_tpu/ops/mg_fused.py _down_body (make_cycle_kernels,
//   pallas_call at :397).
// mg_up_2d / mg_up_3d (mg_up_*_masked) replace _up_body (pallas_call at
//   :409).
//
// What they compute, level by level (levels finest first, each its own
// compact extended array (J+2, I+2) or (K+2, J+2, I+2), ghosts included;
// coefficients per level [idx2, idy2, (idz2,) factor]):
//   DOWN, for l = 0..L-2: n red-black omega=1 sweeps on p_l (each a colour
//     half-sweep r = rhs - lap(p) masked to the colour, p -= factor*r, the
//     other colour, then the face Neumann copy with edges and corners
//     untouched), store p_l, then restrict: the coarse rhs cell is the mean
//     of its 2^d fine residuals, the coarse ghost ring is 0, and p_{l+1}
//     starts at 0. Level 0 reads the caller's p and rhs and writes p_0.
//   UP, for l = L-2..0: out_l = p_l plus the coarser correction, prolonged
//     piecewise-constant, on the interior, the Neumann copy, then n sweeps
//     against rhs_l; the correction of level L-1 is the bottom solution
//     the caller computed between the two halves.
// Colour order: red ((i+j) even) first in 2-D, odd (i+j+k) first in 3-D.
//
// What bounds them on the H100: memory bandwidth (~10-13 flops per cell
// update). The least DOWN must move is the fine p and rhs read once and
// every stored level and restricted rhs written once; UP reads both stacks
// and the bottom once and writes the fine p: ~0.073 ms each at 4096^2 f32
// (L = 5), 3.35 TB/s. The masked mode also reads every level's flags and
// factors once.
//
// Design (simple and right first): the TPU kernel walks all levels in one
// grid step with the whole plane in VMEM; a 4096^2 plane does not fit a
// block's shared memory and CUDA blocks run in no order, so every ordering
// point is a launch boundary, issued by one host function per half:
//   - one launch per colour, in place (a colour reads only the other
//     colour), except the very first half-sweep of DOWN, which reads the
//     caller's p and writes every cell of p_0 (the colour updated, the rest
//     copied), so p_0 needs no separate copy;
//   - one Neumann launch per sweep (it reads interior cells that no thread
//     of that launch writes);
//   - residual and restriction in one launch: each coarse cell computes its
//     2^d fine residuals itself, so no residual field is written; the same
//     launch writes the coarse rhs ghost ring and zeroes the coarse p;
//   - prolongation, add and Neumann in one launch: a face ghost computes
//     the value of its adjacent interior cell the same way.
// Launches per call at n sweeps: (3n + 1)(L - 1) for each half, 7(L - 1)
// at n = 2 (28 each at 4096^2, L = 5). No shared memory, no atomics, no
// reductions: every result is reproducible.
//
// The masked mode (mg_down_*_masked / mg_up_*_masked, the obstacle
// multigrid: make_cycle_kernels(fluid_levels=, factor_levels=), the
// `masked=True` bodies of the same two pallas_calls) takes per level the
// uint8 flags fl (0 on obstacle cells, the ghost ring fluid) and the omega=1
// relaxation factor fac, both of the level's extended shape (fac 0 on the
// ring and on obstacle cells):
//   - the colour update is r = (rhs - lap_obs(p))*fl, p = c - fac*r, with
//     lap_obs's per-direction coefficients fl(+)*fl and fl(-)*fl;
//   - the restricted residual is masked by fl the same way;
//   - UP adds the prolonged correction times fl (fluid cells only).
// Everything else (launches, order, Neumann copies) is the plain mode's.
//
// Arithmetic keeps the plain versions' association term for term:
//   lap = (e - 2c + w)*idx2 + (n - 2c + s)*idy2 [+ (b - 2c + f)*idz2]
//   p   = c - factor*(rhs - lap)
//   lap_obs = (fe*f0*(e - c) + fw*f0*(w - c))*idx2
//             + (fn*f0*(n - c) + fs*f0*(s - c))*idy2 [+ the same in z]
//   p   = c - fac*((rhs - lap_obs)*f0)          (masked)
//   rc  = (((r0 + r1) + r2) + ...) / 2^d, fine cells in (k,) j, i order
//   out = p + e_coarse           (masked: p + e_coarse*fl)
// built with --fmad=false so no multiply-add is contracted.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

// the level's extents and strides; K = 0 in 2-D
struct Lvl {
  int K, J, I;
  size_t W, P;
};

template <int ND>
Lvl level(const int* ext, int l) {
  Lvl a;
  if (ND == 3) {
    a.K = ext[3 * l];
    a.J = ext[3 * l + 1];
    a.I = ext[3 * l + 2];
  } else {
    a.K = 0;
    a.J = ext[2 * l];
    a.I = ext[2 * l + 1];
  }
  a.W = (size_t)a.I + 2;
  a.P = (size_t)(a.J + 2) * a.W;
  return a;
}

typedef unsigned char u8;

// the residual of cell x; masked (M): the flag-masked obstacle stencil,
// times the cell's flag
template <typename T, int ND, bool M>
__device__ __forceinline__ T resid(const T* __restrict__ p,
                                   const u8* __restrict__ fl, T rhs, T c,
                                   size_t x, size_t W, size_t P, T idx2,
                                   T idy2, T idz2) {
  if (!M) {
    T lap = (p[x + 1] - T(2) * c + p[x - 1]) * idx2 +
            (p[x + W] - T(2) * c + p[x - W]) * idy2;
    if (ND == 3) lap = lap + (p[x + P] - T(2) * c + p[x - P]) * idz2;
    return rhs - lap;
  }
  const T f0 = T(fl[x]);
  T lap = (T(fl[x + 1]) * f0 * (p[x + 1] - c) +
           T(fl[x - 1]) * f0 * (p[x - 1] - c)) * idx2 +
          (T(fl[x + W]) * f0 * (p[x + W] - c) +
           T(fl[x - W]) * f0 * (p[x - W] - c)) * idy2;
  if (ND == 3)
    lap = lap + (T(fl[x + P]) * f0 * (p[x + P] - c) +
                 T(fl[x - P]) * f0 * (p[x - P] - c)) * idz2;
  return (rhs - lap) * f0;
}

// one colour, in place: interior cells with (i + j [+ k]) % 2 == par;
// thread (t, row) takes the t-th cell of its colour in row (k, j),
// k = 1 + blockIdx.z in 3-D
template <typename T, int ND, bool M>
__global__ void mg_color(T* __restrict__ p, const T* __restrict__ rhs,
                         const u8* __restrict__ fl, const T* __restrict__ fac,
                         int J, int I, size_t W, size_t P, int par, T factor,
                         T idx2, T idy2, T idz2) {
  const int k = ND == 3 ? 1 + (int)blockIdx.z : 0;
  const int j = 1 + blockIdx.y * BY + threadIdx.y;
  const int t = blockIdx.x * BX + threadIdx.x;
  if (j > J) return;
  const int i = (((1 + j + k) & 1) == par ? 1 : 2) + 2 * t;
  if (i > I) return;
  const size_t x = (size_t)k * P + (size_t)j * W + i;
  const T c = p[x];
  p[x] = c - (M ? fac[x] : factor) *
                 resid<T, ND, M>(p, fl, rhs[x], c, x, W, P, idx2, idy2, idz2);
}

// the first colour of DOWN: every cell of dst, the colour updated from
// src (whose other colour it reads), the rest copied from src
template <typename T, int ND, bool M>
__global__ void mg_color_copy(const T* __restrict__ src, T* __restrict__ dst,
                              const T* __restrict__ rhs,
                              const u8* __restrict__ fl,
                              const T* __restrict__ fac, int K, int J, int I,
                              size_t W, size_t P, int par, T factor, T idx2,
                              T idy2, T idz2) {
  const int k = ND == 3 ? (int)blockIdx.z : 0;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int i = blockIdx.x * BX + threadIdx.x;
  if (j > J + 1 || i > I + 1) return;
  const size_t x = (size_t)k * P + (size_t)j * W + i;
  const T c = src[x];
  const bool inner = i >= 1 && i <= I && j >= 1 && j <= J &&
                     (ND == 2 || (k >= 1 && k <= K));
  if (inner && ((i + j + k) & 1) == par)
    dst[x] = c - (M ? fac[x] : factor) *
                     resid<T, ND, M>(src, fl, rhs[x], c, x, W, P, idx2, idy2,
                                     idz2);
  else
    dst[x] = c;
}

// 2-D Neumann copy on the four walls, corners untouched
template <typename T>
__global__ void mg_neumann2(T* __restrict__ p, int J, int I, size_t W) {
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

// 3-D Neumann copy on the six faces, tangentially clipped; blockIdx.z
// picks the axis (0: k faces, 1: j faces, 2: i faces), (a, b) = 1 + the
// thread's (y, x) position on the face
template <typename T>
__global__ void mg_neumann3(T* __restrict__ p, int K, int J, int I, size_t W,
                            size_t P) {
  const int a = 1 + blockIdx.y * BY + threadIdx.y;
  const int b = 1 + blockIdx.x * BX + threadIdx.x;
  if (blockIdx.z == 0) {
    if (a <= J && b <= I) {
      const size_t x = a * W + b;
      p[x] = p[P + x];
      p[(K + 1) * P + x] = p[K * P + x];
    }
  } else if (blockIdx.z == 1) {
    if (a <= K && b <= I) {
      const size_t x = a * P + b;
      p[x] = p[x + W];
      p[x + (J + 1) * W] = p[x + J * W];
    }
  } else {
    if (a <= K && b <= J) {
      const size_t x = a * P + b * W;
      p[x] = p[x + 1];
      p[x + I + 1] = p[x + I];
    }
  }
}

// residual + full-weighting restriction onto the coarse level (f = fine,
// c = coarse); thread per coarse extended cell: the interior takes the mean
// of its 2^d fine residuals, the ghost ring 0; the coarse p is zeroed
template <typename T, int ND, bool M>
__global__ void mg_restrict(const T* __restrict__ p, const T* __restrict__ rhs,
                            const u8* __restrict__ fl, T* __restrict__ rc,
                            T* __restrict__ pc, Lvl f, Lvl c, T idx2, T idy2,
                            T idz2) {
  const int kc = ND == 3 ? (int)blockIdx.z : 0;
  const int jc = blockIdx.y * BY + threadIdx.y;
  const int ic = blockIdx.x * BX + threadIdx.x;
  if (jc > c.J + 1 || ic > c.I + 1) return;
  const size_t xc = (size_t)kc * c.P + (size_t)jc * c.W + ic;
  pc[xc] = T(0);
  const bool inner = ic >= 1 && ic <= c.I && jc >= 1 && jc <= c.J &&
                     (ND == 2 || (kc >= 1 && kc <= c.K));
  if (!inner) {
    rc[xc] = T(0);
    return;
  }
  T s = T(0);
  for (int q = 0; q < (1 << ND); ++q) {
    // q walks the block in (k,) j, i order, i fastest
    const int di = q & 1;
    const int dj = (q >> 1) & 1;
    const int dk = ND == 3 ? (q >> 2) & 1 : 0;
    const int kf = ND == 3 ? 2 * kc - 1 + dk : 0;
    const size_t x = (size_t)kf * f.P + (size_t)(2 * jc - 1 + dj) * f.W +
                     (2 * ic - 1 + di);
    const T r = resid<T, ND, M>(p, fl, rhs[x], p[x], x, f.W, f.P, idx2, idy2,
                                idz2);
    s = q == 0 ? r : s + r;
  }
  rc[xc] = s / T(1 << ND);
}

// out = pf + the coarse correction ec prolonged (masked: times the fine
// cell's flag), on the interior; a face ghost takes its adjacent interior
// cell's new value (the Neumann copy); edges and corners keep pf
template <typename T, int ND, bool M>
__global__ void mg_prolong_add(const T* __restrict__ pf,
                               const T* __restrict__ ec,
                               const u8* __restrict__ fl, T* __restrict__ out,
                               Lvl f, Lvl c) {
  const int k = ND == 3 ? (int)blockIdx.z : 0;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int i = blockIdx.x * BX + threadIdx.x;
  if (j > f.J + 1 || i > f.I + 1) return;
  const size_t x = (size_t)k * f.P + (size_t)j * f.W + i;
  const int ii = i < 1 ? 1 : (i > f.I ? f.I : i);
  const int jj = j < 1 ? 1 : (j > f.J ? f.J : j);
  const int kk = ND == 3 ? (k < 1 ? 1 : (k > f.K ? f.K : k)) : 0;
  const int outside = (ii != i) + (jj != j) + (kk != k);
  if (outside >= 2) {
    out[x] = pf[x];
    return;
  }
  const size_t y = (size_t)kk * f.P + (size_t)jj * f.W + ii;
  const size_t yc = (ND == 3 ? (size_t)((kk + 1) / 2) * c.P : 0) +
                    (size_t)((jj + 1) / 2) * c.W + (ii + 1) / 2;
  out[x] = M ? pf[y] + ec[yc] * T(fl[y]) : pf[y] + ec[yc];
}

dim3 color_grid(const Lvl& a, int nd) {
  return dim3(((a.I + 1) / 2 + BX - 1) / BX, (a.J + BY - 1) / BY,
              nd == 3 ? a.K : 1);
}

dim3 full_grid(const Lvl& a, int nd) {
  return dim3((a.I + 2 + BX - 1) / BX, (a.J + 2 + BY - 1) / BY,
              nd == 3 ? a.K + 2 : 1);
}

// colour order: red first in 2-D, odd first in 3-D
template <int ND>
int parity(int h) {
  return ND == 3 ? 1 - h : h;
}

template <typename T, int ND>
void neumann(T* p, const Lvl& a, cudaStream_t st) {
  if (ND == 2) {
    const int m = a.I > a.J ? a.I : a.J;
    mg_neumann2<T><<<(m + 255) / 256, 256, 0, st>>>(p, a.J, a.I, a.W);
  } else {
    const int mx = a.I > a.J ? a.I : a.J;
    const int my = a.J > a.K ? a.J : a.K;
    const dim3 grd((mx + BX - 1) / BX, (my + BY - 1) / BY, 3);
    mg_neumann3<T><<<grd, dim3(BX, BY), 0, st>>>(p, a.K, a.J, a.I, a.W, a.P);
  }
}

// sweeps s0..n-1 of n on p (s0 = 1 after DOWN's fused first half-sweep
// pair); `first` skips the first colour, already done by mg_color_copy
template <typename T, int ND, bool M>
void sweeps(T* p, const T* rhs, const u8* fl, const T* fac, const Lvl& a,
            const double* cf, int n, bool first, cudaStream_t st) {
  const T idx2 = T(cf[0]), idy2 = T(cf[1]);
  const T idz2 = ND == 3 ? T(cf[2]) : T(0);
  const T factor = T(cf[ND]);
  const dim3 grd = color_grid(a, ND);
  const dim3 blk(BX, BY);
  for (int s = 0; s < n; ++s) {
    for (int h = (s == 0 && first) ? 1 : 0; h < 2; ++h)
      mg_color<T, ND, M><<<grd, blk, 0, st>>>(p, rhs, fl, fac, a.J, a.I, a.W,
                                              a.P, parity<ND>(h), factor, idx2,
                                              idy2, idz2);
    neumann<T, ND>(p, a, st);
  }
}

// fl and fac: the masked mode's per-level flags and factors (host arrays of
// device pointers), null in the plain mode
template <typename T, int ND, bool M>
int run_down(int dev, const T* p, const T* rhs, T** pstk, T** rstk,
             const u8* const* fl, T* const* fac, const int* ext,
             const double* coef, int L, int n, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 blk(BX, BY);
  for (int l = 0; l < L - 1; ++l) {
    const Lvl a = level<ND>(ext, l);
    const Lvl b = level<ND>(ext, l + 1);
    const double* cf = coef + l * (ND + 1);
    const T* rl = l == 0 ? rhs : rstk[l];
    const u8* fll = M ? fl[l] : nullptr;
    const T* facl = M ? fac[l] : nullptr;
    if (l == 0)
      mg_color_copy<T, ND, M><<<full_grid(a, ND), blk, 0, st>>>(
          p, pstk[0], rhs, fll, facl, a.K, a.J, a.I, a.W, a.P, parity<ND>(0),
          T(cf[ND]), T(cf[0]), T(cf[1]), ND == 3 ? T(cf[2]) : T(0));
    sweeps<T, ND, M>(pstk[l], rl, fll, facl, a, cf, n, l == 0, st);
    mg_restrict<T, ND, M><<<full_grid(b, ND), blk, 0, st>>>(
        pstk[l], rl, fll, rstk[l + 1], pstk[l + 1], a, b, T(cf[0]), T(cf[1]),
        ND == 3 ? T(cf[2]) : T(0));
  }
  return (int)cudaGetLastError();
}

template <typename T, int ND, bool M>
int run_up(int dev, T** pstk, T** rstk, const T* pbot, T** out,
           const u8* const* fl, T* const* fac, const int* ext,
           const double* coef, int L, int n, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 blk(BX, BY);
  const T* ec = pbot;
  for (int l = L - 2; l >= 0; --l) {
    const Lvl a = level<ND>(ext, l);
    const Lvl b = level<ND>(ext, l + 1);
    const u8* fll = M ? fl[l] : nullptr;
    mg_prolong_add<T, ND, M><<<full_grid(a, ND), blk, 0, st>>>(
        pstk[l], ec, fll, out[l], a, b);
    sweeps<T, ND, M>(out[l], rstk[l], fll, M ? fac[l] : nullptr, a,
                     coef + l * (ND + 1), n, false, st);
    ec = out[l];
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

#define DOWN_ENTRY(NAME, T, ND)                                               \
  int NAME(int dev, const void* p, const void* rhs, void** pstk, void** rstk, \
           const int* ext, const double* coef, int L, int n, void* stream) {  \
    return run_down<T, ND, false>(dev, (const T*)p, (const T*)rhs, (T**)pstk, \
                                  (T**)rstk, nullptr, nullptr, ext, coef, L,  \
                                  n, (cudaStream_t)stream);                   \
  }

#define UP_ENTRY(NAME, T, ND)                                                 \
  int NAME(int dev, void** pstk, void** rstk, const void* pbot, void** out,   \
           const int* ext, const double* coef, int L, int n, void* stream) {  \
    return run_up<T, ND, false>(dev, (T**)pstk, (T**)rstk, (const T*)pbot,    \
                                (T**)out, nullptr, nullptr, ext, coef, L, n,  \
                                (cudaStream_t)stream);                        \
  }

#define DOWN_MASKED_ENTRY(NAME, T, ND)                                        \
  int NAME(int dev, const void* p, const void* rhs, void** pstk, void** rstk, \
           void** fl, void** fac, const int* ext, const double* coef, int L,  \
           int n, void* stream) {                                             \
    return run_down<T, ND, true>(dev, (const T*)p, (const T*)rhs, (T**)pstk,  \
                                 (T**)rstk, (const u8* const*)fl, (T**)fac,   \
                                 ext, coef, L, n, (cudaStream_t)stream);      \
  }

#define UP_MASKED_ENTRY(NAME, T, ND)                                          \
  int NAME(int dev, void** pstk, void** rstk, const void* pbot, void** out,   \
           void** fl, void** fac, const int* ext, const double* coef, int L,  \
           int n, void* stream) {                                             \
    return run_up<T, ND, true>(dev, (T**)pstk, (T**)rstk, (const T*)pbot,     \
                               (T**)out, (const u8* const*)fl, (T**)fac, ext, \
                               coef, L, n, (cudaStream_t)stream);             \
  }

DOWN_ENTRY(mg_down_2d_f32, float, 2)
DOWN_ENTRY(mg_down_2d_f64, double, 2)
DOWN_ENTRY(mg_down_3d_f32, float, 3)
DOWN_ENTRY(mg_down_3d_f64, double, 3)
UP_ENTRY(mg_up_2d_f32, float, 2)
UP_ENTRY(mg_up_2d_f64, double, 2)
UP_ENTRY(mg_up_3d_f32, float, 3)
UP_ENTRY(mg_up_3d_f64, double, 3)
DOWN_MASKED_ENTRY(mg_down_2d_masked_f32, float, 2)
DOWN_MASKED_ENTRY(mg_down_2d_masked_f64, double, 2)
DOWN_MASKED_ENTRY(mg_down_3d_masked_f32, float, 3)
DOWN_MASKED_ENTRY(mg_down_3d_masked_f64, double, 3)
UP_MASKED_ENTRY(mg_up_2d_masked_f32, float, 2)
UP_MASKED_ENTRY(mg_up_2d_masked_f64, double, 2)
UP_MASKED_ENTRY(mg_up_3d_masked_f32, float, 3)
UP_MASKED_ENTRY(mg_up_3d_masked_f64, double, 3)

}  // extern "C"
