// The shape-class lane's whole 2-D V-cycle in one launch, for Hopper
// (sm_90a), float32 and float64 (kernel K18 of the port).
//
// mg_class_cycle_2d replaces pampi_tpu/ops/mg_fused.py _class_cycle_body
//   (make_class_cycle_2d, pallas_call at :549), the solve of the fleet's
//   mg class lanes (pampi_tpu/fleet/shapeclass.make_class_mg_solve).
//
// What it computes, for every lane of a class batch at once: the lane's
// level plan arrives as data (ext rows [jl, il, live], geo rows [idx2,
// idy2, factor], ops/mg_fused.class_level_plan), so one build serves every
// lane of every class. Level 0 is the lane's live corner (jl+2, il+2) of its
// class block (jc+2, ic+2); levels l >= 1 live in a per-lane scratch
// buffer of compact levels, ((jc>>l)+2) x ((ic>>l)+2) each. Down every live
// level: n_pre red-black omega = 1 sweeps (red half, black half, then the
// Neumann copy of the faces, corners untouched) and, if the next level is
// live, the restriction (each coarse cell the mean of its four fine
// residuals, summed j-major with i fastest; zero coarse ghosts; coarse p
// = 0). At the deepest live level the corner's cells go through p + 0
// (the TPU kernel's up-pass add of a masked zero, which turns a -0.0 into
// +0.0), then n_bottom extra sweeps stand in for a direct bottom solve. Up
// every level above it: p += the coarse correction prolonged piecewise-
// constant on the interior (+0 on the ring), the Neumann copy, n_post
// sweeps; the deepest level also takes its n_post sweeps. Last, the fine
// residual's sum of squares. Levels past the deepest live one are skipped:
// on the TPU they are gated no-ops that leave every value unchanged.
// A lane whose `active` flag is 0 passes p through and returns rsq 0.
// Cells of the class block outside the lane's live corner are copied.
//
// What bounds it on the H100: neither bytes nor operations at the class
// sizes the fleet serves. A 64^2 lane holds 35 KB a field level, every
// level of a lane fits the 50 MB L2 many times over, and a cycle is a
// chain of about 100 dependent phases (each a few passes over at most a
// few thousand cells) separated by __syncthreads(). The bound the port
// records is bytes (fine p and rhs read, p written, every live coarser
// level once) over 3.35 TB/s; the kernel is expected to sit far above it,
// held by that barrier chain.
//
// Design (simple and right first): one CTA of NT threads per lane
// (grid = lanes); every ordering point of the TPU kernel's straight-line
// body is a __syncthreads(), and a phase is a block-strided loop over the
// level's cells in global memory (L2-resident). Colour half-sweeps update
// in place (a colour reads only the other colour); the Neumann copy reads
// only interior cells; restriction computes its four fine residuals itself
// (no residual field). The fine residual sum is a fixed-order tree: thread
// t adds r^2 of interior cells t, t + NT, ... (row-major over the live
// interior) in turn, then a halving tree over the NT threads in shared
// memory. Its order depends on the live extents only, not on the class,
// so a lane gives the same bits in every rung; the plain version
// (ops/mg_fused.class_cycle_plain) repeats it, so kernel and plain version
// agree bitwise, residual included. No atomics.
//
// Arithmetic keeps the plain version's association term for term:
//   lap = (e - 2c + w)*idx2 + (n - 2c + s)*idy2,  p = c - factor*(rhs - lap)
//   rc  = (((r00 + r01) + r10) + r11) / 4,        out = p + e_coarse
// built with --fmad=false so no multiply-add is contracted.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;    // threads of a lane's CTA (the sum's order)
constexpr int MAXL = 16;   // deepest plan the level table holds

struct Lvl {
  int J, I;
  int W;  // row stride of the level's storage
};

template <typename T>
__device__ __forceinline__ T resid(const T* p, T rhs, size_t x, int W,
                                   T idx2, T idy2) {
  const T c = p[x];
  const T lap = (p[x + 1] - T(2) * c + p[x - 1]) * idx2 +
                (p[x + W] - T(2) * c + p[x - W]) * idy2;
  return rhs - lap;
}

// one colour in place: interior cells with (i + j) % 2 == par; k walks
// the colour's cells row by row (hw slots a row)
template <typename T>
__device__ void colour(T* p, const T* rhs, Lvl a, int par, T factor, T idx2,
                       T idy2) {
  const int hw = (a.I + 1) >> 1;
  const int n = a.J * hw;
  for (int k = threadIdx.x; k < n; k += NT) {
    const int j = 1 + k / hw;
    const int i = (((1 + j) & 1) == par ? 1 : 2) + 2 * (k - (j - 1) * hw);
    if (i > a.I) continue;
    const size_t x = (size_t)j * a.W + i;
    p[x] = p[x] - factor * resid(p, rhs[x], x, a.W, idx2, idy2);
  }
}

// the Neumann copy of the four faces, corners untouched; reads interior
// cells only, so one pass
template <typename T>
__device__ void neumann(T* p, Lvl a) {
  const size_t W = a.W;
  for (int k = 1 + threadIdx.x; k <= a.I; k += NT) {
    p[k] = p[W + k];
    p[(size_t)(a.J + 1) * W + k] = p[(size_t)a.J * W + k];
  }
  for (int k = 1 + threadIdx.x; k <= a.J; k += NT) {
    p[k * W] = p[k * W + 1];
    p[k * W + a.I + 1] = p[k * W + a.I];
  }
}

template <typename T>
__device__ void smooth(T* p, const T* rhs, Lvl a, const T* g, int n) {
  const T idx2 = g[0], idy2 = g[1], factor = g[2];
  for (int s = 0; s < n; ++s) {
    colour(p, rhs, a, 0, factor, idx2, idy2);
    __syncthreads();
    colour(p, rhs, a, 1, factor, idx2, idy2);
    __syncthreads();
    neumann(p, a);
    __syncthreads();
  }
}

// fine level f -> coarse level c: rhs_c = the mean of four fine residuals
// on the interior, 0 on the ring; p_c = 0
template <typename T>
__device__ void restrict_level(const T* p, const T* rhs, Lvl f, const T* g,
                               T* pc, T* rc, Lvl c) {
  const T idx2 = g[0], idy2 = g[1];
  const int w = c.I + 2;
  const int n = (c.J + 2) * w;
  for (int k = threadIdx.x; k < n; k += NT) {
    const int jc = k / w, ic = k - jc * w;
    const size_t xc = (size_t)jc * c.W + ic;
    pc[xc] = T(0);
    if (jc < 1 || jc > c.J || ic < 1 || ic > c.I) {
      rc[xc] = T(0);
      continue;
    }
    T s = T(0);
    for (int q = 0; q < 4; ++q) {
      const size_t x =
          (size_t)(2 * jc - 1 + (q >> 1)) * f.W + (2 * ic - 1 + (q & 1));
      const T r = resid(p, rhs[x], x, f.W, idx2, idy2);
      s = q == 0 ? r : s + r;
    }
    rc[xc] = s / T(4);
  }
}

// p += the child's p prolonged on the interior, p + 0 on the ring (the
// Neumann copy then overwrites the faces); without a child (pc null) every
// cell takes p + 0, which only turns -0.0 into +0.0
template <typename T>
__device__ void prolong_add(T* p, Lvl a, const T* pc, Lvl c) {
  const int w = a.I + 2;
  const int n = (a.J + 2) * w;
  for (int k = threadIdx.x; k < n; k += NT) {
    const int j = k / w, i = k - j * w;
    const size_t x = (size_t)j * a.W + i;
    const T v = p[x];
    if (pc != nullptr && j >= 1 && j <= a.J && i >= 1 && i <= a.I)
      p[x] = v + pc[(size_t)((j + 1) >> 1) * c.W + ((i + 1) >> 1)];
    else
      p[x] = v == T(0) ? T(0) : v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    class_cycle(const T* __restrict__ pin, const T* __restrict__ rhs,
                T* out, const int* __restrict__ ext,
                const T* __restrict__ geo, const int* __restrict__ active,
                T* work, T* __restrict__ rsq, int jc, int ic,
                int lmax, size_t lane_work, int n_pre, int n_post,
                int n_bottom) {
  __shared__ T sh[NT];
  const int lane = blockIdx.x;
  const size_t plane = (size_t)(jc + 2) * (ic + 2);
  const T* src = pin + lane * plane;
  T* p0 = out + lane * plane;
  for (size_t k = threadIdx.x; k < plane; k += NT) p0[k] = src[k];
  if (!active[lane]) {
    if (threadIdx.x == 0) rsq[lane] = T(0);
    return;
  }
  const int* e = ext + (size_t)lane * lmax * 3;
  const T* g = geo + (size_t)lane * lmax * 3;
  T* lp[MAXL];
  T* lr[MAXL];
  Lvl lv[MAXL];
  T* wk = work + lane * lane_work;
  int L = 0;
  for (int l = 0; l < lmax && (l == 0 || e[3 * l + 2] != 0); ++l) {
    // clamped to the storage: a plan past the class never writes out of
    // bounds (the wrappers refuse such lanes before the launch)
    const int cj = jc >> l, ci = ic >> l;
    lv[l].J = min(max(e[3 * l], 1), cj);
    lv[l].I = min(max(e[3 * l + 1], 1), ci);
    lv[l].W = ci + 2;
    if (l == 0) {
      lp[0] = p0;
      lr[0] = const_cast<T*>(rhs) + lane * plane;
    } else {
      lp[l] = wk;
      lr[l] = wk + (size_t)(cj + 2) * (ci + 2);
      wk += 2 * (size_t)(cj + 2) * (ci + 2);
    }
    L = l + 1;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    smooth(lp[l], lr[l], lv[l], g + 3 * l, n_pre);
    if (l + 1 < L) {
      restrict_level(lp[l], lr[l], lv[l], g + 3 * l, lp[l + 1], lr[l + 1],
                     lv[l + 1]);
      __syncthreads();
    }
  }
  for (int l = L - 1; l >= 0; --l) {
    const bool child = l + 1 < L;
    prolong_add(lp[l], lv[l], child ? lp[l + 1] : nullptr,
                child ? lv[l + 1] : lv[l]);
    __syncthreads();
    if (child) {
      neumann(lp[l], lv[l]);
      __syncthreads();
    } else {
      smooth(lp[l], lr[l], lv[l], g + 3 * l, n_bottom);
    }
    smooth(lp[l], lr[l], lv[l], g + 3 * l, n_post);
  }
  // the fine residual's sum of squares in the fixed order
  const Lvl a = lv[0];
  const int n = a.J * a.I;
  T acc = T(0);
  for (int k = threadIdx.x; k < n; k += NT) {
    const int j = 1 + k / a.I;
    const size_t x = (size_t)j * a.W + 1 + (k - (j - 1) * a.I);
    const T r = resid(p0, lr[0][x], x, a.W, g[0], g[1]);
    acc = acc + r * r;
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s)
      sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) rsq[lane] = sh[0];
}

template <typename T>
int run(int dev, const T* p, const T* rhs, T* out, const int* ext,
        const T* geo, const int* active, T* work, T* rsq, int lanes, int jc,
        int ic, int lmax, long long lane_work, int n_pre, int n_post,
        int n_bottom, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  if (lmax < 1 || lmax > MAXL) return (int)cudaErrorInvalidValue;
  if (lanes > 0)
    class_cycle<T><<<lanes, NT, 0, st>>>(p, rhs, out, ext, geo, active, work,
                                         rsq, jc, ic, lmax,
                                         (size_t)lane_work, n_pre, n_post,
                                         n_bottom);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

#define CLASS_ENTRY(NAME, T)                                                 \
  int NAME(int dev, const void* p, const void* rhs, void* out,               \
           const void* ext, const void* geo, const void* active, void* work, \
           void* rsq, int lanes, int jc, int ic, int lmax,                   \
           long long lane_work, int n_pre, int n_post, int n_bottom,         \
           void* stream) {                                                   \
    return run<T>(dev, (const T*)p, (const T*)rhs, (T*)out, (const int*)ext, \
                  (const T*)geo, (const int*)active, (T*)work, (T*)rsq,      \
                  lanes, jc, ic, lmax, lane_work, n_pre, n_post, n_bottom,   \
                  (cudaStream_t)stream);                                     \
  }

CLASS_ENTRY(mg_class_cycle_2d_f32, float)
CLASS_ENTRY(mg_class_cycle_2d_f64, double)

}  // extern "C"
