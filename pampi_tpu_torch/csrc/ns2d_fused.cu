// NS-2D step phases for Hopper (sm_90a): the port's PRE and POST kernels,
// single device, no obstacles.
//
// ns2d_pre (K3) replaces pampi_tpu/ops/ns2d_fused.py _pre_kernel
//   (make_fused_pre_2d): (u, v, dt) -> (u', v', F, G, rhs) = wall BCs ->
//   dcavity lid / canal inflow -> F/G predictor + wall fixups -> RHS.
// ns2d_post (K4) replaces pampi_tpu/ops/ns2d_fused.py _post_kernel
//   (make_fused_post_2d): adaptUV, then max|u| and max|v| over the FULL
//   ghosted arrays (the reference maxElement quirk) for the next CFL dt.
//
// What bounds them on the H100: memory bandwidth. Both run in place, where
// the Pallas kernels write whole new u and v arrays. So PRE must read u, v
// and write F, G, rhs plus the ghost ring of u and v, and POST must read F,
// G, p and the ghost ring of u and v (for the maxima) and write the
// interior of u and v: 5 field-sizes each, ~100 us at 4096^2 f32 and
// 3.35 TB/s (the TPU kernels' 7 would be ~140 us). The ~60 flops per cell
// of the predictor are far below the FP32/FP64 roof.
//
// Design (simple and right first): the Pallas kernels do everything in one
// pass over VMEM windows with a halo. Here PRE is three launches:
//   1. the boundary strips, in place on u and v, by ONE block that walks
//      the walls in the reference order (left, right, bottom, top, then the
//      special BC) with a barrier between walls, because later walls read
//      earlier walls' writes (bottom/top read u(.,imax) set by the right
//      wall) — a few thousand cells, so one block is enough;
//   2. F and G for every cell of the ghosted array, wall fixups included;
//   3. rhs, which reads F and G of neighbouring blocks, so it cannot share
//      launch 2 without a halo tile (one-launch PRE is later work).
// POST is one launch (the projection reads only p neighbours, so u and v
// update in place) that also writes per-block partial maxima, and a
// one-block launch that reduces the partials. max is exact in any order,
// so the maxima equal the plain version's bitwise; NaN propagates as in
// torch.max. dt stays on the device (a pointer), so a step never waits on
// the host for it.
//
// Every formula keeps the association of pampi_tpu/ops/ns2d.py term for
// term; scalar coefficients are formed in double on the host exactly where
// the reference forms them from Python floats, then rounded to T. Built
// with --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int NOSLIP = 1, SLIP = 2, OUTFLOW = 3;
constexpr int DCAVITY = 1, CANAL = 2;
constexpr int BX = 32, BY = 8, NT = BX * BY;
constexpr int BC_THREADS = 1024;
constexpr int FIN = 1024;

template <typename T>
struct Coef {
  T idx4, gidx4, idy4, gidy4, idx2, idy2, inv_re, gx, gy;
};

template <typename T>
__global__ void bc_strips(T* __restrict__ u, T* __restrict__ v, int J, int I,
                          int bl, int br, int bb, int bt, int problem, T dy,
                          T yl, T yl2) {
  const size_t W = I + 2;
#define U(j, i) u[(size_t)(j) * W + (i)]
#define V(j, i) v[(size_t)(j) * W + (i)]
  const int t0 = threadIdx.x;
  for (int j = 1 + t0; j <= J; j += BC_THREADS) {  // left: U on the wall
    if (bl == NOSLIP) { U(j, 0) = T(0); V(j, 0) = -V(j, 1); }
    else if (bl == SLIP) { U(j, 0) = T(0); V(j, 0) = V(j, 1); }
    else if (bl == OUTFLOW) { U(j, 0) = U(j, 1); V(j, 0) = V(j, 1); }
  }
  __syncthreads();
  for (int j = 1 + t0; j <= J; j += BC_THREADS) {  // right: U(imax) on it
    if (br == NOSLIP) { U(j, I) = T(0); V(j, I + 1) = -V(j, I); }
    else if (br == SLIP) { U(j, I) = T(0); V(j, I + 1) = V(j, I); }
    else if (br == OUTFLOW) { U(j, I) = U(j, I - 1); V(j, I + 1) = V(j, I); }
  }
  __syncthreads();
  for (int i = 1 + t0; i <= I; i += BC_THREADS) {  // bottom: V on the wall
    if (bb == NOSLIP) { V(0, i) = T(0); U(0, i) = -U(1, i); }
    else if (bb == SLIP) { V(0, i) = T(0); U(0, i) = U(1, i); }
    else if (bb == OUTFLOW) { U(0, i) = U(1, i); V(0, i) = V(1, i); }
  }
  __syncthreads();
  for (int i = 1 + t0; i <= I; i += BC_THREADS) {  // top: V(jmax) on it
    if (bt == NOSLIP) { V(J, i) = T(0); U(J + 1, i) = -U(J, i); }
    else if (bt == SLIP) { V(J, i) = T(0); U(J + 1, i) = U(J, i); }
    else if (bt == OUTFLOW) { U(J + 1, i) = U(J, i); V(J, i) = V(J - 1, i); }
  }
  __syncthreads();
  if (problem == DCAVITY) {
    // lid, skipping the last interior i (the reference loop-bound quirk)
    for (int i = 1 + t0; i <= I - 1; i += BC_THREADS)
      U(J + 1, i) = T(2) - U(J, i);
  } else if (problem == CANAL) {
    for (int j = 1 + t0; j <= J; j += BC_THREADS) {
      const T y = (T(j) - T(0.5)) * dy;
      U(j, 0) = y * (yl - y) * T(4) / yl2;
    }
  }
#undef U
#undef V
}

template <typename T>
__global__ void fg_cells(const T* __restrict__ u, const T* __restrict__ v,
                         const T* __restrict__ dtp, T* __restrict__ f,
                         T* __restrict__ g, int J, int I, Coef<T> c) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i > I + 1 || j > J + 1) return;
  const size_t W = I + 2;
  const size_t k = (size_t)j * W + i;
  const bool rows = j >= 1 && j <= J;
  const bool cols = i >= 1 && i <= I;
  T fv = T(0), gv = T(0);
  if (rows && cols) {
    const T dt = *dtp;
    const T uc = u[k], ue = u[k + 1], uw = u[k - 1], un = u[k + W],
            us = u[k - W], unw = u[k + W - 1];
    const T vc = v[k], ve = v[k + 1], vw = v[k - 1], vn = v[k + W],
            vs = v[k - W], vse = v[k - W + 1];
    const T du2dx = c.idx4 * ((uc + ue) * (uc + ue) - (uc + uw) * (uc + uw)) +
                    c.gidx4 * (fabs(uc + ue) * (uc - ue) +
                               fabs(uc + uw) * (uc - uw));
    const T duvdy = c.idy4 * ((vc + ve) * (uc + un) - (vs + vse) * (uc + us)) +
                    c.gidy4 * (fabs(vc + ve) * (uc - un) +
                               fabs(vs + vse) * (uc - us));
    const T lap_u = c.idx2 * (ue - T(2) * uc + uw) +
                    c.idy2 * (un - T(2) * uc + us);
    fv = uc + dt * (c.inv_re * lap_u - du2dx - duvdy + c.gx);
    const T duvdx = c.idx4 * ((uc + un) * (vc + ve) - (uw + unw) * (vc + vw)) +
                    c.gidx4 * (fabs(uc + un) * (vc - ve) +
                               fabs(uw + unw) * (vc - vw));
    const T dv2dy = c.idy4 * ((vc + vn) * (vc + vn) - (vc + vs) * (vc + vs)) +
                    c.gidy4 * (fabs(vc + vn) * (vc - vn) +
                               fabs(vc + vs) * (vc - vs));
    const T lap_v = c.idx2 * (ve - T(2) * vc + vw) +
                    c.idy2 * (vn - T(2) * vc + vs);
    gv = vc + dt * (c.inv_re * lap_v - duvdx - dv2dy + c.gy);
  }
  // wall fixups: F carries U on vertical walls, G carries V on horizontal
  if (rows && (i == 0 || i == I)) fv = u[k];
  if (cols && (j == 0 || j == J)) gv = v[k];
  f[k] = fv;
  g[k] = gv;
}

template <typename T>
__global__ void rhs_cells(const T* __restrict__ f, const T* __restrict__ g,
                          const T* __restrict__ dtp, T* __restrict__ rhs,
                          int J, int I, T dx, T dy) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i > I + 1 || j > J + 1) return;
  const size_t W = I + 2;
  const size_t k = (size_t)j * W + i;
  T r = T(0);
  if (j >= 1 && j <= J && i >= 1 && i <= I) {
    const T inv_dt = T(1) / *dtp;
    r = inv_dt * ((f[k] - f[k - 1]) / dx + (g[k] - g[k - W]) / dy);
  }
  rhs[k] = r;
}

template <typename T>
__device__ __forceinline__ T nanmax(T m, T a) {
  return (a > m || a != a) ? a : m;
}

template <typename T>
__global__ void adapt_cells(T* __restrict__ u, T* __restrict__ v,
                            const T* __restrict__ f, const T* __restrict__ g,
                            const T* __restrict__ p, const T* __restrict__ dtp,
                            int J, int I, T dx, T dy, T* __restrict__ partial) {
  __shared__ T shu[NT];
  __shared__ T shv[NT];
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int tid = threadIdx.y * BX + threadIdx.x;
  T au = T(0), av = T(0);
  if (i <= I + 1 && j <= J + 1) {
    const size_t W = I + 2;
    const size_t k = (size_t)j * W + i;
    T uu = u[k], vv = v[k];
    if (j >= 1 && j <= J && i >= 1 && i <= I) {
      const T dt = *dtp;
      const T fx = dt / dx;
      const T fy = dt / dy;
      uu = f[k] - (p[k + 1] - p[k]) * fx;
      vv = g[k] - (p[k + W] - p[k]) * fy;
      u[k] = uu;
      v[k] = vv;
    }
    au = fabs(uu);
    av = fabs(vv);
  }
  shu[tid] = au;
  shv[tid] = av;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
      shu[tid] = nanmax(shu[tid], shu[tid + s]);
      shv[tid] = nanmax(shv[tid], shv[tid + s]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int nb = gridDim.x * gridDim.y;
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    partial[b] = shu[0];
    partial[nb + b] = shv[0];
  }
}

template <typename T>
__global__ void max_partials(const T* __restrict__ partial, int nb,
                             T* __restrict__ out) {
  __shared__ T shu[FIN];
  __shared__ T shv[FIN];
  T mu = T(0), mv = T(0);
  for (int k = threadIdx.x; k < nb; k += FIN) {
    mu = nanmax(mu, partial[k]);
    mv = nanmax(mv, partial[nb + k]);
  }
  shu[threadIdx.x] = mu;
  shv[threadIdx.x] = mv;
  __syncthreads();
  for (int s = FIN / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      shu[threadIdx.x] = nanmax(shu[threadIdx.x], shu[threadIdx.x + s]);
      shv[threadIdx.x] = nanmax(shv[threadIdx.x], shv[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = shu[0];
    out[1] = shv[0];
  }
}

dim3 cell_grid(int J, int I) {
  return dim3((I + 2 + BX - 1) / BX, (J + 2 + BY - 1) / BY);
}

template <typename T>
int run_pre(int dev, T* u, T* v, const T* dt, T* f, T* g, T* rhs, int J,
            int I, const int* bc, int problem, const double* c, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  // c = [idx*0.25, gamma*idx*0.25, idy*0.25, gamma*idy*0.25, idx*idx,
  //      idy*idy, 1/re, gx, gy, dx, dy, ylength, ylength*ylength]
  bc_strips<T><<<1, BC_THREADS, 0, st>>>(u, v, J, I, bc[0], bc[1], bc[2],
                                         bc[3], problem, T(c[10]), T(c[11]),
                                         T(c[12]));
  const Coef<T> k{T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4]),
                  T(c[5]), T(c[6]), T(c[7]), T(c[8])};
  const dim3 grd = cell_grid(J, I);
  const dim3 blk(BX, BY);
  fg_cells<T><<<grd, blk, 0, st>>>(u, v, dt, f, g, J, I, k);
  rhs_cells<T><<<grd, blk, 0, st>>>(f, g, dt, rhs, J, I, T(c[9]), T(c[10]));
  return (int)cudaGetLastError();
}

template <typename T>
int run_post(int dev, T* u, T* v, const T* f, const T* g, const T* p,
             const T* dt, int J, int I, double dx, double dy, T* partial,
             T* out, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grd = cell_grid(J, I);
  adapt_cells<T><<<grd, dim3(BX, BY), 0, st>>>(u, v, f, g, p, dt, J, I, T(dx),
                                               T(dy), partial);
  max_partials<T><<<1, FIN, 0, st>>>(partial, (int)(grd.x * grd.y), out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-max buffer ns2d_post needs
int ns2d_post_partials(int J, int I) {
  const dim3 g = cell_grid(J, I);
  return 2 * (int)(g.x * g.y);
}

#define PRE_ENTRY(NAME, T)                                                   \
  int NAME(int dev, void* u, void* v, const void* dt, void* f, void* g,      \
           void* rhs, int J, int I, const int* bc, int problem,              \
           const double* c, void* stream) {                                  \
    return run_pre<T>(dev, (T*)u, (T*)v, (const T*)dt, (T*)f, (T*)g,         \
                      (T*)rhs, J, I, bc, problem, c, stream);                \
  }

#define POST_ENTRY(NAME, T)                                                  \
  int NAME(int dev, void* u, void* v, const void* f, const void* g,          \
           const void* p, const void* dt, int J, int I, double dx,           \
           double dy, void* partial, void* out, void* stream) {              \
    return run_post<T>(dev, (T*)u, (T*)v, (const T*)f, (const T*)g,          \
                       (const T*)p, (const T*)dt, J, I, dx, dy, (T*)partial, \
                       (T*)out, stream);                                     \
  }

PRE_ENTRY(ns2d_pre_f32, float)
PRE_ENTRY(ns2d_pre_f64, double)
POST_ENTRY(ns2d_post_f32, float)
POST_ENTRY(ns2d_post_f64, double)

}  // extern "C"
