// 3-D red-black SOR for Hopper (sm_90a): the port's two NS-3D solve kernels.
//
// rb_sor3d_checkerboard (K5) replaces pampi_tpu/ops/sor3d_pallas.py
//   _tblock3d_kernel (make_rb_iter_tblock_3d, plain mode) on the natural
//   (K+2, J+2, I+2) layout.
// rb_sor3d_octants (K6) replaces pampi_tpu/ops/sor3d_pallas.py
//   _tblock3d_octants_kernel (make_rb_iter_tblock_3d_octants) on the eight
//   stacked parity octants (8, (K+2)/2, (J+2)/2, (I+2)/2) in BITS order
//   (pampi_tpu_torch/ops/sor_octants.py: octant index 4*pk + 2*pj + pi).
//
// Both compute n_inner red-black iterations of the 7-point stencil, each an
// ODD-parity half-sweep ((i+j+k) odd, the reference's first pass), an even
// half-sweep that sees the odd one's updates, and the 6-face homogeneous-
// Neumann ghost refresh (faces tangentially clipped to the interior, edges
// and corners untouched), and return the sum of r^2 over both half-sweeps
// of the LAST iteration.
//
// What bounds them on the H100: memory bandwidth (~13 flops per cell
// update). The least any implementation must move per call is p and rhs
// read once and p written once, 3 field-sizes: at 128^3 f32 (130^3 * 4 B =
// 8.8 MB a field) ~7.9 us at 3.35 TB/s, at 256^3 ~61.5 us, whatever n_inner
// is. At 128^3, p and rhs fit the 50 MB L2, so that bound is no floor there.
//
// Design (simple and right first, as the 2-D kernels of sor_rb.cu): the TPU
// kernels run their grid steps in order and carry the residual across them
// in SMEM; CUDA blocks run in no order, so every ordering point is a launch
// boundary. Per iteration: one launch per colour (in place; within a colour
// every cell reads only the other colour), then one Neumann launch (the six
// faces are disjoint and read only interior planes, which no thread of that
// launch writes). On the last iteration each block writes its partial sum
// of r^2 (a fixed-order shared-memory tree) and a one-block launch sums the
// partials in a fixed order. No float atomics, so the residual, and every
// iteration count, is reproducible. In the octant layout every neighbour is
// a uniform shift of a dense array, so a thread updates the same index of
// its colour's four octants with unit-stride, coalesced reads, and the
// Neumann refresh is 24 same-index plane copies in one launch. Temporal
// blocking (several iterations per pass through memory, as the TPU kernels
// do) is later work.
//
// Arithmetic keeps the reference association term for term:
//   r = rhs - ((e - 2c + w)*idx2 + (n - 2c + s)*idy2 + (b - 2c + f)*idz2)
//   p = c - factor*r
// built with --fmad=false so no multiply-add is contracted.
//
// rb_sor3d_masked (K5's masked mode) replaces the masked mode of the same
//   TPU kernel (_tblock3d_kernel(masked=True), the NS-3D obstacle solve,
//   pampi_tpu/ops/obstacle3d.make_obstacle_solver_fn_3d): a cell updates
//   only where it is interior, of the colour and fluid (flag != 0), with
//   per-direction coefficients formed from the uint8 flags in the kernel
//   (sor3d_pallas.masked_stencil_ops_3d's order):
//     eps_* = the six neighbours' flags,
//     denom = (eps_e + eps_w)*idx2 + (eps_n + eps_s)*idy2
//             + (eps_b + eps_f)*idz2,
//     fac   = (denom > 0 ? omega/denom : 0) * flag,
//     r     = rhs - ((eps_e*(e - c) + eps_w*(w - c))*idx2
//                    + (eps_n*(n - c) + eps_s*(s - c))*idy2
//                    + (eps_b*(b - c) + eps_f*(f - c))*idz2),
//     p     = c - fac*r.
//   The flags add 1 byte a cell: the bound is 13 bytes a cell at float32
//   (p and rhs read, p written, the flags read). Its residual takes a
//   fixed order that a plain PyTorch version can repeat bit for bit: on
//   the last iteration each cell of a colour writes r^2 (0 on an
//   obstacle) into an interior-sized buffer, one thread per (k, j) row
//   sums its row from i = 1 up, and one block sums the rows as
//   sum_partials does (ops/sor_kernels.ordered_r2_sum is the plain
//   form). The per-shard kernel K16 (sor_obsdist3d.cu) reduces its owned
//   cells the same way, so on a one-shard mesh the two residuals agree
//   bitwise. The buffer costs one extra write and read of a field per
//   call, on the last iteration only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int FIN = 1024;

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
__device__ __forceinline__ T resid3(T c, T rhs, T w, T e, T s, T n, T f, T b,
                                    T idx2, T idy2, T idz2) {
  return rhs - ((e - T(2) * c + w) * idx2 + (n - T(2) * c + s) * idy2 +
                (b - T(2) * c + f) * idz2);
}

template <typename T>
__device__ __forceinline__ void write_partial(T rr, T* sh, T* partial) {
  const T s = block_sum(rr, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
            blockIdx.x] = s;
}

// one colour of the 3-D checkerboard, in place: cells (i+j+k)%2 == par,
// 1 <= i <= I, 1 <= j <= J, k = 1 + blockIdx.z; thread (t, row) takes the
// t-th cell of its colour in row (k, j)
template <typename T>
__global__ void cb3_color(T* __restrict__ p, const T* __restrict__ rhs, int K,
                          int J, int I, int par, T factor, T idx2, T idy2,
                          T idz2, T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t W = I + 2;
  const size_t P = (size_t)(J + 2) * W;
  const int k = 1 + blockIdx.z;
  const int j = 1 + blockIdx.y * BY + threadIdx.y;
  const int t = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (j <= J) {
    const int i = (((1 + j + k) & 1) == par ? 1 : 2) + 2 * t;
    if (i <= I) {
      const size_t x = k * P + j * W + i;
      const T c = p[x];
      const T r = resid3(c, rhs[x], p[x - 1], p[x + 1], p[x - W], p[x + W],
                         p[x - P], p[x + P], idx2, idy2, idz2);
      p[x] = c - factor * r;
      rr = r * r;
    }
  }
  if (partial != nullptr) write_partial(rr, sh, partial);
}

// one colour of the masked mode, in place (cb3_color's mapping); on the
// last iteration (r2 != nullptr) every cell of the colour writes its r^2
// at its interior index, 0 on an obstacle cell
template <typename T>
__global__ void cb3m_color(T* __restrict__ p, const T* __restrict__ rhs,
                           const uint8_t* __restrict__ fl, int K, int J,
                           int I, int par, T omega, T idx2, T idy2, T idz2,
                           T* __restrict__ r2) {
  const size_t W = I + 2;
  const size_t P = (size_t)(J + 2) * W;
  const int k = 1 + blockIdx.z;
  const int j = 1 + blockIdx.y * BY + threadIdx.y;
  const int t = blockIdx.x * BX + threadIdx.x;
  if (j > J) return;
  const int i = (((1 + j + k) & 1) == par ? 1 : 2) + 2 * t;
  if (i > I) return;
  const size_t x = k * P + j * W + i;
  T rr = T(0);
  if (fl[x] != 0) {
    const T ee = T(fl[x + 1]), ew = T(fl[x - 1]);
    const T en = T(fl[x + W]), es = T(fl[x - W]);
    const T eb = T(fl[x + P]), ef = T(fl[x - P]);
    const T denom = (ee + ew) * idx2 + (en + es) * idy2 + (eb + ef) * idz2;
    const T fac = (denom > T(0) ? omega / denom : T(0)) * T(fl[x]);
    const T c = p[x];
    const T lap = (ee * (p[x + 1] - c) + ew * (p[x - 1] - c)) * idx2 +
                  (en * (p[x + W] - c) + es * (p[x - W] - c)) * idy2 +
                  (eb * (p[x + P] - c) + ef * (p[x - P] - c)) * idz2;
    const T r = rhs[x] - lap;
    p[x] = c - fac * r;
    rr = r * r;
  }
  if (r2 != nullptr)
    r2[((size_t)(k - 1) * J + (j - 1)) * I + (i - 1)] = rr;
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

// the six Neumann faces; blockIdx.z picks the axis (0: front/back, 1:
// bottom/top, 2: left/right), (a, b) = 1 + the thread's (y, x) position on
// the face's tangential interior
template <typename T>
__global__ void cb3_neumann(T* __restrict__ p, int K, int J, int I) {
  const size_t W = I + 2;
  const size_t P = (size_t)(J + 2) * W;
  const int a = 1 + blockIdx.y * BY + threadIdx.y;
  const int b = 1 + blockIdx.x * BX + threadIdx.x;
  if (blockIdx.z == 0) {  // (j, i)
    if (a <= J && b <= I) {
      const size_t x = a * W + b;
      p[x] = p[P + x];
      p[(K + 1) * P + x] = p[K * P + x];
    }
  } else if (blockIdx.z == 1) {  // (k, i)
    if (a <= K && b <= I) {
      const size_t x = a * P + b;
      p[x] = p[x + W];
      p[x + (J + 1) * W] = p[x + J * W];
    }
  } else {  // (k, j)
    if (a <= K && b <= J) {
      const size_t x = a * P + b * W;
      p[x] = p[x + 1];
      p[x + I + 1] = p[x + I];
    }
  }
}

// octant B = 4*pk + 2*pj + pi at index (s, r, c): on its interior (parity-0
// axes drop index 0, parity-1 axes drop the last) update it in place from
// its three partners (bit flipped) and return r^2, else return 0
template <typename T, int B>
__device__ __forceinline__ T oct_update(T* __restrict__ q,
                                        const T* __restrict__ f, size_t S,
                                        int K2, int J2, int I2, int s, int r,
                                        int c, T factor, T idx2, T idy2,
                                        T idz2) {
  constexpr int pk = B >> 2, pj = (B >> 1) & 1, pi = B & 1;
  if (pk == 0 ? s < 1 : s > K2 - 2) return T(0);
  if (pj == 0 ? r < 1 : r > J2 - 2) return T(0);
  if (pi == 0 ? c < 1 : c > I2 - 2) return T(0);
  const size_t P = (size_t)J2 * I2;
  const size_t x = s * P + (size_t)r * I2 + c;
  const T* qi = q + (B ^ 1) * S;
  const T* qj = q + (B ^ 2) * S;
  const T* qk = q + (B ^ 4) * S;
  // bit 0: minus = partner[idx-1], plus = partner[idx]; bit 1: minus =
  // partner[idx], plus = partner[idx+1]
  const T w = qi[x - (pi == 0 ? 1 : 0)];
  const T e = qi[x + (pi == 1 ? 1 : 0)];
  const T so = qj[x - (pj == 0 ? (size_t)I2 : 0)];
  const T no = qj[x + (pj == 1 ? (size_t)I2 : 0)];
  const T fr = qk[x - (pk == 0 ? P : 0)];
  const T bk = qk[x + (pk == 1 ? P : 0)];
  T* o = q + B * S;
  const T cv = o[x];
  const T res = resid3(cv, f[B * S + x], w, e, so, no, fr, bk, idx2, idy2,
                       idz2);
  o[x] = cv - factor * res;
  return res * res;
}

// one colour in octant space: odd = octants 1, 2, 4, 7 (read 0, 3, 5, 6),
// even = 0, 3, 5, 6; thread (c, r, s) takes index (s, r, c) of all four
template <typename T>
__global__ void oct_color(T* __restrict__ q, const T* __restrict__ f, int K2,
                          int J2, int I2, int odd, T factor, T idx2, T idy2,
                          T idz2, T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t S = (size_t)K2 * J2 * I2;
  const int s = blockIdx.z;
  const int r = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (r < J2 && c < I2) {
    if (odd) {
      rr += oct_update<T, 1>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 2>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 4>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 7>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
    } else {
      rr += oct_update<T, 0>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 3>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 5>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
      rr += oct_update<T, 6>(q, f, S, K2, J2, I2, s, r, c, factor, idx2, idy2, idz2);
    }
  }
  if (partial != nullptr) write_partial(rr, sh, partial);
}

__device__ __forceinline__ bool inside(int bit, int idx, int n) {
  return bit == 0 ? idx >= 1 : idx <= n - 2;
}

// the 24 same-index ghost-plane copies (pampi_tpu_torch/ops/sor_octants.py
// ghost_pairs); blockIdx.z is the face axis (0: k, 1: j, 2: i) and the
// thread's (y, x) its position on the two tangential axes
template <typename T>
__global__ void oct_neumann(T* __restrict__ q, int K2, int J2, int I2) {
  const size_t S = (size_t)K2 * J2 * I2;
  const size_t P = (size_t)J2 * I2;
  const int a = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.x * BX + threadIdx.x;
  const int ax = blockIdx.z;
  const int na = ax == 0 ? J2 : K2;  // extent of the y tangential axis
  const int nb = ax == 2 ? J2 : I2;  // extent of the x tangential axis
  if (a >= na || b >= nb) return;
  const int n = ax == 0 ? K2 : (ax == 1 ? J2 : I2);  // normal extent
  for (int o = 0; o < 8; ++o) {
    const int pk = o >> 2, pj = (o >> 1) & 1, pi = o & 1;
    int pn, pa, pb;  // bits along the normal, y and x axes
    if (ax == 0) { pn = pk; pa = pj; pb = pi; }
    else if (ax == 1) { pn = pj; pa = pk; pb = pi; }
    else { pn = pi; pa = pk; pb = pj; }
    if (!inside(pa, a, na) || !inside(pb, b, nb)) continue;
    const int plane = pn == 0 ? 0 : n - 1;  // lo ghost at 0, hi at the last
    size_t x;
    if (ax == 0) x = plane * P + (size_t)a * I2 + b;
    else if (ax == 1) x = a * P + (size_t)plane * I2 + b;
    else x = a * P + (size_t)b * I2 + plane;
    const int partner = o ^ (ax == 0 ? 4 : (ax == 1 ? 2 : 1));
    q[o * S + x] = q[partner * S + x];
  }
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

dim3 cb3_grid(int K, int J, int I) {
  return dim3(((I + 1) / 2 + BX - 1) / BX, (J + BY - 1) / BY, K);
}

dim3 oct_grid(int K2, int J2, int I2) {
  return dim3((I2 + BX - 1) / BX, (J2 + BY - 1) / BY, K2);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int run_checkerboard3d(int dev, T* p, const T* rhs, int K, int J, int I,
                       int n_inner, double factor, double idx2, double idy2,
                       double idz2, T* partial, T* out, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = cb3_grid(K, J, I);
  const dim3 blk(BX, BY);
  const size_t nb = (size_t)grd.x * grd.y * grd.z;
  const dim3 ngrd(ceil_div(I > J ? I : J, BX), ceil_div(J > K ? J : K, BY), 3);
  for (int t = 0; t < n_inner; ++t) {
    const bool last = t == n_inner - 1;
    cb3_color<T><<<grd, blk, 0, st>>>(p, rhs, K, J, I, 1, T(factor), T(idx2),
                                      T(idy2), T(idz2),
                                      last ? partial : nullptr);
    cb3_color<T><<<grd, blk, 0, st>>>(p, rhs, K, J, I, 0, T(factor), T(idx2),
                                      T(idy2), T(idz2),
                                      last ? partial + nb : nullptr);
    cb3_neumann<T><<<ngrd, blk, 0, st>>>(p, K, J, I);
  }
  sum_partials<T><<<1, FIN, 0, st>>>(partial, (int)(2 * nb), out);
  return (int)cudaGetLastError();
}

template <typename T>
int run_masked3d(int dev, T* p, const T* rhs, const uint8_t* fl, int K,
                 int J, int I, int n_inner, double omega, double idx2,
                 double idy2, double idz2, T* r2, T* rows, T* out,
                 cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = cb3_grid(K, J, I);
  const dim3 blk(BX, BY);
  const dim3 ngrd(ceil_div(I > J ? I : J, BX), ceil_div(J > K ? J : K, BY), 3);
  for (int t = 0; t < n_inner; ++t) {
    T* last = t == n_inner - 1 ? r2 : nullptr;
    cb3m_color<T><<<grd, blk, 0, st>>>(p, rhs, fl, K, J, I, 1, T(omega),
                                       T(idx2), T(idy2), T(idz2), last);
    cb3m_color<T><<<grd, blk, 0, st>>>(p, rhs, fl, K, J, I, 0, T(omega),
                                       T(idx2), T(idy2), T(idz2), last);
    cb3_neumann<T><<<ngrd, blk, 0, st>>>(p, K, J, I);
  }
  row_sums<T><<<ceil_div(K * J, 256), 256, 0, st>>>(r2, K * J, I, rows);
  sum_partials<T><<<1, FIN, 0, st>>>(rows, K * J, out);
  return (int)cudaGetLastError();
}

template <typename T>
int run_octants(int dev, T* q, const T* f, int K2, int J2, int I2,
                int n_inner, double factor, double idx2, double idy2,
                double idz2, T* partial, T* out, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = oct_grid(K2, J2, I2);
  const dim3 blk(BX, BY);
  const size_t nb = (size_t)grd.x * grd.y * grd.z;
  const dim3 ngrd(ceil_div(I2 > J2 ? I2 : J2, BX),
                  ceil_div(J2 > K2 ? J2 : K2, BY), 3);
  for (int t = 0; t < n_inner; ++t) {
    const bool last = t == n_inner - 1;
    oct_color<T><<<grd, blk, 0, st>>>(q, f, K2, J2, I2, 1, T(factor),
                                      T(idx2), T(idy2), T(idz2),
                                      last ? partial : nullptr);
    oct_color<T><<<grd, blk, 0, st>>>(q, f, K2, J2, I2, 0, T(factor),
                                      T(idx2), T(idy2), T(idz2),
                                      last ? partial + nb : nullptr);
    oct_neumann<T><<<ngrd, blk, 0, st>>>(q, K2, J2, I2);
  }
  sum_partials<T><<<1, FIN, 0, st>>>(partial, (int)(2 * nb), out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-sum buffer each entry point needs
int rb_sor3d_checkerboard_partials(int K, int J, int I) {
  const dim3 g = cb3_grid(K, J, I);
  return 2 * (int)(g.x * g.y * g.z);
}

int rb_sor3d_octants_partials(int K2, int J2, int I2) {
  const dim3 g = oct_grid(K2, J2, I2);
  return 2 * (int)(g.x * g.y * g.z);
}

#define SOR3_ENTRY(NAME, RUN, T)                                             \
  int NAME(int dev, void* p, const void* rhs, int a, int b, int c,           \
           int n_inner, double factor, double idx2, double idy2,             \
           double idz2, void* partial, void* out, void* stream) {            \
    return RUN<T>(dev, (T*)p, (const T*)rhs, a, b, c, n_inner, factor, idx2, \
                  idy2, idz2, (T*)partial, (T*)out, (cudaStream_t)stream);   \
  }

#define MASKED3_ENTRY(NAME, T)                                               \
  int NAME(int dev, void* p, const void* rhs, const void* fl, int K, int J,  \
           int I, int n_inner, double omega, double idx2, double idy2,       \
           double idz2, void* r2, void* rows, void* out, void* stream) {     \
    return run_masked3d<T>(dev, (T*)p, (const T*)rhs, (const uint8_t*)fl, K, \
                           J, I, n_inner, omega, idx2, idy2, idz2, (T*)r2,   \
                           (T*)rows, (T*)out, (cudaStream_t)stream);         \
  }

MASKED3_ENTRY(rb_sor3d_masked_f32, float)
MASKED3_ENTRY(rb_sor3d_masked_f64, double)
SOR3_ENTRY(rb_sor3d_checkerboard_f32, run_checkerboard3d, float)
SOR3_ENTRY(rb_sor3d_checkerboard_f64, run_checkerboard3d, double)
SOR3_ENTRY(rb_sor3d_octants_f32, run_octants, float)
SOR3_ENTRY(rb_sor3d_octants_f64, run_octants, double)

}  // extern "C"
