// Per-shard red-black SOR of the distributed quarter layout, for Hopper
// (sm_90a): kernel K13.
//
// rb_sor_qdist replaces pampi_tpu/ops/sor_qdist.py _qdist_kernel
//   (make_rb_iters_qdist): n red-black iterations, each with the globally
//   gated homogeneous-Neumann wall refresh, on one shard's stacked quarter
//   plane (4, jq, iq) = [R0, R1, B0, B1] of
//   pampi_tpu_torch/parallel/quarters_dist.py, in place.
//
// Stored cell (r, c) of every slot is global quarter cell
//   (gqr, gqc) = (r - n + qoff_j, c - n + qoff_i),
// where (qoff_j, qoff_i) are the shard's global quarter offsets, passed as
// arguments (the TPU kernel takes them by scalar prefetch). What each cell
// does follows from that position alone:
//   - update when it lies in the plane's interior (the outermost stored
//     ring stays frozen) and in the global interior of its slot's parity
//     (`inside` below);
//   - the eight wall selects, gated by global position and clipped
//     tangentially to the global interior, in the TPU kernel's order;
//   - count r^2 of the LAST iteration when it lies in the shard's owned
//     region (ghost cells are the neighbours' cells, recomputed here).
// parallel/quarters_dist.q_masks holds the same formulas; keep the two in
// lockstep.
//
// What bounds it on the H100: memory bandwidth, as K1 (~10 flops per cell
// update). The least any implementation moves per call is the plane and
// its rhs read once and the plane written once; a 2048^2 shard at n = 4
// (4 x 1033^2 cells, float32) is 51 MB, ~15 us at 3.35 TB/s.
//
// Design: K1's (csrc/sor_rb.cu), not a copy of the TPU kernel, whose
// double-buffered DMA windows are a Mosaic device. CUDA blocks run in no
// order, so every ordering point is a launch: per iteration one launch
// per colour (red updates R0 and R1 from B0 and B1, black B0 and B1 from
// the new R0 and R1; within a colour no cell reads another that the launch
// writes) and one launch for the wall refresh. Every wall select reads and
// writes the same index (r, c) of the four slots, so a thread that owns a
// cell applies all eight selects to it in order, in registers: the
// kernel's sequence, with no hazard between threads. That launch covers
// only the two stored rows of gqr = 0 and jmax/2 and the two columns of
// gqc = 0 and imax/2, each cell once. On the last iteration each colour
// block writes its partial sum of r^2 (a fixed-order shared-memory tree),
// and a one-block launch sums the partials in a fixed order: no float
// atomics, so the residual and every iteration count are reproducible.
// Temporal blocking (n iterations per pass through memory) is later work.
//
// Arithmetic keeps the reference association term for term:
//   r = rhs - ((e - 2c + w)*idx2 + (n - 2c + s)*idy2);  p = c - factor*r
// built with --fmad=false so no multiply-add is contracted.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int FIN = 1024;
constexpr int WALL_THREADS = 256;

struct Geom {
  int jq, iq;        // stored plane
  int jl2, il2;      // owned quarter rows / columns per parity
  int n;             // CA depth: iterations per call
  int jmax2, imax2;  // global quarter extents
  int qoff_j, qoff_i;
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

// owned stored rows (or columns) of a parity: [n+1, n+half] even,
// [n, n+half-1] odd
__device__ __forceinline__ bool owned(int parity, int x, int n, int half) {
  const int s = n + (parity == 0 ? 1 : 0);
  return x >= s && x < s + half;
}

// red half-sweep: R0 (even, even) and R1 (odd, odd) read only B0 and B1
template <typename T>
__global__ void qd_red(T* __restrict__ q, const T* __restrict__ f, Geom g,
                       T factor, T idx2, T idy2, T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t S = (size_t)g.jq * g.iq;
  T* R0 = q;
  T* R1 = q + S;
  const T* B0 = q + 2 * S;
  const T* B1 = q + 3 * S;
  const int r = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (r >= 1 && r <= g.jq - 2 && c >= 1 && c <= g.iq - 2) {
    const size_t k = (size_t)r * g.iq + c;
    const int gqr = r - g.n + g.qoff_j;
    const int gqc = c - g.n + g.qoff_i;
    if (inside(0, gqr, g.jmax2) && inside(0, gqc, g.imax2)) {
      // R0: W=B0[c-1] E=B0[c] S=B1[r-1] N=B1[r]
      const T x = R0[k];
      const T res = resid(x, f[k], B0[k - 1], B0[k], B1[k - g.iq], B1[k],
                          idx2, idy2);
      R0[k] = x - factor * res;
      if (owned(0, r, g.n, g.jl2) && owned(0, c, g.n, g.il2)) rr += res * res;
    }
    if (inside(1, gqr, g.jmax2) && inside(1, gqc, g.imax2)) {
      // R1: W=B1[c] E=B1[c+1] S=B0[r] N=B0[r+1]
      const T x = R1[k];
      const T res = resid(x, f[S + k], B1[k], B1[k + 1], B0[k], B0[k + g.iq],
                          idx2, idy2);
      R1[k] = x - factor * res;
      if (owned(1, r, g.n, g.jl2) && owned(1, c, g.n, g.il2)) rr += res * res;
    }
  }
  if (partial != nullptr) {
    const T s = block_sum(rr, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// black half-sweep: B0 (even, odd) and B1 (odd, even) read the new R0, R1
template <typename T>
__global__ void qd_black(T* __restrict__ q, const T* __restrict__ f, Geom g,
                         T factor, T idx2, T idy2, T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t S = (size_t)g.jq * g.iq;
  const T* R0 = q;
  const T* R1 = q + S;
  T* B0 = q + 2 * S;
  T* B1 = q + 3 * S;
  const int r = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (r >= 1 && r <= g.jq - 2 && c >= 1 && c <= g.iq - 2) {
    const size_t k = (size_t)r * g.iq + c;
    const int gqr = r - g.n + g.qoff_j;
    const int gqc = c - g.n + g.qoff_i;
    if (inside(0, gqr, g.jmax2) && inside(1, gqc, g.imax2)) {
      // B0: W=R0[c] E=R0[c+1] S=R1[r-1] N=R1[r]
      const T x = B0[k];
      const T res = resid(x, f[2 * S + k], R0[k], R0[k + 1], R1[k - g.iq],
                          R1[k], idx2, idy2);
      B0[k] = x - factor * res;
      if (owned(0, r, g.n, g.jl2) && owned(1, c, g.n, g.il2)) rr += res * res;
    }
    if (inside(1, gqr, g.jmax2) && inside(0, gqc, g.imax2)) {
      // B1: W=R1[c-1] E=R1[c] S=R0[r] N=R0[r+1]
      const T x = B1[k];
      const T res = resid(x, f[3 * S + k], R1[k - 1], R1[k], R0[k],
                          R0[k + g.iq], idx2, idy2);
      B1[k] = x - factor * res;
      if (owned(1, r, g.n, g.jl2) && owned(0, c, g.n, g.il2)) rr += res * res;
    }
  }
  if (partial != nullptr) {
    const T s = block_sum(rr, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// the Neumann wall refresh: thread t takes one cell of the stored rows of
// gqr = 0 and jmax/2 (t < 2*iq) or of the stored columns of gqc = 0 and
// imax/2 (the rest; cells on those rows are left to the row threads), and
// applies the eight same-index selects to it in the TPU kernel's order
template <typename T>
__global__ void qd_walls(T* __restrict__ q, Geom g) {
  const size_t S = (size_t)g.jq * g.iq;
  T* R0 = q;
  T* R1 = q + S;
  T* B0 = q + 2 * S;
  T* B1 = q + 3 * S;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int rlo = g.n - g.qoff_j;  // stored row of gqr == 0
  const int rhi = rlo + g.jmax2;   // of gqr == jmax/2
  const int clo = g.n - g.qoff_i;
  const int chi = clo + g.imax2;
  int r, c;
  if (t < 2 * g.iq) {
    r = t < g.iq ? rlo : rhi;
    c = t % g.iq;
  } else if (t < 2 * (g.iq + g.jq)) {
    const int u = t - 2 * g.iq;
    c = u < g.jq ? clo : chi;
    r = u % g.jq;
    if (r == rlo || r == rhi) return;
  } else {
    return;
  }
  if (r < 0 || r >= g.jq || c < 0 || c >= g.iq) return;
  const int gqr = r - g.n + g.qoff_j;
  const int gqc = c - g.n + g.qoff_i;
  const bool ri0 = inside(0, gqr, g.jmax2), ri1 = inside(1, gqr, g.jmax2);
  const bool ci0 = inside(0, gqc, g.imax2), ci1 = inside(1, gqc, g.imax2);
  const size_t k = (size_t)r * g.iq + c;
  T r0 = R0[k], r1 = R1[k], b0 = B0[k], b1 = B1[k];
  bool w0 = false, w1 = false, w2 = false, w3 = false;
  // p[0,i] = p[1,i] (even i, odd i); p[J+1,i] = p[J,i] (odd i, even i)
  if (gqr == 0 && ci0) { r0 = b1; w0 = true; }
  if (gqr == 0 && ci1) { b0 = r1; w2 = true; }
  if (gqr == g.jmax2 && ci1) { r1 = b0; w1 = true; }
  if (gqr == g.jmax2 && ci0) { b1 = r0; w3 = true; }
  // p[j,0] = p[j,1] (even j, odd j); p[j,I+1] = p[j,I] (even j, odd j)
  if (gqc == 0 && ri0) { r0 = b0; w0 = true; }
  if (gqc == 0 && ri1) { b1 = r1; w3 = true; }
  if (gqc == g.imax2 && ri0) { b0 = r0; w2 = true; }
  if (gqc == g.imax2 && ri1) { r1 = b1; w1 = true; }
  if (w0) R0[k] = r0;
  if (w1) R1[k] = r1;
  if (w2) B0[k] = b0;
  if (w3) B1[k] = b1;
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

dim3 q_grid(int jq, int iq) {
  return dim3((iq + BX - 1) / BX, (jq + BY - 1) / BY);
}

template <typename T>
int run_qdist(int dev, T* q, const T* f, Geom g, double factor, double idx2,
              double idy2, T* partial, T* out, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = q_grid(g.jq, g.iq);
  const dim3 blk(BX, BY);
  const int nb = grd.x * grd.y;
  const int nw = (2 * (g.jq + g.iq) + WALL_THREADS - 1) / WALL_THREADS;
  for (int t = 0; t < g.n; ++t) {
    const bool last = t == g.n - 1;
    qd_red<T><<<grd, blk, 0, st>>>(q, f, g, T(factor), T(idx2), T(idy2),
                                   last ? partial : nullptr);
    qd_black<T><<<grd, blk, 0, st>>>(q, f, g, T(factor), T(idx2), T(idy2),
                                     last ? partial + nb : nullptr);
    qd_walls<T><<<nw, WALL_THREADS, 0, st>>>(q, g);
  }
  sum_partials<T><<<1, FIN, 0, st>>>(partial, 2 * nb, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-sum buffer rb_sor_qdist_* needs
int rb_sor_qdist_partials(int jq, int iq) {
  const dim3 g = q_grid(jq, iq);
  return 2 * (int)(g.x * g.y);
}

#define QDIST_ENTRY(NAME, T)                                                  \
  int NAME(int dev, void* q, const void* f, int jq, int iq, int jl2, int il2, \
           int n, int jmax2, int imax2, int qoff_j, int qoff_i,               \
           double factor, double idx2, double idy2, void* partial, void* out, \
           void* stream) {                                                    \
    const Geom g{jq, iq, jl2, il2, n, jmax2, imax2, qoff_j, qoff_i};          \
    return run_qdist<T>(dev, (T*)q, (const T*)f, g, factor, idx2, idy2,       \
                        (T*)partial, (T*)out, (cudaStream_t)stream);          \
  }

QDIST_ENTRY(rb_sor_qdist_f32, float)
QDIST_ENTRY(rb_sor_qdist_f64, double)

}  // extern "C"
