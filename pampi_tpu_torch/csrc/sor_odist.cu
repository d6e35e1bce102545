// Per-shard red-black SOR of the distributed octant layout, for Hopper
// (sm_90a): kernel K14.
//
// rb_sor_odist replaces pampi_tpu/ops/sor_odist.py _odist_kernel
//   (make_rb_iters_odist): n red-black iterations, each with the globally
//   gated homogeneous-Neumann wall refresh, on one shard's stacked octant
//   volume (8, kq, jq, iq) in BITS order (octant index 4*pk + 2*pj + pi) of
//   pampi_tpu_torch/parallel/octants_dist.py, in place.
//
// Stored cell (s, r, c) of every slot is global octant cell
//   (go_k, go_j, go_i)
//     = (s - d_k + qoff_k, r - d_j + qoff_j, c - d_i + qoff_i)
// where (qoff_k, qoff_j, qoff_i) are the shard's global octant offsets,
// passed as arguments (the TPU kernel takes them by scalar prefetch), and
// d_ax is the stored deep-halo depth: n on exchanged mesh axes, 0 on axes
// of mesh size 1. What each cell does follows from that position alone:
//   - update when it lies in the global interior of its octant's parity
//     and, on the d_ax > 0 axes, inside the frozen outermost stored ring;
//   - the 24 Neumann face selects (the target octant takes its partner
//     across the face at the same index), gated by global position and
//     clipped tangentially to the global interior, in the TPU kernel's
//     order;
//   - count r^2 of the LAST iteration when it lies in the shard's owned
//     region (ghost cells are the neighbours' cells, recomputed here).
// parallel/octants_dist.o_masks holds the same formulas; keep the two in
// lockstep. With d = (0, 0, 0) and zero offsets (a (1, 1, 1) mesh) these
// are exactly K6's interiors and Neumann faces (csrc/sor3d_rb.cu), and the
// launch grid and the partial sums are K6's, so the two agree bitwise.
//
// What bounds it on the H100: memory bandwidth, as K6 (~13 flops per cell
// update). The least any implementation moves per call is the volume and
// its rhs read once and the volume written once: for a 128^3 shard of
// 256^3 on a 2x2x2 mesh at n = 4 (8 x 73^3 cells, float32) that is 37 MB,
// ~11 us at 3.35 TB/s, whatever n is.
//
// Design: K6's and K13's (csrc/sor3d_rb.cu, csrc/sor_qdist.cu), not a copy
// of the TPU kernel, whose double-buffered k windows are a Mosaic device.
// CUDA blocks run in no order, so every ordering point is a launch: per
// iteration one launch per colour (a thread updates the same index of its
// colour's four octants, which read only the other colour's four) and one
// launch for the wall refresh. Every wall select reads and writes the same
// index of two slots, so the refresh is per cell: a thread takes one cell
// of the union of the wall planes (the first face in the select order
// that holds it) and applies all 24 selects to that index in order, in
// registers, with no hazard between threads. On the last iteration each
// colour block writes its partial sum of r^2 (a fixed-order shared-memory
// tree), and a one-block launch sums the partials in a fixed order: no
// float atomics, so the residual and every iteration count are
// reproducible. Temporal blocking is later work.
//
// Arithmetic keeps the reference association term for term:
//   r = rhs - ((e - 2c + w)*idx2 + (n - 2c + s)*idy2 + (b - 2c + f)*idz2)
//   p = c - factor*r
// built with --fmad=false so no multiply-add is contracted.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int FIN = 1024;

struct Geom {
  int q[3];     // stored extents (kq, jq, iq)
  int d[3];     // stored deep-halo depth per axis
  int l2[3];    // owned octant planes per parity: kl/2, jl/2, il/2
  int max2[3];  // global octant extents: kmax/2, jmax/2, imax/2
  int off[3];   // the shard's global octant offsets
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
__device__ __forceinline__ void write_partial(T rr, T* sh, T* partial) {
  const T s = block_sum(rr, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
            blockIdx.x] = s;
}

template <typename T>
__device__ __forceinline__ T resid3(T c, T rhs, T w, T e, T s, T n, T f, T b,
                                    T idx2, T idy2, T idz2) {
  return rhs - ((e - T(2) * c + w) * idx2 + (n - T(2) * c + s) * idy2 +
                (b - T(2) * c + f) * idz2);
}

// global interior of a parity along one axis: bit 0 holds grid indices
// 2*go (1..max), bit 1 holds 2*go + 1
__device__ __forceinline__ bool inside(int bit, int go, int max2) {
  return bit == 0 ? (go >= 1 && go <= max2) : (go >= 0 && go <= max2 - 1);
}

// updated cells along one axis: the global interior of the parity, and on
// deep-halo axes not the frozen outermost stored ring
__device__ __forceinline__ bool upd_axis(const Geom& g, int ax, int bit,
                                         int x) {
  if (g.d[ax] > 0 && (x < 1 || x > g.q[ax] - 2)) return false;
  return inside(bit, x - g.d[ax] + g.off[ax], g.max2[ax]);
}

// owned stored indices along one axis: [d+1, d+l2] bit 0, [d, d+l2-1] bit 1
__device__ __forceinline__ bool own_axis(const Geom& g, int ax, int bit,
                                         int x) {
  const int s = g.d[ax] + (bit == 0 ? 1 : 0);
  return x >= s && x < s + g.l2[ax];
}

// octant B at stored index (s, r, c): where it updates, update it in
// place from its three partners (bit flipped) and return its owned r^2
template <typename T, int B>
__device__ __forceinline__ T od_update(T* __restrict__ q,
                                       const T* __restrict__ f, size_t S,
                                       const Geom& g, int s, int r, int c,
                                       T factor, T idx2, T idy2, T idz2) {
  constexpr int pk = B >> 2, pj = (B >> 1) & 1, pi = B & 1;
  if (!upd_axis(g, 0, pk, s) || !upd_axis(g, 1, pj, r) ||
      !upd_axis(g, 2, pi, c))
    return T(0);
  const size_t I = g.q[2];
  const size_t P = (size_t)g.q[1] * I;
  const size_t x = s * P + (size_t)r * I + c;
  const T* qi = q + (B ^ 1) * S;
  const T* qj = q + (B ^ 2) * S;
  const T* qk = q + (B ^ 4) * S;
  // bit 0: minus = partner[idx-1], plus = partner[idx]; bit 1: minus =
  // partner[idx], plus = partner[idx+1]
  const T w = qi[x - (pi == 0 ? 1 : 0)];
  const T e = qi[x + (pi == 1 ? 1 : 0)];
  const T so = qj[x - (pj == 0 ? I : 0)];
  const T no = qj[x + (pj == 1 ? I : 0)];
  const T fr = qk[x - (pk == 0 ? P : 0)];
  const T bk = qk[x + (pk == 1 ? P : 0)];
  T* o = q + B * S;
  const T cv = o[x];
  const T res = resid3(cv, f[B * S + x], w, e, so, no, fr, bk, idx2, idy2,
                       idz2);
  o[x] = cv - factor * res;
  if (own_axis(g, 0, pk, s) && own_axis(g, 1, pj, r) && own_axis(g, 2, pi, c))
    return res * res;
  return T(0);
}

// one colour: odd = octants 1, 2, 4, 7 (read 0, 3, 5, 6), even = 0, 3, 5,
// 6; thread (c, r, s) takes stored index (s, r, c) of all four
template <typename T>
__global__ void od_color(T* __restrict__ q, const T* __restrict__ f, Geom g,
                         int odd, T factor, T idx2, T idy2, T idz2,
                         T* __restrict__ partial) {
  __shared__ T sh[NT];
  const size_t S = (size_t)g.q[0] * g.q[1] * g.q[2];
  const int s = blockIdx.z;
  const int r = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.x * BX + threadIdx.x;
  T rr = T(0);
  if (r < g.q[1] && c < g.q[2]) {
    if (odd) {
      rr += od_update<T, 1>(q, f, S, g, s, r, c, factor, idx2, idy2, idz2);
      rr += od_update<T, 2>(q, f, S, g, s, r, c, factor, idx2, idy2, idz2);
      rr += od_update<T, 4>(q, f, S, g, s, r, c, factor, idx2, idy2, idz2);
      rr += od_update<T, 7>(q, f, S, g, s, r, c, factor, idx2, idy2, idz2);
    } else {
      rr += od_update<T, 0>(q, f, S, g, s, r, c, factor, idx2, idy2, idz2);
      rr += od_update<T, 3>(q, f, S, g, s, r, c, factor, idx2, idy2, idz2);
      rr += od_update<T, 5>(q, f, S, g, s, r, c, factor, idx2, idy2, idz2);
      rr += od_update<T, 6>(q, f, S, g, s, r, c, factor, idx2, idy2, idz2);
    }
  }
  if (partial != nullptr) write_partial(rr, sh, partial);
}

// the stored index of the wall plane of face `face` (axis face/2, lo or
// hi), or -1 when the shard's volume does not hold it
__device__ __forceinline__ int wall_plane(const Geom& g, int face) {
  const int ax = face >> 1;
  const int go = (face & 1) ? g.max2[ax] : 0;
  const int x = go + g.d[ax] - g.off[ax];
  return (x >= 0 && x < g.q[ax]) ? x : -1;
}

// the Neumann wall refresh: blockIdx.z is the face (k lo, k hi, j lo, j hi,
// i lo, i hi), the thread's (y, x) a cell on that face's plane in the
// stored volume; a cell that an earlier face's plane also holds is left to
// that face's thread. The thread applies the 24 selects to its index in
// the TPU kernel's order: axis k, j, i; lo then hi; target octants in BITS
// order, each taking its partner across the axis where the target's bit
// on the axis is the face's side and its global position is on the plane
// and, on the two other axes, in the interior of the target's parity.
template <typename T>
__global__ void od_walls(T* __restrict__ q, Geom g) {
  const int face = blockIdx.z;
  const int ax = face >> 1;
  const int a1 = ax == 0 ? 1 : 0;  // the two tangential axes, in order
  const int a2 = ax == 2 ? 1 : 2;
  const int ta = blockIdx.y * BY + threadIdx.y;
  const int tb = blockIdx.x * BX + threadIdx.x;
  if (ta >= g.q[a1] || tb >= g.q[a2]) return;
  const int plane = wall_plane(g, face);
  if (plane < 0) return;
  int x[3];
  x[ax] = plane;
  x[a1] = ta;
  x[a2] = tb;
  for (int f = 0; f < face; ++f) {  // held by an earlier face: skip
    const int p = wall_plane(g, f);
    if (p >= 0 && x[f >> 1] == p) return;
  }
  int go[3];
  for (int a = 0; a < 3; ++a) go[a] = x[a] - g.d[a] + g.off[a];
  const size_t S = (size_t)g.q[0] * g.q[1] * g.q[2];
  const size_t k = ((size_t)x[0] * g.q[1] + x[1]) * g.q[2] + x[2];
  T v[8];
  for (int o = 0; o < 8; ++o) v[o] = q[o * S + k];
  int dirty = 0;
  for (int a = 0; a < 3; ++a) {
    const int b1 = a == 0 ? 1 : 0;
    const int b2 = a == 2 ? 1 : 2;
    for (int hi = 0; hi < 2; ++hi) {
      if (go[a] != (hi ? g.max2[a] : 0)) continue;
      for (int o = 0; o < 8; ++o) {
        const int bits[3] = {o >> 2, (o >> 1) & 1, o & 1};
        if (bits[a] != hi) continue;
        if (!inside(bits[b1], go[b1], g.max2[b1]) ||
            !inside(bits[b2], go[b2], g.max2[b2]))
          continue;
        v[o] = v[o ^ (4 >> a)];
        dirty |= 1 << o;
      }
    }
  }
  for (int o = 0; o < 8; ++o)
    if (dirty & (1 << o)) q[o * S + k] = v[o];
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

dim3 od_grid(int kq, int jq, int iq) {
  return dim3((iq + BX - 1) / BX, (jq + BY - 1) / BY, kq);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int run_odist(int dev, T* q, const T* f, const Geom& g, int n, double factor,
              double idx2, double idy2, double idz2, T* partial, T* out,
              cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grd = od_grid(g.q[0], g.q[1], g.q[2]);
  const dim3 blk(BX, BY);
  const size_t nb = (size_t)grd.x * grd.y * grd.z;
  // the wall launch: (x, y) cover the largest tangential pair of any face
  int tx = 0, ty = 0;
  for (int ax = 0; ax < 3; ++ax) {
    const int a1 = ax == 0 ? 1 : 0, a2 = ax == 2 ? 1 : 2;
    if (g.q[a2] > tx) tx = g.q[a2];
    if (g.q[a1] > ty) ty = g.q[a1];
  }
  const dim3 wgrd(ceil_div(tx, BX), ceil_div(ty, BY), 6);
  for (int t = 0; t < n; ++t) {
    const bool last = t == n - 1;
    od_color<T><<<grd, blk, 0, st>>>(q, f, g, 1, T(factor), T(idx2),
                                     T(idy2), T(idz2),
                                     last ? partial : nullptr);
    od_color<T><<<grd, blk, 0, st>>>(q, f, g, 0, T(factor), T(idx2),
                                     T(idy2), T(idz2),
                                     last ? partial + nb : nullptr);
    od_walls<T><<<wgrd, blk, 0, st>>>(q, g);
  }
  sum_partials<T><<<1, FIN, 0, st>>>(partial, (int)(2 * nb), out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-sum buffer rb_sor_odist_* needs
int rb_sor_odist_partials(int kq, int jq, int iq) {
  const dim3 g = od_grid(kq, jq, iq);
  return 2 * (int)(g.x * g.y * g.z);
}

// geo = [kq, jq, iq, d_k, d_j, d_i, kl/2, jl/2, il/2, kmax/2, jmax/2,
//        imax/2, qoff_k, qoff_j, qoff_i]
#define ODIST_ENTRY(NAME, T)                                                  \
  int NAME(int dev, void* q, const void* f, const int* geo, int n,            \
           double factor, double idx2, double idy2, double idz2,              \
           void* partial, void* out, void* stream) {                          \
    Geom g;                                                                   \
    for (int a = 0; a < 3; ++a) {                                             \
      g.q[a] = geo[a];                                                        \
      g.d[a] = geo[3 + a];                                                    \
      g.l2[a] = geo[6 + a];                                                   \
      g.max2[a] = geo[9 + a];                                                 \
      g.off[a] = geo[12 + a];                                                 \
    }                                                                         \
    return run_odist<T>(dev, (T*)q, (const T*)f, g, n, factor, idx2, idy2,    \
                        idz2, (T*)partial, (T*)out, (cudaStream_t)stream);    \
  }

ODIST_ENTRY(rb_sor_odist_f32, float)
ODIST_ENTRY(rb_sor_odist_f64, double)

}  // extern "C"
