// Per-shard red-black SOR of the distributed octant layout, for Hopper
// (sm_90a): kernel K14.
//
// rb_sor_odist replaces pampi_tpu/ops/sor_odist.py _odist_kernel
//   (make_rb_iters_odist): n red-black iterations, each with the globally
//   gated homogeneous-Neumann wall refresh, on one shard's stacked octant
//   volume (8, kq, jq, iq) in BITS order (octant index 4*pk + 2*pj + pi) of
//   pampi_tpu_torch/parallel/octants_dist.py. It reads the volume and writes
//   the new volume into out (out of place: a CTA reads its neighbours'
//   cells while they write).
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
// are exactly K6's interiors and Neumann faces (csrc/sor3d_rb.cu), so the
// two compute the same volume bit for bit; their residuals sum the same
// values in other orders.
//
// Bound on the H100: memory bandwidth, as K6 (~13 flops per cell update).
// The least any implementation moves per call is the volume and its rhs
// read once and the volume written once: for a 128^3 shard of 256^3 on a
// 2x2x2 mesh at n = 4 (8 x 73^3 cells, float32) that is 37 MB, ~11 us at
// 3.35 TB/s, whatever n is.
//
// Design: the TPU kernel streams the volume along k through VMEM; so does
// this one, through shared memory, one iteration a pass, one launch each
// (a call of n iterations runs n passes, each exact on the whole volume;
// of the depths m = 1, 2, 4 iterations a pass measured on the card, m = 1
// was fastest, PERF.md §6). The volume's (jq, iq) plane is cut into
// owned tiles, and k into slabs where the tiles alone would leave SMs
// idle (ops/sor_odist.odist_tiles); the tiles partition the volume, its
// frozen ring included. A CTA streams the box of its tile (the tile and
// one octant cell a side in k, j and i, clipped to the volume) through a
// ring of 5 planes, each plane the eight slots of p and of rhs: the 4
// planes that the two colour stages read and the next one, whose cells
// arrive by cp.async while the stages run. The odd octants update one plane behind the newest, the
// even ones two: a colour's octants read only the other colour's, whose
// newer state lies on the planes ahead and whose older state no stage
// needs, so the ring is updated in place. Every wall select reads and
// writes one index of two slots (the k faces too: in octant space the
// wall plane's target takes its partner at the same index), so after the
// even stage the 24 selects run on that plane alone, per cell, in the TPU
// kernel's order. In octant space a slot reads the other colour one cell
// away on one side per axis only, so a box cell updates wherever its
// stencil stays in the box (the volume's own ring stays frozen); a cell
// that cannot update goes stale, and the staleness moves one octant cell
// in per iteration: a halo of one (tests/test_torch_sor_tiles3d.py shows
// 1 enough and 0 not). Thread (tx, ty) takes box cells (ty + 16 kk, tx) of
// every slot. The residual: each thread adds the owned r^2 of its updates
// in the order it makes them, a halving tree over the threads gives the
// tile's partial, and the last CTA to take an integer ticket (which it
// resets) adds the partials in tile order (thread t takes partials t, t +
// 512, ..., then the tree); ops/sor_odist.odist_residual repeats that
// order, so kernel and plain version agree bitwise, residual included. No
// float atomics. What bounds it: a CTA's plane steps, one CTA an SM, over
// boxes of 1.45x the volume (a 128^3 shard of 256^3, tiles and slabs
// together) and the ring's 2 steps of fill; neither the copies' issue nor
// the memory's latency sets a step's cost (copying 16-byte blocks, and
// fetching two planes ahead, made the pass slower: PERF.md §6).
// Each pass moves the volume, its rhs and the new volume once (about 12
// bytes an octant cell at float32).
//
// Arithmetic keeps the reference association term for term:
//   r = rhs - ((e - 2c + w)*idx2 + (n - 2c + s)*idy2 + (b - 2c + f)*idz2)
//   p = c - factor*r
// built with --fmad=false so no multiply-add is contracted.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TX = 32;  // lanes: the box's columns
constexpr int TY = 16;  // rows of threads
constexpr int NT = TX * TY;
constexpr int OP = 32;  // row pitch of a slot plane in shared memory
constexpr int HT = 1;   // the tiles' halo (ops/sor_odist.HALO14)
constexpr int RS = 4;   // ring planes that the two colour stages read
constexpr int NS = 5;   // and the next one, in flight (RING14)

struct Geom {
  int q[3];     // stored extents (kq, jq, iq)
  int d[3];     // stored deep-halo depth per axis
  int l2[3];    // owned octant planes per parity: kl/2, jl/2, il/2
  int max2[3];  // global octant extents: kmax/2, jmax/2, imax/2
  int off[3];   // the shard's global octant offsets
  int t[3];     // owned tile extents (tk, tj, ti)
  int rows;     // rows of a slot plane in the ring (the largest box's j)
};

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

// the fixed halving tree over the block's threads; sh holds NT values
template <typename T>
__device__ T block_tree(T v, T* sh) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  return sh[0];
}

// octant B's update at box cell (a, b) of ring plane slots sq (its plane),
// sm (below) and sn (above): the partners (bit flipped) at the same index
// or one cell back (bit 0) or ahead (bit 1) along each axis
template <typename T, int B>
__device__ __forceinline__ T od_cell(T* __restrict__ sp, int PS, int sq,
                                     int sm, int sn, int x, T rc, T factor,
                                     T idx2, T idy2, T idz2) {
  constexpr int pk = B >> 2, pj = (B >> 1) & 1, pi = B & 1;
  const T* qi = sp + (sq * 8 + (B ^ 1)) * PS;
  const T* qj = sp + (sq * 8 + (B ^ 2)) * PS;
  const T* kf = sp + ((pk == 0 ? sm : sq) * 8 + (B ^ 4)) * PS;
  const T* kb = sp + ((pk == 0 ? sq : sn) * 8 + (B ^ 4)) * PS;
  T* o = sp + (sq * 8 + B) * PS;
  const T w = qi[x - (pi == 0 ? 1 : 0)];
  const T e = qi[x + (pi == 1 ? 1 : 0)];
  const T so = qj[x - (pj == 0 ? OP : 0)];
  const T no = qj[x + (pj == 1 ? OP : 0)];
  const T cv = o[x];
  const T res = resid3(cv, rc, w, e, so, no, kf[x], kb[x], idx2, idy2, idz2);
  o[x] = cv - factor * res;
  return res;
}

// the 24 same-index wall selects at box cell x of the plane in ring slot
// sq, whose global octant position is go, in the TPU kernel's order: axis
// k, j, i; lo then hi; target octants in BITS order, each taking its
// partner across the axis where the target's bit on the axis is the
// face's side, its position is on the wall plane and, on the two other
// axes, in the interior of the target's parity
template <typename T>
__device__ __forceinline__ void od_walls(T* __restrict__ sp, int PS, int sq,
                                         int x, const int* go,
                                         const Geom& g) {
  T v[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) v[o] = sp[(sq * 8 + o) * PS + x];
  int dirty = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b1 = a == 0 ? 1 : 0;
    const int b2 = a == 2 ? 1 : 2;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (go[a] != (hi ? g.max2[a] : 0)) continue;
#pragma unroll
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
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (dirty & (1 << o)) sp[(sq * 8 + o) * PS + x] = v[o];
}

// One iteration on the box of one owned tile, read from q, the tile's
// cells written into out. The ring holds NS planes of the eight slots of
// p and of rhs: the RS that the two colour stages read and the next one,
// arriving by cp.async while the stages run. Thread (tx, ty) takes
// box cells (ty + TY kk, tx), kk < KK, of every slot. On the last pass
// (partial != nullptr) the owned r^2 of the last iteration goes into the
// residual.
template <typename T, int KK, int MINB>
__global__ void __launch_bounds__(NT, MINB)
od_pass(const T* __restrict__ q, const T* __restrict__ f,
        T* __restrict__ out, Geom g, T factor, T idx2, T idy2, T idz2,
        T* __restrict__ partial, unsigned* __restrict__ ticket,
        T* __restrict__ res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PS = g.rows * OP;  // a slot of a ring plane
  T* sp = reinterpret_cast<T*>(smem);
  T* sf = sp + (size_t)NS * 8 * PS;  // rhs
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const size_t S = (size_t)g.q[0] * g.q[1] * g.q[2];
  const size_t SK = (size_t)g.q[1] * g.q[2], SI = g.q[2];
  // per axis (k, j, i): the box's origin and extent, the tile in box
  // coordinates, and the box coordinate of global octant 0
  const int bid[3] = {(int)blockIdx.z, (int)blockIdx.y, (int)blockIdx.x};
  int o0[3], ext[3], t0[3], t1[3], base[3];
  // per axis and parity bit: the box cells that update (the stencil in
  // the box, the volume's frozen ring on deep-halo axes, the global
  // interior of the parity) and the tile's owned cells
  int ulo[3][2], uhi[3][2], wlo[3][2], whi[3][2];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int lo = bid[ax] * g.t[ax], hi = min(g.q[ax], lo + g.t[ax]);
    o0[ax] = max(0, lo - HT);
    ext[ax] = min(g.q[ax], hi + HT) - o0[ax];
    t0[ax] = lo - o0[ax];
    t1[ax] = hi - o0[ax];
    base[ax] = g.d[ax] - g.off[ax] - o0[ax];
#pragma unroll
    for (int bit = 0; bit < 2; ++bit) {
      int l = bit == 0 ? 1 : 0, h = bit == 1 ? ext[ax] - 2 : ext[ax] - 1;
      if (g.d[ax] > 0) {
        l = max(l, 1 - o0[ax]);
        h = min(h, g.q[ax] - 2 - o0[ax]);
      }
      ulo[ax][bit] = max(l, base[ax] + (bit == 0 ? 1 : 0));
      uhi[ax][bit] = min(h, base[ax] + g.max2[ax] - (bit == 1 ? 1 : 0));
      const int os = g.d[ax] + (bit == 0 ? 1 : 0) - o0[ax];
      wlo[ax][bit] = max(t0[ax], os);
      whi[ax][bit] = min(t1[ax], os + g.l2[ax]);
    }
  }
  const int KB = ext[0], R = ext[1], W = ext[2];
  const bool col = tx < W;
  // box plane z's eight slots of p and of rhs into ring slot `slot`, by
  // cp.async
  auto fetch = [&](int z, int slot) {
    const size_t row0 = (size_t)(o0[0] + z) * SK + (size_t)o0[1] * SI +
                        o0[2] + tx;
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int a = ty + TY * kk;
        if (!col || a >= R) continue;
        const size_t x = o * S + row0 + (size_t)a * SI;
        const int y = (slot * 8 + o) * PS + a * OP + tx;
        __pipeline_memcpy_async(sp + y, q + x, sizeof(T));
        __pipeline_memcpy_async(sf + y, f + x, sizeof(T));
      }
  };
  T acc = T(0);
  const bool last_pass = partial != nullptr;
  fetch(0, 0);
  __pipeline_commit();
  // the last stage runs in step KB + 1 (on plane KB - 1); the planes that
  // have not left the ring by then go out after the loop
  const int ZE = KB + 2;
  for (int z = 0, zs = 0; z < ZE; ++z, zs = zs == NS - 1 ? 0 : zs + 1) {
    // zs = z % NS: plane z's slot. Once its cells have landed and every
    // thread is past step z - 1, the plane z - RS leaves the ring for out
    // (its last read came in step z - 1) from the slot that plane z + 1
    // then takes
    __pipeline_wait_prior(0);
    __syncthreads();
    const int so = zs == NS - 1 ? 0 : zs + 1;
    {
      const int qo = z - RS;
      const bool oq = qo >= t0[0] && qo < t1[0] && tx >= t0[2] && tx < t1[2];
      const size_t row0 = (size_t)(o0[0] + qo) * SK + (size_t)o0[1] * SI +
                          o0[2] + tx;
#pragma unroll
      for (int o = 0; o < 8; ++o)
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const int a = ty + TY * kk;
          if (oq && a >= t0[1] && a < t1[1])
            out[o * S + row0 + (size_t)a * SI] =
                sp[(so * 8 + o) * PS + a * OP + tx];
        }
    }
    if (z + 1 < KB) fetch(z + 1, so);
    __pipeline_commit();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // stage s: the odd octants 1, 2, 4, 7 (s = 0) or the even ones 0,
      // 3, 5, 6 (s = 1) on plane p = z - 1 - s
      const int p = z - 1 - s;
      int sq = zs - 1 - s;  // ring slots of planes p, p - 1, p + 1
      if (sq < 0) sq += NS;
      const int sm = sq == 0 ? NS - 1 : sq - 1;
      const int sn = sq == NS - 1 ? 0 : sq + 1;
      if (p >= 0 && p < KB) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // odd: 1, 2, 4, 7; even: each one's bit 0 flipped
          const int B = (u == 3 ? 7 : 1 << u) ^ s;
          const int pk = B >> 2, pj = (B >> 1) & 1, pi = B & 1;
          if (p < ulo[0][pk] || p > uhi[0][pk]) continue;
          const bool own_k = p >= wlo[0][pk] && p < whi[0][pk];
          const bool upd_i = tx >= ulo[2][pi] && tx <= uhi[2][pi];
          const bool own_i = own_k && tx >= wlo[2][pi] && tx < whi[2][pi];
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) {
            const int a = ty + TY * kk;
            if (!upd_i || a < ulo[1][pj] || a > uhi[1][pj]) continue;
            const int x = a * OP + tx;
            const T rc = sf[(sq * 8 + B) * PS + x];
            T r;
            switch (B) {
              case 0: r = od_cell<T, 0>(sp, PS, sq, sm, sn, x, rc, factor, idx2, idy2, idz2); break;
              case 1: r = od_cell<T, 1>(sp, PS, sq, sm, sn, x, rc, factor, idx2, idy2, idz2); break;
              case 2: r = od_cell<T, 2>(sp, PS, sq, sm, sn, x, rc, factor, idx2, idy2, idz2); break;
              case 3: r = od_cell<T, 3>(sp, PS, sq, sm, sn, x, rc, factor, idx2, idy2, idz2); break;
              case 4: r = od_cell<T, 4>(sp, PS, sq, sm, sn, x, rc, factor, idx2, idy2, idz2); break;
              case 5: r = od_cell<T, 5>(sp, PS, sq, sm, sn, x, rc, factor, idx2, idy2, idz2); break;
              case 6: r = od_cell<T, 6>(sp, PS, sq, sm, sn, x, rc, factor, idx2, idy2, idz2); break;
              default: r = od_cell<T, 7>(sp, PS, sq, sm, sn, x, rc, factor, idx2, idy2, idz2); break;
            }
            if (last_pass && own_i && a >= wlo[1][pj] && a < whi[1][pj])
              acc += r * r;
          }
        }
      }
      __syncthreads();
      if (s == 1 && p >= 0 && p < KB) {
        // the wall selects that follow plane p's even stage: on a k wall
        // plane every cell of the plane, else the cells of the j wall rows
        // and of the i wall columns (a cell on a wall row is the row
        // thread's). No barrier before the next stage: it updates no cell
        // whose stencil reads a select's target.
        const int gk = p - base[0];
        if (gk == 0 || gk == g.max2[0]) {
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) {
            const int a = ty + TY * kk;
            if (!col || a >= R) continue;
            const int go[3] = {gk, a - base[1], tx - base[2]};
            od_walls<T>(sp, PS, sq, a * OP + tx, go, g);
          }
        } else {
          const int alo = base[1], ahi = base[1] + g.max2[1];
          const int blo = base[2], bhi = base[2] + g.max2[2];
          for (int u = tid; u < 2 * (W + R); u += NT) {
            int a, b;
            if (u < 2 * W) {
              a = u < W ? alo : ahi;
              b = u < W ? u : u - W;
            } else {
              const int v2 = u - 2 * W;
              b = v2 < R ? blo : bhi;
              a = v2 < R ? v2 : v2 - R;
              if (a == alo || a == ahi) continue;
            }
            if (a < 0 || a >= R || b < 0 || b >= W) continue;
            const int go[3] = {gk, a - base[1], b - base[2]};
            od_walls<T>(sp, PS, sq, a * OP + b, go, g);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int qo = max(0, ZE - RS); qo < KB; ++qo) {
    if (qo < t0[0] || qo >= t1[0] || tx < t0[2] || tx >= t1[2]) continue;
    const size_t row0 = (size_t)(o0[0] + qo) * SK + (size_t)o0[1] * SI +
                        o0[2] + tx;
    const int so = qo % NS;
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int a = ty + TY * kk;
        if (a >= t0[1] && a < t1[1])
          out[o * S + row0 + (size_t)a * SI] =
              sp[(so * 8 + o) * PS + a * OP + tx];
      }
  }
  if (!last_pass) return;
  __syncthreads();
  // the residual: this tile's partial (the threads' sums by the halving
  // tree), then the last CTA adds the partials in tile order
  __shared__ bool last_cta;
  const T s = block_tree(acc, sp);
  const int nb = gridDim.x * gridDim.y * gridDim.z;
  if (tid == 0) {
    partial[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        s;
    __threadfence();
    last_cta = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (last_cta) {
    T a = T(0);
    for (int k = tid; k < nb; k += NT) a += __ldcg(partial + k);
    const T total = block_tree(a, sp);
    if (tid == 0) {
      res[0] = total;
      *ticket = 0u;
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int KK, int MINB>
cudaError_t launch_pass(const T* q, const T* f, T* out, const Geom& g,
                        int smem, double factor, double idx2, double idy2,
                        double idz2, T* partial, unsigned* ticket, T* res,
                        cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      od_pass<T, KK, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grd(ceil_div(g.q[2], g.t[2]), ceil_div(g.q[1], g.t[1]),
                 ceil_div(g.q[0], g.t[0]));
  od_pass<T, KK, MINB><<<grd, dim3(TX, TY), smem, st>>>(
      q, f, out, g, T(factor), T(idx2), T(idy2), T(idz2), partial, ticket,
      res);
  return cudaGetLastError();
}

// one pass, one CTA an SM; KK rows of cells a thread: 2 at float32 (boxes
// of up to 32 rows), 1 at float64 (16 rows); boxes of up to 32 columns
template <typename T, int KK>
int run_odist(int dev, const T* q, const T* f, T* out, const int* geo,
              double factor, double idx2, double idy2, double idz2,
              T* partial, unsigned* ticket, T* res, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  Geom g;
  for (int a = 0; a < 3; ++a) {
    g.q[a] = geo[a];
    g.d[a] = geo[3 + a];
    g.l2[a] = geo[6 + a];
    g.max2[a] = geo[9 + a];
    g.off[a] = geo[12 + a];
    g.t[a] = geo[15 + a];
  }
  g.rows = geo[18];
  const int smem = geo[19];
  if (g.rows > TY * KK || min(g.q[2], g.t[2] + 2 * HT) > TX ||
      min(g.q[1], g.t[1] + 2 * HT) > g.rows)
    return (int)cudaErrorInvalidValue;
  e = launch_pass<T, KK, 1>(q, f, out, g, smem, factor, idx2, idy2, idz2,
                            partial, ticket, res, st);
  return (int)e;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// geo = [kq, jq, iq, d_k, d_j, d_i, kl/2, jl/2, il/2, kmax/2, jmax/2,
//        imax/2, qoff_k, qoff_j, qoff_i, tk, tj, ti, rows, smem bytes]
//        (ops/sor_odist.launch_plan); partial == nullptr skips the
// residual (a pass before the last), else it holds one value per tile and
// ticket an unsigned 0 that the kernel leaves at 0
#define ODIST_ENTRY(NAME, T, KK)                                              \
  int NAME(int dev, const void* q, const void* f, void* out, const int* geo, \
           double factor, double idx2, double idy2, double idz2,             \
           void* partial, void* ticket, void* res, void* stream) {           \
    return run_odist<T, KK>(dev, (const T*)q, (const T*)f, (T*)out, geo,     \
                            factor, idx2, idy2, idz2, (T*)partial,           \
                            (unsigned*)ticket, (T*)res,                      \
                            (cudaStream_t)stream);                           \
  }

ODIST_ENTRY(rb_sor_odist_f32, float, 2)
ODIST_ENTRY(rb_sor_odist_f64, double, 1)

}  // extern "C"
