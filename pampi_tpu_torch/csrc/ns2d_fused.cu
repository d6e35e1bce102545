// NS-2D step phases for Hopper (sm_90a): the port's PRE and POST kernels,
// on one device and, below, in the distributed mode (a shard's deep and
// halo-1 blocks of a 2-D mesh, divisible or ragged: make_fused_pre_2d(...,
// jl, il, ext_pad) and make_fused_post_2d(..., jl, il, ragged) of the JAX
// package), each with or without obstacle flag fields.
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
//
// The flag mode (obstacle flag fields, pampi_tpu/ops/obstacle.py; the TPU
// kernels' `masked` mode, fed the global flags on one device and, on a
// mesh, the shard's deep flag block for PRE and its halo-1 block for
// POST, as the JAX package's fused_flag_blocks): both kernels also take a
// uint8 fluid flag block of their input block's shape (0 on obstacle and
// dead cells). A face mask is read from the flags: the u face of a cell is
// fluid-fluid where the cell and its +i neighbour are fluid, forced to 1
// on the last global ghost column i = I+1 (make_masks' fix of its wrapping
// roll), and the v face likewise along j.
//   PRE, after the walls and the special BC (obstacle.
//   apply_obstacle_velocity_bc, then mask_fg):
//   4a. zero the normal components on faces touching an obstacle, into a
//       snapshot us, vs (scratch the wrapper allocates);
//   4b. write u, v from the snapshot: u = us + both_u*(uf_n*(-us_n) +
//       (1 - uf_n)*uf_s*(-us_s)), where both_u marks a face buried in
//       obstacles and uf_n, uf_s are the u faces one row north and south
//       (v: the v faces one column east and west), in the JAX package's
//       arithmetic. The JAX function is functional: every mirror reads
//       the array as it is after the zeroing. Done in place, a thread's
//       write could land on a cell another thread reads, and even a read
//       that is multiplied by 0 changes the sign of a zero; the snapshot
//       keeps 4b's reads apart from its writes. Neighbour reads wrap on
//       the block, as the plain version's rolls do; on one device they are
//       the JAX package's full-array rolls, and on a deep block they reach
//       only the outermost layer, which no output reads;
//   then F, G carry U, V on every non-fluid face (after the wall fixups:
//   mask_fg is pointwise on faces formed from the flags, so it rides the
//   F/G launch).
//   POST: the projection is multiplied by the face mask (adapt_uv_
//   obstacle); on a shard the flags read 0 beyond the block's high edge,
//   as p does there.
// The flags add 1 byte a cell to each kernel's traffic, and PRE's snapshot
// 4 field-sizes (two written, two read).
//
// The class mode (the fleet's shape-class lanes: make_fused_pre_2d(...,
// dynamic=True) and make_fused_post_2d(..., ragged=True, dynamic=True) of
// the JAX package, run by pampi_tpu/fleet/shapeclass.make_fused_class_chunk)
// steps a batch of N lanes at once, each a (jc+2, ic+2) class block whose
// live corner is its own (J+2, I+2) grid, the lane on blockIdx.z (x for the
// walls). Each lane reads its extents (J, I), its cell sizes (dx, dy, in
// T), its dt and its `active` flag from device arrays: the distributed
// kernels' gating by global index with offsets 0 and the lane's extents.
// Every grid constant is formed in T from the lane's dx and dy, as the JAX
// kernels form them from their SMEM scalars (idx = 1/dx, idx*0.25,
// gamma*idx*0.25, idx*idx; the canal inflow's y = (j - 0.5)*dy), not from
// host doubles. An inactive lane is left as it is (PRE writes its F, G,
// rhs as 0). PRE is three launches (the walls by a block per lane in the
// reference's order, F/G, rhs), POST two: the projection on the lane's
// interior, the live-mask multiply that keeps the dead cells 0 (K4's ragged
// mode) and per-block partial maxima of |u|, |v| over the live cells, then
// a block per lane that reduces them (max is exact in any order).
//
// The grid-band mode of the distributed PRE (the overlapped step's two
// halves, make_fused_pre_2d(grid_bands=) of the JAX package;
// parallel/overlap.py): the BCs run on the whole deep block as in the full
// call, F/G and rhs only on bands of the halo-1 block's rows, a CTA row
// mapped to its band through a table of at most four bands passed by
// value. rhs reads G one row down, so the F/G launch also covers the row
// below each band. Every value stored inside a band is the full call's,
// bit for bit (the same code on the same cells); the rows outside are not
// written. What bounds it: the bytes of the rows it covers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NOSLIP = 1, SLIP = 2, OUTFLOW = 3;
constexpr int DCAVITY = 1, CANAL = 2;  // canal_obstacle: CANAL
constexpr int BX = 32, BY = 8, NT = BX * BY;
constexpr int BC_THREADS = 1024;
constexpr int FIN = 1024;

template <typename T>
struct Coef {
  T idx4, gidx4, idy4, gidy4, idx2, idy2, inv_re, gx, gy;
};

// the walls of a (J+2, I+2) grid with rows of W cells in the reference's
// order (left, right, bottom, top), then the lid or the inflow, by the nt
// threads of one block
template <typename T>
__device__ void walls(T* __restrict__ u, T* __restrict__ v, int J, int I,
                      size_t W, int bl, int br, int bb, int bt, int problem,
                      T dy, T yl, T yl2) {
#define U(j, i) u[(size_t)(j) * W + (i)]
#define V(j, i) v[(size_t)(j) * W + (i)]
  const int t0 = threadIdx.x, nt = blockDim.x;
  for (int j = 1 + t0; j <= J; j += nt) {  // left: U on the wall
    if (bl == NOSLIP) { U(j, 0) = T(0); V(j, 0) = -V(j, 1); }
    else if (bl == SLIP) { U(j, 0) = T(0); V(j, 0) = V(j, 1); }
    else if (bl == OUTFLOW) { U(j, 0) = U(j, 1); V(j, 0) = V(j, 1); }
  }
  __syncthreads();
  for (int j = 1 + t0; j <= J; j += nt) {  // right: U(imax) on it
    if (br == NOSLIP) { U(j, I) = T(0); V(j, I + 1) = -V(j, I); }
    else if (br == SLIP) { U(j, I) = T(0); V(j, I + 1) = V(j, I); }
    else if (br == OUTFLOW) { U(j, I) = U(j, I - 1); V(j, I + 1) = V(j, I); }
  }
  __syncthreads();
  for (int i = 1 + t0; i <= I; i += nt) {  // bottom: V on the wall
    if (bb == NOSLIP) { V(0, i) = T(0); U(0, i) = -U(1, i); }
    else if (bb == SLIP) { V(0, i) = T(0); U(0, i) = U(1, i); }
    else if (bb == OUTFLOW) { U(0, i) = U(1, i); V(0, i) = V(1, i); }
  }
  __syncthreads();
  for (int i = 1 + t0; i <= I; i += nt) {  // top: V(jmax) on it
    if (bt == NOSLIP) { V(J, i) = T(0); U(J + 1, i) = -U(J, i); }
    else if (bt == SLIP) { V(J, i) = T(0); U(J + 1, i) = U(J, i); }
    else if (bt == OUTFLOW) { U(J + 1, i) = U(J, i); V(J, i) = V(J - 1, i); }
  }
  __syncthreads();
  if (problem == DCAVITY) {
    // lid, skipping the last interior i (the reference loop-bound quirk)
    for (int i = 1 + t0; i <= I - 1; i += nt)
      U(J + 1, i) = T(2) - U(J, i);
  } else if (problem == CANAL) {
    for (int j = 1 + t0; j <= J; j += nt) {
      const T y = (T(j) - T(0.5)) * dy;
      U(j, 0) = y * (yl - y) * T(4) / yl2;
    }
  }
#undef U
#undef V
}

template <typename T>
__global__ void bc_strips(T* __restrict__ u, T* __restrict__ v, int J, int I,
                          int bl, int br, int bb, int bt, int problem, T dy,
                          T yl, T yl2) {
  walls(u, v, J, I, I + 2, bl, br, bb, bt, problem, dy, yl, yl2);
}

// -- the flag mode --------------------------------------------------------

// a block of the flag mode: R x W cells, cell (a, b) at global extended
// index (a + jb, b + ib); global interior extents (Gj, Gi)
struct Blk {
  int R, W, jb, ib, Gj, Gi;
};

__device__ __forceinline__ int wrap(int a, int L) {
  return a < 0 ? a + L : (a >= L ? a - L : a);
}

// the u (v) face mask at (a, b), every index wrapping on the block: 1 on
// the last global ghost column (row), else the cell's flag times its +i
// (+j) neighbour's
template <typename T>
__device__ __forceinline__ T face_u(const uint8_t* fl, const Blk& k, int a,
                                    int b) {
  a = wrap(a, k.R);
  b = wrap(b, k.W);
  if (b + k.ib == k.Gi + 1) return T(1);
  const size_t r = (size_t)a * k.W;
  return T(fl[r + b]) * T(fl[r + wrap(b + 1, k.W)]);
}

template <typename T>
__device__ __forceinline__ T face_v(const uint8_t* fl, const Blk& k, int a,
                                    int b) {
  a = wrap(a, k.R);
  b = wrap(b, k.W);
  if (a + k.jb == k.Gj + 1) return T(1);
  return T(fl[(size_t)a * k.W + b]) *
         T(fl[(size_t)wrap(a + 1, k.R) * k.W + b]);
}

// launch 4a: the zeroed normal components, into the snapshot
template <typename T>
__global__ void obs_zero(const T* __restrict__ u, const T* __restrict__ v,
                         const uint8_t* __restrict__ fl, T* __restrict__ us,
                         T* __restrict__ vs, Blk k) {
  const int b = blockIdx.x * BX + threadIdx.x;
  const int a = blockIdx.y * BY + threadIdx.y;
  if (a >= k.R || b >= k.W) return;
  const size_t x = (size_t)a * k.W + b;
  us[x] = u[x] * face_u<T>(fl, k, a, b);
  vs[x] = v[x] * face_v<T>(fl, k, a, b);
}

// launch 4b: the mirror of the buried faces, read from the snapshot,
// written to u and v
template <typename T>
__global__ void obs_mirror(T* __restrict__ u, T* __restrict__ v,
                           const uint8_t* __restrict__ fl,
                           const T* __restrict__ us, const T* __restrict__ vs,
                           Blk k) {
  const int b = blockIdx.x * BX + threadIdx.x;
  const int a = blockIdx.y * BY + threadIdx.y;
  if (a >= k.R || b >= k.W) return;
  const T one = T(1);
  const size_t W = k.W;
  const size_t x = (size_t)a * W + b;
  const int an = wrap(a + 1, k.R), as = wrap(a - 1, k.R);
  const int be = wrap(b + 1, k.W), bw = wrap(b - 1, k.W);
  const T fc = T(fl[x]);
  const T both_u = (one - fc) * (one - T(fl[(size_t)a * W + be]));
  const T uf_n = face_u<T>(fl, k, a + 1, b), uf_s = face_u<T>(fl, k, a - 1, b);
  u[x] = us[x] + both_u * (uf_n * (-us[(size_t)an * W + b]) +
                           (one - uf_n) * uf_s * (-us[(size_t)as * W + b]));
  const T both_v = (one - fc) * (one - T(fl[(size_t)an * W + b]));
  const T vf_e = face_v<T>(fl, k, a, b + 1), vf_w = face_v<T>(fl, k, a, b - 1);
  v[x] = vs[x] + both_v * (vf_e * (-vs[(size_t)a * W + be]) +
                           (one - vf_e) * vf_w * (-vs[(size_t)a * W + bw]));
}

// F, G carry U, V on every non-fluid face (obstacle.mask_fg) at block
// cell (a, b), from the post-BC u, v there
template <typename T>
__device__ __forceinline__ void mask_fg(const uint8_t* fl, const Blk& k,
                                        int a, int b, T uu, T vv, T& fv,
                                        T& gv) {
  const T one = T(1);
  const T uf = face_u<T>(fl, k, a, b), vf = face_v<T>(fl, k, a, b);
  fv = uf * fv + (one - uf) * uu;
  gv = vf * gv + (one - vf) * vv;
}

// the F/G predictor at cell k of u and v (row stride W): central plus
// gamma-blended donor-cell convection, the viscous Laplacian, body force
template <typename T>
__device__ __forceinline__ void fg_predict(const T* __restrict__ u,
                                           const T* __restrict__ v, size_t k,
                                           size_t W, T dt, const Coef<T>& c,
                                           T& fv, T& gv) {
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

template <typename T>
__global__ void fg_cells(const T* __restrict__ u, const T* __restrict__ v,
                         const T* __restrict__ dtp, T* __restrict__ f,
                         T* __restrict__ g, int J, int I, Coef<T> c,
                         const uint8_t* __restrict__ fl) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i > I + 1 || j > J + 1) return;
  const size_t W = I + 2;
  const size_t k = (size_t)j * W + i;
  const bool rows = j >= 1 && j <= J;
  const bool cols = i >= 1 && i <= I;
  T fv = T(0), gv = T(0);
  if (rows && cols) fg_predict(u, v, k, W, *dtp, c, fv, gv);
  // wall fixups: F carries U on vertical walls, G carries V on horizontal
  if (rows && (i == 0 || i == I)) fv = u[k];
  if (cols && (j == 0 || j == J)) gv = v[k];
  if (fl != nullptr)
    mask_fg(fl, Blk{J + 2, I + 2, 0, 0, J, I}, j, i, u[k], v[k], fv, gv);
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
                            int J, int I, T dx, T dy,
                            const uint8_t* __restrict__ fl,
                            T* __restrict__ partial) {
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
      if (fl != nullptr) {  // the projection on fluid-fluid faces only
        const T fc = T(fl[k]);
        uu = uu * (fc * T(fl[k + 1]));
        vv = vv * (fc * T(fl[k + W]));
      }
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

// block b reduces the b-th run of 2*nb partials (nb of |u|, nb of |v|):
// out[b] = max|u|, out[gridDim.x + b] = max|v| (one block: out[0], out[1];
// the class mode: a block per lane)
template <typename T>
__global__ void max_partials(const T* __restrict__ partial, int nb,
                             T* __restrict__ out) {
  __shared__ T shu[FIN];
  __shared__ T shv[FIN];
  partial += (size_t)blockIdx.x * 2 * nb;
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
    out[blockIdx.x] = shu[0];
    out[gridDim.x + blockIdx.x] = shv[0];
  }
}

// ---------------------------------------------------------------------
// The distributed mode (a shard's blocks on a 2-D mesh, divisible or
// ragged). Geometry: the shard's halo-1 block is (Lj+2, Li+2), its deep
// block (Lj+2+2e, Li+2+2e) with e = ext_pad; deep cell (a, b) is global
// extended cell (a - e + joff, b - e + ioff), halo-1 cell (a, b) global
// (a + joff, b + ioff). Every write is gated by the global index against
// the global extents (Gj, Gi), so the walls, the lid and the inflow land
// wherever they cross the block, and the dead cells of a ragged block stay
// outside the global interior.
// ---------------------------------------------------------------------

struct Dist {
  int Lj, Li, e, joff, ioff, Gj, Gi;
};

// The grid-band mode (the overlapped step's interior and boundary halves,
// make_fused_pre_2d(grid_bands=) of the JAX package): F/G and rhs cover
// only bands of the halo-1 block's rows. Band b is rows [lo[b], hi[b]),
// its CTA rows (blockIdx.y) start at cta[b]; n == 0 is the full sweep.
// A table of at most MAXB bands travels by value.
constexpr int MAXB = 4;
struct Bands {
  int n;
  int lo[MAXB], hi[MAXB], cta[MAXB + 1];
};

// the row of thread row t of CTA row y (rows of `step` rows a CTA row),
// or -1 past its band's end; the full sweep's row without bands. The
// table is read at constant indices only (an unrolled select), so it stays
// in the kernel's parameter space: a runtime index would copy it to local
// memory in every thread.
__device__ __forceinline__ int band_row(const Bands& b, int y, int t,
                                        int step) {
  if (b.n == 0) return y * step + t;
  int lo = b.lo[0], hi = b.hi[0], c0 = 0;
#pragma unroll
  for (int q = 1; q < MAXB; ++q)
    if (q < b.n && y >= b.cta[q]) {
      lo = b.lo[q];
      hi = b.hi[q];
      c0 = b.cta[q];
    }
  const int r = lo + (y - c0) * step + t;
  return r < hi ? r : -1;
}

// the table of rows [lo, hi) per band from ranges = [n, lo0, hi0, ...],
// each band's start moved `widen` rows down (clipped at 0); CTA rows of
// `step` rows
Bands make_bands(const int* ranges, int widen, int step) {
  Bands b{};
  b.n = ranges == nullptr ? 0 : ranges[0];
  b.cta[0] = 0;
  for (int k = 0; k < b.n; ++k) {
    const int lo = ranges[1 + 2 * k] - widen;
    b.lo[k] = lo < 0 ? 0 : lo;
    b.hi[k] = ranges[2 + 2 * k];
    b.cta[k + 1] = b.cta[k] + (b.hi[k] - b.lo[k] + step - 1) / step;
  }
  return b;
}

// the deep block of a Dist as a flag-mode block
__device__ __host__ __forceinline__ Blk deep_blk(const Dist& d) {
  return Blk{d.Lj + 2 + 2 * d.e, d.Li + 2 + 2 * d.e, d.joff - d.e,
             d.ioff - d.e, d.Gj, d.Gi};
}

// the i-walls of one deep row per thread, in the reference's order (left,
// then right), then the canal inflow on the left wall. Every read is in
// the thread's own row; an inward read past the block reads 0, as the
// TPU kernel's window does (it lands only on the outermost deep layer,
// which the strip to the halo-1 block drops).
template <typename T>
__global__ void bc_rows_dist(T* __restrict__ u, T* __restrict__ v, Dist d,
                             int bl, int br, int problem, double dy, T yl,
                             T yl2) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = d.Lj + 2 + 2 * d.e, W = d.Li + 2 + 2 * d.e;
  if (a >= R) return;
  const int gj = a - d.e + d.joff;
  if (gj < 1 || gj > d.Gj) return;
  T* ur = u + (size_t)a * W;
  T* vr = v + (size_t)a * W;
  auto U = [&](int b) { return b >= 0 && b < W ? ur[b] : T(0); };
  auto V = [&](int b) { return b >= 0 && b < W ? vr[b] : T(0); };
  const int blo = d.e - d.ioff;  // gi == 0
  const int bw = d.Gi + d.e - d.ioff;  // gi == Gi: U on the right wall
  const int bg = bw + 1;  // gi == Gi + 1: the ghost column
  if (blo >= 0 && blo < W) {
    if (bl == NOSLIP) { ur[blo] = T(0); vr[blo] = -V(blo + 1); }
    else if (bl == SLIP) { ur[blo] = T(0); vr[blo] = V(blo + 1); }
    else if (bl == OUTFLOW) { ur[blo] = U(blo + 1); vr[blo] = V(blo + 1); }
  }
  if (br == NOSLIP || br == SLIP) {
    if (bw >= 0 && bw < W) ur[bw] = T(0);
    if (bg >= 0 && bg < W) vr[bg] = br == NOSLIP ? -V(bg - 1) : V(bg - 1);
  } else if (br == OUTFLOW) {
    if (bw >= 0 && bw < W) ur[bw] = U(bw - 1);
    if (bg >= 0 && bg < W) vr[bg] = V(bg - 1);
  }
  if (problem == CANAL && blo >= 0 && blo < W) {
    // y from the global row index in double, then the field's dtype
    const T y = T((double(gj) - 0.5) * dy);
    ur[blo] = y * (yl - y) * T(4) / yl2;
  }
}

// the j-walls of one deep column per thread (bottom, then top), then the
// dcavity lid (which skips the last interior i); every read is in the
// thread's own column
template <typename T>
__global__ void bc_cols_dist(T* __restrict__ u, T* __restrict__ v, Dist d,
                             int bb, int bt, int problem) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = d.Lj + 2 + 2 * d.e, W = d.Li + 2 + 2 * d.e;
  if (b >= W) return;
  const int gi = b - d.e + d.ioff;
  if (gi < 1 || gi > d.Gi) return;
  // reads past the block are 0 (as in bc_rows_dist); writes stay inside
  auto U = [&](int a) { return a >= 0 && a < R ? u[(size_t)a * W + b] : T(0); };
  auto V = [&](int a) { return a >= 0 && a < R ? v[(size_t)a * W + b] : T(0); };
  auto Uw = [&](int a) -> T& { return u[(size_t)a * W + b]; };
  auto Vw = [&](int a) -> T& { return v[(size_t)a * W + b]; };
  const int alo = d.e - d.joff;  // gj == 0
  const int aw = d.Gj + d.e - d.joff;  // gj == Gj: V on the top wall
  const int ag = aw + 1;  // gj == Gj + 1: the ghost row
  const bool lo = alo >= 0 && alo < R, w = aw >= 0 && aw < R,
             gh = ag >= 0 && ag < R;
  if (lo) {
    if (bb == NOSLIP) { Vw(alo) = T(0); Uw(alo) = -U(alo + 1); }
    else if (bb == SLIP) { Vw(alo) = T(0); Uw(alo) = U(alo + 1); }
    else if (bb == OUTFLOW) { Uw(alo) = U(alo + 1); Vw(alo) = V(alo + 1); }
  }
  if (bt == NOSLIP || bt == SLIP) {
    if (w) Vw(aw) = T(0);
    if (gh) Uw(ag) = bt == NOSLIP ? -U(ag - 1) : U(ag - 1);
  } else if (bt == OUTFLOW) {
    if (gh) Uw(ag) = U(ag - 1);
    if (w) Vw(aw) = V(aw - 1);
  }
  if (problem == DCAVITY && gh && gi <= d.Gi - 1) Uw(ag) = T(2) - U(ag - 1);
}

// F and G on the halo-1 block from the deep u and v: the predictor on the
// global interior, the wall fixups, zero elsewhere
template <typename T>
__global__ void fg_cells_dist(const T* __restrict__ u,
                              const T* __restrict__ v,
                              const T* __restrict__ dtp, T* __restrict__ f,
                              T* __restrict__ g, Dist d, Coef<T> c,
                              const uint8_t* __restrict__ fl, Bands bd) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = band_row(bd, blockIdx.y, threadIdx.y, BY);
  if (i > d.Li + 1 || j < 0 || j > d.Lj + 1) return;
  const size_t Wd = d.Li + 2 + 2 * d.e;
  const size_t kd = (size_t)(j + d.e) * Wd + (i + d.e);
  const size_t k = (size_t)j * (d.Li + 2) + i;
  const int gj = j + d.joff, gi = i + d.ioff;
  const bool rows = gj >= 1 && gj <= d.Gj;
  const bool cols = gi >= 1 && gi <= d.Gi;
  T fv = T(0), gv = T(0);
  if (rows && cols) fg_predict(u, v, kd, Wd, *dtp, c, fv, gv);
  if (rows && (gi == 0 || gi == d.Gi)) fv = u[kd];
  if (cols && (gj == 0 || gj == d.Gj)) gv = v[kd];
  if (fl != nullptr)
    mask_fg(fl, deep_blk(d), j + d.e, i + d.e, u[kd], v[kd], fv, gv);
  f[k] = fv;
  g[k] = gv;
}

// rhs on the halo-1 block: the owned cells of the global interior
template <typename T>
__global__ void rhs_cells_dist(const T* __restrict__ f,
                               const T* __restrict__ g,
                               const T* __restrict__ dtp, T* __restrict__ rhs,
                               Dist d, T dx, T dy, Bands bd) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = band_row(bd, blockIdx.y, threadIdx.y, BY);
  if (i > d.Li + 1 || j < 0 || j > d.Lj + 1) return;
  const size_t W = d.Li + 2;
  const size_t k = (size_t)j * W + i;
  const int gj = j + d.joff, gi = i + d.ioff;
  T r = T(0);
  if (j >= 1 && j <= d.Lj && i >= 1 && i <= d.Li && gj <= d.Gj &&
      gi <= d.Gi) {
    const T inv_dt = T(1) / *dtp;
    r = inv_dt * ((f[k] - f[k - 1]) / dx + (g[k] - g[k - W]) / dy);
  }
  rhs[k] = r;
}

// the projection on the halo-1 block's cells of the global interior (p
// read as 0 past the block's high edge), the live-mask multiply on a
// ragged mesh, and per-block maxima of |u|, |v| over the cells of the
// global extended array
template <typename T>
__global__ void adapt_cells_dist(T* __restrict__ u, T* __restrict__ v,
                                 const T* __restrict__ f,
                                 const T* __restrict__ g,
                                 const T* __restrict__ p,
                                 const T* __restrict__ dtp, Dist d, T dx,
                                 T dy, int ragged,
                                 const uint8_t* __restrict__ fl,
                                 T* __restrict__ partial) {
  __shared__ T shu[NT];
  __shared__ T shv[NT];
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int tid = threadIdx.y * BX + threadIdx.x;
  T au = T(0), av = T(0);
  if (i <= d.Li + 1 && j <= d.Lj + 1) {
    const size_t W = d.Li + 2;
    const size_t k = (size_t)j * W + i;
    const int gj = j + d.joff, gi = i + d.ioff;
    T uu = u[k], vv = v[k];
    if (gj >= 1 && gj <= d.Gj && gi >= 1 && gi <= d.Gi) {
      const T dt = *dtp;
      const T fx = dt / dx;
      const T fy = dt / dy;
      const T pe = i <= d.Li ? p[k + 1] : T(0);
      const T pn = j <= d.Lj ? p[k + W] : T(0);
      uu = f[k] - (pe - p[k]) * fx;
      vv = g[k] - (pn - p[k]) * fy;
      if (fl != nullptr) {  // faces read flag 0 past the high edge
        const T fc = T(fl[k]);
        uu = uu * (fc * (i <= d.Li ? T(fl[k + 1]) : T(0)));
        vv = vv * (fc * (j <= d.Lj ? T(fl[k + W]) : T(0)));
      }
    }
    if (ragged) {
      const T live = (gj <= d.Gj + 1 && gi <= d.Gi + 1) ? T(1) : T(0);
      uu = uu * live;
      vv = vv * live;
    }
    u[k] = uu;
    v[k] = vv;
    if (gj >= 0 && gj <= d.Gj + 1 && gi >= 0 && gi <= d.Gi + 1) {
      au = fabs(uu);
      av = fabs(vv);
    }
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
    const int bi = blockIdx.y * gridDim.x + blockIdx.x;
    partial[bi] = shu[0];
    partial[nb + bi] = shv[0];
  }
}

dim3 cell_grid(int J, int I) {
  return dim3((I + 2 + BX - 1) / BX, (J + 2 + BY - 1) / BY);
}

template <typename T>
void run_obstacle_bc(T* u, T* v, const uint8_t* fl, T* us, T* vs,
                     const Blk& k, cudaStream_t st) {
  const dim3 grd((k.W + BX - 1) / BX, (k.R + BY - 1) / BY);
  obs_zero<T><<<grd, dim3(BX, BY), 0, st>>>(u, v, fl, us, vs, k);
  obs_mirror<T><<<grd, dim3(BX, BY), 0, st>>>(u, v, fl, us, vs, k);
}

template <typename T>
int run_pre(int dev, T* u, T* v, const T* dt, T* f, T* g, T* rhs, int J,
            int I, const int* bc, int problem, const double* c,
            const uint8_t* fl, T* us, T* vs, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  // c = [idx*0.25, gamma*idx*0.25, idy*0.25, gamma*idy*0.25, idx*idx,
  //      idy*idy, 1/re, gx, gy, dx, dy, ylength, ylength*ylength]
  bc_strips<T><<<1, BC_THREADS, 0, st>>>(u, v, J, I, bc[0], bc[1], bc[2],
                                         bc[3], problem, T(c[10]), T(c[11]),
                                         T(c[12]));
  if (fl != nullptr)
    run_obstacle_bc(u, v, fl, us, vs, Blk{J + 2, I + 2, 0, 0, J, I}, st);
  const Coef<T> k{T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4]),
                  T(c[5]), T(c[6]), T(c[7]), T(c[8])};
  const dim3 grd = cell_grid(J, I);
  const dim3 blk(BX, BY);
  fg_cells<T><<<grd, blk, 0, st>>>(u, v, dt, f, g, J, I, k, fl);
  rhs_cells<T><<<grd, blk, 0, st>>>(f, g, dt, rhs, J, I, T(c[9]), T(c[10]));
  return (int)cudaGetLastError();
}

template <typename T>
int run_post(int dev, T* u, T* v, const T* f, const T* g, const T* p,
             const T* dt, int J, int I, double dx, double dy,
             const uint8_t* fl, T* partial, T* out, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grd = cell_grid(J, I);
  adapt_cells<T><<<grd, dim3(BX, BY), 0, st>>>(u, v, f, g, p, dt, J, I, T(dx),
                                               T(dy), fl, partial);
  max_partials<T><<<1, FIN, 0, st>>>(partial, (int)(grd.x * grd.y), out);
  return (int)cudaGetLastError();
}

template <typename T>
int run_pre_dist(int dev, T* u, T* v, const T* dt, T* f, T* g, T* rhs,
                 const int* geo, const int* bc, int problem, const double* c,
                 const uint8_t* fl, T* us, T* vs, void* stream,
                 const int* bands = nullptr) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const Dist d{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6]};
  const int R = d.Lj + 2 + 2 * d.e, W = d.Li + 2 + 2 * d.e;
  bc_rows_dist<T><<<(R + BC_THREADS - 1) / BC_THREADS, BC_THREADS, 0, st>>>(
      u, v, d, bc[0], bc[1], problem, c[10], T(c[11]), T(c[12]));
  bc_cols_dist<T><<<(W + BC_THREADS - 1) / BC_THREADS, BC_THREADS, 0, st>>>(
      u, v, d, bc[2], bc[3], problem);
  if (fl != nullptr) run_obstacle_bc(u, v, fl, us, vs, deep_blk(d), st);
  const Coef<T> k{T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4]),
                  T(c[5]), T(c[6]), T(c[7]), T(c[8])};
  // with bands: rhs on the bands' rows, F/G also on the row below each
  // band (rhs reads G one row down)
  const Bands fgb = make_bands(bands, 1, BY), rhb = make_bands(bands, 0, BY);
  dim3 grd = cell_grid(d.Lj, d.Li);
  const dim3 blk(BX, BY);
  if (fgb.n > 0) grd.y = fgb.cta[fgb.n];
  if (grd.y > 0)
    fg_cells_dist<T><<<grd, blk, 0, st>>>(u, v, dt, f, g, d, k, fl, fgb);
  if (rhb.n > 0) grd.y = rhb.cta[rhb.n];
  if (grd.y > 0)
    rhs_cells_dist<T><<<grd, blk, 0, st>>>(f, g, dt, rhs, d, T(c[9]),
                                           T(c[10]), rhb);
  return (int)cudaGetLastError();
}

template <typename T>
int run_post_dist(int dev, T* u, T* v, const T* f, const T* g, const T* p,
                  const T* dt, const int* geo, int ragged, double dx,
                  double dy, const uint8_t* fl, T* partial, T* out,
                  void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const Dist d{geo[0], geo[1], 0, geo[2], geo[3], geo[4], geo[5]};
  const dim3 grd = cell_grid(d.Lj, d.Li);
  adapt_cells_dist<T><<<grd, dim3(BX, BY), 0, st>>>(
      u, v, f, g, p, dt, d, T(dx), T(dy), ragged, fl, partial);
  max_partials<T><<<1, FIN, 0, st>>>(partial, (int)(grd.x * grd.y), out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The class mode: lane-stacked (jc+2, ic+2) blocks; per lane ext = [J, I],
// geo = [dx, dy] (T), dt, active.
// ---------------------------------------------------------------------

// the walls of a lane's live grid in the reference's order (left, right,
// bottom, top), then the lid or the inflow, a block per lane
template <typename T>
__global__ void cls_bc(T* __restrict__ u, T* __restrict__ v,
                       const int* __restrict__ ext, const T* __restrict__ geo,
                       const uint8_t* __restrict__ active, int jc, int ic,
                       int bl, int br, int bb, int bt, int problem, T yl,
                       T yl2) {
  const int lane = blockIdx.x;
  if (!active[lane]) return;
  const size_t W = ic + 2, lane_cells = (size_t)(jc + 2) * W;
  walls(u + lane * lane_cells, v + lane * lane_cells, ext[2 * lane],
        ext[2 * lane + 1], W, bl, br, bb, bt, problem, geo[2 * lane + 1], yl,
        yl2);
}

// F and G of every cell of a lane's block: the predictor on its interior,
// the wall fixups, 0 elsewhere (and everywhere on an inactive lane)
template <typename T>
__global__ void cls_fg(const T* __restrict__ u, const T* __restrict__ v,
                       const T* __restrict__ dt, T* __restrict__ f,
                       T* __restrict__ g, const int* __restrict__ ext,
                       const T* __restrict__ geo,
                       const uint8_t* __restrict__ active, int jc, int ic,
                       T gamma, T inv_re, T gx, T gy) {
  const int lane = blockIdx.z;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i > ic + 1 || j > jc + 1) return;
  const size_t W = ic + 2;
  const size_t k = (size_t)lane * (jc + 2) * W + (size_t)j * W + i;
  T fv = T(0), gv = T(0);
  if (active[lane]) {
    const int J = ext[2 * lane], I = ext[2 * lane + 1];
    const bool rows = j >= 1 && j <= J;
    const bool cols = i >= 1 && i <= I;
    if (rows && cols) {
      const T idx = T(1) / geo[2 * lane], idy = T(1) / geo[2 * lane + 1];
      const Coef<T> c{idx * T(0.25), gamma * idx * T(0.25), idy * T(0.25),
                      gamma * idy * T(0.25), idx * idx, idy * idy, inv_re,
                      gx, gy};
      fg_predict(u, v, k, W, dt[lane], c, fv, gv);
    }
    if (rows && (i == 0 || i == I)) fv = u[k];
    if (cols && (j == 0 || j == J)) gv = v[k];
  }
  f[k] = fv;
  g[k] = gv;
}

template <typename T>
__global__ void cls_rhs(const T* __restrict__ f, const T* __restrict__ g,
                        const T* __restrict__ dt, T* __restrict__ rhs,
                        const int* __restrict__ ext,
                        const T* __restrict__ geo,
                        const uint8_t* __restrict__ active, int jc, int ic) {
  const int lane = blockIdx.z;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i > ic + 1 || j > jc + 1) return;
  const size_t W = ic + 2;
  const size_t k = (size_t)lane * (jc + 2) * W + (size_t)j * W + i;
  T r = T(0);
  if (active[lane] && j >= 1 && j <= ext[2 * lane] && i >= 1 &&
      i <= ext[2 * lane + 1]) {
    const T inv_dt = T(1) / dt[lane];
    r = inv_dt * ((f[k] - f[k - 1]) / geo[2 * lane] +
                  (g[k] - g[k - W]) / geo[2 * lane + 1]);
  }
  rhs[k] = r;
}

// the projection on an active lane's interior, the live-mask multiply, and
// per-block maxima of |u|, |v| over the lane's live cells (all lanes)
template <typename T>
__global__ void cls_adapt(T* __restrict__ u, T* __restrict__ v,
                          const T* __restrict__ f, const T* __restrict__ g,
                          const T* __restrict__ p, const T* __restrict__ dt,
                          const int* __restrict__ ext,
                          const T* __restrict__ geo,
                          const uint8_t* __restrict__ active, int jc, int ic,
                          T* __restrict__ partial) {
  __shared__ T shu[NT];
  __shared__ T shv[NT];
  const int lane = blockIdx.z;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int J = ext[2 * lane], I = ext[2 * lane + 1];
  T au = T(0), av = T(0);
  if (i <= ic + 1 && j <= jc + 1) {
    const size_t W = ic + 2;
    const size_t k = (size_t)lane * (jc + 2) * W + (size_t)j * W + i;
    const bool live = j <= J + 1 && i <= I + 1;
    T uu = u[k], vv = v[k];
    if (active[lane]) {
      if (j >= 1 && j <= J && i >= 1 && i <= I) {
        const T d = dt[lane];
        const T fx = d / geo[2 * lane];
        const T fy = d / geo[2 * lane + 1];
        uu = f[k] - (p[k + 1] - p[k]) * fx;
        vv = g[k] - (p[k + W] - p[k]) * fy;
      }
      const T lm = live ? T(1) : T(0);
      uu = uu * lm;
      vv = vv * lm;
      u[k] = uu;
      v[k] = vv;
    }
    if (live) {
      au = fabs(uu);
      av = fabs(vv);
    }
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
    const size_t b = (size_t)lane * 2 * nb + blockIdx.y * gridDim.x +
                     blockIdx.x;
    partial[b] = shu[0];
    partial[b + nb] = shv[0];
  }
}

template <typename T>
int run_pre_class(int dev, T* u, T* v, const T* dt, T* f, T* g, T* rhs,
                  const int* ext, const T* geo, const uint8_t* active,
                  int lanes, int jc, int ic, const int* bc, int problem,
                  const double* c, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  // c = [gamma, 1/re, gx, gy, ylength, ylength*ylength]
  cls_bc<T><<<lanes, 256, 0, st>>>(u, v, ext, geo, active, jc, ic, bc[0],
                                   bc[1], bc[2], bc[3], problem, T(c[4]),
                                   T(c[5]));
  dim3 grd = cell_grid(jc, ic);
  grd.z = lanes;
  const dim3 blk(BX, BY);
  cls_fg<T><<<grd, blk, 0, st>>>(u, v, dt, f, g, ext, geo, active, jc, ic,
                                 T(c[0]), T(c[1]), T(c[2]), T(c[3]));
  cls_rhs<T><<<grd, blk, 0, st>>>(f, g, dt, rhs, ext, geo, active, jc, ic);
  return (int)cudaGetLastError();
}

template <typename T>
int run_post_class(int dev, T* u, T* v, const T* f, const T* g, const T* p,
                   const T* dt, const int* ext, const T* geo,
                   const uint8_t* active, int lanes, int jc, int ic,
                   T* partial, T* out, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grd = cell_grid(jc, ic);
  const int nb = (int)(grd.x * grd.y);
  grd.z = lanes;
  cls_adapt<T><<<grd, dim3(BX, BY), 0, st>>>(u, v, f, g, p, dt, ext, geo,
                                             active, jc, ic, partial);
  max_partials<T><<<lanes, FIN, 0, st>>>(partial, nb, out);
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

// fl (uint8, the input block's shape) and PRE's scratch us, vs are null
// outside the flag mode
#define PRE_ENTRY(NAME, T)                                                   \
  int NAME(int dev, void* u, void* v, const void* dt, void* f, void* g,      \
           void* rhs, int J, int I, const int* bc, int problem,              \
           const double* c, const void* fl, void* us, void* vs,              \
           void* stream) {                                                   \
    return run_pre<T>(dev, (T*)u, (T*)v, (const T*)dt, (T*)f, (T*)g,         \
                      (T*)rhs, J, I, bc, problem, c, (const uint8_t*)fl,     \
                      (T*)us, (T*)vs, stream);                               \
  }

#define POST_ENTRY(NAME, T)                                                  \
  int NAME(int dev, void* u, void* v, const void* f, const void* g,          \
           const void* p, const void* dt, int J, int I, double dx,           \
           double dy, const void* fl, void* partial, void* out,              \
           void* stream) {                                                   \
    return run_post<T>(dev, (T*)u, (T*)v, (const T*)f, (const T*)g,          \
                       (const T*)p, (const T*)dt, J, I, dx, dy,              \
                       (const uint8_t*)fl, (T*)partial, (T*)out, stream);    \
  }

// the distributed mode: geo = [Lj, Li, ext_pad, joff, ioff, Gj, Gi]; u, v
// are the shard's deep blocks, f, g, rhs its halo-1 blocks
#define PRE_DIST_ENTRY(NAME, T)                                              \
  int NAME(int dev, void* u, void* v, const void* dt, void* f, void* g,      \
           void* rhs, const int* geo, const int* bc, int problem,            \
           const double* c, const void* fl, void* us, void* vs,              \
           void* stream) {                                                   \
    return run_pre_dist<T>(dev, (T*)u, (T*)v, (const T*)dt, (T*)f, (T*)g,    \
                           (T*)rhs, geo, bc, problem, c, (const uint8_t*)fl, \
                           (T*)us, (T*)vs, stream);                          \
  }

// the grid-band mode of the distributed PRE: bands = [n, lo0, hi0, ...],
// n <= 4 sorted disjoint ranges of the halo-1 block's rows; F, G and rhs
// are written on those rows (F/G one row more below each), the BCs on the
// whole deep block as in the full call
#define PRE_BAND_ENTRY(NAME, T)                                              \
  int NAME(int dev, void* u, void* v, const void* dt, void* f, void* g,      \
           void* rhs, const int* geo, const int* bc, int problem,            \
           const double* c, const void* fl, void* us, void* vs,              \
           const int* bands, void* stream) {                                 \
    if (bands[0] < 1 || bands[0] > MAXB) return (int)cudaErrorInvalidValue;  \
    return run_pre_dist<T>(dev, (T*)u, (T*)v, (const T*)dt, (T*)f, (T*)g,    \
                           (T*)rhs, geo, bc, problem, c, (const uint8_t*)fl, \
                           (T*)us, (T*)vs, stream, bands);                   \
  }

// geo = [Lj, Li, joff, ioff, Gj, Gi]; every block is the shard's halo-1
#define POST_DIST_ENTRY(NAME, T)                                             \
  int NAME(int dev, void* u, void* v, const void* f, const void* g,          \
           const void* p, const void* dt, const int* geo, int ragged,        \
           double dx, double dy, const void* fl, void* partial, void* out,   \
           void* stream) {                                                   \
    return run_post_dist<T>(dev, (T*)u, (T*)v, (const T*)f, (const T*)g,     \
                            (const T*)p, (const T*)dt, geo, ragged, dx, dy,  \
                            (const uint8_t*)fl, (T*)partial, (T*)out,        \
                            stream);                                         \
  }

// the class mode: u, v, f, g, rhs, p lane-stacked (lanes, jc+2, ic+2); ext
// int32 (lanes, 2) = [J, I]; geo (lanes, 2) = [dx, dy]; dt (lanes,); active
// uint8 (lanes,); c = [gamma, 1/re, gx, gy, ylength, ylength*ylength]
#define PRE_CLASS_ENTRY(NAME, T)                                             \
  int NAME(int dev, void* u, void* v, const void* dt, void* f, void* g,      \
           void* rhs, const void* ext, const void* geo, const void* active,  \
           int lanes, int jc, int ic, const int* bc, int problem,            \
           const double* c, void* stream) {                                  \
    return run_pre_class<T>(dev, (T*)u, (T*)v, (const T*)dt, (T*)f, (T*)g,   \
                            (T*)rhs, (const int*)ext, (const T*)geo,         \
                            (const uint8_t*)active, lanes, jc, ic, bc,       \
                            problem, c, stream);                             \
  }

// partial: 2*ns2d_post_partials(jc, ic)/2 per lane; out (2, lanes)
#define POST_CLASS_ENTRY(NAME, T)                                            \
  int NAME(int dev, void* u, void* v, const void* f, const void* g,          \
           const void* p, const void* dt, const void* ext, const void* geo,  \
           const void* active, int lanes, int jc, int ic, void* partial,     \
           void* out, void* stream) {                                        \
    return run_post_class<T>(dev, (T*)u, (T*)v, (const T*)f, (const T*)g,    \
                             (const T*)p, (const T*)dt, (const int*)ext,     \
                             (const T*)geo, (const uint8_t*)active, lanes,   \
                             jc, ic, (T*)partial, (T*)out, stream);          \
  }

PRE_CLASS_ENTRY(ns2d_pre_class_f32, float)
PRE_CLASS_ENTRY(ns2d_pre_class_f64, double)
POST_CLASS_ENTRY(ns2d_post_class_f32, float)
POST_CLASS_ENTRY(ns2d_post_class_f64, double)
PRE_DIST_ENTRY(ns2d_pre_dist_f32, float)
PRE_DIST_ENTRY(ns2d_pre_dist_f64, double)
PRE_BAND_ENTRY(ns2d_pre_band_f32, float)
PRE_BAND_ENTRY(ns2d_pre_band_f64, double)
POST_DIST_ENTRY(ns2d_post_dist_f32, float)
POST_DIST_ENTRY(ns2d_post_dist_f64, double)
PRE_ENTRY(ns2d_pre_f32, float)
PRE_ENTRY(ns2d_pre_f64, double)
POST_ENTRY(ns2d_post_f32, float)
POST_ENTRY(ns2d_post_f64, double)

}  // extern "C"
