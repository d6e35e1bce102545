// NS-3D step phases for Hopper (sm_90a): the port's PRE and POST kernels,
// on one device and on the shards of a mesh, no obstacles.
//
// ns3d_pre (K7) replaces pampi_tpu/ops/ns3d_fused.py _pre3_kernel
//   (make_fused_pre_3d): (u, v, w, dt) -> (u', v', w', F, G, H, rhs) = the
//   six wall BCs in the reference order -> dcavity lid / canal inflow ->
//   F/G/H predictor + wall fixups -> RHS.
// ns3d_post (K8) replaces pampi_tpu/ops/ns3d_fused.py _post3_kernel
//   (make_fused_post_3d): the projection on the interiors of u, v, w, then
//   max|u|, |v|, |w| over the FULL ghosted arrays (the reference maxElement
//   quirk) for the next step's CFL dt.
//
// Both take the block's place in the global grid, as the TPU kernels take
// it by scalar prefetch: every write is gated by the GLOBAL index. On one
// device the block is the whole (K+2, J+2, I+2) array at offset 0. On a
// shard of a mesh (the distributed mode, models/ns3d_dist.py) PRE runs on
// the deep block of the shard, ext_pad = 2 ghost layers more per side than
// the halo-1 block (local index a is global a - ext_pad + offset), applies
// the BCs in place where the global walls cross it, and writes F, G, H and
// rhs on the shard's halo-1 block (l+2 per axis); POST runs on the halo-1
// blocks at the shard's offsets and returns the shard's maxima.
//
// What bounds them on the H100: memory bandwidth. PRE reads u, v, w and
// writes F, G, H, rhs plus the ghost planes of u, v, w (in place); POST
// reads F, G, H, p (and the ghost cells of u, v, w, for the maxima) and
// writes u, v, w: 7 field-sizes each, ~18 us at 128^3 f32 and ~144 us at
// 256^3 at 3.35 TB/s. The ~100 flops per cell of the predictor are far
// below the FP32/FP64 roof.
//
// Design (simple and right first): the Pallas kernels do everything in one
// pass over VMEM windows with a halo. Here PRE is five launches.
//   1-3. The wall BCs, in place, as three launches: the two j faces (top,
//        bottom), the two i faces (left, right), then the two k faces
//        (front, back) together with the special BC. Later faces read
//        earlier faces' writes: every face writes the normal component on
//        its wall plane and the tangential ghosts on its ghost plane, all
//        tangentially clipped to the global interior, so the write sets
//        are disjoint, and the only writes another face reads are the
//        normal components on the HI walls (global index max, inside the
//        others' tangential ranges): top's v(., J, .) is read by the i and
//        k faces, right's u(., ., I) by the k faces and, as the OLD value,
//        by the j faces; back's w(K, ., .) is read, old, by the j and i
//        faces. The two faces of one axis read and write disjoint planes
//        when the axis has at least 2 interior cells (the wrapper requires
//        it). So these three launches reproduce the six ordered faces
//        exactly. The argument is about global planes; on a deep block a
//        face writes the part of its planes that the block holds, and its
//        inward read (one plane towards the interior) then lies in the
//        block too. The special BC writes u(., J+1, .) (lid, after top) or
//        u(., ., 0) (inflow, after left), which the k faces neither read
//        nor write.
//   4.   F, G and H for every cell of the halo-1 block, wall fixups
//        included; a global-interior cell reads its neighbours in the
//        input block (on a deep block they lie inside it).
//   5.   rhs on the owned global-interior cells, which reads F(i-1),
//        G(j-1), H(k-1) of neighbouring blocks.
// POST is one launch (the projection reads only p neighbours, so u, v, w
// update in place; on a shard p is read as 0 beyond the block's high edge,
// where an interface ghost of the TPU kernel reads its zero padding) that
// also writes per-block partial maxima, and a one-block launch that
// reduces them. max is exact in any order, so the maxima equal the plain
// version's bitwise; NaN propagates as in torch.max. dt stays on the
// device (a pointer), so no launch waits for the host.
//
// Every formula keeps the association of pampi_tpu/ops/ns3d.py term for
// term; scalar coefficients are formed in double on the host exactly where
// the reference forms them from Python floats, then rounded to T. Built
// with --fmad=false.
//
// The flag mode (obstacle flag fields, pampi_tpu/ops/obstacle3d.py; the
// TPU kernels' `masked` mode): both kernels also take a uint8 fluid flag
// block of their input block's shape (0 on obstacle and dead cells). A
// face mask is read from the flags: the u face of a cell is fluid-fluid
// where the cell and its +i neighbour are fluid, forced to 1 on the last
// global ghost plane i = I+1 (make_masks_3d's fix of its wrapping roll),
// and likewise v along j and w along k.
//   PRE, after the walls and the special BC (obstacle3d.
//   apply_obstacle_velocity_bc_3d, then mask_fgh):
//   4a. zero the normal components on faces touching an obstacle, into a
//       snapshot us, vs, ws (scratch the wrapper allocates);
//   4b. write u, v, w from the snapshot: u = us + both_u*mirror(us),
//       where both_u marks a face buried in obstacles and mirror is the
//       first-hit sum over the fluid-fluid faces at j+1, j-1, k+1, k-1
//       (v: i+1, i-1, k+1, k-1; w: i+1, i-1, j+1, j-1), in the JAX
//       package's arithmetic (`_mirror`). The JAX function is functional:
//       every mirror reads the array as it is after the zeroing. Done in
//       place, a thread's write could land on a cell another thread
//       reads, and even a read that is multiplied by 0 changes the sign
//       of a zero; the snapshot keeps 4b's reads apart from its writes.
//       Neighbour reads wrap on the block, as the plain version's rolls
//       do; on one device they are the JAX package's full-array rolls,
//       and on a deep block they reach only the outermost layer, which no
//       output reads;
//   then F, G, H carry U, V, W on every non-fluid face (after the wall
//   fixups).
//   POST: the projection is multiplied by the face mask (adapt_uvw_
//   obstacle); on a shard the flags read 0 beyond the block's high edge,
//   as p does there.
// The flags add 1 byte a cell to each kernel's traffic, and PRE's snapshot
// 6 field-sizes (three written, three read).
//
// The ragged mode of POST (a mesh that does not divide the grid: ceil-
// divided blocks whose trailing cells are dead; the TPU kernel's `ragged`
// flag): after the projection u, v, w are multiplied by the live mask, 1 up
// to the global ghost ring and 0 past it, so a dead cell holds 0 (-0 where
// its value was negative) and never reaches the maxima of the ghost-
// inclusive CFL dt. Only the dead cells are multiplied and written (a
// multiply by 1 leaves the others' bits as they are); with or without the
// flags, launches stay two. PRE needs no mode of its own there: its writes
// are gated by the global index wherever the walls cross the block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NOSLIP = 1, SLIP = 2, OUTFLOW = 3;
constexpr int DCAVITY = 1, CANAL = 2;
constexpr int BX = 32, BY = 8, NT = BX * BY;
constexpr int FIN = 1024;

// bc[] order: top, bottom, left, right, front, back (the reference's)
struct Bcs {
  int top, bottom, left, right, front, back;
};

// a block of the global grid: its extents, the global extended index of
// its local index 0, and the global interior extents; axes (k, j, i)
struct Blk {
  int L[3];
  int base[3];
  int G[3];
};

template <typename T>
struct Coef {
  T idx4, gidx4, idy4, gidy4, idz4, gidz4, idx2, idy2, idz2, inv_re, gx, gy,
      gz;
};

__device__ __forceinline__ bool in_range(int a, int n) {
  return a >= 0 && a < n;
}

// a local index one step outside [0, L) wrapped onto the block, as the
// plain version's rolls read it
__device__ __forceinline__ int wrap(int a, int L) {
  return a < 0 ? a + L : (a >= L ? a - L : a);
}

// the BC of one face at one tangential position `b` (the offset of the
// position in the face's plane), planes `stride` apart along the normal:
// the normal component n on the wall plane aw (read from aw_in), the
// tangential components t1, t2 on the ghost plane ag (read from ag_in); a
// plane the block does not hold is not written. A read one plane outside
// the block wraps onto it, as the plain version's roll does: on a ragged
// mesh a HI wall can sit on a deep block's first plane (its outermost
// layer, which no output reads).
template <typename T>
__device__ __forceinline__ void face(int kind, T* n, T* t1, T* t2, size_t b,
                                     size_t stride, int L, int aw, int aw_in,
                                     int ag, int ag_in) {
  if (kind != NOSLIP && kind != SLIP && kind != OUTFLOW) return;
  if (in_range(aw, L)) {
    const size_t w = b + aw * stride;
    n[w] = kind == OUTFLOW ? n[b + wrap(aw_in, L) * stride] : T(0);
  }
  if (in_range(ag, L)) {
    const size_t g = b + ag * stride, gi = b + wrap(ag_in, L) * stride;
    if (kind == NOSLIP) {
      t1[g] = -t1[gi];
      t2[g] = -t2[gi];
    } else {
      t1[g] = t1[gi];
      t2[g] = t2[gi];
    }
  }
}

// the wall faces of one axis: lo (z = 0 of the pair) at global 0, hi at
// global G (wall) and G+1 (ghost); (a, b) are the local tangential indices
__device__ __forceinline__ bool tangential(const Blk& k, int ax1, int a,
                                           int ax2, int b) {
  if (a >= k.L[ax1] || b >= k.L[ax2]) return false;
  const int g1 = a + k.base[ax1], g2 = b + k.base[ax2];
  return g1 >= 1 && g1 <= k.G[ax1] && g2 >= 1 && g2 <= k.G[ax2];
}

// launch 1: top (z = 0) and bottom (z = 1) at local (k, i) = (a, b)
template <typename T>
__device__ __forceinline__ void jfaces(T* u, T* v, T* w, const Blk& k,
                                       const Bcs& bc, int a, int b, int z) {
  if (!tangential(k, 0, a, 2, b)) return;
  const size_t W = k.L[2], P = (size_t)k.L[1] * W;
  const size_t base = a * P + b;
  if (z == 0) {  // top: v on the wall j = J, ghosts at J+1
    const int aw = k.G[1] - k.base[1];
    face(bc.top, v, u, w, base, W, k.L[1], aw, aw - 1, aw + 1, aw);
  } else {  // bottom: v on the wall j = 0, ghosts at 0
    const int aw = -k.base[1];
    face(bc.bottom, v, u, w, base, W, k.L[1], aw, aw + 1, aw, aw + 1);
  }
}

template <typename T>
__global__ void bc_jfaces(T* u, T* v, T* w, Blk k, Bcs bc) {
  jfaces(u, v, w, k, bc, blockIdx.y * BY + threadIdx.y,
         blockIdx.x * BX + threadIdx.x, blockIdx.z);
}

// launch 2: left (z = 0) and right (z = 1) at local (k, j) = (a, b)
template <typename T>
__device__ __forceinline__ void ifaces(T* u, T* v, T* w, const Blk& k,
                                       const Bcs& bc, int a, int b, int z) {
  if (!tangential(k, 0, a, 1, b)) return;
  const size_t W = k.L[2], P = (size_t)k.L[1] * W;
  const size_t base = a * P + b * W;
  if (z == 0) {  // left: u on the wall i = 0, ghosts at 0
    const int aw = -k.base[2];
    face(bc.left, u, v, w, base, 1, k.L[2], aw, aw + 1, aw, aw + 1);
  } else {  // right: u on the wall i = I, ghosts at I+1
    const int aw = k.G[2] - k.base[2];
    face(bc.right, u, v, w, base, 1, k.L[2], aw, aw - 1, aw + 1, aw);
  }
}

template <typename T>
__global__ void bc_ifaces(T* u, T* v, T* w, Blk k, Bcs bc) {
  ifaces(u, v, w, k, bc, blockIdx.y * BY + threadIdx.y,
         blockIdx.x * BX + threadIdx.x, blockIdx.z);
}

// launch 3: front (z = 0) and back (z = 1) at local (j, i) = (a, b), and
// the special BC (z = 2): the dcavity lid at local (k, i) = (a, b),
// skipping the last interior k and i, or the canal inflow at (k, j)
template <typename T>
__device__ __forceinline__ void kfaces_special(T* u, T* v, T* w,
                                               const Blk& k, const Bcs& bc,
                                               int problem, int a, int b,
                                               int z) {
  const size_t W = k.L[2], P = (size_t)k.L[1] * W;
  if (z < 2) {
    if (!tangential(k, 1, a, 2, b)) return;
    const size_t base = a * W + b;
    if (z == 0) {  // front: w on the wall k = 0, ghosts at 0
      const int aw = -k.base[0];
      face(bc.front, w, u, v, base, P, k.L[0], aw, aw + 1, aw, aw + 1);
    } else {  // back: w on the wall k = K, ghosts at K+1
      const int aw = k.G[0] - k.base[0];
      face(bc.back, w, u, v, base, P, k.L[0], aw, aw - 1, aw + 1, aw);
    }
  } else if (problem == DCAVITY) {
    if (a >= k.L[0] || b >= k.L[2]) return;
    const int gk = a + k.base[0], gi = b + k.base[2];
    if (gk < 1 || gk > k.G[0] - 1 || gi < 1 || gi > k.G[2] - 1) return;
    const int aj = k.G[1] + 1 - k.base[1];  // the lid's ghost plane J+1
    if (!in_range(aj, k.L[1])) return;
    const size_t x = a * P + (size_t)aj * W + b;
    u[x] = T(2) - u[a * P + (size_t)wrap(aj - 1, k.L[1]) * W + b];
  } else if (problem == CANAL) {
    if (a >= k.L[0] || b >= k.L[1]) return;
    const int gk = a + k.base[0], gj = b + k.base[1];
    if (gk < 1 || gk > k.G[0] || gj < 1 || gj > k.G[1]) return;
    const int ai = -k.base[2];  // the inflow plane i = 0
    if (!in_range(ai, k.L[2])) return;
    u[a * P + b * W + ai] = T(2);
  }
}

template <typename T>
__global__ void bc_kfaces_special(T* u, T* v, T* w, Blk k, Bcs bc,
                                  int problem) {
  kfaces_special(u, v, w, k, bc, problem, blockIdx.y * BY + threadIdx.y,
                 blockIdx.x * BX + threadIdx.x, blockIdx.z);
}

// -- the flag mode --------------------------------------------------------

__device__ __forceinline__ size_t at(const Blk& k, int a0, int a1, int a2) {
  return ((size_t)wrap(a0, k.L[0]) * k.L[1] + wrap(a1, k.L[1])) * k.L[2] +
         wrap(a2, k.L[2]);
}

// the face mask of the component normal to `axis` (0: w, 1: v, 2: u) at
// local (a0, a1, a2), every index wrapping on the block: 1 on the last
// global ghost plane of the axis, else the cell's flag times the flag of
// its + neighbour along the axis
template <typename T>
__device__ __forceinline__ T face_at(const uint8_t* fl, const Blk& k,
                                     int axis, int a0, int a1, int a2) {
  int a[3] = {wrap(a0, k.L[0]), wrap(a1, k.L[1]), wrap(a2, k.L[2])};
  if (a[axis] + k.base[axis] == k.G[axis] + 1) return T(1);
  const T c = T(fl[at(k, a[0], a[1], a[2])]);
  a[axis] += 1;
  return c * T(fl[at(k, a[0], a[1], a[2])]);
}

// launch 4a: the zeroed normal components, into the snapshot
template <typename T>
__global__ void obs_zero(const T* __restrict__ u, const T* __restrict__ v,
                         const T* __restrict__ w,
                         const uint8_t* __restrict__ fl, T* __restrict__ us,
                         T* __restrict__ vs, T* __restrict__ ws, Blk k) {
  const int a2 = blockIdx.x * BX + threadIdx.x;
  const int a1 = blockIdx.y * BY + threadIdx.y;
  const int a0 = blockIdx.z;
  if (a2 >= k.L[2] || a1 >= k.L[1]) return;
  const size_t x = at(k, a0, a1, a2);
  us[x] = u[x] * face_at<T>(fl, k, 2, a0, a1, a2);
  vs[x] = v[x] * face_at<T>(fl, k, 1, a0, a1, a2);
  ws[x] = w[x] * face_at<T>(fl, k, 0, a0, a1, a2);
}

// one term of the first-hit mirror (obstacle3d._mirror)
template <typename T>
__device__ __forceinline__ void mirror_term(T& acc, T& rem, T fm, T val) {
  acc = acc + rem * fm * (-val);
  rem = rem * (T(1) - fm);
}

// launch 4b: the tangential mirror of every component, read from the
// snapshot, written to u, v, w; d[q] are the four neighbour offsets
template <typename T>
__device__ __forceinline__ T mirrored(const T* s, const uint8_t* fl,
                                      const Blk& k, int axis, int a0, int a1,
                                      int a2, const int (*d)[3]) {
  const T one = T(1);
  int b[3] = {a0, a1, a2};
  b[axis] += 1;
  const T both = (one - T(fl[at(k, a0, a1, a2)])) *
                 (one - T(fl[at(k, b[0], b[1], b[2])]));
  T acc = T(0), rem = T(1);
  for (int q = 0; q < 4; ++q) {
    const int n0 = a0 + d[q][0], n1 = a1 + d[q][1], n2 = a2 + d[q][2];
    mirror_term(acc, rem, face_at<T>(fl, k, axis, n0, n1, n2),
                s[at(k, n0, n1, n2)]);
  }
  return s[at(k, a0, a1, a2)] + both * acc;
}

template <typename T>
__global__ void obs_mirror(T* __restrict__ u, T* __restrict__ v,
                           T* __restrict__ w, const uint8_t* __restrict__ fl,
                           const T* __restrict__ us, const T* __restrict__ vs,
                           const T* __restrict__ ws, Blk k) {
  // priority order: u north, south, back, front; v east, west, back,
  // front; w east, west, north, south ((k, j, i) offsets)
  const int du[4][3] = {{0, 1, 0}, {0, -1, 0}, {1, 0, 0}, {-1, 0, 0}};
  const int dv[4][3] = {{0, 0, 1}, {0, 0, -1}, {1, 0, 0}, {-1, 0, 0}};
  const int dw[4][3] = {{0, 0, 1}, {0, 0, -1}, {0, 1, 0}, {0, -1, 0}};
  const int a2 = blockIdx.x * BX + threadIdx.x;
  const int a1 = blockIdx.y * BY + threadIdx.y;
  const int a0 = blockIdx.z;
  if (a2 >= k.L[2] || a1 >= k.L[1]) return;
  const size_t x = at(k, a0, a1, a2);
  u[x] = mirrored<T>(us, fl, k, 2, a0, a1, a2, du);
  v[x] = mirrored<T>(vs, fl, k, 1, a0, a1, a2, dv);
  w[x] = mirrored<T>(ws, fl, k, 0, a0, a1, a2, dw);
}

// launch 4: F, G, H for every cell of the output block o (the halo-1
// block, `e` cells inside the input block k on every side)
template <typename T>
__device__ __forceinline__ void fgh_cell(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ dtp, T* __restrict__ f, T* __restrict__ g,
    T* __restrict__ h, const Blk& k, const Blk& o, int e, const Coef<T>& c,
    const uint8_t* __restrict__ fl, int oi, int oj, int ok) {
  if (oi >= o.L[2] || oj >= o.L[1]) return;
  const size_t W = k.L[2], P = (size_t)k.L[1] * W;
  const size_t x = (size_t)(ok + e) * P + (size_t)(oj + e) * W + (oi + e);
  const int gi = oi + o.base[2], gj = oj + o.base[1], gk = ok + o.base[0];
  const bool in_i = gi >= 1 && gi <= o.G[2];
  const bool in_j = gj >= 1 && gj <= o.G[1];
  const bool in_k = gk >= 1 && gk <= o.G[0];
  T fv = T(0), gv = T(0), hv = T(0);
  if (in_i && in_j && in_k) {
    const T dt = *dtp;
    const T uc = u[x], vc = v[x], wc = w[x];
    const T u_ip = u[x + 1], u_im = u[x - 1], u_jp = u[x + W],
            u_jm = u[x - W], u_kp = u[x + P], u_km = u[x - P];
    const T v_ip = v[x + 1], v_im = v[x - 1], v_jp = v[x + W],
            v_jm = v[x - W], v_kp = v[x + P], v_km = v[x - P];
    const T w_ip = w[x + 1], w_im = w[x - 1], w_jp = w[x + W],
            w_jm = w[x - W], w_kp = w[x + P], w_km = w[x - P];
    const T u_im_jp = u[x - 1 + W], u_im_kp = u[x - 1 + P];
    const T v_jm_ip = v[x - W + 1], v_jm_kp = v[x - W + P];
    const T w_km_ip = w[x - P + 1], w_km_jp = w[x - P + W];
    // ---- F ----
    const T du2dx =
        c.idx4 * ((uc + u_ip) * (uc + u_ip) - (uc + u_im) * (uc + u_im)) +
        c.gidx4 * (fabs(uc + u_ip) * (uc - u_ip) +
                   fabs(uc + u_im) * (uc - u_im));
    const T duvdy =
        c.idy4 * ((vc + v_ip) * (uc + u_jp) - (v_jm + v_jm_ip) * (uc + u_jm)) +
        c.gidy4 * (fabs(vc + v_ip) * (uc - u_jp) +
                   fabs(v_jm + v_jm_ip) * (uc - u_jm));
    const T duwdz =
        c.idz4 * ((wc + w_ip) * (uc + u_kp) - (w_km + w_km_ip) * (uc + u_km)) +
        c.gidz4 * (fabs(wc + w_ip) * (uc - u_kp) +
                   fabs(w_km + w_km_ip) * (uc - u_km));
    const T lap_u = c.idx2 * (u_ip - T(2) * uc + u_im) +
                    c.idy2 * (u_jp - T(2) * uc + u_jm) +
                    c.idz2 * (u_kp - T(2) * uc + u_km);
    fv = uc + dt * (c.inv_re * lap_u - du2dx - duvdy - duwdz + c.gx);
    // ---- G ---- (reference quirk: v_kp in both halves of dvwdz)
    const T duvdx =
        c.idx4 * ((uc + u_jp) * (vc + v_ip) - (u_im + u_im_jp) * (vc + v_im)) +
        c.gidx4 * (fabs(uc + u_jp) * (vc - v_ip) +
                   fabs(u_im + u_im_jp) * (vc - v_im));
    const T dv2dy =
        c.idy4 * ((vc + v_jp) * (vc + v_jp) - (vc + v_jm) * (vc + v_jm)) +
        c.gidy4 * (fabs(vc + v_jp) * (vc - v_jp) +
                   fabs(vc + v_jm) * (vc - v_jm));
    const T dvwdz =
        c.idz4 * ((wc + w_jp) * (vc + v_kp) - (w_km + w_km_jp) * (vc + v_kp)) +
        c.gidz4 * (fabs(wc + w_jp) * (vc - v_kp) +
                   fabs(w_km + w_km_jp) * (vc - v_kp));
    const T lap_v = c.idx2 * (v_ip - T(2) * vc + v_im) +
                    c.idy2 * (v_jp - T(2) * vc + v_jm) +
                    c.idz2 * (v_kp - T(2) * vc + v_km);
    gv = vc + dt * (c.inv_re * lap_v - duvdx - dv2dy - dvwdz + c.gy);
    // ---- H ----
    const T duwdx =
        c.idx4 * ((uc + u_kp) * (wc + w_ip) - (u_im + u_im_kp) * (wc + w_im)) +
        c.gidx4 * (fabs(uc + u_kp) * (wc - w_ip) +
                   fabs(u_im + u_im_kp) * (wc - w_im));
    const T dvwdy =
        c.idy4 * ((vc + v_kp) * (wc + w_jp) - (v_jm_kp + v_jm) * (wc + w_jm)) +
        c.gidy4 * (fabs(vc + v_kp) * (wc - w_jp) +
                   fabs(v_jm_kp + v_jm) * (wc - w_jm));
    const T dw2dz =
        c.idz4 * ((wc + w_kp) * (wc + w_kp) - (wc + w_km) * (wc + w_km)) +
        c.gidz4 * (fabs(wc + w_kp) * (wc - w_kp) +
                   fabs(wc + w_km) * (wc - w_km));
    const T lap_w = c.idx2 * (w_ip - T(2) * wc + w_im) +
                    c.idy2 * (w_jp - T(2) * wc + w_jm) +
                    c.idz2 * (w_kp - T(2) * wc + w_km);
    hv = wc + dt * (c.inv_re * lap_w - duwdx - dvwdy - dw2dz + c.gz);
  }
  // wall fixups: F carries U on the i walls, G V on the j walls, H W on the
  // k walls (tangentially the global interior)
  if (in_j && in_k && (gi == 0 || gi == o.G[2])) fv = u[x];
  if (in_i && in_k && (gj == 0 || gj == o.G[1])) gv = v[x];
  if (in_i && in_j && (gk == 0 || gk == o.G[0])) hv = w[x];
  if (fl != nullptr) {  // F, G, H carry U, V, W on non-fluid faces
    const T one = T(1);
    const T uf = face_at<T>(fl, k, 2, ok + e, oj + e, oi + e);
    const T vf = face_at<T>(fl, k, 1, ok + e, oj + e, oi + e);
    const T wf = face_at<T>(fl, k, 0, ok + e, oj + e, oi + e);
    fv = uf * fv + (one - uf) * u[x];
    gv = vf * gv + (one - vf) * v[x];
    hv = wf * hv + (one - wf) * w[x];
  }
  const size_t y = ((size_t)ok * o.L[1] + oj) * o.L[2] + oi;
  f[y] = fv;
  g[y] = gv;
  h[y] = hv;
}

template <typename T>
__global__ void fgh_cells(const T* __restrict__ u, const T* __restrict__ v,
                          const T* __restrict__ w, const T* __restrict__ dtp,
                          T* __restrict__ f, T* __restrict__ g,
                          T* __restrict__ h, Blk k, Blk o, int e,
                          Coef<T> c, const uint8_t* __restrict__ fl) {
  fgh_cell(u, v, w, dtp, f, g, h, k, o, e, c, fl,
           blockIdx.x * BX + threadIdx.x, blockIdx.y * BY + threadIdx.y,
           blockIdx.z);
}

// launch 5: rhs = div(F, G, H)/dt on the owned global-interior cells of the
// output block, zero elsewhere
template <typename T>
__device__ __forceinline__ void rhs_cell(const T* __restrict__ f,
                                         const T* __restrict__ g,
                                         const T* __restrict__ h,
                                         const T* __restrict__ dtp,
                                         T* __restrict__ rhs, const Blk& o,
                                         T dx, T dy, T dz, int i, int j,
                                         int k) {
  if (i >= o.L[2] || j >= o.L[1]) return;
  const size_t W = o.L[2], P = (size_t)o.L[1] * W;
  const size_t x = k * P + j * W + i;
  const int gi = i + o.base[2], gj = j + o.base[1], gk = k + o.base[0];
  T r = T(0);
  if (i >= 1 && i <= o.L[2] - 2 && j >= 1 && j <= o.L[1] - 2 && k >= 1 &&
      k <= o.L[0] - 2 && gi >= 1 && gi <= o.G[2] && gj >= 1 &&
      gj <= o.G[1] && gk >= 1 && gk <= o.G[0]) {
    const T inv_dt = T(1) / *dtp;
    r = ((f[x] - f[x - 1]) / dx + (g[x] - g[x - W]) / dy +
         (h[x] - h[x - P]) / dz) *
        inv_dt;
  }
  rhs[x] = r;
}

template <typename T>
__global__ void rhs_cells(const T* __restrict__ f, const T* __restrict__ g,
                          const T* __restrict__ h, const T* __restrict__ dtp,
                          T* __restrict__ rhs, Blk o, T dx, T dy, T dz) {
  rhs_cell(f, g, h, dtp, rhs, o, dx, dy, dz, blockIdx.x * BX + threadIdx.x,
           blockIdx.y * BY + threadIdx.y, blockIdx.z);
}

template <typename T>
__device__ __forceinline__ T nanmax(T m, T a) {
  return (a > m || a != a) ? a : m;
}

template <typename T>
__global__ void adapt_cells(T* __restrict__ u, T* __restrict__ v,
                            T* __restrict__ w, const T* __restrict__ f,
                            const T* __restrict__ g, const T* __restrict__ h,
                            const T* __restrict__ p, const T* __restrict__ dtp,
                            Blk o, T dx, T dy, T dz,
                            const uint8_t* __restrict__ fl, bool ragged,
                            T* __restrict__ partial) {
  __shared__ T shu[NT];
  __shared__ T shv[NT];
  __shared__ T shw[NT];
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  const int tid = threadIdx.y * BX + threadIdx.x;
  T au = T(0), av = T(0), aw = T(0);
  if (i < o.L[2] && j < o.L[1]) {
    const size_t W = o.L[2], P = (size_t)o.L[1] * W;
    const size_t x = k * P + j * W + i;
    const int gi = i + o.base[2], gj = j + o.base[1], gk = k + o.base[0];
    T uu, vv, ww;
    if (gi >= 1 && gi <= o.G[2] && gj >= 1 && gj <= o.G[1] && gk >= 1 &&
        gk <= o.G[0]) {
      const T dt = *dtp;
      const T pc = p[x];
      // beyond the block's high edge (an interface ghost) p reads as 0
      const T pi = i + 1 < o.L[2] ? p[x + 1] : T(0);
      const T pj = j + 1 < o.L[1] ? p[x + W] : T(0);
      const T pk = k + 1 < o.L[0] ? p[x + P] : T(0);
      uu = f[x] - (pi - pc) * (dt / dx);
      vv = g[x] - (pj - pc) * (dt / dy);
      ww = h[x] - (pk - pc) * (dt / dz);
      if (fl != nullptr) {  // the projection on fluid-fluid faces only
        const T fc = T(fl[x]);
        uu = uu * (fc * (i + 1 < o.L[2] ? T(fl[x + 1]) : T(0)));
        vv = vv * (fc * (j + 1 < o.L[1] ? T(fl[x + W]) : T(0)));
        ww = ww * (fc * (k + 1 < o.L[0] ? T(fl[x + P]) : T(0)));
      }
      u[x] = uu;
      v[x] = vv;
      w[x] = ww;
    } else {  // ghost cells keep u, v, w and count for the maxima
      uu = u[x];
      vv = v[x];
      ww = w[x];
      if (ragged && (gi > o.G[2] + 1 || gj > o.G[1] + 1 || gk > o.G[0] + 1)) {
        // a dead cell past the global ghost ring: times the live mask's 0
        uu = uu * T(0);
        vv = vv * T(0);
        ww = ww * T(0);
        u[x] = uu;
        v[x] = vv;
        w[x] = ww;
      }
    }
    au = fabs(uu);
    av = fabs(vv);
    aw = fabs(ww);
  }
  shu[tid] = au;
  shv[tid] = av;
  shw[tid] = aw;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
      shu[tid] = nanmax(shu[tid], shu[tid + s]);
      shv[tid] = nanmax(shv[tid], shv[tid + s]);
      shw[tid] = nanmax(shw[tid], shw[tid + s]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const size_t nb = (size_t)gridDim.x * gridDim.y * gridDim.z;
    const size_t b =
        ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partial[b] = shu[0];
    partial[nb + b] = shv[0];
    partial[2 * nb + b] = shw[0];
  }
}

template <typename T>
__global__ void max_partials(const T* __restrict__ partial, int nb,
                             T* __restrict__ out) {
  __shared__ T sh[3][FIN];
  T m[3] = {T(0), T(0), T(0)};
  for (int k = threadIdx.x; k < nb; k += FIN)
    for (int q = 0; q < 3; ++q) m[q] = nanmax(m[q], partial[(size_t)q * nb + k]);
  for (int q = 0; q < 3; ++q) sh[q][threadIdx.x] = m[q];
  __syncthreads();
  for (int s = FIN / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int q = 0; q < 3; ++q)
        sh[q][threadIdx.x] = nanmax(sh[q][threadIdx.x], sh[q][threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0)
    for (int q = 0; q < 3; ++q) out[q] = sh[q][0];
}

// the halo-1 block of local interior extents l at global offsets off
Blk halo1(const int* l, const int* off, const int* G) {
  Blk b;
  for (int a = 0; a < 3; ++a) {
    b.L[a] = l[a] + 2;
    b.base[a] = off[a];
    b.G[a] = G[a];
  }
  return b;
}

dim3 cell_grid(const Blk& o) {
  return dim3((o.L[2] + BX - 1) / BX, (o.L[1] + BY - 1) / BY, o.L[0]);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int max2(int a, int b) { return a > b ? a : b; }

// geo = [ext_pad, koff, joff, ioff, K, J, I]; l = the local interior
// extents (lk, lj, li) of the halo-1 output block
template <typename T>
int run_pre(int dev, T* u, T* v, T* w, const T* dt, T* f, T* g, T* h, T* rhs,
            const int* l, const int* geo, const int* bc, int problem,
            const double* c, const uint8_t* fl, T* us, T* vs, T* ws,
            void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int ep = geo[0];
  const Blk o = halo1(l, geo + 1, geo + 4);
  Blk k = o;  // the input block: ep more ghost layers per side
  for (int a = 0; a < 3; ++a) {
    k.L[a] = o.L[a] + 2 * ep;
    k.base[a] = o.base[a] - ep;
  }
  const Bcs b{bc[0], bc[1], bc[2], bc[3], bc[4], bc[5]};
  const dim3 blk(BX, BY);
  bc_jfaces<T><<<dim3(ceil_div(k.L[2], BX), ceil_div(k.L[0], BY), 2), blk, 0,
                 st>>>(u, v, w, k, b);
  bc_ifaces<T><<<dim3(ceil_div(k.L[1], BX), ceil_div(k.L[0], BY), 2), blk, 0,
                 st>>>(u, v, w, k, b);
  const int xa = max2(k.L[2], k.L[1]), ya = max2(k.L[1], k.L[0]);
  bc_kfaces_special<T><<<dim3(ceil_div(xa, BX), ceil_div(ya, BY), 3), blk, 0,
                         st>>>(u, v, w, k, b, problem);
  if (fl != nullptr) {
    const dim3 kgrd(ceil_div(k.L[2], BX), ceil_div(k.L[1], BY), k.L[0]);
    obs_zero<T><<<kgrd, blk, 0, st>>>(u, v, w, fl, us, vs, ws, k);
    obs_mirror<T><<<kgrd, blk, 0, st>>>(u, v, w, fl, us, vs, ws, k);
  }
  // c = [idx*0.25, gamma*idx*0.25, idy*0.25, gamma*idy*0.25, idz*0.25,
  //      gamma*idz*0.25, idx*idx, idy*idy, idz*idz, 1/re, gx, gy, gz,
  //      dx, dy, dz]
  const Coef<T> cf{T(c[0]), T(c[1]), T(c[2]),  T(c[3]),  T(c[4]),
                   T(c[5]), T(c[6]), T(c[7]),  T(c[8]),  T(c[9]),
                   T(c[10]), T(c[11]), T(c[12])};
  const dim3 grd = cell_grid(o);
  fgh_cells<T><<<grd, blk, 0, st>>>(u, v, w, dt, f, g, h, k, o, ep, cf, fl);
  rhs_cells<T><<<grd, blk, 0, st>>>(f, g, h, dt, rhs, o, T(c[13]), T(c[14]),
                                    T(c[15]));
  return (int)cudaGetLastError();
}

// geo = [koff, joff, ioff, K, J, I]
template <typename T>
int run_post(int dev, T* u, T* v, T* w, const T* f, const T* g, const T* h,
             const T* p, const T* dt, const int* l, const int* geo,
             double dx, double dy, double dz, const uint8_t* fl, int ragged,
             T* partial, T* out, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const Blk o = halo1(l, geo, geo + 3);
  const dim3 grd = cell_grid(o);
  adapt_cells<T><<<grd, dim3(BX, BY), 0, st>>>(u, v, w, f, g, h, p, dt, o,
                                               T(dx), T(dy), T(dz), fl,
                                               ragged != 0, partial);
  max_partials<T><<<1, FIN, 0, st>>>(partial, (int)(grd.x * grd.y * grd.z),
                                     out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The class mode: lane-stacked (kc+2, jc+2, ic+2) blocks; per lane ext =
// [K, J, I] (int32), geo = [dx, dy, dz] (T), dt, active (uint8).
// ---------------------------------------------------------------------

// the lanes of a class call and the class block's interior extents
struct Cls {
  int lanes, kc, jc, ic;
};

// the most blocks a grid's z axis takes: past it a block loops over z
constexpr int ZMAX = 65535;

__host__ __device__ __forceinline__ size_t lane_cells(const Cls& c) {
  return (size_t)(c.kc + 2) * (c.jc + 2) * (c.ic + 2);
}

// lane l's block at offset 0, its global extents the lane's own
__device__ __forceinline__ Blk lane_blk(const Cls& c, const int* ext,
                                        int l) {
  Blk b;
  b.L[0] = c.kc + 2;
  b.L[1] = c.jc + 2;
  b.L[2] = c.ic + 2;
  for (int a = 0; a < 3; ++a) {
    b.base[a] = 0;
    b.G[a] = ext[3 * l + a];
  }
  return b;
}

// launches 1-3: the wall BCs and the special BC of every active lane, z =
// lane * faces + face (a block loops over z past the grid's z extent)
template <typename T>
__global__ void cls_jfaces(T* u, T* v, T* w, const int* __restrict__ ext,
                           const uint8_t* __restrict__ active, Cls c,
                           Bcs bc) {
  const int a = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.x * BX + threadIdx.x;
  for (int z = blockIdx.z; z < 2 * c.lanes; z += gridDim.z) {
    const int l = z / 2;
    if (!active[l]) continue;
    const size_t o = l * lane_cells(c);
    jfaces(u + o, v + o, w + o, lane_blk(c, ext, l), bc, a, b, z % 2);
  }
}

template <typename T>
__global__ void cls_ifaces(T* u, T* v, T* w, const int* __restrict__ ext,
                           const uint8_t* __restrict__ active, Cls c,
                           Bcs bc) {
  const int a = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.x * BX + threadIdx.x;
  for (int z = blockIdx.z; z < 2 * c.lanes; z += gridDim.z) {
    const int l = z / 2;
    if (!active[l]) continue;
    const size_t o = l * lane_cells(c);
    ifaces(u + o, v + o, w + o, lane_blk(c, ext, l), bc, a, b, z % 2);
  }
}

template <typename T>
__global__ void cls_kfaces_special(T* u, T* v, T* w,
                                   const int* __restrict__ ext,
                                   const uint8_t* __restrict__ active, Cls c,
                                   Bcs bc, int problem) {
  const int a = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.x * BX + threadIdx.x;
  for (int z = blockIdx.z; z < 3 * c.lanes; z += gridDim.z) {
    const int l = z / 3;
    if (!active[l]) continue;
    const size_t o = l * lane_cells(c);
    kfaces_special(u + o, v + o, w + o, lane_blk(c, ext, l), bc, problem, a,
                   b, z % 3);
  }
}

// the predictor's constants of lane l in T from its dx, dy, dz, as the JAX
// package's dynamic kernel forms them from its SMEM scalars
template <typename T>
__device__ __forceinline__ Coef<T> lane_coef(const T* __restrict__ geo,
                                             int l, T gamma, T inv_re, T gx,
                                             T gy, T gz) {
  const T idx = T(1) / geo[3 * l], idy = T(1) / geo[3 * l + 1],
          idz = T(1) / geo[3 * l + 2];
  return Coef<T>{idx * T(0.25), gamma * idx * T(0.25), idy * T(0.25),
                 gamma * idy * T(0.25), idz * T(0.25), gamma * idz * T(0.25),
                 idx * idx, idy * idy, idz * idz, inv_re, gx, gy, gz};
}

// launch 4: F, G, H of every cell of every lane's block (0 on an inactive
// lane); z = lane * (kc+2) + k
template <typename T>
__global__ void cls_fgh(const T* __restrict__ u, const T* __restrict__ v,
                        const T* __restrict__ w, const T* __restrict__ dt,
                        T* __restrict__ f, T* __restrict__ g,
                        T* __restrict__ h, const int* __restrict__ ext,
                        const T* __restrict__ geo,
                        const uint8_t* __restrict__ active, Cls c, T gamma,
                        T inv_re, T gx, T gy, T gz) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i > c.ic + 1 || j > c.jc + 1) return;
  for (int z = blockIdx.z; z < c.lanes * (c.kc + 2); z += gridDim.z) {
    const int l = z / (c.kc + 2), k = z % (c.kc + 2);
    const size_t o = l * lane_cells(c);
    if (!active[l]) {
      const size_t x = o + ((size_t)k * (c.jc + 2) + j) * (c.ic + 2) + i;
      f[x] = T(0);
      g[x] = T(0);
      h[x] = T(0);
      continue;
    }
    const Blk b = lane_blk(c, ext, l);
    fgh_cell(u + o, v + o, w + o, dt + l, f + o, g + o, h + o, b, b, 0,
             lane_coef(geo, l, gamma, inv_re, gx, gy, gz),
             (const uint8_t*)nullptr, i, j, k);
  }
}

// launch 5: rhs of every cell of every lane's block (0 on an inactive lane)
template <typename T>
__global__ void cls_rhs(const T* __restrict__ f, const T* __restrict__ g,
                        const T* __restrict__ h, const T* __restrict__ dt,
                        T* __restrict__ rhs, const int* __restrict__ ext,
                        const T* __restrict__ geo,
                        const uint8_t* __restrict__ active, Cls c) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i > c.ic + 1 || j > c.jc + 1) return;
  for (int z = blockIdx.z; z < c.lanes * (c.kc + 2); z += gridDim.z) {
    const int l = z / (c.kc + 2), k = z % (c.kc + 2);
    const size_t o = l * lane_cells(c);
    if (!active[l]) {
      rhs[o + ((size_t)k * (c.jc + 2) + j) * (c.ic + 2) + i] = T(0);
      continue;
    }
    rhs_cell(f + o, g + o, h + o, dt + l, rhs + o, lane_blk(c, ext, l),
             geo[3 * l], geo[3 * l + 1], geo[3 * l + 2], i, j, k);
  }
}

// POST launch 1: on an active lane the projection on its interior and the
// live-mask multiply of every cell; per-block maxima of |u|, |v|, |w| over
// each lane's live cells (every lane). Partials: lane l, field q, block b
// at (l * 3 + q) * nb + b, nb = the blocks of one lane.
template <typename T>
__global__ void cls_adapt(T* __restrict__ u, T* __restrict__ v,
                          T* __restrict__ w, const T* __restrict__ f,
                          const T* __restrict__ g, const T* __restrict__ h,
                          const T* __restrict__ p, const T* __restrict__ dt,
                          const int* __restrict__ ext,
                          const T* __restrict__ geo,
                          const uint8_t* __restrict__ active, Cls c,
                          T* __restrict__ partial) {
  __shared__ T shu[NT];
  __shared__ T shv[NT];
  __shared__ T shw[NT];
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const size_t W = c.ic + 2, P = (size_t)(c.jc + 2) * W;
  const size_t nb = (size_t)gridDim.x * gridDim.y * (c.kc + 2);
  for (int z = blockIdx.z; z < c.lanes * (c.kc + 2); z += gridDim.z) {
    const int l = z / (c.kc + 2), k = z % (c.kc + 2);
    T au = T(0), av = T(0), aw = T(0);
    if (i <= c.ic + 1 && j <= c.jc + 1) {
      const int K = ext[3 * l], J = ext[3 * l + 1], I = ext[3 * l + 2];
      const size_t x = l * lane_cells(c) + k * P + j * W + i;
      const bool live = k <= K + 1 && j <= J + 1 && i <= I + 1;
      T uu = u[x], vv = v[x], ww = w[x];
      if (active[l]) {
        if (k >= 1 && k <= K && j >= 1 && j <= J && i >= 1 && i <= I) {
          const T d = dt[l];
          const T pc = p[x];
          uu = f[x] - (p[x + 1] - pc) * (d / geo[3 * l]);
          vv = g[x] - (p[x + W] - pc) * (d / geo[3 * l + 1]);
          ww = h[x] - (p[x + P] - pc) * (d / geo[3 * l + 2]);
        }
        const T lm = live ? T(1) : T(0);
        uu = uu * lm;
        vv = vv * lm;
        ww = ww * lm;
        u[x] = uu;
        v[x] = vv;
        w[x] = ww;
      }
      if (live) {
        au = fabs(uu);
        av = fabs(vv);
        aw = fabs(ww);
      }
    }
    shu[tid] = au;
    shv[tid] = av;
    shw[tid] = aw;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (tid < s) {
        shu[tid] = nanmax(shu[tid], shu[tid + s]);
        shv[tid] = nanmax(shv[tid], shv[tid + s]);
        shw[tid] = nanmax(shw[tid], shw[tid + s]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      const size_t b =
          ((size_t)k * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      partial[(size_t)l * 3 * nb + b] = shu[0];
      partial[((size_t)l * 3 + 1) * nb + b] = shv[0];
      partial[((size_t)l * 3 + 2) * nb + b] = shw[0];
    }
    __syncthreads();
  }
}

// POST launch 2: block l reduces lane l's 3 * nb partials to out[q][l]
template <typename T>
__global__ void cls_max_partials(const T* __restrict__ partial, int nb,
                                 int lanes, T* __restrict__ out) {
  __shared__ T sh[3][FIN];
  const int l = blockIdx.x;
  partial += (size_t)l * 3 * nb;
  T m[3] = {T(0), T(0), T(0)};
  for (int k = threadIdx.x; k < nb; k += FIN)
    for (int q = 0; q < 3; ++q)
      m[q] = nanmax(m[q], partial[(size_t)q * nb + k]);
  for (int q = 0; q < 3; ++q) sh[q][threadIdx.x] = m[q];
  __syncthreads();
  for (int s = FIN / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int q = 0; q < 3; ++q)
        sh[q][threadIdx.x] = nanmax(sh[q][threadIdx.x], sh[q][threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0)
    for (int q = 0; q < 3; ++q) out[(size_t)q * lanes + l] = sh[q][0];
}

int zdim(long long n) { return (int)(n < ZMAX ? n : ZMAX); }

// c = [gamma, 1/re, gx, gy, gz]
template <typename T>
int run_pre_class(int dev, T* u, T* v, T* w, const T* dt, T* f, T* g, T* h,
                  T* rhs, const int* ext, const T* geo,
                  const uint8_t* active, Cls c, const int* bc, int problem,
                  const double* cf, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const Bcs b{bc[0], bc[1], bc[2], bc[3], bc[4], bc[5]};
  const int L0 = c.kc + 2, L1 = c.jc + 2, L2 = c.ic + 2;
  const dim3 blk(BX, BY);
  cls_jfaces<T><<<dim3(ceil_div(L2, BX), ceil_div(L0, BY),
                       zdim(2LL * c.lanes)), blk, 0, st>>>(u, v, w, ext,
                                                           active, c, b);
  cls_ifaces<T><<<dim3(ceil_div(L1, BX), ceil_div(L0, BY),
                       zdim(2LL * c.lanes)), blk, 0, st>>>(u, v, w, ext,
                                                           active, c, b);
  cls_kfaces_special<T><<<dim3(ceil_div(max2(L2, L1), BX),
                               ceil_div(max2(L1, L0), BY),
                               zdim(3LL * c.lanes)), blk, 0, st>>>(
      u, v, w, ext, active, c, b, problem);
  const dim3 grd(ceil_div(L2, BX), ceil_div(L1, BY),
                 zdim((long long)c.lanes * L0));
  cls_fgh<T><<<grd, blk, 0, st>>>(u, v, w, dt, f, g, h, ext, geo, active, c,
                                  T(cf[0]), T(cf[1]), T(cf[2]), T(cf[3]),
                                  T(cf[4]));
  cls_rhs<T><<<grd, blk, 0, st>>>(f, g, h, dt, rhs, ext, geo, active, c);
  return (int)cudaGetLastError();
}

template <typename T>
int run_post_class(int dev, T* u, T* v, T* w, const T* f, const T* g,
                   const T* h, const T* p, const T* dt, const int* ext,
                   const T* geo, const uint8_t* active, Cls c, T* partial,
                   T* out, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int L0 = c.kc + 2, L1 = c.jc + 2, L2 = c.ic + 2;
  const dim3 grd(ceil_div(L2, BX), ceil_div(L1, BY),
                 zdim((long long)c.lanes * L0));
  cls_adapt<T><<<grd, dim3(BX, BY), 0, st>>>(u, v, w, f, g, h, p, dt, ext,
                                             geo, active, c, partial);
  cls_max_partials<T><<<c.lanes, FIN, 0, st>>>(
      partial, (int)(grd.x * grd.y * L0), c.lanes, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-max buffer ns3d_post needs for a halo-1 block of
// local interior extents (lk, lj, li)
int ns3d_post_partials(int lk, int lj, int li) {
  return 3 * ceil_div(li + 2, BX) * ceil_div(lj + 2, BY) * (lk + 2);
}

// fl (uint8, the input block's shape) and the scratch us, vs, ws are
// null outside the flag mode
#define PRE_ENTRY(NAME, T)                                                   \
  int NAME(int dev, void* u, void* v, void* w, const void* dt, void* f,      \
           void* g, void* h, void* rhs, const int* l, const int* geo,        \
           const int* bc, int problem, const double* c, const void* fl,      \
           void* us, void* vs, void* ws, void* stream) {                     \
    return run_pre<T>(dev, (T*)u, (T*)v, (T*)w, (const T*)dt, (T*)f, (T*)g,  \
                      (T*)h, (T*)rhs, l, geo, bc, problem, c,                \
                      (const uint8_t*)fl, (T*)us, (T*)vs, (T*)ws, stream);   \
  }

#define POST_ENTRY(NAME, T)                                                  \
  int NAME(int dev, void* u, void* v, void* w, const void* f, const void* g, \
           const void* h, const void* p, const void* dt, const int* l,       \
           const int* geo, double dx, double dy, double dz, const void* fl,  \
           int ragged, void* partial, void* out, void* stream) {             \
    return run_post<T>(dev, (T*)u, (T*)v, (T*)w, (const T*)f, (const T*)g,   \
                       (const T*)h, (const T*)p, (const T*)dt, l, geo, dx,   \
                       dy, dz, (const uint8_t*)fl, ragged, (T*)partial,      \
                       (T*)out, stream);                                     \
  }

// the class mode: u, v, w, f, g, h, rhs, p lane-stacked (lanes, kc+2, jc+2,
// ic+2); ext int32 (lanes, 3) = [K, J, I]; geo (lanes, 3) = [dx, dy, dz];
// dt (lanes,); active uint8 (lanes,); c = [gamma, 1/re, gx, gy, gz]
#define PRE_CLASS_ENTRY(NAME, T)                                             \
  int NAME(int dev, void* u, void* v, void* w, const void* dt, void* f,      \
           void* g, void* h, void* rhs, const void* ext, const void* geo,    \
           const void* active, int lanes, int kc, int jc, int ic,            \
           const int* bc, int problem, const double* c, void* stream) {      \
    return run_pre_class<T>(dev, (T*)u, (T*)v, (T*)w, (const T*)dt, (T*)f,   \
                            (T*)g, (T*)h, (T*)rhs, (const int*)ext,          \
                            (const T*)geo, (const uint8_t*)active,           \
                            Cls{lanes, kc, jc, ic}, bc, problem, c, stream); \
  }

// partial: lanes * ns3d_post_partials(kc, jc, ic); out (3, lanes)
#define POST_CLASS_ENTRY(NAME, T)                                            \
  int NAME(int dev, void* u, void* v, void* w, const void* f, const void* g, \
           const void* h, const void* p, const void* dt, const void* ext,    \
           const void* geo, const void* active, int lanes, int kc, int jc,   \
           int ic, void* partial, void* out, void* stream) {                 \
    return run_post_class<T>(dev, (T*)u, (T*)v, (T*)w, (const T*)f,         \
                             (const T*)g, (const T*)h, (const T*)p,          \
                             (const T*)dt, (const int*)ext, (const T*)geo,   \
                             (const uint8_t*)active, Cls{lanes, kc, jc, ic}, \
                             (T*)partial, (T*)out, stream);                  \
  }

PRE_CLASS_ENTRY(ns3d_pre_class_f32, float)
PRE_CLASS_ENTRY(ns3d_pre_class_f64, double)
POST_CLASS_ENTRY(ns3d_post_class_f32, float)
POST_CLASS_ENTRY(ns3d_post_class_f64, double)
PRE_ENTRY(ns3d_pre_f32, float)
PRE_ENTRY(ns3d_pre_f64, double)
POST_ENTRY(ns3d_post_f32, float)
POST_ENTRY(ns3d_post_f64, double)

}  // extern "C"
