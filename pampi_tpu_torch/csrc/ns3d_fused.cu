// NS-3D step phases for Hopper (sm_90a): the port's PRE and POST kernels,
// single device, no obstacles.
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
//        tangentially clipped to the interior, so the write sets are
//        disjoint, and the only writes another face reads are the normal
//        components on the HI walls (index max, inside the others'
//        tangential ranges): top's v(., J, .) is read by the i and k faces,
//        right's u(., ., I) by the k faces and, as the OLD value, by the j
//        faces; back's w(K, ., .) is read, old, by the j and i faces. The
//        two faces of one axis read and write disjoint planes when the
//        axis has at least 2 interior cells (the wrapper requires it). So
//        these three launches reproduce the six ordered faces exactly. The
//        special BC writes u(., J+1, .) (lid, after top) or u(., ., 0)
//        (inflow, after left), which the k faces neither read nor write.
//   4.   F, G and H for every cell of the ghosted array, wall fixups
//        included.
//   5.   rhs, which reads F(i-1), G(j-1), H(k-1) of neighbouring blocks.
// POST is one launch (the projection reads only p neighbours, so u, v, w
// update in place) that also writes per-block partial maxima, and a
// one-block launch that reduces them. max is exact in any order, so the
// maxima equal the plain version's bitwise; NaN propagates as in
// torch.max. dt stays on the device (a pointer), so no launch waits for
// the host.
//
// Every formula keeps the association of pampi_tpu/ops/ns3d.py term for
// term; scalar coefficients are formed in double on the host exactly where
// the reference forms them from Python floats, then rounded to T. Built
// with --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int NOSLIP = 1, SLIP = 2, OUTFLOW = 3;
constexpr int DCAVITY = 1, CANAL = 2;
constexpr int BX = 32, BY = 8, NT = BX * BY;
constexpr int FIN = 1024;

// bc[] order: top, bottom, left, right, front, back (the reference's)
struct Bcs {
  int top, bottom, left, right, front, back;
};

template <typename T>
struct Coef {
  T idx4, gidx4, idy4, gidy4, idz4, gidz4, idx2, idy2, idz2, inv_re, gx, gy,
      gz;
};

// the BC of one face at one tangential position: `wall`/`wall_in` index the
// normal component n, `ghost`/`ghost_in` the tangential components t1, t2
template <typename T>
__device__ __forceinline__ void face(int kind, T* n, T* t1, T* t2,
                                     size_t wall, size_t wall_in,
                                     size_t ghost, size_t ghost_in) {
  if (kind == NOSLIP) {
    n[wall] = T(0);
    t1[ghost] = -t1[ghost_in];
    t2[ghost] = -t2[ghost_in];
  } else if (kind == SLIP) {
    n[wall] = T(0);
    t1[ghost] = t1[ghost_in];
    t2[ghost] = t2[ghost_in];
  } else if (kind == OUTFLOW) {
    n[wall] = n[wall_in];
    t1[ghost] = t1[ghost_in];
    t2[ghost] = t2[ghost_in];
  }
}

// launch 1: top (z = 0) and bottom (z = 1) at (k, i) = 1 + (y, x)
template <typename T>
__global__ void bc_jfaces(T* u, T* v, T* w, int K, int J, int I, Bcs bc) {
  const int k = 1 + blockIdx.y * BY + threadIdx.y;
  const int i = 1 + blockIdx.x * BX + threadIdx.x;
  if (k > K || i > I) return;
  const size_t W = I + 2, P = (size_t)(J + 2) * W;
  const size_t base = k * P + i;
  if (blockIdx.z == 0)  // top: v on the wall j = J, ghosts at J+1
    face(bc.top, v, u, w, base + J * W, base + (J - 1) * W,
         base + (J + 1) * W, base + J * W);
  else  // bottom: v on the wall j = 0, ghosts at 0
    face(bc.bottom, v, u, w, base, base + W, base, base + W);
}

// launch 2: left (z = 0) and right (z = 1) at (k, j) = 1 + (y, x)
template <typename T>
__global__ void bc_ifaces(T* u, T* v, T* w, int K, int J, int I, Bcs bc) {
  const int k = 1 + blockIdx.y * BY + threadIdx.y;
  const int j = 1 + blockIdx.x * BX + threadIdx.x;
  if (k > K || j > J) return;
  const size_t W = I + 2, P = (size_t)(J + 2) * W;
  const size_t base = k * P + j * W;
  if (blockIdx.z == 0)  // left: u on the wall i = 0, ghosts at 0
    face(bc.left, u, v, w, base, base + 1, base, base + 1);
  else  // right: u on the wall i = I, ghosts at I+1
    face(bc.right, u, v, w, base + I, base + I - 1, base + I + 1, base + I);
}

// launch 3: front (z = 0) and back (z = 1) at (j, i) = 1 + (y, x), and the
// special BC (z = 2): the dcavity lid at (k, i) = 1 + (y, x), skipping the
// last interior k and i, or the canal inflow at (k, j) = 1 + (y, x)
template <typename T>
__global__ void bc_kfaces_special(T* u, T* v, T* w, int K, int J, int I,
                                  Bcs bc, int problem) {
  const int a = 1 + blockIdx.y * BY + threadIdx.y;
  const int b = 1 + blockIdx.x * BX + threadIdx.x;
  const size_t W = I + 2, P = (size_t)(J + 2) * W;
  if (blockIdx.z < 2) {
    if (a > J || b > I) return;
    const size_t base = a * W + b;
    if (blockIdx.z == 0)  // front: w on the wall k = 0, ghosts at 0
      face(bc.front, w, u, v, base, base + P, base, base + P);
    else  // back: w on the wall k = K, ghosts at K+1
      face(bc.back, w, u, v, base + K * P, base + (K - 1) * P,
           base + (K + 1) * P, base + K * P);
  } else if (problem == DCAVITY) {
    if (a > K - 1 || b > I - 1) return;
    const size_t x = a * P + (size_t)J * W + b;
    u[x + W] = T(2) - u[x];
  } else if (problem == CANAL) {
    if (a > K || b > J) return;
    u[a * P + b * W] = T(2);
  }
}

// launch 4: F, G, H for every cell of the ghosted array
template <typename T>
__global__ void fgh_cells(const T* __restrict__ u, const T* __restrict__ v,
                          const T* __restrict__ w, const T* __restrict__ dtp,
                          T* __restrict__ f, T* __restrict__ g,
                          T* __restrict__ h, int K, int J, int I, Coef<T> c) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i > I + 1 || j > J + 1) return;
  const size_t W = I + 2, P = (size_t)(J + 2) * W;
  const size_t x = k * P + j * W + i;
  const bool in_i = i >= 1 && i <= I;
  const bool in_j = j >= 1 && j <= J;
  const bool in_k = k >= 1 && k <= K;
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
  // k walls (tangentially the interior)
  if (in_j && in_k && (i == 0 || i == I)) fv = u[x];
  if (in_i && in_k && (j == 0 || j == J)) gv = v[x];
  if (in_i && in_j && (k == 0 || k == K)) hv = w[x];
  f[x] = fv;
  g[x] = gv;
  h[x] = hv;
}

// launch 5: rhs = div(F, G, H)/dt on the interior, zero elsewhere
template <typename T>
__global__ void rhs_cells(const T* __restrict__ f, const T* __restrict__ g,
                          const T* __restrict__ h, const T* __restrict__ dtp,
                          T* __restrict__ rhs, int K, int J, int I, T dx,
                          T dy, T dz) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i > I + 1 || j > J + 1) return;
  const size_t W = I + 2, P = (size_t)(J + 2) * W;
  const size_t x = k * P + j * W + i;
  T r = T(0);
  if (i >= 1 && i <= I && j >= 1 && j <= J && k >= 1 && k <= K) {
    const T inv_dt = T(1) / *dtp;
    r = ((f[x] - f[x - 1]) / dx + (g[x] - g[x - W]) / dy +
         (h[x] - h[x - P]) / dz) *
        inv_dt;
  }
  rhs[x] = r;
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
                            int K, int J, int I, T dx, T dy, T dz,
                            T* __restrict__ partial) {
  __shared__ T shu[NT];
  __shared__ T shv[NT];
  __shared__ T shw[NT];
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  const int tid = threadIdx.y * BX + threadIdx.x;
  T au = T(0), av = T(0), aw = T(0);
  if (i <= I + 1 && j <= J + 1) {
    const size_t W = I + 2, P = (size_t)(J + 2) * W;
    const size_t x = k * P + j * W + i;
    T uu, vv, ww;
    if (i >= 1 && i <= I && j >= 1 && j <= J && k >= 1 && k <= K) {
      const T dt = *dtp;
      const T pc = p[x];
      uu = f[x] - (p[x + 1] - pc) * (dt / dx);
      vv = g[x] - (p[x + W] - pc) * (dt / dy);
      ww = h[x] - (p[x + P] - pc) * (dt / dz);
      u[x] = uu;
      v[x] = vv;
      w[x] = ww;
    } else {  // ghost cells keep u, v, w and count for the maxima
      uu = u[x];
      vv = v[x];
      ww = w[x];
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

dim3 cell_grid(int K, int J, int I) {
  return dim3((I + 2 + BX - 1) / BX, (J + 2 + BY - 1) / BY, K + 2);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int run_pre(int dev, T* u, T* v, T* w, const T* dt, T* f, T* g, T* h, T* rhs,
            int K, int J, int I, const int* bc, int problem, const double* c,
            void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const Bcs b{bc[0], bc[1], bc[2], bc[3], bc[4], bc[5]};
  const dim3 blk(BX, BY);
  bc_jfaces<T><<<dim3(ceil_div(I, BX), ceil_div(K, BY), 2), blk, 0, st>>>(
      u, v, w, K, J, I, b);
  bc_ifaces<T><<<dim3(ceil_div(J, BX), ceil_div(K, BY), 2), blk, 0, st>>>(
      u, v, w, K, J, I, b);
  const int xa = I > J ? I : J, ya = J > K ? J : K;
  bc_kfaces_special<T><<<dim3(ceil_div(xa, BX), ceil_div(ya, BY), 3), blk, 0,
                         st>>>(u, v, w, K, J, I, b, problem);
  // c = [idx*0.25, gamma*idx*0.25, idy*0.25, gamma*idy*0.25, idz*0.25,
  //      gamma*idz*0.25, idx*idx, idy*idy, idz*idz, 1/re, gx, gy, gz,
  //      dx, dy, dz]
  const Coef<T> k{T(c[0]), T(c[1]), T(c[2]),  T(c[3]),  T(c[4]),
                  T(c[5]), T(c[6]), T(c[7]),  T(c[8]),  T(c[9]),
                  T(c[10]), T(c[11]), T(c[12])};
  const dim3 grd = cell_grid(K, J, I);
  fgh_cells<T><<<grd, blk, 0, st>>>(u, v, w, dt, f, g, h, K, J, I, k);
  rhs_cells<T><<<grd, blk, 0, st>>>(f, g, h, dt, rhs, K, J, I, T(c[13]),
                                    T(c[14]), T(c[15]));
  return (int)cudaGetLastError();
}

template <typename T>
int run_post(int dev, T* u, T* v, T* w, const T* f, const T* g, const T* h,
             const T* p, const T* dt, int K, int J, int I, double dx,
             double dy, double dz, T* partial, T* out, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grd = cell_grid(K, J, I);
  adapt_cells<T><<<grd, dim3(BX, BY), 0, st>>>(u, v, w, f, g, h, p, dt, K, J,
                                               I, T(dx), T(dy), T(dz),
                                               partial);
  max_partials<T><<<1, FIN, 0, st>>>(partial, (int)(grd.x * grd.y * grd.z),
                                     out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// length of the partial-max buffer ns3d_post needs
int ns3d_post_partials(int K, int J, int I) {
  const dim3 g = cell_grid(K, J, I);
  return 3 * (int)(g.x * g.y * g.z);
}

#define PRE_ENTRY(NAME, T)                                                   \
  int NAME(int dev, void* u, void* v, void* w, const void* dt, void* f,      \
           void* g, void* h, void* rhs, int K, int J, int I, const int* bc,  \
           int problem, const double* c, void* stream) {                     \
    return run_pre<T>(dev, (T*)u, (T*)v, (T*)w, (const T*)dt, (T*)f, (T*)g,  \
                      (T*)h, (T*)rhs, K, J, I, bc, problem, c, stream);      \
  }

#define POST_ENTRY(NAME, T)                                                  \
  int NAME(int dev, void* u, void* v, void* w, const void* f, const void* g, \
           const void* h, const void* p, const void* dt, int K, int J,       \
           int I, double dx, double dy, double dz, void* partial, void* out, \
           void* stream) {                                                   \
    return run_post<T>(dev, (T*)u, (T*)v, (T*)w, (const T*)f, (const T*)g,   \
                       (const T*)h, (const T*)p, (const T*)dt, K, J, I, dx,  \
                       dy, dz, (T*)partial, (T*)out, stream);                \
  }

PRE_ENTRY(ns3d_pre_f32, float)
PRE_ENTRY(ns3d_pre_f64, double)
POST_ENTRY(ns3d_post_f32, float)
POST_ENTRY(ns3d_post_f64, double)

}  // extern "C"
