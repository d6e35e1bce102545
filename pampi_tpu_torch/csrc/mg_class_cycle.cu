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
// class block (jc+2, ic+2); level l >= 1 is stored at ((jc>>l)+2) x
// ((ic>>l)+2). Down every live level: n_pre red-black omega = 1 sweeps
// (red half, black half, then the Neumann copy of the faces, corners
// untouched) and, if the next level is live, the restriction (each coarse
// cell the mean of its four fine residuals, summed j-major with i fastest;
// zero coarse ghosts; coarse p = 0). At the deepest live level the
// corner's cells go through p + 0 (the TPU kernel's up-pass add of a
// masked zero, which turns a -0.0 into +0.0), then n_bottom extra sweeps
// stand in for a direct bottom solve. Up every level above it: p += the
// coarse correction prolonged piecewise-constant on the interior (+0 on
// the ring), the Neumann copy, n_post sweeps; the deepest level also takes
// its n_post sweeps. Last, the fine residual's sum of squares. Levels past
// the deepest live one are skipped: on the TPU they are gated no-ops that
// leave every value unchanged. A lane whose `active` flag is 0 passes p
// through and returns rsq 0. Cells of the class block outside the lane's
// live corner are copied.
//
// What bounds it on the H100: neither bytes nor operations at the class
// sizes the fleet serves (the bound the port records is bytes: fine p and
// rhs read, p written, every live coarser level once, over 3.35 TB/s). A
// cycle is a chain of dependent phases, each a pass over at most a level's
// cells; what it costs is the shared-memory traffic and the issue of the
// colour phases (two CTAs an SM), their barriers, the copies in and out
// and, on a cluster, the reads of the neighbours' edge rows (PERF.md §6:
// the phases' clock64() trace).
//
// Design: a lane's levels live in shared memory, and a big lane is spread
// over a thread block cluster. A lane is C CTAs (a cluster of C; C = 1 is
// a plain CTA). Level l < Lb is banded: CTA r owns storage rows [r*B_l,
// (r+1)*B_l), B_l = ceil(rows_l / C), in its shared memory (or, where bit l
// of gmask is set, in device memory: level 0 in `out` and `rhs`, coarser
// ones in the lane's `work`). Levels l >= Lb are whole in CTA 0's shared
// memory. Every CTA of a cluster has the same layout, so a row of a band
// that another CTA owns is that CTA's copy of the same offset, read (or,
// by a restriction, written) through distributed shared memory. A phase
// on a banded level runs over the rows each CTA owns (a warp a row, its
// lanes along the row) and ends in a cluster barrier; the restriction
// writes coarse row jc from the CTA owning fine row max(2 jc - 1, 0), the
// prolongation reads the coarse row a fine row needs, wherever it lies.
// CTA 0 runs the levels l >= Lb, down and up, with block barriers, while
// the others wait at the next cluster barrier. The capacity rule in the
// wrapper (ops/mg_fused.class_cycle_form) picks C, Lb and gmask from the
// class and the dtype: one CTA where every level fits its shared memory
// (a 64^2 class: 47 KB at float32), else a cluster of 8 with the small
// levels in CTA 0 and, past the shared memory, the finest levels in L2.
// The level table and the lane's plan sit in shared memory too.
//
// The Neumann copy is folded into the reads: the plain version copies
// each face from its interior neighbour after every sweep and after every
// prolongation, and the only reader of a face is that neighbour, so once
// such a copy is due (a level's ghosts are stale) a neighbour across a
// wall reads the cell itself, which is exactly the value the copy would
// have written; the kernel writes level 0's faces once, at the end. A
// sweep is two phases, not three, and the restriction and the residual
// fold the same way.
//
// Colour half-sweeps update in place (a colour reads only the other
// colour), the restriction computes its four fine residuals itself (no
// residual field): every cell gets the same operations in the same order
// whatever the form, so the fields are bitwise the plain version's. The
// fine residual sum keeps the single-CTA order: thread t of NT adds r^2
// of interior cells t, t + NT, ... (row-major over the live interior) in
// turn, then a halving tree over the NT threads; on a cluster every CTA
// first leaves each cell's r^2 in its rhs slot, then the sum is a chain,
// CTA r continuing each thread's sum over its own rows from CTA r - 1's,
// one cluster barrier a link. The order depends on the live extents only,
// not on the class or the form, so a lane gives the same bits in every
// rung; the plain version (ops/mg_fused.class_cycle_plain) repeats it, so
// kernel and plain version agree bitwise, residual included. No float
// atomics.
//
// Arithmetic keeps the plain version's association term for term:
//   lap = (e - 2c + w)*idx2 + (n - 2c + s)*idy2,  p = c - factor*(rhs - lap)
//   rc  = (((r00 + r01) + r10) + r11) / 4,        out = p + e_coarse
// built with --fmad=false so no multiply-add is contracted.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;    // threads of a CTA (the residual sum's order)
constexpr int NW = NT / 32;
constexpr int MAXL = 16;   // deepest plan the level table holds

// one level of a lane as this CTA sees it
template <typename T>
struct Lvl {
  int J, I;       // live extents (clamped to the storage)
  int W;          // row stride of the storage
  int B;          // rows a band holds (the whole level where not banded)
  int lo, hi;     // storage rows this CTA owns
  int base;       // the storage row at p (lo in shared memory, else 0)
  bool shared;    // in shared memory (else device memory)
  bool remote;    // banded over a cluster: rows past the band lie elsewhere
  T* p;           // this CTA's copy of its band, or the level's row 0
  T* r;
};

template <bool CLUSTER, typename T>
__device__ __forceinline__ T* row_of(const Lvl<T>& a, T* base, int row) {
  if (!CLUSTER || !a.shared || (row >= a.lo && row < a.hi))
    return base + (row - a.base) * a.W;
  // the owner's band starts at the same offset of its shared memory
  const int owner = row / a.B;
  return cg::this_cluster().map_shared_rank(
      base + (row - owner * a.B) * a.W, owner);
}

template <bool CLUSTER, typename T>
__device__ __forceinline__ T* prow(const Lvl<T>& a, int row) {
  return row_of<CLUSTER>(a, a.p, row);
}

template <bool CLUSTER, typename T>
__device__ __forceinline__ T* rrow(const Lvl<T>& a, int row) {
  return row_of<CLUSTER>(a, a.r, row);
}

// the rows of level a around row j: p rows j - 1, j, j + 1 and rhs row j,
// from the band's own storage where it holds them, else through prow
template <typename T>
struct Rows {
  const T* s;
  T* c;
  const T* n;
  const T* r;
};

template <bool CLUSTER, typename T>
__device__ __forceinline__ Rows<T> rows_at(const Lvl<T>& a, int j) {
  if (!a.remote || (j > a.lo && j + 1 < a.hi)) {
    const int x = (j - a.base) * a.W;
    return {a.p + x - a.W, a.p + x, a.p + x + a.W, a.r + x};
  }
  return {prow<CLUSTER>(a, j - 1), prow<CLUSTER>(a, j),
          prow<CLUSTER>(a, j + 1), rrow<CLUSTER>(a, j)};
}

// the residual rhs - lap at (j, i) of level a; with `fold` a neighbour
// across a wall reads the cell itself (the Neumann ghost that the plain
// version writes after every sweep holds exactly that value; the kernel
// writes the ghosts once, at the end)
template <typename T>
__device__ __forceinline__ T resid(const Rows<T>& q, int j, int i, int J,
                                   int I, bool fold, T idx2, T idy2) {
  const T c = q.c[i];
  T w = q.c[i - 1], e = q.c[i + 1], s = q.s[i], n = q.n[i];
  if (fold) {
    w = i == 1 ? c : w;
    e = i == I ? c : e;
    s = j == 1 ? c : s;
    n = j == J ? c : n;
  }
  return q.r[i] - ((e - T(2) * c + w) * idx2 + (n - T(2) * c + s) * idy2);
}

// Every phase gives each warp rows of the level (a row to a warp) and each
// lane the row's cells 32 apart, their addresses an add from the row's.
// The colour phases take U rows (or pairs of rows) a warp and V cells a
// lane of each at a time, their loads first and their stores after
// (within a phase no cell reads another that the phase writes, so the
// order of the cells is free). On a level held whole by one CTA each
// half-warp takes a row of a pair, j and j + 1, and its lanes the colour's
// cells 16 apart: the rows' strides are even, so row j's cells of the
// colour (every other column) and row j + 1's fall in the even and the
// odd banks, and so do all their neighbours, and a warp's loads are free
// of bank conflicts (a row to a warp reads at stride 2: two-way
// conflicts). On a banded level a warp keeps a whole row, so that only
// the warps at the band's edge rows read across the cluster, and their
// U x V loads overlap.
constexpr int U = 2;
constexpr int V = 2;

// U x V cells of the colour: rows jr[u], columns i0[u] + 2 (cb + S v)
template <int S, typename T>
__device__ __forceinline__ void colour_batch(const Rows<T>* q, const int* jr,
                                             const int* i0, int j1, int cb,
                                             int J, int I, bool fold,
                                             T factor, T idx2, T idy2) {
  T val[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = i0[u] + 2 * (cb + S * v);
      if (jr[u] < j1 && i <= I)
        val[u][v] = q[u].c[i] - factor * resid(q[u], jr[u], i, J, I, fold,
                                               idx2, idy2);
    }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = i0[u] + 2 * (cb + S * v);
      if (jr[u] < j1 && i <= I) q[u].c[i] = val[u][v];
    }
}

// one colour in place over the CTA's interior rows: cells with
// (i + j) % 2 == par
template <bool CLUSTER, typename T>
__device__ void colour(const Lvl<T> a, int par, bool fold, const T* g) {
  const T idx2 = g[0], idy2 = g[1], factor = g[2];
  const int j0 = max(a.lo, 1), j1 = min(a.hi, a.J + 1);
  const int w = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int hw = (a.I + 1) >> 1;
  // pairs of rows (a half-warp a row) or rows (a warp a row)
  const bool pairs = !a.remote;
  const int rows = pairs ? 2 : 1;
  const int c0 = pairs ? ln % 16 : ln, half = pairs ? ln / 16 : 0;
  for (int jp = j0 + rows * w; jp < j1; jp += rows * NW * U) {
    Rows<T> q[U];
    int jr[U], i0[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      jr[u] = jp + rows * NW * u + half;
      i0[u] = ((1 + jr[u]) & 1) == par ? 1 : 2;
      if (jr[u] < j1) q[u] = rows_at<CLUSTER>(a, jr[u]);
    }
    if (pairs)
      for (int cb = c0; cb < hw; cb += 16 * V)
        colour_batch<16>(q, jr, i0, j1, cb, a.J, a.I, fold, factor, idx2,
                         idy2);
    else
      for (int cb = c0; cb < hw; cb += 32 * V)
        colour_batch<32>(q, jr, i0, j1, cb, a.J, a.I, fold, factor, idx2,
                         idy2);
  }
}

// n values from src to dst, NT threads, V loads in flight a thread
template <typename T>
__device__ void copy_cells(T* __restrict__ dst, const T* __restrict__ src,
                           int n) {
  for (int k0 = threadIdx.x; k0 < n; k0 += V * NT) {
    T v[V];
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (k0 + u * NT < n) v[u] = src[k0 + u * NT];
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (k0 + u * NT < n) dst[k0 + u * NT] = v[u];
  }
}

// n red-black sweeps; the first of a level whose ghosts are current reads
// them, every later one folds them (`stale` bit l: the plain version's
// Neumann copy has run since the kernel last wrote level l's ghosts)
template <bool CLUSTER, typename T, typename Sync>
__device__ void smooth(const Lvl<T> a, int l, const T* g, int n,
                       unsigned& stale, Sync sync) {
  for (int s = 0; s < n; ++s) {
    const bool fold = (stale >> l) & 1u;
    colour<CLUSTER>(a, 0, fold, g);
    sync();
    colour<CLUSTER>(a, 1, fold, g);
    sync();
    stale |= 1u << l;
  }
}

// fine level f -> coarse level c: rhs_c = the mean of four fine residuals
// on the interior, 0 on the ring; p_c = 0. Coarse row jc is written by
// the CTA owning fine row max(2 jc - 1, 0)
template <bool CLUSTER, typename T>
__device__ void restrict_level(const Lvl<T> f, bool fold, const T* g,
                               const Lvl<T> c) {
  if (f.lo >= f.hi) return;
  const T idx2 = g[0], idy2 = g[1];
  const int jc0 = f.lo == 0 ? 0 : (f.lo + 2) / 2;
  const int jc1 = min(f.hi / 2 + 1, c.J + 2);
  const int w = threadIdx.x / 32, ln = threadIdx.x % 32;
  for (int jc = jc0 + w; jc < jc1; jc += NW) {
    T* pc = prow<CLUSTER>(c, jc);
    T* rc = rrow<CLUSTER>(c, jc);
    if (jc < 1 || jc > c.J) {
      for (int ic = ln; ic <= c.I + 1; ic += 32) pc[ic] = rc[ic] = T(0);
      continue;
    }
    const int j = 2 * jc - 1;
    const Rows<T> q0 = rows_at<CLUSTER>(f, j), q1 = rows_at<CLUSTER>(f, j + 1);
    for (int ic = ln; ic <= c.I + 1; ic += 32) {
      T v = T(0);
      if (ic >= 1 && ic <= c.I) {
        const int i = 2 * ic - 1;
        T s = resid(q0, j, i, f.J, f.I, fold, idx2, idy2);
        s = s + resid(q0, j, i + 1, f.J, f.I, fold, idx2, idy2);
        s = s + resid(q1, j + 1, i, f.J, f.I, fold, idx2, idy2);
        s = s + resid(q1, j + 1, i + 1, f.J, f.I, fold, idx2, idy2);
        v = s / T(4);
      }
      pc[ic] = T(0);
      rc[ic] = v;
    }
  }
}

// p += the child's p prolonged on the interior, p + 0 on the ring;
// without a child every cell takes p + 0, which only turns -0.0 into +0.0
template <bool CLUSTER, typename T>
__device__ void prolong_add(const Lvl<T> a, bool child, const Lvl<T> c) {
  const int j0 = max(a.lo, 0), j1 = min(a.hi, a.J + 2);
  const int w = threadIdx.x / 32, ln = threadIdx.x % 32;
  for (int j = j0 + w; j < j1; j += NW) {
    T* p0 = prow<CLUSTER>(a, j);
    const bool jin = child && j >= 1 && j <= a.J;
    const T* pc = jin ? prow<CLUSTER>(c, (j + 1) >> 1) : nullptr;
    for (int i = ln; i <= a.I + 1; i += 32) {
      const T v = p0[i];
      p0[i] = jin && i >= 1 && i <= a.I ? v + pc[(i + 1) >> 1]
                                        : (v == T(0) ? T(0) : v);
    }
  }
}

// the levels first .. L-1 of the cycle's down leg from `first` and its up
// leg back to `first` (CTA 0's levels, with block barriers)
template <bool CLUSTER, typename T>
__device__ void local_cycle(const Lvl<T>* lv, const T* g, int first, int L,
                            int n_pre, int n_post, int n_bottom,
                            unsigned& stale) {
  const auto bar = [] { __syncthreads(); };
  for (int l = first; l < L; ++l) {
    smooth<CLUSTER>(lv[l], l, g + 3 * l, n_pre, stale, bar);
    if (l + 1 < L) {
      restrict_level<CLUSTER>(lv[l], (stale >> l) & 1u, g + 3 * l,
                              lv[l + 1]);
      stale &= ~(1u << (l + 1));
      __syncthreads();
    }
  }
  for (int l = L - 1; l >= first; --l) {
    const bool child = l + 1 < L;
    prolong_add<CLUSTER>(lv[l], child, lv[child ? l + 1 : l]);
    __syncthreads();
    if (child)
      stale |= 1u << l;
    else
      smooth<CLUSTER>(lv[l], l, g + 3 * l, n_bottom, stale, bar);
    smooth<CLUSTER>(lv[l], l, g + 3 * l, n_post, stale, bar);
  }
}

// form = [C, Lb, gmask]: CTAs a lane, banded levels, levels in device
// memory (bit l); the shared-memory layout follows from the class, the
// dtype and the form (ops/mg_fused.class_cycle_form computes the same)
template <bool CLUSTER, typename T>
__global__ void __launch_bounds__(NT, 2)
    class_cycle(const T* __restrict__ pin, const T* __restrict__ rhs,
                T* out, const int* __restrict__ ext,
                const T* __restrict__ geo, const int* __restrict__ active,
                T* work, T* __restrict__ rsq, int jc, int ic, int lmax,
                size_t lane_work, int C, int Lb, int gmask, int n_pre,
                int n_post, int n_bottom) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sh[NT];
  __shared__ T carry[NT];
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int lane = blockIdx.x / C;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)(jc + 2) * (ic + 2);
  const int W0 = ic + 2;
  const int B0 = (jc + 2 + C - 1) / C;
  const int lo0 = min(rank * B0, jc + 2), hi0 = min(lo0 + B0, jc + 2);
  const T* src = pin + lane * plane;
  T* p0 = out + lane * plane;
  const auto csync = [] {
    if constexpr (CLUSTER)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  if (!active[lane]) {
    for (size_t k = (size_t)lo0 * W0 + tid; k < (size_t)hi0 * W0; k += NT)
      p0[k] = src[k];
    if (rank == 0 && tid == 0) rsq[lane] = T(0);
    return;
  }
  // the level table and the lane's geometry, the same for every thread of
  // the CTA, in shared memory (a per-thread copy would live in local
  // memory, which the big shared-memory forms leave without L1 room)
  __shared__ Lvl<T> lv[MAXL];
  __shared__ T g[3 * MAXL];
  __shared__ int e[3 * MAXL];
  __shared__ int nlive;
  if (tid < 3 * lmax) {
    g[tid] = geo[(size_t)lane * lmax * 3 + tid];
    e[tid] = ext[(size_t)lane * lmax * 3 + tid];
  }
  __syncthreads();
  if (tid == 0) {
    T* sm = reinterpret_cast<T*>(smem);
    T* wk = work + lane * lane_work;
    int L = 0;
    for (int l = 0; l < lmax; ++l) {
      const int cj = jc >> l, ci = ic >> l, rows = cj + 2;
      Lvl<T>& a = lv[l];
      a.W = ci + 2;
      const bool banded = l < Lb;
      a.B = banded ? (rows + C - 1) / C : rows;
      a.lo = min(rank * a.B, rows);
      a.hi = min(a.lo + a.B, rows);
      a.shared = !((gmask >> l) & 1);
      a.base = a.shared ? a.lo : 0;
      a.remote = CLUSTER && a.shared && banded;
      if (a.shared) {
        a.p = sm;
        a.r = sm + (size_t)a.B * a.W;
        sm += 2 * (size_t)a.B * a.W;
      } else if (l == 0) {
        a.p = p0;
        a.r = const_cast<T*>(rhs) + lane * plane;
      } else {
        a.p = wk;
        a.r = wk + (size_t)rows * a.W;
      }
      if (l > 0) wk += 2 * (size_t)rows * a.W;
      // live extents, clamped to the storage: a plan past the class never
      // writes out of bounds (the wrappers refuse such lanes before the
      // launch)
      if (L == l && (l == 0 || e[3 * l + 2] != 0)) {
        a.J = min(max(e[3 * l], 1), cj);
        a.I = min(max(e[3 * l + 1], 1), ci);
        L = l + 1;
      }
    }
    nlive = L;
  }
  __syncthreads();
  const int L = nlive;
  // level 0 in: this CTA's band of the class block
  {
    const Lvl<T> a = lv[0];
    const size_t x = (size_t)a.lo * W0;
    const int n = (a.hi - a.lo) * W0;
    if (a.shared) {
      copy_cells(a.p, src + x, n);
      copy_cells(a.r, rhs + lane * plane + x, n);
    } else {
      copy_cells(p0 + x, src + x, n);
    }
  }
  const int Lband = min(Lb, L);
  // bit l: level l's ghosts in memory are stale (the plain version's
  // Neumann copy has run since); every thread tracks the same bits
  unsigned stale = 0u;
  csync();
  for (int l = 0; l < Lband; ++l) {
    smooth<CLUSTER>(lv[l], l, g + 3 * l, n_pre, stale, csync);
    if (l + 1 < L) {
      restrict_level<CLUSTER>(lv[l], (stale >> l) & 1u, g + 3 * l,
                              lv[l + 1]);
      stale &= ~(1u << (l + 1));
      csync();
    }
  }
  if (Lband < L) {
    if (rank == 0)
      local_cycle<CLUSTER>(lv, g, Lband, L, n_pre, n_post, n_bottom, stale);
    csync();
  }
  for (int l = Lband - 1; l >= 0; --l) {
    const bool child = l + 1 < L;
    prolong_add<CLUSTER>(lv[l], child, lv[child ? l + 1 : l]);
    csync();
    if (child)
      stale |= 1u << l;
    else
      smooth<CLUSTER>(lv[l], l, g + 3 * l, n_bottom, stale, csync);
    smooth<CLUSTER>(lv[l], l, g + 3 * l, n_post, stale, csync);
  }
  // level 0 out: this CTA's band of the class block; then, where stale,
  // the live faces the Neumann copy of their interior neighbours (corners
  // as they are)
  const Lvl<T> a = lv[0];
  const bool fold = stale & 1u;
  if (a.shared) copy_cells(p0 + (size_t)a.lo * W0, a.p, (a.hi - a.lo) * W0);
  if (fold) {
    __syncthreads();
    const int nr = (a.lo <= 0 && 0 < a.hi ? a.I : 0);
    const int ns = (a.lo <= a.J + 1 && a.J + 1 < a.hi ? a.I : 0);
    const int j0 = max(a.lo, 1), j1 = min(a.hi, a.J + 1);
    const int nc = max(0, j1 - j0);
    for (int k = tid; k < nr + ns + 2 * nc; k += NT) {
      int j, i, sj, si;
      if (k < nr + ns) {
        j = k < nr ? 0 : a.J + 1;
        i = 1 + (k < nr ? k : k - nr);
        sj = k < nr ? 1 : a.J;
        si = i;
      } else {
        j = j0 + ((k - nr - ns) >> 1);
        i = (k - nr - ns) & 1 ? a.I + 1 : 0;
        sj = j;
        si = i ? a.I : 1;
      }
      p0[(size_t)j * W0 + i] = prow<CLUSTER>(a, sj)[si];
    }
  }
  // the fine residual's sum of squares in the fixed order: thread t adds
  // interior cells t, t + NT, ... (k = (j - 1) I + i - 1); CTA r takes the
  // cells of its rows, continuing each thread's sum from CTA r - 1. On a
  // cluster with level 0 in shared memory every CTA first leaves each
  // cell's r^2 in its rhs slot (read by that cell alone), so a link adds
  // values from its own shared memory.
  const int jlo = max(a.lo, 1), jhi = min(a.hi, a.J + 1);
  const int kbeg = (jlo - 1) * a.I, kend = (jhi - 1) * a.I;
  const T idx2 = g[0], idy2 = g[1];
  const bool kept = CLUSTER && a.shared;
  if (kept) {
    const int w = tid / 32, ln = tid % 32;
    for (int j = jlo + w; j < jhi; j += NW) {
      const Rows<T> q = rows_at<CLUSTER>(a, j);
      T* r2 = const_cast<T*>(q.r);
      for (int ib = 1 + ln; ib <= a.I; ib += 32 * V) {
        T v[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int i = ib + 32 * u;
          if (i <= a.I) {
            const T r = resid(q, j, i, a.J, a.I, fold, idx2, idy2);
            v[u] = r * r;
          }
        }
#pragma unroll
        for (int u = 0; u < V; ++u)
          if (ib + 32 * u <= a.I) r2[ib + 32 * u] = v[u];
      }
    }
    csync();
  }
  for (int link = 0; link < C; ++link) {
    if (link == rank) {
      T acc = rank == 0 ? T(0) : carry[tid];
      int k = kbeg + ((tid - kbeg) % NT + NT) % NT;
      int j = 1 + k / a.I, i = 1 + k % a.I;
      while (k < kend) {
        // V terms' loads in flight, then their adds in order
        T rr[V];
        int m = 0;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          if (k < kend) {
            if (kept) {
              rr[u] = a.r[(j - a.base) * a.W + i];
            } else {
              const T r = resid(rows_at<CLUSTER>(a, j), j, i, a.J, a.I, fold,
                                idx2, idy2);
              rr[u] = r * r;
            }
            m = u + 1;
            k += NT;
            i += NT;
            while (i > a.I) {
              i -= a.I;
              ++j;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < V; ++u)
          if (u < m) acc = acc + rr[u];
      }
      if constexpr (CLUSTER) {
        if (rank + 1 < C)
          *cg::this_cluster().map_shared_rank(&carry[tid], rank + 1) = acc;
      }
      if (rank + 1 == C) {
        sh[tid] = acc;
        __syncthreads();
        for (int s = NT / 2; s > 0; s >>= 1) {
          if (tid < s) sh[tid] = sh[tid] + sh[tid + s];
          __syncthreads();
        }
        if (tid == 0) rsq[lane] = sh[0];
      }
    }
    // a CTA's shared memory outlives every read of it: the last link too
    // ends in a barrier
    if (CLUSTER) csync();
  }
}

template <typename T>
int run(int dev, const T* p, const T* rhs, T* out, const int* ext,
        const T* geo, const int* active, T* work, T* rsq, int lanes, int jc,
        int ic, int lmax, long long lane_work, const int* form, int n_pre,
        int n_post, int n_bottom, cudaStream_t st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const int C = form[0], Lb = form[1], gmask = form[2], smem = form[3];
  if (lmax < 1 || lmax > MAXL || C < 1 || C > 8)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return (int)cudaSuccess;
  if (C == 1) {
    e = cudaFuncSetAttribute(class_cycle<false, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    class_cycle<false, T><<<lanes, NT, smem, st>>>(
        p, rhs, out, ext, geo, active, work, rsq, jc, ic, lmax,
        (size_t)lane_work, 1, Lb, gmask, n_pre, n_post, n_bottom);
    return (int)cudaGetLastError();
  }
  e = cudaFuncSetAttribute(class_cycle<true, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, class_cycle<true, T>, p, rhs, out, ext, geo,
                         active, work, rsq, jc, ic, lmax, (size_t)lane_work,
                         C, Lb, gmask, n_pre, n_post, n_bottom);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// form = [C, Lb, gmask, shared-memory bytes] (host memory)
#define CLASS_ENTRY(NAME, T)                                                 \
  int NAME(int dev, const void* p, const void* rhs, void* out,               \
           const void* ext, const void* geo, const void* active, void* work, \
           void* rsq, int lanes, int jc, int ic, int lmax,                   \
           long long lane_work, const int* form, int n_pre, int n_post,      \
           int n_bottom, void* stream) {                                     \
    return run<T>(dev, (const T*)p, (const T*)rhs, (T*)out, (const int*)ext, \
                  (const T*)geo, (const int*)active, (T*)work, (T*)rsq,      \
                  lanes, jc, ic, lmax, lane_work, form, n_pre, n_post,       \
                  n_bottom, (cudaStream_t)stream);                           \
  }

CLASS_ENTRY(mg_class_cycle_2d_f32, float)
CLASS_ENTRY(mg_class_cycle_2d_f64, double)

}  // extern "C"
