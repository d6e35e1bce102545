// Per-shard flag-masked red-black SOR of a 2-D mesh, for Hopper (sm_90a):
// kernel K15.
//
// rb_sor_obsdist replaces pampi_tpu/ops/sor_obsdist.py _obsdist_kernel
//   (make_rb_iters_obsdist): n red-black iterations, each with the globally
//   gated homogeneous-Neumann wall refresh, on one shard's (jl+2H, il+2H)
//   deep block p, with per-direction fluid coefficients formed from the
//   shard's uint8 deep flag block. It reads p and writes the new block into
//   out (out of place: a CTA reads its neighbours' cells while they write).
//
// The kernel is the tiled template of csrc/sor_tiles2d.cuh (shared with the
// masked mode of K2), which says how a block maps onto global cells, what
// each cell does and how the tiles, the halo and the residual work. Here
// the block is a shard's deep block: H = ca_halo(n, ragged) >= 2, the
// shard's global offsets (joff, ioff) passed as arguments (the TPU kernel
// takes them by scalar prefetch), its outermost ring frozen.
//
// What bounds it on the H100: memory bandwidth at the least (~20 flops per
// cell update). The least any implementation moves per call is p, rhs and
// the flags read once and p written once: 13 bytes a cell at float32, ~22
// us for a 1366x4096 shard at n = 4 (a 1384x4114 deep block) at 3.35 TB/s.
// Measured, it is bound by the issue rate of its sweeps (PERF.md).

#include "sor_tiles2d.cuh"

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

TILED2D_ENTRY(rb_sor_obsdist_f32, float, false)
TILED2D_ENTRY(rb_sor_obsdist_f64, double, false)

}  // extern "C"
