"""Kernel K15: the per-shard flag-masked red-black SOR of a 2-D mesh on the
H100, beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/sor_obsdist.cu).

K15 `rb_sor_obsdist` replaces pampi_tpu/ops/sor_obsdist.py
`_obsdist_kernel` (make_rb_iters_obsdist, pallas_call at :296): g.n
red-black iterations, each with the globally gated Neumann wall refresh,
on one shard's (jl+2H, il+2H) deep block, with the shard's global offsets
(joff, ioff) as arguments (the TPU kernel's scalar prefetch). H =
ca_halo(n, ragged) is 2n, or 2n+1 on a ragged mesh. Deep cell (a, b)
holds global extended index (a - H + joff + 1, b - H + ioff + 1). Per
cell:

- it updates when it lies in the global interior, off the block's frozen
  outer ring, in the colour (gi + gj) mod 2 of the half-sweep, and is
  fluid (flag != 0);
- its coefficients come from the flags of the shard's deep flag block:
  eps_E/W/N/S are the neighbours' flags, fac = (denom > 0 ? omega/denom :
  0)·flag with denom = (eps_E + eps_W)/dx² + (eps_N + eps_S)/dy²
  (sor_pallas.masked_stencil_ops; the plain form is
  ops/sor_kernels.masked_stencil_2d, which masked K2 shares);
- per iteration: r = rhs - lap(p) on red, p -= fac·r, the same on black,
  then the four wall selects (row lo, row hi, column lo, column hi;
  sor_pallas.rb_inner_sweeps), each clipped tangentially to the global
  interior;
- the residual is Σ r_red² + r_black² of the last iteration over the
  shard's owned cells, returned as a 0-dim tensor on p's device.

The flags are uint8 (1 byte a cell): 0 marks an obstacle or a dead cell
beyond the global ghost ring. The NS-2D obstacle solve passes the real
flags; the ragged NS-2D solve without obstacles passes all-fluid flags.
The dead cells of a ceil-divided block lie outside the global interior,
so the gating keeps them frozen.

The JAX package carries the block in the TPU's padded layout
(sor_pallas.pad_array) and exchanges it there (sor_obsdist.
padded_deep_exchange); both exist for the TPU's (8, 128) tiling. The port
keeps the unpadded block and exchanges it with parallel/comm.halo_exchange
(depth=H), so neither is ported.

Bound: memory, as K2 (p, rhs and the flags read once, p written once per
call: 13 bytes a cell at float32, ~22 us for a 1366x4096 shard at n = 4).
The design is the TPU kernel's temporal blocking: the block is cut into
owned tiles that partition it (obsdist_tiles); a CTA loads its tile with
a halo of 2n + 1 cells into shared memory, runs all n iterations
there and writes the tile's cells into `out` once; the last CTA sums the
per-tile residual partials in tile order. One launch a call: the solver
passes `out` and swaps the two blocks; without `out` the wrapper copies
the result back into p (a second launch). A call whose boxes would
outgrow shared memory (n in the tens at float64) runs as a few passes of
fewer iterations (obsdist_passes), each exact on the whole block.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches K15 or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from .sor_kernels import _SUFFIX, check_out, masked_stencil_2d, run_passes

SOURCE = "pampi_tpu_torch/csrc/sor_obsdist.cu"
RB_SOR_OBSDIST = kb.register(
    "rb_sor_obsdist", SOURCE, "pampi_tpu/ops/sor_obsdist.py:296")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    f"rb_sor_obsdist_{t}": [_I, _V, _V, _V, _V, _V, _D, _D, _D, _V, _V, _V,
                            _V]
    for t in ("f32", "f64")
}
# the largest box (tile and halo, rows x columns) a CTA holds, by element
# size: p, rhs (itemsize each) and the flags (1 byte) of 96x128 cells
# (~111 KB) at float32 and 64x96 (~106 KB) at float64, two CTAs an SM
_BOX = {4: (96, 128), 8: (64, 96)}
_MIN_TILE = (16, 32)
_THREADS = 512  # a CTA's threads (csrc/sor_obsdist.cu's NT)
# dynamic shared memory a CTA may take on the H100 (227 KB, less a margin
# for the kernel's static shared memory)
SMEM_LIMIT = 232448 - 1024


@dataclass(frozen=True)
class ObsGeom:
    """Static geometry of one shard's deep block."""

    jmax: int  # global interior extents
    imax: int
    jl: int  # the shard's owned extents
    il: int
    n: int  # red-black iterations per call
    H: int  # deep-halo depth, ca_halo(n, ragged)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.jl + 2 * self.H, self.il + 2 * self.H)


def obsdist_masks(g: ObsGeom, joff: int, ioff: int, device="cpu"):
    """The gating masks of the deep block at global offsets (joff, ioff),
    the kernel's per-cell formulas: global interior ∩ the block's
    interior (the frozen outer ring) by colour (the kernel also requires
    a fluid cell), the four wall selects and the owned region."""
    ej, ei = g.shape
    a_j = torch.arange(ej, device=device)[:, None]
    a_i = torch.arange(ei, device=device)[None, :]
    gj = a_j - g.H + joff + 1
    gi = a_i - g.H + ioff + 1
    tan_j = (gj >= 1) & (gj <= g.jmax)
    tan_i = (gi >= 1) & (gi <= g.imax)
    valid = (a_j >= 1) & (a_j <= ej - 2) & (a_i >= 1) & (a_i <= ei - 2)
    upd = tan_j & tan_i & valid
    par = (gi + gj) % 2
    return {
        "red": upd & (par == 0), "black": upd & (par == 1),
        "row_lo": (gj == 0) & tan_i & valid,
        "row_hi": (gj == g.jmax + 1) & tan_i & valid,
        "col_lo": (gi == 0) & tan_j & valid,
        "col_hi": (gi == g.imax + 1) & tan_j & valid,
        "owned": ((a_j >= g.H) & (a_j < g.H + g.jl)
                  & (a_i >= g.H) & (a_i < g.H + g.il)),
    }


def rb_iters_obsdist_plain(p, rhs, flags, g: ObsGeom, offs, omega, idx2,
                           idy2):
    """K15's plain version, op for op the kernel's arithmetic, in place on
    p; returns the owned Σr² of the last iteration (0-dim tensor). The
    stencil is ops/sor_kernels.masked_stencil_2d on the block's interior
    (the frozen outer ring is never updated); the wall selects' rolls wrap
    only into that ring, which no mask selects."""
    m = obsdist_masks(g, int(offs[0]), int(offs[1]), p.device)
    inner = (slice(1, -1), slice(1, -1))
    fluid = flags[inner] != 0
    red, black = m["red"][inner] & fluid, m["black"][inner] & fluid
    fac, lap = masked_stencil_2d(flags, p.dtype, omega, idx2, idy2)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    rhs_c = rhs[inner]
    x = p.clone()
    r_red = r_blk = None
    for _ in range(g.n):
        r_red = torch.where(red, rhs_c - lap(x), zero)
        x[inner] = x[inner] - fac * r_red
        r_blk = torch.where(black, rhs_c - lap(x), zero)
        x[inner] = x[inner] - fac * r_blk
        x = torch.where(m["row_lo"], torch.roll(x, -1, 0), x)
        x = torch.where(m["row_hi"], torch.roll(x, 1, 0), x)
        x = torch.where(m["col_lo"], torch.roll(x, -1, 1), x)
        x = torch.where(m["col_hi"], torch.roll(x, 1, 1), x)
    p.copy_(x)
    r2 = r_red * r_red + r_blk * r_blk
    return torch.sum(torch.where(m["owned"][inner], r2, zero))


@dataclass(frozen=True)
class PassPlan:
    """One launch of K15: n iterations on tiles (th, tw) with a halo of ht
    cells, and the shared-memory layout of the largest box."""

    n: int
    ht: int
    th: int
    tw: int
    rows: int  # rows of the largest box
    P: int  # row pitch of p and rhs in shared memory (elements, even)
    Pf: int  # row pitch of the flags (bytes)
    smem: int  # dynamic shared memory a CTA takes (bytes)


def _flag_pitch(w: int) -> int:
    """A row pitch for the byte flags: a multiple of 32 at least w, not of
    128, so that the two rows of a warp's row pair fall on other banks."""
    pf = -(-w // 32) * 32
    return pf + 32 if pf % 128 == 0 else pf


def pass_plan(g: ObsGeom, n: int, itemsize: int = 4) -> PassPlan:
    """The launch plan of a pass of n <= g.n iterations on g's deep block.
    The tile halo is 2n + 1, or g.H less two cells an iteration not run in
    this pass where that is more: the sweeps reach 2n cells in from the
    box's edge, and a wall-ghost cell of the tile copies its inward
    neighbour after them, one cell further (a shard's owned region holds
    no wall cell, so its deep halo needs only 2n, or 2n + 1 on a ragged
    mesh for the same reason). The owned tile is the largest box for the
    element size less the halo (at least _MIN_TILE)."""
    ht = max(g.H - 2 * (g.n - n), 2 * n + 1)
    rows, cols = _BOX[itemsize]
    th, tw = max(rows - 2 * ht, _MIN_TILE[0]), max(cols - 2 * ht, _MIN_TILE[1])
    ej, ei = g.shape
    r, w = min(ej, th + 2 * ht), min(ei, tw + 2 * ht)
    P, Pf = w + (w & 1), _flag_pitch(w)
    # the residual's tree reuses the box's memory: one value a thread
    smem = max(r * (2 * P * itemsize + Pf), _THREADS * itemsize)
    return PassPlan(n, ht, th, tw, r, P, Pf, smem)


def split_passes(n: int, fits) -> list[int]:
    """n iterations as the fewest passes of near-equal length for which
    fits(length) holds (one pass where n fits)."""
    for k in range(1, n + 1):
        parts = [n // k + (1 if i < n % k else 0) for i in range(k)]
        if all(fits(m) for m in set(parts)):
            return parts
    raise ValueError(f"no pass of one iteration fits (n = {n})")


def obsdist_passes(g: ObsGeom, itemsize: int = 4) -> list[PassPlan]:
    """K15's launches for one call: one pass of g.n iterations wherever
    its boxes fit shared memory, else the fewest that do."""
    parts = split_passes(
        g.n, lambda m: pass_plan(g, m, itemsize).smem <= SMEM_LIMIT)
    return [pass_plan(g, m, itemsize) for m in parts]


def obsdist_tiles(g: ObsGeom, itemsize: int = 4, n: int | None = None):
    """The owned tiles (j0, j1, i0, i1) of a pass of n iterations (default
    g.n): they partition the deep block, its frozen ring included, so the
    kernel writes each cell once. The CTA of a tile holds the box
    [j0 - ht, j1 + ht) x [i0 - ht, i1 + ht), clipped to the block."""
    pl = pass_plan(g, g.n if n is None else n, itemsize)
    ej, ei = g.shape
    return [(j0, min(j0 + pl.th, ej), i0, min(i0 + pl.tw, ei))
            for j0 in range(0, ej, pl.th) for i0 in range(0, ei, pl.tw)]


def rb_sor_obsdist(p, rhs, flags, g: ObsGeom, offs, omega, idx2, idy2,
                   out=None):
    """K15 on one shard's deep block p, rhs of shape g.shape with the uint8
    deep flag block `flags` and the shard's global offsets offs = (joff,
    ioff). With `out` it reads p and writes the new block into out (p
    untouched); without, it updates p in place. Returns the owned Σr² of
    the last iteration (0-dim tensor)."""
    if out is not None:
        check_out("K15", p, out)
    if p.device.type == "cpu":
        if out is None:
            return rb_iters_obsdist_plain(p, rhs, flags, g, offs, omega,
                                          idx2, idy2)
        out.copy_(p)
        return rb_iters_obsdist_plain(out, rhs, flags, g, offs, omega, idx2,
                                      idy2)
    if p.device.type != "cuda":
        raise ValueError(f"K15 takes CPU or CUDA tensors, not {p.device}")
    if p.dtype not in _SUFFIX:
        raise ValueError(f"K15 takes float32 or float64, not {p.dtype}")
    for t, dt in ((p, p.dtype), (rhs, p.dtype), (flags, torch.uint8)):
        if (t.device != p.device or t.dtype != dt
                or tuple(t.shape) != g.shape or not t.is_contiguous()):
            raise ValueError(
                f"K15 needs contiguous p, rhs ({p.dtype}) and flags (uint8) "
                f"of shape {g.shape} on one device")
    if g.n < 1 or g.H < 2 * g.n:
        raise ValueError(f"K15 needs n >= 1 and H >= 2n, got n = {g.n}, "
                         f"H = {g.H}")
    lib = kb.load("sor_obsdist", _SIGNATURES)
    res = run_tiled(getattr(lib, f"rb_sor_obsdist_{_SUFFIX[p.dtype]}"), lib,
                    "rb_sor_obsdist",
                    launch_plan(g, p.element_size(), int(offs[0]),
                                int(offs[1])),
                    p, rhs, flags, omega, idx2, idy2, out)
    RB_SOR_OBSDIST.launches += 1
    return res


def run_tiled(entry, lib, what, launches, p, rhs, flags, omega, idx2, idy2,
              out):
    """Launch the tiled kernel `entry` (K15's or masked K2's, the template
    of csrc/sor_tiles2d.cuh) for each pass of `launches` (launch_plan);
    ops/sor_kernels.run_passes says the rest."""
    def launch(src, dst, geo, partial, ticket, res, stream):
        kb.check(lib, entry(p.device.index, src.data_ptr(), rhs.data_ptr(),
                            flags.data_ptr(), dst.data_ptr(), geo, omega,
                            idx2, idy2, partial.data_ptr(), ticket.data_ptr(),
                            res.data_ptr(), stream), what)

    return run_passes(p, launches, out, launch)


@functools.lru_cache(maxsize=1024)
def launch_plan(g: ObsGeom, itemsize: int, joff: int, ioff: int):
    """(tiles, the kernel's geometry array) of each pass of a call, made
    once per shard: the CLI's rounds call K15 and masked K2 on small
    blocks, where the host's work is the call's cost."""
    ej, ei = g.shape
    return tuple(
        (-(-ej // pl.th) * -(-ei // pl.tw),
         (ctypes.c_int * 17)(ej, ei, g.jl, g.il, pl.n, g.H, g.jmax, g.imax,
                             joff, ioff, pl.ht, pl.th, pl.tw, pl.rows, pl.P,
                             pl.Pf, pl.smem))
        for pl in obsdist_passes(g, itemsize))
