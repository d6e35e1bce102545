"""Kernel K13: the per-shard red-black SOR of the distributed quarter
layout on the H100, beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/sor_qdist.cu).

K13 `rb_sor_qdist` replaces pampi_tpu/ops/sor_qdist.py `_qdist_kernel`
(make_rb_iters_qdist, pallas_call at :249): g.n red-black iterations, each
with the globally gated Neumann wall refresh, on one shard's stacked plane
(4, jq, iq) of parallel/quarters_dist.py, with the shard's global quarter
offsets (qoff_j, qoff_i) as arguments. Updates are clipped to the plane's
interior and to the global interior; the residual is the sum of r² of the
last iteration over the shard's OWNED cells (ghost cells are the
neighbours', recomputed here). Returned as a 0-dim tensor on q's device.

Bound: memory, as K1 (q and rhs read once, q written once per call: ~15 us
for a 2048² shard at float32). The design is the TPU kernel's temporal
blocking, as K15's: the plane is cut into owned tiles of (row, column)
that partition it, each covering the same cells of the four slots
(qdist_tiles); a CTA loads its tile with a halo of n quarter cells into
shared memory, runs all n iterations there and writes the tile's
cells into `out` once; the last CTA sums the per-tile residual partials
in tile order (ops/sor_kernels.tiled_residual, which the plain version
repeats: kernel and plain version agree bitwise, residual included). One
launch a call: the wrapper writes into `out`, and the solvers swap two
lists of planes. A call whose boxes would outgrow shared memory (n in the tens)
runs as a few passes of fewer iterations (qdist_passes), each exact on the
whole plane. The launch plan of each shard is made once (launch_plan).

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches K13 or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

from ..kernels import build as kb
from ..parallel.quarters_dist import QGeom, q_masks, rb_iters_q
from .sor_kernels import (
    _SUFFIX,
    NT_TILED,
    _check,
    check_out,
    run_passes,
)
from .sor_obsdist import SMEM_LIMIT, split_passes

SOURCE = "pampi_tpu_torch/csrc/sor_qdist.cu"
RB_SOR_QDIST = kb.register(
    "rb_sor_qdist", SOURCE, "pampi_tpu/ops/sor_qdist.py:249")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    f"rb_sor_qdist_{t}": [_I, _V, _V, _V, _V, _D, _D, _D, _V, _V, _V, _V]
    for t in ("f32", "f64")
}
# the largest box (tile and halo, rows x columns of quarter cells) a CTA
# holds, by element size: the four slots of p and rhs, 32 bytes a cell at
# float32 (48x64, 96 KB) and 64 at float64 (48x32, 96 KB), two CTAs an
# SM; a row is a whole number of warps' columns
_BOX = {4: (48, 64), 8: (48, 32)}
_MIN_TILE = (8, 16)


@dataclass(frozen=True)
class QPassPlan:
    """One launch of K13: `iters` iterations on tiles (th, tw) with a halo
    of ht quarter cells, and the shared-memory layout of the largest
    box."""

    iters: int
    ht: int
    th: int
    tw: int
    rows: int  # rows of the largest box
    P: int  # row pitch of a slot in shared memory (elements)
    smem: int  # dynamic shared memory a CTA takes (bytes)


def qdist_pass_plan(g: QGeom, iters: int, itemsize: int = 4) -> QPassPlan:
    """The launch plan of a pass of `iters` <= g.n iterations on g's plane.
    The tile halo is iters: each slot reads the other colour one quarter
    cell away on one side per axis, so a box cell whose stencil leaves the
    box (on the box's ring) goes stale and the staleness moves one quarter
    cell in per iteration; the wall selects are same-index and reach no
    further (tests/test_torch_sor_tiles.py shows iters enough and iters - 1
    not).
    The owned tile is the box (_BOX for the element size) less the halo,
    at least _MIN_TILE. Shared memory holds the four slots of p and of
    rhs (rhs read through the read-only path each iteration was slower at
    the timed shard, PERF.md §6)."""
    ht = iters
    rows, cols = _BOX[itemsize]
    th = max(rows - 2 * ht, _MIN_TILE[0])
    tw = max(cols - 2 * ht, _MIN_TILE[1])
    r, w = min(g.jq, th + 2 * ht), min(g.iq, tw + 2 * ht)
    P = w + (w & 1)
    # the residual's tree reuses the box's memory: one value a thread
    smem = max(2 * 4 * r * P * itemsize, NT_TILED * itemsize)
    return QPassPlan(iters, ht, th, tw, r, P, smem)


def qdist_passes(g: QGeom, itemsize: int = 4) -> list[QPassPlan]:
    """K13's launches for one call: one pass of g.n iterations wherever its
    boxes fit shared memory, else the fewest that do."""
    parts = split_passes(g.n, lambda m: qdist_pass_plan(
        g, m, itemsize).smem <= SMEM_LIMIT)
    return [qdist_pass_plan(g, m, itemsize) for m in parts]


def qdist_tiles(g: QGeom, itemsize: int = 4, iters: int | None = None):
    """The owned tiles (j0, j1, i0, i1) of a pass of `iters` iterations
    (default g.n): they partition the stored plane,
    its frozen ring included, so the kernel writes each cell of each slot
    once. The CTA of a tile holds the box [j0 - ht, j1 + ht) x [i0 - ht,
    i1 + ht) of every slot, clipped to the plane."""
    pl = qdist_pass_plan(g, g.n if iters is None else iters, itemsize)
    return [(j0, min(j0 + pl.th, g.jq), i0, min(i0 + pl.tw, g.iq))
            for j0 in range(0, g.jq, pl.th) for i0 in range(0, g.iq, pl.tw)]


def rb_sor_qdist_plain(q, f, g: QGeom, qoffs, factor, idx2, idy2, out):
    """K13's plain version: parallel/quarters_dist.rb_iters_q into `out`,
    q untouched."""
    m = q_masks(g, int(qoffs[0]), int(qoffs[1]), q.device)
    new, rsq = rb_iters_q(q, f, g, m, factor, idx2, idy2)
    out.copy_(new)
    return rsq


def rb_sor_qdist(q, f, g: QGeom, qoffs, factor, idx2, idy2, out):
    """K13 on one shard's stacked plane q, f of shape (4, g.jq, g.iq);
    qoffs = (joff/2, ioff/2). It reads q and writes the new plane into
    `out` (q untouched). Returns the owned Σr² of the last iteration (0-dim
    tensor)."""
    check_out("K13", q, out)
    if q.device.type == "cpu":
        return rb_sor_qdist_plain(q, f, g, qoffs, factor, idx2, idy2, out)
    _check(q, f, g.n)
    if tuple(q.shape) != (4, g.jq, g.iq):
        raise ValueError(f"the plane must be (4, {g.jq}, {g.iq}), got "
                         f"{tuple(q.shape)}")
    lib = kb.load("sor_qdist", _SIGNATURES)
    entry = getattr(lib, f"rb_sor_qdist_{_SUFFIX[q.dtype]}")
    launches = launch_plan(g, q.element_size(), int(qoffs[0]),
                           int(qoffs[1]))

    def launch(src, dst, geo, partial, ticket, res, stream):
        kb.check(lib, entry(q.device.index, src.data_ptr(), f.data_ptr(),
                            dst.data_ptr(), geo, factor, idx2, idy2,
                            partial.data_ptr(), ticket.data_ptr(),
                            res.data_ptr(), stream), "rb_sor_qdist")

    res = run_passes(q, launches, out, launch)
    RB_SOR_QDIST.launches += 1
    return res


@functools.lru_cache(maxsize=1024)
def launch_plan(g: QGeom, itemsize: int, qoff_j: int, qoff_i: int):
    """(tiles, the kernel's geometry array) of each pass of a call, made
    once per shard: the CLI's rounds call K13 on small shards, where the
    host's work is the call's cost."""
    return tuple(
        (-(-g.jq // pl.th) * -(-g.iq // pl.tw),
         (ctypes.c_int * 16)(g.jq, g.iq, g.jl // 2, g.il // 2, g.n, pl.iters,
                             g.jmax // 2, g.imax // 2, qoff_j, qoff_i, pl.ht,
                             pl.th, pl.tw, pl.rows, pl.P, pl.smem))
        for pl in qdist_passes(g, itemsize))
