"""Kernel K14: the per-shard red-black SOR of the distributed octant
layout on the H100, beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/sor_odist.cu).

K14 `rb_sor_odist` replaces pampi_tpu/ops/sor_odist.py `_odist_kernel`
(make_rb_iters_odist, pallas_call at :264): g.n red-black iterations, each
with the globally gated Neumann wall refresh, on one shard's stacked octant
volume (8, kq, jq, iq) of parallel/octants_dist.py, with the shard's
global octant offsets (koff/2, joff/2, ioff/2) as arguments. It reads the
volume and writes the new one into `out`. Updates are clipped to the
global interior and, on the exchanged axes, to the stored interior (the
outermost ring stays frozen); the residual is the sum of r² of the last
iteration over the shard's OWNED cells, returned as a 0-dim tensor on q's
device. On a (1, 1, 1) mesh the volume is K6's octant array, and K14
computes K6's volume.

Bound: memory, as K6 (q and rhs read once, q written once per call: ~11 us
for a 128³ shard at float32). The design is the TPU kernel's streaming
along k, one iteration a pass: a call of n iterations runs n passes, one
launch each (odist_pass); a pass cuts the volume's (jq, iq) plane into
owned tiles and k into slabs (odist_tiles), and a CTA streams its tile's
box (a halo of HALO14 = 1 octant cell) through a ring of RING14 = 5
planes of the eight slots of p and rhs in shared memory (the next
plane's arriving by cp.async), the two colour stages a
wavefront one plane apart, and writes the tile's cells into `out` once.
The last CTA sums the per-tile residual partials in tile order
(odist_residual, which the plain version repeats: kernel and plain
version agree bitwise, residual included). The passes alternate `out`
and one scratch volume cached per shard shape and stream, so that the
last lands in `out`; the launch plan of each shard is made once
(launch_plan), and the solvers swap two lists of volumes.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches K14 or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import build as kb
from ..parallel.octants_dist import OGeom, o_masks, rb_iters_o
from .sor3d_kernels import _tiles
from .sor_kernels import _SUFFIX, _check, card_of, check_out, residual_buffers
from .sor_obsdist import SMEM_LIMIT

SOURCE = "pampi_tpu_torch/csrc/sor_odist.cu"
RB_SOR_ODIST = kb.register(
    "rb_sor_odist", SOURCE, "pampi_tpu/ops/sor_odist.py:264")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    f"rb_sor_odist_{t}": [_I, _V, _V, _V, _V, _D, _D, _D, _D, _V, _V, _V, _V]
    for t in ("f32", "f64")
}
# K14's CTA (csrc/sor_odist.cu): TY rows of TX threads, thread (tx, ty)
# taking box cells (ty + TY kk, tx); boxes of up to TX columns and, by
# element size, of up to _ROWS rows (2 cells a thread at float32, 1 at
# float64)
TX, TY = 32, 16
NT = TX * TY
_ROWS = {4: 32, 8: 16}
# a pass is one iteration: the tiles' halo in octant cells (a slot reads
# the other colour one cell away on one side per axis) and the ring's
# planes (the 4 that the two colour stages read and the next one)
HALO14, RING14 = 1, 5
# the scratch volume of the passes, per (shape, dtype, device, stream)
_SCRATCH: dict = {}


@dataclass(frozen=True)
class OPassPlan:
    """A pass of K14: one iteration on owned tiles (tk, tj, ti) of octant
    cells with a halo of HALO14, streamed along k through a ring of RING14
    planes of the eight slots of p and rhs, each slot rows x TX cells."""

    tk: int
    tj: int
    ti: int
    rows: int
    smem: int  # dynamic shared memory a CTA takes (bytes)


def odist_pass(g: OGeom, itemsize: int = 4,
               sms: int | None = None) -> OPassPlan:
    """The plan of a pass on g's volume. The tile halo is HALO14: each slot
    reads the other colour one cell away on one side per axis, so a box
    cell whose stencil leaves the box goes stale, and the staleness moves
    one octant cell in per iteration; the wall selects are same-index and
    reach no further (tests/test_torch_sor_tiles3d.py shows 1 enough and 0
    not). The box is TX columns wide and as tall as the ring of RING14
    planes of p and rhs in shared memory (227 KB) and the threads allow;
    the (j, i) tiles are the fewest that fit it, of near-equal extent; k
    is cut into as many slabs as the SMs can take at one CTA an SM (one
    wave: a CTA's time is its planes and a fixed 2 HALO14 + 2 steps of
    halo and ring)."""
    from .sor_obsdist3d import SMS

    sms = SMS if sms is None else sms
    per_row = RING14 * 8 * TX * 2 * itemsize  # p and rhs, the ring's planes
    cut = (_tiles(g.iq, TX, HALO14),
           _tiles(g.jq, min(_ROWS[itemsize], SMEM_LIMIT // per_row), HALO14))
    if None in cut:
        raise ValueError("no K14 box fits shared memory")
    (ti, ni), (tj, nj) = cut
    rows = min(g.jq, tj + 2 * HALO14)
    slabs = max(1, min(sms // (nj * ni), g.kq))
    return OPassPlan(-(-g.kq // slabs), tj, ti, rows, rows * per_row)


def odist_tiles(g: OGeom, pl: OPassPlan):
    """The owned tiles (k0, k1, j0, j1, i0, i1) of a pass, in CTA order:
    they partition the stored volume, its frozen ring included, so the
    kernel writes each cell of each slot once. The CTA of a tile streams
    the box of the tile and ht cells a side (k included), clipped to the
    volume."""
    return [(k0, min(k0 + pl.tk, g.kq), j0, min(j0 + pl.tj, g.jq), i0,
             min(i0 + pl.ti, g.iq))
            for k0 in range(0, g.kq, pl.tk) for j0 in range(0, g.jq, pl.tj)
            for i0 in range(0, g.iq, pl.ti)]


def odist_partials(r2, g: OGeom, pl: OPassPlan):
    """K14's per-tile partial sums of the last iteration's r² (r2: the
    stacked (8, kq, jq, iq) volume of owned r², 0 elsewhere), in the
    kernel's order: thread (tx, ty) of a tile's CTA adds, step by step of
    its pass, the cells (ty + TY kk, tx) of its box that it updates (box
    coordinates), first on the odd octants 1, 2, 4, 7 of the plane its
    last odd stage takes, then on the even ones 0, 3, 5, 6 of the plane
    behind it, kk by kk; a halving tree over tid = TX ty + tx reduces the
    threads. Returns the partials in tile order, a numpy array of r2's
    dtype: the sums are plain IEEE adds of that dtype, and numpy makes
    them at a fraction of the host's cost a round (the CPU solves call
    this every round). The terms are laid out as (steps, threads) by
    _sum_order, so that one add a step sums every thread at once; a step
    that no thread takes is left out (adding 0 to a sum of squares
    changes no bit)."""
    src, dst, steps, ntiles = _sum_order(g, pl)
    flat = r2.detach().reshape(-1).cpu().numpy()
    terms = np.zeros(steps * ntiles * NT, dtype=flat.dtype)
    terms[dst] = flat[src]
    terms = terms.reshape(steps, ntiles * NT)
    acc = np.zeros(ntiles * NT, dtype=flat.dtype)
    for e in range(steps):
        acc = acc + terms[e]
    return _halving_tree(acc.reshape(ntiles, NT))


def _halving_tree(s):
    """sor_kernels._tree in numpy: s[..., :h] + s[..., h:2h] for h = n/2,
    n/4, ..., 1; returns s[..., 0]."""
    h = s.shape[-1] // 2
    while h:
        s = s[..., :h] + s[..., h:2 * h]
        h //= 2
    return s[..., 0]


def odist_residual(r2, g: OGeom, pl: OPassPlan):
    """K14's residual: odist_partials, then the last CTA's sum of the
    partials in tile order (thread t of NT adds partials t, t + NT, ...,
    then the halving tree: sor_kernels.fixed_order_sum). A 0-dim tensor on
    r2's device, equal bit for bit to the kernel's."""
    parts = odist_partials(r2, g, pl)
    acc = np.zeros(NT, dtype=parts.dtype)
    for k in range(0, len(parts), NT):
        chunk = parts[k:k + NT]
        acc[:len(chunk)] = acc[:len(chunk)] + chunk
    return torch.tensor(_halving_tree(acc), device=r2.device)


@functools.lru_cache(maxsize=4)
def _sum_order(g: OGeom, pl: OPassPlan):
    """(src, dst, steps, tiles) of odist_partials: each owned cell's flat
    index in the stacked volume (src) and its place (dst = step x tiles x
    NT + tile x NT + TX ty + tx) among the steps that some thread takes,
    ranked in the kernel's order, as int32 arrays. Made once per shard
    geometry, for the few geometries of the live solves (a solver's shards
    share one)."""
    tiles = odist_tiles(g, pl)
    kk_n = -(-pl.rows // TY)
    q = (g.kq, g.jq, g.iq)
    src, key, col = [], [], []
    for t, tile in enumerate(tiles):
        lo = [max(0, tile[2 * ax] - HALO14) for ax in range(3)]
        for o in range(8):
            bits = (o >> 2, (o >> 1) & 1, o & 1)
            axes = []
            for ax in range(3):
                os_ = g.d[ax] + (1 if bits[ax] == 0 else 0)
                axes.append(np.arange(max(tile[2 * ax], os_),
                                      min(tile[2 * ax + 1],
                                          os_ + g.local2(ax))))
            k, j, i = np.meshgrid(*axes, indexing="ij")
            k, j, i = k.ravel(), j.ravel(), i.ravel()
            a, b = j - lo[1], i - lo[2]
            odd = o in (1, 2, 4, 7)
            slot = (1, 2, 4, 7).index(o) if odd else (0, 3, 5, 6).index(o)
            # the step of the kernel's loop whose last stages take it, the
            # colour's place in the step, the slot's in the colour, kk
            z = k - lo[0] + (0 if odd else 1)
            key.append(((z * 2 + (0 if odd else 1)) * 4 + slot) * kk_n
                       + a // TY)
            src.append(((o * q[0] + k) * q[1] + j) * q[2] + i)
            col.append(t * NT + (a % TY) * TX + b)
    key, src, col = (np.concatenate(v) for v in (key, src, col))
    used, rank = np.unique(key, return_inverse=True)
    dst = rank * (len(tiles) * NT) + col
    return (src.astype(np.int32), dst.astype(np.int32), len(used),
            len(tiles))


def rb_sor_odist_plain(q, f, g: OGeom, qoffs, factor, idx2, idy2, idz2,
                       out):
    """K14's plain version: parallel/octants_dist.rb_iters_o into `out`
    (q untouched), the residual in the kernel's order (odist_residual
    over the tiles of the call's last pass)."""
    m = o_masks(g, *(int(o) for o in qoffs), q.device)
    new, r2 = rb_iters_o(q, f, g, m, factor, idx2, idy2, idz2)
    out.copy_(new)
    return odist_residual(r2, g, odist_pass(g, q.element_size()))


def rb_sor_odist(q, f, g: OGeom, qoffs, factor, idx2, idy2, idz2, out):
    """K14 on one shard's stacked volume q, f of shape (8, g.kq, g.jq,
    g.iq); qoffs = (koff/2, joff/2, ioff/2). It reads q and writes the new
    volume into `out` (q untouched). Returns the owned Σr² of the last
    iteration (0-dim tensor)."""
    check_out("K14", q, out)
    if q.device.type == "cpu":
        return rb_sor_odist_plain(q, f, g, qoffs, factor, idx2, idy2, idz2,
                                  out)
    _check(q, f, g.n)
    if tuple(q.shape) != (8, g.kq, g.jq, g.iq):
        raise ValueError(f"the volume must be (8, {g.kq}, {g.jq}, {g.iq}), "
                         f"got {tuple(q.shape)}")
    lib = kb.load("sor_odist", _SIGNATURES)
    entry = getattr(lib, f"rb_sor_odist_{_SUFFIX[q.dtype]}")
    ntiles, geo = launch_plan(g, q.element_size(),
                              tuple(int(o) for o in qoffs))
    res = torch.empty((), dtype=q.dtype, device=q.device)
    # the shards of a mesh lie on several cards: the launch selects q's
    # card, and the guard gives the caller its current card back
    with card_of(q):
        stream = kb.stream_of(q)
        scratch = None
        if g.n > 1:
            key = (tuple(q.shape), q.dtype, q.device, stream)
            scratch = _SCRATCH.get(key)
            if scratch is None:
                scratch = _SCRATCH[key] = torch.empty_like(q)
        ticket, partial = residual_buffers(q, stream, ntiles)
        src = q
        for k in range(g.n):
            # the passes alternate out and the scratch volume, the last
            # landing in out
            last = k == g.n - 1
            dst = out if (g.n - 1 - k) % 2 == 0 else scratch
            err = entry(q.device.index, src.data_ptr(), f.data_ptr(),
                        dst.data_ptr(), geo, factor, idx2, idy2, idz2,
                        partial.data_ptr() if last else None,
                        ticket.data_ptr(), res.data_ptr(), stream)
            kb.check(lib, err, "rb_sor_odist")
            src = dst
    RB_SOR_ODIST.launches += 1
    return res


@functools.lru_cache(maxsize=1024)
def launch_plan(g: OGeom, itemsize: int, qoffs: tuple):
    """(tiles, the kernel's geometry array) of a pass, made once per shard:
    the CLI's rounds call K14 on small shards, where the host's work is
    the call's cost."""
    pl = odist_pass(g, itemsize)
    if pl.smem > SMEM_LIMIT:
        raise ValueError(f"a K14 pass takes {pl.smem} bytes of shared "
                         "memory")
    return (len(odist_tiles(g, pl)),
            (ctypes.c_int * 20)(g.kq, g.jq, g.iq, *g.d, g.kl // 2, g.jl // 2,
                                g.il // 2, g.kmax // 2, g.jmax // 2,
                                g.imax // 2, *qoffs, pl.tk, pl.tj, pl.ti,
                                pl.rows, pl.smem))
