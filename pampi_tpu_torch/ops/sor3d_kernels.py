"""Kernels K5 and K6: 3-D red-black SOR on the H100, each beside its plain
PyTorch version (sources: pampi_tpu_torch/csrc/sor3d_rb.cu).

K5 `rb_sor3d_checkerboard` replaces pampi_tpu/ops/sor3d_pallas.py
  `_tblock3d_kernel` (make_rb_iter_tblock_3d, plain mode, pallas_call at
  :388): n_inner iterations on the natural (kmax+2, jmax+2, imax+2) array.
K6 `rb_sor3d_octants` replaces pampi_tpu/ops/sor3d_pallas.py
  `_tblock3d_octants_kernel` (make_rb_iter_tblock_3d_octants, pallas_call
  at :735): the same function on the stacked octants (8, K2, J2, I2) of
  pampi_tpu_torch/ops/sor_octants.py (even imax, jmax, kmax).

K5's masked mode (`rb_sor3d_checkerboard(..., flags=, omega=)`) replaces
  the masked mode of the same TPU kernel (_tblock3d_kernel(masked=True),
  the NS-3D obstacle solve): a cell updates only where it is fluid, with
  per-direction coefficients and the relaxation factor omega/denom formed
  from uint8 flags (1 byte a cell) in the field's dtype, as
  sor3d_pallas.masked_stencil_ops_3d forms them. Its launches count on
  their own kernel entry, `rb_sor3d_checkerboard_masked`. It reads p and
  writes `out` (the solver swaps two fields). Bound: 13 bytes a cell at
  float32 (p, rhs and the flags read, p written: 0.0337 ms at
  512x128x128). Its design is K16's streaming on the whole field, one
  iteration a pass: a call of n iterations runs n passes, one launch each
  (masked_pass); a pass cuts the field into (j, i) tiles and k slabs
  (masked_tiles), and a CTA streams its tile's box (a halo of HALO5 = 3
  cells) along k through a ring of RING5 = 5 planes in shared memory, the
  edge tiles writing the wall shell. Its residual is summed in a fixed
  order (`ordered_r2_sum`: row sums, then the rows, one more launch) that
  the plain version repeats, so the two agree bitwise, residual included:
  n + 1 launches a call. The passes alternate `out` and one scratch field
  cached per shape and stream, the last landing in `out`.

Each iteration is the odd-parity half-sweep, the even one, and the 6-face
Neumann refresh. K5 and K6 update p in place; all return the sum of r²
over both half-sweeps of the LAST of their n_inner iterations, as a 0-dim
tensor on p's device.

What bounds them on the H100 is memory bandwidth: the least a call must
move is p and rhs read once and p written once (3 field-sizes, ~61.5 us at
256³ f32). The design of K5 is the 2-D kernels' (ops/sor_kernels.py): a
launch per colour per iteration, a Neumann launch, per-block partial sums
of r² on the last iteration and a one-block fixed-order sum, so the
residual and every iteration count are reproducible.

K6 has two designs, picked by the capacity rule `octant_tiles` (a function
of the shape and the dtype alone):
- on chip (`rb_sor3d_octants_onchip`, its own launch counter), wherever
  the stacked octants of p and rhs fit the card's shared memory as one
  tile per CTA, at most SMS = 132 tiles (both NS-3D main-path fields: 128³
  float32 and canal3d.par's 200x50x50 float64): one cooperative launch a
  call. Each CTA keeps its tile of all eight slots in shared memory for
  the whole call; after each half-sweep it writes its boundary planes to
  p, waits for its face neighbours to have done the same (an epoch word a
  tile) and reads theirs (the source note of csrc/sor3d_rb.cu). Its residual is summed per tile in a
  fixed order and then over the tiles (`octant_tile_residual`), which the
  plain version repeats bit for bit;
- multi-launch (`rb_sor3d_octants`, as before) for fields that do not fit
  (256³ float32): 3n + 1 launches, K5's pattern on the octants, the plain
  version summing octant by octant (within round-off of the kernel's
  per-block partials).
`dispatch.last("sor3d_octants")` names the design of the last call.

For a CPU tensor each wrapper runs its plain version; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import build as kb
from ..utils.dispatch import record
from .sor3d import checkerboard_mask_3d, neumann_faces_3d, sor_pass_3d
from .sor_kernels import (
    _SUFFIX,
    _check,
    card_of,
    check_out,
    ordered_r2_sum,
    residual_buffers,
)
from .sor_obsdist import SMEM_LIMIT, _flag_pitch
from .sor_octants import BITS, interior_slices, octant_sums, sweeps_octants

SOURCE = "pampi_tpu_torch/csrc/sor3d_rb.cu"
RB_SOR3D_CHECKERBOARD = kb.register(
    "rb_sor3d_checkerboard", SOURCE, "pampi_tpu/ops/sor3d_pallas.py:388")
RB_SOR3D_OCTANTS = kb.register(
    "rb_sor3d_octants", SOURCE, "pampi_tpu/ops/sor3d_pallas.py:735")
RB_SOR3D_OCTANTS_ONCHIP = kb.register(
    "rb_sor3d_octants_onchip", SOURCE, "pampi_tpu/ops/sor3d_pallas.py:735")
RB_SOR3D_MASKED = kb.register(
    "rb_sor3d_checkerboard_masked", SOURCE,
    "pampi_tpu/ops/sor3d_pallas.py:388")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SOR_ARGS = [_I, _V, _V, _I, _I, _I, _I, _D, _D, _D, _D, _V, _V, _V]
_SIGNATURES = {
    f"rb_sor3d_{layout}_{t}": _SOR_ARGS
    for layout in ("checkerboard", "octants") for t in ("f32", "f64")
}
_SIGNATURES["rb_sor3d_checkerboard_partials"] = [_I, _I, _I]
_SIGNATURES["rb_sor3d_octants_partials"] = [_I, _I, _I]
_MASKED_ARGS = [_I, _V, _V, _V, _V, _V, _D, _D, _D, _D, _V, _V, _V, _V, _V]
_SIGNATURES.update({f"rb_sor3d_masked_{t}": _MASKED_ARGS
                    for t in ("f32", "f64")})
_SIGNATURES.update({f"rb_sor3d_octants_onchip_{t}": [
    _I, _V, _V, _V, _I, _D, _D, _D, _D, _V, _V, ctypes.c_uint, _V, _V]
    for t in ("f32", "f64")})
# the masked mode's CTAs (csrc/sor3d_rb.cu's run_masked3d): MASKED_BLOCKS
# an SM, the ring's shared memory and the registers split among them;
# boxes a warp's MTX columns wide and, by element size, up to _ROWS5 rows
# (the threads' row pairs)
MASKED_BLOCKS = 2
SMEM_SM = 233472  # the shared memory of an SM (228 KB)
MTX = 32
_ROWS5 = {4: 96, 8: 64}
# a pass is one iteration: the tiles' halo (2 cells that the two colour
# stages reach in from the box's edge, a wall-ghost cell's copy one more)
# and the ring's planes (the 4 that the stages read and the next one)
HALO5, RING5 = 3, 5
# the scratch field, r² volume and row sums of the masked mode's calls,
# per (shape, dtype, device, stream)
_BUFFERS: dict = {}
# K6 on chip: a CTA's threads (csrc/sor3d_rb.cu OT: 16 warps of 32), the
# most tiles (one CTA an SM of the H100, whatever card runs it, so that the
# residual's order depends on the shape and dtype alone), and per (device,
# stream) the residual's ticket and the tiles' epoch words (int32, 1 +
# OCT_TILES_MAX) with the count of epochs its calls have used
OCT_THREADS = 512
OCT_TILES_MAX = 132
_EPOCHS: dict = {}
_NP = {torch.float32: np.float32, torch.float64: np.float64}


def masked_stencil_3d(flags, dtype, omega, idx2, idy2, idz2):
    """(fac, lap) of the flag-masked stencil on the interior of a
    (K'+2, J'+2, I'+2) block, from the six neighbours' flags (e, w, n, s,
    b, f): fac = (denom > 0 ? omega/denom : 0)·flag and lap(x) the
    eps-coefficient Laplacian on x's interior, in
    sor3d_pallas.masked_stencil_ops_3d's operation order."""
    fl = flags.to(dtype)
    c = fl[1:-1, 1:-1, 1:-1]
    eps = (fl[1:-1, 1:-1, 2:], fl[1:-1, 1:-1, :-2], fl[1:-1, 2:, 1:-1],
           fl[1:-1, :-2, 1:-1], fl[2:, 1:-1, 1:-1], fl[:-2, 1:-1, 1:-1])
    e, w, n, s, b, f = eps
    denom = (e + w) * idx2 + (n + s) * idy2 + (b + f) * idz2
    om = torch.full((), omega, dtype=dtype, device=fl.device)
    zero = torch.zeros((), dtype=dtype, device=fl.device)
    fac = torch.where(denom > 0, om / denom, zero) * c

    def lap(x):
        xc = x[1:-1, 1:-1, 1:-1]
        return ((e * (x[1:-1, 1:-1, 2:] - xc) + w * (x[1:-1, 1:-1, :-2] - xc))
                * idx2
                + (n * (x[1:-1, 2:, 1:-1] - xc) + s * (x[1:-1, :-2, 1:-1] - xc))
                * idy2
                + (b * (x[2:, 1:-1, 1:-1] - xc) + f * (x[:-2, 1:-1, 1:-1] - xc))
                * idz2)

    return fac, lap


def _launch(kernel, entry: str, p, rhs, dims, n_inner, factor, idx2, idy2,
            idz2):
    lib = kb.load("sor3d_rb", _SIGNATURES)
    partial = torch.empty(getattr(lib, f"{entry}_partials")(*dims),
                          dtype=p.dtype, device=p.device)
    out = torch.empty((), dtype=p.dtype, device=p.device)
    err = getattr(lib, f"{entry}_{_SUFFIX[p.dtype]}")(
        p.device.index, p.data_ptr(), rhs.data_ptr(), *dims, n_inner,
        factor, idx2, idy2, idz2, partial.data_ptr(), out.data_ptr(),
        kb.stream_of(p))
    kb.check(lib, err, entry)
    kernel.launches += 1
    return out


def rb_sor3d_checkerboard_plain(p, rhs, n_inner, factor, idx2, idy2, idz2):
    """K5's plain version: n_inner (odd, even, Neumann) iterations with
    ops/sor3d.py, in place on p."""
    kmax, jmax, imax = (n - 2 for n in p.shape)
    odd = checkerboard_mask_3d(kmax, jmax, imax, 1, p.dtype, p.device)
    even = checkerboard_mask_3d(kmax, jmax, imax, 0, p.dtype, p.device)
    for _ in range(n_inner):
        _, r0 = sor_pass_3d(p, rhs, odd, factor, idx2, idy2, idz2)
        _, r1 = sor_pass_3d(p, rhs, even, factor, idx2, idy2, idz2)
        neumann_faces_3d(p)
    return r0 + r1


def rb_sor3d_masked_plain(p, rhs, flags, n_inner, omega, idx2, idy2,
                          idz2):
    """K5's masked mode, plain: n_inner (odd, even, Neumann) iterations in
    place on p, a cell updating only where it is interior, of the colour
    and fluid. Returns Σr² of the last iteration in ordered_r2_sum's
    order."""
    return ordered_r2_sum(masked_sweeps_3d(p, rhs, flags, n_inner, omega,
                                           idx2, idy2, idz2))


def masked_sweeps_3d(p, rhs, flags, n_inner, omega, idx2, idy2, idz2):
    """rb_sor3d_masked_plain's iterations, in place on p. Returns the last
    iteration's r² on the interior (0 on every cell that does not
    update)."""
    kmax, jmax, imax = (n - 2 for n in p.shape)
    fluid = flags[1:-1, 1:-1, 1:-1] != 0
    odd = (checkerboard_mask_3d(kmax, jmax, imax, 1, torch.uint8, p.device)
           != 0) & fluid
    even = (checkerboard_mask_3d(kmax, jmax, imax, 0, torch.uint8, p.device)
            != 0) & fluid
    fac, lap = masked_stencil_3d(flags, p.dtype, omega, idx2, idy2, idz2)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    rhs_c = rhs[1:-1, 1:-1, 1:-1]
    r_odd = r_evn = None
    for _ in range(n_inner):
        r_odd = torch.where(odd, rhs_c - lap(p), zero)
        p[1:-1, 1:-1, 1:-1] = p[1:-1, 1:-1, 1:-1] - fac * r_odd
        r_evn = torch.where(even, rhs_c - lap(p), zero)
        p[1:-1, 1:-1, 1:-1] = p[1:-1, 1:-1, 1:-1] - fac * r_evn
        neumann_faces_3d(p)
    return r_odd * r_odd + r_evn * r_evn


def rb_sor3d_checkerboard(p, rhs, n_inner, factor, idx2, idy2, idz2,
                          flags=None, omega=None, out=None):
    """K5 on a (kmax+2, jmax+2, imax+2) p, in place. Returns Σr² of the
    last iteration (0-dim tensor). With `flags` (uint8 of p's shape, 0 on
    obstacle cells) the masked mode, which relaxes with `omega` (the
    per-cell factor comes from the flags; `factor` is not read) and needs
    `out`: it reads p and writes the new field into out (p untouched)."""
    if flags is not None:
        return _masked(p, rhs, flags, n_inner, omega, idx2, idy2, idz2, out)
    if out is not None:
        raise ValueError("K5 takes out= in its masked mode only")
    if p.device.type == "cpu":
        return rb_sor3d_checkerboard_plain(p, rhs, n_inner, factor, idx2,
                                           idy2, idz2)
    _check(p, rhs, n_inner)
    if p.dim() != 3:
        raise ValueError(f"checkerboard p must be 3-D, got {tuple(p.shape)}")
    return _launch(RB_SOR3D_CHECKERBOARD, "rb_sor3d_checkerboard", p, rhs,
                   tuple(n - 2 for n in p.shape), n_inner, factor, idx2,
                   idy2, idz2)


def _masked(p, rhs, flags, n_inner, omega, idx2, idy2, idz2, out):
    if omega is None or out is None:
        raise ValueError("the masked mode needs omega and out")
    check_out("masked K5", p, out)
    if p.device.type == "cpu":
        out.copy_(p)
        return rb_sor3d_masked_plain(out, rhs, flags, n_inner, omega, idx2,
                                     idy2, idz2)
    _check(p, rhs, n_inner)
    if (p.dim() != 3 or flags.dtype != torch.uint8
            or flags.device != p.device or flags.shape != p.shape
            or not flags.is_contiguous()):
        raise ValueError("masked K5 needs a 3-D p and contiguous uint8 flags "
                         "of its shape on its device")
    K, J, I = (n - 2 for n in p.shape)
    lib = kb.load("sor3d_rb", _SIGNATURES)
    entry = getattr(lib, f"rb_sor3d_masked_{_SUFFIX[p.dtype]}")
    geo = masked_geometry(K, J, I, p.element_size())
    res = torch.empty((), dtype=p.dtype, device=p.device)
    with card_of(p):
        stream = kb.stream_of(p)
        key = (tuple(p.shape), p.dtype, p.device, stream)
        bufs = _BUFFERS.get(key)
        if bufs is None:
            bufs = _BUFFERS[key] = (
                torch.empty_like(p),
                torch.empty((K, J, I), dtype=p.dtype, device=p.device),
                torch.empty(K * J, dtype=p.dtype, device=p.device))
        scratch, r2, rsum = bufs
        ticket, _ = residual_buffers(p, stream, 1)
        src = p
        for k in range(n_inner):
            # the passes alternate out and the scratch field, the last
            # landing in out
            last = k == n_inner - 1
            dst = out if (n_inner - 1 - k) % 2 == 0 else scratch
            err = entry(p.device.index, src.data_ptr(), rhs.data_ptr(),
                        flags.data_ptr(), dst.data_ptr(), geo, omega, idx2,
                        idy2, idz2, r2.data_ptr() if last else None,
                        rsum.data_ptr(), ticket.data_ptr(), res.data_ptr(),
                        stream)
            kb.check(lib, err, "rb_sor3d_masked")
            src = dst
    RB_SOR3D_MASKED.launches += 1
    return res


@dataclass(frozen=True)
class MaskedPass:
    """A pass of the masked mode: one iteration on owned tiles (tk, tj,
    ti) with a halo of HALO5 cells, streamed along k through a ring of
    RING5 planes of rows x P cells of p and rhs and rows x Pf flag
    bytes."""

    tk: int
    tj: int
    ti: int
    rows: int
    P: int  # row pitch of p (and rhs) in shared memory (elements, even)
    Pf: int  # row pitch of the flags (bytes)
    smem: int  # dynamic shared memory a CTA takes (bytes)


def _tiles(extent: int, box: int, ht: int):
    """(owned tile extent, count) of one axis: the fewest tiles whose boxes
    (the tile and ht cells a side) fit `box`, of near-equal extent; the
    whole extent where it fits the box. None where no tile fits."""
    if extent <= box:
        return extent, 1
    if box <= 2 * ht:
        return None
    t = -(-extent // -(-extent // (box - 2 * ht)))
    return t, -(-extent // t)


def masked_pass(K: int, J: int, I: int, itemsize: int = 4,
                sms: int | None = None) -> MaskedPass:
    """The plan of a pass of the masked mode on the (K+2, J+2, I+2) field.
    The tile halo is HALO5, K16's at one iteration: the two colour stages
    reach 2 cells in from the box's edge, a wall-ghost cell's copy one
    more. The box is a warp's 32 columns wide and as tall as the ring of
    RING5 planes in shared memory (227 KB) and the threads' row pairs
    allow, at MASKED_BLOCKS CTAs an SM (two ran faster than one at the
    timed shape, PERF.md §6); the (j, i) tiles are the fewest that
    fit it, of near-equal extent, and k is cut into as many slabs as the
    SMs can take (one wave: a CTA's time is its planes and a fixed 2 HALO5
    + 2 steps of halo and ring)."""
    from .sor_obsdist3d import SMS

    sms = SMS if sms is None else sms
    ek, ej, ei = K + 2, J + 2, I + 2
    ti_n = _tiles(ei, MTX, HALO5)
    w = min(ei, ti_n[0] + 2 * HALO5) if ti_n else MTX
    P, Pf = w + (w & 1), _flag_pitch(w)
    per_row = RING5 * (2 * P * itemsize + Pf)
    budget = min(SMEM_LIMIT, SMEM_SM // MASKED_BLOCKS - 1024)
    tj_n = _tiles(ej, min(budget // per_row, _ROWS5[itemsize]), HALO5)
    if ti_n is None or tj_n is None:
        raise ValueError("no masked K5 box fits")
    (tj, nj), (ti, ni) = tj_n, ti_n
    rows = min(ej, tj + 2 * HALO5)
    slabs = max(1, min(sms * MASKED_BLOCKS // (nj * ni), ek))
    return MaskedPass(-(-ek // slabs), tj, ti, rows, P, Pf, rows * per_row)


def masked_tiles(K: int, J: int, I: int, pl: MaskedPass):
    """The owned tiles (k0, k1, j0, j1, i0, i1) of a pass: they partition
    the field, its wall shell included, so the kernel writes each cell
    once. The CTA of a tile streams the box of the tile and HALO5 cells a
    side, clipped to the field."""
    ek, ej, ei = K + 2, J + 2, I + 2
    return [(k0, min(k0 + pl.tk, ek), j0, min(j0 + pl.tj, ej), i0,
             min(i0 + pl.ti, ei))
            for k0 in range(0, ek, pl.tk) for j0 in range(0, ej, pl.tj)
            for i0 in range(0, ei, pl.ti)]


@functools.lru_cache(maxsize=64)
def masked_geometry(K: int, J: int, I: int, itemsize: int):
    """The kernel's geometry array of a pass, made once per field shape
    (the CLI's solves call the masked mode at n = 1 on a small field,
    where the host's work is the call's cost)."""
    pl = masked_pass(K, J, I, itemsize)
    if pl.smem > SMEM_LIMIT:
        raise ValueError(f"a masked K5 pass takes {pl.smem} bytes of shared "
                         "memory")
    return (ctypes.c_int * 10)(K + 2, J + 2, I + 2, pl.tk, pl.tj, pl.ti,
                               pl.rows, pl.P, pl.Pf, pl.smem)


@dataclass(frozen=True)
class OctantTiles:
    """K6's on-chip plan: tiles of (ts, tr, tc) octant cells, ns x nr x nc
    of them, tile t = (t // (nr nc), t // nc % nr, t % nc); a CTA's shared
    memory: each slot's box of p (the tile and one face per axis) and its
    tile of rhs, and 32 warp sums."""

    ts: int
    tr: int
    tc: int
    ns: int
    nr: int
    nc: int
    smem: int

    @property
    def tiles(self) -> int:
        return self.ns * self.nr * self.nc


def _tile_extents(n: int):
    """The tile extents worth trying on an axis of n cells: the least
    extent for each tile count."""
    return sorted({-(-n // m) for m in range(1, n + 1)})


@functools.lru_cache(maxsize=64)
def octant_tiles(K2: int, J2: int, I2: int, itemsize: int):
    """The capacity rule of K6's on-chip design: the plan of the (K2, J2,
    I2) octants at `itemsize` bytes a cell, or None where they do not fit
    (then the multi-launch design runs). A plan has at most OCT_TILES_MAX
    tiles, each CTA's boxes fit SMEM_LIMIT, a box row fits a warp (tc <
    32) and a colour's faces come to at most four cells a thread; of
    those, the one of the smallest box (the least work and face traffic a
    CTA), then the fewest tiles, then the longest rows. A function of the
    shape and the dtype alone, so the residual's order is too."""
    if 8 * K2 * J2 * I2 >= 2 ** 31:  # the kernel's 32-bit offsets
        return None
    best = None
    for ts in _tile_extents(K2):
        ns = -(-K2 // ts)
        for tr in _tile_extents(J2):
            nr = -(-J2 // tr)
            for tc in _tile_extents(I2):
                nc = -(-I2 // tc)
                if (ns * nr * nc > OCT_TILES_MAX or tc >= 32
                        or tr * tc + ts * tc + ts * tr > OCT_THREADS):
                    continue
                box = (ts + 1) * (tr + 1) * (tc + 1)
                smem = itemsize * (8 * box + 8 * ts * tr * tc + 32)
                if smem > SMEM_LIMIT:
                    continue
                key = (box, ns * nr * nc, -tc)
                if best is None or key < best[0]:
                    best = (key, OctantTiles(ts, tr, tc, ns, nr, nc, smem))
    return None if best is None else best[1]


def octant_tile_list(K2: int, J2: int, I2: int, pl: OctantTiles):
    """The tiles (s0, s1, r0, r1, c0, c1) of a plan in tile order: they
    partition the octants' index space."""
    return [(s0, min(s0 + pl.ts, K2), r0, min(r0 + pl.tr, J2), c0,
             min(c0 + pl.tc, I2))
            for s0 in range(0, pl.ns * pl.ts, pl.ts)
            for r0 in range(0, pl.nr * pl.tr, pl.tr)
            for c0 in range(0, pl.nc * pl.tc, pl.tc)]


@functools.lru_cache(maxsize=64)
def octant_geometry(K2: int, J2: int, I2: int, itemsize: int):
    """The on-chip kernel's geometry array (made once per shape)."""
    pl = octant_tiles(K2, J2, I2, itemsize)
    return (ctypes.c_int * 10)(K2, J2, I2, pl.ts, pl.tr, pl.tc, pl.ns,
                               pl.nr, pl.nc, pl.smem)


@functools.lru_cache(maxsize=64)
def octant_design(pl, n_inner: int) -> str:
    """The text `record` keeps for a K6 call of plan pl (None: the
    multi-launch design)."""
    if pl is None:
        return f"multi-launch ({3 * n_inner + 1} launches a call)"
    return (f"on chip: {pl.tiles} tiles of {pl.ts}x{pl.tr}x{pl.tc}, one "
            f"cooperative launch a call")


def _seq_sum(x):
    """The on-chip kernel's sum of each row of x (rows, n), a numpy array
    (csrc/sor3d_rb.cu seq_sum): thread t adds its run of c = ceil(n /
    OCT_THREADS) cells from the first, each warp's 32 thread sums are
    added in lane order and the warps' in warp order. Threads and warps
    past the cells hold +0, which leaves a sum of squares as it is, so
    they are left out here: a few vector adds, cheap on the CPU, where the
    plain solves call it every iteration. Returns (rows,)."""
    rows, n = x.shape
    c = -(-n // OCT_THREADS)
    threads = -(-n // c)
    warps = -(-threads // 32)
    x = np.concatenate([x, np.zeros((rows, warps * 32 * c - n), x.dtype)],
                       axis=1).reshape(rows, warps, 32, c)
    acc = x[..., 0]
    for k in range(1, c):
        acc = acc + x[..., k]
    lanes = acc[..., 0]
    for k in range(1, 32):
        lanes = lanes + acc[..., k]
    total = lanes[:, 0]
    for k in range(1, warps):
        total = total + lanes[:, k]
    return total


@functools.lru_cache(maxsize=16)
def _tile_order(K2: int, J2: int, I2: int, pl: OctantTiles):
    """The order of octant_tile_residual: (tiles, 8 ts tr tc) indices into
    the slots' interior r² concatenated in BITS order (each row-major), the
    index past them (a 0) where a tile's cell lies past the octants or off
    its slot's interior."""
    starts, size = [], 0
    for bits in BITS:
        starts.append(size)
        size += (K2 - 1) * (J2 - 1) * (I2 - 1)
    t_s, t_r, t_c = np.meshgrid(np.arange(pl.ns), np.arange(pl.nr),
                                np.arange(pl.nc), indexing="ij")
    d_s, d_r, d_c = np.meshgrid(np.arange(pl.ts), np.arange(pl.tr),
                                np.arange(pl.tc), indexing="ij")
    s = (t_s.reshape(-1, 1) * pl.ts + d_s.reshape(1, -1))
    r = (t_r.reshape(-1, 1) * pl.tr + d_r.reshape(1, -1))
    c = (t_c.reshape(-1, 1) * pl.tc + d_c.reshape(1, -1))
    out = []
    for start, (pk, pj, pi) in zip(starts, BITS):
        # an interior drops index 0 on a bit-0 axis, the last on a bit-1 one
        ls, lr, lc = s - (1 - pk), r - (1 - pj), c - (1 - pi)
        ok = ((ls >= 0) & (ls < K2 - 1) & (lr >= 0) & (lr < J2 - 1)
              & (lc >= 0) & (lc < I2 - 1))
        out.append(np.where(ok, start + (ls * (J2 - 1) + lr) * (I2 - 1) + lc,
                            size))
    return np.concatenate(out, axis=1)


def _slots_tile_residual(r2s, shape, pl: OctantTiles):
    """octant_tile_residual of the slots' interior r² (BITS order)."""
    idx = _tile_order(*shape, pl)
    dtype, device = r2s[0].dtype, r2s[0].device
    flat = np.concatenate([x.detach().cpu().numpy().reshape(-1) for x in r2s]
                          + [np.zeros(1, dtype=_NP[dtype])])
    total = np.add.accumulate(_seq_sum(flat[idx]))[-1]
    return torch.tensor(total, dtype=dtype, device=device)


def octant_tile_residual(r2, pl: OctantTiles):
    """The on-chip kernel's Σr² of an (8, K2, J2, I2) volume of r² whose
    cells off their slot's interior do not count (the kernel stashes 0
    there): each tile's 8 ts tr tc cells in (slot, s, r, c) order, cells
    past the octants 0, through _seq_sum; then the tiles' partials added
    in tile order. A 0-dim tensor, equal bit for bit to the kernel's."""
    return _slots_tile_residual(
        [r2[k][interior_slices(bits)] for k, bits in enumerate(BITS)],
        tuple(r2.shape[1:]), pl)


def rb_sor3d_octants_plain(q, f, n_inner, factor, idx2, idy2, idz2):
    """K6's plain version: ops/sor_octants.sweeps_octants, in place on the
    octants of q. Σr² of the last iteration in the order of the design
    that the capacity rule picks: octant_tile_residual's (on chip, bitwise
    the kernel's) or octant by octant (multi-launch)."""
    rs = sweeps_octants(dict(zip(BITS, q.unbind(0))),
                        dict(zip(BITS, f.unbind(0))), n_inner, factor,
                        idx2, idy2, idz2)
    pl = octant_tiles(*q.shape[1:], q.element_size())
    if pl is None:
        return octant_sums(rs)
    return _slots_tile_residual([rs[b] * rs[b] for b in BITS],
                                tuple(q.shape[1:]), pl)


def rb_sor3d_octants(q, f, n_inner, factor, idx2, idy2, idz2):
    """K6 on stacked octants q, f of shape (8, K2, J2, I2), in place on q.
    Returns Σr² of the last iteration (0-dim tensor). The capacity rule
    (octant_tiles) picks the design; `record` names it."""
    pl = octant_tiles(*q.shape[1:], q.element_size())
    record("sor3d_octants", octant_design(pl, n_inner))
    if q.device.type == "cpu":
        return rb_sor3d_octants_plain(q, f, n_inner, factor, idx2, idy2, idz2)
    _check(q, f, n_inner)
    if q.dim() != 4 or q.shape[0] != 8 or min(q.shape[1:]) < 2:
        raise ValueError(f"octants must be (8, K2, J2, I2), got {tuple(q.shape)}")
    if pl is None:
        return _launch(RB_SOR3D_OCTANTS, "rb_sor3d_octants", q, f,
                       tuple(q.shape[1:]), n_inner, factor, idx2, idy2, idz2)
    geo = octant_geometry(*q.shape[1:], q.element_size())
    lib = kb.load("sor3d_rb", _SIGNATURES)
    out = torch.empty((), dtype=q.dtype, device=q.device)
    with card_of(q):
        stream = kb.stream_of(q)
        _, partial = residual_buffers(q, stream, pl.tiles)
        key = (q.device.index, stream)
        words = _EPOCHS.get(key)
        if words is None:
            words = _EPOCHS[key] = [torch.zeros(
                1 + OCT_TILES_MAX, dtype=torch.int32, device=q.device), 0]
        base = words[1]
        words[1] = (base + 2 * n_inner) & 0xFFFFFFFF
        err = getattr(lib, f"rb_sor3d_octants_onchip_{_SUFFIX[q.dtype]}")(
            q.device.index, q.data_ptr(), f.data_ptr(), geo, n_inner, factor,
            idx2, idy2, idz2, partial.data_ptr(), words[0].data_ptr(), base,
            out.data_ptr(), stream)
    kb.check(lib, err, "rb_sor3d_octants_onchip")
    RB_SOR3D_OCTANTS_ONCHIP.launches += 1
    return out
