"""Kernels K1, K2 and K17: red-black SOR on the H100, each beside its
plain PyTorch version (sources: pampi_tpu_torch/csrc/sor_rb.cu).

K1 `rb_sor_quarters` replaces pampi_tpu/ops/sor_pallas.py
  `_tblock_quarters_kernel` (make_rb_iter_tblock_quarters, pallas_call at
  :964): n_inner iterations on the stacked quarter planes (4, J2, I2) =
  [R0, R1, B0, B1] of pampi_tpu_torch/ops/sor_quarters.py, in one
  pass a call (csrc/sor_rb.cu q_tiled): owned tiles with a halo of n
  quarter cells, each thread holding a column run of the four slots of p
  and rhs in registers and publishing its cells to shared memory after
  each colour; one launch with `out=` (the solve loop swaps two planes),
  the residual per tile and then over the tiles in tile order
  (`quarters_residual`, which the plain version repeats: bitwise).
K1's bf16-storage mode (`rb_sor_quarters` on bfloat16 planes) replaces the
  compute_dtype branch of the same TPU kernel: bf16 planes, all n_inner
  iterations of a call in float32, the plane rounded to bf16 once, at the
  store, and a float32 residual. Its kernel is K13's one-pass tiled
  template (ops/sor_qdist.rb_sor_quarters_bf16, csrc/sor_qdist.cu): one
  launch a call, with `out=`; its launches count on `rb_sor_quarters_bf16`.
K2 `rb_sor_checkerboard` replaces pampi_tpu/ops/sor_pallas.py
  `_tblock_kernel` (make_rb_iter_tblock, plain mode, pallas_call at :620):
  the same function on the natural (jmax+2, imax+2) checkerboard, in one
  pass a call (csrc/sor_rb.cu cb_tiled): owned tiles with a halo of 2n + 1
  grid cells, each thread holding a column run of p and rhs in registers
  (its red and its black cells) and publishing its cells to shared memory
  after each colour, the Neumann copy folded into the reads; one launch
  with `out=` (the Poisson loop swaps two fields), the residual per tile
  and then over the tiles in tile order (`checkerboard_residual`, which
  the plain version repeats: bitwise).

K2's masked mode (`rb_sor_checkerboard(..., flags=, omega=)`) replaces
  the masked mode of the same TPU kernel (_tblock_kernel(masked=True), the
  NS-2D obstacle solve): a cell updates only where it is fluid, with
  per-direction coefficients and the relaxation factor omega/denom formed
  from uint8 flags (1 byte a cell) in the field's dtype, as
  sor_pallas.masked_stencil_ops forms them (`masked_stencil_2d`, which
  K15's plain version shares). Its launches count on their own kernel
  entry, `rb_sor_checkerboard_masked`. It is K15's kernel (the tiled
  template of csrc/sor_tiles2d.cuh) on the whole field as a block of
  H = 1 at offsets 0: all n_inner iterations in one pass through shared
  memory, one launch a call, out of place: it reads p and writes `out`
  (the solver swaps two fields), the tiles at the field's edge refreshing
  its wall-ghost ring. Its
  residual is summed per tile and then over the tiles in tile order
  (`tiled_residual`), which the plain version repeats, so the two agree
  bitwise, residual included. Bound: 13 bytes a cell at float32, ~65 us
  at 8192x2048; the sweeps' issue rate bounds it in fact, as K15.
K17 `rb_sor_blocked` replaces pampi_tpu/ops/sor_pallas.py `_rb_kernel`
  (make_rb_iter_pallas, pallas_call at :1049; its one caller is
  models/poisson.make_rb_step_padded(kernel="blocked")): ONE red-black
  iteration, red then black, the sum of r² over both half-sweeps, then the
  Neumann ghost copy. Its design is the TPU kernel's band walk (a CTA owns
  a band of rows and stages it with a halo in shared memory, one launch
  per colour; csrc/sor_rb.cu says more). Its fields equal K2's at n_inner
  1 bit for bit, and its plain version repeats its summation order.

K2's dynamic-extent mode `rb_sor_class` replaces the shape-class mode of
  the same TPU kernel (_tblock_kernel(dynamic=True), make_rb_iter_tblock(
  dynamic=True): the fleet's padded class solve): n_inner iterations on
  every solving lane of a batch of (jc+2, ic+2) class blocks at once, each
  lane at its own extents (ext (N, 2) int32: jmax, imax) with its own
  update constants (geo (N, 3): factor, idx2, idy2, in p's dtype), in
  one launch a call with `out=` (csrc/sor_rb.cu cls_tiled): a CTA
  per tile of a lane's block (tiles of a side that depends on the dtype
  and n only, `class_tile`), all n iterations in shared memory; cells
  beyond a lane's live corner, and every cell of a lane whose `solving`
  flag is false, are copied into out unchanged. It returns each lane's
  Σr² of its last iteration, (N,), summed per tile and then over the
  lane's own tiles (`class_residual`, which the plain version repeats),
  so a lane is bitwise the same in every rung and beside any batchmates,
  residual included. Its launches count on their own kernel entry,
  `rb_sor_class`; its partial, ticket and result buffers are made once
  per stream and batch.

K17 updates p in place; K1, K2 (plain and masked) and the class mode
read p and write `out` (without `out`, K1, plain K2 and the class mode
copy the new field back: a second launch). All return the sum of r² over
both half-sweeps of the LAST of their iterations, as a 0-dim tensor on
p's device (the class mode one per lane).

What bounds them on the H100 is memory bandwidth (~10 flops per cell
update). The least any implementation must move per call is p and rhs read
once and p written once: ~60 us at 4096² f32 whatever n_inner is. K1, K2
(plain and masked) and the class mode run all n_inner iterations of a call
in one pass (temporal blocking, as the TPU kernels do); their residuals are
per-tile fixed-order sums, so every iteration count is reproducible.

For a CPU tensor each wrapper runs its plain version; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import build as kb
from .sor import checkerboard_mask, interior_residual, neumann_bc, sor_pass
from .sor_quarters import rb_sweeps_quarters_rs

SOURCE = "pampi_tpu_torch/csrc/sor_rb.cu"
RB_SOR_QUARTERS = kb.register(
    "rb_sor_quarters", SOURCE, "pampi_tpu/ops/sor_pallas.py:964")
RB_SOR_CHECKERBOARD = kb.register(
    "rb_sor_checkerboard", SOURCE, "pampi_tpu/ops/sor_pallas.py:620")
RB_SOR_MASKED = kb.register(
    "rb_sor_checkerboard_masked", SOURCE, "pampi_tpu/ops/sor_pallas.py:620")
RB_SOR_BLOCKED = kb.register(
    "rb_sor_blocked", SOURCE, "pampi_tpu/ops/sor_pallas.py:1049")
RB_SOR_CLASS = kb.register(
    "rb_sor_class", SOURCE, "pampi_tpu/ops/sor_pallas.py:620")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {"rb_sor_blocked_partials": [_I]}
for _t in ("f32", "f64"):
    # dev, q, f, out, geo, factor, idx2, idy2, partial, ticket, res, stream
    _SIGNATURES[f"rb_sor_quarters_{_t}"] = [_I, _V, _V, _V, _V, _D, _D, _D,
                                            _V, _V, _V, _V]
    _SIGNATURES[f"rb_sor_checkerboard_{_t}"] = [_I, _V, _V, _V, _V, _D, _D,
                                                _D, _V, _V, _V, _V]
    _SIGNATURES[f"rb_sor_masked_{_t}"] = [_I, _V, _V, _V, _V, _V, _D, _D, _D,
                                          _V, _V, _V, _V]
    _SIGNATURES[f"rb_sor_blocked_{_t}"] = [_I, _V, _V, _I, _I, _D, _D, _D,
                                           _V, _V, _V]
    # dev, p, rhs, out, ext, geo, solving, lanes, gi, partial, ticket, res,
    # stream
    _SIGNATURES[f"rb_sor_class_{_t}"] = [_I, _V, _V, _V, _V, _V, _V, _I, _V,
                                         _V, _V, _V, _V]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
FIN = 1024  # threads of the kernels' one-block final sum (sum_partials)
BAND, TILE = 8, 256  # K17's rows per CTA and columns per tile (sor_rb.cu)
# a tiled kernel's CTA (csrc/sor_tiles2d.cuh's TX x TY threads)
TX_TILED, TY_TILED = 32, 16
NT_TILED = TX_TILED * TY_TILED
# per (device, stream): the residual's ticket and its partial buffers
_TICKETS: dict = {}
_PARTIALS: dict = {}


def fixed_order_sum(flat, threads: int = FIN):
    """The one-block fixed-order sum of a 1-D tensor that the kernels'
    sum_partials takes on the card: thread t of `threads` (FIN there)
    adds elements t, t + threads, ... in turn, then a halving tree over
    the threads. Returns a 0-dim tensor equal bit for bit to the
    kernels'."""
    m = max(1, -(-flat.numel() // threads))
    padded = torch.zeros(m * threads, dtype=flat.dtype, device=flat.device)
    padded[:flat.numel()] = flat
    s = torch.zeros(threads, dtype=flat.dtype, device=flat.device)
    for r in range(m):
        s = s + padded[r * threads:(r + 1) * threads]
    return _tree(s)[..., 0]


def _tree(s):
    """The halving tree over the last axis (a power of two) that a block's
    shared-memory reduction takes: s[:h] + s[h:2h], h = n/2, n/4, ..."""
    st = s.shape[-1] // 2
    while st > 0:
        s = s[..., :st] + s[..., st:2 * st]
        st //= 2
    return s


def tile_partials(r2, th, tw):
    """The tiled kernels' per-CTA partial sums (K13 and masked K2;
    csrc/sor_tiles2d.cuh's tile_residual): r2 of shape (..., ej, ei) (the
    last iteration's r², 0 where nothing counts) is cut into tiles of th x
    tw cells, row-major; thread (tx, ty) of a tile's CTA adds the tile's
    cells (ty + TY·k, tx + TX·m), leading index by leading index, k-major,
    and a halving tree over tid = TX·ty + tx reduces the threads. Returns
    the partials in CTA order."""
    *lead, ej, ei = r2.shape
    gy, gx = -(-ej // th), -(-ei // tw)
    kk, mm = -(-th // TY_TILED), -(-tw // TX_TILED)
    wide = r2.new_zeros((*lead, gy, kk * TY_TILED, gx, mm * TX_TILED))
    tiles = torch.zeros((*lead, gy * th, gx * tw), dtype=r2.dtype,
                        device=r2.device)
    tiles[..., :ej, :ei] = r2
    wide[..., :, :th, :, :tw] = tiles.reshape(*lead, gy, th, gx, tw)
    cells = wide.reshape(-1, gy, kk, TY_TILED, gx, mm, TX_TILED)
    cells = cells.permute(1, 4, 0, 2, 5, 3, 6).reshape(
        gy * gx, -1, TY_TILED * TX_TILED)
    acc = r2.new_zeros((gy * gx, TY_TILED * TX_TILED))
    for k in range(cells.shape[1]):
        acc = acc + cells[:, k]
    return _tree(acc)[:, 0]


def tiled_residual(r2, th, tw):
    """The tiled kernels' residual: tile_partials, then the last CTA's sum
    of the partials in CTA order (fixed_order_sum over NT_TILED threads).
    A 0-dim tensor equal bit for bit to the kernels'."""
    return fixed_order_sum(tile_partials(r2, th, tw), NT_TILED)


def residual_buffers(t, stream: int, ntiles: int):
    """(ticket, partial) of a tiled kernel's launch on t's device and the
    stream `stream` (kb.stream_of(t)): the ticket an int32 0 that the
    kernels leave at 0, the partial buffer at least ntiles long. Both are
    made once per stream and reused: launches on one stream run in
    order."""
    key = (t.device.index, stream)
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=t.device)
        _TICKETS[key] = ticket
    pkey = key + (t.dtype,)
    partial = _PARTIALS.get(pkey)
    if partial is None or partial.numel() < ntiles:
        partial = torch.empty(ntiles, dtype=t.dtype, device=t.device)
        _PARTIALS[pkey] = partial
    return ticket, partial


def run_passes(p, launches, out, launch):
    """Run a tiled kernel's passes (K13, K15, masked K2): launches holds
    (tiles, geometry array) per pass, and launch(src, dst, geo, partial,
    ticket, res, stream) starts one and returns its CUDA error. The passes
    alternate two arrays so that the last lands in out (or, without out,
    in a new array copied back into p: a second launch). Returns the
    residual, a new 0-dim tensor (the caller keeps it across calls)."""
    target = torch.empty_like(p) if out is None else out
    scratch = torch.empty_like(p) if len(launches) > 1 else None
    res = torch.empty((), dtype=p.dtype, device=p.device)
    with card_of(p):
        stream = kb.stream_of(p)
        ticket, partial = residual_buffers(
            p, stream, max(ntiles for ntiles, _ in launches))
        src = p
        for k, (_, geo) in enumerate(launches):
            dst = target if (len(launches) - 1 - k) % 2 == 0 else scratch
            launch(src, dst, geo, partial, ticket, res, stream)
            src = dst
        if out is None:
            p.copy_(target)
    return res


def _lib():
    """K1/K2/K17's bound library (csrc/sor_rb.cu), built at first use."""
    return kb.load("sor_rb", _SIGNATURES)


def card_of(t):
    """The guard that makes t's card current for a launch and gives the
    caller its current card back (the shards of a mesh lie on several
    cards); nothing to do where t's card is current already."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def check_out(name, p, out):
    """The `out=` form's contract: a contiguous tensor of p's dtype, shape
    and device that is not p itself."""
    if (out.device != p.device or out.dtype != p.dtype
            or out.shape != p.shape or not out.is_contiguous()
            or out.data_ptr() == p.data_ptr()):
        raise ValueError(f"{name}: out must be a contiguous {p.dtype} block "
                         f"of p's shape on p's device, not p itself")


def ordered_r2_sum(r2):
    """The fixed-order sum of an array of r² that masked K5 and K16 take
    on the card: each row (the last axis) summed from its first
    cell up, then the rows, in row-major order, by fixed_order_sum. Returns
    a 0-dim tensor equal bit for bit to the kernels'."""
    rows = torch.zeros(r2.shape[:-1], dtype=r2.dtype, device=r2.device)
    for i in range(r2.shape[-1]):
        rows = rows + r2[..., i]
    return fixed_order_sum(rows.reshape(-1))


def masked_stencil_2d(flags, dtype, omega, idx2, idy2):
    """(fac, lap) of the flag-masked stencil on the interior of a
    (J'+2, I'+2) block, from the four neighbours' flags (e, w, n, s): fac =
    (denom > 0 ? omega/denom : 0)·flag and lap(x) the eps-coefficient
    Laplacian on x's interior, in sor_pallas.masked_stencil_ops' operation
    order, in `dtype`. The single home of the 2-D masked arithmetic:
    masked K2's and K15's plain versions and the thin-shard fallback of
    the distributed obstacle solve all take it."""
    fl = flags.to(dtype)
    c = fl[1:-1, 1:-1]
    e, w, n, s = fl[1:-1, 2:], fl[1:-1, :-2], fl[2:, 1:-1], fl[:-2, 1:-1]
    denom = (e + w) * idx2 + (n + s) * idy2
    om = torch.full((), omega, dtype=dtype, device=fl.device)
    zero = torch.zeros((), dtype=dtype, device=fl.device)
    fac = torch.where(denom > 0, om / denom, zero) * c

    def lap(x):
        xc = x[1:-1, 1:-1]
        return ((e * (x[1:-1, 2:] - xc) + w * (x[1:-1, :-2] - xc)) * idx2
                + (n * (x[2:, 1:-1] - xc) + s * (x[:-2, 1:-1] - xc)) * idy2)

    return fac, lap


def sor_coefficients(dx: float, dy: float, omega: float):
    """(factor, idx2, idy2) of the red-black update, formed in double
    exactly as the JAX package forms them (sor_pallas.py:595)."""
    dx2, dy2 = dx * dx, dy * dy
    factor = omega * 0.5 * (dx2 * dy2) / (dx2 + dy2)
    return factor, 1.0 / dx2, 1.0 / dy2


def _check(p: torch.Tensor, rhs: torch.Tensor, n_inner: int,
           dtypes=_SUFFIX) -> None:
    """A kernel's inputs on the card: float32 or float64 (`dtypes`: K1's
    bf16-storage mode takes bfloat16), contiguous, of one shape."""
    if p.device.type != "cuda":
        raise ValueError(f"SOR kernels take CPU or CUDA tensors, not {p.device}")
    if rhs.device != p.device or rhs.dtype != p.dtype or rhs.shape != p.shape:
        raise ValueError("p and rhs must share device, dtype and shape")
    if p.dtype not in dtypes:
        raise ValueError(f"this SOR kernel takes {', '.join(map(str, dtypes))}"
                         f", not {p.dtype}")
    if not (p.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("SOR kernels need contiguous p and rhs")
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")


def rb_sor_checkerboard_plain(p, rhs, n_inner, factor, idx2, idy2):
    """K2's plain version: n_inner (red, black, Neumann) iterations in
    place on p, each colour's cells taking c - factor·r (the other cells
    left as they are), the Neumann copy with corners untouched. Returns Σr²
    of the last iteration in the kernel's order (checkerboard_residual
    over the tiles of the call's last pass)."""
    r2 = checkerboard_sweeps(p, rhs, n_inner, factor, idx2, idy2)
    return checkerboard_residual(
        r2, checkerboard_passes(n_inner, p.element_size())[-1])


def checkerboard_sweeps(p, rhs, n_inner, factor, idx2, idy2):
    """rb_sor_checkerboard_plain's iterations, in place on p. Returns the
    last iteration's r² on the (jmax, imax) interior (each cell's from its
    own colour's half-sweep)."""
    jmax, imax = p.shape[0] - 2, p.shape[1] - 2
    red = checkerboard_mask(jmax, imax, 0, torch.bool, p.device)
    black = ~red
    inner = p[1:-1, 1:-1]
    r_red = r_blk = None
    for _ in range(n_inner):
        r_red = interior_residual(p, rhs, idx2, idy2)
        inner.copy_(torch.where(red, inner - factor * r_red, inner))
        r_blk = interior_residual(p, rhs, idx2, idy2)
        inner.copy_(torch.where(black, inner - factor * r_blk, inner))
        neumann_bc(p)
    return torch.where(red, r_red * r_red, r_blk * r_blk)


@functools.lru_cache(maxsize=64)
def masked_geom(J: int, I: int, n_inner: int):
    """Masked K2's field as the tiled kernel's block: the (J+2, I+2) field
    is a block of H = 1 at offsets 0 whose owned region is the interior
    (ops/sor_obsdist.ObsGeom)."""
    from .sor_obsdist import ObsGeom

    return ObsGeom(J, I, J, I, n_inner, 1)


def rb_sor_masked_plain(p, rhs, flags, n_inner, omega, idx2, idy2):
    """K2's masked mode, plain: n_inner (red, black, Neumann) iterations in
    place on p, a cell updating only where it is interior, of the colour
    and fluid. Returns Σr² of the last iteration in the kernel's order
    (tiled_residual over the tiles of the call's last pass)."""
    from .sor_obsdist import obsdist_passes

    r2 = masked_sweeps(p, rhs, flags, n_inner, omega, idx2, idy2)
    pl = obsdist_passes(masked_geom(p.shape[0] - 2, p.shape[1] - 2, n_inner),
                        p.element_size())[-1]
    return tiled_residual(r2, pl.th, pl.tw)


def masked_sweeps(p, rhs, flags, n_inner, omega, idx2, idy2):
    """rb_sor_masked_plain's iterations, in place on p. Returns the last
    iteration's r² as a field of p's shape (0 on the ring and on every
    cell that does not update)."""
    jmax, imax = p.shape[0] - 2, p.shape[1] - 2
    fluid = flags[1:-1, 1:-1] != 0
    red = (checkerboard_mask(jmax, imax, 0, torch.uint8, p.device)
           != 0) & fluid
    black = (checkerboard_mask(jmax, imax, 1, torch.uint8, p.device)
             != 0) & fluid
    fac, lap = masked_stencil_2d(flags, p.dtype, omega, idx2, idy2)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    rhs_c = rhs[1:-1, 1:-1]
    r_red = r_blk = None
    for _ in range(n_inner):
        r_red = torch.where(red, rhs_c - lap(p), zero)
        p[1:-1, 1:-1] = p[1:-1, 1:-1] - fac * r_red
        r_blk = torch.where(black, rhs_c - lap(p), zero)
        p[1:-1, 1:-1] = p[1:-1, 1:-1] - fac * r_blk
        neumann_bc(p)
    r2 = torch.zeros_like(p)
    r2[1:-1, 1:-1] = r_red * r_red + r_blk * r_blk
    return r2


def rb_sor_checkerboard(p, rhs, n_inner, factor, idx2, idy2, flags=None,
                        omega=None, out=None):
    """K2 on a (jmax+2, imax+2) p. With `out` it reads p and writes the new
    field into out (p untouched), one launch a call (a call too deep for
    one pass runs several); without, the new field is copied back into p
    (a second launch). Returns Σr² of the last iteration (0-dim tensor).
    With `flags` (uint8 of p's shape, 0 on obstacle cells) the masked
    mode, which relaxes with `omega` (the per-cell factor comes from the
    flags; `factor` is not read) and needs `out`."""
    if flags is not None:
        return _masked(p, rhs, flags, n_inner, omega, idx2, idy2, out)
    if out is not None:
        check_out("K2", p, out)
    if p.device.type == "cpu":
        x = p if out is None else out.copy_(p)
        return rb_sor_checkerboard_plain(x, rhs, n_inner, factor, idx2, idy2)
    _check(p, rhs, n_inner)
    if p.dim() != 2:
        raise ValueError(f"checkerboard p must be 2-D, got {tuple(p.shape)}")
    lib = _lib()
    entry = getattr(lib, f"rb_sor_checkerboard_{_SUFFIX[p.dtype]}")
    launches = checkerboard_launch_plan(p.shape[0] - 2, p.shape[1] - 2,
                                        n_inner, p.element_size())

    def launch(src, dst, geo, partial, ticket, res, stream):
        kb.check(lib, entry(p.device.index, src.data_ptr(), rhs.data_ptr(),
                            dst.data_ptr(), geo, factor, idx2, idy2,
                            partial.data_ptr(), ticket.data_ptr(),
                            res.data_ptr(), stream), "rb_sor_checkerboard")

    res = run_passes(p, launches, out, launch)
    RB_SOR_CHECKERBOARD.launches += 1
    return res


def _masked(p, rhs, flags, n_inner, omega, idx2, idy2, out):
    from . import sor_obsdist as sod

    if omega is None or out is None:
        raise ValueError("the masked mode needs omega and out")
    check_out("masked K2", p, out)
    if p.device.type == "cpu":
        out.copy_(p)
        return rb_sor_masked_plain(out, rhs, flags, n_inner, omega, idx2,
                                   idy2)
    _check(p, rhs, n_inner)
    if (p.dim() != 2 or flags.dtype != torch.uint8
            or flags.device != p.device or flags.shape != p.shape
            or not flags.is_contiguous()):
        raise ValueError("masked K2 needs a 2-D p and contiguous uint8 flags "
                         "of its shape on its device")
    g = masked_geom(p.shape[0] - 2, p.shape[1] - 2, n_inner)
    lib = _lib()
    res = sod.run_tiled(getattr(lib, f"rb_sor_masked_{_SUFFIX[p.dtype]}"),
                        lib, "rb_sor_masked",
                        sod.launch_plan(g, p.element_size(), 0, 0), p, rhs,
                        flags, omega, idx2, idy2, out)
    RB_SOR_MASKED.launches += 1
    return res


def _band_partials(r):
    """K17's per-CTA partial sums of one colour's r² (r: the (J, I)
    interior residual, 0 off the colour): CTA b owns rows [b·BAND,
    (b+1)·BAND) of the (J+2)-row array, thread t of TILE adds the r² of
    column t of every tile, tile by tile and row by row, and a halving tree
    reduces the threads."""
    J, I = r.shape
    nb, nt = -(-(J + 2) // BAND), -(-I // TILE)
    sq = torch.zeros((nb * BAND, nt * TILE), dtype=r.dtype, device=r.device)
    sq[1:J + 1, :I] = r * r
    sq = sq.reshape(nb, BAND, nt, TILE)
    acc = torch.zeros((nb, TILE), dtype=r.dtype, device=r.device)
    for k in range(nt):
        for band_row in range(BAND):
            acc = acc + sq[:, band_row, k, :]
    return _tree(acc)[:, 0]


def rb_sor_blocked_plain(p, rhs, factor, idx2, idy2):
    """K17's plain version: one (red, black, Neumann) iteration with
    ops/sor.py, in place on p (K2's plain iteration); returns Σr² of both
    half-sweeps in K17's summation order (_band_partials, then
    fixed_order_sum over the red and then the black partials)."""
    jmax, imax = p.shape[0] - 2, p.shape[1] - 2
    parts = []
    for parity in (0, 1):
        mask = checkerboard_mask(jmax, imax, parity, p.dtype, p.device)
        r = interior_residual(p, rhs, idx2, idy2) * mask
        p[1:-1, 1:-1] -= factor * r
        parts.append(_band_partials(r))
    neumann_bc(p)
    return fixed_order_sum(torch.cat(parts))


def rb_sor_blocked(p, rhs, factor, idx2, idy2):
    """K17: one red-black iteration on a (jmax+2, imax+2) p, in place,
    Neumann ghost copy included. Returns Σr² of both half-sweeps (0-dim
    tensor)."""
    if p.device.type == "cpu":
        return rb_sor_blocked_plain(p, rhs, factor, idx2, idy2)
    _check(p, rhs, 1)
    if p.dim() != 2:
        raise ValueError(f"K17 takes a 2-D p, got {tuple(p.shape)}")
    J, I = p.shape[0] - 2, p.shape[1] - 2
    lib = _lib()
    partial = torch.empty(lib.rb_sor_blocked_partials(J), dtype=p.dtype,
                          device=p.device)
    out = torch.empty((), dtype=p.dtype, device=p.device)
    err = getattr(lib, f"rb_sor_blocked_{_SUFFIX[p.dtype]}")(
        p.device.index, p.data_ptr(), rhs.data_ptr(), J, I, factor, idx2,
        idy2, partial.data_ptr(), out.data_ptr(), kb.stream_of(p))
    kb.check(lib, err, "rb_sor_blocked")
    RB_SOR_BLOCKED.launches += 1
    return out




# ----------------------------------------------------------------------
# K1: the single-device quarter plane, one pass through the card a call
# ----------------------------------------------------------------------

# K1's CTA by element size: (QW, QS, QK) = box columns (a thread each),
# row segments, rows a thread; the box is QS*QK rows by QW columns, 32x64
# at float32 and 16x64 at float64 (the shapes csrc/sor_rb.cu
# instantiates, the fastest measured, PERF.md). Each thread keeps
# QK cells of the four slots of p and rhs in registers.
K1_CTA = {4: (64, 4, 8), 8: (64, 4, 4)}


@dataclass(frozen=True)
class QuartersPass:
    """One launch of K1 or K2: `iters` iterations on owned tiles (th, tw)
    of the plane (K1's quarter cells) or the field (K2's grid cells), each
    in a box of rows x qw cells from the tile's corner less the halo on
    each side (K1: `iters`; K2: checkerboard_halo)."""

    iters: int
    th: int
    tw: int
    qw: int
    qs: int
    qk: int

    @property
    def rows(self) -> int:
        return self.qs * self.qk

    @property
    def threads(self) -> int:
        return self.qw * self.qs


def quarters_pass(iters: int, itemsize: int) -> QuartersPass:
    """K1's launch plan for a pass of `iters` iterations: the halo is iters
    quarter cells (each slot reads the other colour one cell away on one
    side per axis: tests/test_torch_sor_tiles.py shows iters enough and
    iters - 1 not), the owned tile the box less the halo."""
    qw, qs, qk = K1_CTA[itemsize]
    return QuartersPass(iters, qs * qk - 2 * iters, qw - 2 * iters, qw, qs,
                        qk)


@functools.lru_cache(maxsize=256)
def quarters_passes(n: int, itemsize: int) -> tuple:
    """K1's passes for a call of n iterations: one pass wherever its tile
    keeps at least half the box each way, else the fewest that do."""
    from .sor_obsdist import split_passes

    qw, qs, qk = K1_CTA[itemsize]
    parts = split_passes(n, lambda m: 4 * m <= min(qs * qk, qw))
    return tuple(quarters_pass(m, itemsize) for m in parts)


@functools.lru_cache(maxsize=256)
def quarters_launch_plan(j2: int, i2: int, n: int, itemsize: int):
    """(tiles, the kernel's geometry array) of each pass of a K1 call on a
    (4, j2, i2) plane (csrc/sor_rb.cu launch_q_tiled: J2, I2, iters, th,
    tw, QS, QK, shared-memory bytes)."""
    out = []
    for pl in quarters_passes(n, itemsize):
        smem = 4 * pl.rows * pl.qw * itemsize
        geo = (ctypes.c_int * 8)(j2, i2, pl.iters, pl.th, pl.tw, pl.qs,
                                 pl.qk, smem)
        out.append((-(-j2 // pl.th) * -(-i2 // pl.tw), geo))
    return tuple(out)


def np_tree(s):
    """_tree in numpy: s[..., :h] + s[..., h:2h] for h = n/2, ..., 1;
    returns s[..., 0]."""
    h = s.shape[-1] // 2
    while h:
        s = s[..., :h] + s[..., h:2 * h]
        h //= 2
    return s[..., 0]


def np_fixed_order_sum(parts, threads: int):
    """fixed_order_sum in numpy over the last axis: thread t adds parts t,
    t + threads, ... in turn, then the halving tree. With no more parts
    than threads the tree runs over the next power of two only: its upper
    levels would add zeros."""
    n = parts.shape[-1]
    if n <= threads:
        width = 1 << max(0, n - 1).bit_length()
        padded = np.zeros((*parts.shape[:-1], width), dtype=parts.dtype)
        padded[..., :n] = parts
        return np_tree(padded)
    m = -(-n // threads)
    padded = np.zeros((*parts.shape[:-1], m * threads), dtype=parts.dtype)
    padded[..., :parts.shape[-1]] = parts
    acc = np.zeros((*parts.shape[:-1], threads), dtype=parts.dtype)
    for r in range(m):
        acc = acc + padded[..., r * threads:(r + 1) * threads]
    return np_tree(acc)


# each slot's interior (its cells that update) as (first row, first
# column) of its plane; its extent is (J2 - 1, I2 - 1) (ops/sor_quarters)
_INTERIOR_START = ((1, 1), (0, 0), (1, 0), (0, 1))


@functools.lru_cache(maxsize=16)
def _quarters_order(j2: int, i2: int, pl: QuartersPass):
    """The gather plan of quarters_residual: an index array (steps, tiles x
    threads) of indices into the four slots' interior r² laid end to end
    (each row-major), the index past them (a 0) where a thread's cell of
    that step lies off its tile or off its slot's interior. A thread (tx,
    ty) holds column tx of box rows ty·QK .. ty·QK + QK - 1 (the box from
    the tile's corner less the halo); its steps are its update order, red
    (R0 then R1 of each row in turn) then black (B0, B1). Steps that no
    thread takes are left out (adding 0 to a sum of squares changes no
    bit)."""
    th, tw, ht = pl.th, pl.tw, pl.iters
    gy, gx = -(-j2 // th), -(-i2 // tw)
    size = (j2 - 1) * (i2 - 1)
    by, bx, ty, tx = np.meshgrid(np.arange(gy), np.arange(gx),
                                 np.arange(pl.qs), np.arange(pl.qw),
                                 indexing="ij")
    col = tx - ht  # the cell's column in its tile
    gc = bx * tw + col
    steps = []
    for slots in ((0, 1), (2, 3)):
        for k in range(pl.qk):
            row = ty * pl.qk + k - ht
            gr = by * th + row
            own = ((row >= 0) & (row < th) & (gr < j2)
                   & (col >= 0) & (col < tw) & (gc < i2))
            for s in slots:
                r0, c0 = _INTERIOR_START[s]
                ir, ic = gr - r0, gc - c0
                ok = own & (ir >= 0) & (ir < j2 - 1) & (ic >= 0) & (ic < i2 - 1)
                idx = np.where(ok, s * size + ir * (i2 - 1) + ic, 4 * size)
                if ok.any():
                    steps.append(idx.reshape(-1).astype(np.intp))
    return np.stack(steps), gy * gx


def quarters_residual(rs, pl: QuartersPass):
    """K1's residual in the kernel's order, from the last iteration's r of
    each slot's interior (R0, R1, B0, B1; ops/sor_quarters.rb_sweeps_
    quarters_rs): in each tile's box thread (tx, ty) adds its column tx of
    rows ty·QK .. ty·QK + QK - 1 in its update order (red: R0 then R1 of
    each row in turn; then black: B0, B1), a halving tree over tid =
    QW·ty + tx gives the tile's partial, and the last CTA adds the tiles'
    partials in tile order (fixed_order_sum over the CTA's threads). The
    adds are IEEE adds of the dtype in numpy, a cached gather and one add
    a step (_quarters_order), which costs the CPU solves a fraction of
    torch's per-op overhead. A 0-dim tensor on rs's device, equal bit for
    bit to the kernel's."""
    r = [x.detach().numpy() if x.device.type == "cpu" else x.cpu().numpy()
         for x in rs]
    j2, i2 = r[0].shape[0] + 1, r[0].shape[1] + 1
    order, tiles = _quarters_order(j2, i2, pl)
    size = (j2 - 1) * (i2 - 1)
    flat = np.empty(4 * size + 1, dtype=r[0].dtype)
    for s, x in enumerate(r):
        np.multiply(x, x, out=flat[s * size:(s + 1) * size].reshape(x.shape))
    flat[-1] = 0
    terms = np.take(flat, order)
    acc = terms[0].copy()
    for e in range(1, len(terms)):
        acc += terms[e]
    parts = np_tree(acc.reshape(tiles, pl.threads))
    return torch.from_numpy(np.asarray(
        np_fixed_order_sum(parts, pl.threads))).to(rs[0].device)


def rb_sor_quarters_plain(q, f, n_inner, factor, idx2, idy2):
    """K1's plain version: ops/sor_quarters's iterations, in place on the
    stacked planes q; the residual in the kernel's order (quarters_residual
    over the tiles of the call's last pass). On bf16 planes the
    bf16-storage mode (ops/sor_qdist.rb_sor_quarters_bf16_plain: float32
    inside the call, a float32 residual in the one-pass kernel's order)."""
    if q.dtype == torch.bfloat16:
        from .sor_qdist import rb_sor_quarters_bf16_plain

        return rb_sor_quarters_bf16_plain(q, f, n_inner, factor, idx2, idy2)
    rs = rb_sweeps_quarters_rs(q, f, n_inner, factor, idx2, idy2)
    return quarters_residual(
        rs, quarters_passes(n_inner, q.element_size())[-1])


def rb_sor_quarters(q, f, n_inner, factor, idx2, idy2, out=None):
    """K1 on stacked quarters q, f of shape (4, J2, I2): with `out` it
    reads q and writes the new planes into out (q untouched), one launch a
    call (a call too deep for one pass runs several); without, a second
    launch copies the new planes back into q. Returns Σr² of the last
    iteration (0-dim tensor). bf16 planes take the bf16-storage mode
    (ops/sor_qdist.rb_sor_quarters_bf16, the residual float32)."""
    if out is not None:
        check_out("K1", q, out)
    if q.dtype == torch.bfloat16:
        return _quarters_bf16(q, f, n_inner, factor, idx2, idy2, out)
    if q.device.type == "cpu":
        x = q if out is None else out.copy_(q)
        return rb_sor_quarters_plain(x, f, n_inner, factor, idx2, idy2)
    _check(q, f, n_inner)
    if q.dim() != 3 or q.shape[0] != 4:
        raise ValueError(f"quarters must be (4, J2, I2), got {tuple(q.shape)}")
    lib = _lib()
    entry = getattr(lib, f"rb_sor_quarters_{_SUFFIX[q.dtype]}")
    launches = quarters_launch_plan(q.shape[1], q.shape[2], n_inner,
                                    q.element_size())

    def launch(src, dst, geo, partial, ticket, res, stream):
        kb.check(lib, entry(q.device.index, src.data_ptr(), f.data_ptr(),
                            dst.data_ptr(), geo, factor, idx2, idy2,
                            partial.data_ptr(), ticket.data_ptr(),
                            res.data_ptr(), stream), "rb_sor_quarters")

    res = run_passes(q, launches, out, launch)
    RB_SOR_QUARTERS.launches += 1
    return res


def _quarters_bf16(q, f, n_inner, factor, idx2, idy2, out):
    from .sor_qdist import rb_sor_quarters_bf16

    if q.device.type == "cpu":
        x = q if out is None else out.copy_(q)
        return rb_sor_quarters_plain(x, f, n_inner, factor, idx2, idy2)
    if out is not None:
        return rb_sor_quarters_bf16(q, f, n_inner, factor, idx2, idy2, out)
    new = torch.empty_like(q)
    res = rb_sor_quarters_bf16(q, f, n_inner, factor, idx2, idy2, new)
    q.copy_(new)
    return res


# ----------------------------------------------------------------------
# K2: the natural field, one pass through the card a call
# ----------------------------------------------------------------------

# K2's CTA by element size: (QW, QS, QK) = box columns (a thread each),
# runs, rows a run; the box is QS*QK rows by QW columns, 96x64 at float32
# and 64x64 at float64 (csrc/sor_rb.cu cb_tiled, the fastest measured,
# PERF.md). Each thread keeps QK cells of p and of rhs in registers.
K2_CTA = {4: (64, 4, 24), 8: (64, 4, 16)}


def checkerboard_halo(iters: int) -> int:
    """K2's halo for a pass of `iters` iterations: 2·iters + 1 grid cells
    (each half-sweep carries a stale or clamped value one cell further in;
    a wall ghost, written at the end from its interior neighbour, reads one
    further: tests/test_torch_k18_k2_tiles.py shows 2·iters + 1 enough and
    2·iters not)."""
    return 2 * iters + 1


def checkerboard_pass(iters: int, itemsize: int) -> QuartersPass:
    """K2's launch plan for a pass of `iters` iterations: the owned tile is
    the box less the halo on each side."""
    qw, qs, qk = K2_CTA[itemsize]
    h = checkerboard_halo(iters)
    return QuartersPass(iters, qs * qk - 2 * h, qw - 2 * h, qw, qs, qk)


@functools.lru_cache(maxsize=256)
def checkerboard_passes(n: int, itemsize: int) -> tuple:
    """K2's passes for a call of n iterations: one pass wherever its tile
    keeps at least half the box each way, else the fewest that do."""
    from .sor_obsdist import split_passes

    qw, qs, qk = K2_CTA[itemsize]
    parts = split_passes(
        n, lambda m: 4 * checkerboard_halo(m) <= min(qs * qk, qw))
    return tuple(checkerboard_pass(m, itemsize) for m in parts)


@functools.lru_cache(maxsize=256)
def checkerboard_launch_plan(jmax: int, imax: int, n: int, itemsize: int):
    """(tiles, the kernel's geometry array) of each pass of a K2 call on a
    (jmax+2, imax+2) field (csrc/sor_rb.cu launch_cb_tiled: J, I, iters,
    th, tw, QS, QK, shared-memory bytes)."""
    out = []
    for pl in checkerboard_passes(n, itemsize):
        smem = pl.rows * pl.qw * itemsize
        geo = (ctypes.c_int * 8)(jmax, imax, pl.iters, pl.th, pl.tw, pl.qs,
                                 pl.qk, smem)
        out.append((-(-(jmax + 2) // pl.th) * -(-(imax + 2) // pl.tw), geo))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _checkerboard_order(jmax: int, imax: int, pl: QuartersPass):
    """The gather plan of checkerboard_residual: an index array (steps,
    tiles x threads) into the interior r² (row-major) with one 0 appended,
    the index of that 0 where a thread's cell of that step lies off its
    tile or off the interior. Thread (tx, ty) holds column tx of box rows
    ty·QK .. ty·QK + QK - 1 (the box from the tile's corner less the halo);
    par, the parity of its first cell's (row + column), puts its red cells
    at run rows 2m + par and its black ones at 2m + 1 - par; its steps are
    its update order, red m = 0, 1, ... then black."""
    th, tw, ht = pl.th, pl.tw, checkerboard_halo(pl.iters)
    gy, gx = -(-(jmax + 2) // th), -(-(imax + 2) // tw)
    size = jmax * imax
    by, bx, ty, tx = np.meshgrid(np.arange(gy), np.arange(gx),
                                 np.arange(pl.qs), np.arange(pl.qw),
                                 indexing="ij")
    col = tx - ht  # the cell's column in its tile
    gc = bx * tw + col
    row0 = ty * pl.qk - ht  # the run's first row in its tile
    par = (by * th + row0 + gc) & 1
    steps = []
    for shift in (par, 1 - par):
        for m in range(pl.qk // 2):
            row = row0 + 2 * m + shift
            gr = by * th + row
            ok = ((row >= 0) & (row < th) & (col >= 0) & (col < tw)
                  & (gr >= 1) & (gr <= jmax) & (gc >= 1) & (gc <= imax))
            idx = np.where(ok, (gr - 1) * imax + gc - 1, size)
            if ok.any():
                steps.append(idx.reshape(-1).astype(np.intp))
    return np.stack(steps), gy * gx


def checkerboard_residual(r2, pl: QuartersPass):
    """K2's residual in the kernel's order, from the last iteration's r² on
    the (jmax, imax) interior: in each tile's box thread (tx, ty) adds its
    owned cells in its update order (_checkerboard_order), a halving tree
    over tid = QW·ty + tx gives the tile's partial, and the last CTA adds
    the tiles' partials in tile order (fixed_order_sum over the CTA's
    threads). IEEE adds of the dtype in numpy, a cached gather and one add
    a step. A 0-dim tensor on r2's device, equal bit for bit to the
    kernel's."""
    a = r2.detach().cpu().numpy()
    order, tiles = _checkerboard_order(a.shape[0], a.shape[1], pl)
    flat = np.append(a.reshape(-1), a.dtype.type(0))
    terms = np.take(flat, order)
    acc = terms[0].copy()
    for e in range(1, len(terms)):
        acc += terms[e]
    parts = np_tree(acc.reshape(tiles, pl.threads))
    return torch.from_numpy(np.asarray(
        np_fixed_order_sum(parts, pl.threads))).to(r2.device)


# ----------------------------------------------------------------------
# K2's dynamic-extent mode: the fleet's sor class lanes
# ----------------------------------------------------------------------

# the class mode's box side by element size: a pass of m iterations takes
# tiles of side CLASS_BOX - 2(2m + 1), so a call's tiles depend on the
# dtype and n only; a 64² lane fits one tile at n = 4 (66 cells)
CLASS_BOX = {4: 84, 8: 84}
_CLASS_MIN_TILE = 32
# per (device, stream, dtype, lanes, stride): the partial, ticket and
# result buffers; per (device, stream, dtype, shape): the scratch block
_CLASS_BUFS: dict = {}
_CLASS_SCRATCH: dict = {}


def class_tile(iters: int, itemsize: int) -> int:
    """The side of the class mode's owned tiles in a pass of `iters`
    iterations: the box less a halo of 2·iters + 1 a side (the sweeps reach
    2·iters cells in from a box edge inside the lane, a wall-ghost cell
    copies its neighbour one further)."""
    return CLASS_BOX[itemsize] - 2 * (2 * iters + 1)


@functools.lru_cache(maxsize=256)
def class_passes(n: int, itemsize: int) -> tuple:
    """The iterations of each pass of a class call of n: one pass where
    its tile keeps _CLASS_MIN_TILE cells a side, else the fewest that do."""
    from .sor_obsdist import split_passes

    return tuple(split_passes(n, lambda m: class_tile(m, itemsize)
                              >= _CLASS_MIN_TILE))


@functools.lru_cache(maxsize=256)
def class_launch_plan(jc: int, ic: int, n: int, itemsize: int):
    """(stride, the kernel's geometry array of each pass) of a class call
    on (jc+2, ic+2) blocks (csrc/sor_rb.cu run_class: jc, ic, iters, th,
    tw, the boxes' row pitch, shared-memory bytes, stride); stride: the
    partials a lane may have, the class block's tile count."""
    passes = class_passes(n, itemsize)
    stride = max(-(-(jc + 2) // class_tile(m, itemsize))
                 * -(-(ic + 2) // class_tile(m, itemsize)) for m in passes)
    geos = []
    for m in passes:
        t = class_tile(m, itemsize)
        rows = min(t + 2 * (2 * m + 1), jc + 2)
        w = min(t + 2 * (2 * m + 1), ic + 2)
        pitch = w + (w & 1)
        smem = max(2 * rows * pitch * itemsize, NT_TILED * itemsize)
        geos.append((ctypes.c_int * 8)(jc, ic, m, t, t, pitch, smem, stride))
    return stride, tuple(geos)


def class_residual(r2, ext, n_inner: int):
    """Each lane's Σr² in rb_sor_class's order, (N,): r2 the last
    iteration's r² of the lanes' (jc+2, ic+2) blocks, 0 wherever nothing
    updated. A lane's tiles (side class_tile of the call's last pass) start
    at its block's corner; thread (tx, ty) of a tile's CTA adds the tile's
    cells (ty + TY·k, tx + TX·m), k-major, a halving tree over tid = TX·ty
    + tx gives the tile's partial, and the lane's last CTA adds the
    partials of the lane's own tile grid (ceil((jmax+2)/t) x
    ceil((imax+2)/t), row-major) by fixed_order_sum over the CTA's
    threads: an order that depends on the lane's extents only, so a lane
    is bitwise the same in every rung. Made in numpy (IEEE adds of r2's
    dtype); returned on r2's device."""
    a = r2.detach().cpu().numpy()
    n, ej, ei = a.shape
    t = class_tile(class_passes(n_inner, r2.element_size())[-1],
                   r2.element_size())
    gy, gx = -(-ej // t), -(-ei // t)
    kk, mm = -(-t // TY_TILED), -(-t // TX_TILED)
    wide = np.zeros((n, gy, kk * TY_TILED, gx, mm * TX_TILED), dtype=a.dtype)
    tiles = np.zeros((n, gy * t, gx * t), dtype=a.dtype)
    tiles[:, :ej, :ei] = a
    wide[:, :, :t, :, :t] = tiles.reshape(n, gy, t, gx, t)
    cells = wide.reshape(n, gy, kk, TY_TILED, gx, mm, TX_TILED)
    acc = np.zeros((n, gy, TY_TILED, gx, TX_TILED), dtype=a.dtype)
    for k in range(kk):
        for m in range(mm):
            acc = acc + cells[:, :, k, :, :, m]
    parts = np_tree(acc.transpose(0, 1, 3, 2, 4).reshape(n, gy, gx, -1))
    own = np.zeros((n, gy * gx), dtype=a.dtype)
    for lane, (jmax, imax) in enumerate(ext.tolist()):
        gyl, gxl = -(-(jmax + 2) // t), -(-(imax + 2) // t)
        own[lane, :gyl * gxl] = parts[lane, :gyl, :gxl].reshape(-1)
    return torch.from_numpy(np_fixed_order_sum(own, NT_TILED)).to(
        r2.device)


def rb_sor_class_plain(p, rhs, n_inner, ext, geo, solving):
    """K2's dynamic-extent mode, plain: n_inner (red, black, Neumann)
    iterations in place on every solving lane of p (N, jc+2, ic+2), each at
    its extents ext[lane] = (jmax, imax) with geo[lane] = (factor, idx2,
    idy2); every other cell is left as it is (selects). Returns each
    lane's Σr² of the last iteration in the kernel's order (class_residual;
    0 for a lane that is not solving)."""
    n, jc, ic = p.shape[0], p.shape[-2] - 2, p.shape[-1] - 2
    dev = p.device
    jmax, imax = (ext[:, k].to(torch.int64).view(n, 1, 1) for k in (0, 1))
    factor, idx2, idy2 = (geo[:, k].to(p.dtype).view(n, 1, 1)
                          for k in range(3))
    on = solving.to(torch.bool).view(n, 1, 1)
    jj = torch.arange(1, jc + 1, device=dev)[:, None]
    ii = torch.arange(1, ic + 1, device=dev)[None, :]
    interior = on & (jj <= jmax) & (ii <= imax)
    red = interior & ((ii + jj) % 2 == 0)
    black = interior & ((ii + jj) % 2 == 1)
    gj = torch.arange(jc + 2, device=dev)[:, None]
    gi = torch.arange(ic + 2, device=dev)[None, :]
    tan_j = on & (gj >= 1) & (gj <= jmax)
    tan_i = on & (gi >= 1) & (gi <= imax)
    ghosts = (((gj == 0) & tan_i, -1, -2), ((gj == jmax + 1) & tan_i, 1, -2),
              ((gi == 0) & tan_j, -1, -1), ((gi == imax + 1) & tan_j, 1, -1))
    zero = torch.zeros((), dtype=p.dtype, device=dev)
    rc = rhs[:, 1:-1, 1:-1]
    r2 = torch.zeros_like(p)
    for t in range(n_inner):
        for mask in (red, black):
            c = p[:, 1:-1, 1:-1]
            r = rc - ((p[:, 1:-1, 2:] - 2.0 * c + p[:, 1:-1, :-2]) * idx2
                      + (p[:, 2:, 1:-1] - 2.0 * c + p[:, :-2, 1:-1]) * idy2)
            p[:, 1:-1, 1:-1] = torch.where(mask, c - factor * r, c)
            if t == n_inner - 1:
                # each interior cell updates in one colour: its r² lands
                # once, as in the kernel's rhs slot
                r2[:, 1:-1, 1:-1] += torch.where(mask, r * r, zero)
        q = p
        for mask, shift, dim in ghosts:
            q = torch.where(mask, torch.roll(q, shift, dim), q)
        p.copy_(q)
    return class_residual(r2, ext, n_inner)


def _class_buffers(p, stream: int, n: int, stride: int):
    """(partial, ticket, res) of a class call on p's device and stream for
    n lanes: made once and reused (launches on one stream run in order),
    the ticket n int32 zeros that the kernel leaves at 0."""
    key = (p.device.index, stream, p.dtype, n, stride)
    bufs = _CLASS_BUFS.get(key)
    if bufs is None:
        bufs = (torch.empty(n * stride, dtype=p.dtype, device=p.device),
                torch.zeros(n, dtype=torch.int32, device=p.device),
                torch.empty(n, dtype=p.dtype, device=p.device))
        _CLASS_BUFS[key] = bufs
    return bufs


def _class_scratch(p, stream: int, k: int):
    """Scratch block k (0 or 1) of p's shape, dtype and device for the
    passes of a deep call or the in-place form, made once per stream and
    shape."""
    key = (p.device.index, stream, p.dtype, tuple(p.shape), k)
    x = _CLASS_SCRATCH.get(key)
    if x is None:
        x = _CLASS_SCRATCH[key] = torch.empty_like(p)
    return x


def rb_sor_class(p, rhs, n_inner, ext, geo, solving, out=None):
    """K2's dynamic-extent mode on lane-stacked class blocks p, rhs (N,
    jc+2, ic+2). With `out` it reads p and writes the new blocks into out
    (p untouched), one launch a call: the kernel writes every cell of out,
    the cells past each lane's live corner and the lanes that are not
    solving copied from p, so out is whole whichever array the caller
    reads next. Without `out` a second launch copies the new blocks back
    into p. ext (N, 2) int32, geo (N, 3) in p's dtype, solving (N,) bool,
    on p's device. Returns each lane's Σr² of the last iteration, (N,) (0
    where not solving); on the card a buffer reused by the next call with
    the same stream and batch size: read it before.

    Every lane's extents must fit its block, 1 <= jmax <= jc and 1 <= imax
    <= ic: the kernel reads them on the card and does not check them (a
    larger lane would write into the next lane's block and sum past its
    partials). fleet/shapeclass.class_lanes checks them on the host."""
    if out is not None:
        check_out("K2's class mode", p, out)
    if p.device.type == "cpu":
        x = p if out is None else out.copy_(p)
        return rb_sor_class_plain(x, rhs, n_inner, ext, geo, solving)
    _check(p, rhs, n_inner)
    n = p.shape[0]
    for a, dtype, shape in ((ext, torch.int32, (n, 2)),
                            (geo, p.dtype, (n, 3)),
                            (solving, torch.bool, (n,))):
        if (p.dim() != 3 or a.device != p.device or a.dtype != dtype
                or tuple(a.shape) != shape or not a.is_contiguous()):
            raise ValueError(f"K2's class mode takes (N, jc+2, ic+2) p and "
                             f"contiguous {dtype} {shape} per-lane arrays "
                             f"on its device")
    jc, ic = p.shape[1] - 2, p.shape[2] - 2
    lib = _lib()
    entry = getattr(lib, f"rb_sor_class_{_SUFFIX[p.dtype]}")
    stride, geos = class_launch_plan(jc, ic, n_inner, p.element_size())
    with card_of(p):
        stream = kb.stream_of(p)
        partial, ticket, res = _class_buffers(p, stream, n, stride)
        target = _class_scratch(p, stream, 0) if out is None else out
        other = (_class_scratch(p, stream, 1 if out is None else 0)
                 if len(geos) > 1 else None)
        src = p
        for k, gi in enumerate(geos):
            # the passes alternate target and a scratch block so that the
            # last lands in target
            dst = target if (len(geos) - 1 - k) % 2 == 0 else other
            kb.check(lib, entry(p.device.index, src.data_ptr(),
                                rhs.data_ptr(), dst.data_ptr(),
                                ext.data_ptr(), geo.data_ptr(),
                                solving.data_ptr(), n, gi,
                                partial.data_ptr(), ticket.data_ptr(),
                                res.data_ptr(), stream), "rb_sor_class")
            src = dst
        if out is None:
            p.copy_(target)
    RB_SOR_CLASS.launches += 1
    return res
