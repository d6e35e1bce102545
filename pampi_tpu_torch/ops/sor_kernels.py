"""Kernels K1, K2 and K17: red-black SOR on the H100, each beside its
plain PyTorch version (sources: pampi_tpu_torch/csrc/sor_rb.cu).

K1 `rb_sor_quarters` replaces pampi_tpu/ops/sor_pallas.py
  `_tblock_quarters_kernel` (make_rb_iter_tblock_quarters, pallas_call at
  :964): n_inner iterations on the stacked quarter planes (4, J2, I2) =
  [R0, R1, B0, B1] of pampi_tpu_torch/ops/sor_quarters.py.
K2 `rb_sor_checkerboard` replaces pampi_tpu/ops/sor_pallas.py
  `_tblock_kernel` (make_rb_iter_tblock, plain mode, pallas_call at :620):
  the same function on the natural (jmax+2, imax+2) checkerboard.

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

All but masked K2 update p in place; all return the sum of r² over both
half-sweeps of the LAST of their iterations, as a 0-dim tensor on p's
device.

What bounds them on the H100 is memory bandwidth (~10 flops per cell
update). The least any implementation must move per call is p and rhs read
once and p written once: ~60 us at 4096² f32 whatever n_inner is. K1 and
plain K2 are simple first: a launch per colour per iteration (black sees
red through the launch boundary), a Neumann launch, per-block partial sums
of r² on the last iteration and a one-block fixed-order sum, so the
residual and every iteration count are reproducible. Each iteration
therefore reads and writes p from device memory; temporal blocking
(several iterations per pass, as the TPU kernels do) is later work for
them, done for the masked mode above.

For a CPU tensor each wrapper runs its plain version; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..kernels import build as kb
from .sor import checkerboard_mask, interior_residual, neumann_bc, sor_pass
from .sor_quarters import rb_sweeps_quarters

SOURCE = "pampi_tpu_torch/csrc/sor_rb.cu"
RB_SOR_QUARTERS = kb.register(
    "rb_sor_quarters", SOURCE, "pampi_tpu/ops/sor_pallas.py:964")
RB_SOR_CHECKERBOARD = kb.register(
    "rb_sor_checkerboard", SOURCE, "pampi_tpu/ops/sor_pallas.py:620")
RB_SOR_MASKED = kb.register(
    "rb_sor_checkerboard_masked", SOURCE, "pampi_tpu/ops/sor_pallas.py:620")
RB_SOR_BLOCKED = kb.register(
    "rb_sor_blocked", SOURCE, "pampi_tpu/ops/sor_pallas.py:1049")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SOR_ARGS = [_I, _V, _V, _I, _I, _I, _D, _D, _D, _V, _V, _V]
_SIGNATURES = {
    f"rb_sor_{layout}_{t}": _SOR_ARGS
    for layout in ("checkerboard", "quarters") for t in ("f32", "f64")
}
_SIGNATURES["rb_sor_checkerboard_partials"] = [_I, _I]
_SIGNATURES["rb_sor_quarters_partials"] = [_I, _I]
_SIGNATURES["rb_sor_blocked_partials"] = [_I]
for _t in ("f32", "f64"):
    _SIGNATURES[f"rb_sor_masked_{_t}"] = [_I, _V, _V, _V, _V, _V, _D, _D, _D,
                                          _V, _V, _V, _V]
    _SIGNATURES[f"rb_sor_blocked_{_t}"] = [_I, _V, _V, _I, _I, _D, _D, _D,
                                           _V, _V, _V]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
FIN = 1024  # threads of the kernels' one-block final sum (sum_partials)
BX, BY = 32, 8  # K2's thread block (sor_rb.cu)
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


def _check(p: torch.Tensor, rhs: torch.Tensor, n_inner: int) -> None:
    if p.device.type != "cuda":
        raise ValueError(f"SOR kernels take CPU or CUDA tensors, not {p.device}")
    if rhs.device != p.device or rhs.dtype != p.dtype or rhs.shape != p.shape:
        raise ValueError("p and rhs must share device, dtype and shape")
    if p.dtype not in _SUFFIX:
        raise ValueError(f"SOR kernels take float32 or float64, not {p.dtype}")
    if not (p.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("SOR kernels need contiguous p and rhs")
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")


def _launch(kernel, entry: str, partials: str, p, rhs, a: int, b: int,
            n_inner: int, factor: float, idx2: float, idy2: float):
    lib = kb.load("sor_rb", _SIGNATURES)
    partial = torch.empty(getattr(lib, partials)(a, b), dtype=p.dtype,
                          device=p.device)
    out = torch.empty((), dtype=p.dtype, device=p.device)
    err = getattr(lib, f"{entry}_{_SUFFIX[p.dtype]}")(
        p.device.index, p.data_ptr(), rhs.data_ptr(), a, b, n_inner,
        factor, idx2, idy2, partial.data_ptr(), out.data_ptr(),
        kb.stream_of(p))
    kb.check(lib, err, entry)
    kernel.launches += 1
    return out


def rb_sor_checkerboard_plain(p, rhs, n_inner, factor, idx2, idy2):
    """K2's plain version: n_inner (red, black, Neumann) iterations with
    ops/sor.py, in place on p."""
    jmax, imax = p.shape[0] - 2, p.shape[1] - 2
    red = checkerboard_mask(jmax, imax, 0, p.dtype, p.device)
    black = checkerboard_mask(jmax, imax, 1, p.dtype, p.device)
    for _ in range(n_inner):
        _, r0 = sor_pass(p, rhs, red, factor, idx2, idy2)
        _, r1 = sor_pass(p, rhs, black, factor, idx2, idy2)
        neumann_bc(p)
    return r0 + r1


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
    """K2 on a (jmax+2, imax+2) p, in place. Returns Σr² of the last
    iteration (0-dim tensor). With `flags` (uint8 of p's shape, 0 on
    obstacle cells) the masked mode, which relaxes with `omega` (the
    per-cell factor comes from the flags; `factor` is not read) and needs
    `out`: it reads p and writes the new field into out (p untouched), one
    launch a call."""
    if flags is not None:
        return _masked(p, rhs, flags, n_inner, omega, idx2, idy2, out)
    if out is not None:
        raise ValueError("K2 takes out= in its masked mode only")
    if p.device.type == "cpu":
        return rb_sor_checkerboard_plain(p, rhs, n_inner, factor, idx2, idy2)
    _check(p, rhs, n_inner)
    if p.dim() != 2:
        raise ValueError(f"checkerboard p must be 2-D, got {tuple(p.shape)}")
    jmax, imax = p.shape[0] - 2, p.shape[1] - 2
    return _launch(RB_SOR_CHECKERBOARD, "rb_sor_checkerboard",
                   "rb_sor_checkerboard_partials", p, rhs, jmax, imax,
                   n_inner, factor, idx2, idy2)


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
    lib = kb.load("sor_rb", _SIGNATURES)
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
    lib = kb.load("sor_rb", _SIGNATURES)
    partial = torch.empty(lib.rb_sor_blocked_partials(J), dtype=p.dtype,
                          device=p.device)
    out = torch.empty((), dtype=p.dtype, device=p.device)
    err = getattr(lib, f"rb_sor_blocked_{_SUFFIX[p.dtype]}")(
        p.device.index, p.data_ptr(), rhs.data_ptr(), J, I, factor, idx2,
        idy2, partial.data_ptr(), out.data_ptr(), kb.stream_of(p))
    kb.check(lib, err, "rb_sor_blocked")
    RB_SOR_BLOCKED.launches += 1
    return out


def rb_sor_quarters_plain(q, f, n_inner, factor, idx2, idy2):
    """K1's plain version: ops/sor_quarters.rb_sweeps_quarters, in place
    on the planes of q."""
    return rb_sweeps_quarters(tuple(q.unbind(0)), tuple(f.unbind(0)),
                              n_inner, factor, idx2, idy2)


def rb_sor_quarters(q, f, n_inner, factor, idx2, idy2):
    """K1 on stacked quarters q, f of shape (4, J2, I2), in place on q.
    Returns Σr² of the last iteration (0-dim tensor)."""
    if q.device.type == "cpu":
        return rb_sor_quarters_plain(q, f, n_inner, factor, idx2, idy2)
    _check(q, f, n_inner)
    if q.dim() != 3 or q.shape[0] != 4:
        raise ValueError(f"quarters must be (4, J2, I2), got {tuple(q.shape)}")
    return _launch(RB_SOR_QUARTERS, "rb_sor_quarters",
                   "rb_sor_quarters_partials", q, f, q.shape[1], q.shape[2],
                   n_inner, factor, idx2, idy2)
