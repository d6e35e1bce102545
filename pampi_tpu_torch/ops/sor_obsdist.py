"""Kernel K15: the per-shard flag-masked red-black SOR of a 2-D mesh on the
H100, beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/sor_obsdist.cu).

K15 `rb_sor_obsdist` replaces pampi_tpu/ops/sor_obsdist.py
`_obsdist_kernel` (make_rb_iters_obsdist, pallas_call at :296): g.n
red-black iterations, each with the globally gated Neumann wall refresh,
on one shard's (jl+2H, il+2H) deep block, in place, with the shard's
global offsets (joff, ioff) as arguments (the TPU kernel's scalar
prefetch). H = ca_halo(n, ragged) is 2n, or 2n+1 on a ragged mesh. Deep
cell (a, b) holds global extended index (a - H + joff + 1, b - H + ioff +
1). Per cell:

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
The design is K13's: a launch per colour per iteration and one for the
wall refresh, per-block partial sums of r² on the last iteration and a
one-block fixed-order sum; temporal blocking is later work.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches K15 or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from .sor_kernels import _SUFFIX, masked_stencil_2d

SOURCE = "pampi_tpu_torch/csrc/sor_obsdist.cu"
RB_SOR_OBSDIST = kb.register(
    "rb_sor_obsdist", SOURCE, "pampi_tpu/ops/sor_obsdist.py:296")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    f"rb_sor_obsdist_{t}": [_I, _V, _V, _V] + [_I] * 10
    + [_D, _D, _D, _V, _V, _V]
    for t in ("f32", "f64")
}
_SIGNATURES["rb_sor_obsdist_partials"] = [_I, _I]


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


def rb_sor_obsdist(p, rhs, flags, g: ObsGeom, offs, omega, idx2, idy2):
    """K15 on one shard's deep block p, rhs of shape g.shape, in place on
    p, with the uint8 deep flag block `flags` and the shard's global
    offsets offs = (joff, ioff). Returns the owned Σr² of the last
    iteration (0-dim tensor)."""
    if p.device.type == "cpu":
        return rb_iters_obsdist_plain(p, rhs, flags, g, offs, omega, idx2,
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
    if g.n < 1:
        raise ValueError(f"n must be >= 1, got {g.n}")
    lib = kb.load("sor_obsdist", _SIGNATURES)
    ej, ei = g.shape
    partial = torch.empty(lib.rb_sor_obsdist_partials(ej, ei),
                          dtype=p.dtype, device=p.device)
    out = torch.empty((), dtype=p.dtype, device=p.device)
    # the shards of a mesh lie on several cards: the launch selects p's
    # card, and the guard gives the caller its current card back
    with torch.cuda.device(p.device):
        err = getattr(lib, f"rb_sor_obsdist_{_SUFFIX[p.dtype]}")(
            p.device.index, p.data_ptr(), rhs.data_ptr(), flags.data_ptr(),
            ej, ei, g.jl, g.il, g.n, g.H, g.jmax, g.imax, int(offs[0]),
            int(offs[1]), omega, idx2, idy2, partial.data_ptr(),
            out.data_ptr(), kb.stream_of(p))
    kb.check(lib, err, "rb_sor_obsdist")
    RB_SOR_OBSDIST.launches += 1
    return out
