"""Kernel K16: the per-shard flag-masked red-black SOR of a 3-D mesh on the
H100, beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/sor_obsdist3d.cu).

K16 `rb_sor_obsdist3d` replaces pampi_tpu/ops/sor_obsdist3d.py
`_obsdist3d_kernel` (make_rb_iters_obsdist_3d, pallas_call at :227): g.n
red-black iterations, each with the globally gated 6-face Neumann
refresh, on one shard's (kl+2H, jl+2H, il+2H) deep block, in place, with
the shard's global offsets (koff, joff, ioff) as arguments (the TPU
kernel's scalar prefetch). H = 2n. Deep cell (a, b, c) holds global
extended index (a - H + koff + 1, b - H + joff + 1, c - H + ioff + 1).
Per cell:

- it updates when it lies in the global interior, off the block's frozen
  outer shell, in the colour (gi + gj + gk) mod 2 of the half-sweep (odd
  first) and is fluid (flag != 0);
- its coefficients come from the shard's uint8 deep flag block: the six
  neighbours' flags and fac = (denom > 0 ? omega/denom : 0)·flag
  (sor3d_pallas.masked_stencil_ops_3d), the masked mode of K5 term for
  term (ops/sor3d_kernels.masked_stencil_3d);
- per iteration: the odd colour, the even one, then the six wall selects
  (sor3d_pallas.rb_inner_sweeps_3d), each clipped tangentially to the
  global interior;
- the residual is Σ r_odd² + r_even² of the last iteration over the
  shard's owned cells, summed in ops/sor_kernels.ordered_r2_sum's
  fixed order (the masked K5's), returned as a 0-dim tensor on p's
  device: on a one-shard mesh K16 and masked K5 agree bitwise.

The JAX package carries the block in the TPU's padded layout
(sor3d_pallas.pad_array_3d) and exchanges it there
(sor_obsdist3d.padded_deep_exchange_3d); both exist for the TPU's
tiling. The port keeps the unpadded block and exchanges it with
parallel/comm.halo_exchange(depth=H), as K15 does, so neither is ported.
Divisible meshes only, as in the JAX package.

Bound: memory (p, rhs and the flags read once, p written once per call:
13 bytes a cell at float32, ~42 us for a (128, 128, 512) shard at n = 4).
The design is K15's: a launch per colour per iteration and one for the
walls; temporal blocking is later work.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches K16 or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from .sor3d_kernels import masked_stencil_3d
from .sor_kernels import _SUFFIX, ordered_r2_sum

SOURCE = "pampi_tpu_torch/csrc/sor_obsdist3d.cu"
RB_SOR_OBSDIST3D = kb.register(
    "rb_sor_obsdist3d", SOURCE, "pampi_tpu/ops/sor_obsdist3d.py:227")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    f"rb_sor_obsdist3d_{t}": [_I, _V, _V, _V, _V, _D, _D, _D, _D, _V, _V,
                              _V, _V]
    for t in ("f32", "f64")
}


@dataclass(frozen=True)
class ObsGeom3:
    """Static geometry of one shard's deep block."""

    kmax: int  # global interior extents
    jmax: int
    imax: int
    kl: int  # the shard's owned extents
    jl: int
    il: int
    n: int  # red-black iterations per call; the deep halo is H = 2n

    @property
    def H(self) -> int:
        return 2 * self.n

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(e + 2 * self.H for e in (self.kl, self.jl, self.il))


def obsdist3d_masks(g: ObsGeom3, offs, device="cpu"):
    """The gating masks of the deep block at global offsets offs = (koff,
    joff, ioff), the kernel's per-cell formulas: global interior ∩ the
    block's interior (the frozen outer shell) by colour (the kernel also
    requires a fluid cell), the six wall selects and the owned region."""
    gl, loc = [], []
    for axis, (n, o) in enumerate(zip(g.shape, offs)):
        a = torch.arange(n, device=device).reshape(
            [-1 if d == axis else 1 for d in range(3)])
        loc.append(a)
        gl.append(a - g.H + int(o) + 1)
    gmax = (g.kmax, g.jmax, g.imax)
    tan = [(x >= 1) & (x <= m) for x, m in zip(gl, gmax)]
    valid = ((loc[0] >= 1) & (loc[0] <= g.shape[0] - 2)
             & (loc[1] >= 1) & (loc[1] <= g.shape[1] - 2)
             & (loc[2] >= 1) & (loc[2] <= g.shape[2] - 2))
    upd = tan[0] & tan[1] & tan[2] & valid
    par = (gl[0] + gl[1] + gl[2]) % 2
    out = {"odd": upd & (par == 1), "even": upd & (par == 0)}
    for axis, (lo, hi) in enumerate((("front", "back"), ("bottom", "top"),
                                     ("left", "right"))):
        t1, t2 = (d for d in range(3) if d != axis)
        side = tan[t1] & tan[t2] & valid
        out[lo] = (gl[axis] == 0) & side
        out[hi] = (gl[axis] == gmax[axis] + 1) & side
    own = tuple(slice(g.H, g.H + e) for e in (g.kl, g.jl, g.il))
    return out, own


def rb_iters_obsdist3d_plain(p, rhs, flags, g: ObsGeom3, offs, omega, idx2,
                             idy2, idz2):
    """K16's plain version, op for op the kernel's arithmetic, in place on
    p; returns the owned Σr² of the last iteration (0-dim tensor) in the
    kernel's order."""
    m, own = obsdist3d_masks(g, offs, p.device)
    inner = (slice(1, -1),) * 3
    fluid = flags[inner] != 0
    odd, even = m["odd"][inner] & fluid, m["even"][inner] & fluid
    fac, lap = masked_stencil_3d(flags, p.dtype, omega, idx2, idy2, idz2)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    rhs_c = rhs[inner]
    x = p.clone()
    r_odd = r_evn = None
    for _ in range(g.n):
        r_odd = torch.where(odd, rhs_c - lap(x), zero)
        x[inner] = x[inner] - fac * r_odd
        r_evn = torch.where(even, rhs_c - lap(x), zero)
        x[inner] = x[inner] - fac * r_evn
        for key, shift, dim in (("front", -1, 0), ("back", 1, 0),
                                ("bottom", -1, 1), ("top", 1, 1),
                                ("left", -1, 2), ("right", 1, 2)):
            x = torch.where(m[key], torch.roll(x, shift, dim), x)
    p.copy_(x)
    r2 = torch.zeros_like(p)
    r2[inner] = r_odd * r_odd + r_evn * r_evn
    return ordered_r2_sum(r2[own])


def rb_sor_obsdist3d(p, rhs, flags, g: ObsGeom3, offs, omega, idx2, idy2,
                     idz2):
    """K16 on one shard's deep block p, rhs of shape g.shape, in place on
    p, with the uint8 deep flag block `flags` and the shard's global
    offsets offs = (koff, joff, ioff). Returns the owned Σr² of the last
    iteration (0-dim tensor)."""
    if p.device.type == "cpu":
        return rb_iters_obsdist3d_plain(p, rhs, flags, g, offs, omega, idx2,
                                        idy2, idz2)
    if p.device.type != "cuda":
        raise ValueError(f"K16 takes CPU or CUDA tensors, not {p.device}")
    if p.dtype not in _SUFFIX:
        raise ValueError(f"K16 takes float32 or float64, not {p.dtype}")
    for t, dt in ((p, p.dtype), (rhs, p.dtype), (flags, torch.uint8)):
        if (t.device != p.device or t.dtype != dt
                or tuple(t.shape) != g.shape or not t.is_contiguous()):
            raise ValueError(
                f"K16 needs contiguous p, rhs ({p.dtype}) and flags (uint8) "
                f"of shape {g.shape} on one device")
    if g.n < 1:
        raise ValueError(f"n must be >= 1, got {g.n}")
    lib = kb.load("sor_obsdist3d", _SIGNATURES)
    r2 = torch.empty((g.kl, g.jl, g.il), dtype=p.dtype, device=p.device)
    rows = torch.empty((g.kl, g.jl), dtype=p.dtype, device=p.device)
    out = torch.empty((), dtype=p.dtype, device=p.device)
    geo = (ctypes.c_int * 14)(*g.shape, g.kl, g.jl, g.il, g.n, g.H, g.kmax,
                              g.jmax, g.imax, *(int(o) for o in offs))
    # the shards of a mesh lie on several cards: the launch selects p's
    # card, and the guard gives the caller its current card back
    with torch.cuda.device(p.device):
        err = getattr(lib, f"rb_sor_obsdist3d_{_SUFFIX[p.dtype]}")(
            p.device.index, p.data_ptr(), rhs.data_ptr(), flags.data_ptr(),
            geo, omega, idx2, idy2, idz2, r2.data_ptr(), rows.data_ptr(),
            out.data_ptr(), kb.stream_of(p))
    kb.check(lib, err, "rb_sor_obsdist3d")
    RB_SOR_OBSDIST3D.launches += 1
    return out
