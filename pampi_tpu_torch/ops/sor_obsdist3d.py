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
The design is the TPU kernel's temporal blocking, streamed along k: the
block's (j, i) plane is cut into owned tiles, and k into slabs where the
tiles alone would leave SMs idle (obsdist3d_tiles); a CTA streams its
tile's box (a halo of 2n + 1 cells a side) through a ring of 2n + 2 planes in
shared memory, the 2n colour stages a wavefront one plane apart, and
writes the tile's cells into `out` once. The residual keeps its fixed
order: the owned r² buffer, row sums from the low i up, then one block
(three launches a call). The solver passes `out` and swaps the two
blocks; without `out` the wrapper copies the result back into p. At
n >= 6 the ring of 2n + 2 planes outgrows shared memory at either
dtype, and a call runs as a few passes of at most 5 iterations
(obsdist3d_passes), each exact on the whole block.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches K16 or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from .sor3d_kernels import masked_stencil_3d
from .sor_kernels import _SUFFIX, check_out, ordered_r2_sum
from .sor_obsdist import SMEM_LIMIT, _flag_pitch, split_passes

SOURCE = "pampi_tpu_torch/csrc/sor_obsdist3d.cu"
RB_SOR_OBSDIST3D = kb.register(
    "rb_sor_obsdist3d", SOURCE, "pampi_tpu/ops/sor_obsdist3d.py:227")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    f"rb_sor_obsdist3d_{t}": [_I, _V, _V, _V, _V, _V, _D, _D, _D, _D, _V,
                              _V, _V, _V]
    for t in ("f32", "f64")
}
# the largest (j, i) box of a ring plane, by element size: the kernel's
# threads hold a plane's next loads in registers, sized for it
# (csrc/sor_obsdist3d.cu's entries)
_BOX3 = {4: (32, 64), 8: (32, 32)}
# SMs of the card, for the number of k slabs (the H100 SXM's 132)
SMS = 132


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


@dataclass(frozen=True)
class PassPlan3:
    """One pass of K16: n iterations on tiles (tk, tj, ti) with a halo of
    ht = 2n + 1 cells, a ring of rs = 2n + 2 planes of rows x P cells."""

    n: int
    ht: int
    tk: int
    tj: int
    ti: int
    rs: int
    rows: int
    P: int  # row pitch of p and rhs in shared memory (elements, even)
    Pf: int  # row pitch of the flags (bytes)
    smem: int  # dynamic shared memory a CTA takes (bytes)


def pass_plan_3d(g: ObsGeom3, n: int, itemsize: int = 4,
                 sms: int = SMS) -> PassPlan3 | None:
    """The plan of a pass of n <= g.n iterations on g's deep block, or
    None where no owned tile fits the largest box with its halo. The halo
    is 2n + 1 (sor_obsdist.pass_plan: the sweeps reach 2n cells in, a
    wall-ghost cell's copy one more). The (j, i) tile is the box less the
    halo (the whole extent where the block is smaller); k is cut into as
    many slabs as idle SMs can take, none of fewer than 4n owned
    planes."""
    ht, rs = 2 * n + 1, 2 * n + 2
    BJ, BI = _BOX3[itemsize]
    ek, ej, ei = g.shape
    tj = ej if ej <= BJ else BJ - 2 * ht
    ti = ei if ei <= BI else BI - 2 * ht
    if tj < 1 or ti < 1:
        return None
    rows, w = min(ej, tj + 2 * ht), min(ei, ti + 2 * ht)
    P, Pf = w + (w & 1), _flag_pitch(w)
    smem = rs * rows * (2 * P * itemsize + Pf)
    per_sm = max(1, 233472 // (smem + 1024))  # the SM's 228 KB
    tiles = -(-ej // tj) * -(-ei // ti)
    slabs = max(1, min(sms * per_sm // tiles, ek // (4 * n)))
    tk = -(-ek // slabs)
    return PassPlan3(n, ht, tk, tj, ti, rs, rows, P, Pf, smem)


def obsdist3d_passes(g: ObsGeom3, itemsize: int = 4,
                     sms: int = SMS) -> list[PassPlan3]:
    """K16's passes for one call: one of g.n iterations wherever its ring
    fits shared memory (n <= 5 at either dtype), else the fewest that
    do."""
    def fits(m):
        pl = pass_plan_3d(g, m, itemsize, sms)
        return pl is not None and pl.smem <= SMEM_LIMIT

    return [pass_plan_3d(g, m, itemsize, sms)
            for m in split_passes(g.n, fits)]


def obsdist3d_tiles(g: ObsGeom3, itemsize: int = 4, sms: int = SMS,
                    n: int | None = None):
    """The owned tiles (k0, k1, j0, j1, i0, i1) of a pass of n iterations
    (default g.n): they partition the deep block, its frozen shell
    included, so the kernel writes each cell once. The CTA of a tile
    streams the box of the tile and ht = 2n + 1 cells a side (k
    included), clipped to the block."""
    pl = pass_plan_3d(g, g.n if n is None else n, itemsize, sms)
    ek, ej, ei = g.shape
    return [(k0, min(k0 + pl.tk, ek), j0, min(j0 + pl.tj, ej), i0,
             min(i0 + pl.ti, ei))
            for k0 in range(0, ek, pl.tk) for j0 in range(0, ej, pl.tj)
            for i0 in range(0, ei, pl.ti)]


def rb_sor_obsdist3d(p, rhs, flags, g: ObsGeom3, offs, omega, idx2, idy2,
                     idz2, out=None):
    """K16 on one shard's deep block p, rhs of shape g.shape with the uint8
    deep flag block `flags` and the shard's global offsets offs = (koff,
    joff, ioff). With `out` it reads p and writes the new block into out
    (p untouched); without, it updates p in place. Returns the owned Σr²
    of the last iteration (0-dim tensor)."""
    if out is not None:
        check_out("K16", p, out)
    if p.device.type == "cpu":
        if out is None:
            return rb_iters_obsdist3d_plain(p, rhs, flags, g, offs, omega,
                                            idx2, idy2, idz2)
        out.copy_(p)
        return rb_iters_obsdist3d_plain(out, rhs, flags, g, offs, omega,
                                        idx2, idy2, idz2)
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
    entry = getattr(lib, f"rb_sor_obsdist3d_{_SUFFIX[p.dtype]}")
    launches = _launches(g, p.element_size(), tuple(int(o) for o in offs),
                         _sms(p.device.index))
    target = torch.empty_like(p) if out is None else out
    scratch = torch.empty_like(p) if len(launches) > 1 else None
    r2 = torch.empty((g.kl, g.jl, g.il), dtype=p.dtype, device=p.device)
    rows = torch.empty((g.kl, g.jl), dtype=p.dtype, device=p.device)
    res = torch.empty((), dtype=p.dtype, device=p.device)
    # the shards of a mesh lie on several cards: the launch selects p's
    # card, and the guard gives the caller its current card back
    with torch.cuda.device(p.device):
        src = p
        for k, geo in enumerate(launches):
            # alternate the two buffers so that the last pass lands in target
            last = k == len(launches) - 1
            dst = target if (len(launches) - 1 - k) % 2 == 0 else scratch
            err = entry(p.device.index, src.data_ptr(), rhs.data_ptr(),
                        flags.data_ptr(), dst.data_ptr(), geo, omega, idx2,
                        idy2, idz2, r2.data_ptr() if last else None,
                        rows.data_ptr(), res.data_ptr(), kb.stream_of(p))
            kb.check(lib, err, "rb_sor_obsdist3d")
            src = dst
        if out is None:
            p.copy_(target)
    RB_SOR_OBSDIST3D.launches += 1
    return res


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _launches(g: ObsGeom3, itemsize: int, offs: tuple, sms: int):
    """The kernel's geometry array of each pass of a call, made once per
    shard (the CLI's rounds call K16 on small shards, where the host's
    work is the call's cost)."""
    return tuple(
        (ctypes.c_int * 23)(*g.shape, g.kl, g.jl, g.il, pl.n, g.H, g.kmax,
                            g.jmax, g.imax, *offs, pl.ht, pl.tk, pl.tj,
                            pl.ti, pl.rs, pl.rows, pl.P, pl.Pf, pl.smem)
        for pl in obsdist3d_passes(g, itemsize, sms))
