"""Kernels K3 and K4: the NS-2D step phases around the pressure solve on
the H100, each beside its plain PyTorch version (sources:
pampi_tpu_torch/csrc/ns2d_fused.cu), with and without obstacle flag
fields.

K3 `ns2d_pre` replaces pampi_tpu/ops/ns2d_fused.py `_pre_kernel`
  (make_fused_pre_2d, pallas_call at :775): (u, v, dt) -> (u', v', F, G,
  rhs) = wall BCs -> dcavity lid / canal (and canal_obstacle) inflow ->
  F/G predictor + wall fixups -> RHS. u and v are updated in place.
K4 `ns2d_post` replaces pampi_tpu/ops/ns2d_fused.py `_post_kernel`
  (make_fused_post_2d, pallas_call at :877): adaptUV in place on u and v,
  then max|u| and max|v| over the FULL ghosted arrays (the reference's
  maxElement quirk), which the next step's CFL dt reads.

What bounds them on the H100 is memory bandwidth. Both run in place,
where the Pallas kernels write whole new u and v arrays: PRE must read u, v
and write F, G, rhs and the ghost ring of u and v; POST must read F, G, p
and the ghost ring of u and v (for the maxima) and write the interior of u
and v. That is five field-sizes each, ~100 us at 4096² f32 (seven, ~140 us,
for the TPU kernels' out-of-place form). The ~60 flops per cell of the
predictor are far below the card's arithmetic rate. Design, simple first:
PRE is three launches (the boundary strips by one block walking the walls
in the reference's order, F/G per cell, RHS per cell, since RHS reads F/G
of neighbouring blocks); POST is one launch that also writes per-block
partial maxima, and a one-block launch that reduces them. dt stays on the
device, so no launch waits for the host. max is exact in any order, so the
maxima equal the plain version's bitwise given equal fields.

The distributed mode (models/ns2d_dist.py; JAX make_fused_pre_2d(...,
jl, il, ext_pad=FUSE_DEEP_HALO - 1) and make_fused_post_2d(..., jl, il,
ragged)): the caller passes the shard's global offsets and the global
extents, and every write is gated by the global index, so the walls, the
lid and the inflow land wherever they cross a shard, on a divisible mesh
or a ragged one. PRE takes the shard's deep blocks (ext_pad ghost layers
more per side than the halo-1 block), applies the BCs in place where the
global walls cross them, and returns F, G, rhs on the halo-1 block (four
launches: the i-walls and the inflow one thread per row, the j-walls and
the lid one per column, F/G, rhs). POST takes the halo-1 blocks, reads p
as 0 past the block's high edge, zeroes the dead cells on a ragged mesh
(the live-mask multiply) and returns the shard's maxima over the cells of
the global extended array. The single-device mode is the call without
offsets and runs the kernels above unchanged.

The flag mode (`flags=`, a uint8 fluid field of the input block's shape:
the TPU kernels' masked mode, fed the global flags on one device and, on
a mesh, the shard's deep flag block for PRE and its halo-1 block for POST,
as the JAX package's fused_flag_blocks; cells beyond the global grid read
flag 0): PRE applies the obstacle velocity BC after the walls and the
special BC and makes F/G carry U/V on non-fluid faces
(ops/obstacle.apply_obstacle_velocity_bc, mask_fg); POST projects on
fluid-fluid faces only (adapt_uv_obstacle). Its launches count on kernel
entries of their own, `ns2d_pre_flags` and `ns2d_post_flags`.

The class mode (`ext=`, `geo=`, `active=`: the fleet's shape-class lanes,
the JAX package's make_fused_pre_2d(..., dynamic=True) and
make_fused_post_2d(..., ragged=True, dynamic=True)): u, v, F, G, rhs, p are
lane-stacked (N, jc+2, ic+2) class blocks whose live corner is each lane's
own grid; ext (N, 2) int32 holds each lane's (jmax, imax), geo (N, 2) its
(dx, dy) in the fields' dtype, dt (N,) its timestep and active (N,) bool
which lanes step. Every write is gated by the lane's extents, and every
grid constant (1/dx, the canal inflow's y = (j - 0.5)·dy, ...) is formed
in the fields' dtype from the lane's dx and dy, as the JAX kernels form it
from their SMEM scalars; an inactive lane is left as it is (its F, G, rhs
are 0). POST zeroes the dead cells after the projection (the live-mask
multiply) and returns each lane's max|u|, max|v| over its live cells, (N,)
each. Its launches count on entries of their own, `ns2d_pre_class` and
`ns2d_post_class` (three and two CUDA launches a call for the whole
batch). Every lane's extents must fit its block (1 <= jmax <= jc, 1 <=
imax <= ic): the kernels read them on the card unchecked, and
fleet/shapeclass.class_lanes checks them on the host.

The bf16 mode (bfloat16 fields, one device only: the JAX package's
kernels at bfloat16, whose scratch is in the field dtype): every operation
rounded to bf16, in the plain version's order and association. The plain
version is ops/ns2d.py on bf16 tensors, with each Python-float constant
rounded to bf16 first where the JAX package forms it in the field dtype
(ops/ns2d._weak); the kernels compute each operation in float32 and round
it (csrc/ns2d_fused.cu, bf16::value), so the two agree bit for bit. Its
launches count on `ns2d_pre_bf16` and `ns2d_post_bf16`; the distributed, flag, class
and band modes raise a ValueError on bfloat16 fields.

The grid-band mode of the distributed PRE (`bands=`, the JAX package's
make_fused_pre_2d(grid_bands=); the overlapped step's interior and
boundary halves, parallel/overlap.py): K3 with its F/G and rhs launches
restricted to bands of the halo-1 block's rows (the BCs as in the full
call), every value inside the bands bitwise the full call's. Its launches
count on `ns2d_pre_band`, with or without flags.

For a CPU tensor each wrapper runs its plain version (ops/ns2d.py,
ops/obstacle.py); for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from ..parallel.overlap import band_plain, band_ranges
from . import ns2d as ops
from . import obstacle as obst

SOURCE = "pampi_tpu_torch/csrc/ns2d_fused.cu"
NS2D_PRE = kb.register(
    "ns2d_pre", SOURCE, "pampi_tpu/ops/ns2d_fused.py:775")
NS2D_POST = kb.register(
    "ns2d_post", SOURCE, "pampi_tpu/ops/ns2d_fused.py:877")
NS2D_PRE_FLAGS = kb.register(
    "ns2d_pre_flags", SOURCE, "pampi_tpu/ops/ns2d_fused.py:775")
NS2D_POST_FLAGS = kb.register(
    "ns2d_post_flags", SOURCE, "pampi_tpu/ops/ns2d_fused.py:877")
NS2D_PRE_CLASS = kb.register(
    "ns2d_pre_class", SOURCE, "pampi_tpu/ops/ns2d_fused.py:775")
NS2D_POST_CLASS = kb.register(
    "ns2d_post_class", SOURCE, "pampi_tpu/ops/ns2d_fused.py:877")
NS2D_PRE_BAND = kb.register(
    "ns2d_pre_band", SOURCE, "pampi_tpu/ops/ns2d_fused.py:775")
NS2D_PRE_BF16 = kb.register(
    "ns2d_pre_bf16", SOURCE, "pampi_tpu/ops/ns2d_fused.py:775")
NS2D_POST_BF16 = kb.register(
    "ns2d_post_bf16", SOURCE, "pampi_tpu/ops/ns2d_fused.py:877")

# the grid-band mode: rows of the deep block a band block covers (a CTA row
# of the band launch), and the most bands one call takes
BAND_ROWS = 8
MAX_BANDS = 4

_PROBLEM_CODE = {"dcavity": 1, "canal": 2, "canal_obstacle": 2}
_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PRE_ARGS = [_I, _V, _V, _V, _V, _V, _V, _I, _I, _V, _I, _V, _V, _V, _V, _V]
_POST_ARGS = [_I, _V, _V, _V, _V, _V, _V, _I, _I, _D, _D, _V, _V, _V, _V]
_PRE_DIST_ARGS = [_I, _V, _V, _V, _V, _V, _V, _V, _V, _I, _V, _V, _V, _V, _V]
_POST_DIST_ARGS = [_I, _V, _V, _V, _V, _V, _V, _V, _I, _D, _D, _V, _V, _V,
                   _V]
_PRE_BAND_ARGS = _PRE_DIST_ARGS[:-1] + [_V, _V]
_SIGNATURES = {
    "ns2d_pre_f32": _PRE_ARGS, "ns2d_pre_f64": _PRE_ARGS,
    "ns2d_pre_band_f32": _PRE_BAND_ARGS, "ns2d_pre_band_f64": _PRE_BAND_ARGS,
    "ns2d_post_f32": _POST_ARGS, "ns2d_post_f64": _POST_ARGS,
    "ns2d_pre_dist_f32": _PRE_DIST_ARGS, "ns2d_pre_dist_f64": _PRE_DIST_ARGS,
    "ns2d_post_dist_f32": _POST_DIST_ARGS,
    "ns2d_post_dist_f64": _POST_DIST_ARGS,
    "ns2d_post_partials": [_I, _I],
}
# dev, u, v, dt, f, g, rhs, ext, geo, active, lanes, jc, ic, bc, problem, c,
# stream; and dev, u, v, f, g, p, dt, ext, geo, active, lanes, jc, ic,
# partial, out, stream
for _t in ("f32", "f64"):
    _SIGNATURES[f"ns2d_pre_class_{_t}"] = [_I, _V, _V, _V, _V, _V, _V, _V, _V,
                                           _V, _I, _I, _I, _V, _I, _V, _V]
    _SIGNATURES[f"ns2d_post_class_{_t}"] = [_I, _V, _V, _V, _V, _V, _V, _V,
                                            _V, _V, _I, _I, _I, _V, _V, _V]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}
_SIGNATURES["ns2d_pre_bf16"] = _PRE_ARGS
_SIGNATURES["ns2d_post_bf16"] = _POST_ARGS


def _check_bf16(u, offs, flags, ext, bands=None) -> None:
    """bfloat16 fields run the single-device mode only (the bf16 mode of
    K3/K4, module docstring): the distributed, flag, class and band modes
    raise a ValueError on either device."""
    if u.dtype == torch.bfloat16 and not (
            offs is None and flags is None and ext is None and bands is None):
        raise ValueError("K3/K4 take bfloat16 fields in their single-device "
                         "mode only (no offsets, flags, class lanes or "
                         "bands)")


@dataclass(frozen=True)
class StepConfig:
    """The static configuration of the step phases (from a Parameter)."""

    bc: tuple  # (left, right, bottom, top)
    problem: str
    re: float
    gx: float
    gy: float
    gamma: float
    dx: float
    dy: float
    ylength: float

    @classmethod
    def from_param(cls, param) -> "StepConfig":
        return cls(
            (param.bcLeft, param.bcRight, param.bcBottom, param.bcTop),
            param.name, param.re, param.gx, param.gy, param.gamma,
            param.xlength / param.imax, param.ylength / param.jmax,
            param.ylength)

    def coefficients(self) -> list[float]:
        """Scalar coefficients in double, formed exactly where the JAX
        package forms them from Python floats (ops/ns2d.py)."""
        idx, idy = 1.0 / self.dx, 1.0 / self.dy
        return [idx * 0.25, self.gamma * idx * 0.25, idy * 0.25,
                self.gamma * idy * 0.25, idx * idx, idy * idy,
                1.0 / self.re, self.gx, self.gy, self.dx, self.dy,
                self.ylength, self.ylength * self.ylength]


def _check(tensors, dt, shape=None) -> None:
    """Device, dtype, contiguity; every tensor of `shape` (default: the
    first one's)."""
    t0 = tensors[0]
    shape = t0.shape if shape is None else shape
    if t0.device.type != "cuda":
        raise ValueError(f"NS-2D kernels take CPU or CUDA tensors, not {t0.device}")
    if t0.dtype not in _SUFFIX:
        raise ValueError(f"NS-2D kernels take float32, float64 or bfloat16, "
                         f"not {t0.dtype}")
    if t0.dim() != 2:
        raise ValueError(f"fields must be 2-D, got {tuple(t0.shape)}")
    for t in tensors:
        if (t.device != t0.device or t.dtype != t0.dtype
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError("fields must be contiguous and share device, "
                             "dtype and shape")
    if dt.device != t0.device or dt.dtype != t0.dtype or dt.numel() != 1:
        raise ValueError("dt must be a one-element tensor beside the fields")


def _lib():
    return kb.load("ns2d_fused", _SIGNATURES)


def _mode(shape, offs, gext, ext_pad: int, deep: bool):
    """(local interior extents of the halo-1 block, offsets, global
    extents) of a call: one device when offs is None; otherwise the
    shard's, on a deep block (ext_pad >= 1) when `deep`."""
    local = tuple(n - 2 - 2 * ext_pad for n in shape)
    if offs is None:
        if ext_pad:
            raise ValueError("a deep block (ext_pad > 0) needs the shard's "
                             "offsets and the global extents")
        return local, (0, 0), local
    if gext is None:
        raise ValueError("the distributed mode needs the global extents")
    if deep and ext_pad < 1:
        raise ValueError("the distributed PRE runs on a deep block "
                         "(ext_pad >= 1)")
    return local, tuple(int(o) for o in offs), tuple(int(n) for n in gext)


def _check_flags(flags, like) -> None:
    if (flags.dtype != torch.uint8 or flags.device != like.device
            or flags.shape != like.shape or not flags.is_contiguous()):
        raise ValueError("flags must be contiguous uint8 of the fields' "
                         "shape on their device")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _faces(flags, u):
    """The faces of a single-device (J+2, I+2) flag field."""
    return obst.block_faces(
        flags, *ops.index_grids_2d(u.shape, 0, (0, 0), u.device),
        tuple(n - 2 for n in u.shape), u.dtype)


def _class_lanes(u, ext, geo):
    """(index grids, jmax, imax, dx, dy) of a class-mode call, the lane
    scalars as (N, 1, 1) tensors."""
    n = u.shape[0]
    grids = ops.index_grids_2d(u.shape[-2:], 0, (0, 0), u.device)
    jmax, imax = (ext[:, k].to(torch.int64).view(n, 1, 1) for k in (0, 1))
    dx, dy = (geo[:, k].to(u.dtype).view(n, 1, 1) for k in (0, 1))
    return grids, jmax, imax, dx, dy


def _pre_class_plain(u, v, dt, cfg: StepConfig, ext, geo, active):
    """K3's class mode, plain: the JAX package's dynamic PRE on every
    active lane (the class chain's gated BCs, the inflow in the fields'
    dtype from the lane's dy, the predictor on the lane's interior, the
    wall fixups, rhs), the inactive lanes left as they are with F, G, rhs
    0."""
    from ..parallel import ragged2d as rg

    n = u.shape[0]
    (gj, gi), jmax, imax, dx, dy = _class_lanes(u, ext, geo)
    dt3 = dt.to(u.dtype).view(n, 1, 1)
    u1, v1 = ops.apply_wall_bcs_gated(u, v, gj, gi, cfg.bc, (jmax, imax))
    if cfg.problem in ("canal", "canal_obstacle"):
        prof = rg.class_inflow_profile(u.shape[-2], dy, cfg.ylength,
                                       u.dtype, u.device)
        m = (gi == 0) & (gj >= 1) & (gj <= jmax)
        u1 = torch.where(m, prof.expand_as(u1), u1)
    else:
        u1 = ops.apply_special_bc_gated(u1, gj, gi, cfg.problem,
                                        (jmax, imax), None, cfg.ylength)
    f_full, g_full = ops.fg_predictor_terms(u1, v1, dt3, cfg.re, cfg.gx,
                                            cfg.gy, cfg.gamma, dx, dy)
    interior = (gj >= 1) & (gj <= jmax) & (gi >= 1) & (gi <= imax)
    zero = ops._const(0.0, u)
    f, g = ops.fg_fixups_gated(torch.where(interior, f_full, zero),
                               torch.where(interior, g_full, zero),
                               u1, v1, gj, gi, (jmax, imax))
    rhs = torch.where(interior, ops.rhs_terms(f, g, dt3, dx, dy), zero)
    on = active.to(torch.bool).view(n, 1, 1)
    return (torch.where(on, u1, u), torch.where(on, v1, v),
            *(torch.where(on, x, zero) for x in (f, g, rhs)))


def _post_class_plain(u, v, f, g, p, dt, ext, geo, active):
    """K4's class mode, plain: on every active lane the projection on its
    interior and the live-mask multiply; (u'', v'', max|u''|, max|v''|),
    the maxima over each lane's live cells, (N,) each."""
    n = u.shape[0]
    (gj, gi), jmax, imax, dx, dy = _class_lanes(u, ext, geo)
    ua, va = ops.adapt_terms(f, g, p, dt.to(u.dtype).view(n, 1, 1), dx, dy)
    interior = (gj >= 1) & (gj <= jmax) & (gi >= 1) & (gi <= imax)
    live = (gj <= jmax + 1) & (gi <= imax + 1)
    lm = live.to(u.dtype)
    on = active.to(torch.bool).view(n, 1, 1)
    un = torch.where(on, torch.where(interior, ua, u) * lm, u)
    vn = torch.where(on, torch.where(interior, va, v) * lm, v)
    zero = ops._const(0.0, u)
    return (un, vn, torch.where(live, un.abs(), zero).amax((-2, -1)),
            torch.where(live, vn.abs(), zero).amax((-2, -1)))


def _check_class(tensors, dt, ext, geo, active) -> tuple:
    """(lanes, jc, ic) of a class-mode call on the card, after checking its
    lane-stacked fields and per-lane arrays."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"NS-2D kernels take CPU or CUDA tensors, not {t0.device}")
    if t0.dtype not in _SUFFIX or t0.dim() != 3:
        raise ValueError("the class mode takes float32 or float64 fields of "
                         "shape (lanes, jc+2, ic+2)")
    for t in tensors:
        if (t.device != t0.device or t.dtype != t0.dtype
                or t.shape != t0.shape or not t.is_contiguous()):
            raise ValueError("fields must be contiguous and share device, "
                             "dtype and shape")
    n = t0.shape[0]
    for a, dtype, shape in ((dt, t0.dtype, (n,)), (ext, torch.int32, (n, 2)),
                            (geo, t0.dtype, (n, 2)),
                            (active, torch.bool, (n,))):
        if (a.device != t0.device or a.dtype != dtype
                or tuple(a.shape) != shape or not a.is_contiguous()):
            raise ValueError(f"the class mode needs contiguous {dtype} "
                             f"{shape} per-lane arrays on the fields' device")
    return n, t0.shape[1] - 2, t0.shape[2] - 2


def ns2d_pre_plain(u, v, dt, cfg: StepConfig, offs=None, gext=None,
                   ext_pad: int = 0, flags=None, ext=None, geo=None,
                   active=None, bands=None):
    """K3's plain version: returns (u', v', F, G, rhs), inputs untouched;
    in the distributed mode u', v' are deep blocks and F, G, rhs halo-1
    blocks (ops/ns2d.pre_gated). `flags` adds the obstacle velocity BC
    and mask_fg (ops/obstacle.py); `ext`, `geo`, `active` select the class
    mode (module docstring). `bands` (distributed mode only) selects the
    grid-band mode: F, G and rhs hold the full call's values on the bands'
    rows (F and G on the row below each band too, as the kernel writes
    them) and NaN on every other row, so that a merge that reads outside
    the bands shows; u', v' are the full call's."""
    if ext is not None:
        return _pre_class_plain(u, v, dt, cfg, ext, geo, active)
    if offs is not None:
        _mode(u.shape, offs, gext, ext_pad, True)
        out = ops.pre_gated(u, v, dt, cfg.bc, cfg.problem, cfg.re, cfg.gx,
                            cfg.gy, cfg.gamma, cfg.dx, cfg.dy, cfg.ylength,
                            offs, gext, ext_pad, flags)
        if bands is None:
            return out
        return out[:2] + band_plain(
            out[2:], band_ranges(bands, BAND_ROWS, u.shape[0], ext_pad,
                                 MAX_BANDS), u)
    if bands is not None:
        raise ValueError("the grid-band mode is the distributed mode's "
                         "(offsets and global extents)")
    u1, v1 = ops.set_boundary_conditions(u, v, *cfg.bc)
    u1 = ops.set_special_bc(u1, cfg.problem, cfg.dy, cfg.ylength)
    if flags is not None:
        faces = _faces(flags, u)
        u1, v1 = obst.apply_obstacle_velocity_bc(u1, v1, faces)
    f, g = ops.compute_fg(u1, v1, dt, cfg.re, cfg.gx, cfg.gy, cfg.gamma,
                          cfg.dx, cfg.dy)
    if flags is not None:
        f, g = obst.mask_fg(f, g, u1, v1, faces)
    rhs = ops.compute_rhs(f, g, dt, cfg.dx, cfg.dy)
    return u1, v1, f, g, rhs


def ns2d_pre(u, v, dt, cfg: StepConfig, offs=None, gext=None,
             ext_pad: int = 0, flags=None, ext=None, geo=None, active=None,
             bands=None):
    """K3: boundary conditions in place on u and v; returns (F, G, rhs).
    dt is a 0-dim tensor beside the fields. One device by default; with
    the shard's global offsets `offs` = (joff, ioff), the global interior
    extents `gext` = (jmax, imax) and `ext_pad` >= 1, u and v are the
    shard's deep blocks (local index a is global a - ext_pad + offset) and
    F, G, rhs its halo-1 blocks. `flags` (uint8 of u's shape) selects the
    flag mode; `ext`, `geo` and `active` the class mode, with dt (N,)
    (module docstring). `bands` ((start_row, n_blocks), ... of BAND_ROWS
    rows in the deep block's frame, overlap.band_ranges) selects the
    grid-band mode of the distributed call, with or without flags: the BCs as in
    the full call, F, G and rhs only on the bands' rows, every value there
    bitwise the full call's; the other rows of F, G and rhs are left
    unwritten (the plain version's NaN). Its launches count on
    `ns2d_pre_band`."""
    _check_bf16(u, offs, flags, ext, bands)
    if ext is not None:
        return _pre_class(u, v, dt, cfg, ext, geo, active)
    local, o, G = _mode(u.shape, offs, gext, ext_pad, True)
    if bands is not None and offs is None:
        raise ValueError("the grid-band mode is the distributed mode's "
                         "(offsets and global extents)")
    if u.device.type == "cpu":
        u1, v1, f, g, rhs = ns2d_pre_plain(u, v, dt, cfg, offs, gext,
                                           ext_pad, flags, bands=bands)
        u.copy_(u1)
        v.copy_(v1)
        return f, g, rhs
    _check((u, v), dt)
    f, g, rhs = (u.new_empty(tuple(n + 2 for n in local)) for _ in range(3))
    _check((f, g, rhs), dt)
    scratch = [None] * 2
    if flags is not None:
        _check_flags(flags, u)
        scratch = [torch.empty_like(u) for _ in range(2)]
    bc = (ctypes.c_int * 4)(*cfg.bc)
    coef = (ctypes.c_double * 13)(*cfg.coefficients())
    lib = _lib()
    code = _PROBLEM_CODE.get(cfg.problem, 0)
    with torch.cuda.device(u.device):
        if offs is None:
            err = getattr(lib, f"ns2d_pre_{_SUFFIX[u.dtype]}")(
                u.device.index, u.data_ptr(), v.data_ptr(), dt.data_ptr(),
                f.data_ptr(), g.data_ptr(), rhs.data_ptr(), *local, bc, code,
                coef, _ptr(flags), *(_ptr(a) for a in scratch),
                kb.stream_of(u))
        elif bands is None:
            err = getattr(lib, f"ns2d_pre_dist_{_SUFFIX[u.dtype]}")(
                u.device.index, u.data_ptr(), v.data_ptr(), dt.data_ptr(),
                f.data_ptr(), g.data_ptr(), rhs.data_ptr(),
                (ctypes.c_int * 7)(*local, ext_pad, *o, *G), bc, code, coef,
                _ptr(flags), *(_ptr(a) for a in scratch), kb.stream_of(u))
        else:
            ranges = band_ranges(bands, BAND_ROWS, u.shape[0], ext_pad,
                                 MAX_BANDS)
            table = (ctypes.c_int * (1 + 2 * MAX_BANDS))(
                len(ranges), *(r for lohi in ranges for r in lohi))
            err = getattr(lib, f"ns2d_pre_band_{_SUFFIX[u.dtype]}")(
                u.device.index, u.data_ptr(), v.data_ptr(), dt.data_ptr(),
                f.data_ptr(), g.data_ptr(), rhs.data_ptr(),
                (ctypes.c_int * 7)(*local, ext_pad, *o, *G), bc, code, coef,
                _ptr(flags), *(_ptr(a) for a in scratch), table,
                kb.stream_of(u))
    kb.check(lib, err, "ns2d_pre")
    if bands is not None:
        NS2D_PRE_BAND.launches += 1
    elif u.dtype == torch.bfloat16:
        NS2D_PRE_BF16.launches += 1
    else:
        (NS2D_PRE if flags is None else NS2D_PRE_FLAGS).launches += 1
    return f, g, rhs


def _pre_class(u, v, dt, cfg: StepConfig, ext, geo, active):
    if u.device.type == "cpu":
        u1, v1, f, g, rhs = _pre_class_plain(u, v, dt, cfg, ext, geo, active)
        u.copy_(u1)
        v.copy_(v1)
        return f, g, rhs
    n, jc, ic = _check_class((u, v), dt, ext, geo, active)
    f, g, rhs = (torch.empty_like(u) for _ in range(3))
    bc = (ctypes.c_int * 4)(*cfg.bc)
    coef = (ctypes.c_double * 6)(cfg.gamma, 1.0 / cfg.re, cfg.gx, cfg.gy,
                                 cfg.ylength, cfg.ylength * cfg.ylength)
    lib = _lib()
    with torch.cuda.device(u.device):
        err = getattr(lib, f"ns2d_pre_class_{_SUFFIX[u.dtype]}")(
            u.device.index, u.data_ptr(), v.data_ptr(), dt.data_ptr(),
            f.data_ptr(), g.data_ptr(), rhs.data_ptr(), ext.data_ptr(),
            geo.data_ptr(), active.data_ptr(), n, jc, ic, bc,
            _PROBLEM_CODE.get(cfg.problem, 0), coef, kb.stream_of(u))
    kb.check(lib, err, "ns2d_pre_class")
    NS2D_PRE_CLASS.launches += 1
    return f, g, rhs


def ns2d_post_plain(u, v, f, g, p, dt, dx, dy, offs=None, gext=None,
                    ragged: bool = False, flags=None, ext=None, geo=None,
                    active=None):
    """K4's plain version: returns (u'', v'', max|u''|, max|v''|); in the
    distributed mode the gated projection of ops/ns2d.post_gated on the
    shard's halo-1 blocks. `flags` restricts the projection to
    fluid-fluid faces (ops/obstacle.adapt_uv_obstacle); `ext`, `geo`,
    `active` select the class mode (dx, dy unused)."""
    if ext is not None:
        return _post_class_plain(u, v, f, g, p, dt, ext, geo, active)
    if offs is not None:
        return ops.post_gated(u, v, f, g, p, dt, dx, dy, offs, gext, ragged,
                              flags)
    if flags is None:
        u2, v2 = ops.adapt_uv(u, v, f, g, p, dt, dx, dy)
    else:
        u2, v2 = obst.adapt_uv_obstacle(u, v, f, g, p, dt, dx, dy,
                                        _faces(flags, u))
    return u2, v2, ops.max_element(u2), ops.max_element(v2)


def ns2d_post(u, v, f, g, p, dt, dx, dy, offs=None, gext=None,
              ragged: bool = False, flags=None, ext=None, geo=None,
              active=None):
    """K4: projection in place on u and v; returns (umax, vmax) as 0-dim
    tensors on the fields' device. With the shard's global offsets and the
    global extents, the distributed mode on its halo-1 blocks (`ragged`:
    the mesh does not divide the grid, and the dead cells are zeroed); the
    maxima are then the shard's. `flags` (uint8 of u's shape) selects the
    flag mode; `ext`, `geo` and `active` the class mode (dx, dy unused),
    whose maxima are (N,) each (module docstring)."""
    _check_bf16(u, offs, flags, ext)
    if ext is not None:
        return _post_class(u, v, f, g, p, dt, ext, geo, active)
    local, o, G = _mode(u.shape, offs, gext, 0, False)
    if u.device.type == "cpu":
        u2, v2, umax, vmax = ns2d_post_plain(u, v, f, g, p, dt, dx, dy,
                                             offs, gext, ragged, flags)
        u.copy_(u2)
        v.copy_(v2)
        return umax, vmax
    _check((u, v, f, g, p), dt)
    if flags is not None:
        _check_flags(flags, u)
    lib = _lib()
    partial = torch.empty(lib.ns2d_post_partials(*local), dtype=u.dtype,
                          device=u.device)
    out = torch.empty(2, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        if offs is None:
            err = getattr(lib, f"ns2d_post_{_SUFFIX[u.dtype]}")(
                u.device.index, u.data_ptr(), v.data_ptr(), f.data_ptr(),
                g.data_ptr(), p.data_ptr(), dt.data_ptr(), *local, dx, dy,
                _ptr(flags), partial.data_ptr(), out.data_ptr(),
                kb.stream_of(u))
        else:
            err = getattr(lib, f"ns2d_post_dist_{_SUFFIX[u.dtype]}")(
                u.device.index, u.data_ptr(), v.data_ptr(), f.data_ptr(),
                g.data_ptr(), p.data_ptr(), dt.data_ptr(),
                (ctypes.c_int * 6)(*local, *o, *G), int(ragged), dx, dy,
                _ptr(flags), partial.data_ptr(), out.data_ptr(),
                kb.stream_of(u))
    kb.check(lib, err, "ns2d_post")
    if u.dtype == torch.bfloat16:
        NS2D_POST_BF16.launches += 1
    else:
        (NS2D_POST if flags is None else NS2D_POST_FLAGS).launches += 1
    return out[0], out[1]


def _post_class(u, v, f, g, p, dt, ext, geo, active):
    if u.device.type == "cpu":
        u2, v2, umax, vmax = _post_class_plain(u, v, f, g, p, dt, ext, geo,
                                               active)
        u.copy_(u2)
        v.copy_(v2)
        return umax, vmax
    n, jc, ic = _check_class((u, v, f, g, p), dt, ext, geo, active)
    lib = _lib()
    partial = torch.empty(n * lib.ns2d_post_partials(jc, ic), dtype=u.dtype,
                          device=u.device)
    out = torch.empty((2, n), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        err = getattr(lib, f"ns2d_post_class_{_SUFFIX[u.dtype]}")(
            u.device.index, u.data_ptr(), v.data_ptr(), f.data_ptr(),
            g.data_ptr(), p.data_ptr(), dt.data_ptr(), ext.data_ptr(),
            geo.data_ptr(), active.data_ptr(), n, jc, ic, partial.data_ptr(),
            out.data_ptr(), kb.stream_of(u))
    kb.check(lib, err, "ns2d_post_class")
    NS2D_POST_CLASS.launches += 1
    return out[0], out[1]
