"""Kernels K7 and K8: the NS-3D step phases around the pressure solve on
the H100, each beside its plain PyTorch version (sources:
pampi_tpu_torch/csrc/ns3d_fused.cu), with and without obstacle flag
fields.

K7 `ns3d_pre` replaces pampi_tpu/ops/ns3d_fused.py `_pre3_kernel`
  (make_fused_pre_3d, pallas_call at :778): (u, v, w, dt) -> (u', v', w',
  F, G, H, rhs) = the six wall BCs in the reference order -> dcavity lid /
  canal inflow -> F/G/H predictor + wall fixups -> RHS. u, v and w are
  updated in place.
K8 `ns3d_post` replaces pampi_tpu/ops/ns3d_fused.py `_post3_kernel`
  (make_fused_post_3d, pallas_call at :880): the projection in place on the
  interiors of u, v, w, then max|u|, |v|, |w| over the FULL ghosted arrays
  (the reference's maxElement quirk), which the next step's CFL dt reads.

Both gate every write by the global index, as the TPU kernels do. On one
device the block is the whole array at offset 0. In the distributed mode
(models/ns3d_dist.py; JAX make_fused_pre_3d(..., kl, jl, il,
ext_pad=FUSE_DEEP_HALO - 1) and make_fused_post_3d(..., kl, jl, il)) the
caller passes the shard's global offsets and the global extents: PRE takes
the shard's deep blocks (ext_pad ghost layers more per side than the
halo-1 block), applies the BCs in place where the global walls cross them
and returns F, G, H, rhs on the halo-1 block; POST takes the halo-1 blocks
and returns the shard's maxima.

What bounds them on the H100 is memory bandwidth: PRE reads u, v, w and
writes F, G, H, rhs and the ghost planes of u, v, w; POST reads F, G, H, p
and writes u, v, w: 7 field-sizes each, ~144 us at 256³ f32. Design,
simple first: PRE is five launches (the three axes' wall pairs in order,
the special BC riding with the last pair, F/G/H per cell, RHS per cell);
POST is one launch with per-block partial maxima and a one-block launch
that reduces them. dt stays on the device, so no launch waits for the host.
The source note in ns3d_fused.cu gives the proof that the three wall
launches reproduce the six ordered faces.

The flag mode (`flags=`, a uint8 fluid field of the input block's shape:
the TPU kernels' masked mode, fed the global flags on one device and, on
a mesh, the shard's deep flag block for PRE and its halo-1 block for POST,
as the JAX package's fused_flag_blocks): PRE applies the obstacle
velocity BC after the walls and the special BC and makes F/G/H carry
U/V/W on non-fluid faces (ops/obstacle3d.apply_obstacle_velocity_bc_3d,
mask_fgh); POST projects on fluid-fluid faces only (adapt_uvw_obstacle).
Its launches count on kernel entries of their own, `ns3d_pre_flags` and
`ns3d_post_flags`. PRE's flag mode is five launches: the three wall
launches and, instead of F/G/H per cell, one tiled launch through shared
memory that applies the obstacle velocity BC and computes F, G, H (no
snapshot of u, v, w in device memory, nothing allocated beyond the
outputs), then rhs, which also writes the few cells whose face is forced
on the last global ghost plane and buried in a deep block's dead cells
(the tiled launch's in-place writes leave them alone: the csrc note says
why). The flags are 0 or 1, as the package makes them.

The ragged mode of K8 (`ragged=True`, a mesh that does not divide the
grid: ceil-divided shards whose trailing cells are dead; JAX
make_fused_post_3d(ragged=True)): after the projection u, v, w are
multiplied by the live mask (parallel/ragged3d.live_masks_3d), so that
the dead cells hold 0 and never reach the ghost-inclusive maxima. Its
launches count on `ns3d_post_ragged` and, with the flags,
`ns3d_post_flags_ragged`. K7 runs unchanged at such uneven shard bounds:
every write is gated by the global index, wherever the walls cross the
block.

The class mode (`ext=`, `geo=`, `active=`: the fleet's 3-D shape-class
lanes, the JAX package's make_fused_pre_3d(..., dynamic=True) and
make_fused_post_3d(..., ragged=True, dynamic=True)): u, v, w, F, G, H,
rhs, p are lane-stacked (N, kc+2, jc+2, ic+2) class blocks whose live
corner is each lane's own grid; ext (N, 3) int32 holds each lane's (kmax,
jmax, imax), geo (N, 3) its (dx, dy, dz) in the fields' dtype, dt (N,) its
timestep and active (N,) bool which lanes step. Every write is gated by the
lane's extents, and 1/dx, the predictor's coefficients and dt/dx are
formed in the fields' dtype from the lane's dx, dy, dz, as the JAX kernels
form them from their SMEM scalars (the one-grid mode folds them in double
on the host). An inactive lane is left as it is (its F, G, H, rhs are 0).
POST zeroes the dead cells after the projection (the live-mask multiply)
and returns each lane's max|u|, max|v|, max|w| over its live cells, (N,)
each. The lane shares the grid's z axis with the k plane (z = lane·(kc+2)
+ k); past CUDA's 65,535 a block loops over z, so no lane is dropped.
Launches: five for PRE and two for POST, for the whole batch, counted on
entries of their own, `ns3d_pre_class` and `ns3d_post_class`. Every
lane's extents must fit its block (1 <= kmax <= kc, ...): the kernels
read them on the card unchecked, and fleet/shapeclass.class_lanes_3d
checks them on the host.

The grid-band mode of the distributed PRE (`bands=`, the JAX package's
make_fused_pre_3d(grid_bands=); the overlapped step's interior and
boundary halves, parallel/overlap.py): K7 with its F/G/H and rhs launches
restricted to bands of the halo-1 block's k-planes (the BCs as in the full
call), every value inside the bands bitwise the full call's. Its launches
count on `ns3d_pre_band`, with or without flags.

For a CPU tensor each wrapper runs its plain version (ops/ns3d.py,
ops/obstacle3d.py, parallel/ragged3d.py's class forms); for a CUDA tensor
it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from ..parallel.overlap import band_plain, band_ranges
from . import ns3d as ops
from . import obstacle3d as obst3

SOURCE = "pampi_tpu_torch/csrc/ns3d_fused.cu"
NS3D_PRE = kb.register(
    "ns3d_pre", SOURCE, "pampi_tpu/ops/ns3d_fused.py:778")
NS3D_POST = kb.register(
    "ns3d_post", SOURCE, "pampi_tpu/ops/ns3d_fused.py:880")
NS3D_PRE_FLAGS = kb.register(
    "ns3d_pre_flags", SOURCE, "pampi_tpu/ops/ns3d_fused.py:778")
NS3D_POST_FLAGS = kb.register(
    "ns3d_post_flags", SOURCE, "pampi_tpu/ops/ns3d_fused.py:880")
NS3D_POST_RAGGED = kb.register(
    "ns3d_post_ragged", SOURCE, "pampi_tpu/ops/ns3d_fused.py:880")
NS3D_POST_FLAGS_RAGGED = kb.register(
    "ns3d_post_flags_ragged", SOURCE, "pampi_tpu/ops/ns3d_fused.py:880")
NS3D_PRE_CLASS = kb.register(
    "ns3d_pre_class", SOURCE, "pampi_tpu/ops/ns3d_fused.py:778")
NS3D_POST_CLASS = kb.register(
    "ns3d_post_class", SOURCE, "pampi_tpu/ops/ns3d_fused.py:880")
NS3D_PRE_BAND = kb.register(
    "ns3d_pre_band", SOURCE, "pampi_tpu/ops/ns3d_fused.py:778")

# the grid-band mode: k-planes of the deep block a band block covers (a
# grid z index of the band launch), and the most bands one call takes
BAND_ROWS = 1
MAX_BANDS = 4

_PROBLEM_CODE = {"dcavity": 1, "canal": 2}
_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PRE_ARGS = [_I, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _I, _V, _V,
             _V]
_POST_ARGS = [_I, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _D, _D, _D, _V, _I,
              _V, _V, _V]
_PRE_BAND_ARGS = _PRE_ARGS[:-1] + [_V, _V]
_SIGNATURES = {
    "ns3d_pre_f32": _PRE_ARGS, "ns3d_pre_f64": _PRE_ARGS,
    "ns3d_pre_band_f32": _PRE_BAND_ARGS, "ns3d_pre_band_f64": _PRE_BAND_ARGS,
    "ns3d_post_f32": _POST_ARGS, "ns3d_post_f64": _POST_ARGS,
    "ns3d_post_partials": [_I, _I, _I],
}
# dev, u, v, w, dt, f, g, h, rhs, ext, geo, active, lanes, kc, jc, ic, bc,
# problem, c, stream; and dev, u, v, w, f, g, h, p, dt, ext, geo, active,
# lanes, kc, jc, ic, partial, out, stream
for _t in ("f32", "f64"):
    _SIGNATURES[f"ns3d_pre_class_{_t}"] = [_I] + [_V] * 11 + [_I] * 4 + [
        _V, _I, _V, _V]
    _SIGNATURES[f"ns3d_post_class_{_t}"] = [_I] + [_V] * 11 + [_I] * 4 + [
        _V] * 3
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclass(frozen=True)
class StepConfig3D:
    """The static configuration of the 3-D step phases (from a Parameter)."""

    bc: tuple  # (top, bottom, left, right, front, back): the reference order
    problem: str  # "dcavity", "canal" or another name (no special BC)
    re: float
    gx: float
    gy: float
    gz: float
    gamma: float
    dx: float
    dy: float
    dz: float

    @classmethod
    def from_param(cls, param) -> "StepConfig3D":
        return cls(
            (param.bcTop, param.bcBottom, param.bcLeft, param.bcRight,
             param.bcFront, param.bcBack),
            param.name.replace("3d", ""), param.re, param.gx, param.gy,
            param.gz, param.gamma, param.xlength / param.imax,
            param.ylength / param.jmax, param.zlength / param.kmax)

    @property
    def bcs(self) -> dict:
        """face -> kind, in the reference's application order."""
        return dict(zip(("top", "bottom", "left", "right", "front", "back"),
                        self.bc))

    def coefficients(self) -> list[float]:
        """Scalar coefficients in double, formed exactly where the JAX
        package forms them from Python floats (ops/ns3d.py)."""
        idx, idy, idz = 1.0 / self.dx, 1.0 / self.dy, 1.0 / self.dz
        g = self.gamma
        return [idx * 0.25, g * idx * 0.25, idy * 0.25, g * idy * 0.25,
                idz * 0.25, g * idz * 0.25, idx * idx, idy * idy, idz * idz,
                1.0 / self.re, self.gx, self.gy, self.gz, self.dx, self.dy,
                self.dz]


def _check(tensors, dt, shape=None) -> None:
    """Device, dtype, contiguity; every tensor of `shape` (default: the
    first one's)."""
    t0 = tensors[0]
    shape = t0.shape if shape is None else shape
    if t0.device.type != "cuda":
        raise ValueError(f"NS-3D kernels take CPU or CUDA tensors, not {t0.device}")
    if t0.dtype not in _SUFFIX:
        raise ValueError(f"NS-3D kernels take float32 or float64, not {t0.dtype}")
    if t0.dim() != 3 or min(shape) < 4:
        raise ValueError("fields must be 3-D with at least 2 interior cells "
                         f"per axis, got {tuple(shape)}")
    for t in tensors:
        if (t.device != t0.device or t.dtype != t0.dtype
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError("fields must be contiguous and share device, "
                             "dtype and shape")
    if dt.device != t0.device or dt.dtype != t0.dtype or dt.numel() != 1:
        raise ValueError("dt must be a one-element tensor beside the fields")


def _lib():
    return kb.load("ns3d_fused", _SIGNATURES)


def _mode(shape, offs, gext, ext_pad: int, deep: bool):
    """(local interior extents of the halo-1 block, offsets, global
    extents) of a call: one device when offs is None; otherwise the
    shard's, on a deep block (ext_pad >= 1) when `deep`."""
    local = tuple(n - 2 - 2 * ext_pad for n in shape)
    if offs is None:
        if ext_pad:
            raise ValueError("a deep block (ext_pad > 0) needs the shard's "
                             "offsets and the global extents")
        return local, (0, 0, 0), local
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


def _class_lanes(u, dt, ext, geo):
    """(index grids, (kmax, jmax, imax), (dx, dy, dz), dt) of a class-mode
    call, the lane scalars as (N, 1, 1, 1) tensors."""
    from ..parallel import ragged3d as rg3

    n = u.shape[0]
    grids = rg3.class_index_grids_3d(*(m - 2 for m in u.shape[1:]),
                                     u.device)
    ext4 = tuple(ext[:, a].to(torch.int64).view(n, 1, 1, 1) for a in range(3))
    cell = tuple(geo[:, a].to(u.dtype).view(n, 1, 1, 1) for a in range(3))
    return grids, ext4, cell, dt.to(u.dtype).view(n, 1, 1, 1)


def _pre_class_plain(u, v, w, dt, cfg: StepConfig3D, ext, geo, active):
    """K7's class mode, plain: parallel/ragged3d.class_pre_3d on every
    active lane, the inactive lanes left as they are with F, G, H, rhs 0."""
    from ..parallel import ragged3d as rg3

    grids, ext4, cell, dt4 = _class_lanes(u, dt, ext, geo)
    out = rg3.class_pre_3d(u, v, w, dt4, cfg, grids, ext4, cell)
    on = active.to(torch.bool).view(-1, 1, 1, 1)
    zero = ops._const(0.0, u)
    return (*(torch.where(on, a, b) for a, b in zip(out[:3], (u, v, w))),
            *(torch.where(on, x, zero) for x in out[3:]))


def _post_class_plain(u, v, w, f, g, h, p, dt, ext, geo, active):
    """K8's class mode, plain: on every active lane parallel/ragged3d.
    class_post_3d (the projection and the live-mask multiply); returns
    (u'', v'', w'', max|u''|, max|v''|, max|w''|), the maxima over each
    lane's live cells, (N,) each."""
    from ..parallel import ragged3d as rg3

    grids, ext4, cell, dt4 = _class_lanes(u, dt, ext, geo)
    new = rg3.class_post_3d(u, v, w, f, g, h, p, dt4, grids, ext4, cell)
    on = active.to(torch.bool).view(-1, 1, 1, 1)
    out = tuple(torch.where(on, a, b) for a, b in zip(new, (u, v, w)))
    _interior, live = rg3.class_masks_3d(grids, *ext4)
    zero = ops._const(0.0, u)
    return (*out, *(torch.where(live, a.abs(), zero).amax((-3, -2, -1))
                    for a in out))


def _check_class(tensors, dt, ext, geo, active) -> tuple:
    """(lanes, kc, jc, ic) of a class-mode call on the card, after checking
    its lane-stacked fields and per-lane arrays."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"NS-3D kernels take CPU or CUDA tensors, not {t0.device}")
    if t0.dtype not in _SUFFIX or t0.dim() != 4 or min(t0.shape[1:]) < 4:
        raise ValueError("the class mode takes float32 or float64 fields of "
                         "shape (lanes, kc+2, jc+2, ic+2), kc, jc, ic >= 2")
    for t in tensors:
        if (t.device != t0.device or t.dtype != t0.dtype
                or t.shape != t0.shape or not t.is_contiguous()):
            raise ValueError("fields must be contiguous and share device, "
                             "dtype and shape")
    n = t0.shape[0]
    for a, dtype, shape in ((dt, t0.dtype, (n,)), (ext, torch.int32, (n, 3)),
                            (geo, t0.dtype, (n, 3)),
                            (active, torch.bool, (n,))):
        if (a.device != t0.device or a.dtype != dtype
                or tuple(a.shape) != shape or not a.is_contiguous()):
            raise ValueError(f"the class mode needs contiguous {dtype} "
                             f"{shape} per-lane arrays on the fields' device")
    return (n, *(m - 2 for m in t0.shape[1:]))


def _pre_class(u, v, w, dt, cfg: StepConfig3D, ext, geo, active):
    if u.device.type == "cpu":
        *uvw, f, g, h, rhs = _pre_class_plain(u, v, w, dt, cfg, ext, geo,
                                              active)
        for a, b in zip((u, v, w), uvw):
            a.copy_(b)
        return f, g, h, rhs
    n, kc, jc, ic = _check_class((u, v, w), dt, ext, geo, active)
    f, g, h, rhs = (torch.empty_like(u) for _ in range(4))
    bc = (ctypes.c_int * 6)(*cfg.bc)
    coef = (ctypes.c_double * 5)(cfg.gamma, 1.0 / cfg.re, cfg.gx, cfg.gy,
                                 cfg.gz)
    lib = _lib()
    with torch.cuda.device(u.device):
        err = getattr(lib, f"ns3d_pre_class_{_SUFFIX[u.dtype]}")(
            u.device.index, u.data_ptr(), v.data_ptr(), w.data_ptr(),
            dt.data_ptr(), f.data_ptr(), g.data_ptr(), h.data_ptr(),
            rhs.data_ptr(), ext.data_ptr(), geo.data_ptr(), active.data_ptr(),
            n, kc, jc, ic, bc, _PROBLEM_CODE.get(cfg.problem, 0), coef,
            kb.stream_of(u))
    kb.check(lib, err, "ns3d_pre_class")
    NS3D_PRE_CLASS.launches += 1
    return f, g, h, rhs


def _post_class(u, v, w, f, g, h, p, dt, ext, geo, active):
    if u.device.type == "cpu":
        *uvw, umax, vmax, wmax = _post_class_plain(u, v, w, f, g, h, p, dt,
                                                   ext, geo, active)
        for a, b in zip((u, v, w), uvw):
            a.copy_(b)
        return umax, vmax, wmax
    n, kc, jc, ic = _check_class((u, v, w, f, g, h, p), dt, ext, geo,
                                 active)
    lib = _lib()
    partial = torch.empty(n * lib.ns3d_post_partials(kc, jc, ic),
                          dtype=u.dtype, device=u.device)
    out = torch.empty((3, n), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        err = getattr(lib, f"ns3d_post_class_{_SUFFIX[u.dtype]}")(
            u.device.index, u.data_ptr(), v.data_ptr(), w.data_ptr(),
            f.data_ptr(), g.data_ptr(), h.data_ptr(), p.data_ptr(),
            dt.data_ptr(), ext.data_ptr(), geo.data_ptr(), active.data_ptr(),
            n, kc, jc, ic, partial.data_ptr(), out.data_ptr(),
            kb.stream_of(u))
    kb.check(lib, err, "ns3d_post_class")
    NS3D_POST_CLASS.launches += 1
    return out[0], out[1], out[2]


def ns3d_pre_plain(u, v, w, dt, cfg: StepConfig3D, offs=None, gext=None,
                   ext_pad: int = 0, flags=None, ext=None, geo=None,
                   active=None, bands=None):
    """K7's plain version: returns (u', v', w', F, G, H, rhs), inputs
    untouched; in the distributed mode u', v', w' are deep blocks and
    F, G, H, rhs halo-1 blocks (ops/ns3d.pre_gated). `flags` adds the
    obstacle velocity BC and mask_fgh (ops/obstacle3d.py); `ext`, `geo`,
    `active` select the class mode (module docstring). `bands`
    (distributed mode only) selects the grid-band mode: F, G, H and rhs
    hold the full call's values on the bands' k-planes (F, G, H on the
    plane below each band too, as the kernel writes them) and NaN on
    every other plane; u', v', w' are the full call's."""
    if ext is not None:
        return _pre_class_plain(u, v, w, dt, cfg, ext, geo, active)
    if offs is not None:
        _mode(u.shape, offs, gext, ext_pad, True)
        out = ops.pre_gated(u, v, w, dt, cfg.bcs, cfg.problem, cfg.re,
                            cfg.gx, cfg.gy, cfg.gz, cfg.gamma, cfg.dx,
                            cfg.dy, cfg.dz, offs, gext, ext_pad, flags)
        if bands is None:
            return out
        return out[:3] + band_plain(
            out[3:], band_ranges(bands, BAND_ROWS, u.shape[0], ext_pad,
                                 MAX_BANDS), u)
    if bands is not None:
        raise ValueError("the grid-band mode is the distributed mode's "
                         "(offsets and global extents)")
    u1, v1, w1 = ops.set_boundary_conditions_3d(u, v, w, cfg.bcs)
    u1 = ops.set_special_bc_3d(u1, cfg.problem)
    if flags is not None:
        faces = obst3.block_faces_3d(
            flags, *ops.index_grids(u.shape, 0, (0, 0, 0), u.device),
            tuple(n - 2 for n in u.shape), u.dtype)
        u1, v1, w1 = obst3.apply_obstacle_velocity_bc_3d(u1, v1, w1, faces)
    f, g, h = ops.compute_fgh(u1, v1, w1, dt, cfg.re, cfg.gx, cfg.gy, cfg.gz,
                              cfg.gamma, cfg.dx, cfg.dy, cfg.dz)
    if flags is not None:
        f, g, h = obst3.mask_fgh(f, g, h, u1, v1, w1, faces)
    rhs = ops.compute_rhs(f, g, h, dt, cfg.dx, cfg.dy, cfg.dz)
    return u1, v1, w1, f, g, h, rhs


def ns3d_pre(u, v, w, dt, cfg: StepConfig3D, offs=None, gext=None,
             ext_pad: int = 0, flags=None, ext=None, geo=None, active=None,
             bands=None):
    """K7: boundary conditions in place on u, v, w; returns (F, G, H, rhs).
    dt is a 0-dim tensor beside the fields. One device by default; with
    the shard's global offsets `offs` = (koff, joff, ioff), the global
    interior extents `gext` and `ext_pad` >= 1, u, v, w are the shard's
    deep blocks (local index a is global a - ext_pad + offset) and F, G,
    H, rhs its halo-1 blocks. `flags` (uint8 of u's shape) selects the
    flag mode; `ext`, `geo` and `active` the class mode, with dt (N,)
    (module docstring). `bands` ((start_plane, n_planes), ... in the deep
    block's frame, overlap.band_ranges) selects the grid-band mode of the
    distributed call, with or without flags: the BCs as in the full call,
    F, G, H and rhs only on the bands' k-planes, every value there
    bitwise the full call's; the other planes are left unwritten (the
    plain version's NaN). Its launches count on `ns3d_pre_band`."""
    if ext is not None:
        return _pre_class(u, v, w, dt, cfg, ext, geo, active)
    local, o, G = _mode(u.shape, offs, gext, ext_pad, True)
    if bands is not None and offs is None:
        raise ValueError("the grid-band mode is the distributed mode's "
                         "(offsets and global extents)")
    if u.device.type == "cpu":
        u1, v1, w1, f, g, h, rhs = ns3d_pre_plain(u, v, w, dt, cfg, offs,
                                                  gext, ext_pad, flags,
                                                  bands=bands)
        for a, b in ((u, u1), (v, v1), (w, w1)):
            a.copy_(b)
        return f, g, h, rhs
    _check((u, v, w), dt)
    f, g, h, rhs = (u.new_empty(tuple(n + 2 for n in local))
                    for _ in range(4))
    _check((f, g, h, rhs), dt)
    if flags is not None:
        _check_flags(flags, u)
    bc = (ctypes.c_int * 6)(*cfg.bc)
    coef = (ctypes.c_double * 16)(*cfg.coefficients())
    lib = _lib()
    args = (u.device.index, u.data_ptr(), v.data_ptr(), w.data_ptr(),
            dt.data_ptr(), f.data_ptr(), g.data_ptr(), h.data_ptr(),
            rhs.data_ptr(), (ctypes.c_int * 3)(*local),
            (ctypes.c_int * 7)(ext_pad, *o, *G), bc,
            _PROBLEM_CODE.get(cfg.problem, 0), coef, _ptr(flags))
    with torch.cuda.device(u.device):
        if bands is None:
            err = getattr(lib, f"ns3d_pre_{_SUFFIX[u.dtype]}")(
                *args, kb.stream_of(u))
        else:
            ranges = band_ranges(bands, BAND_ROWS, u.shape[0], ext_pad,
                                 MAX_BANDS)
            table = (ctypes.c_int * (1 + 2 * MAX_BANDS))(
                len(ranges), *(r for lohi in ranges for r in lohi))
            err = getattr(lib, f"ns3d_pre_band_{_SUFFIX[u.dtype]}")(
                *args, table, kb.stream_of(u))
    kb.check(lib, err, "ns3d_pre")
    if bands is not None:
        NS3D_PRE_BAND.launches += 1
    else:
        (NS3D_PRE if flags is None else NS3D_PRE_FLAGS).launches += 1
    return f, g, h, rhs


def _ptr(t):
    return None if t is None else t.data_ptr()


# K8's kernel entry by (flag mode, ragged mode)
_POST_ENTRY = {(False, False): NS3D_POST, (True, False): NS3D_POST_FLAGS,
               (False, True): NS3D_POST_RAGGED,
               (True, True): NS3D_POST_FLAGS_RAGGED}


def ns3d_post_plain(u, v, w, f, g, h, p, dt, dx, dy, dz, offs=None,
                    gext=None, flags=None, ragged: bool = False, ext=None,
                    geo=None, active=None):
    """K8's plain version: returns (u'', v'', w'', max|u''|, max|v''|,
    max|w''|); in the distributed mode the gated projection of
    ops/ns3d.post_gated on the shard's halo-1 blocks, with the live-mask
    multiply when `ragged`. `flags` restricts the projection to
    fluid-fluid faces (ops/obstacle3d.adapt_uvw_obstacle); `ext`, `geo`,
    `active` select the class mode (dx, dy, dz unused)."""
    if ext is not None:
        return _post_class_plain(u, v, w, f, g, h, p, dt, ext, geo, active)
    if offs is not None:
        return ops.post_gated(u, v, w, f, g, h, p, dt, dx, dy, dz, offs,
                              gext, flags, ragged)
    if flags is None:
        u2, v2, w2 = ops.adapt_uvw(u, v, w, f, g, h, p, dt, dx, dy, dz)
    else:
        faces = obst3.block_faces_3d(
            flags, *ops.index_grids(u.shape, 0, (0, 0, 0), u.device),
            tuple(n - 2 for n in u.shape), u.dtype)
        u2, v2, w2 = obst3.adapt_uvw_obstacle(u, v, w, f, g, h, p, dt, dx,
                                              dy, dz, faces)
    return (u2, v2, w2, ops.max_element(u2), ops.max_element(v2),
            ops.max_element(w2))


def ns3d_post(u, v, w, f, g, h, p, dt, dx, dy, dz, offs=None, gext=None,
              flags=None, ragged: bool = False, ext=None, geo=None,
              active=None):
    """K8: projection in place on u, v, w; returns (umax, vmax, wmax) as
    0-dim tensors on the fields' device. With the shard's global offsets
    and the global extents, the distributed mode on its halo-1 blocks
    (the maxima are the shard's). `flags` (uint8 of u's shape) selects
    the flag mode, `ragged` the live-mask multiply of a mesh that does
    not divide the grid; `ext`, `geo` and `active` the class mode (dx,
    dy, dz unused), whose maxima are (N,) each (module docstring)."""
    if ext is not None:
        return _post_class(u, v, w, f, g, h, p, dt, ext, geo, active)
    local, o, G = _mode(u.shape, offs, gext, 0, False)
    if ragged and offs is None:
        raise ValueError("the ragged mode needs the shard's offsets and the "
                         "global extents")
    if u.device.type == "cpu":
        u2, v2, w2, *maxima = ns3d_post_plain(u, v, w, f, g, h, p, dt, dx,
                                              dy, dz, offs, gext, flags,
                                              ragged)
        for a, b in ((u, u2), (v, v2), (w, w2)):
            a.copy_(b)
        return tuple(maxima)
    _check((u, v, w, f, g, h, p), dt)
    if flags is not None:
        _check_flags(flags, u)
    lib = _lib()
    partial = torch.empty(lib.ns3d_post_partials(*local), dtype=u.dtype,
                          device=u.device)
    out = torch.empty(3, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        err = getattr(lib, f"ns3d_post_{_SUFFIX[u.dtype]}")(
            u.device.index, u.data_ptr(), v.data_ptr(), w.data_ptr(),
            f.data_ptr(), g.data_ptr(), h.data_ptr(), p.data_ptr(),
            dt.data_ptr(), (ctypes.c_int * 3)(*local),
            (ctypes.c_int * 6)(*o, *G), dx, dy, dz, _ptr(flags), int(ragged),
            partial.data_ptr(), out.data_ptr(), kb.stream_of(u))
    kb.check(lib, err, "ns3d_post")
    _POST_ENTRY[flags is not None, bool(ragged)].launches += 1
    return out[0], out[1], out[2]
