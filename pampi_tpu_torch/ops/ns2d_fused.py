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

For a CPU tensor each wrapper runs its plain version (ops/ns2d.py,
ops/obstacle.py); for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..kernels import build as kb
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

_PROBLEM_CODE = {"dcavity": 1, "canal": 2, "canal_obstacle": 2}
_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PRE_ARGS = [_I, _V, _V, _V, _V, _V, _V, _I, _I, _V, _I, _V, _V, _V, _V, _V]
_POST_ARGS = [_I, _V, _V, _V, _V, _V, _V, _I, _I, _D, _D, _V, _V, _V, _V]
_PRE_DIST_ARGS = [_I, _V, _V, _V, _V, _V, _V, _V, _V, _I, _V, _V, _V, _V, _V]
_POST_DIST_ARGS = [_I, _V, _V, _V, _V, _V, _V, _V, _I, _D, _D, _V, _V, _V,
                   _V]
_SIGNATURES = {
    "ns2d_pre_f32": _PRE_ARGS, "ns2d_pre_f64": _PRE_ARGS,
    "ns2d_post_f32": _POST_ARGS, "ns2d_post_f64": _POST_ARGS,
    "ns2d_pre_dist_f32": _PRE_DIST_ARGS, "ns2d_pre_dist_f64": _PRE_DIST_ARGS,
    "ns2d_post_dist_f32": _POST_DIST_ARGS,
    "ns2d_post_dist_f64": _POST_DIST_ARGS,
    "ns2d_post_partials": [_I, _I],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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
        raise ValueError(f"NS-2D kernels take float32 or float64, not {t0.dtype}")
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


def ns2d_pre_plain(u, v, dt, cfg: StepConfig, offs=None, gext=None,
                   ext_pad: int = 0, flags=None):
    """K3's plain version: returns (u', v', F, G, rhs), inputs untouched;
    in the distributed mode u', v' are deep blocks and F, G, rhs halo-1
    blocks (ops/ns2d.pre_gated). `flags` adds the obstacle velocity BC
    and mask_fg (ops/obstacle.py)."""
    if offs is not None:
        _mode(u.shape, offs, gext, ext_pad, True)
        return ops.pre_gated(u, v, dt, cfg.bc, cfg.problem, cfg.re, cfg.gx,
                             cfg.gy, cfg.gamma, cfg.dx, cfg.dy, cfg.ylength,
                             offs, gext, ext_pad, flags)
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
             ext_pad: int = 0, flags=None):
    """K3: boundary conditions in place on u and v; returns (F, G, rhs).
    dt is a 0-dim tensor beside the fields. One device by default; with
    the shard's global offsets `offs` = (joff, ioff), the global interior
    extents `gext` = (jmax, imax) and `ext_pad` >= 1, u and v are the
    shard's deep blocks (local index a is global a - ext_pad + offset) and
    F, G, rhs its halo-1 blocks. `flags` (uint8 of u's shape) selects the
    flag mode."""
    local, o, G = _mode(u.shape, offs, gext, ext_pad, True)
    if u.device.type == "cpu":
        u1, v1, f, g, rhs = ns2d_pre_plain(u, v, dt, cfg, offs, gext,
                                           ext_pad, flags)
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
        else:
            err = getattr(lib, f"ns2d_pre_dist_{_SUFFIX[u.dtype]}")(
                u.device.index, u.data_ptr(), v.data_ptr(), dt.data_ptr(),
                f.data_ptr(), g.data_ptr(), rhs.data_ptr(),
                (ctypes.c_int * 7)(*local, ext_pad, *o, *G), bc, code, coef,
                _ptr(flags), *(_ptr(a) for a in scratch), kb.stream_of(u))
    kb.check(lib, err, "ns2d_pre")
    (NS2D_PRE if flags is None else NS2D_PRE_FLAGS).launches += 1
    return f, g, rhs


def ns2d_post_plain(u, v, f, g, p, dt, dx, dy, offs=None, gext=None,
                    ragged: bool = False, flags=None):
    """K4's plain version: returns (u'', v'', max|u''|, max|v''|); in the
    distributed mode the gated projection of ops/ns2d.post_gated on the
    shard's halo-1 blocks. `flags` restricts the projection to
    fluid-fluid faces (ops/obstacle.adapt_uv_obstacle)."""
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
              ragged: bool = False, flags=None):
    """K4: projection in place on u and v; returns (umax, vmax) as 0-dim
    tensors on the fields' device. With the shard's global offsets and the
    global extents, the distributed mode on its halo-1 blocks (`ragged`:
    the mesh does not divide the grid, and the dead cells are zeroed); the
    maxima are then the shard's. `flags` (uint8 of u's shape) selects the
    flag mode."""
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
    (NS2D_POST if flags is None else NS2D_POST_FLAGS).launches += 1
    return out[0], out[1]
