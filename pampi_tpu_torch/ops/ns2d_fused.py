"""Kernels K3 and K4: the NS-2D step phases around the pressure solve on
the H100, each beside its plain PyTorch version (sources:
pampi_tpu_torch/csrc/ns2d_fused.cu). Single device, no obstacles.

K3 `ns2d_pre` replaces pampi_tpu/ops/ns2d_fused.py `_pre_kernel`
  (make_fused_pre_2d, pallas_call at :775): (u, v, dt) -> (u', v', F, G,
  rhs) = wall BCs -> dcavity lid / canal inflow -> F/G predictor + wall
  fixups -> RHS. u and v are updated in place.
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

For a CPU tensor each wrapper runs its plain version (ops/ns2d.py); for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from . import ns2d as ops

SOURCE = "pampi_tpu_torch/csrc/ns2d_fused.cu"
NS2D_PRE = kb.register(
    "ns2d_pre", SOURCE, "pampi_tpu/ops/ns2d_fused.py:775")
NS2D_POST = kb.register(
    "ns2d_post", SOURCE, "pampi_tpu/ops/ns2d_fused.py:877")

_PROBLEM_CODE = {"dcavity": 1, "canal": 2}
_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PRE_ARGS = [_I, _V, _V, _V, _V, _V, _V, _I, _I, _V, _I, _V, _V]
_POST_ARGS = [_I, _V, _V, _V, _V, _V, _V, _I, _I, _D, _D, _V, _V, _V]
_SIGNATURES = {
    "ns2d_pre_f32": _PRE_ARGS, "ns2d_pre_f64": _PRE_ARGS,
    "ns2d_post_f32": _POST_ARGS, "ns2d_post_f64": _POST_ARGS,
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


def _check(tensors, dt) -> None:
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"NS-2D kernels take CPU or CUDA tensors, not {t0.device}")
    if t0.dtype not in _SUFFIX:
        raise ValueError(f"NS-2D kernels take float32 or float64, not {t0.dtype}")
    if t0.dim() != 2:
        raise ValueError(f"fields must be 2-D, got {tuple(t0.shape)}")
    for t in tensors:
        if (t.device != t0.device or t.dtype != t0.dtype
                or t.shape != t0.shape or not t.is_contiguous()):
            raise ValueError("fields must be contiguous and share device, "
                             "dtype and shape")
    if dt.device != t0.device or dt.dtype != t0.dtype or dt.numel() != 1:
        raise ValueError("dt must be a one-element tensor beside the fields")


def _lib():
    return kb.load("ns2d_fused", _SIGNATURES)


def ns2d_pre_plain(u, v, dt, cfg: StepConfig):
    """K3's plain version: returns (u', v', F, G, rhs), inputs untouched."""
    u1, v1 = ops.set_boundary_conditions(u, v, *cfg.bc)
    u1 = ops.set_special_bc(u1, cfg.problem, cfg.dy, cfg.ylength)
    f, g = ops.compute_fg(u1, v1, dt, cfg.re, cfg.gx, cfg.gy, cfg.gamma,
                          cfg.dx, cfg.dy)
    rhs = ops.compute_rhs(f, g, dt, cfg.dx, cfg.dy)
    return u1, v1, f, g, rhs


def ns2d_pre(u, v, dt, cfg: StepConfig):
    """K3: boundary conditions in place on u and v; returns (F, G, rhs).
    dt is a 0-dim tensor beside the fields."""
    if u.device.type == "cpu":
        u1, v1, f, g, rhs = ns2d_pre_plain(u, v, dt, cfg)
        u.copy_(u1)
        v.copy_(v1)
        return f, g, rhs
    _check((u, v), dt)
    f, g, rhs = (torch.empty_like(u) for _ in range(3))
    jmax, imax = u.shape[0] - 2, u.shape[1] - 2
    bc = (ctypes.c_int * 4)(*cfg.bc)
    coef = (ctypes.c_double * 13)(*cfg.coefficients())
    lib = _lib()
    err = getattr(lib, f"ns2d_pre_{_SUFFIX[u.dtype]}")(
        u.device.index, u.data_ptr(), v.data_ptr(), dt.data_ptr(),
        f.data_ptr(), g.data_ptr(), rhs.data_ptr(), jmax, imax, bc,
        _PROBLEM_CODE.get(cfg.problem, 0), coef, kb.stream_of(u))
    kb.check(lib, err, "ns2d_pre")
    NS2D_PRE.launches += 1
    return f, g, rhs


def ns2d_post_plain(u, v, f, g, p, dt, dx, dy):
    """K4's plain version: returns (u'', v'', max|u''|, max|v''|)."""
    u2, v2 = ops.adapt_uv(u, v, f, g, p, dt, dx, dy)
    return u2, v2, ops.max_element(u2), ops.max_element(v2)


def ns2d_post(u, v, f, g, p, dt, dx, dy):
    """K4: projection in place on u and v; returns (umax, vmax) as 0-dim
    tensors on the fields' device."""
    if u.device.type == "cpu":
        u2, v2, umax, vmax = ns2d_post_plain(u, v, f, g, p, dt, dx, dy)
        u.copy_(u2)
        v.copy_(v2)
        return umax, vmax
    _check((u, v, f, g, p), dt)
    jmax, imax = u.shape[0] - 2, u.shape[1] - 2
    lib = _lib()
    partial = torch.empty(lib.ns2d_post_partials(jmax, imax), dtype=u.dtype,
                          device=u.device)
    out = torch.empty(2, dtype=u.dtype, device=u.device)
    err = getattr(lib, f"ns2d_post_{_SUFFIX[u.dtype]}")(
        u.device.index, u.data_ptr(), v.data_ptr(), f.data_ptr(),
        g.data_ptr(), p.data_ptr(), dt.data_ptr(), jmax, imax, dx, dy,
        partial.data_ptr(), out.data_ptr(), kb.stream_of(u))
    kb.check(lib, err, "ns2d_post")
    NS2D_POST.launches += 1
    return out[0], out[1]
