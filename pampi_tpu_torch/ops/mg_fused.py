"""Kernels K9-K12: the fused multigrid V-cycle's DOWN and UP halves on the
H100, each beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/mg_cycle.cu).

K9  `mg_down_2d`, K11 `mg_down_3d` replace pampi_tpu/ops/mg_fused.py
    `_down_body` (make_cycle_kernels, pallas_call at :397): for each level
    0..L-2, n_pre ω = 1 red-black sweeps (each followed by the Neumann
    copy), store p and rhs, and restrict the residual to the next level's
    rhs (mean of 2^d fine residuals, zero ghost ring); the next level's p
    starts at 0. Level L-1 holds p = 0 and the coarsest rhs.
K10 `mg_up_2d`, K12 `mg_up_3d` replace `_up_body` (pallas_call at :409):
    for each level L-2..0, the stored p plus the piecewise-constant
    prolongation of the coarser correction on the interior, the Neumann
    copy, and n_post sweeps; returns the fine p.

The exact bottom solve runs between them as plain torch
(ops/multigrid.py), as in the JAX package. Both halves are op for op the
ladder of ops/multigrid.py (parity order red first in 2-D, odd first in
3-D; inv2 ordered [idx2, idy2(, idz2)] and the ω = 1 factor per level, as
make_cycle_kernels lays out its geometry rows).

The TPU keeps every level on one padded plane (Mosaic needs static
shapes). Here each level is its own compact (jl+2, il+2)[, kl+2] tensor:
the wrappers take and return lists of level tensors, finest first. Both
halves are pure: DOWN returns new tensors (its rhs list starts with the
given rhs itself), UP writes new tensors and leaves the stacks alone.

One wrapper call is one ctypes call, which issues the CUDA launches the
ordering needs (see the source note): 7(L-1) for DOWN and for UP at
n_pre = n_post = 2. For a CPU tensor each wrapper runs its plain version;
for a CUDA tensor it launches its kernels or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from .multigrid import (
    _embed,
    _inner,
    _masks,
    _neumann,
    _parities,
    _prolong,
    _residual,
    _restrict,
    _smooth,
    level_config,
)

SOURCE = "pampi_tpu_torch/csrc/mg_cycle.cu"
_DOWN = "pampi_tpu/ops/mg_fused.py:397"
_UP = "pampi_tpu/ops/mg_fused.py:409"
MG_DOWN_2D = kb.register("mg_down_2d", SOURCE, _DOWN)
MG_UP_2D = kb.register("mg_up_2d", SOURCE, _UP)
MG_DOWN_3D = kb.register("mg_down_3d", SOURCE, _DOWN)
MG_UP_3D = kb.register("mg_up_3d", SOURCE, _UP)
_KERNELS = {("down", 2): MG_DOWN_2D, ("up", 2): MG_UP_2D,
            ("down", 3): MG_DOWN_3D, ("up", 3): MG_UP_3D}

_V, _I = ctypes.c_void_p, ctypes.c_int
_PV = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_PD = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {}
for _nd in (2, 3):
    for _t in ("f32", "f64"):
        # dev, p, rhs, pstk, rstk, ext, coef, L, n_pre, stream
        _SIGNATURES[f"mg_down_{_nd}d_{_t}"] = [_I, _V, _V, _PV, _PV, _PI, _PD,
                                               _I, _I, _V]
        # dev, pstk, rstk, pbot, out, ext, coef, L, n_post, stream
        _SIGNATURES[f"mg_up_{_nd}d_{_t}"] = [_I, _PV, _PV, _V, _PV, _PI, _PD,
                                             _I, _I, _V]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclass(frozen=True)
class CyclePlan:
    """A static level plan and its per-level coefficients: levels finest
    first ((jl, il) or (kl, jl, il)), inv2 per level ordered (idx2,
    idy2[, idz2]), the ω = 1 factor per level, the half-sweep parities,
    and the sweep counts."""

    levels: tuple
    inv2: tuple
    factor: tuple
    parities: tuple
    n_pre: int
    n_post: int

    @property
    def nd(self) -> int:
        return len(self.levels[0])

    def shape(self, lvl: int) -> tuple:
        return tuple(n + 2 for n in self.levels[lvl])


def make_cycle_plan(levels, spacings, n_pre: int = 2, n_post: int = 2):
    """The plan of make_cycle_kernels (pampi_tpu/ops/mg_fused.py:361-373)
    for levels finest first and spacings (dx, dy[, dz]). The plan must
    have at least two levels, every coarser level exactly half of an even
    finer one, and n_pre, n_post >= 1."""
    levels = tuple(tuple(int(n) for n in ext) for ext in levels)
    if len(levels) < 2:
        raise ValueError("the fused cycle needs a plan of at least 2 levels")
    for fine, coarse in zip(levels, levels[1:]):
        if any(f % 2 or c * 2 != f for f, c in zip(fine, coarse)):
            raise ValueError(f"level {coarse} is not half of level {fine}")
    if n_pre < 1 or n_post < 1:
        raise ValueError(f"n_pre and n_post must be >= 1, got {n_pre}, "
                         f"{n_post}")
    cfg = level_config(levels, spacings)
    return CyclePlan(levels, tuple(c[0] for c in cfg),
                     tuple(c[1] for c in cfg), _parities(len(levels[0])),
                     n_pre, n_post)


def _level_masks(plan: CyclePlan, lvl: int, like):
    return _masks(plan.levels[lvl], plan.parities, like.dtype, like.device)


def mg_down_plain(plan: CyclePlan, p, rhs):
    """DOWN's plain version: (pstk, rstk), lists of L level tensors."""
    L = len(plan.levels)
    pstk, rstk = [], [rhs]
    p = p.clone()
    for lvl in range(L - 1):
        _smooth(p, rstk[lvl], _level_masks(plan, lvl, p),
                plan.factor[lvl], plan.inv2[lvl], plan.n_pre)
        pstk.append(p)
        rc = _embed(_restrict(_residual(p, rstk[lvl], plan.inv2[lvl])))
        rstk.append(rc)
        p = torch.zeros_like(rc)
    pstk.append(p)
    return pstk, rstk


def mg_up_plain(plan: CyclePlan, pstk, rstk, pbot):
    """UP's plain version: the fine p (a new tensor)."""
    e = pbot
    for lvl in reversed(range(len(plan.levels) - 1)):
        p = pstk[lvl].clone()
        _inner(p).add_(_prolong(_inner(e)))
        _neumann(p)
        _smooth(p, rstk[lvl], _level_masks(plan, lvl, p),
                plan.factor[lvl], plan.inv2[lvl], plan.n_post)
        e = p
    return e


def _check(tensors, shapes):
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"MG cycle kernels take CPU or CUDA tensors, not {dev}")
    if dtype not in _SUFFIX:
        raise ValueError(f"MG cycle kernels take float32 or float64, not {dtype}")
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != dtype:
            raise ValueError("every level tensor must share device and dtype")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"level tensor {tuple(t.shape)} must be a "
                             f"contiguous {shape}")


def _call(plan: CyclePlan, kind: str, like, ptrs):
    """One ctypes call of DOWN or UP on like's device and stream: ptrs
    are the entry point's tensor arguments, the plan's extents and
    coefficients follow."""
    nd, L = plan.nd, len(plan.levels)
    ext = (ctypes.c_int * (L * nd))(*[n for e in plan.levels for n in e])
    coef = (ctypes.c_double * (L * (nd + 1)))(
        *[c for inv2, f in zip(plan.inv2, plan.factor) for c in (*inv2, f)])
    n = plan.n_pre if kind == "down" else plan.n_post
    lib = kb.load("mg_cycle", _SIGNATURES)
    entry = f"mg_{kind}_{nd}d"
    err = getattr(lib, f"{entry}_{_SUFFIX[like.dtype]}")(
        like.device.index, *ptrs, ext, coef, L, n, kb.stream_of(like))
    kb.check(lib, err, entry)
    _KERNELS[(kind, nd)].launches += 1


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _empty_levels(plan, like, lvls):
    return [torch.empty(plan.shape(lvl), dtype=like.dtype, device=like.device)
            for lvl in lvls]


def mg_down(plan: CyclePlan, p, rhs):
    """K9 (2-D) / K11 (3-D): DOWN on the fine p and rhs. Returns (pstk,
    rstk), L level tensors each; rstk[0] is rhs itself."""
    if p.device.type == "cpu":
        return mg_down_plain(plan, p, rhs)
    _check((p, rhs), (plan.shape(0),) * 2)
    L = len(plan.levels)
    pstk = _empty_levels(plan, p, range(L))
    rstk = [rhs] + _empty_levels(plan, p, range(1, L))
    _call(plan, "down", p,
          (p.data_ptr(), rhs.data_ptr(), _ptrs(pstk), _ptrs(rstk)))
    return pstk, rstk


def mg_up(plan: CyclePlan, pstk, rstk, pbot):
    """K10 (2-D) / K12 (3-D): UP from the bottom correction pbot through
    the stacks of DOWN. Returns the fine p (a new tensor)."""
    if pbot.device.type == "cpu":
        return mg_up_plain(plan, pstk, rstk, pbot)
    L = len(plan.levels)
    _check([pbot, *pstk, *rstk],
           [plan.shape(L - 1)] + [plan.shape(lvl) for lvl in range(L)] * 2)
    out = _empty_levels(plan, pbot, range(L - 1))
    _call(plan, "up", pbot,
          (_ptrs(pstk), _ptrs(rstk), pbot.data_ptr(), _ptrs(out)))
    return out[0]
