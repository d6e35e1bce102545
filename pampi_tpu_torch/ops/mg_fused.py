"""Kernels K9-K12: the fused multigrid V-cycle's DOWN and UP halves on the
H100, each beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/mg_cycle.cu); and K18, the fleet's one-launch class
V-cycle (below).

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

K18 `mg_class_cycle_2d` (source: pampi_tpu_torch/csrc/mg_class_cycle.cu)
replaces `_class_cycle_body` (make_class_cycle_2d, pallas_call at :549),
the fleet's shape-class mg lane: the whole 2-D V-cycle of every lane of a
class batch in ONE launch (a CTA per lane), each lane's level plan
(`class_level_plan`, from its live extents) arriving as data, with an
in-kernel smoothed bottom (n_bottom extra sweeps at the deepest live
level) in place of a direct solve. `class_cycle` is its wrapper,
`class_cycle_plain` its plain version, which repeats the kernel's
fixed-order residual sum, so the two agree bitwise.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
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
from .sor import checkerboard_mask, interior_residual, neumann_bc
from .sor_kernels import fixed_order_sum

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


# ----------------------------------------------------------------------
# K18: the shape-class lane's whole V-cycle in one launch
# ----------------------------------------------------------------------

CLASS_SOURCE = "pampi_tpu_torch/csrc/mg_class_cycle.cu"
MG_CLASS_CYCLE_2D = kb.register("mg_class_cycle_2d", CLASS_SOURCE,
                                "pampi_tpu/ops/mg_fused.py:549")
CLASS_THREADS = 256  # K18's CTA per lane: the residual sum's order
CLASS_MAX_LEVELS = 16  # the kernel's level table
# the TPU class cycle's sweep counts (make_class_cycle_2d's defaults)
N_PRE = N_POST = 2
N_BOTTOM = 8
_CLASS_SIGNATURES = {
    # dev, p, rhs, out, ext, geo, active, work, rsq, lanes, jc, ic, lmax,
    # lane_work, n_pre, n_post, n_bottom, stream
    f"mg_class_cycle_2d_{t}": [_I, _V, _V, _V, _V, _V, _V, _V, _V, _I, _I,
                               _I, _I, ctypes.c_longlong, _I, _I, _I, _V]
    for t in ("f32", "f64")
}
_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def class_level_max(jmax_c: int, imax_c: int) -> int:
    """The unroll depth of a (jmax_c, imax_c) class (the JAX package's
    class_level_max): an extent e yields at most floor(log2(e)) - 1
    levels (mg_levels' min_size 4)."""
    return max(1, int(math.floor(math.log2(max(8, min(jmax_c, imax_c)))))
               - 1)


def class_level_plan(jl: int, il: int, idx2: float, idy2: float, lmax: int,
                     dtype, min_size: int = 4):
    """The mg_levels rule over one lane's live extents, as the JAX
    package's class_level_plan computes it: level l+1 is live while level
    l's extents are even and >= 2·min_size. idx2 and idy2 are cast to the
    lane dtype first, then divided by 4^l in that dtype; the ω = 1 factor
    0.5/(i2 + j2) is formed in that dtype too. Returns (ext, geo): CPU
    tensors (lmax, 3) int32 of rows [jl, il, live] and (lmax, 3) `dtype`
    of rows [idx2, idy2, factor]."""
    real = _REAL[dtype]
    i2_0, j2_0 = real(idx2), real(idy2)
    jl, il, live = int(jl), int(il), 1
    ext = np.zeros((lmax, 3), np.int32)
    geo = np.zeros((lmax, 3), real)
    for lvl in range(lmax):
        scale = real(4.0 ** lvl)
        i2, j2 = i2_0 / scale, j2_0 / scale
        ext[lvl] = (jl, il, live)
        geo[lvl] = (i2, j2, real(0.5) / (i2 + j2))
        can = (jl % 2 == 0 and il % 2 == 0 and jl >= 2 * min_size
               and il >= 2 * min_size)
        live = live * int(can)
        jl, il = jl // 2, il // 2
    return torch.from_numpy(ext), torch.from_numpy(geo)


def class_work_cells(jc: int, ic: int, lmax: int) -> int:
    """Per-lane scratch of K18, in elements: p and rhs of every level
    l = 1..lmax-1 at its compact storage ((jc>>l)+2) x ((ic>>l)+2)."""
    return sum(2 * ((jc >> lvl) + 2) * ((ic >> lvl) + 2)
               for lvl in range(1, lmax))


def _live_levels(ext_rows):
    """[(jl, il), ...] of a lane's live levels, finest first."""
    out = []
    for lvl, (jl, il, live) in enumerate(ext_rows):
        if lvl and not live:
            break
        out.append((int(jl), int(il)))
    return out


def _class_smooth(p, rhs, masks, coef, n):
    """n red-black ω = 1 sweeps in place on a level's (jl+2, il+2) p: the
    colour's cells take p - factor·(rhs - lap), every other cell is left
    as it is (the TPU kernel's where-select), then the Neumann copy."""
    idx2, idy2, factor = coef
    for _ in range(n):
        for m in masks:
            inner = p[1:-1, 1:-1]
            r = interior_residual(p, rhs, idx2, idy2)
            inner.copy_(torch.where(m, inner - factor * r, inner))
        neumann_bc(p)


def _class_lane_plain(p, rhs, ext_rows, geo, n_pre, n_post, n_bottom):
    """One active lane of class_cycle_plain, in place on p (the lane's
    class block); returns its Σr²."""
    levels = _live_levels(ext_rows)
    L = len(levels)
    coef = [tuple(geo[lvl, k] for k in range(3)) for lvl in range(L)]
    masks = [[checkerboard_mask(jl, il, par, torch.float32, p.device) > 0
              for par in (0, 1)] for jl, il in levels]
    jl, il = levels[0]
    P = [p[:jl + 2, :il + 2]] + [None] * (L - 1)
    R = [rhs[:jl + 2, :il + 2]] + [None] * (L - 1)
    for lvl in range(L):
        _class_smooth(P[lvl], R[lvl], masks[lvl], coef[lvl], n_pre)
        if lvl + 1 < L:
            r = interior_residual(P[lvl], R[lvl], *coef[lvl][:2])
            R[lvl + 1] = _embed(_restrict(r))
            P[lvl + 1] = torch.zeros_like(R[lvl + 1])
    for lvl in reversed(range(L)):
        if lvl + 1 < L:
            f = torch.zeros_like(P[lvl])
            _inner(f).copy_(_prolong(_inner(P[lvl + 1])))
            P[lvl].add_(f)
            neumann_bc(P[lvl])
        else:
            # the TPU kernel adds a masked 0.0 at the deepest level: -0.0
            # becomes +0.0, every other value is unchanged
            P[lvl].copy_(torch.where(P[lvl] == 0, torch.zeros_like(P[lvl]),
                                     P[lvl]))
            _class_smooth(P[lvl], R[lvl], masks[lvl], coef[lvl], n_bottom)
        _class_smooth(P[lvl], R[lvl], masks[lvl], coef[lvl], n_post)
    r = interior_residual(P[0], R[0], *coef[0][:2])
    return fixed_order_sum((r * r).reshape(-1), CLASS_THREADS)


def class_cycle_plain(p, rhs, ext, geo, active, n_pre: int = N_PRE,
                      n_post: int = N_POST, n_bottom: int = N_BOTTOM):
    """K18's plain version: (p', rsq) for lane-stacked p, rhs (N, jc+2,
    ic+2), ext (N, lmax, 3) int32, geo (N, lmax, 3) and active (N,). Each
    active lane runs the TPU kernel's cycle on its live corner, level by
    level on compact (jl+2, il+2) arrays: n_pre sweeps and the restriction
    down the live levels, at the deepest one p + 0 and n_bottom sweeps,
    then back up the prolongation add, the Neumann copy and n_post sweeps;
    rsq is the fine Σr² in the kernel's fixed order. An inactive lane
    keeps p and returns rsq 0; cells outside a lane's live corner keep
    their values. p is not modified."""
    out = p.clone()
    rsq = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    ext_rows = ext.tolist()
    for lane, on in enumerate(torch.as_tensor(active).tolist()):
        if on:
            rsq[lane] = _class_lane_plain(out[lane], rhs[lane],
                                          ext_rows[lane], geo[lane],
                                          n_pre, n_post, n_bottom)
    return out, rsq


def class_cycle_library():
    """K18's bound library, built at first use."""
    return kb.load("mg_class_cycle", _CLASS_SIGNATURES)


def _check_class(p, rhs, ext, geo, active):
    """Refuse what K18 (and so its plain version) does not take; returns
    (N, jc, ic, lmax)."""
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K18 takes CPU or CUDA tensors, not {p.device}")
    if p.dtype not in _SUFFIX:
        raise ValueError(f"K18 takes float32 or float64, not {p.dtype}")
    if p.dim() != 3:
        raise ValueError(f"K18 takes lane-stacked (N, jc+2, ic+2) planes, "
                         f"got {tuple(p.shape)}")
    n, jc, ic = p.shape[0], p.shape[1] - 2, p.shape[2] - 2
    lmax = class_level_max(jc, ic)
    want = ((rhs, p.dtype, tuple(p.shape), "rhs"),
            (ext, torch.int32, (n, lmax, 3), "ext"),
            (geo, p.dtype, (n, lmax, 3), "geo"),
            (active, torch.int32, (n,), "active"))
    for t, dtype, shape, name in want:
        if t.device != p.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {p.device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for t in (p, rhs, ext, geo, active):
        if not t.is_contiguous():
            raise ValueError("K18's tensors must be contiguous")
    if lmax > CLASS_MAX_LEVELS:
        raise ValueError(f"a {jc}x{ic} class needs {lmax} levels; K18 "
                         f"holds {CLASS_MAX_LEVELS}")
    return n, jc, ic, lmax


def class_cycle(p, rhs, ext, geo, active, work=None, n_pre: int = N_PRE,
                n_post: int = N_POST, n_bottom: int = N_BOTTOM):
    """K18: one V-cycle of every lane, (p', rsq). p, rhs: (N, jc+2, ic+2)
    class blocks; ext, geo: the lanes' stacked class_level_plan rows
    (lmax = class_level_max(jc, ic)); active (N,) int32, 0 passes the
    lane through with rsq 0. The caller guarantees every lane's extents
    fit the class (ClassSolver.lane_state refuses a lane that does not).
    `work` is the scratch of the coarse levels (N·class_work_cells
    elements of p's dtype), allocated here when not given. Shapes and
    dtypes are checked on either device; then for CPU tensors the plain
    version runs, for CUDA tensors one launch, or a raise. p is not
    modified."""
    n, jc, ic, lmax = _check_class(p, rhs, ext, geo, active)
    if p.device.type == "cpu":
        return class_cycle_plain(p, rhs, ext, geo, active, n_pre, n_post,
                                 n_bottom)
    lane_work = class_work_cells(jc, ic, lmax)
    if work is None:
        work = torch.empty(max(1, n * lane_work), dtype=p.dtype,
                           device=p.device)
    elif (work.device != p.device or work.dtype != p.dtype
          or work.numel() < n * lane_work):
        raise ValueError(f"work must hold {n * lane_work} {p.dtype} on "
                         f"{p.device}")
    out = torch.empty_like(p)
    rsq = torch.empty(n, dtype=p.dtype, device=p.device)
    lib = class_cycle_library()
    entry = "mg_class_cycle_2d"
    err = getattr(lib, f"{entry}_{_SUFFIX[p.dtype]}")(
        p.device.index, p.data_ptr(), rhs.data_ptr(), out.data_ptr(),
        ext.data_ptr(), geo.data_ptr(), active.data_ptr(), work.data_ptr(),
        rsq.data_ptr(), n, jc, ic, lmax, lane_work, n_pre, n_post, n_bottom,
        kb.stream_of(p))
    kb.check(lib, err, entry)
    MG_CLASS_CYCLE_2D.launches += 1
    return out, rsq
