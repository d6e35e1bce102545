"""Geometric multigrid for the pressure-Poisson equation, single device,
no obstacles (counterpart of pampi_tpu/ops/multigrid.py:50-643).

Cell-centred grids: coarsening halves every interior extent, restriction
is the mean of each 2^d block of fine residuals (full weighting),
prolongation is piecewise-constant injection. The smoother is red-black
Gauss-Seidel (ω = 1) with the SOR half-sweep arithmetic of ops/sor.py and
ops/sor3d.py (red first in 2-D, odd parity first in 3-D), then the
Neumann ghost copy. The coarsest level is solved exactly by DCT
diagonalisation (ops/dctpoisson.py) as an additive residual correction,
so the iterate's null-space component survives even a single-level plan.
`tpu_solver mg` takes this solver; `it` counts V-cycles.

Two forms of one V-cycle, chosen by `tpu_mg_fused`
(utils/dispatch.resolve_mg_fused):

- the fused cycle: the DOWN kernel (pre-smooth, store, restrict on every
  level), the exact bottom as plain torch, the UP kernel (prolong, add,
  Neumann, post-smooth back to the fine level); ops/mg_fused.py holds the
  wrappers and their plain versions;
- the ladder: the recursive V-cycle op by op, the parity oracle. Levels
  with at least `_KERNEL_SMOOTH_MIN_CELLS` interior cells smooth through
  the red-black kernels K2/K5 at ω = 1 (ops/sor_kernels.py,
  ops/sor3d_kernels.py), as the JAX ladder smooths its large levels
  through the temporal-blocked Pallas kernels; smaller levels keep the
  plain sweeps.

The convergence loop runs on the host, like the SOR loop of
models/poisson.py: after every V-cycle it reads Σr² of the fine level
back, normalises it in the field's dtype, and stops on res < eps², on
it >= itermax, or on a stall (the residual changed by at most
`stall_rtol` relative over one cycle, from the second cycle on; 0
disables the detector). The obstacle and distributed multigrids are not
ported (ROADMAP A item 5, A.8).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..utils import flags as _flags
from ..utils.dispatch import resolve_mg_fused
from ..utils.precision import check_eps_floor
from .dctpoisson import make_poisson_dct
from .sor import checkerboard_mask, interior_residual, neumann_bc
from .sor3d import checkerboard_mask_3d, interior_residual_3d, neumann_faces_3d
from .sor3d_kernels import rb_sor3d_checkerboard
from .sor_kernels import rb_sor_checkerboard


def mg_levels(*extents, min_size: int = 4):
    """Level plan: halve every interior extent while all stay even and at
    least 2·min_size; level 0 is the fine grid."""
    levels = [tuple(extents)]
    while all(d % 2 == 0 and d >= 2 * min_size for d in levels[-1]):
        levels.append(tuple(d // 2 for d in levels[-1]))
    return levels


# The DCT bottom is exact at any size, so a plan stops coarsening at the
# first level that fits this budget (256²): a 100² grid is a single-level
# plan, a 4096² grid stops at 256² (5 levels), 128³ at 32³ (3 levels).
_DCT_BOTTOM_MAX_CELLS = 65536


def _truncate_levels(levels, max_cells, scale: int = 1):
    """Cut the level plan at the first level whose cell count (×scale)
    fits the bottom budget; a plan may be a single level."""
    for idx, ext in enumerate(levels):
        if math.prod(ext) * scale <= max_cells:
            return levels[: idx + 1]
    return levels


# Relative-change stall tolerance of the convergence loop (the .par key
# tpu_mg_stall_rtol): a V-cycle contracts the residual ~10x until it
# floors (an inconsistent Neumann rhs, float32 round-off), so a residual
# that moved by at most this much over one cycle has converged to its
# floor.
MG_STALL_RTOL = 1e-4

# levels with at least this many interior cells smooth through K2/K5 on
# the ladder (the JAX package's _PALLAS_SMOOTH_MIN_CELLS)
_KERNEL_SMOOTH_MIN_CELLS = 512 * 256


def _stalled(prev, res, it, rtol=MG_STALL_RTOL) -> bool:
    """The stall predicate on the host, in the residual's numpy dtype:
    it >= 2 and |prev - res| <= rtol·res; rtol <= 0 never stalls, None
    means MG_STALL_RTOL."""
    if rtol is None:
        rtol = MG_STALL_RTOL
    if rtol <= 0:
        return False
    return it >= 2 and abs(prev - res) <= type(res)(rtol) * res


def _mg_converge_loop(vcycle, inv2, ncells, eps, itermax, dtype,
                      stall_rtol=MG_STALL_RTOL):
    """solve(p, rhs) -> (p, res, it): V-cycles until res < eps², itermax,
    or a stall. res = Σr²/ncells of the fine level after the last cycle,
    in the field's dtype; `it` counts V-cycles."""
    real = np.float32 if dtype == torch.float32 else np.float64
    norm = real(ncells)
    epssq = real(eps * eps)

    def solve(p, rhs):
        res, prev, it = real(1.0), real(np.inf), 0
        while (res >= epssq and it < itermax
               and not _stalled(prev, res, it, stall_rtol)):
            p = vcycle(p, rhs)
            r = _residual(p, rhs, inv2)
            prev, res = res, real(float(torch.sum(r * r))) / norm
            if _flags.debug():
                print(f"{it} Residuum: {float(res)}")  # it = V-cycle
            it += 1
        return p, float(res), it

    return solve


# ----------------------------------------------------------------------
# level operations on extended arrays (ghosts included), 2-D (j+2, i+2)
# and 3-D (k+2, j+2, i+2); inv2 is ordered (idx2, idy2[, idz2])
# ----------------------------------------------------------------------


def _inner(a):
    """The interior view of an extended array."""
    return a[(slice(1, -1),) * a.dim()]


def _residual(p, rhs, inv2):
    if p.dim() == 2:
        return interior_residual(p, rhs, *inv2)
    return interior_residual_3d(p, rhs, *inv2)


def _neumann(p):
    return neumann_bc(p) if p.dim() == 2 else neumann_faces_3d(p)


def _parities(nd: int):
    """Half-sweep order: red (parity 0) first in 2-D, odd first in 3-D."""
    return (0, 1) if nd == 2 else (1, 0)


def _masks(extents, parities, dtype, device):
    """The interior checkerboard masks of a level, in sweep order."""
    mask = checkerboard_mask if len(extents) == 2 else checkerboard_mask_3d
    return [mask(*extents, par, dtype, device) for par in parities]


def _smooth(p, rhs, masks, factor, inv2, n):
    """n red-black ω = 1 sweeps in place on p, each half-sweep the SOR
    pass arithmetic (r = rhs - lap(p) masked, p -= factor·r), then the
    Neumann copy."""
    for _ in range(n):
        for m in masks:
            r = _residual(p, rhs, inv2) * m
            _inner(p).sub_(factor * r)
        _neumann(p)
    return p


def _restrict(r):
    """Full weighting: each coarse cell is the mean of its 2^d fine
    residuals, summed in one fixed order (lexicographic over the block, i
    fastest) and then divided, as the DOWN kernel sums them."""
    total = None
    for off in itertools.product((0, 1), repeat=r.dim()):
        t = r[tuple(slice(o, None, 2) for o in off)]
        total = t if total is None else total + t
    return total / float(2 ** r.dim())


def _prolong(e):
    """Piecewise-constant injection: each coarse cell covers its 2^d fine
    block."""
    for d in range(e.dim()):
        e = e.repeat_interleave(2, dim=d)
    return e


def _embed(interior):
    """interior with a zero ghost ring."""
    out = interior.new_zeros(tuple(n + 2 for n in interior.shape))
    _inner(out).copy_(interior)
    return out


def level_config(levels, spacings):
    """Per-level (inv2, factor, spacings) of a plan, formed in double as
    the JAX package forms them: spacing·2^lvl, inv2 = 1/h² ordered (idx2,
    idy2[, idz2]), and the ω = 1 factor. spacings = (dx, dy[, dz])."""
    out = []
    for lvl in range(len(levels)):
        sp = [s * (2 ** lvl) for s in spacings]
        sq = [s * s for s in sp]
        inv2 = tuple(1.0 / q for q in sq)
        if len(sq) == 2:
            factor = 0.5 * (sq[0] * sq[1]) / (sq[0] + sq[1])
        else:
            factor = 0.5 * (sq[0] * sq[1] * sq[2]) / (
                sq[1] * sq[2] + sq[0] * sq[2] + sq[0] * sq[1])
        out.append((inv2, factor, tuple(sp)))
    return out


def _make_vcycle(extents, spacings, dtype, n_pre, n_post, fused, device,
                 key):
    """vcycle(p, rhs) -> p on the fine extended grid; extents (jmax, imax)
    or (kmax, jmax, imax), spacings (dx, dy[, dz])."""
    levels = _truncate_levels(mg_levels(*extents), _DCT_BOTTOM_MAX_CELLS)
    use_fused = resolve_mg_fused(fused, levels, key)
    cfg = level_config(levels, spacings)
    bottom_dct = make_poisson_dct(levels[-1], tuple(reversed(cfg[-1][2])),
                                  dtype, device)

    def bottom(p, rhs):
        # exact additive bottom: p += the zero-mean DCT solution of its
        # residual equation (p = 0 below a multi-level plan)
        r = _residual(p, rhs, cfg[-1][0])
        _inner(p).add_(bottom_dct(r))
        return _neumann(p)

    if use_fused:
        from . import mg_fused as mf

        plan = mf.make_cycle_plan(levels, spacings, n_pre, n_post)

        def vcycle_fused(p, rhs):
            pstk, rstk = mf.mg_down(plan, p, rhs)
            rb = rstk[-1]
            pbot = bottom(torch.zeros_like(rb), rb)
            return mf.mg_up(plan, pstk, rstk, pbot)

        return vcycle_fused

    three_d = len(extents) == 3
    kernel = rb_sor3d_checkerboard if three_d else rb_sor_checkerboard
    masks = [_masks(ext, _parities(len(ext)), dtype, device)
             for ext in levels]
    big = [math.prod(ext) >= _KERNEL_SMOOTH_MIN_CELLS for ext in levels]

    def smooth(p, rhs, lvl, n):
        inv2, factor, _sp = cfg[lvl]
        if n and big[lvl]:
            kernel(p, rhs, n, factor, *inv2)
        else:
            _smooth(p, rhs, masks[lvl], factor, inv2, n)

    def vcycle(p, rhs, lvl=0):
        if lvl == len(levels) - 1:
            return bottom(p, rhs)
        smooth(p, rhs, lvl, n_pre)
        r2 = _restrict(_residual(p, rhs, cfg[lvl][0]))
        e2 = vcycle(_embed(torch.zeros_like(r2)), _embed(r2), lvl + 1)
        _inner(p).add_(_prolong(_inner(e2)))
        _neumann(p)
        smooth(p, rhs, lvl, n_post)
        return p

    def vcycle_ladder(p, rhs):
        # the ladder works in place: a copy keeps the caller's p intact
        return vcycle(p.clone(), rhs.contiguous())

    return vcycle_ladder


def make_mg_vcycle_2d(imax, jmax, dx, dy, dtype, n_pre: int = 2,
                      n_post: int = 2, *, fused: str, device):
    """Build vcycle(p_ext, rhs_ext) -> p_ext on the (jmax+2, imax+2)
    grid; `fused` is the tpu_mg_fused knob (recorded under
    "mg2d_fused"), `device` where the masks and the bottom's DCT matrices
    are built."""
    return _make_vcycle((jmax, imax), (dx, dy), dtype, n_pre, n_post, fused,
                        device, "mg2d_fused")


def make_mg_vcycle_3d(imax, jmax, kmax, dx, dy, dz, dtype, n_pre: int = 2,
                      n_post: int = 2, *, fused: str, device):
    """The 3-D twin of make_mg_vcycle_2d (recorded under "mg3d_fused")."""
    return _make_vcycle((kmax, jmax, imax), (dx, dy, dz), dtype, n_pre,
                        n_post, fused, device, "mg3d_fused")


def make_mg_solve_2d(imax, jmax, dx, dy, eps, itermax, dtype,
                     n_pre: int = 2, n_post: int = 2,
                     stall_rtol=MG_STALL_RTOL, *, fused: str, device):
    """The solve contract (p, rhs) -> (p, res, it) with V-cycles:
    res = Σr²/(imax·jmax) after the last cycle, `it` the cycle count; the
    loop also stops on a stall (`stall_rtol`, 0 disables)."""
    check_eps_floor(eps, imax * jmax, dtype, f"mg2d {imax}x{jmax}")
    vcycle = make_mg_vcycle_2d(imax, jmax, dx, dy, dtype, n_pre, n_post,
                               fused=fused, device=device)
    inv2 = (1.0 / (dx * dx), 1.0 / (dy * dy))
    return _mg_converge_loop(vcycle, inv2, imax * jmax, eps, itermax, dtype,
                             stall_rtol)


def make_mg_solve_3d(imax, jmax, kmax, dx, dy, dz, eps, itermax, dtype,
                     n_pre: int = 2, n_post: int = 2,
                     stall_rtol=MG_STALL_RTOL, *, fused: str, device):
    """The 3-D twin of make_mg_solve_2d."""
    check_eps_floor(eps, imax * jmax * kmax, dtype,
                    f"mg3d {imax}x{jmax}x{kmax}")
    vcycle = make_mg_vcycle_3d(imax, jmax, kmax, dx, dy, dz, dtype, n_pre,
                               n_post, fused=fused, device=device)
    inv2 = (1.0 / (dx * dx), 1.0 / (dy * dy), 1.0 / (dz * dz))
    return _mg_converge_loop(vcycle, inv2, imax * jmax * kmax, eps, itermax,
                             dtype, stall_rtol)
