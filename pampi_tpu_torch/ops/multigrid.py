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
disables the detector). The obstacle multigrid on one device (below,
make_obstacle_mg_solve_2d/3d) normalises by the fluid cells and runs the
masked mode of the fused-cycle kernels; the distributed multigrids, the
obstacle one included, are not ported (ROADMAP A.8, item 6.4).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..utils import flags as _flags
from ..utils.dispatch import record, resolve_mg_fused
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


def _mg_converge_loop(vcycle, residual_of, norm, eps, itermax, dtype,
                      stall_rtol=MG_STALL_RTOL):
    """solve(p, rhs) -> (p, res, it): V-cycles until res < eps², itermax,
    or a stall. `residual_of(p, rhs)` is the fine level's interior
    residual; res = Σr²/norm after the last cycle, in the field's dtype
    (norm: the cell count, or the fluid cell count of an obstacle grid);
    `it` counts V-cycles."""
    real = np.float32 if dtype == torch.float32 else np.float64
    norm = real(norm)
    epssq = real(eps * eps)

    def solve(p, rhs):
        res, prev, it = real(1.0), real(np.inf), 0
        while (res >= epssq and it < itermax
               and not _stalled(prev, res, it, stall_rtol)):
            p = vcycle(p, rhs)
            r = residual_of(p, rhs)
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


def _shifted(nd: int, ax: int, off: int):
    """The interior window moved by off (+1 or -1) along axis ax."""
    return tuple((slice(2, None) if off > 0 else slice(None, -2)) if d == ax
                 else slice(1, -1) for d in range(nd))


def _obstacle_residual(p, rhs, fl, inv2):
    """(rhs - lap_obs(p))·fl on the interior: the flag-masked obstacle
    stencil of an extended level array, fl the level's 0/1 flags in p's
    dtype (ghosts fluid), each direction's coefficient fl(±)·fl, the terms
    summed x first, as _lap_obstacle and obstacle_residual form them."""
    nd = p.dim()
    c, f0 = _inner(p), _inner(fl)
    lap = None
    for k, w in enumerate(inv2):
        ax = nd - 1 - k
        hi, lo = _shifted(nd, ax, 1), _shifted(nd, ax, -1)
        t = (fl[hi] * f0 * (p[hi] - c) + fl[lo] * f0 * (p[lo] - c)) * w
        lap = t if lap is None else lap + t
    return (_inner(rhs) - lap) * f0


def _obstacle_smooth(p, rhs, fl, fac, masks, inv2, n):
    """n red-black ω = 1 sweeps of the obstacle operator in place on p
    (sor_pass_obstacle's arithmetic: r = residual·colour, p -= fac·r with
    fac the interior's per-cell factor), each followed by the Neumann
    copy."""
    for _ in range(n):
        for m in masks:
            r = _obstacle_residual(p, rhs, fl, inv2) * m
            _inner(p).sub_(fac * r)
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
    return _mg_converge_loop(vcycle, lambda p, rhs: _residual(p, rhs, inv2),
                             imax * jmax, eps, itermax, dtype, stall_rtol)


def make_mg_solve_3d(imax, jmax, kmax, dx, dy, dz, eps, itermax, dtype,
                     n_pre: int = 2, n_post: int = 2,
                     stall_rtol=MG_STALL_RTOL, *, fused: str, device):
    """The 3-D twin of make_mg_solve_2d."""
    check_eps_floor(eps, imax * jmax * kmax, dtype,
                    f"mg3d {imax}x{jmax}x{kmax}")
    vcycle = make_mg_vcycle_3d(imax, jmax, kmax, dx, dy, dz, dtype, n_pre,
                               n_post, fused=fused, device=device)
    inv2 = (1.0 / (dx * dx), 1.0 / (dy * dy), 1.0 / (dz * dz))
    return _mg_converge_loop(vcycle, lambda p, rhs: _residual(p, rhs, inv2),
                             imax * jmax * kmax, eps, itermax, dtype,
                             stall_rtol)


# ----------------------------------------------------------------------
# obstacle multigrid on one device (pampi_tpu/ops/multigrid.py:646-920,
# 1720-1944): flag fields coarsen by fluid-ANY, every level rediscretises
# the flag-masked operator from its own flags at ω = 1, the bottom is the
# dense pseudo-inverse (or, over its budget, the FFT-preconditioned
# Richardson rounds under tpu_mg_fused on, else 60 smoothing sweeps), and
# the residual is normalised by the fluid cells. The fused cycle runs the
# masked mode of K9-K12 (ops/mg_fused.py); the ladder smooths its large
# levels through masked K2/K5 at ω = 1.
# ----------------------------------------------------------------------

# Obstacle plans stop coarsening at the first level of at most this many
# cells, whose operator is solved exactly by a dense pseudo-inverse (the
# JAX package's _DENSE_BOTTOM_MAX_CELLS).
_DENSE_BOTTOM_MAX_CELLS = 1024

# FFT-preconditioned Richardson rounds of an over-budget bottom under
# tpu_mg_fused on (the JAX package's _FFT_COARSE_ITERS)
_FFT_COARSE_ITERS = 4


def coarsen_fluid(fluid: np.ndarray) -> np.ndarray:
    """(J+2, I+2) bool flags -> (J/2+2, I/2+2): a coarse interior cell is
    fluid iff ANY of its 2x2 fine cells is; the ghost ring stays fluid."""
    fi = fluid[1:-1, 1:-1]
    J, I = fi.shape
    out = np.ones((J // 2 + 2, I // 2 + 2), dtype=bool)
    out[1:-1, 1:-1] = fi.reshape(J // 2, 2, I // 2, 2).any(axis=(1, 3))
    return out


def coarsen_fluid_3d(fluid: np.ndarray) -> np.ndarray:
    """The 3-D twin of coarsen_fluid: ANY of the 2x2x2 fine cells."""
    fi = fluid[1:-1, 1:-1, 1:-1]
    K, J, I = fi.shape
    out = np.ones((K // 2 + 2, J // 2 + 2, I // 2 + 2), dtype=bool)
    out[1:-1, 1:-1, 1:-1] = fi.reshape(K // 2, 2, J // 2, 2, I // 2,
                                       2).any(axis=(1, 3, 5))
    return out


def obstacle_factor(fluid: np.ndarray, spacings) -> np.ndarray:
    """The ω = 1 relaxation factor of a bool flag field (ghosts fluid) as
    an extended float64 array, 0 on the ghost ring and on obstacle cells:
    1/denom with denom = (eps_e + eps_w)·idx2 + (eps_n + eps_s)·idy2
    [+ (eps_b + eps_f)·idz2], formed as the JAX package's make_masks /
    make_masks_3d form ObstacleMasks.factor. spacings = (dx, dy[, dz])."""
    f = np.asarray(fluid, dtype=bool)
    nd = f.ndim
    inner = (slice(1, -1),) * nd
    fi = f[inner]
    denom = None
    for k, h in enumerate(spacings):
        ax = nd - 1 - k
        pair = ((f[_shifted(nd, ax, 1)] & fi).astype(np.float64)
                + (f[_shifted(nd, ax, -1)] & fi).astype(np.float64))
        t = pair * (1.0 / (h * h))
        denom = t if denom is None else denom + t
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = np.where(denom > 0, 1.0 / denom, 0.0) * fi
    out = np.zeros(f.shape)
    out[inner] = fac
    return out


class ObstacleLevel:
    """One level of an obstacle plan, from its masks at ω = 1
    (ops/obstacle.make_masks, ops/obstacle3d.make_masks_3d): its bool
    flags, uint8 flags and 0/1 flags in the dtype (extended, on the
    device), the interior factor, the extended factor the kernels read,
    inv2 (idx2, idy2[, idz2]), the colour masks in sweep order and the
    fluid cell count."""

    def __init__(self, fluid, spacings, dtype, device):
        from .obstacle import make_masks
        from .obstacle3d import make_masks_3d

        nd = fluid.ndim
        m = (make_masks if nd == 2 else make_masks_3d)(fluid, *spacings, 1.0)
        self.fluid = fluid
        self.flags = m.flags(device)
        self.fl = self.flags.to(dtype)
        self.fac_ext = torch.from_numpy(obstacle_factor(fluid, spacings)).to(
            device=device, dtype=dtype)
        self.fac = _inner(self.fac_ext)
        self.spacings = tuple(spacings)
        self.inv2 = tuple(1.0 / (h * h) for h in spacings)
        extents = tuple(n - 2 for n in fluid.shape)
        self.masks = _masks(extents, _parities(nd), dtype, device)
        self.n_fluid = m.n_fluid

    def residual(self, p, rhs):
        return _obstacle_residual(p, rhs, self.fl, self.inv2)

    def smooth(self, p, rhs, n):
        return _obstacle_smooth(p, rhs, self.fl, self.fac, self.masks,
                                self.inv2, n)


def obstacle_levels(fine_fluid, levels, spacings, dtype, device):
    """The ObstacleLevels of a plan: level 0 from the fine bool flags,
    each coarser one coarsened by fluid-ANY, spacings doubled per level."""
    coarsen = coarsen_fluid if len(levels[0]) == 2 else coarsen_fluid_3d
    out, fluid = [], np.asarray(fine_fluid, dtype=bool)
    for lvl in range(len(levels)):
        if lvl:
            fluid = coarsen(fluid)
        out.append(ObstacleLevel(fluid, [h * (2 ** lvl) for h in spacings],
                                 dtype, device))
    return out


def _dense_obstacle_bottom(lv: ObstacleLevel, dtype, device):
    """solve_exact(p, rhs) -> e, the exact bottom: the pseudo-inverse of
    the level's all-Neumann flag-masked operator, built once here with
    numpy as the JAX package builds it (wall ghosts and obstacle
    neighbours drop out; an obstacle cell's row is the identity and its
    column is zeroed in the input), applied as one matrix-vector product.
    p is not read: the solution replaces it (the Neumann ghosts set)."""
    fl = lv.fluid[(slice(1, -1),) * lv.fluid.ndim]
    shape = fl.shape
    nd = fl.ndim
    N = fl.size
    A = np.zeros((N, N))
    steps = []
    for k, w in enumerate(lv.inv2):
        ax = nd - 1 - k
        for sgn in (1, -1):
            d = [0] * nd
            d[ax] = sgn
            steps.append((tuple(d), w))
    for idx in np.ndindex(*shape):
        kk = np.ravel_multi_index(idx, shape)
        if not fl[idx]:
            A[kk, kk] = 1.0
            continue
        for d, w in steps:
            nb = tuple(a + b for a, b in zip(idx, d))
            if not all(0 <= a < n for a, n in zip(nb, shape)):
                continue  # wall ghost: the Neumann mirror cancels the term
            if not fl[nb]:
                continue  # obstacle neighbour: its coefficient is 0
            A[kk, np.ravel_multi_index(nb, shape)] += w
            A[kk, kk] -= w
    apinv = torch.from_numpy(np.linalg.pinv(A)).to(device=device,
                                                   dtype=dtype)
    fl_mask = torch.from_numpy(fl.reshape(-1).astype(np.float64)).to(
        device=device, dtype=dtype)

    def solve_exact(p, rhs):
        e = torch.mv(apinv, _inner(rhs).reshape(-1) * fl_mask)
        out = torch.zeros_like(p)
        _inner(out).copy_(e.reshape(shape))
        return _neumann(out)

    return solve_exact


def _make_fft_coarse(lv: ObstacleLevel, dtype, device,
                     n_rich: int = _FFT_COARSE_ITERS):
    """apply(p, rhs) -> p: the FFT-preconditioned Richardson bottom of an
    over-budget level (the JAX package's _make_fft_coarse_2d/3d): n_rich
    rounds of p += the constant-coefficient DCT solve of the obstacle
    residual on the fluid cells, the Neumann copy, and one red-black ω = 1
    sweep of the obstacle operator (odd first in 3-D)."""
    extents = tuple(n - 2 for n in lv.fluid.shape)
    dct = make_poisson_dct(extents, tuple(reversed(lv.spacings)), dtype,
                           device)
    f0 = _inner(lv.fl)

    def apply(p, rhs):
        p = p.clone()
        for _ in range(n_rich):
            e = dct(lv.residual(p, rhs))
            _inner(p).add_(e * f0)
            _neumann(p)
            lv.smooth(p, rhs, 1)
        return p

    return apply


def _make_obstacle_mg_solve(extents, spacings, eps, itermax, fine_fluid,
                            dtype, n_pre, n_post, n_coarse, stall_rtol,
                            fused, device, key):
    """The obstacle MG solve of make_obstacle_mg_solve_2d/3d on (jmax,
    imax) or (kmax, jmax, imax); key is the dispatch prefix ("mg2d" or
    "mg3d")."""
    from . import mg_fused as mf

    nd = len(extents)
    levels = _truncate_levels(mg_levels(*extents), _DENSE_BOTTOM_MAX_CELLS)
    use_fused = resolve_mg_fused(fused, levels, f"{key}_obstacle_fused")
    lvs = obstacle_levels(fine_fluid, levels, spacings, dtype, device)
    bottom_lv = lvs[-1]
    bottom_exact = bottom_fft = None
    if math.prod(levels[-1]) <= _DENSE_BOTTOM_MAX_CELLS:
        bottom_exact = _dense_obstacle_bottom(bottom_lv, dtype, device)
    elif fused == "on":
        # an over-budget bottom (the plan could not coarsen into the
        # pinv's budget) under tpu_mg_fused on: the Richardson rounds in
        # place of the n_coarse sweeps, in either cycle form
        bottom_fft = _make_fft_coarse(bottom_lv, dtype, device)
        record(f"{key}_obstacle_coarse",
               f"fft_richardson (n={_FFT_COARSE_ITERS})")
    kernel = rb_sor3d_checkerboard if nd == 3 else rb_sor_checkerboard
    big = [math.prod(ext) >= _KERNEL_SMOOTH_MIN_CELLS for ext in levels]

    def smooth(p, rhs, lvl, n):
        # large levels: masked K2/K5 at ω = 1 (its plain version on the
        # CPU), reading p and writing a new field
        lv = lvs[lvl]
        if n and big[lvl]:
            out = torch.empty_like(p)
            kernel(p, rhs, n, 0.0, *lv.inv2, flags=lv.flags, omega=1.0,
                   out=out)
            return out
        return lv.smooth(p, rhs, n)

    def bottom(p, rhs):
        if bottom_exact is not None:
            return bottom_exact(p, rhs)
        if bottom_fft is not None:
            return bottom_fft(p, rhs)
        return smooth(p, rhs, len(lvs) - 1, n_coarse)

    def vcycle(p, rhs, lvl=0):
        lv = lvs[lvl]
        if lvl == len(lvs) - 1:
            return bottom(p, rhs)
        p = smooth(p, rhs, lvl, n_pre)
        r2 = _restrict(lv.residual(p, rhs))
        e2 = vcycle(_embed(torch.zeros_like(r2)), _embed(r2), lvl + 1)
        # inject into fluid cells only
        _inner(p).add_(_prolong(_inner(e2)) * _inner(lv.fl))
        _neumann(p)
        return smooth(p, rhs, lvl, n_post)

    def vcycle_ladder(p, rhs):
        # the ladder works in place: a copy keeps the caller's p intact
        return vcycle(p.clone(), rhs.contiguous())

    cycle = vcycle_ladder
    if use_fused:
        plan = mf.make_cycle_plan(
            levels, spacings, n_pre, n_post,
            fluid_levels=[lv.flags for lv in lvs],
            factor_levels=[lv.fac_ext for lv in lvs])

        def vcycle_fused(p, rhs):
            # looked up at call time, so a caller may wrap the two halves
            pstk, rstk = mf.mg_down(plan, p, rhs)
            rb = rstk[-1]
            pbot = bottom(torch.zeros_like(rb), rb)
            return mf.mg_up(plan, pstk, rstk, pbot)

        cycle = vcycle_fused

    fine = lvs[0]
    solve = _mg_converge_loop(cycle, fine.residual, fine.n_fluid, eps,
                              itermax, dtype, stall_rtol)
    solve.levels, solve.fused, solve.flags = lvs, use_fused, fine.flags
    return solve


def make_obstacle_mg_solve_2d(imax, jmax, dx, dy, eps, itermax, masks,
                              dtype, n_pre: int = 2, n_post: int = 2,
                              n_coarse: int = 60, stall_rtol=MG_STALL_RTOL,
                              *, fused: str, device):
    """The obstacle MG solve (p, rhs) -> (p, res, it) on the (jmax+2,
    imax+2) grid (counterpart of pampi_tpu/ops/multigrid.py
    make_obstacle_mg_solve_2d): `masks` the fine level's ObstacleMasks
    (ops/obstacle.py; only its fluid field is read, every level relaxes at
    ω = 1), res = Σr²/n_fluid after the last cycle, `it` the V-cycle
    count; stalls stop the loop early (`stall_rtol`, 0 disables). The
    cycle form is `fused` (tpu_mg_fused, recorded under
    "mg2d_obstacle_fused"); an over-budget bottom under `on` records
    "mg2d_obstacle_coarse". solve.levels holds the plan's
    ObstacleLevels, solve.fused the cycle form, solve.flags the fine
    level's uint8 flags."""
    check_eps_floor(eps, imax * jmax, dtype, f"mg2d_obstacle {imax}x{jmax}")
    return _make_obstacle_mg_solve(
        (jmax, imax), (dx, dy), eps, itermax, np.asarray(masks.fluid) != 0,
        dtype, n_pre, n_post, n_coarse, stall_rtol, fused, device, "mg2d")


def make_obstacle_mg_solve_3d(imax, jmax, kmax, dx, dy, dz, eps, itermax,
                              masks, dtype, n_pre: int = 2, n_post: int = 2,
                              n_coarse: int = 60, stall_rtol=MG_STALL_RTOL,
                              *, fused: str, device):
    """The 3-D twin of make_obstacle_mg_solve_2d (masks: ops/obstacle3d.
    ObstacleMasks3D; sweeps odd then even; recorded under
    "mg3d_obstacle_fused" and "mg3d_obstacle_coarse")."""
    check_eps_floor(eps, imax * jmax * kmax, dtype,
                    f"mg3d_obstacle {imax}x{jmax}x{kmax}")
    return _make_obstacle_mg_solve(
        (kmax, jmax, imax), (dx, dy, dz), eps, itermax,
        np.asarray(masks.fluid) != 0, dtype, n_pre, n_post, n_coarse,
        stall_rtol, fused, device, "mg3d")
