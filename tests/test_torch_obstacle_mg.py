"""The port's obstacle multigrid on one device (pampi_tpu_torch/ops/
multigrid.py make_obstacle_mg_solve_2d/3d, the masked mode of K9-K12 in
ops/mg_fused.py, models/ns2d.py and ns3d.py under `tpu_solver mg|auto`)
on the CPU, where the kernels run their plain versions, against the JAX
package (pampi_tpu/ops/multigrid.py, ops/mg_fused.py and its NS solvers).

The dense-bottom budget is lowered in both packages to 64 cells in 2-D
and 512 in 3-D (as tests/test_mg_fused.py does), so that small grids give
plans of several levels.

- The hierarchy: coarsen_fluid/coarsen_fluid_3d bitwise JAX's on random
  flags; the ω = 1 factor of every level (the array the masked kernels
  read) bitwise JAX's ObstacleMasks.factor, in float64 and cast to
  float32; the dense bottoms and the FFT Richardson bottoms within 1e-12
  of JAX's (numpy builds the same pseudo-inverse; only the products'
  summation orders differ).
- The masked DOWN/UP plain versions against JAX's interpret-mode
  make_cycle_kernels(fluid_levels=, factor_levels=) at 32² (the box of
  tests/test_mg_fused.py, and one that touches the walls at every level),
  float64 1e-12 and float32 2e-5 of scale; in 3-D against JAX's ladder
  (its own 3-D interpret test is marked slow).
- The solves, fused and ladder, against JAX's ladder (and in 2-D its
  forced fused cycle): the same V-cycle counts, fields within 1e-12 of
  scale; the port's two forms bitwise one another; every bottom branch
  reached (dense, FFT Richardson under `on`, the smoothed fallback).
- NS2DSolver on configs/canal_obstacle.par cut to 64x16 and NS3DSolver on
  configs/canal3d_obstacle.par cut to 32x16x16 under `tpu_solver mg` and
  `auto`: nt equal, fields within 1e-10 of scale, the dispatch keys JAX's;
  and the CLI on `--device cpu` against the JAX CLI: .dat files within
  their print precision.
- The plain multigrid keeps its cycle counts and fields after the
  convergence loop was generalised (a fixed-seed pin)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu import cli as jcli
from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver
from pampi_tpu.models.ns3d import NS3DSolver as JNS3DSolver
from pampi_tpu.ops import mg_fused as jmf
from pampi_tpu.ops import multigrid as jmg
from pampi_tpu.ops import obstacle as jobst
from pampi_tpu.ops import obstacle3d as jobst3
from pampi_tpu.utils import dispatch as jdispatch
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.ops import mg_fused as tmf
from pampi_tpu_torch.ops import multigrid as tmg
from pampi_tpu_torch.ops import obstacle as tobst
from pampi_tpu_torch.ops import obstacle3d as tobst3
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.datio import read_pressure, read_velocity
from pampi_tpu_torch.utils.params import Parameter, read_parameter

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
F64 = torch.float64
BUDGET = {2: 64, 3: 512}
N = {2: 32, 3: 16}


@pytest.fixture
def small_budget(monkeypatch):
    """Lower the dense-bottom budget of both packages (2-D value; a test
    that needs the 3-D one calls the returned setter)."""
    def set_budget(nd):
        for mod in (jmg, tmg):
            monkeypatch.setattr(mod, "_DENSE_BOTTOM_MAX_CELLS", BUDGET[nd])

    set_budget(2)
    return set_budget


def _close(a, b, tol):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    scale = max(1.0, float(np.abs(b).max()))
    d = float(np.abs(a - b).max())
    assert d <= tol * scale, (d, tol * scale)


def _box(nd, kind="box"):
    """Fine bool flags on the (N+2)^nd grid: "box" the box of
    tests/test_mg_fused.py, "edge" two obstacles touching walls, cut so
    that every level's coarsened flags touch them too."""
    n = N[nd]
    fl = np.ones((n + 2,) * nd, bool)
    if nd == 2 and kind == "box":
        fl[10:18, 12:22] = False
    elif nd == 2:
        fl[1:9, 5:13] = False      # on the south wall
        fl[21:33, 25:33] = False   # in the north-east corner
    else:
        fl[6:10, 5:9, 7:12] = False
    return fl


def _rhs(nd, seed, dtype=np.float64, zero_mean=False):
    n = N[nd]
    rng = np.random.default_rng(seed)
    rhs = np.zeros((n + 2,) * nd, dtype)
    inner = rng.standard_normal((n,) * nd)
    if zero_mean:
        inner -= inner.mean()
    rhs[(slice(1, -1),) * nd] = inner
    return rhs


def _masks(fluid):
    """(the port's, JAX's) masks of a fine flag field at ω = 1.7, f64."""
    n = fluid.shape[0] - 2
    h = 1.0 / n
    if fluid.ndim == 2:
        return (tobst.make_masks(fluid, h, h, 1.7),
                jobst.make_masks(fluid, h, h, 1.7, jnp.float64))
    return (tobst3.make_masks_3d(fluid, h, h, h, 1.7),
            jobst3.make_masks_3d(fluid, h, h, h, 1.7, jnp.float64))


def _jax_levels(fluid, nd):
    """JAX's ω = 1 masks of every level of the plan of `fluid`."""
    n = N[nd]
    levels = jmg._truncate_levels(jmg.mg_levels(*(n,) * nd),
                                  jmg._DENSE_BOTTOM_MAX_CELLS)
    coarsen = jmg.coarsen_fluid if nd == 2 else jmg.coarsen_fluid_3d
    out, fl = [], fluid
    for lvl in range(len(levels)):
        if lvl:
            fl = coarsen(fl)
        h = 2 ** lvl / n
        out.append(jobst.make_masks(fl, h, h, 1.0, jnp.float64) if nd == 2
                   else jobst3.make_masks_3d(fl, h, h, h, 1.0, jnp.float64))
    return levels, out


# -- the hierarchy -----------------------------------------------------------


@pytest.mark.parametrize("nd", [2, 3])
def test_coarsen_fluid_matches_jax(nd):
    rng = np.random.default_rng(nd)
    shape = (18, 34) if nd == 2 else (10, 18, 34)
    fl = rng.random(shape) < 0.7
    ours = (tmg.coarsen_fluid if nd == 2 else tmg.coarsen_fluid_3d)(fl)
    theirs = (jmg.coarsen_fluid if nd == 2 else jmg.coarsen_fluid_3d)(fl)
    assert ours.dtype == bool and np.array_equal(ours, theirs)


@pytest.mark.parametrize("nd", [2, 3])
def test_level_factors_are_jax_factors(nd, small_budget):
    """Every level's ω = 1 factor, as the plan holds it for the masked
    kernels, is bitwise JAX's ObstacleMasks.factor at float64 and at
    float32 (JAX casts its float64 host array)."""
    small_budget(nd)
    fluid = _box(nd)
    levels, jlv = _jax_levels(fluid, nd)
    assert len(levels) >= 2
    inner = (slice(1, -1),) * nd
    for dtype, jdt in ((torch.float64, jnp.float64),
                       (torch.float32, jnp.float32)):
        lvs = tmg.obstacle_levels(fluid, levels, (1.0 / N[nd],) * nd, dtype,
                                  "cpu")
        for lv, jm in zip(lvs, jlv):
            fac = lv.fac_ext.numpy()
            assert not fac[0].any() and not fac[-1].any()
            np.testing.assert_array_equal(
                fac[inner], np.asarray(jm.factor).astype(jdt))
            np.testing.assert_array_equal(lv.flags.numpy(),
                                          np.asarray(jm.fluid) != 0)
            assert lv.n_fluid == jm.n_fluid


@pytest.mark.parametrize("nd", [2, 3])
def test_dense_and_fft_bottoms_match_jax(nd):
    """The dense pseudo-inverse bottom and the FFT Richardson bottom of a
    coarse obstacle level against JAX's, on a random rhs and start."""
    n = 16 if nd == 2 else 8
    fluid = np.ones((n + 2,) * nd, bool)
    fluid[(slice(4, 9),) * nd] = False
    h = 0.25
    lv = tmg.ObstacleLevel(fluid, (h,) * nd, F64, "cpu")
    jm = (jobst.make_masks(fluid, h, h, 1.0, jnp.float64) if nd == 2 else
          jobst3.make_masks_3d(fluid, h, h, h, 1.0, jnp.float64))
    rng = np.random.default_rng(5)
    p, rhs = rng.standard_normal((2,) + fluid.shape)
    if nd == 2:
        from pampi_tpu.ops.sor import checkerboard_mask

        jexact = jmg._dense_obstacle_bottom(jm.fluid, h, h, jnp.float64)
        red, black = (checkerboard_mask(n, n, c, jnp.float64) for c in (0, 1))
        jfft = jmg._make_fft_coarse_2d(jm, h, h, 1 / h ** 2, 1 / h ** 2, red,
                                       black)
    else:
        from pampi_tpu.models.ns3d import checkerboard_mask_3d

        jexact = jmg._dense_obstacle_bottom_3d(jm.fluid, h, h, h,
                                               jnp.float64)
        odd, even = (checkerboard_mask_3d(n, n, n, c, jnp.float64)
                     for c in (1, 0))
        jfft = jmg._make_fft_coarse_3d(jm, h, h, h, *(1 / h ** 2,) * 3, odd,
                                       even)
    exact = tmg._dense_obstacle_bottom(lv, F64, "cpu")
    fft = tmg._make_fft_coarse(lv, F64, "cpu")
    tp, trhs = torch.from_numpy(p), torch.from_numpy(rhs)
    _close(exact(tp, trhs).numpy(),
           jexact(jnp.asarray(p), jnp.asarray(rhs)), 1e-12)
    got = fft(tp, trhs)
    assert torch.equal(tp, torch.from_numpy(p))  # the input is not touched
    _close(got.numpy(), jfft(jnp.asarray(p), jnp.asarray(rhs)), 1e-12)


# -- the masked DOWN/UP plain versions --------------------------------------


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["box", "edge"])
def test_masked_down_up_plain_match_jax_kernels(kind, dt, small_budget):
    """mg_down_plain/mg_up_plain of a masked plan against JAX's
    interpret-mode masked DOWN/UP at 32² (3 levels): every level of both
    stacks and UP's output from the same stacks."""
    tdt, jdt, tol = ((F64, jnp.float64, 1e-12) if dt == "f64"
                     else (torch.float32, jnp.float32, 2e-5))
    npdt = np.float64 if dt == "f64" else np.float32
    fluid = _box(2, kind)
    levels, jlv = _jax_levels(fluid, 2)
    assert len(levels) == 3
    h = 1.0 / N[2]
    down, up, plane = jmf.make_cycle_kernels(
        levels, (h, h), jdt, 2, 2, interpret=True,
        fluid_levels=[np.asarray(m.fluid) for m in jlv],
        factor_levels=[m.factor for m in jlv])
    rng = np.random.default_rng(11)
    p, rhs = (x.astype(npdt) for x in rng.standard_normal((2, 34, 34)))
    jp, jr = down(jmf.pad_plane(jnp.asarray(p), plane),
                  jmf.pad_plane(jnp.asarray(rhs), plane))
    lvs = tmg.obstacle_levels(fluid, levels, (h, h), tdt, "cpu")
    plan = tmf.make_cycle_plan(levels, (h, h),
                               fluid_levels=[lv.flags for lv in lvs],
                               factor_levels=[lv.fac_ext for lv in lvs])
    assert plan.masked
    pstk, rstk = tmf.mg_down(plan, torch.from_numpy(p), torch.from_numpy(rhs))
    for lvl, (jl, il) in enumerate(levels):
        _close(pstk[lvl].numpy(), np.asarray(jp[lvl])[:jl + 2, :il + 2], tol)
        _close(rstk[lvl].numpy(), np.asarray(jr[lvl])[:jl + 2, :il + 2], tol)
    jb, ib = levels[-1]
    pbot = np.zeros((jb + 2, ib + 2), npdt)
    pbot[1:-1, 1:-1] = rng.standard_normal((jb, ib))
    jout = up(jp, jr, jmf.pad_plane(jnp.asarray(pbot), plane))
    stacks = [[torch.from_numpy(np.asarray(s[lvl])[:jl + 2, :il + 2].copy())
               for lvl, (jl, il) in enumerate(levels)] for s in (jp, jr)]
    out = tmf.mg_up(plan, *stacks, torch.from_numpy(pbot))
    _close(out.numpy(), np.asarray(jout)[:34, :34], tol)
    # the correction lands on fluid cells only: UP from a zero pbot and a
    # nonzero one differ nowhere inside the obstacles (before smoothing
    # reaches them, which it does not: their factor is 0)
    zero = tmf.mg_up(plan, *stacks, torch.zeros_like(torch.from_numpy(pbot)))
    obst = ~fluid
    np.testing.assert_array_equal(out.numpy()[obst], zero.numpy()[obst])


def test_masked_plan_rules():
    lv = [torch.ones(18, 18, dtype=torch.uint8), torch.ones(10, 10,
                                                            dtype=torch.uint8)]
    fac = [torch.zeros(18, 18, dtype=F64), torch.zeros(10, 10, dtype=F64)]
    levels = [(16, 16), (8, 8)]
    with pytest.raises(ValueError, match="every level"):
        tmf.make_cycle_plan(levels, (0.1, 0.1), fluid_levels=lv[:1],
                            factor_levels=fac[:1])
    with pytest.raises(ValueError, match="uint8"):
        tmf.make_cycle_plan(levels, (0.1, 0.1),
                            fluid_levels=[x.to(F64) for x in lv],
                            factor_levels=fac)
    with pytest.raises(ValueError, match="level 1"):
        tmf.make_cycle_plan(levels, (0.1, 0.1), fluid_levels=lv,
                            factor_levels=[fac[0], fac[0]])
    plan = tmf.make_cycle_plan(levels, (0.1, 0.1), fluid_levels=lv,
                               factor_levels=fac)
    assert plan.masked and not tmf.make_cycle_plan(levels, (0.1, 0.1)).masked
    assert {"mg_down_2d_masked", "mg_up_2d_masked", "mg_down_3d_masked",
            "mg_up_3d_masked"} <= set(tmf.kb.KERNELS)
    z = torch.zeros(18, 18, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tmf.mg_down(plan, z, z)


# -- the solves ---------------------------------------------------------------


def _solve_args(nd, eps=0.0, itermax=3):
    n = N[nd]
    return (*(n,) * nd, *(1.0 / n,) * nd, eps, itermax)


def _jax_solve(nd, jm, fused, rhs, eps=0.0, itermax=3):
    make = (jmg.make_obstacle_mg_solve_2d if nd == 2
            else jmg.make_obstacle_mg_solve_3d)
    s = make(*_solve_args(nd, eps, itermax), jm, jnp.float64, stall_rtol=0,
             fused=fused)
    p, res, it = s(jnp.zeros(rhs.shape), jnp.asarray(rhs))
    return np.asarray(p), float(res), int(it)


def _port_solve(nd, tm, fused, rhs, eps=0.0, itermax=3):
    make = (tmg.make_obstacle_mg_solve_2d if nd == 2
            else tmg.make_obstacle_mg_solve_3d)
    s = make(*_solve_args(nd, eps, itermax), tm, F64, stall_rtol=0,
             fused=fused, device="cpu")
    p, res, it = s(torch.zeros(rhs.shape, dtype=F64), torch.from_numpy(rhs))
    return p.numpy(), res, it, s


@pytest.mark.parametrize("nd", [2, 3])
def test_solves_match_jax(nd, small_budget):
    """Fused and ladder against JAX's ladder (and, in 2-D, its forced
    fused cycle): the same V-cycle counts on an eps the solve reaches in a
    few cycles, fields within 1e-12 of scale, the last residual (a sum of
    squares near round-off) within 1e-9 relative; the port's two forms
    bitwise one another."""
    small_budget(nd)
    fluid = _box(nd)
    tm, jm = _masks(fluid)
    # a consistent Neumann rhs: zero on the obstacles, zero mean on the
    # interior's fluid cells
    live = np.zeros_like(fluid)
    live[(slice(1, -1),) * nd] = fluid[(slice(1, -1),) * nd]
    rhs = _rhs(nd, 3) * live
    rhs[live] -= rhs[live].mean()
    rhs *= live
    eps = 1e-5 if nd == 2 else 1e-6
    theirs = {"off": _jax_solve(nd, jm, "off", rhs, eps, 20)}
    if nd == 2:
        theirs["on"] = _jax_solve(nd, jm, "on", rhs, eps, 20)
    ours = {}
    for fused, rec in (("auto", "fused cycle (auto"), ("off", "ladder")):
        ours[fused] = _port_solve(nd, tm, fused, rhs, eps, 20)
        assert dispatch.last(f"mg{nd}d_obstacle_fused").startswith(rec)
        assert ours[fused][3].fused == (fused == "auto")
        assert len(ours[fused][3].levels) >= 2
    for jp, jres, jit in theirs.values():
        for p, res, it, _s in ours.values():
            assert it == jit and 2 <= it < 20
            _close(p, jp, 1e-12)
            assert abs(res - jres) <= 1e-9 * jres
    np.testing.assert_array_equal(ours["auto"][0], ours["off"][0])
    assert ours["auto"][1] == ours["off"][1]


def test_ladder_through_masked_k2_matches_jax(small_budget, monkeypatch):
    """With the kernel threshold lowered, the ladder's two finer levels
    smooth through masked K2 at ω = 1 (its plain version here), as the
    card's ladder does at full size: fields within 1e-12 of JAX's
    ladder."""
    monkeypatch.setattr(tmg, "_KERNEL_SMOOTH_MIN_CELLS", 256)
    fluid = _box(2)
    tm, jm = _masks(fluid)
    rhs = _rhs(2, 4)
    jp, jres, jit = _jax_solve(2, jm, "off", rhs)
    p, res, it, _s = _port_solve(2, tm, "off", rhs)
    assert it == jit == 3
    _close(p, jp, 1e-12)


@pytest.mark.parametrize("fused, coarse", [("on", "fft_richardson (n=4)"),
                                           ("auto", None), ("off", None)])
def test_over_budget_bottoms_match_jax(fused, coarse, small_budget):
    """An 18x22 grid stops at 9x11 (99 cells, over the 64-cell budget):
    under `on` the FFT Richardson bottom (recorded), else the 60-sweep
    smoothed bottom; against JAX's same build, 3 cycles."""
    J, I = 18, 22
    dx, dy = 1.0 / I, 1.0 / J
    fluid = np.ones((J + 2, I + 2), bool)
    fluid[5:10, 6:12] = False
    tm = tobst.make_masks(fluid, dx, dy, 1.7)
    jm = jobst.make_masks(fluid, dx, dy, 1.7, jnp.float64)
    rng = np.random.default_rng(8)
    rhs = np.zeros((J + 2, I + 2))
    rhs[1:-1, 1:-1] = rng.standard_normal((J, I))
    for d in (dispatch, jdispatch):
        d._RECORD.pop("mg2d_obstacle_coarse", None)
    js = jmg.make_obstacle_mg_solve_2d(I, J, dx, dy, 0.0, 3, jm, jnp.float64,
                                       stall_rtol=0, fused=fused)
    jp, _jres, jit = js(jnp.zeros(rhs.shape), jnp.asarray(rhs))
    s = tmg.make_obstacle_mg_solve_2d(I, J, dx, dy, 0.0, 3, tm, F64,
                                      stall_rtol=0, fused=fused, device="cpu")
    assert [lv.fluid.shape for lv in s.levels] == [(20, 24), (11, 13)]
    p, _res, it = s(torch.zeros(rhs.shape, dtype=F64), torch.from_numpy(rhs))
    assert dispatch.last("mg2d_obstacle_coarse") == coarse
    assert jdispatch.last("mg2d_obstacle_coarse") == coarse
    assert it == int(jit) == 3
    _close(p.numpy(), jp, 1e-12)


def _loop_before(vcycle, inv2, ncells, eps, itermax):
    """The convergence loop as it was before it took a residual function
    and a norm (the plain residual and the cell count hard-coded)."""
    norm, epssq = np.float64(ncells), np.float64(eps * eps)

    def solve(p, rhs):
        res, prev, it = np.float64(1.0), np.float64(np.inf), 0
        while (res >= epssq and it < itermax
               and not tmg._stalled(prev, res, it)):
            p = vcycle(p, rhs)
            r = tmg._residual(p, rhs, inv2)
            prev, res = res, np.float64(float(torch.sum(r * r))) / norm
            it += 1
        return p, float(res), it

    return solve


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_plain_mg_unchanged(nd, fused, monkeypatch):
    """The plain mg solves, with the convergence loop generalised, give
    bitwise the fields, residuals and cycle counts of the loop before the
    change, on multi-level plans in both cycle forms."""
    monkeypatch.setattr(tmg, "_DCT_BOTTOM_MAX_CELLS", BUDGET[nd])
    n = N[nd]
    rhs = torch.from_numpy(_rhs(nd, 9))
    h = 1.0 / n
    make = tmg.make_mg_solve_2d if nd == 2 else tmg.make_mg_solve_3d
    new = make(*(n,) * nd, *(h,) * nd, 1e-9, 30, F64, fused=fused,
               device="cpu")
    vcycle = (tmg.make_mg_vcycle_2d if nd == 2 else tmg.make_mg_vcycle_3d)(
        *(n,) * nd, *(h,) * nd, F64, fused=fused, device="cpu")
    old = _loop_before(vcycle, (1.0 / (h * h),) * nd, n ** nd, 1e-9, 30)
    p0 = torch.zeros_like(rhs)
    a, b = new(p0, rhs), old(p0, rhs)
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:]
    assert 2 <= a[2] < 30


# -- the NS solvers and the CLI ----------------------------------------------


def _ns_params(nd, solver, **kw):
    if nd == 2:
        base = dict(imax=64, jmax=16, te=1.0, tpu_solver=solver)
        par = str(CONFIGS / "canal_obstacle.par")
    else:
        base = dict(imax=32, jmax=16, kmax=16, te=0.5, tpu_solver=solver,
                    tpu_mesh="1")
        par = str(CONFIGS / "canal3d_obstacle.par")
    base.update(kw)
    return (jread_parameter(par).replace(**base),
            read_parameter(par).replace(**base))


# each case removed from the refusal tests when obstacle multigrid came
# (tests/test_torch_obstacle2d.py "mg", "auto-takes-mg";
# tests/test_torch_obstacle3d.py "mg", "auto-takes-mg", "2-d") runs here
NS_CASES = {
    "2d-mg": (2, "mg", True),
    "2d-auto-takes-mg": (2, "auto", False),
    "3d-mg": (3, "mg", True),
    "3d-auto-takes-mg": (3, "auto", False),
}


@pytest.mark.parametrize("case", sorted(NS_CASES))
def test_ns_solver_matches_jax(case, monkeypatch):
    """NS2DSolver / NS3DSolver with obstacles under mg (multi-level plans
    at the lowered budget) and auto (the default budget: a 2-level plan in
    3-D, a single-level one in 2-D) against the JAX solvers: the same
    steps and V-cycles, t to an ulp, fields within 1e-10 of scale, the
    dispatch keys JAX records."""
    nd, solver, multi = NS_CASES[case]
    if multi:
        for mod in (jmg, tmg):
            monkeypatch.setattr(mod, "_DENSE_BOTTOM_MAX_CELLS", BUDGET[nd])
    jparam, param = _ns_params(nd, solver)
    for d in (dispatch, jdispatch):
        d._RECORD.clear()
    js = (JNS2DSolver if nd == 2 else JNS3DSolver)(jparam)
    js.run(progress=False)
    s = (NS2DSolver if nd == 2 else NS3DSolver)(param, device="cpu")
    s.run(progress=False)
    key = f"mg{nd}d_obstacle_fused"
    step = "ns2d_step" if nd == 2 else "ns3d_step"
    assert dispatch.last(key).startswith("fused cycle (auto" if multi or
                                         nd == 3 else "ladder (single")
    assert dispatch.last(step).startswith("pre -> mg obstacle")
    assert key in jdispatch.snapshot()
    assert (dispatch.last("solver_auto") is None) == (solver == "mg")
    assert (jdispatch.last("solver_auto") is None) == (solver == "mg")
    levels = len(s._solve.levels)
    assert (levels >= 2) == (multi or nd == 3)
    assert s.nt == js.nt > 2
    assert abs(s.t - js.t) <= 1e-14 * js.t
    assert 1 <= s.last_it <= jparam.itermax
    for name in ("uvp" if nd == 2 else "uvwp"):
        _close(getattr(s, name).numpy(), getattr(js, name), 1e-10)


def test_ns2d_canal_with_obstacles_runs_mg():
    """A canal (not canal_obstacle) .par with an obstacles key under mg
    runs the obstacle multigrid too (once refused as the "2-d" case)."""
    s = NS2DSolver(Parameter(name="canal", imax=32, jmax=16,
                             obstacles="0.2,0.2,0.4,0.4", tpu_solver="mg",
                             te=0.2), device="cpu")
    s.run(progress=False)
    assert dispatch.last("ns2d_step") == "pre -> mg obstacle ladder -> " \
        "post on cpu"
    assert s.nt > 0 and all(bool(torch.isfinite(getattr(s, k)).all())
                            for k in "uvp")


def test_cli_mg_matches_jax_cli(tmp_path, monkeypatch):
    """`python -m pampi_tpu_torch --device cpu` with tpu_solver mg on
    canal_obstacle.par cut to 64x16 (te 0.3) exits 0, and its
    pressure.dat and velocity.dat agree with the JAX CLI's within 1e-10
    plus their print precision."""
    text = (CONFIGS / "canal_obstacle.par").read_text()
    for key, val in (("imax", 64), ("jmax", 16), ("te", 0.3)):
        text = "\n".join(f"{key} {val}" if ln.split()[:1] == [key] else ln
                         for ln in text.splitlines()) + "\n"
    text += "tpu_solver mg\n"
    outs = []
    for name, main, args in (
            ("jax", jcli.main, ["pampi_tpu", "co.par"]),
            ("torch", cli.main, ["pampi_tpu_torch", "--device", "cpu",
                                 "co.par"])):
        d = tmp_path / name
        d.mkdir()
        (d / "co.par").write_text(text)
        monkeypatch.chdir(d)
        assert main(args) in (0, None)
        outs.append((read_pressure(str(d / "pressure.dat")),
                     *read_velocity(str(d / "velocity.dat"))))
    assert dispatch.last("ns2d_step").startswith("pre -> mg obstacle")
    for a, b in zip(*outs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 + 2e-6)


def test_mesh_refusal_names_a8():
    """On a mesh obstacle multigrid stays refused, naming ROADMAP A.8."""
    from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
    from pampi_tpu_torch.parallel.comm import CartComm

    _, param = _ns_params(2, "mg")
    comm = CartComm(ndims=2, dims=(2, 2), devices=[torch.device("cpu")])
    with pytest.raises(NotImplementedError,
                       match="obstacle multigrid .*ROADMAP A.8, item 6.4"):
        NS2DDistSolver(param, comm)
