"""The fused V-cycle's DOWN and UP (ops/mg_fused.py) on the CPU:

1. mg_down_plain / mg_up_plain against the JAX kernels themselves
   (make_cycle_kernels, interpret mode) on 2- and 3-level plans,
   (32,32)/(16,16)/(8,8) and (16,16,16)/(8,8,8), float32 (2e-5 of scale,
   the JAX fused-vs-ladder contract) and float64 (1e-12): the live corner
   of every level of both stacks, and UP's output from the same stacks;
2. the whole fused solve against JAX's forced fused solve (same V-cycle
   count) and against the port's own ladder (2e-5 in float32);
3. the plan rules: a single-level plan takes the ladder and records why;
   odd or non-halving plans are refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.ops import mg_fused as jmf
from pampi_tpu.ops import multigrid as jmg
from pampi_tpu_torch.ops import mg_fused as tmf
from pampi_tpu_torch.ops import multigrid as tmg
from pampi_tpu_torch.utils import dispatch

PLANS = {
    "2d-3lvl": [(32, 32), (16, 16), (8, 8)],
    "2d-2lvl": [(16, 24), (8, 12)],
    "3d-2lvl": [(16, 16, 16), (8, 8, 8)],
}
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-5),
          "f64": (torch.float64, jnp.float64, 1e-12)}


def _close(a, b, tol):
    b = np.asarray(b, dtype=np.float64)
    scale = max(1.0, float(np.abs(b).max()))
    d = float(np.abs(np.asarray(a, dtype=np.float64) - b).max())
    assert d <= tol * scale, (d, tol * scale)


def _corner(a, ext):
    return np.asarray(a)[tuple(slice(0, n + 2) for n in ext)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(PLANS))
def test_down_up_plain_match_jax_kernels(name, dt):
    levels = PLANS[name]
    tdt, jdt, tol = DTYPES[dt]
    nd = len(levels[0])
    sp = tuple(1.0 / (levels[0][-1 - a] + 2 * a) for a in range(nd))
    rng = np.random.default_rng(7)
    full = tuple(n + 2 for n in levels[0])
    p, rhs = rng.standard_normal((2,) + full)
    p, rhs = p.astype(np.float32 if dt == "f32" else np.float64), \
        rhs.astype(np.float32 if dt == "f32" else np.float64)
    down, up, plane = jmf.make_cycle_kernels(levels, sp, jdt, 2, 2,
                                             interpret=True)
    jp, jr = down(jmf.pad_plane(jnp.asarray(p), plane),
                  jmf.pad_plane(jnp.asarray(rhs), plane))
    plan = tmf.make_cycle_plan(levels, sp)
    assert plan.parities == ((0, 1) if nd == 2 else (1, 0))
    pstk, rstk = tmf.mg_down(plan, torch.from_numpy(p), torch.from_numpy(rhs))
    assert len(pstk) == len(rstk) == len(levels)
    assert pstk[0].dtype == tdt
    for lvl, ext in enumerate(levels):
        _close(pstk[lvl].numpy(), _corner(jp[lvl], ext), tol)
        _close(rstk[lvl].numpy(), _corner(jr[lvl], ext), tol)
    assert not pstk[-1].any()
    # UP from JAX's own stacks and one bottom correction
    pbot = np.zeros(tuple(n + 2 for n in levels[-1]), p.dtype)
    pbot[(slice(1, -1),) * nd] = rng.standard_normal(levels[-1])
    jout = up(jp, jr, jmf.pad_plane(jnp.asarray(pbot), plane))
    stacks = [[torch.from_numpy(_corner(s[lvl], ext).copy())
               for lvl, ext in enumerate(levels)] for s in (jp, jr)]
    before = [t.clone() for t in stacks[0]]
    out = tmf.mg_up(plan, *stacks, torch.from_numpy(pbot))
    _close(out.numpy(), _corner(jout, levels[0]), tol)
    # UP leaves the stacks alone
    assert all(torch.equal(a, b) for a, b in zip(before, stacks[0]))


def _rhs(n, nd, dtype, seed):
    """A consistent Neumann rhs: random, zero mean on the interior."""
    rng = np.random.default_rng(seed)
    rhs = np.zeros((n + 2,) * nd, dtype)
    inner = rng.standard_normal((n,) * nd)
    rhs[(slice(1, -1),) * nd] = inner - inner.mean()
    return rhs


@pytest.mark.parametrize("nd", [2, 3])
def test_fused_solve_matches_jax_fused_and_own_ladder(nd, monkeypatch):
    budget = 64 if nd == 2 else 512
    monkeypatch.setattr(jmg, "_DCT_BOTTOM_MAX_CELLS", budget)
    monkeypatch.setattr(tmg, "_DCT_BOTTOM_MAX_CELLS", budget)
    n = 32 if nd == 2 else 16
    dims = (n,) * nd
    sp = (1.0 / n,) * nd
    rhs = _rhs(n, nd, np.float32, nd)
    args = (*dims, *sp, 1e-4, 20)  # stops on eps after a few cycles
    make_t = tmg.make_mg_solve_2d if nd == 2 else tmg.make_mg_solve_3d
    make_j = jmg.make_mg_solve_2d if nd == 2 else jmg.make_mg_solve_3d
    jfused = make_j(*args, jnp.float32, stall_rtol=0, fused="on")
    jp, _jres, jit = jfused(jnp.zeros_like(jnp.asarray(rhs)),
                            jnp.asarray(rhs))
    runs = {}
    for fused, rec in (("on", "fused cycle (forced"), ("off", "ladder")):
        solve = make_t(*args, torch.float32, stall_rtol=0, fused=fused,
                       device="cpu")
        assert dispatch.last(f"mg{nd}d_fused").startswith(rec)
        runs[fused] = solve(torch.zeros(rhs.shape), torch.from_numpy(rhs))
    p_on, _res, it_on = runs["on"]
    assert it_on == runs["off"][2] == int(jit) and 2 <= it_on < 20
    _close(p_on.numpy(), runs["off"][0].numpy(), 2e-5)
    _close(p_on.numpy(), jp, 2e-5)


def test_single_level_plan_takes_the_ladder():
    """At the default bottom budget a 32² grid is one level: the fused
    knob forced on still takes the ladder, and says why."""
    tmg.make_mg_solve_2d(32, 32, 1 / 32, 1 / 32, 0.0, 2, torch.float64,
                         fused="on", device="cpu")
    rec = dispatch.last("mg2d_fused")
    assert rec.startswith("ladder (single-level plan"), rec
    tmg.make_mg_solve_3d(16, 16, 16, 1 / 16, 1 / 16, 1 / 16, 0.0, 2,
                         torch.float64, fused="auto", device="cpu")
    assert dispatch.last("mg3d_fused").startswith("ladder (single-level")


def test_plan_rules():
    with pytest.raises(ValueError, match="at least 2 levels"):
        tmf.make_cycle_plan([(8, 8)], (0.1, 0.1))
    with pytest.raises(ValueError, match="not half"):
        tmf.make_cycle_plan([(10, 8), (4, 4)], (0.1, 0.1))
    with pytest.raises(ValueError, match="not half"):
        tmf.make_cycle_plan([(9, 8), (4, 4)], (0.1, 0.1))
    with pytest.raises(ValueError, match=">= 1"):
        tmf.make_cycle_plan([(8, 8), (4, 4)], (0.1, 0.1), n_pre=0)
    with pytest.raises(ValueError, match="auto|on|off"):
        tmg.make_mg_solve_2d(8, 8, 0.1, 0.1, 0.0, 2, torch.float64,
                             fused="yes", device="cpu")
    plan = tmf.make_cycle_plan([(16, 8), (8, 4)], (0.5, 0.25))
    assert plan.inv2 == ((4.0, 16.0), (1.0, 4.0))
    assert plan.factor == (0.5 * (0.25 * 0.0625) / (0.25 + 0.0625),
                           0.5 * (1.0 * 0.25) / (1.0 + 0.25))
    z = torch.zeros(18, 10, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tmf.mg_down(plan, z, z)
