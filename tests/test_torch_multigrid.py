"""The port's multigrid (ops/multigrid.py) on the CPU against the JAX
package, float64:

1. the level plan and its truncation on a table of extents;
2. one ladder V-cycle (tpu_mg_fused off) at 32² and 16³ with the bottom
   budget lowered (64 and 512 cells, as tests/test_mg_fused.py does) so the
   plans have 3 and 2 levels, to 1e-12 of scale; again with the port's
   large-level threshold at 0, so every level smooths through the K2/K5
   wrappers (their plain versions here);
3. the whole solve: the same V-cycle count and fields to 1e-10 at eps 1e-6;
4. the stall detector on an inconsistent Neumann rhs: the same early stop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.ops import multigrid as jmg
from pampi_tpu_torch.ops import multigrid as tmg
from pampi_tpu_torch.utils import dispatch

BUDGET = {2: 64, 3: 512}
N = {2: 32, 3: 16}


@pytest.fixture
def budget(monkeypatch):
    def lower(nd):
        monkeypatch.setattr(jmg, "_DCT_BOTTOM_MAX_CELLS", BUDGET[nd])
        monkeypatch.setattr(tmg, "_DCT_BOTTOM_MAX_CELLS", BUDGET[nd])
    return lower


def _close(a, b, tol):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(np.asarray(a) - b).max()) <= tol * scale


def _problem(nd, seed, consistent=True):
    """(p0, rhs, dims, spacings) on an n^nd grid: p0 random, rhs random on
    the interior (zero mean when consistent)."""
    n = N[nd]
    rng = np.random.default_rng(seed)
    full = (n + 2,) * nd
    rhs = np.zeros(full)
    inner = (slice(1, -1),) * nd
    rhs[inner] = rng.standard_normal((n,) * nd)
    if consistent:
        rhs[inner] -= rhs[inner].mean()
    p0 = rng.standard_normal(full)
    dims = (n,) * nd
    sp = tuple(1.0 / (n + 3 * a) for a in range(nd))  # non-square cells
    return p0, rhs, dims, sp


@pytest.mark.parametrize("extents", [
    (100, 100), (4096, 4096), (512, 512), (128, 128, 128), (64, 64, 64),
    (6, 8), (101, 100), (96, 64), (48, 32, 16)])
def test_level_plan_matches_jax(extents):
    for budget in (64, 512, 65536):
        plan = jmg._truncate_levels(jmg.mg_levels(*extents), budget)
        assert tmg._truncate_levels(tmg.mg_levels(*extents), budget) == plan
    assert tmg.mg_levels(*extents) == jmg.mg_levels(*extents)
    assert tmg._DCT_BOTTOM_MAX_CELLS == jmg._DCT_BOTTOM_MAX_CELLS
    assert tmg.MG_STALL_RTOL == jmg.MG_STALL_RTOL


def _vcycles(nd):
    if nd == 2:
        return tmg.make_mg_vcycle_2d, jmg.make_mg_vcycle_2d
    return tmg.make_mg_vcycle_3d, jmg.make_mg_vcycle_3d


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("threshold", [None, 0], ids=["plain", "kernels"])
def test_ladder_vcycle_matches_jax(nd, threshold, budget, monkeypatch):
    budget(nd)
    if threshold is not None:
        monkeypatch.setattr(tmg, "_KERNEL_SMOOTH_MIN_CELLS", threshold)
    p0, rhs, dims, sp = _problem(nd, 0)
    make_t, make_j = _vcycles(nd)
    ours = make_t(*reversed(dims), *sp, torch.float64, fused="off",
                  device="cpu")
    theirs = make_j(*reversed(dims), *sp, jnp.float64, fused="off")
    assert dispatch.last(f"mg{nd}d_fused") == "ladder (tpu_mg_fused off)"
    p = ours(torch.from_numpy(p0), torch.from_numpy(rhs))
    _close(p.numpy(), theirs(jnp.asarray(p0), jnp.asarray(rhs)), 1e-12)


def test_kernel_threshold_reaches_the_smoother_kernels(budget, monkeypatch):
    """With the threshold at 0 every ladder level calls the K2 wrapper."""
    from pampi_tpu_torch.ops import sor_kernels

    budget(2)
    calls = []
    plain = sor_kernels.rb_sor_checkerboard_plain
    monkeypatch.setattr(
        tmg, "rb_sor_checkerboard",
        lambda *a: calls.append(a[0].shape) or plain(*a))
    monkeypatch.setattr(tmg, "_KERNEL_SMOOTH_MIN_CELLS", 0)
    p0, rhs, dims, sp = _problem(2, 1)
    tmg.make_mg_vcycle_2d(*dims, *sp, torch.float64, fused="off",
                          device="cpu")(
        torch.from_numpy(p0), torch.from_numpy(rhs))
    assert calls == [(34, 34), (18, 18), (18, 18), (34, 34)]


def _solves(nd):
    if nd == 2:
        return tmg.make_mg_solve_2d, jmg.make_mg_solve_2d
    return tmg.make_mg_solve_3d, jmg.make_mg_solve_3d


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("fused", ["off", "on"])
def test_mg_solve_matches_jax(nd, fused, budget):
    """The port's ladder and fused cycle against the JAX ladder: the same
    V-cycle count to eps 1e-6, fields to 1e-10."""
    budget(nd)
    p0, rhs, dims, sp = _problem(nd, 2)
    make_t, make_j = _solves(nd)
    args = (*reversed(dims), *sp, 1e-6, 50)
    p, res, it = make_t(*args, torch.float64, fused=fused, device="cpu")(
        torch.from_numpy(p0), torch.from_numpy(rhs))
    jp, jres, jit = make_j(*args, jnp.float64)(jnp.asarray(p0),
                                               jnp.asarray(rhs))
    assert it == int(jit) and it >= 2
    # a converged r (~5e-7) keeps ~1e-13 of absolute round-off from the
    # stencil's cancellation, so Σr² agrees to ~1e-7 relative
    assert res < 1e-12 and abs(res - float(jres)) <= 1e-6 * float(jres)
    _close(p.numpy(), jp, 1e-10)


@pytest.mark.parametrize("nd", [2, 3])
def test_stall_stops_like_jax(nd, budget):
    """An inconsistent Neumann rhs floors the residual; at stall_rtol 1e-4
    both loops stop at the same cycle, long before itermax; with the
    detector off both run to itermax."""
    budget(nd)
    p0, rhs, dims, sp = _problem(nd, 3, consistent=False)
    make_t, make_j = _solves(nd)
    for rtol, itermax in ((1e-4, 200), (0, 12)):
        args = (*reversed(dims), *sp, 1e-6, itermax)
        _p, res, it = make_t(*args, torch.float64, stall_rtol=rtol, fused="off",
                              device="cpu")(
            torch.from_numpy(p0), torch.from_numpy(rhs))
        _jp, jres, jit = make_j(*args, jnp.float64, stall_rtol=rtol)(
            jnp.asarray(p0), jnp.asarray(rhs))
        assert it == int(jit), (rtol, it, int(jit))
        assert (it < itermax) == (rtol > 0)
        assert abs(res - float(jres)) <= 1e-10 * float(jres)


def test_stall_predicate():
    f32 = np.float32
    assert not tmg._stalled(f32(1.0), f32(1.0), 1)
    assert tmg._stalled(f32(1.0), f32(1.0), 2)
    assert not tmg._stalled(f32(1.0), f32(0.5), 5)
    assert not tmg._stalled(f32(1.0), f32(1.0), 5, rtol=0)
    assert tmg._stalled(f32(1.0), f32(1.0), 5, rtol=None)
