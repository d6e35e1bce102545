"""The port's Poisson solver on the CPU against the JAX package:
configs/poisson.par (100², float64) converges in exactly the JAX
iteration count, 2388, and writes the same p.dat; the convergence loop
keeps the JAX package's n_inner and flat iteration accounting."""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.models import poisson as jpoisson
from pampi_tpu.ops import sor_pallas as sp
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch.models import poisson as tpoisson
from pampi_tpu_torch.utils.datio import read_matrix
from pampi_tpu_torch.utils.params import parameter_from_dict, read_parameter

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def _lines(path):
    return [ln.split() for ln in path.read_text().splitlines()]


def test_poisson_par_iterations_and_p_dat_match_jax(tmp_path):
    par = str(CONFIGS / "poisson.par")
    js = jpoisson.PoissonSolver(jread_parameter(par))
    j_it, _j_res = js.solve()
    js.write_result(str(tmp_path / "p_jax.dat"))

    ts = tpoisson.PoissonSolver(read_parameter(par), device="cpu")
    t_it, t_res = ts.solve()
    ts.write_result(str(tmp_path / "p_torch.dat"))

    assert j_it == 2388
    assert t_it == 2388
    assert t_res < 1e-12  # eps² = 1e-12
    jl, tl = _lines(tmp_path / "p_jax.dat"), _lines(tmp_path / "p_torch.dat")
    assert [len(r) for r in jl] == [len(r) for r in tl] == [102] * 102
    diff = np.abs(read_matrix(str(tmp_path / "p_jax.dat"))
                  - read_matrix(str(tmp_path / "p_torch.dat")))
    assert diff.max() <= 1e-10


def test_init_fields_match_jax():
    jparam = jread_parameter(str(CONFIGS / "poisson.par")).replace(
        imax=24, jmax=16)
    param = parameter_from_dict(dataclasses.asdict(jparam))
    for problem in (1, 2):
        jp, jr = jpoisson.init_fields(jparam, problem, jnp.float64)
        tp, tr = tpoisson.init_fields(param, problem, torch.float64)
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert np.array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("n_inner", [1, 4])
def test_padded_solver_matches_jax_fold(n_inner):
    """The checkerboard solve, the port's counterpart of the folded
    p-layout, against the JAX folded solve (make_padded_solver_fn, tblock
    kernel, interpret): same iteration count, same field."""
    imax, jmax, eps, itermax = 24, 16, 1e-3, 60
    dx, dy = 1.0 / imax, 1.0 / jmax
    rng = np.random.default_rng(0)
    p, rhs = rng.normal(size=(2, jmax + 2, imax + 2))
    jsolve, br, h = jpoisson.make_padded_solver_fn(
        imax, jmax, dx, dy, 1.7, eps, itermax, jnp.float64, n_inner=n_inner,
        interpret=True)
    jp, jres, jit = jsolve(sp.pad_array(jnp.asarray(p), br, h),
                           sp.pad_array(jnp.asarray(rhs), br, h))
    tsolve = tpoisson.make_solver_fn(imax, jmax, dx, dy, 1.7, eps, itermax,
                                     torch.float64, n_inner=n_inner,
                                     layout="checkerboard")
    tp, tres, tit = tsolve(torch.from_numpy(p.copy()), torch.from_numpy(rhs))
    assert tit == int(jit)
    np.testing.assert_allclose(tres, float(jres), rtol=1e-11)
    np.testing.assert_allclose(
        tp.numpy(), np.asarray(sp.unpad_array(jp, jmax, imax, h)), rtol=0,
        atol=1e-13)


@pytest.mark.parametrize("layout", ["quarters", "checkerboard"])
def test_flat_solve_runs_ceil_itermax_over_inner(layout):
    solve = tpoisson.make_solver_fn(24, 16, 1 / 24, 1 / 16, 1.7, 1.0, 10,
                                    torch.float64, n_inner=4, layout=layout,
                                    flat=True)
    p = torch.zeros(18, 26, dtype=torch.float64)
    _p, res, it = solve(p, torch.ones_like(p))
    assert it == 12 and res > 0.0


@pytest.mark.parametrize("n_inner", [1, 3, 4])
def test_iteration_count_advances_by_n_inner(n_inner):
    imax = jmax = 16
    p0, rhs = tpoisson.init_fields(
        read_parameter(str(CONFIGS / "poisson.par")).replace(imax=imax,
                                                             jmax=jmax))
    solve = tpoisson.make_solver_fn(imax, jmax, 1 / imax, 1 / jmax, 1.9, 1e-6,
                                    10**6, torch.float64, n_inner=n_inner)
    _p, _res, it = solve(p0.clone(), rhs)
    one = tpoisson.make_solver_fn(imax, jmax, 1 / imax, 1 / jmax, 1.9, 1e-6,
                                  10**6, torch.float64, n_inner=1)
    _p, _res, it1 = one(p0.clone(), rhs)
    assert it % n_inner == 0
    assert it1 <= it < it1 + n_inner


def test_refused_options_name_the_roadmap():
    base = read_parameter(str(CONFIGS / "poisson.par"))
    # tpu_dtype bfloat16 runs since its quarters solve is ported; its
    # refused paths are tests/test_torch_bf16.py's
    for kw in (dict(tpu_solver="sor_rba"), dict(tpu_solver="sor_lex"),
               dict(tpu_mesh="2x2", tpu_solver="mg")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpoisson.PoissonSolver(base.replace(**kw), device="cpu")
    # an obstacles key is no unported option: Poisson refuses it with the
    # JAX CLI's error
    with pytest.raises(ValueError, match="supported for NS problems only"):
        tpoisson.PoissonSolver(base.replace(obstacles="0.1,0.1,0.2,0.2"),
                               device="cpu")
