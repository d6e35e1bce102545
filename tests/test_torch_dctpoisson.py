"""The port's DCT direct solve (ops/dctpoisson.py) on the CPU against the
JAX package, float64: the matrices and eigenvalues bitwise, the interior
solves at 24x40 and 12x16x20 to 1e-12 of scale (the dense matrix
products sum in another order), and the solve contract (it = 1, res the
returned field's residual) to 1e-12. Half precision and TF32 products are
refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.ops import dctpoisson as jdct
from pampi_tpu_torch.ops import dctpoisson as tdct

TOL = 1e-12


def _close(a, b, tol=TOL):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(np.asarray(a) - b).max()) <= tol * scale


def _rhs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def test_matrices_and_eigenvalues_match_jax():
    for n in (1, 5, 24, 40):
        assert np.array_equal(tdct.dct2_matrix(n), jdct.dct2_matrix(n))
        assert np.array_equal(tdct.neumann_eigenvalues(n, 0.03),
                              jdct.neumann_eigenvalues(n, 0.03))


def test_poisson_dct_2d_matches_jax():
    r = _rhs((24, 40), 0)
    dx, dy = 1.0 / 40, 2.0 / 24
    ours = tdct.poisson_dct_2d(torch.from_numpy(r), dx, dy)
    _close(ours.numpy(), jdct.poisson_dct_2d(jnp.asarray(r), dx, dy))
    # the zero mode is 0: the solution has zero mean
    assert abs(float(ours.mean())) <= TOL


def test_poisson_dct_3d_matches_jax():
    r = _rhs((12, 16, 20), 1)
    dx, dy, dz = 1.0 / 20, 1.0 / 16, 0.5 / 12
    ours = tdct.poisson_dct_3d(torch.from_numpy(r), dx, dy, dz)
    _close(ours.numpy(), jdct.poisson_dct_3d(jnp.asarray(r), dx, dy, dz))


@pytest.mark.parametrize("dims", [(40, 24), (20, 16, 12)],
                         ids=["2d", "3d"])
def test_dct_solve_contract_matches_jax(dims):
    full = tuple(n + 2 for n in reversed(dims))
    rhs = np.zeros(full)
    inner = (slice(1, -1),) * len(dims)
    rhs[inner] = _rhs(tuple(reversed(dims)), 2)
    rhs[inner] -= rhs[inner].mean()
    p0 = _rhs(full, 3)  # ignored by a direct solve
    sp = tuple(1.0 / n for n in dims)
    if len(dims) == 2:
        ours = tdct.make_dct_solve_2d(*dims, *sp, torch.float64,
                                      device="cpu")
        theirs = jdct.make_dct_solve_2d(*dims, *sp, jnp.float64)
    else:
        ours = tdct.make_dct_solve_3d(*dims, *sp, torch.float64,
                                      device="cpu")
        theirs = jdct.make_dct_solve_3d(*dims, *sp, jnp.float64)
    p, res, it = ours(torch.from_numpy(p0), torch.from_numpy(rhs))
    jp, jres, jit = theirs(jnp.asarray(p0), jnp.asarray(rhs))
    assert it == int(jit) == 1
    assert abs(res - float(jres)) <= TOL and res <= TOL
    _close(p.numpy(), jp)


def test_half_precision_and_tf32_refused():
    with pytest.raises(ValueError, match="float32/float64"):
        tdct.make_dct_solve_2d(8, 8, 0.1, 0.1, torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="float32/float64"):
        tdct.make_dct_solve_3d(8, 8, 8, 0.1, 0.1, 0.1, torch.float16,
                               device="cpu")
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            tdct.make_dct_solve_2d(8, 8, 0.1, 0.1, torch.float32,
                                   device="cpu")
        # no TF32 in f64
        tdct.make_dct_solve_2d(8, 8, 0.1, 0.1, torch.float64, device="cpu")
    finally:
        torch.set_float32_matmul_precision(before)
    tdct.make_dct_solve_2d(8, 8, 0.1, 0.1, torch.float32, device="cpu")
