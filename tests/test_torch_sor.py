"""The port's red-black SOR kernels K1 (quarters) and K2 (checkerboard),
run through their plain versions on CPU tensors, against the JAX package:
the interpret-mode Pallas kernels and the jnp oracles, at float64.

Tolerances: fields atol 1e-13 and the residual rtol 1e-11, because fma
contraction and the order of the r² reduction differ between XLA and ATen;
ghost strips are copies and come out equal to that bound as well."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.models.poisson import make_rb_step
from pampi_tpu.ops import sor_pallas as sp
from pampi_tpu.ops import sor_quarters as jq
from pampi_tpu_torch.models.poisson import resolve_layout
from pampi_tpu_torch.ops import sor_kernels as sk
from pampi_tpu_torch.ops.sor_quarters import (
    pack_quarters,
    rb_iter_quarters,
    stack_quarters,
    unpack_quarters,
    unstack_quarters,
)

OMEGA = 1.9
ATOL = 1e-13
RTOL_RES = 1e-11


def _fields(jmax, imax, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(jmax + 2, imax + 2)),
            rng.normal(size=(jmax + 2, imax + 2)))


def _coef(jmax, imax):
    return 1.0 / imax, 1.0 / jmax, sk.sor_coefficients(1.0 / imax, 1.0 / jmax,
                                                       OMEGA)


@pytest.mark.parametrize("shape", [(16, 24), (17, 23)])
@pytest.mark.parametrize("n_inner", [1, 4])
def test_checkerboard_matches_tblock_interpret(shape, n_inner):
    jmax, imax = shape
    dx, dy, (fac, idx2, idy2) = _coef(jmax, imax)
    p, rhs = _fields(jmax, imax)
    rb, br, h = sp.make_rb_iter_tblock(imax, jmax, dx, dy, OMEGA, jnp.float64,
                                       n_inner=n_inner, interpret=True)
    pj, rj = sp.pad_array(jnp.asarray(p), br, h), sp.pad_array(
        jnp.asarray(rhs), br, h)
    pt, rt = torch.from_numpy(p.copy()), torch.from_numpy(rhs)
    for _ in range(2):  # ghost state carried across calls
        pj, rsq_j = rb(pj, rj)
        rsq_t = sk.rb_sor_checkerboard(pt, rt, n_inner, fac, idx2, idy2)
        np.testing.assert_allclose(
            pt.numpy(), np.asarray(sp.unpad_array(pj, jmax, imax, h)),
            rtol=0, atol=ATOL)
        np.testing.assert_allclose(float(rsq_t), float(rsq_j), rtol=RTOL_RES)


@pytest.mark.parametrize("shape", [(16, 24), (17, 23)])
@pytest.mark.parametrize("n_inner", [1, 4])
def test_checkerboard_matches_jnp_step(shape, n_inner):
    jmax, imax = shape
    dx, dy, (fac, idx2, idy2) = _coef(jmax, imax)
    p, rhs = _fields(jmax, imax, seed=1)
    step = make_rb_step(imax, jmax, dx, dy, OMEGA, jnp.float64, backend="jnp")
    pj, rj = jnp.asarray(p), jnp.asarray(rhs)
    pt, rt = torch.from_numpy(p.copy()), torch.from_numpy(rhs)
    for _ in range(2):
        for _ in range(n_inner):
            pj, res_j = step(pj, rj)
        rsq_t = sk.rb_sor_checkerboard(pt, rt, n_inner, fac, idx2, idy2)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(float(rsq_t) / (imax * jmax),
                                   float(res_j), rtol=RTOL_RES)


@pytest.mark.parametrize("n_inner", [1, 4])
def test_quarters_matches_tblock_quarters_interpret(n_inner):
    jmax, imax = 16, 24
    dx, dy, (fac, idx2, idy2) = _coef(jmax, imax)
    p, rhs = _fields(jmax, imax, seed=2)
    rb, brq, h = sp.make_rb_iter_tblock_quarters(
        imax, jmax, dx, dy, OMEGA, jnp.float64, n_inner=n_inner,
        interpret=True)
    qj = sp.pad_quarters(jnp.asarray(p), brq, h)
    fj = sp.pad_quarters(jnp.asarray(rhs), brq, h)
    qt = stack_quarters(torch.from_numpy(p))
    ft = stack_quarters(torch.from_numpy(rhs))
    for _ in range(2):
        qj, rsq_j = rb(qj, fj)
        rsq_t = sk.rb_sor_quarters(qt, ft, n_inner, fac, idx2, idy2)
        np.testing.assert_allclose(
            unstack_quarters(qt).numpy(),
            np.asarray(sp.unpad_quarters(qj, jmax, imax, h)), rtol=0,
            atol=ATOL)
        np.testing.assert_allclose(float(rsq_t), float(rsq_j), rtol=RTOL_RES)


@pytest.mark.parametrize("n_inner", [1, 4])
def test_quarters_matches_jnp_rb_iter_quarters(n_inner):
    jmax, imax = 16, 24
    _dx, _dy, (fac, idx2, idy2) = _coef(jmax, imax)
    p, rhs = _fields(jmax, imax, seed=3)
    qj = jq.pack_quarters(jnp.asarray(p))
    fj = jq.pack_quarters(jnp.asarray(rhs))
    qt = stack_quarters(torch.from_numpy(p))
    ft = stack_quarters(torch.from_numpy(rhs))
    for _ in range(2):
        for _ in range(n_inner):
            qj, rsq_j = jq.rb_iter_quarters(qj, fj, fac, idx2, idy2)
        rsq_t = sk.rb_sor_quarters(qt, ft, n_inner, fac, idx2, idy2)
        np.testing.assert_allclose(
            unstack_quarters(qt).numpy(), np.asarray(jq.unpack_quarters(*qj)),
            rtol=0, atol=ATOL)
        np.testing.assert_allclose(float(rsq_t), float(rsq_j), rtol=RTOL_RES)


def test_rb_iter_quarters_matches_jax_one_iteration():
    jmax, imax = 16, 24
    _dx, _dy, (fac, idx2, idy2) = _coef(jmax, imax)
    p, rhs = _fields(jmax, imax, seed=4)
    qj, rsq_j = jq.rb_iter_quarters(jq.pack_quarters(jnp.asarray(p)),
                                    jq.pack_quarters(jnp.asarray(rhs)),
                                    fac, idx2, idy2)
    pt = torch.from_numpy(p.copy())
    planes = pack_quarters(pt)  # strided views: the update lands in pt
    rsq_t = rb_iter_quarters(planes, pack_quarters(torch.from_numpy(rhs)),
                             fac, idx2, idy2)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jq.unpack_quarters(*qj)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(rsq_t), float(rsq_j), rtol=RTOL_RES)


def test_quarter_packing_round_trip_matches_jax():
    p, _ = _fields(16, 24, seed=5)
    q = stack_quarters(torch.from_numpy(p))
    for a, b in zip(q, jq.pack_quarters(jnp.asarray(p))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(unstack_quarters(q), torch.from_numpy(p))
    assert torch.equal(unpack_quarters(*q.unbind(0)), torch.from_numpy(p))


def test_layout_policy():
    assert resolve_layout(24, 16) == "quarters"
    assert resolve_layout(23, 16) == "checkerboard"
    assert resolve_layout(24, 16, "checkerboard") == "checkerboard"
    with pytest.raises(ValueError):
        resolve_layout(23, 17, "quarters")
    with pytest.raises(ValueError):
        resolve_layout(24, 16, "octants")


def test_wrappers_refuse_other_devices():
    p = torch.zeros(18, 26, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        sk.rb_sor_checkerboard(p, p, 1, 0.1, 1.0, 1.0)
    q = torch.zeros(4, 9, 13, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        sk.rb_sor_quarters(q, q, 1, 0.1, 1.0, 1.0)
