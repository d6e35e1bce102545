"""Kernel K17's plain version (ops/sor_kernels.rb_sor_blocked_plain)
through the port's make_rb_step_padded against the JAX package's, on the
CPU: kernel="blocked" against JAX's interpret-mode _rb_kernel (B.5) on the
shapes and tolerances of tests/test_sor_pallas.py (fields 1e-13, the
residual 1e-12 relative; XLA contracts the interpret kernel's
multiply-adds, so not bitwise), its multi-block case (16-row bands over
102 rows, a ragged tail band), and "fused"/"tblock" (K2) against JAX's
interpret tblock kernel. K17's fields equal K2's at n_inner 1 bit for bit,
and its residual is its own fixed summation order (per-band partials,
then the one-block sum), written out here in numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.models.poisson import init_fields as jinit_fields
from pampi_tpu.models.poisson import make_rb_step as jmake_rb_step
from pampi_tpu.models.poisson import make_rb_step_padded as jmake_padded
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.models.poisson import make_rb_step_padded
from pampi_tpu_torch.ops import sor_kernels as sk

CPU = torch.device("cpu")


def _fields(imax, jmax):
    p0, rhs = jinit_fields(JParameter(imax=imax, jmax=jmax), problem=2,
                           dtype=jnp.float64)
    return np.array(p0), np.array(rhs)


@pytest.mark.parametrize("shape", [(32, 32), (100, 100), (64, 32), (48, 96)])
def test_blocked_step_matches_jax_interpret(shape):
    imax, jmax = shape
    dx, dy = 1.0 / imax, 1.0 / jmax
    p0, rhs = _fields(imax, jmax)
    jstep, jpad, junpad = jmake_padded(imax, jmax, dx, dy, 1.9, jnp.float64,
                                       interpret=True, kernel="blocked")
    step, pad, unpad = make_rb_step_padded(imax, jmax, dx, dy, 1.9,
                                           torch.float64, kernel="blocked",
                                           device=CPU)
    jp, jr = jpad(jnp.asarray(p0)), jpad(jnp.asarray(rhs))
    p, r = pad(torch.from_numpy(p0)), pad(torch.from_numpy(rhs))
    for _ in range(3):
        jp, jres = jstep(jp, jr)
        p, res = step(p, r)
        np.testing.assert_allclose(unpad(p).numpy(), np.asarray(junpad(jp)),
                                   rtol=0, atol=1e-13)
        np.testing.assert_allclose(float(res), float(jres), rtol=1e-12)


def test_blocked_multiblock_matches_jax():
    """JAX's kernel over 16-row bands (102 rows: a ragged tail band)
    against K17's plain version (8-row bands): the halo rows, the in-place
    write-back and the tail handling cross band boundaries on both sides;
    and both against the jnp red-black step."""
    from pampi_tpu.ops.sor_pallas import (
        make_rb_iter_pallas,
        neumann_bc_padded,
        pad_array,
        unpad_array,
    )

    imax, jmax = 64, 100
    dx, dy = 1.0 / imax, 1.0 / jmax
    p0, rhs = _fields(imax, jmax)
    rb16, _br = make_rb_iter_pallas(imax, jmax, dx, dy, 1.9, jnp.float64,
                                    block_rows=16, interpret=True)
    jp, rsq = rb16(pad_array(jnp.asarray(p0), 16),
                   pad_array(jnp.asarray(rhs), 16))
    jp = np.asarray(unpad_array(neumann_bc_padded(jp, jmax, imax), jmax,
                                imax))
    jstep = jmake_rb_step(imax, jmax, dx, dy, 1.9, jnp.float64,
                          backend="jnp")
    pj, resj = jstep(jnp.asarray(p0), jnp.asarray(rhs))
    step, pad, unpad = make_rb_step_padded(imax, jmax, dx, dy, 1.9,
                                           torch.float64, kernel="blocked",
                                           device=CPU)
    p, res = step(pad(torch.from_numpy(p0)), pad(torch.from_numpy(rhs)))
    np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=1e-13)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(float(res), float(rsq) / (imax * jmax),
                               rtol=1e-12)
    np.testing.assert_allclose(float(res), float(resj), rtol=1e-12)


@pytest.mark.parametrize("kernel,n_inner", [("fused", 1), ("tblock", 2)])
def test_k2_steps_match_jax_interpret(kernel, n_inner):
    imax, jmax = 48, 40
    dx, dy = 1.0 / imax, 1.0 / jmax
    p0, rhs = _fields(imax, jmax)
    jstep, jpad, junpad = jmake_padded(imax, jmax, dx, dy, 1.8, jnp.float64,
                                       interpret=True, kernel=kernel,
                                       n_inner=n_inner)
    step, pad, unpad = make_rb_step_padded(imax, jmax, dx, dy, 1.8,
                                           torch.float64, kernel=kernel,
                                           n_inner=n_inner, device=CPU)
    jp, jr = jpad(jnp.asarray(p0)), jpad(jnp.asarray(rhs))
    p, r = pad(torch.from_numpy(p0)), pad(torch.from_numpy(rhs))
    for _ in range(2):
        jp, jres = jstep(jp, jr)
        p, res = step(p, r)
    np.testing.assert_allclose(unpad(p).numpy(), np.asarray(junpad(jp)),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(float(res), float(jres), rtol=1e-12)


@pytest.mark.parametrize("shape", [(37, 29), (300, 12)])
def test_blocked_fields_are_k2s_and_residual_its_own_order(shape):
    """K17's plain iteration is K2's at n_inner 1, bit for bit; its
    residual is r² summed per CTA (BAND rows, tiles of TILE columns, each
    thread down its column tile by tile and row by row, then a halving
    tree) and then over the red and the black partials by one block."""
    imax, jmax = shape
    rng = np.random.default_rng(7)
    p0, rhs = (torch.from_numpy(rng.standard_normal((jmax + 2, imax + 2)))
               for _ in range(2))
    coef = sk.sor_coefficients(1.0 / imax, 1.0 / jmax, 1.7)
    pb, p2 = p0.clone(), p0.clone()
    r17 = sk.rb_sor_blocked(pb, rhs, *coef)
    r2 = sk.rb_sor_checkerboard(p2, rhs, 1, *coef)
    assert torch.equal(pb, p2)
    assert abs(float(r17) - float(r2)) <= 1e-12 * float(r2)
    # the order written out: the residuals of the two half-sweeps
    y, parts = p0.clone().numpy(), []
    factor, idx2, idy2 = coef
    for parity in (0, 1):
        c = y[1:-1, 1:-1]
        r = rhs.numpy()[1:-1, 1:-1] - (
            (y[1:-1, 2:] - 2.0 * c + y[1:-1, :-2]) * idx2
            + (y[2:, 1:-1] - 2.0 * c + y[:-2, 1:-1]) * idy2)
        jj, ii = np.meshgrid(np.arange(1, jmax + 1), np.arange(1, imax + 1),
                             indexing="ij")
        r = np.where((ii + jj) % 2 == parity, r, 0.0)
        y[1:-1, 1:-1] = c - factor * r
        nb = -(-(jmax + 2) // sk.BAND)
        nt = -(-imax // sk.TILE)
        for b in range(nb):
            acc = np.zeros(sk.TILE)
            for k in range(nt):
                for row in range(b * sk.BAND, (b + 1) * sk.BAND):
                    if 1 <= row <= jmax:
                        cols = r[row - 1, k * sk.TILE:(k + 1) * sk.TILE]
                        acc[:cols.size] = acc[:cols.size] + cols * cols
            st = sk.TILE // 2
            while st:
                acc = acc[:st] + acc[st:2 * st]
                st //= 2
            parts.append(acc[0])
    s = np.zeros(sk.FIN)
    for q, x in enumerate(parts):
        s[q % sk.FIN] = s[q % sk.FIN] + x
    st = sk.FIN // 2
    while st:
        s = s[:st] + s[st:2 * st]
        st //= 2
    assert float(r17) == float(s[0])


def test_step_rejects_unknown_kernel():
    with pytest.raises(ValueError, match="fused|tblock|blocked"):
        make_rb_step_padded(8, 8, 0.1, 0.1, 1.7, torch.float64,
                            kernel="quarters", device=CPU)
