"""The port's NS-2D step kernels K3 (PRE) and K4 (POST), run through their
plain versions on CPU tensors, against the JAX package's fused Pallas
kernels in interpret mode (make_fused_step_2d) and its jnp phase chain, at
float64 on a 16x24 grid.

Copies (the BC strips of u', v') and the maxima are checked bitwise;
F, G, rhs and the projected u'', v'' to 1e-13 times the field's scale
max(1, max|x|) (fma contraction differs between XLA and ATen; the
association of every term is the same; rhs is O(1e3) here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.ops import ns2d as jops
from pampi_tpu.ops import ns2d_fused as jnf
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.ops import ns2d as ops
from pampi_tpu_torch.ops import ns2d_fused as nf
from pampi_tpu_torch.utils.params import Parameter

JMAX, IMAX = 16, 24
ATOL = 1e-13
CASES = [
    ("dcavity", (1, 1, 1, 1)),
    ("canal", (3, 3, 1, 1)),
    ("dcavity", (2, 2, 2, 2)),
    ("canal", (3, 1, 2, 1)),
]


def _setup(problem, bcs, seed=7):
    kw = dict(name=problem, imax=IMAX, jmax=JMAX, re=100.0, gamma=0.9,
              gx=0.1, gy=-0.2, bcLeft=bcs[0], bcRight=bcs[1],
              bcBottom=bcs[2], bcTop=bcs[3])
    rng = np.random.default_rng(seed)
    u, v, p = (rng.normal(size=(JMAX + 2, IMAX + 2)) for _ in range(3))
    return JParameter(**kw), Parameter(**kw), u, v, p


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _run_port(param, u, v, p, dt):
    cfg = nf.StepConfig.from_param(param)
    ut, vt = _t(u), _t(v)
    dtt = torch.tensor(dt, dtype=torch.float64)
    f, g, rhs = nf.ns2d_pre(ut, vt, dtt, cfg)
    u1, v1 = ut.clone(), vt.clone()
    umax, vmax = nf.ns2d_post(ut, vt, f, g, _t(p), dtt, cfg.dx, cfg.dy)
    return u1, v1, f, g, rhs, ut, vt, umax, vmax


def _close(a, b):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("problem,bcs", CASES)
def test_pre_post_match_fused_interpret(problem, bcs):
    jparam, param, u, v, p = _setup(problem, bcs)
    dt = 0.013
    dx, dy = 1.0 / IMAX, 1.0 / JMAX
    pre, post, pad, unpad, _h = jnf.make_fused_step_2d(
        jparam, JMAX, IMAX, dx, dy, jnp.float64, interpret=True)
    offs = jnp.zeros((2,), jnp.int32)
    dt11 = jnp.full((1, 1), dt, jnp.float64)
    up, vp, fp, gp, rp = pre(offs, dt11, pad(jnp.asarray(u)),
                             pad(jnp.asarray(v)))
    up2, vp2, um, vm = post(offs, dt11, up, vp, fp, gp, pad(jnp.asarray(p)))

    u1, v1, f, g, rhs, u2, v2, umax, vmax = _run_port(param, u, v, p, dt)
    assert np.array_equal(u1.numpy(), np.asarray(unpad(up)))
    assert np.array_equal(v1.numpy(), np.asarray(unpad(vp)))
    _close(f, unpad(fp))
    _close(g, unpad(gp))
    _close(rhs, unpad(rp))
    _close(u2, unpad(up2))
    _close(v2, unpad(vp2))
    assert float(umax) == float(um)
    assert float(vmax) == float(vm)


@pytest.mark.parametrize("problem,bcs", CASES)
def test_pre_post_match_jnp_chain(problem, bcs):
    jparam, param, u, v, p = _setup(problem, bcs, seed=8)
    dt = 0.009
    dx, dy = 1.0 / IMAX, 1.0 / JMAX
    ju, jv = jops.set_boundary_conditions(jnp.asarray(u), jnp.asarray(v),
                                          *bcs)
    if problem == "dcavity":
        ju = jops.set_special_bc_dcavity(ju)
    else:
        ju = jops.set_special_bc_canal(ju, dy, jparam.ylength, jnp.float64)
    jdt = jnp.asarray(dt)
    jf, jg = jops.compute_fg(ju, jv, jdt, jparam.re, jparam.gx, jparam.gy,
                             jparam.gamma, dx, dy)
    jr = jops.compute_rhs(jf, jg, jdt, dx, dy)
    ju2, jv2 = jops.adapt_uv(ju, jv, jf, jg, jnp.asarray(p), jdt, dx, dy)

    u1, v1, f, g, rhs, u2, v2, umax, vmax = _run_port(param, u, v, p, dt)
    assert np.array_equal(u1.numpy(), np.asarray(ju))
    assert np.array_equal(v1.numpy(), np.asarray(jv))
    _close(f, jf)
    _close(g, jg)
    _close(rhs, jr)
    _close(u2, ju2)
    _close(v2, jv2)
    assert float(umax) == float(jops.max_element(ju2))
    assert float(vmax) == float(jops.max_element(jv2))


def test_cfl_dt_matches_jax():
    for um, vm in ((0.0, 0.0), (1.3, 0.0), (0.7, 2.9), (3.0, 1e-9)):
        j = jops.cfl_dt(jnp.asarray(um), jnp.asarray(vm), 0.02, 0.01, 0.02,
                        0.5)
        t = ops.cfl_dt(torch.tensor(um, dtype=torch.float64),
                       torch.tensor(vm, dtype=torch.float64), 0.02, 0.01,
                       0.02, 0.5)
        assert float(t) == float(j)


def test_normalize_pressure_matches_jax():
    p = np.random.default_rng(9).normal(size=(JMAX + 2, IMAX + 2))
    np.testing.assert_allclose(ops.normalize_pressure(_t(p)).numpy(),
                               np.asarray(jops.normalize_pressure(
                                   jnp.asarray(p))), rtol=0, atol=1e-15)


def test_step_coefficients_formed_like_jax():
    param = Parameter(name="canal", imax=IMAX, jmax=JMAX, re=37.0,
                      gamma=0.7, gx=0.1, gy=0.2, ylength=2.0)
    c = nf.StepConfig.from_param(param).coefficients()
    idx, idy = 1.0 / (1.0 / IMAX), 1.0 / (2.0 / JMAX)
    assert c[:7] == [idx * 0.25, 0.7 * idx * 0.25, idy * 0.25,
                     0.7 * idy * 0.25, idx * idx, idy * idy, 1.0 / 37.0]
    assert c[7:] == [0.1, 0.2, 1.0 / IMAX, 2.0 / JMAX, 2.0, 4.0]


def test_wrappers_refuse_other_devices():
    cfg = nf.StepConfig.from_param(Parameter(name="dcavity"))
    z = torch.zeros(4, 4, dtype=torch.float64, device="meta")
    dt = torch.zeros((), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        nf.ns2d_pre(z, z, dt, cfg)
    with pytest.raises(ValueError):
        nf.ns2d_post(z, z, z, z, z, dt, 0.1, 0.1)
