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


# The distributed mode: a shard's blocks at chosen offsets of a grid (the
# kernels see only the offsets and the global extents). Divisible: 8x8
# shards of 24x24 at a low corner, an interior, a high corner and a mixed
# position. Ragged: 5x10 shards of 18x20 ((4, 2) mesh), the trailing ones
# holding the global ghost row and dead cells, and 3x16 shards of 18x16
# ((8, 1) mesh), whose last one is wholly dead.
H = 3  # FUSE_DEEP_HALO: the deep block has H - 1 = 2 more ghost layers
DIST_CASES = [
    ((24, 24), (8, 8), (0, 0)), ((24, 24), (8, 8), (8, 8)),
    ((24, 24), (8, 8), (16, 16)), ((24, 24), (8, 8), (0, 16)),
    ((18, 20), (5, 10), (15, 10)), ((18, 20), (5, 10), (15, 0)),
    ((18, 20), (5, 10), (10, 10)), ((18, 16), (3, 16), (18, 0)),
    ((18, 16), (3, 16), (21, 0)),
]
DIST_IDS = ["lo", "interior", "hi", "mixed", "ragged-hi", "ragged-lo-i",
            "ragged-hi-i", "ghost-row-shard", "dead-shard"]


@pytest.mark.parametrize("problem,bcs", CASES)
@pytest.mark.parametrize("G,local,offs", DIST_CASES, ids=DIST_IDS)
def test_distributed_mode_matches_fused_interpret(problem, bcs, G, local,
                                                  offs):
    """K3/K4's distributed mode (plain versions) against the JAX kernels
    built for a shard (jl, il, ext_pad = H - 1; POST ragged where the
    grid is), on random deep and halo-1 blocks: the deep blocks after the
    BCs bitwise; F, G, rhs and u'', v'' to 1e-13 of scale (the fma class
    of the single-device test above); the maxima bitwise against the
    port's own fields and to 1e-12 against JAX's."""
    jmax, imax = G
    jl, il = local
    ragged = jmax % jl != 0 or imax % il != 0
    kw = dict(name=problem, imax=imax, jmax=jmax, re=100.0, gamma=0.9,
              gx=0.1, gy=-0.2, ylength=2.0, bcLeft=bcs[0], bcRight=bcs[1],
              bcBottom=bcs[2], bcTop=bcs[3])
    jparam, param = JParameter(**kw), Parameter(**kw)
    cfg = nf.StepConfig.from_param(param)
    rng = np.random.default_rng(sum(offs) + 3 * bcs[0])
    deep = [rng.normal(size=(jl + 2 * H, il + 2 * H)) for _ in range(2)]
    ext = [rng.normal(size=(jl + 2, il + 2)) for _ in range(5)]
    dt = 0.011
    pre, pad_d, unpad_d, _h = jnf.make_fused_pre_2d(
        jparam, jmax, imax, cfg.dx, cfg.dy, jnp.float64, jl=jl, il=il,
        ext_pad=H - 1, prof_dtype=jnp.float64, interpret=True)
    post, pad_e, unpad_e, _h = jnf.make_fused_post_2d(
        jparam, jmax, imax, cfg.dx, cfg.dy, jnp.float64, jl=jl, il=il,
        ragged=ragged, interpret=True)
    joffs = jnp.asarray(offs, jnp.int32)
    dt11 = jnp.full((1, 1), dt, jnp.float64)
    outs = [np.asarray(unpad_d(a)) for a in pre(
        joffs, dt11, *(pad_d(jnp.asarray(a)) for a in deep))]
    strip = (slice(H - 1, -(H - 1)),) * 2

    tu, tv = (_t(a) for a in deep)
    tdt = torch.tensor(dt, dtype=torch.float64)
    f, g, rhs = nf.ns2d_pre(tu, tv, tdt, cfg, offs, G, H - 1)
    for a, b in zip((tu, tv), outs[:2]):
        assert np.array_equal(a.numpy(), b)
    for a, b in zip((f, g, rhs), outs[2:]):
        _close(a, b[strip])

    jout = post(joffs, dt11, *(pad_e(jnp.asarray(a)) for a in ext))
    fields = [_t(a) for a in ext]
    maxima = nf.ns2d_post(*fields, tdt, cfg.dx, cfg.dy, offs, G, ragged)
    for a, b in zip(fields[:2], jout[:2]):
        _close(a, unpad_e(b))
    for got, want in zip(maxima, jout[2:]):
        assert abs(float(got) - float(want)) <= 1e-12 * max(1.0, float(want))
    gj, gi = ops.index_grids_2d(fields[0].shape, 0, offs)
    valid = (gj <= jmax + 1) & (gi <= imax + 1)
    for got, field in zip(maxima, fields[:2]):
        assert float(got) == float(torch.where(valid, field.abs(), 0).max())


@pytest.mark.parametrize("problem,bcs", CASES)
def test_distributed_mode_at_offset_zero_is_the_single_device_call(problem,
                                                                   bcs):
    """A one-shard mesh: the distributed mode on the deep block gives the
    single-device call's fields bitwise."""
    jparam, param, u, v, p = _setup(problem, bcs, seed=9)
    cfg = nf.StepConfig.from_param(param)
    dt = torch.tensor(0.01, dtype=torch.float64)
    single = [_t(u), _t(v)]
    fs = nf.ns2d_pre(*single, dt, cfg)
    deep = [torch.nn.functional.pad(_t(a), (H - 1,) * 4) for a in (u, v)]
    fd = nf.ns2d_pre(*deep, dt, cfg, (0, 0), (JMAX, IMAX), H - 1)
    for a, b in zip(single, deep):
        assert torch.equal(a, b[(slice(H - 1, -(H - 1)),) * 2])
    for a, b in zip(fs, fd):
        assert torch.equal(a, b)
    ms = nf.ns2d_post(*single, *fs[:2], _t(p), dt, cfg.dx, cfg.dy)
    ud = [b[(slice(H - 1, -(H - 1)),) * 2].clone() for b in deep]
    md = nf.ns2d_post(*ud, *fd[:2], _t(p), dt, cfg.dx, cfg.dy, (0, 0),
                      (JMAX, IMAX))
    for a, b in zip(single, ud):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(ms, md))


def test_distributed_mode_refuses_a_flat_block():
    cfg = nf.StepConfig.from_param(Parameter(name="dcavity"))
    z = torch.zeros(8, 8, dtype=torch.float64)
    dt = torch.zeros((), dtype=torch.float64)
    with pytest.raises(ValueError, match="deep block"):
        nf.ns2d_pre(z, z, dt, cfg, (0, 0), (6, 6), 0)
    with pytest.raises(ValueError, match="offsets"):
        nf.ns2d_pre(z, z, dt, cfg, None, None, 1)
