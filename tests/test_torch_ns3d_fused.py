"""The port's NS-3D step kernels K7 (PRE) and K8 (POST), run through their
plain versions on CPU tensors, against the JAX package's fused Pallas
kernels in interpret mode (make_fused_step_3d), at float64, parametrised
as tests/test_ns3d_fused.py::test_phase_parity_3d is (dcavity3d and canal3d
boundary sets x (16, 16, 16) and (12, 20, 28) grids).

Copies (the BC faces of u', v', w') and the maxima are checked bitwise;
F, G, H, rhs and the projected u'', v'', w'' to 1e-12 times the field's
scale max(1, max|x|): the association of every term is the same, the
compilers' fusion differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.ops import ns3d_fused as jnf3
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.ops import ns3d_fused as nf3
from pampi_tpu_torch.utils.params import Parameter

TOL = 1e-12
CASES = [
    ("dcavity3d", {}),
    ("canal3d", dict(bcLeft=3, bcRight=3, bcFront=2, bcBack=2)),
]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(a, b):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("problem,bckw", CASES, ids=["dcavity3d", "canal3d"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 20, 28)])
def test_pre_post_match_fused_interpret(problem, bckw, shape):
    km, jm, im = shape
    kw = dict(name=problem, imax=im, jmax=jm, kmax=km, re=100.0, gamma=0.9,
              gx=0.1, gy=-0.2, gz=0.05, **bckw)
    jparam, param = JParameter(**kw), Parameter(**kw)
    cfg = nf3.StepConfig3D.from_param(param)
    rng = np.random.default_rng(11)
    u, v, w, p = (rng.normal(size=(km + 2, jm + 2, im + 2)) for _ in range(4))
    dt = 0.011

    pre, post, pad3, unpad3, _h = jnf3.make_fused_step_3d(
        jparam, km, jm, im, cfg.dx, cfg.dy, cfg.dz, jnp.float64,
        interpret=True)
    offs = jnp.zeros((3,), jnp.int32)
    dt11 = jnp.full((1, 1), dt, jnp.float64)
    up, vp, wp, fp, gp, hp, rp = pre(offs, dt11, pad3(jnp.asarray(u)),
                                     pad3(jnp.asarray(v)),
                                     pad3(jnp.asarray(w)))
    up2, vp2, wp2, um, vm, wm = post(offs, dt11, up, vp, wp, fp, gp, hp,
                                     pad3(jnp.asarray(p)))

    tu, tv, tw = _t(u), _t(v), _t(w)
    tdt = torch.tensor(dt, dtype=torch.float64)
    f, g, h, rhs = nf3.ns3d_pre(tu, tv, tw, tdt, cfg)
    for a, b in ((tu, up), (tv, vp), (tw, wp)):
        assert np.array_equal(a.numpy(), np.asarray(unpad3(b)))
    for a, b in ((f, fp), (g, gp), (h, hp), (rhs, rp)):
        _close(a, unpad3(b))
    maxima = nf3.ns3d_post(tu, tv, tw, f, g, h, _t(p), tdt, cfg.dx, cfg.dy,
                           cfg.dz)
    for a, b in ((tu, up2), (tv, vp2), (tw, wp2)):
        _close(a, unpad3(b))
    for got, want, field in zip(maxima, (um, vm, wm), (tu, tv, tw)):
        assert float(got) == float(field.abs().max())
        assert abs(float(got) - float(want)) <= TOL * max(1.0, float(want))


def test_plain_versions_leave_inputs_alone():
    param = Parameter(name="dcavity3d", imax=6, jmax=5, kmax=4)
    cfg = nf3.StepConfig3D.from_param(param)
    rng = np.random.default_rng(2)
    fields = [_t(rng.normal(size=(6, 7, 8))) for _ in range(7)]
    before = [a.clone() for a in fields]
    dt = torch.tensor(0.01, dtype=torch.float64)
    nf3.ns3d_pre_plain(*fields[:3], dt, cfg)
    nf3.ns3d_post_plain(*fields, dt, cfg.dx, cfg.dy, cfg.dz)
    for a, b in zip(fields, before):
        assert torch.equal(a, b)


def test_step_coefficients_formed_like_jax():
    param = Parameter(name="canal3d", imax=12, jmax=10, kmax=8, re=37.0,
                      gamma=0.7, gx=0.1, gy=0.2, gz=0.3, xlength=3.0,
                      ylength=2.0, zlength=0.5, bcTop=2, bcBack=3)
    cfg = nf3.StepConfig3D.from_param(param)
    assert cfg.problem == "canal"
    assert list(cfg.bcs.items()) == [("top", 2), ("bottom", 1), ("left", 1),
                                     ("right", 1), ("front", 1), ("back", 3)]
    c = cfg.coefficients()
    dx, dy, dz = 3.0 / 12, 2.0 / 10, 0.5 / 8
    idx, idy, idz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    assert c == [idx * 0.25, 0.7 * idx * 0.25, idy * 0.25, 0.7 * idy * 0.25,
                 idz * 0.25, 0.7 * idz * 0.25, idx * idx, idy * idy,
                 idz * idz, 1.0 / 37.0, 0.1, 0.2, 0.3, dx, dy, dz]


def test_wrappers_refuse_other_devices():
    cfg = nf3.StepConfig3D.from_param(Parameter(name="dcavity3d"))
    z = torch.zeros(6, 6, 6, dtype=torch.float64, device="meta")
    dt = torch.zeros((), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        nf3.ns3d_pre(z, z, z, dt, cfg)
    with pytest.raises(ValueError):
        nf3.ns3d_post(z, z, z, z, z, z, z, dt, 0.1, 0.1, 0.1)


# the distributed mode: shards of 8³ of a 24³ grid at a low corner, an
# interior and a high corner position, and one on the high i and low k
# walls (the kernels see only the offsets and the global extents)
SHARD_OFFSETS = [(0, 0, 0), (8, 8, 8), (16, 16, 16), (0, 8, 16)]
H = 3  # FUSE_DEEP_HALO: the deep block has H - 1 = 2 more ghost layers


@pytest.mark.parametrize("problem,bckw", CASES, ids=["dcavity3d", "canal3d"])
@pytest.mark.parametrize("offs", SHARD_OFFSETS,
                         ids=["lo-corner", "interior", "hi-corner", "mixed"])
def test_distributed_mode_matches_fused_interpret(problem, bckw, offs):
    """K7/K8's distributed mode (plain versions) against the JAX kernels
    built for a shard (kl, jl, il, ext_pad = H - 1), on random deep and
    halo-1 blocks: the deep blocks after the BCs bitwise, F/G/H/rhs (on
    the halo-1 block) and u'', v'', w'' to 1e-12 of scale; the maxima
    bitwise against the port's own fields and, as on one device, to 1e-12
    against JAX's (the maximum can sit on a projected cell, whose last bit
    XLA's contracted multiply-adds move)."""
    G = (24, 24, 24)
    kl = jl = il = 8
    kw = dict(name=problem, imax=G[2], jmax=G[1], kmax=G[0], re=100.0,
              gamma=0.9, gx=0.1, gy=-0.2, gz=0.05, **bckw)
    jparam, param = JParameter(**kw), Parameter(**kw)
    cfg = nf3.StepConfig3D.from_param(param)
    rng = np.random.default_rng(sum(offs) + 5)
    deep = [rng.normal(size=(kl + 2 * H,) * 3) for _ in range(3)]
    ext = [rng.normal(size=(kl + 2,) * 3) for _ in range(7)]
    dt = 0.011
    pre, pad_d, unpad_d, _h = jnf3.make_fused_pre_3d(
        jparam, *G, cfg.dx, cfg.dy, cfg.dz, jnp.float64, kl=kl, jl=jl, il=il,
        ext_pad=H - 1, interpret=True)
    post, pad_e, unpad_e, _h = jnf3.make_fused_post_3d(
        jparam, *G, cfg.dx, cfg.dy, cfg.dz, jnp.float64, kl=kl, jl=jl, il=il,
        interpret=True)
    joffs = jnp.asarray(offs, jnp.int32)
    dt11 = jnp.full((1, 1), dt, jnp.float64)
    outs = [np.asarray(unpad_d(a)) for a in pre(
        joffs, dt11, *(pad_d(jnp.asarray(a)) for a in deep))]
    strip = (slice(H - 1, -(H - 1)),) * 3

    tu, tv, tw = (_t(a) for a in deep)
    tdt = torch.tensor(dt, dtype=torch.float64)
    f, g, h, rhs = nf3.ns3d_pre(tu, tv, tw, tdt, cfg, offs, G, H - 1)
    for a, b in zip((tu, tv, tw), outs[:3]):
        assert np.array_equal(a.numpy(), b)
    for a, b in zip((f, g, h, rhs), outs[3:]):
        _close(a, b[strip])

    jout = post(joffs, dt11, *(pad_e(jnp.asarray(a)) for a in ext))
    fields = [_t(a) for a in ext]
    maxima = nf3.ns3d_post(*fields, tdt, cfg.dx, cfg.dy, cfg.dz, offs, G)
    for a, b in zip(fields[:3], jout[:3]):
        _close(a, unpad_e(b))
    for got, want, field in zip(maxima, jout[3:], fields):
        assert float(got) == float(field.abs().max())
        assert abs(float(got) - float(want)) <= TOL * max(1.0, float(want))


def test_distributed_mode_at_offset_zero_is_the_single_device_call():
    """A one-shard mesh: the distributed mode on the deep block gives the
    single-device call's fields bitwise."""
    param = Parameter(name="dcavity3d", imax=10, jmax=8, kmax=6, re=100.0)
    cfg = nf3.StepConfig3D.from_param(param)
    rng = np.random.default_rng(9)
    u, v, w, p = (_t(rng.normal(size=(8, 10, 12))) for _ in range(4))
    dt = torch.tensor(0.01, dtype=torch.float64)
    single = [a.clone() for a in (u, v, w)]
    fs = nf3.ns3d_pre(*single, dt, cfg)
    deep = [torch.nn.functional.pad(a, (H - 1,) * 6) for a in (u, v, w)]
    fd = nf3.ns3d_pre(*deep, dt, cfg, (0, 0, 0), (6, 8, 10), H - 1)
    for a, b in zip(single, deep):
        assert torch.equal(a, b[(slice(H - 1, -(H - 1)),) * 3])
    for a, b in zip(fs, fd):
        assert torch.equal(a, b)
    ms = nf3.ns3d_post(*single, *fs[:3], p, dt, cfg.dx, cfg.dy, cfg.dz)
    ud = [b[(slice(H - 1, -(H - 1)),) * 3].clone() for b in deep]
    md = nf3.ns3d_post(*ud, *fd[:3], p, dt, cfg.dx, cfg.dy, cfg.dz,
                       (0, 0, 0), (6, 8, 10))
    for a, b in zip(single, ud):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(ms, md))
