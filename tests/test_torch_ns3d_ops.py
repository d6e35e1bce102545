"""The port's plain NS-3D ops (pampi_tpu_torch/ops/ns3d.py) against the JAX
package's (pampi_tpu/ops/ns3d.py) at float64 on a 6x7x9 interior, inputs
from a numpy seed.

Copies (the BC faces, the special BCs, the wall fixups, the maxima) must
be bitwise; arithmetic (F/G/H, RHS, projection, CFL dt) agrees to 1e-12 of
the field's scale max(1, max|x|): the association of every term is the
same, only the compilers' fusion differs."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.ops import ns3d as jops
from pampi_tpu_torch.ops import ns3d as ops

SHAPE = (6 + 2, 7 + 2, 9 + 2)  # (kmax+2, jmax+2, imax+2)
DX, DY, DZ = 1.0 / 9, 2.0 / 7, 0.5 / 6
TOL = 1e-12
FACE_ORDER = ("top", "bottom", "left", "right", "front", "back")


def _fields(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE) for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(a, b):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=TOL * scale)


def _bitwise(a, b):
    assert np.array_equal(np.asarray(a), np.asarray(b))


# every kind on every face: kind k on face f for the 4 rotations of the
# kinds over the faces, plus a few mixed settings
_KIND_SETS = [tuple((f + r) % 4 + 1 for f in range(6)) for r in range(4)] + [
    (1, 1, 1, 1, 1, 1), (2, 2, 2, 2, 2, 2), (3, 3, 3, 3, 3, 3),
    (1, 1, 3, 3, 2, 2),
]


@pytest.mark.parametrize("kinds", _KIND_SETS)
def test_boundary_conditions_match_jax(kinds):
    u, v, w = _fields(3, seed=sum(kinds))
    bcs = dict(zip(FACE_ORDER, kinds))
    ju, jv, jw = jops.set_boundary_conditions_3d(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), bcs)
    tu, tv, tw = _t(u), _t(v), _t(w)
    pu, pv, pw = ops.set_boundary_conditions_3d(tu, tv, tw, bcs)
    for a, b in ((pu, ju), (pv, jv), (pw, jw)):
        _bitwise(a, b)
    # inputs untouched, like the JAX functions
    for a, b in ((tu, u), (tv, v), (tw, w)):
        _bitwise(a, b)


def test_face_order_is_the_reference_order():
    assert tuple(ops.FACES) == FACE_ORDER
    assert ops.FACES == jops.FACES


@pytest.mark.parametrize("problem", ["dcavity", "canal", "other"])
def test_special_bcs_match_jax(problem):
    (u,) = _fields(1, seed=3)
    want = {"dcavity": jops.set_special_bc_dcavity_3d,
            "canal": jops.set_special_bc_canal_3d}.get(problem)
    got = ops.set_special_bc_3d(_t(u), problem)
    _bitwise(got, u if want is None else want(jnp.asarray(u)))


@pytest.mark.parametrize("gx,gy,gz", [(0.0, 0.0, 0.0), (0.1, -0.2, 0.3)])
def test_compute_fgh_matches_jax(gx, gy, gz):
    u, v, w = _fields(3, seed=4)
    dt = 0.013
    jf, jg, jh = jops.compute_fgh(jnp.asarray(u), jnp.asarray(v),
                                  jnp.asarray(w), jnp.asarray(dt), 100.0, gx,
                                  gy, gz, 0.9, DX, DY, DZ)
    f, g, h = ops.compute_fgh(_t(u), _t(v), _t(w),
                              torch.tensor(dt, dtype=torch.float64), 100.0,
                              gx, gy, gz, 0.9, DX, DY, DZ)
    for a, b in ((f, jf), (g, jg), (h, jh)):
        _close(a, b)
    # the terms alone, and the fixups alone (pure copies)
    terms = ops.fgh_predictor_terms(_t(u), _t(v), _t(w),
                                    torch.tensor(dt, dtype=torch.float64),
                                    100.0, gx, gy, gz, 0.9, DX, DY, DZ)
    jterms = jops.fgh_predictor_terms(jnp.asarray(u), jnp.asarray(v),
                                      jnp.asarray(w), jnp.asarray(dt), 100.0,
                                      gx, gy, gz, 0.9, DX, DY, DZ)
    for a, b in zip(terms, jterms):
        _close(a, b)
    f0, g0, h0, uu, vv, ww = _fields(6, seed=5)
    fixed = ops.apply_fgh_wall_fixups(*(_t(a) for a in (f0, g0, h0, uu, vv,
                                                         ww)))
    jfixed = jops.apply_fgh_wall_fixups(*(jnp.asarray(a) for a in (
        f0, g0, h0, uu, vv, ww)))
    for a, b in zip(fixed, jfixed):
        _bitwise(a, b)


def test_rhs_and_projection_match_jax():
    f, g, h, u, v, w, p = _fields(7, seed=6)
    dt = 0.021
    jdt, tdt = jnp.asarray(dt), torch.tensor(dt, dtype=torch.float64)
    _close(ops.compute_rhs(_t(f), _t(g), _t(h), tdt, DX, DY, DZ),
           jops.compute_rhs(jnp.asarray(f), jnp.asarray(g), jnp.asarray(h),
                            jdt, DX, DY, DZ))
    got = ops.adapt_uvw(*(_t(a) for a in (u, v, w, f, g, h, p)), tdt, DX, DY,
                        DZ)
    want = jops.adapt_uvw(*(jnp.asarray(a) for a in (u, v, w, f, g, h, p)),
                          jdt, DX, DY, DZ)
    for a, b in zip(got, want):
        _close(a, b)
        # the ghost cells keep the input velocity bitwise
        b = np.asarray(b)
        for face in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                     np.s_[:, :, 0], np.s_[:, :, -1]):
            _bitwise(np.asarray(a)[face], b[face])


def test_max_cfl_and_normalize_match_jax():
    u, v, w, p = _fields(4, seed=7)
    for a in (u, v, w):
        assert float(ops.max_element(_t(a))) == float(
            jops.max_element(jnp.asarray(a)))
    maxima = [(0.0, 0.0, 0.0), (1.3, 0.0, 0.2), (0.7, 2.9, 5.0),
              (3.0, 1e-9, 0.0)]
    for um, vm, wm in maxima:
        j = jops.cfl_dt_3d(jnp.asarray(um), jnp.asarray(vm), jnp.asarray(wm),
                           jnp.asarray(0.02), 0.01, 0.02, 0.03, 0.5)
        t = ops.cfl_dt_3d(*(torch.tensor(x, dtype=torch.float64)
                            for x in (um, vm, wm)), 0.02, 0.01, 0.02, 0.03,
                          0.5)
        assert float(t) == float(j)
    j = jops.compute_timestep_3d(jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(w), jnp.asarray(0.05), DX, DY,
                                 DZ, 0.5)
    t = ops.compute_timestep_3d(_t(u), _t(v), _t(w), 0.05, DX, DY, DZ, 0.5)
    assert float(t) == float(j)
    _close(ops.normalize_pressure_3d(_t(p), 9, 7, 6),
           jops.normalize_pressure_3d(jnp.asarray(p), 9, 7, 6))


def test_shift_accessor_matches_jax():
    (a,) = _fields(1, seed=8)
    for dk, dj, di in itertools.product((-1, 0, 1), repeat=3):
        _bitwise(ops.V3(_t(a), dk, dj, di),
                 jops.V3(jnp.asarray(a), dk, dj, di))
