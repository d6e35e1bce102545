"""The port's 2-D obstacle flag fields on one device (pampi_tpu_torch/ops/
obstacle.py, the masked mode of K2, the flag mode of K3/K4,
models/ns2d.py) on the CPU, where the kernels run their plain versions,
against the JAX package (pampi_tpu/ops/obstacle.py and its NS2DSolver).

- The geometry and the masks: parse_obstacles, build_fluid, the face
  masks of make_masks and the thin-wall rejection equal JAX's bitwise,
  and so do the solve's coefficients, formed from the flags
  (sor_kernels.masked_stencil_2d), against JAX's host-made interior
  fields (p_mask, eps_*, factor); apply_obstacle_velocity_bc, mask_fg,
  adapt_uv_obstacle and normalize_pressure_fluid too (the JAX functions
  run eagerly, op by op), or within 1e-13 of scale where XLA reduces.
- Masked K2's plain version against the JAX package's sor_pass_obstacle
  chain (eager: bitwise fields) and its interpret-mode masked kernel
  make_rb_iter_tblock(fluid=...) as tests/test_obstacle.py runs it (1e-12,
  residual 1e-11: XLA contracts the interpret kernel's multiply-adds).
- The solve at float64: make_obstacle_solver_fn against JAX's
  backend="jnp" (the host-made float64 factor): the same iteration count,
  fields to 1e-12.
- K3/K4's flag mode (plain versions) against the JAX package's
  interpret-mode make_fused_step_2d(fluid=...), as
  tests/test_ns2d_fused.py runs it: 1e-13 of scale.
- NS2DSolver on configs/canal_obstacle.par cut to 64x16 (the box stays 4
  cells wide), float64: nt exactly, t to 1e-14 relative (an ulp: the CFL
  dt reads maxima that XLA's contraction moves), fields to 1e-10; the same
  from a carried JAX state (the CLI against the JAX CLI is in
  tests/test_torch_obstacle2d_dist.py, beside its meshes).
- Every refusal of the slice, each a case of its own."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu import cli as jcli
from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver
from pampi_tpu.ops import obstacle as jobst
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.poisson import PoissonSolver
from pampi_tpu_torch.ops import ns2d as ops
from pampi_tpu_torch.ops import ns2d_fused as nf
from pampi_tpu_torch.ops import obstacle as obst
from pampi_tpu_torch.ops import sor_kernels as sk
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.params import Parameter, read_parameter

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
J, I = 40, 48
DX, DY = 1.0 / I, 1.0 / J
OMEGA = 1.7
BOX = "0.3,0.3,0.6,0.7"


def _fluid():
    return obst.build_fluid(I, J, DX, DY, BOX)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def test_geometry_and_masks_match_jax():
    fluid = _fluid()
    assert np.array_equal(fluid, jobst.build_fluid(I, J, DX, DY, BOX))
    assert obst.parse_obstacles(" 3,1,1,2 ; 0,0,1,1;") == \
        jobst.parse_obstacles(" 3,1,1,2 ; 0,0,1,1;")
    m = obst.make_masks(fluid, DX, DY, OMEGA)
    jm = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    for name in ("fluid", "u_face", "v_face"):
        np.testing.assert_array_equal(getattr(m, name),
                                      np.asarray(getattr(jm, name)))
    assert m.n_fluid == jm.n_fluid and m.omega == jm.omega
    flags = m.flags()
    assert flags.dtype == torch.uint8
    np.testing.assert_array_equal(flags.numpy(), fluid.astype(np.uint8))
    # the block faces of the whole array are make_masks' faces
    faces = obst.block_faces(flags, *ops.index_grids_2d(flags.shape, 0,
                                                        (0, 0)),
                             (J, I), torch.float64)
    for name in ("fluid", "u_face", "v_face"):
        np.testing.assert_array_equal(getattr(faces, name).numpy(),
                                      getattr(m, name))


def test_solve_coefficients_from_flags_match_jax_host_arrays():
    """masked_stencil_2d's fac equals JAX's host-made factor bitwise at
    float64, and its Laplacian JAX's obstacle_residual on fluid cells."""
    fluid = _fluid()
    jm = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    flags = obst.make_masks(fluid, DX, DY, OMEGA).flags()
    idx2, idy2 = 1.0 / (DX * DX), 1.0 / (DY * DY)
    fac, lap = sk.masked_stencil_2d(flags, torch.float64, OMEGA, idx2, idy2)
    np.testing.assert_array_equal(fac.numpy(), np.asarray(jm.factor))
    rng = np.random.default_rng(1)
    p, rhs = (rng.standard_normal((J + 2, I + 2)) for _ in range(2))
    with jax.disable_jit():
        want = np.asarray(jobst.obstacle_residual(jnp.asarray(p),
                                                  jnp.asarray(rhs), jm,
                                                  idx2, idy2))
    got = (rhs[1:-1, 1:-1] - lap(_t(p)).numpy()) * fluid[1:-1, 1:-1]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", ["0.3,0.3,0.32,0.7", "0.3,0.3,0.6,0.33"])
def test_thin_obstacles_are_rejected_with_jax_message(spec):
    with pytest.raises(ValueError) as theirs:
        jobst.build_fluid(I, J, DX, DY, spec)
    with pytest.raises(ValueError) as ours:
        obst.build_fluid(I, J, DX, DY, spec)
    assert str(ours.value) == str(theirs.value)


def test_phase_ops_match_jax():
    """The obstacle velocity BC, mask_fg, adapt_uv_obstacle bitwise
    against the JAX functions run op by op; normalize_pressure_fluid
    within 1e-13 (the sums reduce in another order)."""
    fluid = _fluid()
    m = obst.make_masks(fluid, DX, DY, OMEGA).to(torch.float64)
    jm = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    rng = np.random.default_rng(2)
    u, v, f, g, p = (rng.standard_normal((J + 2, I + 2)) for _ in range(5))
    dt = 0.013
    with jax.disable_jit():
        ju, jv = jobst.apply_obstacle_velocity_bc(jnp.asarray(u),
                                                  jnp.asarray(v), jm)
        jf, jg = jobst.mask_fg(jnp.asarray(f), jnp.asarray(g), ju, jv, jm)
        ju2, jv2 = jobst.adapt_uv_obstacle(
            ju, jv, jf, jg, jnp.asarray(p), jnp.asarray(dt), DX, DY, jm)
        jp = jobst.normalize_pressure_fluid(jnp.asarray(p), jm)
    tu, tv = obst.apply_obstacle_velocity_bc(_t(u), _t(v), m)
    tf, tg = obst.mask_fg(_t(f), _t(g), tu, tv, m)
    tu2, tv2 = obst.adapt_uv_obstacle(tu, tv, tf, tg, _t(p),
                                      torch.tensor(dt, dtype=torch.float64),
                                      DX, DY, m)
    for a, b in ((tu, ju), (tv, jv), (tf, jf), (tg, jg), (tu2, ju2),
                 (tv2, jv2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        obst.normalize_pressure_fluid(_t(p), m.fluid).numpy(),
        np.asarray(jp), rtol=0, atol=1e-13)


@pytest.mark.parametrize("n_inner", [1, 3])
def test_masked_k2_plain_matches_jax_chain_and_interpret_kernel(n_inner):
    from pampi_tpu.ops.sor import checkerboard_mask, neumann_bc
    from pampi_tpu.ops.sor_pallas import (
        make_rb_iter_tblock,
        pad_array,
        unpad_array,
    )

    fluid = _fluid()
    jm = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    flags = obst.make_masks(fluid, DX, DY, OMEGA).flags()
    idx2, idy2 = 1.0 / (DX * DX), 1.0 / (DY * DY)
    rng = np.random.default_rng(3)
    p0, rhs = (rng.standard_normal((J + 2, I + 2)) for _ in range(2))
    red = checkerboard_mask(J, I, 0, jnp.float64)
    black = checkerboard_mask(J, I, 1, jnp.float64)
    p_j = jnp.asarray(p0)
    with jax.disable_jit():
        for _ in range(n_inner):
            p_j, r0 = jobst.sor_pass_obstacle(p_j, jnp.asarray(rhs), red, jm,
                                              idx2, idy2)
            p_j, r1 = jobst.sor_pass_obstacle(p_j, jnp.asarray(rhs), black,
                                              jm, idx2, idy2)
            p_j = neumann_bc(p_j)
    x = torch.empty_like(_t(p0))
    r = sk.rb_sor_checkerboard(_t(p0), _t(rhs), n_inner, 0.0, idx2, idy2,
                               flags=flags, omega=OMEGA, out=x)
    np.testing.assert_array_equal(x.numpy(), np.asarray(p_j))
    assert abs(float(r) - float(r0 + r1)) <= 1e-13 * float(r0 + r1)
    rb, br, h = make_rb_iter_tblock(I, J, DX, DY, OMEGA, jnp.float64,
                                    n_inner=n_inner, block_rows=16,
                                    interpret=True, fluid=fluid)
    p_p, rsq = rb(pad_array(jnp.asarray(p0), br, h),
                  pad_array(jnp.asarray(rhs), br, h))
    np.testing.assert_allclose(x.numpy(),
                               np.asarray(unpad_array(p_p, J, I, h)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(r), float(rsq), rtol=1e-11)


def test_masked_k2_residual_is_the_ordered_sum():
    """The plain version's residual is the kernel's fixed order: the field
    is cut into the call's tiles (th x tw, row-major; K15's plan on the
    field as a block of H = 1); in a tile's CTA thread (tx, ty) of 32 x 16
    adds the r² of the tile's cells (ty + 16 k, tx + 32 m), k-major (0 on
    the ring and off the fluid), and a halving tree over 32 ty + tx sums
    the threads; then thread t of 512 adds partials t, t + 512, ... and a
    halving tree (written out here in numpy)."""
    from pampi_tpu_torch.ops import sor_obsdist as sod

    flags = obst.make_masks(_fluid(), DX, DY, OMEGA).flags()
    idx2, idy2 = 1.0 / (DX * DX), 1.0 / (DY * DY)
    rng = np.random.default_rng(4)
    p0, rhs = (_t(rng.standard_normal((J + 2, I + 2))) for _ in range(2))
    r = sk.rb_sor_masked_plain(p0.clone(), rhs, flags, 1, OMEGA, idx2, idy2)
    fac, lap = sk.masked_stencil_2d(flags, torch.float64, OMEGA, idx2, idy2)
    fluid = flags[1:-1, 1:-1] != 0
    y, sq = p0.clone(), np.zeros((J + 2, I + 2))

    def tree(v):
        st = len(v) // 2
        while st:
            v = v[:st] + v[st:2 * st]
            st //= 2
        return v[0]

    for parity in (0, 1):
        upd = (sk.checkerboard_mask(J, I, parity, torch.uint8) != 0) & fluid
        rr = torch.where(upd, rhs[1:-1, 1:-1] - lap(y), 0.0)
        y[1:-1, 1:-1] = y[1:-1, 1:-1] - fac * rr
        sq[1:-1, 1:-1] += (rr * rr).numpy()
    (pl,) = sod.obsdist_passes(sk.masked_geom(J, I, 1), 8)
    parts = []
    for j0 in range(0, J + 2, pl.th):
        for i0 in range(0, I + 2, pl.tw):
            acc = np.zeros(512)
            for j in range(j0, min(j0 + pl.th, J + 2)):
                for i in range(i0, min(i0 + pl.tw, I + 2)):
                    acc[32 * ((j - j0) % 16) + (i - i0) % 32] += sq[j, i]
            parts.append(tree(acc))
    s = np.zeros(512)
    for k, v in enumerate(parts):
        s[k % 512] += v
    assert float(r) == float(tree(s)) > 0


def test_one_device_solve_matches_jax_jnp():
    fluid = _fluid()
    jm = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    m = obst.make_masks(fluid, DX, DY, OMEGA)
    rng = np.random.default_rng(5)
    p0, rhs = (rng.standard_normal((J + 2, I + 2)) for _ in range(2))
    # a compatible Neumann problem: rhs zero off the fluid interior and of
    # zero mean on it
    inner = fluid.copy()
    inner[0], inner[-1], inner[:, 0], inner[:, -1] = False, False, False, \
        False
    rhs = np.where(inner, rhs - rhs[inner].mean(), 0.0)
    jsolve = jobst.make_obstacle_solver_fn(I, J, DX, DY, 1e-2, 3000, jm,
                                           jnp.float64, backend="jnp")
    jp, jres, jit_ = jax.jit(jsolve)(jnp.asarray(p0), jnp.asarray(rhs))
    solve = obst.make_obstacle_solver_fn(I, J, DX, DY, 1e-2, 3000, m,
                                         torch.float64, 1, device="cpu")
    p, res, it = solve(_t(p0), _t(rhs))
    assert it == int(jit_) < 3000
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-12 * max(1.0, np.abs(p0).max()))
    assert abs(res - float(jres)) <= 1e-10 * float(jres)


def test_flag_mode_matches_jax_interpret_fused_step():
    """K3/K4's flag mode (plain versions) against the JAX package's
    interpret-mode fused step with the baked flags (make_fused_step_2d
    fluid=...): 1e-13 of scale; u', v' after the BCs bitwise."""
    from pampi_tpu.ops import ns2d_fused as jnf
    from pampi_tpu.utils.params import Parameter as JParameter

    kw = dict(name="canal_obstacle", imax=I, jmax=J, re=10.0, bcLeft=3,
              bcRight=3, obstacles=BOX, gamma=0.9, omg=OMEGA)
    jparam, param = JParameter(**kw), Parameter(**kw)
    fluid = _fluid()
    jm = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    rng = np.random.default_rng(6)
    u, v, p = (rng.standard_normal((J + 2, I + 2)) for _ in range(3))
    dt = 0.01
    pre, post, pad, unpad, _h = jnf.make_fused_step_2d(
        jparam, J, I, DX, DY, jnp.float64, fluid=jm.fluid, interpret=True)
    offs = jnp.zeros((2,), jnp.int32)
    dt11 = jnp.full((1, 1), dt, jnp.float64)
    up, vp, fp, gp, rp = pre(offs, dt11, pad(jnp.asarray(u)),
                             pad(jnp.asarray(v)))
    up2, vp2, um, vm = post(offs, dt11, up, vp, fp, gp, pad(jnp.asarray(p)))
    flags = obst.make_masks(fluid, DX, DY, OMEGA).flags()
    cfg = nf.StepConfig.from_param(param)
    tu, tv = _t(u), _t(v)
    tdt = torch.tensor(dt, dtype=torch.float64)
    f, g, rhs = nf.ns2d_pre(tu, tv, tdt, cfg, flags=flags)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(unpad(up)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(unpad(vp)))
    for a, b in ((f, fp), (g, gp), (rhs, rp)):
        b = np.asarray(unpad(b))
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-13 * max(1.0, np.abs(b).max()))
    umax, vmax = nf.ns2d_post(tu, tv, f, g, _t(p), tdt, DX, DY, flags=flags)
    for a, b in ((tu, up2), (tv, vp2)):
        b = np.asarray(unpad(b))
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-13 * max(1.0, np.abs(b).max()))
    assert float(umax) == float(tu.abs().max())
    assert float(vmax) == float(tv.abs().max())
    assert abs(float(umax) - float(um)) <= 1e-12 * float(um)
    assert abs(float(vmax) - float(vm)) <= 1e-12 * float(vm)


def _params(**kw):
    base = dict(imax=64, jmax=16, te=2.0)
    base.update(kw)
    par = str(CONFIGS / "canal_obstacle.par")
    return (jread_parameter(par).replace(**base),
            read_parameter(par).replace(**base))


def _assert_close(s, js, tol=1e-10):
    for name in "uvp":
        a, b = getattr(s, name).numpy(), np.asarray(getattr(js, name))
        d = float(np.abs(a - b).max())
        assert d <= tol * max(1.0, float(np.abs(b).max())), (name, d)


def test_ns2d_canal_obstacle_matches_jax():
    jparam, param = _params()
    js = JNS2DSolver(jparam)
    js.run(progress=False)
    s = NS2DSolver(param, device="cpu")
    s.run(progress=False)
    assert dispatch.last("ns2d_step") == (
        "pre -> sor masked checkerboard n_inner=1 -> post on cpu")
    assert s.nt == js.nt and s.nt > 10
    assert abs(s.t - js.t) <= 1e-14 * js.t
    _assert_close(s, js)


def test_ns2d_from_jax_state_matches_jax():
    """A run started from a JAX solver's state (u, v, p, t, nt after a
    few steps) continues as the JAX solver does."""
    jparam, param = _params(te=0.5)
    js = JNS2DSolver(jparam)
    js.run(progress=False)
    s = NS2DSolver.from_numpy_state(param.replace(te=1.0), js.u, js.v, js.p,
                                    js.t, js.nt, device="cpu")
    js2 = JNS2DSolver(jparam.replace(te=1.0))
    js2.u, js2.v, js2.p, js2.t, js2.nt = js.u, js.v, js.p, js.t, js.nt
    js2.run(progress=False)
    s.run(progress=False)
    assert s.nt == js2.nt > js.nt
    assert abs(s.t - js2.t) <= 1e-14 * js2.t
    _assert_close(s, js2)


def _obstacle_param(**kw):
    return dataclasses.replace(_params()[1], **kw)


REFUSALS = {
    "quarters": (lambda: NS2DSolver(
        _obstacle_param(tpu_sor_layout="quarters"), device="cpu"),
                 ValueError, "tpu_sor_layout quarters does not support "
                 "obstacle flag fields"),
    "poisson": (lambda: PoissonSolver(Parameter(
        name="poisson", imax=16, jmax=16, obstacles=BOX), device="cpu"),
                ValueError, "supported for NS problems only"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal(case):
    make, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        make()


@pytest.mark.parametrize("solver", ["fft", "sor_lex"])
def test_refusals_follow_jax(solver):
    """fft and sor_lex on an obstacle grid raise the JAX package's own
    ValueError text."""
    jparam, param = _params()
    with pytest.raises(ValueError) as theirs:
        JNS2DSolver(jparam.replace(tpu_solver=solver))
    with pytest.raises(ValueError) as ours:
        NS2DSolver(param.replace(tpu_solver=solver), device="cpu")
    assert str(ours.value) == str(theirs.value)


def test_cli_refuses_poisson_with_obstacles_like_jax(tmp_path, capsys):
    par = tmp_path / "po.par"
    par.write_text(f"name poisson\nimax 16\njmax 16\nobstacles {BOX}\n")
    assert jcli.main(["pampi_tpu", str(par)]) == 1
    theirs = capsys.readouterr().err.strip().splitlines()[-1]
    assert cli.main(["pampi_tpu_torch", "--device", "cpu", str(par)]) == 1
    ours = capsys.readouterr().err.strip().splitlines()[-1]
    assert ours == theirs == ("Error: the obstacles key is supported for NS "
                              "problems only")
