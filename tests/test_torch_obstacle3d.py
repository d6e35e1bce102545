"""The port's 3-D obstacle flag fields on one device (pampi_tpu_torch/ops/
obstacle3d.py, the masked mode of K5, the flag mode of K7/K8,
models/ns3d.py) on the CPU, where the kernels run their plain versions,
against the JAX package (pampi_tpu/ops/obstacle3d.py and its NS3DSolver).

- The geometry and the masks: build_fluid_3d, every field of
  make_masks_3d and the thin-wall rejection equal JAX's bitwise, and so
  do the solve's coefficients, formed from the flags
  (sor3d_kernels.masked_stencil_3d), against JAX's host-made interior
  fields (p_mask, eps_*, factor); apply_obstacle_velocity_bc_3d, mask_fgh
  and adapt_uvw_obstacle too (the JAX functions run eagerly, op by op).
- The solve at float64: make_obstacle_solver_fn_3d (masked K5's plain
  version, whose relaxation factor is formed from the flags) against
  JAX's backend="jnp" (the host-made float64 factor): the same iteration
  count, fields to 1e-12 (XLA contracts the jitted loop's multiply-adds).
- The solve at float32: against JAX's masked kernel in interpret mode at
  n_inner 1 and 2, to atol 5e-5 (JAX's own tolerance for it,
  tests/test_obstacle3d.py).
- NS3DSolver on configs/canal3d_obstacle.par cut to 32x8x8 (the box
  stays 2 cells thick), float64: nt exactly, t to 1e-14 relative (an ulp:
  the CFL dt reads maxima that XLA's contraction moves), fields to 1e-10;
  the same from a carried JAX state; the port's CLI against the JAX CLI's
  binary VTK (1e-10).
- Every refusal of the slice, each a case of its own."""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu import cli as jcli
from pampi_tpu.models.ns3d import NS3DSolver as JNS3DSolver
from pampi_tpu.ops import obstacle3d as jo3
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
from pampi_tpu_torch.ops import ns3d as ops
from pampi_tpu_torch.ops import obstacle3d as o3
from pampi_tpu_torch.ops import sor3d_kernels as sk3
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.params import Parameter, parameter_from_dict

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
CPU = torch.device("cpu")
K, J, I = 10, 12, 14
DX, DY, DZ = 1.0 / I, 1.0 / J, 1.0 / K
OMEGA = 1.7
BOX = "0.2,0.2,0.2,0.6,0.6,0.6"


def _fluid():
    return o3.build_fluid_3d(I, J, K, DX, DY, DZ, BOX)


def _torch(a, dtype=torch.float64):
    return torch.from_numpy(np.array(a)).to(dtype)


def _inv2():
    return tuple(1.0 / (d * d) for d in (DX, DY, DZ))


def assert_coefficients_match(flags, jm):
    """The float64 coefficients masked K5 forms from the uint8 flags
    (fac and the six neighbour flags, times the cell's) equal the JAX
    package's host-made interior fields bitwise."""
    fl = flags.to(torch.float64)
    c = fl[1:-1, 1:-1, 1:-1]
    fac, _ = sk3.masked_stencil_3d(flags, torch.float64, OMEGA, *_inv2())
    ours = {"p_mask": c, "factor": fac}
    for name, nb in (("eps_e", fl[1:-1, 1:-1, 2:]),
                     ("eps_w", fl[1:-1, 1:-1, :-2]),
                     ("eps_n", fl[1:-1, 2:, 1:-1]),
                     ("eps_s", fl[1:-1, :-2, 1:-1]),
                     ("eps_b", fl[2:, 1:-1, 1:-1]),
                     ("eps_f", fl[:-2, 1:-1, 1:-1])):
        ours[name] = nb * c
    for name, a in ours.items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jm,
                                                                    name)),
                                      name)


def test_geometry_and_masks_match_jax():
    fluid = _fluid()
    assert np.array_equal(fluid, jo3.build_fluid_3d(I, J, K, DX, DY, DZ,
                                                    BOX))
    assert (~fluid).sum() > 0
    m = o3.make_masks_3d(fluid, DX, DY, DZ, OMEGA)
    jm = jo3.make_masks_3d(fluid, DX, DY, DZ, OMEGA, jnp.float64)
    for name in ("fluid", "u_face", "v_face", "w_face"):
        np.testing.assert_array_equal(getattr(m, name),
                                      np.asarray(getattr(jm, name)), name)
    assert (m.n_fluid, m.omega) == (jm.n_fluid, jm.omega)
    assert_coefficients_match(m.flags(), jm)
    # the kernels' faces, from the flags on the whole array, are the masks'
    faces = o3.block_faces_3d(m.flags(), *ops.index_grids(
        fluid.shape, 0, (0, 0, 0), CPU), (K, J, I), torch.float64)
    for name in ("fluid", "u_face", "v_face", "w_face"):
        assert np.array_equal(getattr(faces, name).numpy(),
                              getattr(m, name)), name
    assert o3.parse_obstacles_3d("9,8,7,6,5,4;") == \
        jo3.parse_obstacles_3d("9,8,7,6,5,4;") == [(6, 5, 4, 9, 8, 7)]


def test_thin_wall_and_bad_box_rejected_as_in_jax():
    thin = "0.4,0.2,0.2,0.5,0.8,0.8"  # one cell thick in x at 8³
    with pytest.raises(ValueError) as ours:
        o3.build_fluid_3d(8, 8, 8, 1 / 8, 1 / 8, 1 / 8, thin)
    with pytest.raises(ValueError) as theirs:
        jo3.build_fluid_3d(8, 8, 8, 1 / 8, 1 / 8, 1 / 8, thin)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="6 values"):
        o3.parse_obstacles_3d("1,2,3,4")


def test_velocity_bc_mask_fgh_and_projection_match_jax():
    fluid = _fluid()
    m = o3.make_masks_3d(fluid, DX, DY, DZ, OMEGA).to(torch.float64)
    jm = jo3.make_masks_3d(fluid, DX, DY, DZ, OMEGA, jnp.float64)
    rng = np.random.default_rng(3)
    u, v, w, f, g, h, p = (rng.standard_normal(fluid.shape)
                           for _ in range(7))
    ours = o3.apply_obstacle_velocity_bc_3d(*map(_torch, (u, v, w)), m)
    theirs = jo3.apply_obstacle_velocity_bc_3d(*map(jnp.asarray, (u, v, w)),
                                               jm)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the BC changed obstacle faces (the test is not vacuous)
    assert not np.array_equal(ours[0].numpy(), u)
    ours = o3.mask_fgh(*map(_torch, (f, g, h, u, v, w)), m)
    theirs = jo3.mask_fgh(*map(jnp.asarray, (f, g, h, u, v, w)), jm)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dt = 0.013
    ours = o3.adapt_uvw_obstacle(*map(_torch, (u, v, w, f, g, h, p)),
                                 torch.tensor(dt, dtype=torch.float64),
                                 DX, DY, DZ, m)
    theirs = jo3.adapt_uvw_obstacle(*map(jnp.asarray, (u, v, w, f, g, h, p)),
                                    jnp.asarray(dt), DX, DY, DZ, jm)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _problem(seed=5):
    """Random p and a compatible rhs (zero mean over the fluid cells, so
    the Neumann problem converges)."""
    rng = np.random.default_rng(seed)
    shape = (K + 2, J + 2, I + 2)
    rhs = rng.standard_normal(shape)
    inner = _fluid()[1:-1, 1:-1, 1:-1]
    rhs[1:-1, 1:-1, 1:-1] -= rhs[1:-1, 1:-1, 1:-1][inner].mean()
    return rng.standard_normal(shape), rhs


def test_solve_float64_matches_jax_jnp():
    fluid = _fluid()
    m = o3.make_masks_3d(fluid, DX, DY, DZ, OMEGA)
    jm = jo3.make_masks_3d(fluid, DX, DY, DZ, OMEGA, jnp.float64)
    p0, rhs = _problem()
    jsolve = jo3.make_obstacle_solver_fn_3d(I, J, K, DX, DY, DZ, 1e-3, 300,
                                            jm, jnp.float64, backend="jnp")
    jp, jres, jit_ = jax.jit(jsolve)(jnp.asarray(p0), jnp.asarray(rhs))
    solve = o3.make_obstacle_solver_fn_3d(I, J, K, DX, DY, DZ, 1e-3, 300, m,
                                          torch.float64, device=CPU)
    p, res, it = solve(_torch(p0), _torch(rhs))
    assert it == int(jit_) < 300
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-12)
    assert res == pytest.approx(float(jres), rel=1e-10)


def test_jnp_twin_and_masked_k5_match_jax_passes():
    """One iteration of JAX's precomputed-coefficient passes
    (sor_pass_obstacle_3d, odd then even, then the Neumann faces), run
    eagerly, against masked K5's plain version, which forms the
    coefficients from the flags: bitwise at float64."""
    from pampi_tpu.models.ns3d import checkerboard_mask_3d as jmask
    from pampi_tpu.models.ns3d import neumann_faces_3d as jneumann

    fluid = _fluid()
    m = o3.make_masks_3d(fluid, DX, DY, DZ, OMEGA)
    jm = jo3.make_masks_3d(fluid, DX, DY, DZ, OMEGA, jnp.float64)
    p0, rhs = _problem(11)
    c = _inv2()
    jx, jf = jnp.asarray(p0), jnp.asarray(rhs)
    jr2 = 0.0
    for parity in (1, 0):
        jx, jr = jo3.sor_pass_obstacle_3d(
            jx, jf, jmask(K, J, I, parity, jnp.float64), jm, *c)
        jr2 += float(jr)
    jx = jneumann(jx)
    k5 = torch.empty_like(_torch(p0))
    rk = sk3.rb_sor3d_checkerboard(_torch(p0), _torch(rhs), 1, 0.0, *c,
                                   flags=m.flags(), omega=OMEGA, out=k5)
    np.testing.assert_array_equal(k5.numpy(), np.asarray(jx))
    assert float(rk) == pytest.approx(jr2, rel=1e-12)


@pytest.mark.parametrize("n_inner", [1, 2])
def test_masked_kernel_float32_matches_jax_interpret_kernel(n_inner):
    from pampi_tpu.ops.sor3d_pallas import (
        make_rb_iter_tblock_3d,
        pad_array_3d,
        unpad_array_3d,
    )

    fluid = _fluid()
    m = o3.make_masks_3d(fluid, DX, DY, DZ, OMEGA)
    p0, rhs = (a.astype(np.float32) for a in _problem(7))
    rb, bk = make_rb_iter_tblock_3d(I, J, K, DX, DY, DZ, OMEGA, jnp.float32,
                                    n_inner=n_inner, interpret=True,
                                    fluid=fluid.astype(np.float32))
    pp = pad_array_3d(jnp.asarray(p0), bk, n_inner)
    rp = pad_array_3d(jnp.asarray(rhs), bk, n_inner)
    x, f = torch.from_numpy(p0.copy()), torch.from_numpy(rhs)
    y = torch.empty_like(x)
    flags = m.flags()
    for _ in range(3):
        pp, jres = rb(pp, rp)
        res = sk3.rb_sor3d_checkerboard(x, f, n_inner, 0.0, 1 / DX**2,
                                        1 / DY**2, 1 / DZ**2, flags=flags,
                                        omega=OMEGA, out=y)
        x, y = y, x
        got = np.asarray(unpad_array_3d(pp, K, J, I, n_inner))
        np.testing.assert_allclose(x.numpy(), got, rtol=0, atol=5e-5)
        assert float(res) == pytest.approx(float(jres), rel=1e-4)


def _jparam(**kw):
    """configs/canal3d_obstacle.par cut to 32x8x8 (its box 2 cells thick
    per axis), float64."""
    base = dict(imax=32, jmax=8, kmax=8, te=0.2, tpu_dtype="float64",
                itermax=60)
    return jread_parameter(str(CONFIGS / "canal3d_obstacle.par")).replace(
        **{**base, **kw})


def _port_param(jparam):
    return parameter_from_dict(dataclasses.asdict(jparam))


def _assert_state(s, fields, t, nt, tol=1e-10):
    assert s.nt == nt
    assert s.t == pytest.approx(t, rel=1e-14)
    for name, ref in zip("uvwp", fields):
        d = np.abs(getattr(s, name).numpy() - np.asarray(ref)).max()
        assert d <= tol, (name, d)


def test_ns3d_solver_matches_jax():
    jparam = _jparam(te=1e9, tpu_chunk=5)
    js = JNS3DSolver(jparam)
    u, v, w, p, t, nt = js._chunk_fn(*js.initial_state())
    s = NS3DSolver(_port_param(jparam), device="cpu")
    assert dispatch.last("ns3d_step") == \
        "pre -> sor masked checkerboard n_inner=1 -> post on cpu"
    s.run_steps(5)
    _assert_state(s, (u, v, w, p), float(t), int(nt))
    # the masks are JAX's, rebuilt from the .par
    for name in ("fluid", "u_face", "v_face", "w_face"):
        np.testing.assert_array_equal(getattr(s.masks, name),
                                      np.asarray(getattr(js.masks, name)))


def test_from_numpy_state_carries_a_jax_obstacle_run():
    jparam = _jparam(te=1e9, tpu_chunk=3)
    js = JNS3DSolver(jparam)
    mid = js._chunk_fn(*js.initial_state())
    u, v, w, p, t, nt = js._chunk_fn(*mid)
    s = NS3DSolver.from_numpy_state(_port_param(jparam), *mid[:4],
                                    float(mid[4]), int(mid[5]), device="cpu")
    assert s.nt == 3
    s.run_steps(3)
    _assert_state(s, (u, v, w, p), float(t), int(nt))


def test_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    text = (CONFIGS / "canal3d_obstacle.par").read_text()
    for key, val in (("imax", 32), ("jmax", 8), ("kmax", 8), ("te", 0.3),
                     ("itermax", 60)):
        text = re.sub(rf"^{key}\s.*$", f"{key} {val}", text, flags=re.M)
    par = tmp_path / "canal3d_obstacle.par"
    par.write_text(text + "\ntpu_vtk binary\n")
    files = {}
    for name, main, argv in (
            ("jax", jcli.main, ["pampi_tpu", str(par)]),
            ("torch", cli.main, ["pampi_tpu_torch", "--device", "cpu",
                                 str(par)])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(argv) == 0
        capsys.readouterr()
        files[name] = (tmp_path / name / "canal.vtk").read_bytes()
    ours, theirs = files["torch"], files["jax"]
    head = ours.index(b"LOOKUP_TABLE default\n") + 21
    vhead = ours.index(b"VECTORS velocity double\n") + 24
    assert ours[:head] == theirs[:head] and len(ours) == len(theirs)
    n = 32 * 8 * 8
    for start, count in ((head, n), (vhead, 3 * n)):
        a, b = (np.frombuffer(x[start:start + 8 * count], ">f8")
                for x in (ours, theirs))
        assert np.abs(a - b).max() <= 1e-10


# -- refusals: each a case of its own ---------------------------------------

def _three_d(**kw):
    return Parameter(**{**dict(name="canal3d", imax=16, jmax=8, kmax=8,
                               obstacles=BOX), **kw})


def _mesh(param, dims):
    return NS3DDistSolver(param, CartComm(ndims=3, dims=dims, devices=[CPU]))


REFUSALS = {
    "fft": (lambda: NS3DSolver(_three_d(tpu_solver="fft"), device="cpu"),
            ValueError, "tpu_solver fft cannot solve obstacle flag fields"),
    "fft-mesh": (lambda: _mesh(_three_d(tpu_solver="fft"), (2, 2, 2)),
                 ValueError, "tpu_solver fft cannot solve obstacle"),
    "mg-mesh": (lambda: _mesh(_three_d(tpu_solver="mg"), (2, 2, 2)),
                NotImplementedError, "obstacle multigrid .*ROADMAP A.8"),
    "ragged-mesh": (lambda: _mesh(_three_d(imax=18, tpu_solver="mg"),
                                  (1, 1, 4)),
                    ValueError, "tpu_solver mg needs a divisible grid/mesh"),
    "octants-one-device": (
        lambda: NS3DSolver(_three_d(tpu_sor_layout="octants"), device="cpu"),
        ValueError, "tpu_sor_layout octants does not support obstacle"),
    "octants-mesh": (
        lambda: _mesh(_three_d(tpu_sor_layout="octants"), (2, 2, 2)),
        ValueError, "tpu_sor_layout octants needs"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal(case):
    make, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        make()


def test_refusals_follow_jax():
    """The fft refusal is JAX's own ValueError text; a forced octant
    layout on one device is refused by both packages alike."""
    from pampi_tpu.utils.params import Parameter as JParameter

    jp = JParameter(name="canal3d", imax=16, jmax=8, kmax=8, obstacles=BOX)
    for kw in (dict(tpu_solver="fft"), dict(tpu_sor_layout="octants")):
        with pytest.raises(ValueError) as theirs:
            JNS3DSolver(jp.replace(**kw))
        with pytest.raises(ValueError) as ours:
            NS3DSolver(_three_d(**kw), device="cpu")
        assert str(ours.value) == str(theirs.value)
