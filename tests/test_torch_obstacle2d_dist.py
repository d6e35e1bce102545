"""The port's distributed NS-2D solver with obstacle flag fields
(models/ns2d_dist.py, ops/obstacle.py) against the JAX package's
NS2DDistSolver on the suite's 8 faked CPU devices, float64,
configs/canal_obstacle.par cut to small grids (its box kept where it is in
physical coordinates), itermax 60, a few steps: on a divisible 2x2 mesh
whose shard interfaces cut through the box, on the ragged 3x2, and on a
mesh whose shards own one row (the exchange-per-half-sweep fallback);
through the fused step (K3/K4 in flag mode, K15 on the real flags) and
the phase chain. Every shard of the port lies on the CPU, where the
kernels run their plain versions. Also K3/K4's distributed flag mode
against the JAX package's interpret-mode `fluid=True` kernels on every
shard, and the CLI on one device, a 2x2 and a ragged 3x2 mesh against the
JAX CLI (steps, t to an ulp, full-precision fields to 1e-10).

Tolerances: the JAX package runs its jnp grid CA with coefficients made
in float64 on the host, the port K15's plain version with coefficients
formed from the flags; both are the same operations at float64, but XLA
contracts the JAX package's multiply-adds, so the fields agree within
1e-10 of scale, not bitwise. Steps agree exactly, t to an ulp (the CFL dt
reads maxima that round-off moves)."""

import pathlib

import numpy as np
import pytest
import torch

from pampi_tpu import cli as jcli
from pampi_tpu.models.ns2d_dist import NS2DDistSolver as JDistSolver
from pampi_tpu.parallel.comm import CartComm as JComm
from pampi_tpu.utils import dispatch as jdispatch
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.datio import read_pressure, read_velocity
from pampi_tpu_torch.utils.params import read_parameter

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
CPU = torch.device("cpu")
STEPS = 4


class JDist(JDistSolver):
    """The JAX solver with a chunk of STEPS steps (its chunk length is a
    class constant)."""

    CHUNK = STEPS


def _params(**kw):
    base = dict(te=1e9, itermax=60)
    base.update(kw)
    par = str(CONFIGS / "canal_obstacle.par")
    return (jread_parameter(par).replace(**base),
            read_parameter(par).replace(**base))


def _run_both(dims, **kw):
    jparam, param = _params(**kw)
    js = JDist(jparam, JComm(ndims=2, dims=dims))
    u, v, p, t, nt = js._chunk_sm(*js.initial_state())[:5]
    js.u, js.v, js.p = u, v, p
    s = NS2DDistSolver(param, CartComm(ndims=2, dims=dims, devices=[CPU]))
    s.run_steps(STEPS)
    return js, float(t), int(nt), s


def _assert_close(s, js, tol=1e-10):
    got, want = s.global_fields(), js.global_fields()
    for name in "uvp":
        a, b = got[name], np.asarray(want[name])
        assert a.shape == b.shape == (s.jmax + 2, s.imax + 2)
        scale = max(1.0, float(np.abs(b).max()))
        d = float(np.abs(a - b).max())
        assert d <= tol * scale, (name, d)


CASES = [
    # (dims, grid (jmax, imax), the port's obstacle_dist record)
    ((2, 2), (16, 64), "pallas ca1"),
    ((3, 2), (16, 64), "pallas ca1 ragged"),
    ((8, 1), (8, 64), "jnp_rb_fallback"),
]


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("dims,grid,label", CASES)
def test_steps_match_jax(dims, grid, label, fuse):
    js, jt, jnt, s = _run_both(dims, jmax=grid[0], imax=grid[1],
                               tpu_fuse_phases=fuse)
    ragged = " ragged" if "ragged" in label else ""
    assert s.ragged == js.ragged == bool(ragged)
    assert dispatch.last("ns2d_dist") == jdispatch.last("ns2d_dist") == (
        "obstacle (see obstacle_dist)" + ragged)
    assert dispatch.last("obstacle_dist") == label
    if label.startswith("jnp"):
        assert jdispatch.last("obstacle_dist") == label
    else:  # the JAX package's CPU runs its jnp CA where the port runs K15
        assert jdispatch.last("obstacle_dist") == "jnp_ca ca1" + ragged
    fused = fuse == "auto" and min(s.local) >= 3
    assert dispatch.last("ns2d_dist_phases") == (
        "pallas_fused" if fused else "jnp (tpu_fuse_phases off)"
        if fuse == "off" else "jnp (shard extents < deep halo 3)")
    assert s.nt == jnt == STEPS
    assert abs(s.t - jt) <= 1e-14 * jt
    _assert_close(s, js)


def test_forced_checkerboard_runs_k15_at_the_kernel_depth():
    """`tpu_sor_layout checkerboard`: both packages run their per-shard
    kernel at max(tpu_ca_inner, tpu_sor_inner), the JAX one in interpret
    mode, and the iteration counts agree."""
    js, jt, jnt, s = _run_both((2, 2), jmax=16, imax=64,
                               tpu_sor_layout="checkerboard",
                               tpu_sor_inner=2)
    assert dispatch.last("obstacle_dist") == "pallas ca2"
    assert jdispatch.last("obstacle_dist") == "pallas ca2"
    assert s.nt == jnt
    assert abs(s.t - jt) <= 1e-14 * jt
    _assert_close(s, js)


def test_from_jax_state_on_ragged_mesh_matches_one_device():
    """NS2DDistSolver.from_numpy_state takes an obstacle run's state from
    the JAX package's numpy fields (its one-device run after a few steps)
    and continues on the ragged 3x2 as the port's one-device solver does
    from the same state: steps equal, fields within 1e-12 of scale."""
    from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver

    from pampi_tpu_torch.models.ns2d import NS2DSolver

    jparam, param = _params(jmax=16, imax=64, te=0.3)
    js = JNS2DSolver(jparam)
    js.run(progress=False)
    state = (np.asarray(js.u), np.asarray(js.v), np.asarray(js.p), js.t,
             js.nt)
    cont = param.replace(te=0.6)
    s = NS2DDistSolver.from_numpy_state(
        cont, CartComm(ndims=2, dims=(3, 2), devices=[CPU]), *state)
    one = NS2DSolver.from_numpy_state(cont, *state, device="cpu")
    for x in (s, one):
        x.run(progress=False)
    assert s.nt == one.nt > js.nt
    got = s.global_fields()
    for k in "uvp":
        ref = getattr(one, k).numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(got[k] - ref).max()) <= 1e-12 * scale


def test_mesh_refusals_follow_jax():
    """A forced quarter layout and fft raise the JAX package's ValueErrors;
    mg (and auto, which takes mg on an obstacle grid) name ROADMAP A.8,
    where the distributed obstacle multigrid waits."""
    jparam, param = _params(jmax=16, imax=64)
    comm = CartComm(ndims=2, dims=(2, 2), devices=[CPU])
    for kw in (dict(tpu_sor_layout="quarters"), dict(tpu_solver="fft")):
        with pytest.raises(ValueError) as theirs:
            JDistSolver(jparam.replace(**kw), JComm(ndims=2, dims=(2, 2)))
        with pytest.raises(ValueError) as ours:
            NS2DDistSolver(param.replace(**kw), comm)
        assert str(ours.value) == str(theirs.value)
    for solver in ("mg", "auto"):
        with pytest.raises(NotImplementedError,
                           match="obstacle multigrid .*ROADMAP A.8"):
            NS2DDistSolver(param.replace(tpu_solver=solver), comm)


def _flag_blocks(fluid, H, off, jl, il, dims, G):
    """A shard's block of the global flags, H-1 dead layers per side and
    the ragged overhang, sliced at its offsets (fused_flag_blocks)."""
    over = [max(0, d * n - g) for d, n, g in zip(dims, (jl, il), G)]
    wide = np.pad(fluid.astype(np.uint8),
                  [(H - 1, H - 1 + over[0]), (H - 1, H - 1 + over[1])])
    return wide[off[0]:off[0] + jl + 2 * H, off[1]:off[1] + il + 2 * H]


@pytest.mark.parametrize("dims,grid", [((2, 2), (16, 64)),
                                       ((3, 2), (16, 64))])
def test_dist_flag_mode_matches_jax_interpret_kernels(dims, grid):
    """K3/K4's distributed flag mode (plain versions) against the JAX
    package's interpret-mode make_fused_pre_2d / make_fused_post_2d with
    fluid=True on every shard's deep and halo-1 blocks: 1e-13 of scale."""
    import jax.numpy as jnp
    from pampi_tpu.ops import ns2d_fused as jnf
    from pampi_tpu.ops import obstacle as jobst

    from pampi_tpu_torch.ops import ns2d_fused as nf

    jmax, imax = grid
    jparam, param = _params(jmax=jmax, imax=imax)
    dx, dy = param.xlength / imax, param.ylength / jmax
    jl, il = -(-jmax // dims[0]), -(-imax // dims[1])
    ragged = jl * dims[0] != jmax or il * dims[1] != imax
    fluid = jobst.build_fluid(imax, jmax, dx, dy, param.obstacles)
    H = 3
    pre_k, pad_d, unpad_d, _ = jnf.make_fused_pre_2d(
        jparam, jmax, imax, dx, dy, jnp.float64, jl=jl, il=il,
        ext_pad=H - 1, fluid=True, interpret=True)
    post_k, pad_e, unpad_e, _ = jnf.make_fused_post_2d(
        jparam, jmax, imax, dx, dy, jnp.float64, jl=jl, il=il, fluid=True,
        ragged=ragged, interpret=True)
    cfg = nf.StepConfig.from_param(param)
    dt = 0.013
    tdt = torch.tensor(dt, dtype=torch.float64)
    rng = np.random.default_rng(3)
    comm = CartComm(ndims=2, dims=dims, devices=[CPU])
    for s in range(comm.size):
        off = comm.offsets(s, (jl, il))
        ud, vd = (rng.standard_normal((jl + 2 * H, il + 2 * H))
                  for _ in range(2))
        p = rng.standard_normal((jl + 2, il + 2))
        fd = _flag_blocks(fluid, H, off, jl, il, dims, (jmax, imax))
        fe = _flag_blocks(fluid, 1, off, jl, il, dims, (jmax, imax))
        offs = jnp.asarray(off, jnp.int32)
        dt11 = jnp.full((1, 1), dt)
        jout = [np.asarray(a)[H - 1:-(H - 1), H - 1:-(H - 1)]
                if k >= 2 else np.asarray(a) for k, a in enumerate(
                    unpad_d(x) for x in pre_k(offs, dt11, pad_d(ud),
                                              pad_d(vd),
                                              pad_d(fd.astype(float))))]
        uk, vk = torch.from_numpy(ud.copy()), torch.from_numpy(vd.copy())
        got = nf.ns2d_pre(uk, vk, tdt, cfg, off, (jmax, imax), H - 1,
                          torch.from_numpy(fd))
        strip = (slice(H - 1, -(H - 1)),) * 2
        for a, b in zip((uk[strip], vk[strip], *got),
                        [x[strip] for x in jout[:2]] + jout[2:]):
            scale = max(1.0, float(np.abs(b).max()))
            assert float(np.abs(a.numpy() - b).max()) <= 1e-13 * scale
        uh, vh, f, g = (x.clone() for x in (uk[strip], vk[strip], got[0],
                                            got[1]))
        up, vp, um, vm = post_k(offs, dt11, *(pad_e(x.numpy()) for x in
                                              (uh, vh, f, g)),
                                pad_e(p), pad_e(fe.astype(float)))
        uc, vc = uh.contiguous(), vh.contiguous()
        mu, mv = nf.ns2d_post(uc, vc, f, g, torch.from_numpy(p), tdt, dx, dy,
                              off, (jmax, imax), ragged,
                              torch.from_numpy(fe))
        for a, b, m, jm in ((uc, unpad_e(up), mu, um),
                            (vc, unpad_e(vp), mv, vm)):
            b = np.asarray(b)
            scale = max(1.0, float(np.abs(b).max()))
            assert float(np.abs(a.numpy() - b).max()) <= 1e-13 * scale
            assert abs(float(m) - float(jm)) <= 1e-12 * max(1.0, float(jm))


def _recorded(monkeypatch, classes, got):
    """Make each class's write_result record nt, t and the global u, v, p
    at full precision into `got` first."""
    for cls in classes:
        write = cls.write_result

        def record(self, *a, _write=write, **kw):
            fields = (self.global_fields() if hasattr(self, "global_fields")
                      else {k: getattr(self, k).numpy() for k in "uvp"})
            got.update(nt=int(self.nt), t=float(self.t),
                       **{k: np.asarray(fields[k]) for k in "uvp"})
            return _write(self, *a, **kw)

        monkeypatch.setattr(cls, "write_result", record)


@pytest.mark.parametrize("mesh", ["1", "2x2", "3x2"])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, mesh):
    """`python -m pampi_tpu_torch --device cpu` on canal_obstacle.par cut
    to 64x16 (te 0.3) on one device, a 2x2 and a ragged 3x2 mesh, against
    `python -m pampi_tpu` on the same file: the same steps, t to an ulp,
    u, v, p within 1e-10 of scale, pressure.dat and velocity.dat within
    their print precision."""
    from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver

    from pampi_tpu_torch.models.ns2d import NS2DSolver

    text = (CONFIGS / "canal_obstacle.par").read_text()
    for key, val in (("imax", 64), ("jmax", 16), ("te", 0.3),
                     ("tpu_mesh", mesh)):
        text = "\n".join(f"{key} {val}" if ln.split()[:1] == [key] else ln
                         for ln in text.splitlines()) + "\n"
    outs, runs = [], []
    for name, main, classes in (
            ("jax", jcli.main, (JNS2DSolver, JDistSolver)),
            ("torch", cli.main, (NS2DSolver, NS2DDistSolver))):
        d = tmp_path / name
        d.mkdir()
        (d / "co.par").write_text(text)
        monkeypatch.chdir(d)
        got = {}
        _recorded(monkeypatch, classes, got)
        args = (["pampi_tpu_torch", "--device", "cpu", "co.par"]
                if name == "torch" else ["pampi_tpu", "co.par"])
        assert main(args) in (0, None)
        runs.append(got)
        outs.append((read_pressure(str(d / "pressure.dat")),
                     *read_velocity(str(d / "velocity.dat"))))
    theirs, ours = runs
    assert ours["nt"] == theirs["nt"] > 1
    assert abs(ours["t"] - theirs["t"]) <= 1e-14 * theirs["t"]
    for k in "uvp":
        scale = max(1.0, float(np.abs(theirs[k]).max()))
        assert float(np.abs(ours[k] - theirs[k]).max()) <= 1e-10 * scale
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
