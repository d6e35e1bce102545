"""The port's distributed NS-2D solver (models/ns2d_dist.py) against the
JAX package's NS2DDistSolver on the suite's 8 faked CPU devices, float64,
configs/dcavity.par and configs/canal.par cut to small grids, itermax 60,
a few steps, on divisible and ragged meshes, through the fused step and
the phase chain (the JAX package on the CPU runs its phase chain under
`auto`), and through the CLI. Every shard of the port lies on the CPU,
where the kernels run their plain versions.

Tolerances: where both packages run the same arithmetic (the quarter
layout K13 against the JAX grid CA, whose updates are the same operations;
the grid CA against itself) the fields agree within 1e-12; they are not
bitwise because XLA contracts the JAX package's multiply-adds. Where the
port runs K15 (a ragged mesh, `tpu_sor_layout checkerboard`) and the JAX
package its uniform-coefficient grid CA, the relaxation factor is formed
otherwise (omega/(2/dx² + 2/dy²) against omega·dx²dy²/(2(dx² + dy²))),
so the fields agree within 1e-10. Step counts and t agree exactly; the
iteration counts agree because the residual cadence is the same
(utils/dispatch.sor_cadence)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from pampi_tpu import cli as jcli
from pampi_tpu.models.ns2d_dist import NS2DDistSolver as JDistSolver
from pampi_tpu.parallel.comm import CartComm as JComm
from pampi_tpu.utils import dispatch as jdispatch
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.datio import read_pressure, read_velocity
from pampi_tpu_torch.utils.params import read_parameter

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
CPU = torch.device("cpu")
STEPS = 6


class JDist(JDistSolver):
    """The JAX solver with a chunk of STEPS steps (its chunk length is a
    class constant)."""

    CHUNK = STEPS


def _params(par, **kw):
    base = dict(te=1e9, itermax=60)
    base.update(kw)
    return (jread_parameter(str(CONFIGS / par)).replace(**base),
            read_parameter(str(CONFIGS / par)).replace(**base))


def _run_both(par, dims, **kw):
    jparam, param = _params(par, **kw)
    js = JDist(jparam, JComm(ndims=2, dims=dims))
    u, v, p, t, nt = js._chunk_sm(*js.initial_state())[:5]
    js.u, js.v, js.p = u, v, p
    s = NS2DDistSolver(param, CartComm(ndims=2, dims=dims, devices=[CPU]))
    s.run_steps(STEPS)
    return js, float(t), int(nt), s


def _assert_t(t, jt):
    # the canal's CFL dt reads maxima that round-off moves by an ulp
    assert abs(t - jt) <= 1e-14 * jt


def _assert_close(s, js, tol):
    got, want = s.global_fields(), js.global_fields()
    for name in "uvp":
        a, b = got[name], np.asarray(want[name])
        assert a.shape == b.shape == (s.jmax + 2, s.imax + 2)
        scale = max(1.0, float(np.abs(b).max()))
        d = float(np.abs(a - b).max())
        assert d <= tol * scale, (name, d)


CASES = [
    # (config, dims, grid (jmax, imax), port's solve, tolerance)
    ("dcavity.par", (2, 4), (16, 32), "pallas_quarters ca1", 1e-12),
    ("canal.par", (2, 4), (16, 32), "pallas_quarters ca1", 1e-12),
    ("dcavity.par", (1, 8), (16, 24), "jnp_ca", 1e-12),
    ("canal.par", (1, 8), (16, 24), "jnp_ca", 1e-12),
    ("dcavity.par", (2, 3), (36, 20), "pallas ca1 ragged", 1e-10),
    ("canal.par", (2, 3), (36, 20), "pallas ca1 ragged", 1e-10),
    ("dcavity.par", (8, 1), (18, 16), "pallas ca1 ragged", 1e-10),
    ("canal.par", (8, 1), (18, 16), "pallas ca1 ragged", 1e-10),
]


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("par,dims,grid,label,tol", CASES)
def test_steps_match_jax(par, dims, grid, label, tol, fuse):
    js, jt, jnt, s = _run_both(par, dims, jmax=grid[0], imax=grid[1],
                               tpu_fuse_phases=fuse)
    assert dispatch.last("ns2d_dist") == label
    assert jdispatch.last("ns2d_dist").startswith("jnp_ca")
    assert dispatch.last("ns2d_dist_phases") == (
        "pallas_fused" if fuse == "auto" else "jnp (tpu_fuse_phases off)")
    assert s.ragged == js.ragged == ("ragged" in label)
    assert s.nt == jnt == STEPS
    _assert_t(s.t, jt)
    _assert_close(s, js, tol)


def test_thin_ragged_shards_match_jax():
    """2-row shards on a ragged mesh: neither K15 nor the grid CA can ship
    the depth-3 strips, so the port runs the exchange-per-half-sweep
    fallback (recorded as the JAX package records its solve there), in
    the phase chain (the fused step needs 3 rows)."""
    js, jt, jnt, s = _run_both("dcavity.par", (8, 1), jmax=15, imax=12)
    assert dispatch.last("ns2d_dist") == "jnp_ca ragged"
    assert jdispatch.last("ns2d_dist") == "jnp_ca ragged"
    assert s.ragged and js.ragged and s.nt == jnt == STEPS
    _assert_t(s.t, jt)
    _assert_close(s, js, 1e-12)


def test_forced_checkerboard_on_2x2_matches_jax():
    """`tpu_sor_layout checkerboard` runs K15 on a divisible mesh, at the
    kernel's cadence (pinned to 1, the JAX grid CA's, so that the counts
    agree)."""
    js, jt, jnt, s = _run_both("dcavity.par", (2, 2), jmax=16, imax=16,
                               tpu_sor_layout="checkerboard",
                               tpu_sor_inner=1)
    assert dispatch.last("ns2d_dist") == "pallas ca1"
    assert s.nt == jnt
    _assert_t(s.t, jt)
    _assert_close(s, js, 1e-10)


def test_fused_from_a_random_state_matches_jax_kernels():
    """K3/K4 distributed and K13 (plain versions) against the JAX Pallas
    kernels in interpret mode (tpu_fuse_phases on, tpu_sor_layout
    quarters) on (2, 4), both from one seeded random state, n = 2."""
    kw = dict(jmax=16, imax=32, tpu_fuse_phases="on",
              tpu_sor_layout="quarters", tpu_sor_inner=2)
    jparam, param = _params("dcavity.par", **kw)
    rng = np.random.default_rng(3)
    state = {n: rng.normal(size=(16 + 2, 32 + 2)) * 0.1 for n in "uvp"}
    js = JDist(jparam, JComm(ndims=2, dims=(2, 4)))
    js.set_global_fields(state)
    u, v, p, t, nt = js._chunk_sm(*js.initial_state())[:5]
    js.u, js.v, js.p = u, v, p
    assert jdispatch.last("ns2d_dist") == "pallas_quarters ca2"
    assert jdispatch.last("ns2d_dist_phases") == "pallas_fused (forced)"
    s = NS2DDistSolver.from_numpy_state(
        param, CartComm(ndims=2, dims=(2, 4), devices=[CPU]), **state,
        t=0.0, nt=0)
    assert dispatch.last("ns2d_dist") == "pallas_quarters ca2"
    assert dispatch.last("ns2d_dist_phases") == "pallas_fused (forced)"
    s.run_steps(STEPS)
    assert s.nt == int(nt)
    _assert_t(s.t, float(t))
    _assert_close(s, js, 1e-12)


@pytest.mark.parametrize("dims", [(2, 2), (2, 3), (3, 3)])
def test_matches_the_single_device_solver(dims):
    """The distributed fused step against NS2DSolver on one device, the
    quarter layout on both sides of a divisible mesh; K15 on a ragged
    one."""
    _, param = _params("dcavity.par", jmax=18, imax=24)
    single = NS2DSolver(param, device="cpu")
    single.run_steps(STEPS)
    s = NS2DDistSolver(param, CartComm(ndims=2, dims=dims, devices=[CPU]))
    s.run_steps(STEPS)
    assert (s.nt, s.t) == (single.nt, single.t)
    g = s.global_fields()
    tol = 1e-12 if not s.ragged else 1e-10
    for name in "uvp":
        ref = getattr(single, name).numpy()
        assert np.abs(g[name] - ref).max() <= tol * max(1.0,
                                                        np.abs(ref).max())


def _run_cli(main, argv, path, capsys, monkeypatch, cls):
    """Run a CLI in `path`; returns (p, u, v from the .dat files, stdout,
    the step count the solver of class `cls` wrote them at)."""
    path.mkdir()
    monkeypatch.chdir(path)
    steps, write = [], cls.write_result

    def record(self, *a, **kw):
        steps.append(self.nt)
        return write(self, *a, **kw)

    monkeypatch.setattr(cls, "write_result", record)
    assert main(argv) == 0
    monkeypatch.setattr(cls, "write_result", write)
    out = capsys.readouterr().out
    return (read_pressure(str(path / "pressure.dat")),
            *read_velocity(str(path / "velocity.dat")), out, steps)


@pytest.mark.parametrize("par,mesh,te", [
    ("dcavity.par", "2x2", 0.002), ("dcavity.par", "3x2", 0.002),
    ("canal.par", "2x4", 0.5), ("canal.par", "3x2", 0.5)])
def test_cli_mesh_matches_jax_cli(par, mesh, te, tmp_path, capsys,
                                  monkeypatch):
    """configs/dcavity.par (100², f64) on 2x2 and the ragged 3x2 (34-row
    shards), configs/canal.par (200x50) on 2x4 and the ragged 3x2, through
    both CLIs: the same step count, pressure.dat and velocity.dat within
    1e-10 (the files print six decimals). dcavity.par is cut to te 0.002
    (16 steps) and itermax 100: every solve of its first steps runs to its
    itermax, which on the CPU costs the port a few ms a round."""
    text = (CONFIGS / par).read_text()
    cut = [("tpu_mesh", mesh), ("te", te)]
    if par == "dcavity.par":
        cut.append(("itermax", 100))
    for key, val in cut:
        text = re.sub(rf"^{key} .*$", f"{key} {val}", text, flags=re.M)
    path = tmp_path / par
    path.write_text(text)
    jout = _run_cli(jcli.main, ["pampi_tpu", str(path)], tmp_path / "jax",
                    capsys, monkeypatch, JDistSolver)
    out = _run_cli(cli.main, ["pampi_tpu_torch", "--device", "cpu",
                              str(path)], tmp_path / "torch", capsys,
                   monkeypatch, NS2DDistSolver)
    n = {"2x2": 4, "3x2": 6, "2x4": 8}[mesh]
    assert f"\t{n} shards share 1 device(s), placed round-robin" in \
        out[3].splitlines()
    assert out[4] == jout[4] and len(out[4]) == 1 and out[4][0] > 1
    for a, b in zip(out[:3], jout[:3]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-10


def test_refusals():
    """What the distributed NS-2D slice does not run raises, naming the
    ROADMAP item."""
    _, base = _params("dcavity.par", jmax=16, imax=16)
    comm = CartComm(ndims=2, dims=(2, 2), devices=[CPU])
    for kw in (dict(tpu_solver="mg"), dict(tpu_solver="fft"),
               dict(tpu_solver="auto"),  # takes fft on a divisible mesh
               dict(tpu_exchange_depth="1"),
               dict(tpu_itermax_adaptive=4),
               dict(obstacles="0.2,0.2,0.4,0.4", tpu_solver="mg")):
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            NS2DDistSolver(base.replace(**kw), comm)
    # obstacles run on a mesh; obstacle multigrid does not
    with pytest.raises(NotImplementedError,
                       match="obstacle multigrid .*ROADMAP A.8"):
        NS2DDistSolver(base.replace(obstacles="0.2,0.2,0.4,0.4",
                                    tpu_solver="mg"), comm)
    # auto takes sor on a ragged mesh
    s = NS2DDistSolver(base.replace(tpu_solver="auto", imax=15), comm)
    assert s.ragged and s.param.tpu_solver == "sor"
    with pytest.raises(ValueError, match="tpu_sor_layout quarters"):
        NS2DDistSolver(base.replace(imax=15, tpu_sor_layout="quarters"), comm)
    with pytest.raises(ValueError, match="2-D mesh"):
        NS2DDistSolver(base, CartComm(ndims=3, dims=(1, 2, 2),
                                      devices=[CPU]))


def test_dispatch_records_and_fallbacks():
    _, base = _params("dcavity.par", jmax=16, imax=16)
    NS2DDistSolver(base.replace(tpu_sor_inner=4, tpu_dtype="float32"),
                   CartComm(ndims=2, dims=(2, 2), devices=[CPU]))
    assert dispatch.last("ns2d_dist") == "pallas_quarters ca3"  # 8/2 - 1
    assert dispatch.last("ns2d_dist_phases") == "pallas_fused"
    assert dispatch.last("overlap_ns2d_dist") == "serial (no TPU)"
    # ragged, f64: the cadence is tpu_ca_inner; forced: the kernel's
    NS2DDistSolver(base.replace(imax=15, tpu_ca_inner=2),
                   CartComm(ndims=2, dims=(2, 2), devices=[CPU]))
    assert dispatch.last("ns2d_dist") == "pallas ca2 ragged"
    NS2DDistSolver(base.replace(tpu_sor_layout="checkerboard"),
                   CartComm(ndims=2, dims=(2, 2), devices=[CPU]))
    assert dispatch.last("ns2d_dist") == "pallas ca4"
    # 2-row shards: the CA cannot ship a ragged deep strip, and the fused
    # step needs 3
    NS2DDistSolver(base.replace(jmax=15, tpu_fuse_phases="auto"),
                   CartComm(ndims=2, dims=(8, 1), devices=[CPU]))
    assert dispatch.last("ns2d_dist") == "jnp_ca ragged"
    assert dispatch.last("ns2d_dist_phases") == \
        "jnp (shard extents < deep halo 3)"
