"""The port's NS-2D solver on the CPU against the JAX package, float64:

1. dcavity 16², 20 steps, tpu_sor_inner 1, against NS2DSolver with
   tpu_fuse_phases off (the jnp chain);
2. the same with tpu_sor_layout checkerboard against the JAX fused path
   (tpu_fuse_phases on, interpret kernels), at float64 (one iteration a
   call, the float64 cadence) and at float32 with tpu_sor_inner 4, which
   pins the n_inner iteration accounting;
3. configs/dcavity.par with te 0.01 through the port's CLI (--device cpu)
   against the committed rb fixtures, the check tests/test_ns2d.py makes.

Fields agree to 1e-10 at float64 (1e-5 of scale at float32); nt exactly,
t exactly at float64 (to 1e-6 at float32, whose CFL dt an ulp of the
maxima moves)."""

import dataclasses
import pathlib

import numpy as np
import pytest

from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.utils.datio import read_pressure, read_velocity
from pampi_tpu_torch.utils.params import parameter_from_dict

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS = 20


def _jax_steps(**kw):
    jparam = jread_parameter(str(ROOT / "configs" / "dcavity.par")).replace(
        imax=16, jmax=16, te=1e9, tpu_chunk=STEPS, **kw)
    js = JNS2DSolver(jparam)
    u, v, p, t, nt = js._chunk_fn(*js.initial_state())
    return jparam, js, u, v, p, float(t), int(nt)


# float64 checks convergence every iteration (utils/dispatch.sor_cadence),
# so in "folded-fused" the JAX package's fused path, forced in interpret
# mode, runs one iteration a call too; the n = 4 fold is held at float32
# ("folded-fused-f32"), where both packages run the kernel cadence, to
# 1e-5 of the field's scale (float32 round-off over 20 steps; the float64
# cases hold 1e-10 absolute)
@pytest.mark.parametrize("kw,tol", [
    (dict(tpu_sor_inner=1, tpu_fuse_phases="off"), 1e-10),
    (dict(tpu_sor_inner=1, tpu_fuse_phases="on",
          tpu_sor_layout="checkerboard"), 1e-10),
    (dict(tpu_sor_inner=4, tpu_fuse_phases="on",
          tpu_sor_layout="checkerboard", tpu_dtype="float32"), 1e-5),
], ids=["jnp-chain", "folded-fused", "folded-fused-f32"])
def test_dcavity_steps_match_jax(kw, tol):
    jparam, js, ju, jv, jp, jt, jnt = _jax_steps(**kw)
    assert js._fused == (kw["tpu_fuse_phases"] == "on")
    s = NS2DSolver(parameter_from_dict(dataclasses.asdict(jparam)),
                   device="cpu")
    s.run_steps(STEPS)
    assert s.nt == jnt
    if kw.get("tpu_dtype") == "float32":
        # the float32 CFL dt reads maxima that round-off moves by an ulp
        assert abs(s.t - jt) <= 1e-6 * jt
    else:
        assert s.t == jt
    for name, ref in (("u", ju), ("v", jv), ("p", jp)):
        ref = np.asarray(ref)
        assert getattr(s, name).numpy().dtype == ref.dtype
        d = np.abs(getattr(s, name).numpy() - ref).max()
        scale = (1.0 if ref.dtype == np.float64
                 else max(1.0, float(np.abs(ref).max())))
        assert d <= tol * scale, (name, d)


def test_dcavity_par_cli_matches_rb_fixtures(tmp_path, monkeypatch, capsys):
    par = tmp_path / "dcavity.par"
    text = (ROOT / "configs" / "dcavity.par").read_text()
    par.write_text(text.replace("te         10.0", "te         0.01"))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["pampi_tpu_torch", "--device", "cpu", str(par)]) == 0
    assert "Solution took" in capsys.readouterr().out
    fix = ROOT / "tests" / "fixtures"
    p = read_pressure(str(tmp_path / "pressure.dat"))
    u, v = read_velocity(str(tmp_path / "velocity.dat"))
    pg = read_pressure(str(fix / "dcavity_rb_te0.01_pressure.dat"))
    ug, vg = read_velocity(str(fix / "dcavity_rb_te0.01_velocity.dat"))
    assert np.abs(p - pg).max() <= 1e-6
    assert np.abs(u - ug).max() <= 1e-6
    assert np.abs(v - vg).max() <= 1e-6


def test_run_stops_after_te_like_jax():
    """run() takes a step whenever t <= te at its start, as the JAX drive
    loop does: same final t and nt."""
    jparam = jread_parameter(str(ROOT / "configs" / "dcavity.par")).replace(
        imax=16, jmax=16, te=0.05, tpu_sor_inner=1, tpu_fuse_phases="off")
    js = JNS2DSolver(jparam)
    js.run(progress=False)
    s = NS2DSolver(parameter_from_dict(dataclasses.asdict(jparam)),
                   device="cpu")
    s.run(progress=False)
    assert (s.nt, s.t) == (js.nt, js.t)
    assert np.abs(s.u.numpy() - np.asarray(js.u)).max() <= 1e-10


def test_cli_refuses_unported_problems(tmp_path, capsys):
    """canal_obstacle runs since 2-D obstacles are ported, and under
    tpu_solver mg on one device since obstacle multigrid is; what stays
    refused on it is obstacle multigrid on an explicit mesh, named by its
    ROADMAP item."""
    par = tmp_path / "co.par"
    par.write_text("name canal_obstacle\nobstacles 0.2,0.2,0.4,0.4\n"
                   "tpu_solver mg\ntpu_mesh 2x2\n")
    assert cli.main(["pampi_tpu_torch", "--device", "cpu", str(par)]) == 1
    err = capsys.readouterr().err
    assert "obstacle multigrid" in err and "ROADMAP A.8" in err
