"""The port's NS-3D solver on the CPU against the JAX package, float64:

1. dcavity3d 12³, 20 steps, tpu_sor_inner 1, against NS3DSolver with
   tpu_fuse_phases off (the jnp chain, which checks convergence every
   iteration);
2. the same in both SOR layouts against the JAX fused chunk with the
   Pallas solve (`_build_chunk(backend="pallas")`, tpu_fuse_phases on,
   interpret kernels), at float64 (one iteration a call, the float64
   cadence) and at float32 with tpu_sor_inner 4, which pins the n_inner
   iteration accounting;
3. a JAX solver's state carried across with from_numpy_state;
4. configs/canal3d.par (48x16x16, te 0.5) and configs/dcavity3d.par (32³,
   te 1.0, float64) through the port's CLI (--device cpu) at tpu_sor_inner
   1 against the reference's own VTK output in tests/fixtures (1e-6, the
   writer's precision; 112 steps for dcavity3d, as the oracle's log);
5. the VTK writer's bytes against the JAX writer's, ASCII and BINARY.

Fields agree to 1e-10 at float64 (1e-5 of scale at float32); nt exactly,
t exactly at float64 (to 1e-6 at float32, whose CFL dt an ulp of the
maxima moves)."""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest

from pampi_tpu.models.ns3d import NS3DSolver as JNS3DSolver
from pampi_tpu.utils import native as jnative
from pampi_tpu.utils.grid import Grid as JGrid
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu.utils.vtkio import VtkWriter as JVtkWriter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.utils.grid import Grid
from pampi_tpu_torch.utils.params import parameter_from_dict
from pampi_tpu_torch.utils.vtkio import VtkWriter, read_vtk_ascii

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
STEPS = 20


def _jax_steps(backend=None, **kw):
    jparam = jread_parameter(str(ROOT / "configs" / "dcavity3d.par")).replace(
        imax=12, jmax=12, kmax=12, te=1e9, tpu_chunk=STEPS,
        **{"tpu_dtype": "float64", **kw})
    js = JNS3DSolver(jparam)
    if backend is not None:
        js._chunk_fn = jax.jit(js._build_chunk(backend=backend))
    u, v, w, p, t, nt = js._chunk_fn(*js.initial_state())
    return jparam, js, (u, v, w, p), float(t), int(nt)


def _port(jparam):
    return NS3DSolver(parameter_from_dict(dataclasses.asdict(jparam)),
                      device="cpu")


# float64 checks convergence every iteration (utils/dispatch.sor_cadence),
# so the JAX kernels forced in interpret mode run one iteration a call too;
# the n = 4 fold is held at float32 ("-f32"), where both packages run the
# kernel cadence, to 1e-5 of the field's scale (float32 round-off over 20
# steps; the float64 cases hold 1e-10 absolute)
F32 = dict(tpu_sor_inner=4, tpu_fuse_phases="on", tpu_dtype="float32")


@pytest.mark.parametrize("kw,backend", [
    (dict(tpu_sor_inner=1, tpu_fuse_phases="off"), None),
    (dict(tpu_sor_inner=1, tpu_fuse_phases="on", tpu_sor_layout="auto"),
     "pallas"),
    (dict(tpu_sor_inner=1, tpu_fuse_phases="on",
          tpu_sor_layout="checkerboard"), "pallas"),
    (dict(F32, tpu_sor_layout="auto"), "pallas"),
    (dict(F32, tpu_sor_layout="checkerboard"), "pallas"),
], ids=["jnp-chain", "fused-octants", "fused-checkerboard",
        "fused-octants-f32", "fused-checkerboard-f32"])
def test_dcavity3d_steps_match_jax(kw, backend):
    jparam, js, fields, jt, jnt = _jax_steps(backend, **kw)
    assert js._fused == (kw["tpu_fuse_phases"] == "on")
    s = _port(jparam)
    s.run_steps(STEPS)
    assert s.nt == jnt
    if kw.get("tpu_dtype") == "float32":
        # the float32 CFL dt reads maxima that round-off moves by an ulp
        assert abs(s.t - jt) <= 1e-6 * jt
    else:
        assert s.t == jt
    for name, ref in zip("uvwp", fields):
        ref = np.asarray(ref)
        assert getattr(s, name).numpy().dtype == ref.dtype
        d = np.abs(getattr(s, name).numpy() - ref).max()
        scale = (1.0 if ref.dtype == np.float64
                 else max(1.0, float(np.abs(ref).max())))
        tol = 1e-10 if ref.dtype == np.float64 else 1e-5
        assert d <= tol * scale, (name, d)


def test_from_numpy_state_carries_a_jax_state():
    jparam, _js, fields, jt, jnt = _jax_steps(
        tpu_sor_inner=1, tpu_fuse_phases="off")
    param = parameter_from_dict(dataclasses.asdict(jparam))
    s = NS3DSolver.from_numpy_state(param, *fields, jt, jnt, device="cpu")
    assert (s.t, s.nt) == (jt, STEPS)
    for name, ref in zip("uvwp", fields):
        assert np.array_equal(getattr(s, name).numpy(), np.asarray(ref))
    # the fields are copies: stepping the port leaves the JAX arrays alone
    before = [np.array(f) for f in fields]
    s.run_steps(1)
    assert s.nt == STEPS + 1
    for ref, b in zip(fields, before):
        assert np.array_equal(np.asarray(ref), b)


def _cli_vs_fixture(tmp_path, monkeypatch, capsys, par, lines, fixture,
                    output):
    """Run the CLI on configs/<par> with `lines` replaced, compare the VTK
    it writes with the fixture; returns the solver the CLI ran."""
    text = (ROOT / "configs" / par).read_text()
    for key, val in lines.items():
        text = "\n".join(ln for ln in text.splitlines()
                         if not ln.split() or ln.split()[0] != key)
        text += f"\n{key} {val}\n"
    (tmp_path / par).write_text(text)
    monkeypatch.chdir(tmp_path)
    ran, run = [], NS3DSolver.run

    def record_run(self, *a, **kw):
        ran.append(self)
        return run(self, *a, **kw)

    monkeypatch.setattr(NS3DSolver, "run", record_run)
    assert cli.main(["pampi_tpu_torch", "--device", "cpu", par]) == 0
    assert "Solution took" in capsys.readouterr().out
    so, vo = read_vtk_ascii(str(tmp_path / output))
    sg, vg = read_vtk_ascii(str(FIX / fixture))
    assert np.abs(so["pressure"] - sg["pressure"]).max() <= 1e-6
    for c in range(3):
        assert np.abs(vo["velocity"][c] - vg["velocity"][c]).max() <= 1e-6
    (solver,) = ran
    return solver


def test_canal3d_cli_matches_fixture(tmp_path, monkeypatch, capsys):
    _cli_vs_fixture(tmp_path, monkeypatch, capsys, "canal3d.par",
                    dict(imax=48, jmax=16, kmax=16, te=0.5, tpu_sor_inner=1),
                    "canal3d_48x16x16_te0.5.vtk", "canal.vtk")


def test_dcavity3d_cli_matches_fixture(tmp_path, monkeypatch, capsys):
    s = _cli_vs_fixture(tmp_path, monkeypatch, capsys, "dcavity3d.par",
                        dict(imax=32, jmax=32, kmax=32, te=1.0,
                             tpu_dtype="float64", tpu_sor_inner=1),
                        "dcavity3d_32_te1.0.vtk", "dcavity.vtk")
    assert s.nt == 112  # the oracle's log (tests/fixtures/dc3b.log)


def test_run_stops_after_te_like_jax():
    jparam = jread_parameter(str(ROOT / "configs" / "canal3d.par")).replace(
        imax=12, jmax=6, kmax=6, te=1.0, itermax=50, tpu_sor_inner=1,
        tpu_fuse_phases="off")
    js = JNS3DSolver(jparam)
    js.run(progress=False)
    s = _port(jparam)
    s.run(progress=False)
    assert (s.nt, s.t) == (js.nt, js.t)
    assert np.abs(s.u.numpy() - np.asarray(js.u)).max() <= 1e-10


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
@pytest.mark.parametrize("jax_writer", ["python", "default"])
def test_vtk_bytes_match_jax_writer(tmp_path, monkeypatch, fmt, jax_writer):
    if jax_writer == "python":
        monkeypatch.setattr(jnative, "available", lambda: False)
    rng = np.random.default_rng(0)
    s = rng.normal(size=(3, 4, 5))
    u, v, w = (rng.normal(size=(3, 4, 5)) for _ in range(3))
    out = {}
    for name, writer, grid in (
            ("port", VtkWriter, Grid(imax=5, jmax=4, kmax=3, xlength=2.0)),
            ("jax", JVtkWriter, JGrid(imax=5, jmax=4, kmax=3, xlength=2.0))):
        path = tmp_path / f"{name}.vtk"
        wr = writer("dcavity", grid, fmt=fmt, path=str(path))
        wr.scalar("pressure", s)
        wr.vector("velocity", u, v, w)
        wr.close()
        out[name] = path.read_bytes()
    assert out["port"] == out["jax"]
    if fmt == "ascii":
        so, vo = read_vtk_ascii(str(tmp_path / "port.vtk"))
        np.testing.assert_allclose(so["pressure"], s, atol=1e-6)
        np.testing.assert_allclose(vo["velocity"][2], w, atol=1e-6)


def test_write_result_default_path_and_binary(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jparam = jread_parameter(str(ROOT / "configs" / "dcavity3d.par")).replace(
        imax=6, jmax=4, kmax=5, tpu_dtype="float64")
    s = _port(jparam)
    s.run_steps(2)
    s.write_result(fmt="binary")
    raw = (tmp_path / "dcavity.vtk").read_bytes()
    assert raw.startswith(b"# vtk DataFile Version 3.0\n")
    head = b"LOOKUP_TABLE default\n"
    at = raw.index(head) + len(head)
    vals = np.frombuffer(raw[at:at + 8 * 120], dtype=">f8")
    np.testing.assert_array_equal(vals.reshape(5, 4, 6), s.collect()[3])
