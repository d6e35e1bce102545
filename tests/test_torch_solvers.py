"""The alternative pressure solvers (`tpu_solver mg|fft|auto`) through the
port's entry points on the CPU against the JAX package, float64:

1. PoissonSolver: the same V-cycle count (mg) or 1 (fft) and fields to
   1e-10, on configs/poisson.par (a single-level plan at the default
   bottom budget) and at 64² with the budget lowered to a 3-level plan;
2. NS2DSolver dcavity 32² and NS3DSolver dcavity3d 16³, 10 steps, budget
   lowered (3 and 2 levels), for mg (the fused cycle and the ladder), fft
   and auto: t and nt exact, fields to 1e-10 (the JAX runs are its jnp
   chains, whose mg is the ladder off the TPU);
3. auto resolves to fft on a plain grid and records why;
4. both CLIs on configs/poisson.par (mg), dcavity.par (auto) and
   dcavity3d.par (mg) cut to small grids, and on
   configs/dcavity3d_fast.par (fft, float32) cut to 16³ and a few steps:
   the same iteration line and output files to one unit in their last
   printed digit.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from pampi_tpu import cli as jcli
from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver
from pampi_tpu.models.ns3d import NS3DSolver as JNS3DSolver
from pampi_tpu.models.poisson import PoissonSolver as JPoissonSolver
from pampi_tpu.ops import multigrid as jmg
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.models.poisson import PoissonSolver
from pampi_tpu_torch.ops import multigrid as tmg
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.params import parameter_from_dict
from pampi_tpu_torch.utils.vtkio import read_vtk_ascii

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
STEPS = 10


def _lower_budget(monkeypatch, cells):
    monkeypatch.setattr(jmg, "_DCT_BOTTOM_MAX_CELLS", cells)
    monkeypatch.setattr(tmg, "_DCT_BOTTOM_MAX_CELLS", cells)


def _port_param(jparam):
    return parameter_from_dict(dataclasses.asdict(jparam))


def _max_diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("solver,size,budget", [
    ("mg", 100, None), ("mg", 64, 256), ("fft", 100, None)])
def test_poisson_matches_jax(solver, size, budget, monkeypatch):
    if budget is not None:
        _lower_budget(monkeypatch, budget)
    jparam = jread_parameter(str(CONFIGS / "poisson.par")).replace(
        imax=size, jmax=size, tpu_solver=solver)
    js = JPoissonSolver(jparam)
    j_it, j_res = js.solve()
    s = PoissonSolver(_port_param(jparam), device="cpu")
    it, res = s.solve()
    assert it == j_it
    assert res < jparam.eps ** 2 and j_res < jparam.eps ** 2
    assert _max_diff(s.p.numpy(), js.p) <= 1e-10
    if solver == "mg":
        levels = 1 if budget is None else 3
        rec = dispatch.last("mg2d_fused")
        assert rec.startswith("ladder (single-level" if levels == 1
                              else "fused cycle (auto"), rec


def _ns2d(monkeypatch, **kw):
    _lower_budget(monkeypatch, 64)
    jparam = jread_parameter(str(CONFIGS / "dcavity.par")).replace(
        imax=32, jmax=32, te=1e9, tpu_chunk=STEPS, tpu_fuse_phases="off",
        **kw)
    return jparam


@pytest.mark.parametrize("solver,fused", [
    ("mg", "auto"), ("mg", "off"), ("fft", "auto"), ("auto", "auto")])
def test_ns2d_matches_jax(solver, fused, monkeypatch):
    jparam = _ns2d(monkeypatch, tpu_solver=solver, tpu_mg_fused=fused)
    js = JNS2DSolver(jparam)
    u, v, p, t, nt = js._chunk_fn(*js.initial_state())
    s = NS2DSolver(_port_param(jparam), device="cpu")
    s.run_steps(STEPS)
    assert (s.nt, s.t) == (int(nt), float(t))
    for name, ref in (("u", u), ("v", v), ("p", p)):
        d = _max_diff(getattr(s, name).numpy(), ref)
        assert d <= 1e-10, (name, d)
    if solver == "mg":
        want = "fused cycle (auto" if fused == "auto" else "ladder"
        assert dispatch.last("mg2d_fused").startswith(want)


@pytest.mark.parametrize("solver,fused", [
    ("mg", "auto"), ("mg", "off"), ("fft", "auto"), ("auto", "auto")])
def test_ns3d_matches_jax(solver, fused, monkeypatch):
    _lower_budget(monkeypatch, 512)
    jparam = jread_parameter(str(CONFIGS / "dcavity3d.par")).replace(
        imax=16, jmax=16, kmax=16, te=1e9, tpu_chunk=STEPS,
        tpu_dtype="float64", tpu_fuse_phases="off", tpu_solver=solver,
        tpu_mg_fused=fused)
    js = JNS3DSolver(jparam)
    fields = js._chunk_fn(*js.initial_state())
    s = NS3DSolver(_port_param(jparam), device="cpu")
    s.run_steps(STEPS)
    assert (s.nt, s.t) == (int(fields[5]), float(fields[4]))
    for name, ref in zip("uvwp", fields):
        d = _max_diff(getattr(s, name).numpy(), ref)
        assert d <= 1e-10, (name, d)
    if solver == "mg":
        want = "fused cycle (auto" if fused == "auto" else "ladder"
        assert dispatch.last("mg3d_fused").startswith(want)


def test_auto_resolves_to_fft_and_records_why():
    param = _port_param(jread_parameter(str(CONFIGS / "dcavity.par")).replace(
        imax=16, jmax=16, tpu_solver="auto"))
    s = NS2DSolver(param, device="cpu")
    assert s.param.tpu_solver == "fft"
    assert dispatch.last("solver_auto") == (
        "fft (plain grid: exact DCT direct solve)")
    assert dispatch.last("ns2d_step") == "pre -> fft -> post on cpu"
    s3 = NS3DSolver(param.replace(name="dcavity3d", kmax=8), device="cpu")
    assert s3.param.tpu_solver == "fft"


def _cut_par(tmp_path, name, lines):
    text = (CONFIGS / name).read_text()
    for key, val in lines.items():
        text = "\n".join(ln for ln in text.splitlines()
                         if not ln.split() or ln.split()[0] != key)
        text += f"\n{key} {val}\n"
    par = tmp_path / name
    par.write_text(text)
    return par


def _read(path):
    if path.suffix == ".vtk":
        scalars, vectors = read_vtk_ascii(str(path))
        return [scalars["pressure"], *vectors["velocity"]]
    return [np.loadtxt(path)]


@pytest.mark.parametrize("name,lines,outputs", [
    ("poisson.par", dict(tpu_solver="mg"), ["p.dat"]),
    ("dcavity.par", dict(imax=32, jmax=32, te=0.05, tpu_solver="auto"),
     ["pressure.dat", "velocity.dat"]),
    ("dcavity3d.par", dict(imax=16, jmax=16, kmax=16, te=0.1,
                           tpu_dtype="float64", tpu_solver="mg",
                           tpu_vtk="ascii"), ["dcavity.vtk"]),
    ("dcavity3d_fast.par", dict(imax=16, jmax=16, kmax=16, te=0.1,
                                tpu_vtk="ascii"), ["dcavity.vtk"]),
], ids=["poisson-mg", "dcavity-auto", "dcavity3d-mg", "dcavity3d_fast-fft"])
def test_cli_matches_jax_cli(name, lines, outputs, tmp_path, monkeypatch,
                             capsys):
    """Both CLIs on the same cut .par: the same printed iteration count
    (Poisson) and the same output files to one unit in their last printed
    digit (%f; the float32 fft config's matrix products sum in another
    order)."""
    # one device in both packages (the JAX CLI would take its 8 test
    # devices as a mesh under `tpu_mesh auto`)
    par = _cut_par(tmp_path, name, dict(lines, tpu_mesh=1))
    runs = {}
    for pkg, main, argv0 in (("jax", jcli.main, "pampi_tpu"),
                             ("torch", cli.main, "pampi_tpu_torch")):
        out = tmp_path / pkg
        out.mkdir()
        monkeypatch.chdir(out)
        argv = [argv0, str(par)] if pkg == "jax" else \
            [argv0, "--device", "cpu", str(par)]
        assert main(argv) == 0
        text = capsys.readouterr().out
        count = [ln.split()[0] for ln in text.splitlines()
                 if "Walltime" in ln]
        runs[pkg] = count, [a for f in outputs for a in _read(out / f)]
    assert runs["torch"][0] == runs["jax"][0]
    for ours, theirs in zip(runs["torch"][1], runs["jax"][1]):
        assert ours.shape == theirs.shape
        assert _max_diff(ours, theirs) <= 2e-6
