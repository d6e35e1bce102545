"""The SOR solves' residual cadence (utils/dispatch.sor_cadence) against
the JAX package at float64 with the shipped defaults (`tpu_sor_inner 4`,
`tpu_ca_inner 1`): the JAX package checks every iteration there on one
device and every `tpu_ca_inner` on a mesh, so the iteration counts of the
two packages are equal and their fields agree to round-off. Also the
refusal of the DMVM command form, which is not ported."""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver
from pampi_tpu.models.ns3d import NS3DSolver as JNS3DSolver
from pampi_tpu.models.ns3d_dist import NS3DDistSolver as JNS3DDist
from pampi_tpu.models.poisson import PoissonSolver as JPoisson
from pampi_tpu.models.poisson_dist import DistPoissonSolver as JDistPoisson
from pampi_tpu.parallel.comm import CartComm as JComm
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
from pampi_tpu_torch.models.poisson import PoissonSolver
from pampi_tpu_torch.models.poisson_dist import DistPoissonSolver
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils.dispatch import sor_cadence
from pampi_tpu_torch.utils.params import Parameter, parameter_from_dict

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
CPU = torch.device("cpu")


def _port(jparam):
    return parameter_from_dict(dataclasses.asdict(jparam))


def test_cadence_rule():
    p = Parameter(tpu_sor_inner=4, tpu_ca_inner=2)
    f32, f64 = torch.float32, torch.float64
    assert sor_cadence(p, f32) == 4
    assert sor_cadence(p, f64) == 1
    assert sor_cadence(p, f32, mesh=True) == 4
    assert sor_cadence(p, f64, mesh=True) == 2
    assert sor_cadence(p, f64, mesh=True, forced=True) == 4
    assert sor_cadence(p, f64, mesh=True, clamp=lambda n: min(n, 1)) == 1
    assert sor_cadence(p, f32, mesh=True, clamp=lambda n: min(n, 3)) == 3


@pytest.mark.parametrize("n,count", [(64, 1065), (50, 686)])
def test_poisson_f64_counts_match_jax(n, count):
    """One device and a 2x2 mesh: the JAX package's count, which the
    previous cadence of 4 missed by 3 (64²) and 2 (50²)."""
    jparam = jread_parameter(str(CONFIGS / "poisson.par")).replace(
        imax=n, jmax=n)
    assert (jparam.tpu_sor_inner, jparam.tpu_ca_inner,
            jparam.tpu_dtype) == (4, 1, "float64")
    param = _port(jparam)
    j1 = JPoisson(jparam).solve()[0]
    jd = JDistPoisson(jparam.replace(tpu_mesh="2x2"),
                      comm=JComm(ndims=2, dims=(2, 2))).solve()[0]
    assert j1 == jd == count
    assert PoissonSolver(param, device="cpu").solve()[0] == count
    dist = DistPoissonSolver(param.replace(tpu_mesh="2x2"),
                             CartComm(ndims=2, dims=(2, 2), devices=[CPU]))
    assert dist.solve()[0] == count


def test_poisson_par_still_2388():
    param = _port(jread_parameter(str(CONFIGS / "poisson.par")))
    assert PoissonSolver(param, device="cpu").solve()[0] == 2388


def test_ns2d_dcavity_64_f64_matches_jax():
    """dcavity 64², 10 steps, f64 with the defaults: within 1e-12 of the
    JAX package (its jnp chain; the port's K1/K3/K4 plain versions)."""
    steps = 10
    jparam = jread_parameter(str(CONFIGS / "dcavity.par")).replace(
        imax=64, jmax=64, te=1e9, tpu_chunk=steps)
    js = JNS2DSolver(jparam)
    u, v, p, t, nt = js._chunk_fn(*js.initial_state())
    s = NS2DSolver(_port(jparam), device="cpu")
    s.run_steps(steps)
    assert (s.nt, int(nt)) == (steps, steps)
    assert abs(s.t - float(t)) <= 1e-15 * float(t)
    for name, ref in (("u", u), ("v", v), ("p", p)):
        d = np.abs(getattr(s, name).numpy() - np.asarray(ref)).max()
        assert d <= 1e-12, (name, d)


def _ns3d_param():
    return jread_parameter(str(CONFIGS / "dcavity3d.par")).replace(
        imax=16, jmax=16, kmax=16, tpu_dtype="float64")


def test_ns3d_dcavity3d_16_f64_matches_jax():
    """dcavity3d 16³, 8 steps, f64 with the defaults, on one device."""
    steps = 8
    jparam = _ns3d_param().replace(te=1e9, tpu_chunk=steps)
    assert (jparam.tpu_sor_inner, jparam.tpu_ca_inner) == (4, 1)
    js = JNS3DSolver(jparam)
    *fields, t, nt = js._chunk_fn(*js.initial_state())
    s = NS3DSolver(_port(jparam), device="cpu")
    s.run_steps(steps)
    assert s.nt == int(nt) == steps
    for name, ref in zip("uvwp", fields):
        d = np.abs(getattr(s, name).numpy() - np.asarray(ref)).max()
        assert d <= 1e-10, (name, d)


def test_ns3d_dcavity3d_16_f64_on_2x2x2_matches_jax():
    """The same grid on a 2x2x2 mesh, to te 0.6 (the step count of both
    packages equal)."""
    jparam = _ns3d_param().replace(te=0.6)
    js = JNS3DDist(jparam, JComm(ndims=3, dims=(2, 2, 2)))
    js.run(progress=False)
    s = NS3DDistSolver(_port(jparam),
                       CartComm(ndims=3, dims=(2, 2, 2), devices=[CPU]))
    s.run(progress=False)
    assert s.nt == js.nt >= 8
    jf, f = js.global_fields(), s.global_fields()
    for name in "uvwp":
        d = np.abs(f[name] - np.asarray(jf[name])).max()
        assert d <= 1e-10, (name, d)


def test_dmvm_form_is_refused_naming_its_item(capsys):
    """`python -m pampi_tpu_torch <N> <iter>`, the JAX package's DMVM
    form, exits non-zero naming ROADMAP A.7."""
    assert cli.main(["pampi_tpu_torch", "1000", "10"]) != 0
    assert "ROADMAP A.7" in capsys.readouterr().err


def test_jax_runs_on_cpu_here():
    # the JAX package's counts above are its CPU dispatch, which at
    # float64 equals its TPU dispatch (no Pallas kernel takes f64)
    assert jax.default_backend() == "cpu"
