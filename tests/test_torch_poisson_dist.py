"""The port's distributed Poisson solver (pampi_tpu_torch/models/
poisson_dist.py) against the JAX package's DistPoissonSolver on the suite's
8-device CPU mesh, against the port's single-device solver, and through
both CLIs. Every shard of the port lies on the CPU (where K13 runs its
plain version), so the CPU runs the card's choreography."""

import pathlib

import numpy as np
import pytest
import torch

from pampi_tpu import cli as jcli
from pampi_tpu.models.poisson_dist import DistPoissonSolver as JDist
from pampi_tpu.parallel.comm import CartComm as JComm
from pampi_tpu.utils import dispatch as jdispatch
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.poisson import PoissonSolver
from pampi_tpu_torch.models.poisson_dist import DistPoissonSolver
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.datio import read_matrix
from pampi_tpu_torch.utils.params import Parameter, read_parameter

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
CPU = torch.device("cpu")


def _both(dims, **kw):
    """(port solver, JAX solver) of the same Parameter on a `dims` mesh."""
    port = DistPoissonSolver(Parameter(**kw), CartComm(ndims=2, dims=dims,
                                                       devices=[CPU]))
    jax_ = JDist(JParameter(**kw), comm=JComm(ndims=2, dims=dims))
    return port, jax_


def _quarters(**kw):
    return dict(dict(imax=64, jmax=64, itermax=96, eps=1e-12, omg=1.9,
                     tpu_dtype="float64", tpu_sor_layout="quarters"), **kw)


@pytest.mark.parametrize("dims", [(2, 4), (1, 8), (8, 1), (2, 2)])
def test_forced_quarters_match_jax_and_single_device(dims):
    """f64, itermax 96 (a multiple of every clamped depth: n = 3 on the
    thin meshes, 4 elsewhere): the JAX solve runs its Pallas kernel in
    interpret mode, the port K13's plain version."""
    port, jax_ = _both(dims, **_quarters())
    it, _res = port.solve()
    assert dispatch.last("poisson_dist") == \
        jdispatch.last("poisson_dist").replace("pallas", "kernel")
    assert it == jax_.solve()[0] == 96
    single = PoissonSolver(Parameter(**_quarters(
        tpu_sor_layout="checkerboard")), device="cpu")
    assert single.solve()[0] == 96
    full = port.full_field()
    np.testing.assert_allclose(full, jax_.full_field(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(full, single.p.numpy(), rtol=0, atol=1e-12)


def test_ca_depth_independence_bitwise():
    fields = []
    for n in (1, 2, 3):
        s = DistPoissonSolver(
            Parameter(**_quarters(itermax=24, tpu_ca_inner=n,
                                  tpu_sor_inner=n)),
            CartComm(ndims=2, dims=(2, 4), devices=[CPU]))
        assert s.solve()[0] == 24
        assert dispatch.last("poisson_dist") == f"kernel_quarters ca{n}"
        fields.append(s.full_field())
    np.testing.assert_array_equal(fields[0], fields[1])
    np.testing.assert_array_equal(fields[0], fields[2])


def test_float32_close_to_jax():
    port, jax_ = _both((2, 4), **_quarters(tpu_dtype="float32", itermax=120))
    assert port.solve()[0] == jax_.solve()[0] == 120
    assert port.p[0].dtype == torch.float32
    np.testing.assert_allclose(port.full_field(), jax_.full_field(), rtol=0,
                               atol=5e-5)


@pytest.mark.parametrize("case", ["checkerboard", "ragged", "extent1"])
def test_grid_paths_match_jax(case):
    """The grid communication-avoiding path (checkerboard layout at CA
    depth 2), a ragged grid (36x20 on (2, 3): pad-with-mask at halo 2n+1)
    and a mesh of extent-1 shards (the exchange-per-half-sweep fallback),
    each converging on eps: the same count, fields to 1e-12."""
    kw, dims, tag = {
        "checkerboard": (dict(imax=32, jmax=32, tpu_sor_layout="checkerboard",
                              tpu_ca_inner=2), (2, 2), "jnp_ca ca2"),
        "ragged": (dict(imax=20, jmax=36), (2, 3), "jnp_ca ca1 ragged"),
        "extent1": (dict(imax=8, jmax=8), (8, 1), "jnp_rb_fallback"),
    }[case]
    kw = dict(kw, eps=1e-3, omg=1.8, itermax=5000)
    port, jax_ = _both(dims, **kw)
    it, res = port.solve()
    assert dispatch.last("poisson_dist") == tag == \
        jdispatch.last("poisson_dist")
    jit, jres = jax_.solve()
    assert it == jit and 0 < it < 5000
    assert res == pytest.approx(jres, rel=1e-9)
    np.testing.assert_allclose(port.full_field(), jax_.full_field(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("layout", ["quarters", "checkerboard"])
def test_resumed_solve_equals_one_long_solve(layout):
    """Ghost reconstruction on a resumed solve (Neumann walls from the
    interior, not the analytic init) keeps the trajectory."""
    def solver(itermax):
        return DistPoissonSolver(
            Parameter(imax=32, jmax=32, itermax=itermax, eps=1e-30, omg=1.8,
                      tpu_sor_layout=layout),
            CartComm(ndims=2, dims=(2, 2), devices=[CPU]))
    long = solver(64)
    long.solve()
    short = solver(32)
    short.solve()
    short.solve()
    np.testing.assert_array_equal(long.full_field(), short.full_field())


def test_refusals():
    mesh = CartComm(ndims=2, dims=(2, 2), devices=[CPU])
    for solver in ("mg", "fft"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            DistPoissonSolver(Parameter(imax=16, jmax=16, tpu_solver=solver),
                              mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        DistPoissonSolver(Parameter(imax=16, jmax=16, tpu_solver="auto"),
                          mesh)  # auto takes fft on a divisible grid
    for solver in ("sor_lex", "sor_rba"):
        with pytest.raises(ValueError, match="single-device oracle"):
            DistPoissonSolver(Parameter(imax=16, jmax=16, tpu_solver=solver),
                              mesh)
    with pytest.raises(ValueError, match="tpu_sor_layout quarters"):
        DistPoissonSolver(Parameter(imax=20, jmax=36,
                                    tpu_sor_layout="quarters"),
                          CartComm(ndims=2, dims=(2, 3), devices=[CPU]))
    # NS-2D sor runs on a mesh (models/ns2d_dist.py); mg there does not
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        NS2DSolver(Parameter(name="dcavity", imax=16, jmax=16,
                             tpu_mesh="2x2", tpu_solver="mg"), device="cpu")


def _run_cli(main, argv, path, capsys, monkeypatch):
    path.mkdir()
    monkeypatch.chdir(path)
    assert main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    count = [ln.split()[0] for ln in lines if "Walltime" in ln]
    return count, read_matrix(str(path / "p.dat")), lines


def test_cli_mesh_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """configs/poisson.par (100², f64, eps 1e-6) with tpu_mesh 2x2 through
    both CLIs: the same iteration count (2388, the single-device count)
    and p.dat within 1e-10."""
    par = tmp_path / "poisson.par"
    par.write_text((CONFIGS / "poisson.par").read_text().replace(
        "tpu_mesh   auto", "tpu_mesh   2x2"))
    assert read_parameter(str(par)).tpu_mesh == "2x2"
    jcount, jp, _ = _run_cli(jcli.main, ["pampi_tpu", str(par)],
                             tmp_path / "jax", capsys, monkeypatch)
    count, p, lines = _run_cli(
        cli.main, ["pampi_tpu_torch", "--device", "cpu", str(par)],
        tmp_path / "torch", capsys, monkeypatch)
    assert count == jcount == ["2388"]
    assert "\t4 shards share 1 device(s), placed round-robin" in lines
    # float64 checks every tpu_ca_inner (1) iterations, as JAX's jnp_ca
    assert dispatch.last("poisson_dist") == "kernel_quarters ca1"
    assert p.shape == (102, 102)
    assert np.abs(p - jp).max() <= 1e-10
