"""The port's distributed NS-3D solver (pampi_tpu_torch/models/ns3d_dist.py)
on the CPU, where K7, K8 and K14 run their plain versions, against the JAX
package's NS3DDistSolver on the suite's 8-device CPU mesh, against the
port's single-device NS3DSolver, against the reference's VTK output, and
through both CLIs.

Against JAX (float64): t and nt exactly, fields to 1e-10 (XLA contracts
multiply-adds that the port keeps apart). Against the port's single-device
solver: nt exactly, fields to 1e-12 (0.0 is what they give: every path
keeps the single-device trajectory; the JAX suite pins its own dist ==
single bitwise on these meshes). Every comparison runs tpu_sor_inner 1, so
both sides check the residual every iteration and stop at the same one.
Against the reference's VTK: 1e-6, the writer's `%f`."""

import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from pampi_tpu import cli as jcli
from pampi_tpu.models.ns3d_dist import NS3DDistSolver as JDist
from pampi_tpu.parallel.comm import CartComm as JComm
from pampi_tpu.utils import dispatch as jdispatch
from pampi_tpu.utils.grid import Grid as JGrid
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu.utils.vtkio import ShardedVtkWriter as JShardedVtkWriter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.grid import Grid
from pampi_tpu_torch.utils.params import parameter_from_dict, read_parameter
from pampi_tpu_torch.utils.vtkio import (
    ShardedVtkWriter,
    VtkWriter,
    read_vtk_ascii,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
FIX = ROOT / "tests" / "fixtures"
CPU = torch.device("cpu")


def _jparam(par="dcavity3d.par", **kw):
    """A JAX Parameter from configs/<par> cut to 16³, te 0.3, float64,
    tpu_sor_inner 1; dcavity3d at re 100."""
    base = {"imax": 16, "jmax": 16, "kmax": 16, "te": 0.3,
            "tpu_dtype": "float64", "tpu_sor_inner": 1}
    if par == "dcavity3d.par":
        base["re"] = 100.0
    return jread_parameter(str(CONFIGS / par)).replace(**{**base, **kw})


def _port_param(jparam):
    return parameter_from_dict(dataclasses.asdict(jparam))


def _comm(dims):
    return CartComm(ndims=3, dims=dims, devices=[CPU])


def _assert_fields_close(port, jax_, tol):
    pg, jg = port.global_fields(), jax_.global_fields()
    for name in "uvwp":
        d = np.abs(pg[name] - np.asarray(jg[name])).max()
        assert d <= tol, (name, d)
    for a, b in zip(port.collect(), jax_.collect()):
        assert np.abs(a - np.asarray(b)).max() <= tol


def _random_state(jparam, seed):
    rng = np.random.default_rng(seed)
    shape = (jparam.kmax + 2, jparam.jmax + 2, jparam.imax + 2)
    return {name: rng.normal(scale=0.1, size=shape) for name in "uvwp"}


@pytest.mark.parametrize("dims", [(2, 2, 2), (1, 2, 4)])
def test_phase_chain_matches_jax(dims):
    """tpu_fuse_phases off on both sides: the phase chain with the F/G/H
    shift; JAX solves in the grid-space CA path, the port in the octant
    layout (K14's plain version)."""
    jparam = _jparam(te=0.2, tpu_fuse_phases="off")
    js = JDist(jparam, JComm(ndims=3, dims=dims))
    js.run(progress=False)
    s = NS3DDistSolver(_port_param(jparam), _comm(dims))
    s.run(progress=False)
    assert dispatch.last("ns3d_dist_phases") == \
        jdispatch.last("ns3d_dist_phases") == "jnp (tpu_fuse_phases off)"
    assert dispatch.last("ns3d_dist") == "kernel_octants ca1"
    assert (s.nt, s.t) == (js.nt, js.t)
    assert s.nt > 5
    _assert_fields_close(s, js, 1e-10)


def test_fused_octants_from_a_random_state_match_jax():
    """K7, K8 and K14 (plain versions) on (2, 2, 2) against the JAX Pallas
    kernels in interpret mode (tpu_fuse_phases on, tpu_sor_layout
    octants), both from one seeded random state, n = 2 iterations per
    exchange and itermax 60."""
    jparam = _jparam(te=0.05, itermax=60, tpu_sor_inner=2,
                     tpu_fuse_phases="on", tpu_sor_layout="octants")
    state = _random_state(jparam, 7)
    js = JDist(jparam, JComm(ndims=3, dims=(2, 2, 2)))
    js.set_global_fields(state)
    js.run(progress=False)
    assert jdispatch.last("ns3d_dist") == "pallas_octants ca2"
    s = NS3DDistSolver.from_numpy_state(_port_param(jparam),
                                        _comm((2, 2, 2)), **state, t=0.0,
                                        nt=0)
    assert dispatch.last("ns3d_dist") == "kernel_octants ca2"
    assert dispatch.last("ns3d_dist_phases") == "kernel_fused (forced)"
    s.run(progress=False)
    assert (s.nt, s.t) == (js.nt, js.t)
    assert s.nt >= 3
    _assert_fields_close(s, js, 1e-10)


def test_canal3d_on_a_flow_axis_mesh_matches_jax():
    """configs/canal3d.par cut to 48x16x16, te 0.2, on (1, 1, 4): the
    inflow on the first shard, the outflow on the last, three seams across
    the flow; JAX on the CPU takes its phase chain, the port K7/K8/K14."""
    jparam = _jparam("canal3d.par", imax=48, te=0.2)
    js = JDist(jparam, JComm(ndims=3, dims=(1, 1, 4)))
    js.run(progress=False)
    s = NS3DDistSolver(_port_param(jparam), _comm((1, 1, 4)))
    s.run(progress=False)
    assert dispatch.last("ns3d_dist_phases") == "kernel_fused"
    assert (s.nt, s.t) == (js.nt, js.t)
    _assert_fields_close(s, js, 1e-10)


_single_cache = {}


def _single(param):
    key = dataclasses.astuple(param)
    if key not in _single_cache:
        one = NS3DSolver(param, device="cpu")
        one.run(progress=False)
        _single_cache[key] = (one.nt, one.t, one.collect())
    return _single_cache[key]


@pytest.mark.parametrize("dims,layout", [
    ((4, 2, 1), "auto"), ((1, 1, 8), "auto"), ((8, 1, 1), "auto"),
    ((2, 4, 1), "auto"), ((2, 1, 1), "auto"), ((2, 2, 2), "checkerboard"),
    ((16, 1, 1), "auto")])
def test_dist_matches_single_device(dims, layout):
    """The port's dist solver against its single-device NS3DSolver over
    the JAX suite's balanced and extreme meshes, te 0.2: the octant layout
    (K14) where every shard extent is even and >= 4, else the grid CA
    path; the fused step where every shard extent is >= 3, else the phase
    chain; the grid CA path on (2, 2, 2); and on (16, 1, 1), whose
    one-plane shards cannot ship a depth-2 strip, the exchange-per-half-
    sweep fallback. The residual is summed in
    another order than on one device, so an iteration count could move at
    the eps threshold; on these runs none does."""
    param = _port_param(_jparam(te=0.2, tpu_sor_layout=layout))
    nt, t, fields = _single(param.replace(tpu_sor_layout="auto"))
    s = NS3DDistSolver(param, _comm(dims))
    s.run(progress=False)
    assert (s.nt, s.t) == (nt, t)
    for a, b in zip(s.collect(), fields):
        assert np.abs(a - b).max() <= 1e-12
    thin = min(s.local) < 3
    assert dispatch.last("ns3d_dist_phases") == (
        "jnp (shard extents < deep halo 3)" if thin else "kernel_fused")
    octants = layout == "auto" and min(s.local) >= 4
    assert dispatch.last("ns3d_dist") == (
        "kernel_octants ca1" if octants else "jnp_ca")


def test_canal3d_fixture_on_a_mesh():
    """configs/canal3d.par at 48x16x16, te 0.5, tpu_sor_inner 1, on
    (2, 2, 2) against the reference's own VTK output: 1e-6."""
    param = read_parameter(str(CONFIGS / "canal3d.par")).replace(
        imax=48, jmax=16, kmax=16, te=0.5, tpu_sor_inner=1)
    s = NS3DDistSolver(param, _comm((2, 2, 2)))
    s.run(progress=False)
    ug, vg, wg, pg = s.collect()
    sg, vecg = read_vtk_ascii(str(FIX / "canal3d_48x16x16_te0.5.vtk"))
    assert np.abs(pg - sg["pressure"]).max() <= 1e-6
    for a, b in zip((ug, vg, wg), vecg["velocity"]):
        assert np.abs(a - b).max() <= 1e-6


def test_refusals():
    """What the distributed NS-3D slice does not run raises, naming the
    ROADMAP item (or, for a forced octant layout on odd shards, the JAX
    package's ValueError). Obstacles run under sor on any mesh; with mg
    they stay refused. On a mesh that does not divide the grid mg and fft
    raise the JAX package's ValueError (its refusal is permanent, so it
    comes before the ROADMAP item's), obstacles or not."""
    base = _port_param(_jparam())
    box = "0.2,0.2,0.2,0.6,0.6,0.6"
    for kw, mesh in ((dict(tpu_solver="mg"), (2, 2, 2)),
                     (dict(tpu_solver="fft"), (2, 2, 2)),
                     (dict(tpu_solver="auto"), (2, 2, 2)),  # takes fft
                     (dict(obstacles=box, tpu_solver="mg"), (2, 2, 2)),
                     (dict(tpu_exchange_depth="1"), (2, 2, 2)),
                     (dict(tpu_itermax_adaptive=4), (2, 2, 2))):
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            NS3DDistSolver(base.replace(**kw), _comm(mesh))
    jbase = _jparam()
    for kw in (dict(imax=18, tpu_solver="mg"),  # ragged
               dict(imax=18, tpu_solver="fft"),
               dict(imax=18, tpu_solver="mg", obstacles=box)):
        with pytest.raises(ValueError) as theirs:
            JDist(jbase.replace(**kw), JComm(ndims=3, dims=(1, 1, 4)))
        with pytest.raises(ValueError, match="needs a divisible") as ours:
            NS3DDistSolver(base.replace(**kw), _comm((1, 1, 4)))
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="tpu_sor_layout octants"):
        NS3DDistSolver(base.replace(imax=12, jmax=12, kmax=12,
                                    tpu_sor_layout="octants"),
                       _comm((4, 2, 1)))
    with pytest.raises(ValueError, match="3-D mesh"):
        NS3DDistSolver(base, CartComm(ndims=2, dims=(2, 2), devices=[CPU]))


def test_dispatch_records():
    base = _port_param(_jparam())
    NS3DDistSolver(base, _comm((2, 2, 2)))
    assert dispatch.last("ns3d_dist") == "kernel_octants ca1"
    assert dispatch.last("ns3d_dist_phases") == "kernel_fused"
    assert dispatch.last("overlap_ns3d_dist") == "serial (no TPU)"
    # float32 takes the kernel's depth (float64 checks every tpu_ca_inner)
    NS3DDistSolver(base.replace(tpu_sor_inner=4, tpu_dtype="float32"),
                   _comm((2, 2, 2)))
    assert dispatch.last("ns3d_dist") == "kernel_octants ca3"  # 8/2 - 1
    NS3DDistSolver(base.replace(tpu_fuse_phases="off", tpu_overlap="off",
                                tpu_sor_layout="checkerboard"),
                   _comm((1, 2, 4)))
    assert dispatch.last("ns3d_dist") == "jnp_ca"
    assert dispatch.last("ns3d_dist_phases") == "jnp (tpu_fuse_phases off)"
    assert dispatch.last("overlap_ns3d_dist") == "serial (tpu_overlap off)"
    NS3DDistSolver(base, _comm((8, 1, 1)))  # 2-cell shards along k
    assert dispatch.last("ns3d_dist") == "jnp_ca"
    assert dispatch.last("ns3d_dist_phases") == \
        "jnp (shard extents < deep halo 3)"
    assert dispatch.last("overlap_ns3d_dist") == (
        "serial (needs the fused deep-halo step (tpu_fuse_phases))")


def test_sharded_writer_bytes_match_binary_and_jax(tmp_path):
    """ShardedVtkWriter's file is VtkWriter(fmt="binary")'s, byte for byte,
    and the JAX package's ShardedVtkWriter's on the same slabs."""
    rng = np.random.default_rng(1)
    shape = (4, 6, 8)
    s, u, v, w = (rng.normal(size=shape) for _ in range(4))
    slabs = [((0, 0, 0), (slice(0, 2), slice(0, 6), slice(0, 4))),
             ((2, 0, 0), (slice(2, 4), slice(0, 6), slice(0, 4))),
             ((0, 0, 4), (slice(0, 2), slice(0, 6), slice(4, 8))),
             ((2, 0, 4), (slice(2, 4), slice(0, 6), slice(4, 8)))]
    out = {}
    for name, cls, grid in (
            ("port", ShardedVtkWriter, Grid(imax=8, jmax=6, kmax=4)),
            ("jax", JShardedVtkWriter, JGrid(imax=8, jmax=6, kmax=4))):
        path = tmp_path / f"{name}.vtk"
        wr = cls("dcavity", grid, path=str(path))
        wr.scalar("pressure", [(s[sl], o) for o, sl in slabs])
        wr.vector("velocity", [(u[sl], v[sl], w[sl], o) for o, sl in slabs])
        wr.close()
        out[name] = path.read_bytes()
    path = tmp_path / "binary.vtk"
    wr = VtkWriter("dcavity", Grid(imax=8, jmax=6, kmax=4), fmt="binary",
                   path=str(path))
    wr.scalar("pressure", s)
    wr.vector("velocity", u, v, w)
    wr.close()
    assert out["port"] == out["jax"] == path.read_bytes()


def _cli_par(tmp_path, mesh, vtk="ascii"):
    """configs/dcavity3d.par (re 1000) at 16³, te 0.5, float64,
    tpu_sor_inner 1, with `tpu_mesh mesh` and `tpu_vtk vtk`."""
    text = (CONFIGS / "dcavity3d.par").read_text()
    for key, val in (("imax", 16), ("jmax", 16), ("kmax", 16), ("te", 0.5),
                     ("tpu_dtype", "float64"), ("tpu_mesh", mesh)):
        text = re.sub(rf"^{key} .*$", f"{key} {val}", text, flags=re.M)
    text += f"\ntpu_sor_inner 1\ntpu_vtk {vtk}\n"
    par = tmp_path / f"dcavity3d_{mesh}_{vtk}.par"
    par.write_text(text)
    return par


def _run(main, argv, path, monkeypatch, capsys):
    path.mkdir()
    monkeypatch.chdir(path)
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_mesh_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """The 16³ dcavity3d .par with tpu_mesh 2x2x2 through both CLIs: the
    shard placement printed, the same step count, the ASCII VTK fields
    within 1e-6; without --device cpu and without a card the port's CLI
    raises."""
    par = _cli_par(tmp_path, "2x2x2")
    ran = []
    for cls in (JDist, NS3DDistSolver):
        run = cls.run

        def record(self, *a, _run=run, **kw):
            ran.append(self)
            return _run(self, *a, **kw)

        monkeypatch.setattr(cls, "run", record)
    _run(jcli.main, ["pampi_tpu", str(par)], tmp_path / "jax", monkeypatch,
         capsys)
    out = _run(cli.main, ["pampi_tpu_torch", "--device", "cpu", str(par)],
               tmp_path / "torch", monkeypatch, capsys)
    assert "\tShard 7 (1, 1, 1): cpu" in out
    assert "\t8 shards share 1 device(s), placed round-robin" in out
    jsolver, solver = ran
    assert solver.nt == jsolver.nt > 5
    so, vo = read_vtk_ascii(str(tmp_path / "torch" / "dcavity.vtk"))
    sj, vj = read_vtk_ascii(str(tmp_path / "jax" / "dcavity.vtk"))
    assert np.abs(so["pressure"] - sj["pressure"]).max() <= 1e-6
    for a, b in zip(vo["velocity"], vj["velocity"]):
        assert np.abs(a - b).max() <= 1e-6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["pampi_tpu_torch", str(par)])


def test_cli_sharded_vtk(tmp_path, monkeypatch, capsys):
    """tpu_vtk sharded: on the 2x2x2 mesh the port writes, slab by slab,
    the bytes its single-device run writes in binary (the fields are
    equal bitwise); JAX's sharded file holds the same values to 1e-12."""
    par = _cli_par(tmp_path, "2x2x2", "sharded")
    single = _cli_par(tmp_path, "1x1x1", "binary")
    _run(jcli.main, ["pampi_tpu", str(par)], tmp_path / "jax", monkeypatch,
         capsys)
    _run(cli.main, ["pampi_tpu_torch", "--device", "cpu", str(par)],
         tmp_path / "torch", monkeypatch, capsys)
    _run(cli.main, ["pampi_tpu_torch", "--device", "cpu", str(single)],
         tmp_path / "single", monkeypatch, capsys)
    sharded = (tmp_path / "torch" / "dcavity.vtk").read_bytes()
    assert sharded == (tmp_path / "single" / "dcavity.vtk").read_bytes()
    jbytes = (tmp_path / "jax" / "dcavity.vtk").read_bytes()
    head = sharded.index(b"LOOKUP_TABLE default\n") + 21
    assert jbytes[:head] == sharded[:head] and len(jbytes) == len(sharded)
    n = 16 ** 3
    ours = np.frombuffer(sharded[head:head + 8 * n], ">f8")
    theirs = np.frombuffer(jbytes[head:head + 8 * n], ">f8")
    assert np.abs(ours - theirs).max() <= 1e-12


def test_debug_and_verbose_lines(monkeypatch, capsys):
    """PAMPI_DEBUG prints one residual line per check and PAMPI_VERBOSE the
    step's time, once each (one controller: master_print prints for the
    mesh)."""
    monkeypatch.setenv("PAMPI_DEBUG", "1")
    monkeypatch.setenv("PAMPI_VERBOSE", "1")
    # float64 on a mesh checks every tpu_ca_inner iterations
    param = _port_param(_jparam(itermax=6, eps=0.0, tpu_ca_inner=2))
    s = NS3DDistSolver(param, _comm((2, 2, 2)))
    s.run_steps(1)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines if "Residuum" in ln] == \
        ["1", "3", "5"]
    assert [ln for ln in lines if ln.startswith("TIME")] == [
        f"TIME {s.t} , TIMESTEP {s.t}"]


# -- a mesh that does not divide the grid (the ragged pad-with-mask
# decomposition): the port against the JAX package on the same mesh ----------


def _jax_run_counts(jparam, dims, tmp_path, monkeypatch, cls=JDist):
    """JAX's distributed solver run to te one step a chunk, with its
    flight recorder on: the solver and every step's iteration count."""
    tel = tmp_path / "telemetry.jsonl"
    monkeypatch.setenv("PAMPI_TELEMETRY", str(tel))

    class OneStep(cls):
        CHUNK = 1

    js = OneStep(jparam, JComm(ndims=3, dims=dims))
    js.run(progress=False)
    monkeypatch.delenv("PAMPI_TELEMETRY")
    recs = [json.loads(ln) for ln in tel.read_text().splitlines()]
    return js, [r["iters"] for r in recs if r["kind"] == "chunk"]


def _port_run_counts(s):
    """The port's solver run to te: every step's iteration count."""
    its = []
    while s.t <= s.param.te:
        s.run_steps(1)
        its.append(int(s.last_it))
    return its


def assert_ragged_run_matches_jax(jparam, dims, tmp_path, monkeypatch, tol,
                                  records):
    """The port's NS3DDistSolver against JAX's on the same mesh: each
    step's iteration count, nt and t exactly, the fields to `tol`, and
    the dispatch records {key: label} both packages make."""
    js, jits = _jax_run_counts(jparam, dims, tmp_path, monkeypatch)
    jrec = {k: jdispatch.last(k) for k in records}
    s = NS3DDistSolver(_port_param(jparam), _comm(dims))
    assert s.ragged
    its = _port_run_counts(s)
    assert its == jits and len(its) >= 2
    assert (s.nt, s.t) == (js.nt, js.t)
    _assert_fields_close(s, js, tol)
    assert {k: dispatch.last(k) for k in records} == jrec == records
    return s


# (mesh, (kmax, jmax, imax), tpu_fuse_phases, other keys): the five
# ragged meshes, each run fused (K7/K8) or through the phase chain
RAGGED = [((4, 2, 1), (10, 10, 12), "off", {}),
          ((1, 2, 4), (10, 10, 18), "on", {}),
          ((2, 2, 2), (9, 11, 13), "on", dict(tpu_dtype="float32")),
          ((2, 2, 2), (7, 7, 7), "off", dict(tpu_ca_inner=2)),
          ((4, 1, 1), (9, 8, 8), "on", {})]


@pytest.mark.parametrize(
    "dims,shape,fuse,kw", RAGGED,
    ids=["4x2x1-chain", "1x2x4-fused", "2x2x2-fused-f32",
         "2x2x2-7cubed-ca2-chain", "4x1x1-ghost-fused"])
def test_ragged_mesh_matches_jax(dims, shape, fuse, kw, tmp_path,
                                 monkeypatch):
    """dcavity3d at re 100, te 0.2, on a mesh that does not divide the
    grid: the grid-space CA solve at halo 2n + 1 ("jnp_ca ragged"), the
    octants not dispatched; K7/K8 (ragged mode) against JAX's Pallas
    kernels in interpret mode, or the phase chain against JAX's. float64
    to 1e-10; the float32 case's counts must equal JAX's too (its
    cadence is tpu_ca_inner, as JAX's jnp path takes it), fields to
    1e-5."""
    k, j, i = shape
    jparam = _jparam(kmax=k, jmax=j, imax=i, te=0.2, tpu_fuse_phases=fuse,
                     **kw)
    f32 = kw.get("tpu_dtype") == "float32"
    assert_ragged_run_matches_jax(
        jparam, dims, tmp_path, monkeypatch, 1e-5 if f32 else 1e-10,
        {"ns3d_dist": "jnp_ca ragged"})
    assert dispatch.last("ns3d_dist_phases") == (
        "kernel_fused (forced)" if fuse == "on"
        else "jnp (tpu_fuse_phases off)")


def test_ragged_octants_forced_fails_as_jax():
    """tpu_sor_layout octants on a ragged mesh: the octant layout is not
    dispatched there, and a forced one raises as JAX's does."""
    jparam = _jparam(imax=12, jmax=12, kmax=10, tpu_sor_layout="octants")
    with pytest.raises(ValueError) as theirs:
        JDist(jparam, JComm(ndims=3, dims=(4, 2, 1)))
    with pytest.raises(ValueError) as ours:
        NS3DDistSolver(_port_param(jparam), _comm((4, 2, 1)))
    assert str(ours.value) == str(theirs.value)


def test_cli_ragged_mesh_matches_one_device(tmp_path, monkeypatch, capsys):
    """configs/canal3d.par cut to 18x8x8, te 0.3, on tpu_mesh 1x1x4, which
    does not divide imax 18: the CLI runs it on the mesh with no ROADMAP
    note, and its `tpu_vtk sharded` file (the gathered binary write on a
    ragged mesh) holds the bytes of the one-device binary run."""
    text = (CONFIGS / "canal3d.par").read_text()
    for key, val in (("imax", 18), ("jmax", 8), ("kmax", 8), ("te", 0.3)):
        text = re.sub(rf"^{key} .*$", f"{key} {val}", text, flags=re.M)
    files = {}
    for mesh, vtk in (("1x1x4", "sharded"), ("1", "binary")):
        par = tmp_path / f"canal3d_{mesh}.par"
        par.write_text(re.sub(r"^tpu_mesh .*$", f"tpu_mesh {mesh}", text,
                              flags=re.M) + f"\ntpu_vtk {vtk}\n")
        out = _run(cli.main, ["pampi_tpu_torch", "--device", "cpu",
                              str(par)], tmp_path / mesh, monkeypatch,
                   capsys)
        assert ("\tShard 3 (0, 0, 3): cpu" in out) == (mesh != "1")
        assert "ROADMAP" not in out
        files[mesh] = (tmp_path / mesh / "canal.vtk").read_bytes()
    assert files["1x1x4"] == files["1"]
