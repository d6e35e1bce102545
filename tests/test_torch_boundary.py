"""The port's boundary and device rules:

- importing and running pampi_tpu_torch (bfloat16 runs included) loads
  neither jax, ml_dtypes nor pampi_tpu (checked in a fresh interpreter),
  and no file of the port imports them;
- an entry point asked for CUDA without a GPU raises, it never runs on the
  CPU quietly;
- state crosses from the JAX package to the port and back unchanged;
- a failed kernel build raises."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch.kernels import build as kb
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
from pampi_tpu_torch.models.poisson import PoissonSolver
from pampi_tpu_torch.utils.params import (
    Parameter,
    parameter_from_dict,
    read_parameter,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "pampi_tpu_torch"


def _forbidden(name: str) -> bool:
    return (name.startswith("jax") or name == "pampi_tpu"
            or name.startswith("pampi_tpu.") or name.startswith("ml_dtypes"))


def test_import_and_solve_load_no_jax():
    code = textwrap.dedent("""
        import sys
        from pampi_tpu_torch.models.ns2d import NS2DSolver
        from pampi_tpu_torch.models.poisson import PoissonSolver
        from pampi_tpu_torch.utils.params import Parameter
        it, res = PoissonSolver(Parameter(imax=8, jmax=8, itermax=40),
                                device="cpu").solve()
        s = NS2DSolver(Parameter(name="dcavity", imax=8, jmax=8),
                       device="cpu")
        s.run_steps(2)
        from pampi_tpu_torch.models.ns3d import NS3DSolver
        s3 = NS3DSolver(Parameter(name="dcavity3d", imax=6, jmax=6, kmax=6),
                        device="cpu")
        s3.run_steps(2)
        from pampi_tpu_torch.ops import multigrid
        multigrid._DCT_BOTTOM_MAX_CELLS = 64
        mg = PoissonSolver(Parameter(imax=32, jmax=32, itermax=3, eps=0.0,
                                     tpu_solver="mg"), device="cpu").solve()
        fft = PoissonSolver(Parameter(imax=8, jmax=8, tpu_solver="fft"),
                            device="cpu").solve()
        import torch
        from pampi_tpu_torch.models.poisson_dist import DistPoissonSolver
        from pampi_tpu_torch.parallel.comm import CartComm
        from pampi_tpu_torch.parallel.halo_debug import rank_id_blocks
        mesh = CartComm(ndims=2, dims=(2, 2), devices=[torch.device("cpu")])
        dist = DistPoissonSolver(Parameter(imax=16, jmax=16, itermax=36),
                                 mesh).solve()
        rank_id_blocks(CartComm(ndims=3, dims=(2, 2, 2),
                                devices=[torch.device("cpu")]), (2, 2, 2))
        from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
        d3 = NS3DDistSolver(Parameter(name="dcavity3d", imax=8, jmax=8,
                                      kmax=8),
                            CartComm(ndims=3, dims=(2, 2, 2),
                                     devices=[torch.device("cpu")]))
        d3.run_steps(2)
        from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
        d2 = NS2DDistSolver(Parameter(name="dcavity", imax=9, jmax=8),
                            CartComm(ndims=2, dims=(2, 2),
                                     devices=[torch.device("cpu")]))
        d2.run_steps(2)
        obstacle = Parameter(name="canal3d", imax=16, jmax=8, kmax=8,
                             obstacles="0.2,0.2,0.2,0.6,0.6,0.6", itermax=5)
        NS3DSolver(obstacle, device="cpu").run_steps(1)
        NS3DDistSolver(obstacle, CartComm(ndims=3, dims=(2, 2, 2),
                                          devices=[torch.device("cpu")])
                       ).run_steps(1)
        from pampi_tpu_torch.fleet import FleetScheduler
        sched = FleetScheduler(classes="on", device="cpu")
        for k, (i, j) in enumerate(((12, 12), (9, 14))):
            sched.submit_param(f"m{k}", Parameter(
                name="dcavity", imax=i, jmax=j, te=0.02, tpu_mesh="1",
                tpu_solver="mg", itermax=3))
        sched.submit_param("s", Parameter(name="dcavity", imax=8, jmax=8,
                                          te=0.02, tpu_mesh="1"))
        fl = sched.run()
        bf = PoissonSolver(Parameter(imax=8, jmax=8, itermax=40, eps=0.0,
                                     tpu_dtype="bfloat16"),
                           device="cpu").solve()
        NS2DSolver(Parameter(name="dcavity", imax=8, jmax=8, eps=0.0,
                             tpu_dtype="bfloat16"), device="cpu").run_steps(2)
        print(it, s.nt, s3.nt, mg[0], fft[0], dist[0], d3.nt, d2.nt,
              fl.summary["n_scenarios"], bf[0])
        print(sorted(m for m in sys.modules
                     if m.startswith("jax") or m.startswith("pampi_tpu")
                     or m.startswith("ml_dtypes")))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120,
                         check=True).stdout.splitlines()
    assert out[0] == "40 2 2 3 1 36 2 2 3 40"
    loaded = ast.literal_eval(out[1])
    assert [m for m in loaded if _forbidden(m)] == []
    for mod in ("ops.sor_kernels", "ops.sor3d_kernels", "ops.ns3d_fused",
                "ops.mg_fused", "ops.dctpoisson", "ops.sor_qdist",
                "parallel.comm", "parallel.halo_debug",
                "parallel.quarters_dist", "parallel.stencil2d",
                "ops.sor_odist", "parallel.octants_dist",
                "parallel.stencil3d", "models.ns3d_dist", "ops.obstacle",
                "ops.sor_obsdist", "parallel.ragged2d", "models.ns2d_dist",
                "ops.obstacle3d", "ops.sor_obsdist3d", "fleet.queue",
                "fleet.shapeclass", "fleet.batch", "fleet.scheduler"):
        assert f"pampi_tpu_torch.{mod}" in loaded


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {PORT / "parallel" / f"{m}.py" for m in (
        "comm", "halo_debug", "quarters_dist", "stencil2d", "octants_dist",
        "stencil3d", "ragged2d")} <= set(files)
    assert {PORT / "fleet" / f"{m}.py" for m in (
        "__init__", "queue", "shapeclass", "batch", "scheduler")} \
        <= set(files)
    assert {PORT / "models" / "poisson_dist.py",
            PORT / "models" / "ns3d_dist.py",
            PORT / "models" / "ns2d_dist.py",
            PORT / "ops" / "sor_odist.py", PORT / "ops" / "sor_obsdist.py",
            PORT / "ops" / "obstacle.py", PORT / "ops" / "obstacle3d.py",
            PORT / "ops" / "sor_obsdist3d.py"} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}: imports {bad}"


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoissonSolver(Parameter(imax=8, jmax=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NS2DSolver(Parameter(name="dcavity", imax=8, jmax=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NS2DSolver(Parameter(name="dcavity", imax=8, jmax=8), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NS3DSolver(Parameter(name="dcavity3d", imax=8, jmax=8, kmax=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NS3DDistSolver(Parameter(name="dcavity3d", imax=8, jmax=8, kmax=8))


def test_parameter_from_dict_round_trip():
    jparam = jread_parameter(str(ROOT / "configs" / "dcavity.par"))
    param = parameter_from_dict(dataclasses.asdict(jparam))
    ours = dataclasses.asdict(param)
    theirs = dataclasses.asdict(jparam)
    assert ours == {k: theirs[k] for k in ours}
    assert param == read_parameter(str(ROOT / "configs" / "dcavity.par"))


def test_from_numpy_state_round_trip():
    jparam = JParameter(name="dcavity", imax=12, jmax=10, te=1e9,
                        tpu_chunk=3, tpu_fuse_phases="off")
    js = JNS2DSolver(jparam)
    u, v, p, t, nt = js._chunk_fn(*js.initial_state())
    param = parameter_from_dict(dataclasses.asdict(jparam))
    s = NS2DSolver.from_numpy_state(param, u, v, p, t, nt, device="cpu")
    assert (s.t, s.nt) == (float(t), 3)
    for name, ref in (("u", u), ("v", v), ("p", p)):
        assert np.array_equal(getattr(s, name).numpy(), np.asarray(ref))
    back = NS2DSolver.from_numpy_state(param, s.u.numpy(), s.v.numpy(),
                                       s.p.numpy(), s.t, s.nt, device="cpu")
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(back, name), getattr(s, name))
    ps = PoissonSolver.from_numpy(Parameter(imax=12, jmax=10),
                                  np.asarray(p), np.asarray(u), device="cpu")
    assert np.array_equal(ps.p.numpy(), np.asarray(p))
    assert np.array_equal(ps.rhs.numpy(), np.asarray(u))


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kb, "nvcc_path", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="nvcc sor_rb.cu failed"):
        kb.build(["sor_rb"])
    assert not list(tmp_path.glob("*.so"))


def test_kernel_registry():
    from pampi_tpu_torch.ops import (  # noqa: F401
        mg_fused,
        ns2d_fused,
        ns3d_fused,
        sor3d_kernels,
        sor_kernels,
        sor_obsdist,
        sor_obsdist3d,
        sor_odist,
        sor_qdist,
    )

    assert set(kb.KERNELS) == {"rb_sor_quarters", "rb_sor_checkerboard",
                               "ns2d_pre", "ns2d_post",
                               "rb_sor3d_checkerboard", "rb_sor3d_octants",
                               "ns3d_pre", "ns3d_post",
                               "mg_down_2d", "mg_up_2d",
                               "mg_down_3d", "mg_up_3d",
                               "mg_down_2d_masked", "mg_up_2d_masked",
                               "mg_down_3d_masked", "mg_up_3d_masked",
                               "rb_sor_qdist",
                               "rb_sor_odist", "rb_sor_obsdist",
                               "rb_sor_obsdist3d",
                               "rb_sor3d_checkerboard_masked",
                               "ns3d_pre_flags", "ns3d_post_flags",
                               "ns3d_post_ragged", "ns3d_post_flags_ragged",
                               "rb_sor_checkerboard_masked",
                               "rb_sor_blocked", "ns2d_pre_flags",
                               "ns2d_post_flags", "mg_class_cycle_2d",
                               "rb_sor_class", "ns2d_pre_class",
                               "ns2d_post_class", "ns3d_pre_class",
                               "ns3d_post_class", "ns2d_pre_band",
                               "ns3d_pre_band", "rb_sor_quarters_bf16",
                               "ns2d_pre_bf16", "ns2d_post_bf16"}
    for k in kb.KERNELS.values():
        assert (ROOT / k.source).is_file()
        path, line = k.replaces.split(":")
        src = (ROOT / path).read_text().splitlines()
        assert "pl.pallas_call(" in src[int(line) - 1], k
    assert kb.sources() == ["mg_class_cycle", "mg_cycle", "ns2d_fused",
                            "ns3d_fused", "sor3d_rb", "sor_obsdist",
                            "sor_obsdist3d", "sor_odist", "sor_qdist",
                            "sor_rb"]
