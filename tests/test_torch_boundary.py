"""The port's boundary and device rules:

- importing and running pampi_tpu_torch loads neither jax nor pampi_tpu
  (checked in a fresh interpreter), and no file of the port imports them;
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
            or name.startswith("pampi_tpu."))


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
        print(it, s.nt)
        print(sorted(m for m in sys.modules
                     if m.startswith("jax") or m.startswith("pampi_tpu")))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120,
                         check=True).stdout.splitlines()
    assert out[0] == "40 2"
    loaded = ast.literal_eval(out[1])
    assert [m for m in loaded if _forbidden(m)] == []
    assert "pampi_tpu_torch.ops.sor_kernels" in loaded


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
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
    from pampi_tpu_torch.ops import ns2d_fused, sor_kernels  # noqa: F401

    assert set(kb.KERNELS) == {"rb_sor_quarters", "rb_sor_checkerboard",
                               "ns2d_pre", "ns2d_post"}
    for k in kb.KERNELS.values():
        assert (ROOT / k.source).is_file()
        path, line = k.replaces.split(":")
        src = (ROOT / path).read_text().splitlines()
        assert "pl.pallas_call(" in src[int(line) - 1], k
    assert kb.sources() == ["ns2d_fused", "sor_rb"]
