"""The port's CUDA kernels against their plain versions on the card. These
need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and skip
elsewhere; on the card run

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Fields must agree to 1e-12 (float64) / 1e-5 (float32) of their scale: the
kernels keep the plain versions' association and are built without fma
contraction, only the r² sums are reduced in another order."""

import numpy as np
import pytest
import torch

from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.ops import ns2d_fused as nf
from pampi_tpu_torch.ops import sor_kernels as sk
from pampi_tpu_torch.ops.sor_quarters import stack_quarters
from pampi_tpu_torch.utils.params import Parameter

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.float64]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return 1e-12 if dtype == torch.float64 else 1e-5


def _rand(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape)).to(device, dtype)


def _assert_close(a, b, dtype):
    scale = max(1.0, float(b.abs().max()))
    assert float((a - b).abs().max()) <= _tol(dtype) * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 96), (63, 95)])
def test_sor_kernels_match_plain(cuda, dtype, shape):
    jmax, imax = shape
    fac, idx2, idy2 = sk.sor_coefficients(1 / imax, 1 / jmax, 1.9)
    p = _rand((jmax + 2, imax + 2), dtype, cuda, 0)
    rhs = _rand((jmax + 2, imax + 2), dtype, cuda, 1)
    cases = [(sk.rb_sor_checkerboard, sk.rb_sor_checkerboard_plain, p, rhs)]
    if jmax % 2 == 0:
        cases.append((sk.rb_sor_quarters, sk.rb_sor_quarters_plain,
                      stack_quarters(p), stack_quarters(rhs)))
    for kern, plain, x, f in cases:
        xk, xp = x.clone(), x.clone()
        launches = sk.RB_SOR_QUARTERS.launches + sk.RB_SOR_CHECKERBOARD.launches
        rk = kern(xk, f, 3, fac, idx2, idy2)
        rp = plain(xp, f, 3, fac, idx2, idy2)
        assert (sk.RB_SOR_QUARTERS.launches
                + sk.RB_SOR_CHECKERBOARD.launches) == launches + 1
        _assert_close(xk, xp, dtype)
        assert abs(float(rk) - float(rp)) <= 1e3 * _tol(dtype) * float(rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("problem", ["dcavity", "canal"])
def test_step_kernels_match_plain(cuda, dtype, problem):
    jmax, imax = 63, 96
    param = Parameter(name=problem, imax=imax, jmax=jmax, bcLeft=3, bcRight=3)
    cfg = nf.StepConfig.from_param(param)
    u, v, p = (_rand((jmax + 2, imax + 2), dtype, cuda, s) for s in (2, 3, 4))
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    uk, vk = u.clone(), v.clone()
    f, g, rhs = nf.ns2d_pre(uk, vk, dt, cfg)
    u1, v1, f1, g1, r1 = nf.ns2d_pre_plain(u, v, dt, cfg)
    assert torch.equal(uk, u1) and torch.equal(vk, v1)
    for a, b in ((f, f1), (g, g1), (rhs, r1)):
        _assert_close(a, b, dtype)
    umax, vmax = nf.ns2d_post(uk, vk, f, g, p, dt, cfg.dx, cfg.dy)
    u2, v2, _um, _vm = nf.ns2d_post_plain(u1, v1, f1, g1, p, dt, cfg.dx,
                                          cfg.dy)
    _assert_close(uk, u2, dtype)
    _assert_close(vk, v2, dtype)
    assert torch.equal(umax, uk.abs().max())
    assert torch.equal(vmax, vk.abs().max())


def test_dcavity_on_card_matches_cpu(cuda):
    param = Parameter(name="dcavity", imax=32, jmax=32, re=10.0, te=0.05,
                      itermax=200, eps=1e-3, omg=1.8)
    runs = []
    for device in ("cuda", "cpu"):
        s = NS2DSolver(param, device=device)
        s.run(progress=False)
        runs.append(s)
    a, b = runs
    assert (a.nt, a.t) == (b.nt, b.t)
    for name in ("u", "v", "p"):
        d = (getattr(a, name).cpu() - getattr(b, name)).abs().max()
        assert float(d) <= 1e-12
