"""The port's CUDA kernels against their plain versions on the card. These
need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and skip
elsewhere; on the card run

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Fields must agree to 1e-12 (float64) / 1e-5 (float32) of their scale: the
kernels keep the plain versions' association and are built without fma
contraction, only the r² sums are reduced in another order. The MG cycle
kernels K9-K12 and the distributed quarter and octant kernels K13 and K14
keep every operation of their plain versions, so their fields are held
bitwise, and K14 on a one-shard mesh is K6, residual included; so is K15,
the flag-masked per-shard kernel of the distributed NS-2D solve; K13 and
masked K2 sum their residual per tile in an order their plain versions
repeat, so it is held bitwise too, and so do K1 and plain K2 (one pass
a call), fields and residual; masked
K5 and K16 (3-D obstacles) sum their residual in an order their plain
versions repeat, so they are held bitwise, residual included, and K16 on a
one-shard mesh is masked K5; masked K2 (2-D obstacles) and K17 (one
blocked red-black iteration) likewise, residual included, and K17's
fields are K2's; so is K18 (the fleet's one-launch class V-cycle), fields
and residual; K15 and K16 (one pass through shared memory a call) on
shards of several tiles with ragged remainders and on shards smaller than
a tile, n = 1..4 (K16 also n = 5, and 6 as two passes), their `out=` form (the
solvers') and in-place form bitwise each other; K13 and masked K2 (one
pass a call, `out=` only) on planes and fields of several tiles and of
one; an MG run on the card
against the CPU, whose DCT bottom's matrix products sum in another order,
to 1e-9; a fleet of mg class lanes on the card against the CPU to 1e-9 of
scale; K7/K8's class mode against their plain versions (boundary copies,
dead cells and maxima bitwise) and a fleet of 3-D class lanes on the card
against the CPU to 1e-9 of scale; K1's bf16-storage mode (planes and its
float32 residual) and K3/K4 at bf16 bitwise their plain versions, and an
NS-2D bf16 run on the card bitwise the CPU's."""

import numpy as np
import pytest
import torch

from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.ops import mg_fused as mf
from pampi_tpu_torch.ops import multigrid as mg
from pampi_tpu_torch.ops import ns2d_fused as nf
from pampi_tpu_torch.ops import ns3d_fused as nf3
from pampi_tpu_torch.ops import sor3d_kernels as sk3
from pampi_tpu_torch.ops import sor_kernels as sk
from pampi_tpu_torch.ops import obstacle as obst
from pampi_tpu_torch.ops import sor_obsdist as sod
from pampi_tpu_torch.ops import sor_odist as so
from pampi_tpu_torch.ops import sor_qdist as sq
from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
from pampi_tpu_torch.ops.sor_octants import stack_octants
from pampi_tpu_torch.ops.sor_quarters import stack_quarters
from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
from pampi_tpu_torch.models.poisson_dist import DistPoissonSolver
from pampi_tpu_torch.parallel import octants_dist as od
from pampi_tpu_torch.parallel import quarters_dist as qd
from pampi_tpu_torch.parallel.comm import CartComm
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 24, 32), (15, 23, 31)])
def test_sor3d_kernels_match_plain(cuda, dtype, shape):
    kmax, jmax, imax = shape
    coef = sor_coefficients_3d(1 / imax, 1 / jmax, 1 / kmax, 1.8)
    full = (kmax + 2, jmax + 2, imax + 2)
    p, rhs = _rand(full, dtype, cuda, 5), _rand(full, dtype, cuda, 6)
    cases = [(sk3.rb_sor3d_checkerboard, sk3.rb_sor3d_checkerboard_plain,
              sk3.RB_SOR3D_CHECKERBOARD, p, rhs)]
    if kmax % 2 == 0:
        q = stack_octants(p)
        onchip = sk3.octant_tiles(*q.shape[1:], q.element_size())
        cases.append((sk3.rb_sor3d_octants, sk3.rb_sor3d_octants_plain,
                      sk3.RB_SOR3D_OCTANTS_ONCHIP if onchip
                      else sk3.RB_SOR3D_OCTANTS, q, stack_octants(rhs)))
    for kern, plain, counter, x, f in cases:
        xk, xp = x.clone(), x.clone()
        launches = counter.launches
        for _ in range(3):  # ghosts carried across calls
            rk = kern(xk, f, 2, *coef)
            rp = plain(xp, f, 2, *coef)
        assert counter.launches == launches + 3
        _assert_close(xk, xp, dtype)
        assert abs(float(rk) - float(rp)) <= _tol(dtype) * float(rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 24, 32), (50, 50, 200), (4, 6, 2)])
def test_octants_onchip_matches_plain_bitwise(cuda, dtype, shape):
    """K6's on-chip design (one launch a call) on grids of many tiles,
    canal3d.par's among them, and on one of tiles smaller than a cell row:
    volume and residual bitwise the plain version's at n = 1..4, with the
    ghosts carried across calls."""
    kmax, jmax, imax = shape
    coef = sor_coefficients_3d(1 / imax, 1 / jmax, 1 / kmax, 1.7)
    full = (kmax + 2, jmax + 2, imax + 2)
    q = stack_octants(_rand(full, dtype, cuda, 21))
    f = stack_octants(_rand(full, dtype, cuda, 22))
    assert sk3.octant_tiles(*q.shape[1:], q.element_size()) is not None
    for n in (1, 2, 3, 4):
        xk, xp = q.clone(), q.clone()
        launches = sk3.RB_SOR3D_OCTANTS_ONCHIP.launches
        for _ in range(2):
            rk = sk3.rb_sor3d_octants(xk, f, n, *coef)
            rp = sk3.rb_sor3d_octants_plain(xp, f, n, *coef)
        assert sk3.RB_SOR3D_OCTANTS_ONCHIP.launches == launches + 2
        assert torch.equal(xk, xp) and torch.equal(rk, rp)


def test_octants_multi_launch_beyond_capacity(cuda):
    """Octants past the capacity rule (128³ float64) run the multi-launch
    design, counted on its own entry, within round-off of the plain
    version (the residual sums in other orders)."""
    coef = sor_coefficients_3d(1 / 128, 1 / 128, 1 / 128, 1.7)
    full = (130, 130, 130)
    q = stack_octants(_rand(full, torch.float64, cuda, 23))
    f = stack_octants(_rand(full, torch.float64, cuda, 24))
    assert sk3.octant_tiles(*q.shape[1:], 8) is None
    xk, xp = q.clone(), q.clone()
    launches = sk3.RB_SOR3D_OCTANTS.launches
    rk = sk3.rb_sor3d_octants(xk, f, 2, *coef)
    rp = sk3.rb_sor3d_octants_plain(xp, f, 2, *coef)
    assert sk3.RB_SOR3D_OCTANTS.launches == launches + 1
    assert torch.equal(xk, xp)
    assert abs(float(rk) - float(rp)) <= 1e-12 * float(rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("problem,bckw", [
    ("dcavity3d", {}),
    ("canal3d", dict(bcLeft=3, bcRight=3, bcFront=2, bcBack=2)),
])
def test_ns3d_step_kernels_match_plain(cuda, dtype, problem, bckw):
    kmax, jmax, imax = 15, 20, 33
    param = Parameter(name=problem, imax=imax, jmax=jmax, kmax=kmax, **bckw)
    cfg = nf3.StepConfig3D.from_param(param)
    full = (kmax + 2, jmax + 2, imax + 2)
    u, v, w, p = (_rand(full, dtype, cuda, s) for s in (7, 8, 9, 10))
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    uk, vk, wk = u.clone(), v.clone(), w.clone()
    f, g, h, rhs = nf3.ns3d_pre(uk, vk, wk, dt, cfg)
    u1, v1, w1, f1, g1, h1, r1 = nf3.ns3d_pre_plain(u, v, w, dt, cfg)
    assert torch.equal(uk, u1) and torch.equal(vk, v1) and torch.equal(wk, w1)
    for a, b in ((f, f1), (g, g1), (h, h1), (rhs, r1)):
        _assert_close(a, b, dtype)
    maxima = nf3.ns3d_post(uk, vk, wk, f, g, h, p, dt, cfg.dx, cfg.dy, cfg.dz)
    u2, v2, w2, *_ = nf3.ns3d_post_plain(u1, v1, w1, f1, g1, h1, p, dt,
                                         cfg.dx, cfg.dy, cfg.dz)
    for a, b in ((uk, u2), (vk, v2), (wk, w2)):
        _assert_close(a, b, dtype)
    for m, a in zip(maxima, (uk, vk, wk)):
        assert torch.equal(m, a.abs().max())


@pytest.mark.parametrize("layout", ["auto", "checkerboard"])
def test_dcavity3d_on_card_matches_cpu(cuda, layout):
    param = Parameter(name="dcavity3d", imax=16, jmax=16, kmax=16, re=100.0,
                      te=0.1, itermax=100, eps=1e-3, omg=1.8,
                      tpu_sor_layout=layout)
    runs = []
    for device in ("cuda", "cpu"):
        s = NS3DSolver(param, device=device)
        s.run(progress=False)
        runs.append(s)
    a, b = runs
    assert (a.nt, a.t) == (b.nt, b.t)
    for name in ("u", "v", "w", "p"):
        d = (getattr(a, name).cpu() - getattr(b, name)).abs().max()
        assert float(d) <= 1e-12


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("extents", [(512, 512), (64, 64, 64)])
def test_mg_cycle_kernels_match_plain(cuda, dtype, extents):
    levels = mg._truncate_levels(mg.mg_levels(*extents),
                                 mg._DCT_BOTTOM_MAX_CELLS)
    assert len(levels) == 2
    nd = len(extents)
    plan = mf.make_cycle_plan(levels, tuple(1.0 / n for n in extents))
    full = tuple(n + 2 for n in extents)
    p, rhs = _rand(full, dtype, cuda, 11), _rand(full, dtype, cuda, 12)
    down, up = (mf.MG_DOWN_2D, mf.MG_UP_2D) if nd == 2 else \
        (mf.MG_DOWN_3D, mf.MG_UP_3D)
    n_down, n_up = down.launches, up.launches
    pstk, rstk = mf.mg_down(plan, p, rhs)
    pk, rk = mf.mg_down_plain(plan, p, rhs)
    assert down.launches == n_down + 1
    assert rstk[0] is rhs
    for a, b in zip(pstk + rstk, pk + rk):
        assert torch.equal(a, b)
    pbot = _rand(tuple(n + 2 for n in levels[-1]), dtype, cuda, 13)
    out = mf.mg_up(plan, pstk, rstk, pbot)
    assert up.launches == n_up + 1
    assert torch.equal(out, mf.mg_up_plain(plan, pk, rk, pbot))


@pytest.mark.parametrize("solver", ["mg", "fft"])
def test_mg_fft_dcavity_on_card_matches_cpu(cuda, solver, monkeypatch):
    monkeypatch.setattr(mg, "_DCT_BOTTOM_MAX_CELLS", 256)  # 64² -> 3 levels
    param = Parameter(name="dcavity", imax=64, jmax=64, re=100.0, te=0.05,
                      itermax=20, eps=1e-5, tpu_solver=solver)
    runs = []
    for device in ("cuda", "cpu"):
        s = NS2DSolver(param, device=device)
        s.run(progress=False)
        runs.append(s)
    a, b = runs
    assert a.nt == b.nt and abs(a.t - b.t) <= 1e-12 * b.t
    for name in ("u", "v", "p"):
        d = (getattr(a, name).cpu() - getattr(b, name)).abs().max()
        assert float(d) <= 1e-9


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("extents", [(64, 96), (32, 32, 48)])
def test_masked_mg_cycle_kernels_match_plain(cuda, dtype, extents):
    """The masked mode of K9-K12 (an odd box on two walls, 3 levels)
    bitwise its plain version, launched as the masked entries."""
    nd = len(extents)
    fluid = np.ones(tuple(n + 2 for n in extents), bool)
    fluid[(slice(1, 12),) + (slice(5, 17),) * (nd - 2)
          + (slice(extents[-1] - 20, extents[-1] + 1),)] = False
    levels = mg.mg_levels(*extents)[:3]
    sp = tuple(1.0 / n for n in reversed(extents))
    lvs = mg.obstacle_levels(fluid, levels, sp, dtype, cuda)
    plan = mf.make_cycle_plan(levels, sp,
                              fluid_levels=[lv.flags for lv in lvs],
                              factor_levels=[lv.fac_ext for lv in lvs])
    full = tuple(n + 2 for n in extents)
    p, rhs = _rand(full, dtype, cuda, 21), _rand(full, dtype, cuda, 22)
    down, up = mf._KERNELS[("down", nd, True)], mf._KERNELS[("up", nd, True)]
    n_down, n_up = down.launches, up.launches
    pstk, rstk = mf.mg_down(plan, p, rhs)
    pk, rk = mf.mg_down_plain(plan, p, rhs)
    assert down.launches == n_down + 1
    for a, b in zip(pstk + rstk, pk + rk):
        assert torch.equal(a, b)
    pbot = _rand(tuple(n + 2 for n in levels[-1]), dtype, cuda, 23)
    out = mf.mg_up(plan, pstk, rstk, pbot)
    assert up.launches == n_up + 1
    assert torch.equal(out, mf.mg_up_plain(plan, pk, rk, pbot))


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("nd", [2, 3])
def test_obstacle_mg_on_card_matches_cpu(cuda, nd, fused, monkeypatch):
    """canal_obstacle.par cut to 64x16 and canal3d_obstacle.par cut to
    32x16x16 (f64) under tpu_solver mg, multi-level plans, on the card
    and on the CPU: the same steps and fields within 1e-9."""
    import pathlib

    from pampi_tpu_torch.utils.params import read_parameter

    monkeypatch.setattr(mg, "_DENSE_BOTTOM_MAX_CELLS", 64 if nd == 2 else 512)
    root = pathlib.Path(__file__).resolve().parent.parent
    if nd == 2:
        param = read_parameter(str(root / "configs" / "canal_obstacle.par")
                               ).replace(imax=64, jmax=16, te=0.5)
    else:
        param = read_parameter(str(root / "configs" / "canal3d_obstacle.par")
                               ).replace(imax=32, jmax=16, kmax=16, te=0.5,
                                         tpu_mesh="1")
    param = param.replace(tpu_solver="mg", tpu_mg_fused=fused)
    cls = NS2DSolver if nd == 2 else NS3DSolver
    a, b = (cls(param, device=d) for d in ("cuda", "cpu"))
    for s in (a, b):
        s.run(progress=False)
    assert len(a._solve.levels) >= 2 and a.nt == b.nt > 2
    for name in ("uvp" if nd == 2 else "uvwp"):
        d = (getattr(a, name).cpu() - getattr(b, name)).abs().max()
        assert float(d) <= 1e-9


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qoffs", [(0, 0), (8, 4), (0, 12), (16, 36)])
def test_qdist_kernel_matches_plain(cuda, dtype, qoffs):
    """K13 on random stacked planes of shards at global offsets, walls and
    ghosts included: planes and the owned r² (summed in the tile order the
    plain version repeats) bitwise."""
    g = qd.make_qgeom(64, 96, 32, 24, 3)
    coef = sk.sor_coefficients(1 / 96, 1 / 64, 1.9)
    x = _rand((4, g.jq, g.iq), dtype, cuda, 21)
    f = _rand((4, g.jq, g.iq), dtype, cuda, 22)
    xk, xp, yk, yp = x.clone(), x.clone(), x.clone(), x.clone()
    launches = sq.RB_SOR_QDIST.launches
    for _ in range(2):
        rk = sq.rb_sor_qdist(xk, f, g, qoffs, *coef, out=yk)
        rp = sq.rb_sor_qdist_plain(xp, f, g, qoffs, *coef, out=yp)
        xk, yk, xp, yp = yk, xk, yp, xp
    assert sq.RB_SOR_QDIST.launches == launches + 2
    assert torch.equal(xk, xp) and torch.equal(rk, rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("grid", [(1024, 680, (2, 2)), (100, 100, (2, 2))])
def test_qdist_tiles_match_plain(cuda, dtype, n, grid):
    """K13 (one launch, `out=`) on every shard of 1024x680 on 2x2 (several
    tiles a plane, cut at the plane's edges) and of configs/dcavity.par's
    100² on 2x2 (one tile), two chained calls: planes and residual bitwise
    the plain version's, q untouched."""
    jmax, imax, dims = grid
    jl, il = jmax // dims[0], imax // dims[1]
    g = qd.make_qgeom(jmax, imax, jl, il, n)
    coef = sk.sor_coefficients(1 / imax, 1 / jmax, 1.9)
    for s in range(dims[0] * dims[1]):
        qoffs = (s // dims[1] * jl // 2, s % dims[1] * il // 2)
        x, f = (_rand((4, g.jq, g.iq), dtype, cuda, 301 + 2 * s + k)
                for k in (0, 1))
        xp, yp, xk, out = x.clone(), x.clone(), x.clone(), torch.empty_like(x)
        for _ in range(2):
            keep = xk.clone()
            rk = sq.rb_sor_qdist(xk, f, g, qoffs, *coef, out=out)
            assert torch.equal(xk, keep)
            xk, out = out, xk
            rp = sq.rb_sor_qdist_plain(xp, f, g, qoffs, *coef, out=yp)
            xp, yp = yp, xp
        assert torch.equal(xk, xp) and torch.equal(rk, rp)


def test_dist_poisson_on_card_matches_cpu(cuda):
    """A 2x2 mesh whose shards share the card against the same mesh on the
    CPU: the same count, bitwise fields (the r² sums, reduced in another
    order, decide nothing here: eps is below reach)."""
    param = Parameter(imax=64, jmax=48, itermax=120, eps=1e-30, omg=1.8)
    runs = []
    for device in ("cuda", "cpu"):
        s = DistPoissonSolver(param, CartComm(ndims=2, dims=(2, 2),
                                              devices=[torch.device(device)]))
        runs.append((s.solve()[0], s.full_field()))
    assert runs[0][0] == runs[1][0] == 120
    assert np.array_equal(runs[0][1], runs[1][1])


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two or more cards")
def test_dist_poisson_across_cards_matches_cpu(cuda):
    """`tpu_mesh auto` over every visible card (one shard per card, halos
    copied between cards) against a 2x2 mesh on the CPU: the same count,
    bitwise fields, and the caller's current card unchanged by the
    launches on the other cards."""
    param = Parameter(imax=64, jmax=48, itermax=120, eps=1e-30, omg=1.8)
    mesh = CartComm(ndims=2)
    assert mesh.size == torch.cuda.device_count() and not mesh.shared
    current = torch.cuda.current_device()
    card = DistPoissonSolver(param, mesh)
    assert card.solve()[0] == 120
    assert torch.cuda.current_device() == current
    cpu = DistPoissonSolver(param, CartComm(ndims=2, dims=mesh.dims,
                                            devices=[torch.device("cpu")]))
    assert cpu.solve()[0] == 120
    assert np.array_equal(card.full_field(), cpu.full_field())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims,offs", [
    ((2, 2, 2), (0, 0, 0)), ((2, 2, 2), (8, 8, 8)), ((1, 2, 4), (0, 8, 24)),
    ((1, 1, 1), (0, 0, 0))])
def test_odist_kernel_matches_plain(cuda, dtype, dims, offs):
    """K14 (`out=`, the solver's swap of two volumes) on random stacked
    volumes of a shard of 32x32x64 (n = 2) at its global octant offsets,
    walls and ghosts included: volumes and the owned r² bitwise (the
    residual's tile order is the plain version's), q untouched."""
    ext = (32, 32, 64) if dims != (1, 1, 1) else (16, 16, 16)
    local = tuple(e // d for e, d in zip(ext, dims))
    g = od.make_ogeom(*ext, *local, 2, dims=dims)
    coef = sor_coefficients_3d(1 / ext[2], 1 / ext[1], 1 / ext[0], 1.8)
    x = _rand((8, g.kq, g.jq, g.iq), dtype, cuda, 31)
    f = _rand((8, g.kq, g.jq, g.iq), dtype, cuda, 32)
    xk, xp = [x.clone(), torch.empty_like(x)], [x.clone(), torch.empty_like(x)]
    launches = so.RB_SOR_ODIST.launches
    for _ in range(2):
        keep = xk[0].clone()
        rk = so.rb_sor_odist(xk[0], f, g, offs, *coef, xk[1])
        assert torch.equal(xk[0], keep)
        rp = so.rb_sor_odist_plain(xp[0], f, g, offs, *coef, xp[1])
        xk.reverse()
        xp.reverse()
    assert so.RB_SOR_ODIST.launches == launches + 2
    assert torch.equal(xk[0], xp[0]) and torch.equal(rk, rp)


@pytest.mark.parametrize("dtype", DTYPES)
def test_odist_kernel_on_one_shard_is_k6(cuda, dtype):
    """On a (1, 1, 1) mesh the shard's volume is K6's stacked octants: K14
    and K6 give the same volume, bitwise, and the same residual summed in
    other orders (K14's per tile, K6's per block): rtol 1e-5 at float32,
    1e-12 at float64."""
    g = od.make_ogeom(24, 16, 32, 24, 16, 32, 3, dims=(1, 1, 1))
    coef = sor_coefficients_3d(1 / 32, 1 / 16, 1 / 24, 1.7)
    p = _rand((26, 18, 34), dtype, cuda, 41)
    rhs = _rand((26, 18, 34), dtype, cuda, 42)
    q14, q6 = [stack_octants(p), None], stack_octants(p)
    q14[1] = torch.empty_like(q14[0])
    f = stack_octants(rhs)
    assert tuple(q6.shape) == (8, g.kq, g.jq, g.iq)
    for _ in range(2):
        r14 = so.rb_sor_odist(q14[0], f, g, (0, 0, 0), *coef, q14[1])
        q14.reverse()
        r6 = sk3.rb_sor3d_octants(q6, f, g.n, *coef)
    assert torch.equal(q14[0], q6)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    assert abs(float(r14) - float(r6)) <= rtol * float(r6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("problem,bckw", [
    ("dcavity3d", {}),
    ("canal3d", dict(bcLeft=3, bcRight=3, bcFront=2, bcBack=2))])
@pytest.mark.parametrize("offs", [(0, 0, 0), (8, 8, 8), (16, 0, 16)])
def test_ns3d_step_kernels_distributed_match_plain(cuda, dtype, problem,
                                                   bckw, offs):
    """K7 on a shard's deep block and K8 on its halo-1 blocks (8³ shards of
    24³) against their plain versions: u', v', w' and the maxima bitwise,
    F/G/H/rhs and u'', v'', w'' to the tolerance."""
    G = (24, 24, 24)
    param = Parameter(name=problem, imax=24, jmax=24, kmax=24, re=100.0,
                      **bckw)
    cfg = nf3.StepConfig3D.from_param(param)
    u, v, w = (_rand((14, 14, 14), dtype, cuda, 51 + k) for k in range(3))
    p = _rand((10, 10, 10), dtype, cuda, 54)
    dt = torch.tensor(0.013, dtype=dtype, device=cuda)
    uk, vk, wk = u.clone(), v.clone(), w.clone()
    fk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, offs, G, 2)
    plain = nf3.ns3d_pre_plain(u, v, w, dt, cfg, offs, G, 2)
    for a, b in zip((uk, vk, wk), plain[:3]):
        assert torch.equal(a, b)
    for a, b in zip(fk, plain[3:]):
        _assert_close(a, b, dtype)
    strip = (slice(2, -2),) * 3
    halo1 = [a[strip].contiguous() for a in (uk, vk, wk)]
    mk = nf3.ns3d_post(*halo1, *fk[:3], p, dt, cfg.dx, cfg.dy, cfg.dz,
                       offs, G)
    mp = nf3.ns3d_post_plain(*(a[strip] for a in plain[:3]), *plain[3:6], p,
                             dt, cfg.dx, cfg.dy, cfg.dz, offs, G)
    for a, b in zip(halo1, mp[:3]):
        _assert_close(a, b, dtype)
    for m, a in zip(mk, halo1):
        assert torch.equal(m, a.abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("flags", [False, True], ids=["plain", "flags"])
@pytest.mark.parametrize("dims,G", [((4, 1, 1), (9, 12, 12)),
                                    ((2, 2, 2), (9, 11, 13))],
                         ids=["4x1x1-ghost", "2x2x2"])
def test_ns3d_step_kernels_ragged_match_plain(cuda, dtype, flags, dims, G):
    """K7 at uneven shard bounds and K8 in its ragged mode (the live-mask
    multiply), on every shard of a mesh that does not divide the grid
    (on 4x1x1 the last shard holds only the HI ghost plane and dead
    cells), without and with a box's flags, against their plain versions:
    u', v', w', the maxima and the dead cells (0) bitwise, the rest to the
    tolerance."""
    from pampi_tpu_torch.ops import ns3d as ops3

    param = Parameter(name="dcavity3d", imax=G[2], jmax=G[1], kmax=G[0],
                      re=100.0)
    cfg = nf3.StepConfig3D.from_param(param)
    local = tuple(-(-n // d) for n, d in zip(G, dims))
    fluid = np.ones(tuple(n + 2 for n in G), bool)
    fluid[3:7, 4:9, 3:9] = False
    comm = CartComm(ndims=3, dims=dims, devices=[cuda])
    dt = torch.tensor(0.013, dtype=dtype, device=cuda)
    for s in range(comm.size):
        offs = comm.offsets(s, local)
        fl = (None, None)
        if flags:
            over = [max(0, o + n + 4 - g) for o, n, g in
                    zip(offs, local, fluid.shape)]
            wide = np.pad(fluid.astype(np.uint8),
                          [(2, 2 + e) for e in over])
            fl = tuple(torch.from_numpy(np.ascontiguousarray(wide[tuple(
                slice(o + 2 - h, o + n + 4 + h) for o, n in
                zip(offs, local))])).to(cuda) for h in (2, 0))
        u, v, w = (_rand(tuple(n + 6 for n in local), dtype, cuda, 61 + k)
                   for k in range(3))
        p = _rand(tuple(n + 2 for n in local), dtype, cuda, 64)
        uk, vk, wk = u.clone(), v.clone(), w.clone()
        fk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, offs, G, 2, flags=fl[0])
        plain = nf3.ns3d_pre_plain(u, v, w, dt, cfg, offs, G, 2, fl[0])
        for a, b in zip((uk, vk, wk), plain[:3]):
            assert torch.equal(a, b)
        for a, b in zip(fk, plain[3:]):
            _assert_close(a, b, dtype)
        strip = (slice(2, -2),) * 3
        halo1 = [a[strip].contiguous() for a in (uk, vk, wk)]
        mk = nf3.ns3d_post(*halo1, *fk[:3], p, dt, cfg.dx, cfg.dy, cfg.dz,
                           offs, G, flags=fl[1], ragged=True)
        mp = nf3.ns3d_post_plain(*(a[strip] for a in plain[:3]),
                                 *plain[3:6], p, dt, cfg.dx, cfg.dy, cfg.dz,
                                 offs, G, fl[1], True)
        gk, gj, gi = ops3.index_grids(halo1[0].shape, 0, offs, cuda)
        dead = ((gk > G[0] + 1) | (gj > G[1] + 1)
                | (gi > G[2] + 1)).expand(halo1[0].shape)
        for a, b in zip(halo1, mp[:3]):
            _assert_close(a, b, dtype)
            assert torch.equal(a[dead], b[dead]) and not a[dead].any()
        for m, a in zip(mk, halo1):
            assert torch.equal(m, a.abs().max())


def test_ragged_dist_ns3d_on_card_matches_cpu(cuda):
    """dcavity3d 9x11x13 f64 on the ragged (2, 2, 2), K7/K8 (ragged mode),
    and canal3d with a box on the ragged (1, 2, 3) in flag mode, against
    the same mesh on the CPU (their plain versions): the same step count,
    fields within 1e-12 (the r² sums, reduced in another order, decide no
    count here)."""
    for param, dims in (
            (Parameter(name="dcavity3d", imax=13, jmax=11, kmax=9, re=100.0,
                       te=0.2, tpu_dtype="float64"), (2, 2, 2)),
            (Parameter(name="canal3d", imax=20, jmax=10, kmax=10, re=100.0,
                       bcLeft=3, bcRight=3, te=0.2, xlength=2.0,
                       obstacles="0.6,0.3,0.3,1.0,0.7,0.7",
                       tpu_dtype="float64"), (1, 2, 3))):
        runs = []
        for device in ("cuda", "cpu"):
            s = NS3DDistSolver(param, CartComm(
                ndims=3, dims=dims, devices=[torch.device(device)]))
            assert s.ragged
            s.run(progress=False)
            runs.append((s.nt, s.collect()))
        assert runs[0][0] == runs[1][0] >= 2
        for a, b in zip(runs[0][1], runs[1][1]):
            assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(b).max())


def test_dist_ns3d_on_card_matches_cpu(cuda):
    """dcavity3d 16³ f64 on a (2, 2, 2) mesh whose shards share the card
    (K7, K8, K14) against the same mesh on the CPU (their plain versions):
    the same step count and bitwise fields (eps below reach: the r² sums,
    reduced in another order, decide nothing)."""
    param = Parameter(name="dcavity3d", imax=16, jmax=16, kmax=16, re=100.0,
                      te=0.2, itermax=40, eps=1e-30, tpu_sor_inner=2,
                      tpu_dtype="float64")
    runs = []
    for device in ("cuda", "cpu"):
        s = NS3DDistSolver(param, CartComm(ndims=3, dims=(2, 2, 2),
                                           devices=[torch.device(device)]))
        s.run(progress=False)
        runs.append((s.nt, s.t, s.collect()))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2], runs[1][2]):
        assert np.array_equal(a, b)


def test_dist_ns3d_across_cards_matches_cpu(cuda):
    """`tpu_mesh auto` over every visible card (one shard per card, the
    deep and octant exchanges copied between cards) against the same mesh
    on the CPU: the same step count, bitwise fields, and the caller's
    current card unchanged by the launches on the other cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    param = Parameter(name="dcavity3d", imax=16, jmax=16, kmax=16, re=100.0,
                      te=0.2, itermax=40, eps=1e-30, tpu_sor_inner=2,
                      tpu_dtype="float64")
    mesh = CartComm(ndims=3, extents=(16, 16, 16))
    assert mesh.size == torch.cuda.device_count() and not mesh.shared
    current = torch.cuda.current_device()
    card = NS3DDistSolver(param, mesh)
    card.run(progress=False)
    assert torch.cuda.current_device() == current
    cpu = NS3DDistSolver(param, CartComm(ndims=3, dims=mesh.dims,
                                         devices=[torch.device("cpu")]))
    cpu.run(progress=False)
    assert (card.nt, card.t) == (cpu.nt, cpu.t)
    for a, b in zip(card.collect(), cpu.collect()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("obstacle", [False, True])
def test_obsdist_kernel_matches_plain(cuda, dtype, obstacle):
    """K15 on every shard of 33x18 on a ragged (4, 2) mesh (n = 2, the
    ragged depth H = 5), all-fluid or with an obstacle's flags, two calls
    each: blocks bitwise, residuals to the tolerance."""
    imax, jmax, dims, n = 33, 18, (4, 2), 2
    jl, il = -(-jmax // dims[0]), -(-imax // dims[1])
    dx, dy = 4.0 / imax, 2.0 / jmax
    fluid = np.ones((jmax + 2, imax + 2), bool)
    if obstacle:
        fluid[6:12, 10:16] = False
    m = obst.make_masks(fluid, dx, dy, 1.7)
    comm = CartComm(ndims=2, dims=dims, devices=[cuda])
    H = 2 * n + 1
    g = sod.ObsGeom(jmax, imax, jl, il, n, H)
    coef = (1.7, 1.0 / (dx * dx), 1.0 / (dy * dy))
    for s in range(comm.size):
        fl = obst.deep_flag_block(m, comm, s, jl, il, H, jmax, imax, cuda)
        x, f = (_rand(g.shape, dtype, cuda, 71 + 2 * s + k) for k in (0, 1))
        xk, xp = x.clone(), x.clone()
        for _ in range(2):
            rk = sod.rb_sor_obsdist(xk, f, fl, g, comm.offsets(s, (jl, il)),
                                    *coef)
            rp = sod.rb_iters_obsdist_plain(xp, f, fl, g,
                                            comm.offsets(s, (jl, il)), *coef)
        assert torch.equal(xk, xp)
        assert abs(float(rk) - float(rp)) <= _tol(dtype) * abs(float(rp))


def _obsdist_shards(imax, jmax, dims, n, obstacle, cuda):
    """(geometry, coefficients, [(offsets, deep flags)]) of K15 on every
    shard of imax x jmax on a ragged dims mesh (H = 2n+1)."""
    jl, il = -(-jmax // dims[0]), -(-imax // dims[1])
    dx, dy = 4.0 / imax, 2.0 / jmax
    fluid = np.ones((jmax + 2, imax + 2), bool)
    if obstacle:
        fluid[jmax // 3:2 * jmax // 3, imax // 4:imax // 2] = False
    m = obst.make_masks(fluid, dx, dy, 1.7)
    comm = CartComm(ndims=2, dims=dims, devices=[cuda])
    g = sod.ObsGeom(jmax, imax, jl, il, n, 2 * n + 1)
    return g, (1.7, 1.0 / (dx * dx), 1.0 / (dy * dy)), [
        (comm.offsets(s, (jl, il)),
         obst.deep_flag_block(m, comm, s, jl, il, g.H, jmax, imax, cuda))
        for s in range(comm.size)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("obstacle", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("grid", [(301, 203, (2, 2)), (33, 18, (4, 2))])
def test_obsdist_tiles_match_plain(cuda, dtype, obstacle, n, grid):
    """K15 (one launch, `out=`) on every shard of 301x203 on 2x2 (several
    tiles a shard, ragged remainders) and of 33x18 on (4, 2) (shards
    smaller than a tile), two chained calls: blocks bitwise the plain
    version's, p untouched, the residual to the tolerance; the in-place
    form bitwise the `out=` form."""
    g, coef, shards = _obsdist_shards(*grid, n, obstacle, cuda)
    for s, (offs, fl) in enumerate(shards):
        x, f = (_rand(g.shape, dtype, cuda, 201 + 2 * s + k) for k in (0, 1))
        xp, xi, xk, out = x.clone(), x.clone(), x.clone(), torch.empty_like(x)
        for _ in range(2):
            keep = xk.clone()
            rk = sod.rb_sor_obsdist(xk, f, fl, g, offs, *coef, out=out)
            assert torch.equal(xk, keep)
            xk, out = out, xk
            ri = sod.rb_sor_obsdist(xi, f, fl, g, offs, *coef)
            rp = sod.rb_iters_obsdist_plain(xp, f, fl, g, offs, *coef)
        assert torch.equal(xk, xp) and torch.equal(xi, xp)
        assert torch.equal(rk, ri)
        assert abs(float(rk) - float(rp)) <= _tol(dtype) * abs(float(rp))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("problem,bcs", [("dcavity", (1, 1, 1, 1)),
                                         ("canal", (3, 3, 1, 1))])
@pytest.mark.parametrize("offs", [(0, 0), (5, 10), (15, 10)])
def test_ns2d_step_kernels_distributed_match_plain(cuda, dtype, problem, bcs,
                                                   offs):
    """K3 on a shard's deep block and K4 on its halo-1 blocks (5x10 shards
    of the ragged 18x20 on (4, 2)) against their plain versions: u', v'
    and the maxima bitwise, F/G/rhs and u'', v'' to the tolerance."""
    G = (18, 20)
    param = Parameter(name=problem, imax=20, jmax=18, re=100.0,
                      bcLeft=bcs[0], bcRight=bcs[1], bcBottom=bcs[2],
                      bcTop=bcs[3])
    cfg = nf.StepConfig.from_param(param)
    u, v = (_rand((11, 16), dtype, cuda, 81 + k) for k in range(2))
    p = _rand((7, 12), dtype, cuda, 84)
    dt = torch.tensor(0.013, dtype=dtype, device=cuda)
    uk, vk = u.clone(), v.clone()
    fk = nf.ns2d_pre(uk, vk, dt, cfg, offs, G, 2)
    plain = nf.ns2d_pre_plain(u, v, dt, cfg, offs, G, 2)
    for a, b in zip((uk, vk), plain[:2]):
        assert torch.equal(a, b)
    for a, b in zip(fk, plain[2:]):
        _assert_close(a, b, dtype)
    strip = (slice(2, -2),) * 2
    halo1 = [a[strip].contiguous() for a in (uk, vk)]
    mk = nf.ns2d_post(*halo1, *fk[:2], p, dt, cfg.dx, cfg.dy, offs, G, True)
    mp = nf.ns2d_post_plain(*(a[strip] for a in plain[:2]), *plain[2:4], p,
                            dt, cfg.dx, cfg.dy, offs, G, True)
    for a, b in zip(halo1, mp[:2]):
        _assert_close(a, b, dtype)
    for m, b in zip(mk, mp[2:]):
        assert abs(float(m) - float(b)) <= _tol(dtype) * max(1.0, float(b))


@pytest.mark.parametrize("dims", [(2, 2), (3, 3)])
def test_dist_ns2d_on_card_matches_cpu(cuda, dims):
    """dcavity 24x18 f64 on a 2x2 (K13) or ragged 3x3 (K15) mesh whose
    shards share the card, K3/K4 in their distributed mode, against the
    same mesh on the CPU (their plain versions): the same step count and
    bitwise fields (eps below reach)."""
    param = Parameter(name="dcavity", imax=24, jmax=18, te=0.05, itermax=30,
                      eps=1e-30, tpu_dtype="float64")
    runs = []
    for device in ("cuda", "cpu"):
        s = NS2DDistSolver(param, CartComm(ndims=2, dims=dims,
                                           devices=[torch.device(device)]))
        s.run(progress=False)
        runs.append((s.nt, s.t, s.fields()))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2], runs[1][2]):
        assert np.array_equal(a, b)


def test_dist_ns2d_across_cards_matches_cpu(cuda):
    """`tpu_mesh auto` over every visible card (one shard per card) against
    the same mesh on the CPU: the same step count and bitwise fields."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    param = Parameter(name="dcavity", imax=24, jmax=18, te=0.05, itermax=30,
                      eps=1e-30, tpu_dtype="float64")
    mesh = CartComm(ndims=2, extents=(18, 24))
    card = NS2DDistSolver(param, mesh)
    card.run(progress=False)
    cpu = NS2DDistSolver(param, CartComm(ndims=2, dims=mesh.dims,
                                         devices=[torch.device("cpu")]))
    cpu.run(progress=False)
    assert (card.nt, card.t) == (cpu.nt, cpu.t)
    for a, b in zip(card.fields(), cpu.fields()):
        assert np.array_equal(a, b)


def _obstacle_flags(shape, cuda):
    """uint8 flags of a (k, j, i)-extended grid with a box obstacle at least
    two cells thick per axis (ghost shell fluid)."""
    fluid = np.ones(shape, bool)
    k, j, i = (n // 4 for n in shape)
    fluid[k:2 * k + 2, j:2 * j + 2, i:2 * i + 2] = False
    return torch.from_numpy(fluid.astype(np.uint8)).to(cuda)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 24, 32), (15, 23, 31)])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_masked_k5_matches_plain(cuda, dtype, shape, n):
    """K5's masked mode (obstacle flags, `out=`, the solver's swap of two
    fields), two calls: fields and the residual bitwise (the residual's
    fixed order is the plain version's), p untouched."""
    full = tuple(e + 2 for e in shape)
    flags = _obstacle_flags(full, cuda)
    coef = tuple(e * e for e in shape[::-1])  # idx2, idy2, idz2 of 1/e
    x, f = _rand(full, dtype, cuda, 81), _rand(full, dtype, cuda, 82)
    xk, xp = [x.clone(), torch.empty_like(x)], x.clone()
    launches = sk3.RB_SOR3D_MASKED.launches
    for _ in range(2):
        keep = xk[0].clone()
        rk = sk3.rb_sor3d_checkerboard(xk[0], f, n, 0.0, *coef, flags=flags,
                                       omega=1.7, out=xk[1])
        assert torch.equal(xk[0], keep)
        xk.reverse()
        rp = sk3.rb_sor3d_masked_plain(xp, f, flags, n, 1.7, *coef)
    assert sk3.RB_SOR3D_MASKED.launches == launches + 2
    assert torch.equal(xk[0], xp) and torch.equal(rk, rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(40, 300, 90), (9, 11, 13)])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_masked_k5_tiles_match_plain(cuda, dtype, shape, n):
    """Masked K5 on a field of several (j, i) tiles and k slabs, tiles cut
    at every face (40x300x90, k, j, i), and on one smaller than a tile:
    fields and residual bitwise its plain version's over two calls."""
    full = tuple(e + 2 for e in shape)
    flags = _obstacle_flags(full, cuda)
    coef = tuple(e * e for e in shape[::-1])
    x, f = _rand(full, dtype, cuda, 85), _rand(full, dtype, cuda, 86)
    xk, xp = [x.clone(), torch.empty_like(x)], x.clone()
    for _ in range(2):
        rk = sk3.rb_sor3d_checkerboard(xk[0], f, n, 0.0, *coef, flags=flags,
                                       omega=1.7, out=xk[1])
        xk.reverse()
        rp = sk3.rb_sor3d_masked_plain(xp, f, flags, n, 1.7, *coef)
    assert torch.equal(xk[0], xp) and torch.equal(rk, rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_odist_tiles_match_plain(cuda, dtype, n):
    """K14 on every shard of 128³ on (2, 2, 2) (64³ shards: several (j, i)
    tiles and k slabs), two calls: volumes and residuals bitwise."""
    dims = (2, 2, 2)
    g = od.make_ogeom(128, 128, 128, 64, 64, 64, n, dims=dims)
    coef = sor_coefficients_3d(1 / 128, 1 / 128, 1 / 128, 1.8)
    for s in range(8):
        offs = tuple(((s >> (2 - a)) & 1) * 32 for a in range(3))
        x = _rand((8, g.kq, g.jq, g.iq), dtype, cuda, 33 + s)
        f = _rand((8, g.kq, g.jq, g.iq), dtype, cuda, 43 + s)
        xk = [x.clone(), torch.empty_like(x)]
        xp = [x.clone(), torch.empty_like(x)]
        for _ in range(2):
            rk = so.rb_sor_odist(xk[0], f, g, offs, *coef, xk[1])
            rp = so.rb_sor_odist_plain(xp[0], f, g, offs, *coef, xp[1])
            xk.reverse()
            xp.reverse()
        assert torch.equal(xk[0], xp[0]) and torch.equal(rk, rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2])
def test_obsdist3d_kernel_matches_plain(cuda, dtype, n):
    """K16 on every shard of 32x16x16 on (2, 2, 2) with a box obstacle's
    deep flag blocks, two calls each: blocks and residuals bitwise."""
    from pampi_tpu_torch.ops import obstacle3d as o3
    from pampi_tpu_torch.ops import sor_obsdist3d as sod3

    G, dims = (16, 16, 32), (2, 2, 2)
    local = tuple(e // d for e, d in zip(G, dims))
    dx, dy, dz = 8.0 / G[2], 4.0 / G[1], 4.0 / G[0]
    m = o3.make_masks_3d(o3.build_fluid_3d(G[2], G[1], G[0], dx, dy, dz,
                                           "3.0,1.5,1.5,5.0,2.5,2.5"),
                         dx, dy, dz, 1.7)
    comm = CartComm(ndims=3, dims=dims, devices=[cuda])
    g = sod3.ObsGeom3(*G, *local, n)
    coef = (1.7, 1 / dx**2, 1 / dy**2, 1 / dz**2)
    for s in range(comm.size):
        offs = comm.offsets(s, local)
        fl = o3.deep_flag_block_3d(m, comm, s, *local, g.H, cuda)
        x, f = (_rand(g.shape, dtype, cuda, 91 + 2 * s + k) for k in (0, 1))
        xk, xp = x.clone(), x.clone()
        for _ in range(2):
            rk = sod3.rb_sor_obsdist3d(xk, f, fl, g, offs, *coef)
            rp = sod3.rb_iters_obsdist3d_plain(xp, f, fl, g, offs, *coef)
        assert torch.equal(xk, xp) and torch.equal(rk, rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("G,dims", [((40, 72, 136), (2, 2, 2)),
                                    ((32, 32, 128), (2, 2, 2))])
def test_obsdist3d_tiles_match_plain(cuda, dtype, n, G, dims):
    """K16 (`out=`) on every shard of 40x72x136 (k, j, i; several (j, i)
    tiles a shard, ragged remainders) and of 32x32x128 (canal3d_obstacle
    .par's 16x16x64 shards: one tile across j) on (2, 2, 2) with a box
    obstacle's deep flags, two chained calls: blocks and residuals bitwise
    the plain version's, p untouched, the in-place form bitwise the `out=`
    form. n = 6 runs as two passes of 3."""
    from pampi_tpu_torch.ops import obstacle3d as o3
    from pampi_tpu_torch.ops import sor_obsdist3d as sod3

    local = tuple(e // d for e, d in zip(G, dims))
    dx, dy, dz = 8.0 / G[2], 4.0 / G[1], 4.0 / G[0]
    m = o3.make_masks_3d(o3.build_fluid_3d(G[2], G[1], G[0], dx, dy, dz,
                                           "3.0,1.5,1.5,5.0,2.5,2.5"),
                         dx, dy, dz, 1.7)
    comm = CartComm(ndims=3, dims=dims, devices=[cuda])
    g = sod3.ObsGeom3(*G, *local, n)
    coef = (1.7, 1 / dx**2, 1 / dy**2, 1 / dz**2)
    for s in range(comm.size):
        offs = comm.offsets(s, local)
        fl = o3.deep_flag_block_3d(m, comm, s, *local, g.H, cuda)
        x, f = (_rand(g.shape, dtype, cuda, 211 + 2 * s + k) for k in (0, 1))
        xp, xi, xk, out = x.clone(), x.clone(), x.clone(), torch.empty_like(x)
        for _ in range(2):
            keep = xk.clone()
            rk = sod3.rb_sor_obsdist3d(xk, f, fl, g, offs, *coef, out=out)
            assert torch.equal(xk, keep)
            xk, out = out, xk
            ri = sod3.rb_sor_obsdist3d(xi, f, fl, g, offs, *coef)
            rp = sod3.rb_iters_obsdist3d_plain(xp, f, fl, g, offs, *coef)
        assert torch.equal(xk, xp) and torch.equal(xi, xp)
        assert torch.equal(rk, rp) and torch.equal(ri, rp)


@pytest.mark.parametrize("dtype", DTYPES)
def test_obsdist3d_on_one_shard_is_masked_k5(cuda, dtype):
    """On a (1, 1, 1) mesh K16's deep block holds masked K5's array: the
    same volume and residual, bitwise."""
    from pampi_tpu_torch.ops import sor_obsdist3d as sod3
    from pampi_tpu_torch.parallel.stencil2d import embed_deep, strip_deep

    G, n = (12, 10, 14), 2
    g = sod3.ObsGeom3(*G, *G, n)
    full = tuple(e + 2 for e in G)
    flags = _obstacle_flags(full, cuda)
    deep = torch.nn.functional.pad(flags, (g.H - 1,) * 6).contiguous()
    coef = (14.0**2, 10.0**2, 12.0**2)  # idx2, idy2, idz2 of 1/I, 1/J, 1/K
    x, f = _rand(full, dtype, cuda, 101), _rand(full, dtype, cuda, 102)
    x5, xd = [x.clone(), torch.empty_like(x)], embed_deep(x, g.H)
    xd, fd = xd.contiguous(), embed_deep(f, g.H).contiguous()
    for _ in range(2):
        r16 = sod3.rb_sor_obsdist3d(xd, fd, deep, g, (0, 0, 0), 1.7, *coef)
        r5 = sk3.rb_sor3d_checkerboard(x5[0], f, n, 0.0, *coef, flags=flags,
                                       omega=1.7, out=x5[1])
        x5.reverse()
    assert torch.equal(strip_deep(xd, g.H), x5[0]) and torch.equal(r16, r5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offs", [None, (0, 0, 0), (8, 8, 8), (16, 0, 16)])
def test_ns3d_step_kernels_flag_mode_match_plain(cuda, dtype, offs):
    """K7/K8 in flag mode, on one device (24³) and on 8³ shards of 24³
    (the deep flag block for PRE, the halo-1 one for POST): u', v', w'
    and the maxima bitwise, F/G/H/rhs and u'', v'', w'' to the
    tolerance."""
    G = (24, 24, 24)
    param = Parameter(name="canal3d", imax=24, jmax=24, kmax=24, re=100.0,
                      bcLeft=3, bcRight=3)
    cfg = nf3.StepConfig3D.from_param(param)
    fluid = _obstacle_flags((26, 26, 26), cuda).cpu().numpy()
    dt = torch.tensor(0.013, dtype=dtype, device=cuda)
    if offs is None:
        flags = torch.from_numpy(fluid).to(cuda)
        u, v, w, p = (_rand((26,) * 3, dtype, cuda, 111 + k)
                      for k in range(4))
        uk, vk, wk = u.clone(), v.clone(), w.clone()
        fk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, flags=flags)
        plain = nf3.ns3d_pre_plain(u, v, w, dt, cfg, flags=flags)
        halo1, post_in, pflags = (uk, vk, wk), plain[:3], flags
        mode = {}
    else:
        deep, ext = (torch.from_numpy(np.ascontiguousarray(np.pad(
            fluid, h - 1)[tuple(slice(o, o + 8 + 2 * h) for o in offs)]
        )).to(cuda) for h in (3, 1))
        u, v, w = (_rand((14,) * 3, dtype, cuda, 121 + k) for k in range(3))
        p = _rand((10,) * 3, dtype, cuda, 124)
        uk, vk, wk = u.clone(), v.clone(), w.clone()
        fk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, offs, G, 2, flags=deep)
        plain = nf3.ns3d_pre_plain(u, v, w, dt, cfg, offs, G, 2, flags=deep)
        strip = (slice(2, -2),) * 3
        halo1 = [a[strip].contiguous() for a in (uk, vk, wk)]
        post_in = [a[strip] for a in plain[:3]]
        pflags, mode = ext, dict(offs=offs, gext=G)
    for a, b in zip((uk, vk, wk), plain[:3]):
        assert torch.equal(a, b)
    for a, b in zip(fk, plain[3:]):
        _assert_close(a, b, dtype)
    launches = nf3.NS3D_POST_FLAGS.launches
    mk = nf3.ns3d_post(*halo1, *fk[:3], p, dt, cfg.dx, cfg.dy, cfg.dz,
                       flags=pflags, **mode)
    mp = nf3.ns3d_post_plain(*post_in, *plain[3:6], p, dt, cfg.dx, cfg.dy,
                             cfg.dz, flags=pflags, **mode)
    assert nf3.NS3D_POST_FLAGS.launches == launches + 1
    for a, b in zip(halo1, mp[:3]):
        _assert_close(a, b, dtype)
    for m, a in zip(mk, halo1):
        assert torch.equal(m, a.abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_ns3d_pre_flags_tiles_no_snapshot(cuda, dtype):
    """Flag K7's tiled launch on a block of several tiles per axis, the
    last ones ragged, with two obstacle boxes: u', v', w' bitwise the plain
    version's, F/G/H/rhs to the tolerance; the call allocates its four
    outputs and nothing more (no snapshot of u, v, w)."""
    shape = (21, 35, 77)
    param = Parameter(name="canal3d", imax=75, jmax=33, kmax=19, re=100.0,
                      bcLeft=3, bcRight=3)
    cfg = nf3.StepConfig3D.from_param(param)
    flags = _obstacle_flags(shape, cuda)
    flags[12:17, 3:9, 50:60] = 0
    u, v, w = (_rand(shape, dtype, cuda, 131 + k) for k in range(3))
    dt = torch.tensor(0.013, dtype=dtype, device=cuda)
    uk, vk, wk = u.clone(), v.clone(), w.clone()
    nf3.ns3d_pre(uk, vk, wk, dt, cfg, flags=flags)  # built and warm
    uk, vk, wk = u.clone(), v.clone(), w.clone()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = nf3.NS3D_PRE_FLAGS.launches
    fk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, flags=flags)
    torch.cuda.synchronize()
    assert nf3.NS3D_PRE_FLAGS.launches == launches + 1
    assert torch.cuda.max_memory_allocated() - base <= 4 * u.nbytes + 4096
    plain = nf3.ns3d_pre_plain(u, v, w, dt, cfg, flags=flags)
    for a, b in zip((uk, vk, wk), plain[:3]):
        assert torch.equal(a, b)
    for a, b in zip(fk, plain[3:]):
        _assert_close(a, b, dtype)


def test_obstacle_ns3d_on_card_matches_cpu(cuda):
    """configs/canal3d_obstacle.par cut to 32x8x8 (te 0.3, f64) on the card
    and on the CPU, one device and (2, 2, 2): the same steps and fields
    within 1e-12."""
    import pathlib

    from pampi_tpu_torch.utils.params import read_parameter

    root = pathlib.Path(__file__).resolve().parent.parent
    param = read_parameter(str(root / "configs" / "canal3d_obstacle.par")
                           ).replace(
        imax=32, jmax=8, kmax=8, te=0.3, itermax=60)
    runs = [NS3DSolver(param, device=d) for d in ("cuda", "cpu")]
    runs += [NS3DDistSolver(param, CartComm(ndims=3, dims=(2, 2, 2),
                                            devices=[d]))
             for d in (cuda, torch.device("cpu"))]
    for s in runs:
        s.run(progress=False)
    ref = runs[1].collect()
    for s in runs:
        assert s.nt == runs[1].nt
        for a, b in zip(s.collect(), ref):
            assert np.abs(a - b).max() <= 1e-12


def _obstacle_flags_2d(jmax, imax, device):
    """The canal_obstacle.par box scaled onto a jmax x imax grid."""
    dx, dy = 16.0 / imax, 4.0 / jmax
    return obst.make_masks(obst.build_fluid(imax, jmax, dx, dy,
                                            "3.0,1.5,4.0,2.5"),
                           dx, dy, 1.8).flags(device), dx, dy


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(128, 256), (127, 257)])
@pytest.mark.parametrize("n", [1, 4])
def test_masked_k2_matches_plain(cuda, dtype, shape, n):
    """Masked K2 against its plain version, two calls: fields and the
    residual (summed in an order the plain version repeats) bitwise."""
    jmax, imax = shape
    flags, dx, dy = _obstacle_flags_2d(jmax, imax, cuda)
    coef = (1.0 / (dx * dx), 1.0 / (dy * dy))
    x = _rand((jmax + 2, imax + 2), dtype, cuda, 91)
    f = _rand((jmax + 2, imax + 2), dtype, cuda, 92)
    xk, xp, yk = x.clone(), x.clone(), x.clone()
    launches = sk.RB_SOR_MASKED.launches
    for _ in range(2):
        rk = sk.rb_sor_checkerboard(xk, f, n, 0.0, *coef, flags=flags,
                                    omega=1.8, out=yk)
        xk, yk = yk, xk
        rp = sk.rb_sor_masked_plain(xp, f, flags, n, 1.8, *coef)
    assert sk.RB_SOR_MASKED.launches == launches + 2
    assert torch.equal(xk, xp) and torch.equal(rk, rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(300, 520), (41, 9)])
def test_masked_k2_tiles_match_plain(cuda, dtype, n, shape):
    """Masked K2 (one launch, `out=`) on a field of several tiles, the box
    across tile edges, and on one smaller than a tile, two chained calls:
    fields and residual bitwise the plain version's, p untouched."""
    jmax, imax = shape
    flags, dx, dy = _obstacle_flags_2d(jmax, imax, cuda)
    coef = (1.0 / (dx * dx), 1.0 / (dy * dy))
    x = _rand((jmax + 2, imax + 2), dtype, cuda, 95)
    f = _rand((jmax + 2, imax + 2), dtype, cuda, 96)
    xp, xk, out = x.clone(), x.clone(), torch.empty_like(x)
    for _ in range(2):
        keep = xk.clone()
        rk = sk.rb_sor_checkerboard(xk, f, n, 0.0, *coef, flags=flags,
                                    omega=1.8, out=out)
        assert torch.equal(xk, keep)
        xk, out = out, xk
        rp = sk.rb_sor_masked_plain(xp, f, flags, n, 1.8, *coef)
    assert torch.equal(xk, xp) and torch.equal(rk, rp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(300, 520), (301, 9)])
def test_blocked_k17_matches_plain_and_k2(cuda, dtype, shape):
    """K17 against its plain version (fields and residual bitwise: the
    plain version repeats its summation order) and its fields against K2
    at n_inner 1, bitwise."""
    jmax, imax = shape
    coef = sk.sor_coefficients(1 / imax, 1 / jmax, 1.9)
    x = _rand((jmax + 2, imax + 2), dtype, cuda, 93)
    f = _rand((jmax + 2, imax + 2), dtype, cuda, 94)
    xk, xp, x2 = x.clone(), x.clone(), x.clone()
    launches = sk.RB_SOR_BLOCKED.launches
    for _ in range(2):
        rk = sk.rb_sor_blocked(xk, f, *coef)
        rp = sk.rb_sor_blocked_plain(xp, f, *coef)
        sk.rb_sor_checkerboard(x2, f, 1, *coef)
    assert sk.RB_SOR_BLOCKED.launches == launches + 2
    assert torch.equal(xk, xp) and torch.equal(rk, rp)
    assert torch.equal(xk, x2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 256), (63, 255)])
def test_ns2d_step_kernels_flag_mode_match_plain(cuda, dtype, shape):
    """K3/K4 in flag mode on one device against their plain versions:
    u', v' after the BCs and the maxima bitwise, the rest to the
    tolerance; the flag entries count their launches."""
    from pampi_tpu_torch.utils.params import Parameter

    jmax, imax = shape
    flags, dx, dy = _obstacle_flags_2d(jmax, imax, cuda)
    param = Parameter(name="canal_obstacle", imax=imax, jmax=jmax,
                      xlength=16.0, ylength=4.0, re=100.0, bcLeft=3,
                      bcRight=3, gamma=0.9)
    cfg = nf.StepConfig.from_param(param)
    u, v, p = (_rand((jmax + 2, imax + 2), dtype, cuda, 95 + k)
               for k in range(3))
    dt = torch.tensor(0.013, dtype=dtype, device=cuda)
    plain = nf.ns2d_pre_plain(u, v, dt, cfg, flags=flags)
    uk, vk = u.clone(), v.clone()
    pre, post = nf.NS2D_PRE_FLAGS.launches, nf.NS2D_POST_FLAGS.launches
    fk = nf.ns2d_pre(uk, vk, dt, cfg, flags=flags)
    assert torch.equal(uk, plain[0]) and torch.equal(vk, plain[1])
    for a, b in zip(fk, plain[2:]):
        _assert_close(a, b, dtype)
    mp = nf.ns2d_post_plain(uk, vk, *fk[:2], p, dt, cfg.dx, cfg.dy,
                            flags=flags)
    mk = nf.ns2d_post(uk, vk, *fk[:2], p, dt, cfg.dx, cfg.dy, flags=flags)
    assert (nf.NS2D_PRE_FLAGS.launches, nf.NS2D_POST_FLAGS.launches) == (
        pre + 1, post + 1)
    for a, b in zip((uk, vk), mp[:2]):
        _assert_close(a, b, dtype)
    for m, a in zip(mk, (uk, vk)):
        assert torch.equal(m, a.abs().max())


def test_obstacle_ns2d_on_card_matches_cpu(cuda):
    """configs/canal_obstacle.par cut to 64x16 (te 0.5, f64) on the card
    and on the CPU, one device and 2x2: the same steps and fields within
    1e-12."""
    import pathlib

    from pampi_tpu_torch.utils.params import read_parameter

    root = pathlib.Path(__file__).resolve().parent.parent
    param = read_parameter(str(root / "configs" / "canal_obstacle.par")
                           ).replace(imax=64, jmax=16, te=0.5)
    runs = [NS2DSolver(param, device=d) for d in ("cuda", "cpu")]
    runs += [NS2DDistSolver(param, CartComm(ndims=2, dims=(2, 2),
                                            devices=[d]))
             for d in (cuda, torch.device("cpu"))]
    for s in runs:
        s.run(progress=False)
    ref = [getattr(runs[1], n).numpy() for n in "uvp"]
    for s in runs:
        assert s.nt == runs[1].nt
        got = (s.global_fields() if hasattr(s, "global_fields")
               else {n: getattr(s, n).cpu().numpy() for n in "uvp"})
        for n, b in zip("uvp", ref):
            assert np.abs(np.asarray(got[n]) - b).max() <= 1e-12


def _class_lanes(cls, dtype, device, seed):
    """Lane-stacked class blocks for K18: a full-class lane, an odd one
    (a one-level plan), one whose plan stops early, an inactive one."""
    lanes = [(cls, cls), (9, 13), (12, 12), (cls, cls - 3)]
    rng = np.random.default_rng(seed)
    n, lmax = len(lanes), mf.class_level_max(cls, cls)
    p = np.zeros((n, cls + 2, cls + 2))
    rhs = np.zeros((n, cls + 2, cls + 2))
    plans = []
    for k, (jl, il) in enumerate(lanes):
        p[k, :jl + 2, :il + 2] = rng.normal(size=(jl + 2, il + 2))
        rhs[k, 1:jl + 1, 1:il + 1] = rng.normal(size=(jl, il))
        plans.append(mf.class_level_plan(jl, il, float(il * il),
                                          float(jl * jl), lmax, dtype))
    act = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=device)
    return (torch.from_numpy(p).to(device, dtype),
            torch.from_numpy(rhs).to(device, dtype),
            torch.stack([e for e, _ in plans]).to(device),
            torch.stack([g for _, g in plans]).to(device), act)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cls", [16, 64, 128, 256, 512])
def test_class_cycle_k18_matches_plain(cuda, dtype, cls):
    """K18 against its plain version on the same CUDA inputs, three
    cycles, in every form its capacity rule picks (one CTA a lane; a
    cluster with the coarse levels in CTA 0; the same with the fine level
    in device memory at 512²): fields and residual bitwise; the inactive
    lane passes."""
    p, rhs, ext, geo, act = _class_lanes(cls, dtype, cuda, 101 + cls)
    pk = pp = p
    launches = mf.MG_CLASS_CYCLE_2D.launches
    for _ in range(3):
        pk, rk = mf.class_cycle(pk, rhs, ext, geo, act)
        pp, rp = mf.class_cycle_plain(pp, rhs, ext, geo, act)
        assert torch.equal(pk, pp) and torch.equal(rk, rp)
    assert mf.MG_CLASS_CYCLE_2D.launches == launches + 3
    assert torch.equal(pk[3], p[3]) and float(rk[3]) == 0.0


def test_class_fleet_on_card_matches_cpu(cuda):
    """Four mixed-grid mg requests (dcavity and canal, f64) through
    FleetScheduler(classes="on") on the card and on the CPU: the same
    steps, fields within 1e-9 of scale, K18 launched."""
    from pampi_tpu_torch.fleet import FleetScheduler

    base = dict(tpu_mesh="1", tpu_solver="mg", re=10.0, tau=0.5,
                itermax=10, eps=1e-4, gamma=0.9, te=0.1)
    reqs = {"d0": dict(base, name="dcavity", imax=12, jmax=12),
            "d1": dict(base, name="dcavity", imax=16, jmax=9, u_init=0.1),
            "c0": dict(base, name="canal", imax=24, jmax=10, xlength=3.0,
                       bcLeft=3, bcRight=3, re=100.0),
            "c1": dict(base, name="canal", imax=20, jmax=14, xlength=3.0,
                       bcLeft=3, bcRight=3, re=100.0)}
    runs = {}
    for dev in ("cuda", "cpu"):
        sched = FleetScheduler(classes="on", device=dev)
        for sid, kw in reqs.items():
            sched.submit_param(sid, Parameter(**kw))
        launches = mf.MG_CLASS_CYCLE_2D.launches
        runs[dev] = sched.run()
        if dev == "cuda":
            assert mf.MG_CLASS_CYCLE_2D.launches > launches
    for sid in reqs:
        a, b = runs["cuda"].by_sid(sid), runs["cpu"].by_sid(sid)
        assert a.nt == b.nt and a.mode == b.mode == "class"
        assert not a.diverged
        for x, y in zip(a.fields, b.fields):
            scale = max(1.0, float(np.abs(y).max()))
            assert np.abs(x - y).max() <= 1e-9 * scale


def _sor_class_batch(cls, dtype, device, seed):
    """Lane-stacked inputs of the sor class lane's kernels in a cls² class:
    a full-class lane, a 12x12 one, a ragged one, a canal-shaped one (30x4
    box) and one that does not step; fields random on each live corner,
    0 on the dead cells. Returns (u, v, p, rhs, ext, sor_geo, cell, dt,
    active)."""
    from pampi_tpu_torch.fleet import shapeclass as sc

    lanes = [(cls, cls), (12, 12), (cls - 3, cls - 1), (cls // 2, cls - 2),
             (cls, cls - 5)]
    lengths = [(1.0, 1.0), (1.0, 1.0), (1.0, 1.0), (30.0, 4.0), (1.0, 1.0)]
    rng = np.random.default_rng(seed)
    n = len(lanes)
    fields = np.zeros((4, n, cls + 2, cls + 2))
    gm = []
    for k, ((j, i), (xl, yl)) in enumerate(zip(lanes, lengths)):
        fields[:, k, :j + 2, :i + 2] = rng.normal(size=(4, j + 2, i + 2))
        gm.append(sc.lane_geometry(Parameter(imax=i, jmax=j, xlength=xl,
                                             ylength=yl, omg=1.7)))
    gm = np.array(gm)
    real = np.float64 if dtype == torch.float64 else np.float32
    u, v, p, rhs = (torch.from_numpy(x).to(device, dtype) for x in fields)
    return (u, v, p, rhs,
            torch.tensor(lanes, dtype=torch.int32, device=device),
            torch.from_numpy(np.ascontiguousarray(gm[:, [5, 6, 7]], real)).to(
                device),
            torch.from_numpy(np.ascontiguousarray(gm[:, [2, 3]], real)).to(
                device),
            torch.from_numpy(0.01 + 0.002 * np.arange(n)).to(device, dtype),
            torch.tensor([True] * (n - 1) + [False], device=device))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cls", [16, 64, 256])
def test_sor_class_k2_matches_plain(cuda, dtype, cls):
    """K2's dynamic-extent mode against its plain version, n = 4 then 1:
    fields and per-lane residuals bitwise, dead cells and the lane that
    does not solve untouched."""
    _u, _v, p, rhs, ext, geo, _c, _dt, solving = _sor_class_batch(
        cls, dtype, cuda, 301 + cls)
    pk, pp = p.clone(), p.clone()
    launches = sk.RB_SOR_CLASS.launches
    for n in (4, 1):
        rk = sk.rb_sor_class(pk, rhs, n, ext, geo, solving)
        rp = sk.rb_sor_class_plain(pp, rhs, n, ext, geo, solving)
        _assert_close(pk, pp, dtype)
        assert torch.equal(pk, pp) and torch.equal(rk, rp)
    assert sk.RB_SOR_CLASS.launches == launches + 2
    assert torch.equal(pk[-1], p[-1]) and float(rk[-1]) == 0.0
    for k, (j, i) in enumerate(ext.tolist()):
        assert torch.equal(pk[k, j + 2:], p[k, j + 2:])
        assert torch.equal(pk[k, :, i + 2:], p[k, :, i + 2:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 20])
@pytest.mark.parametrize("shape", [(256, 384), (62, 30), (100, 100)])
def test_k1_one_pass_matches_plain(cuda, dtype, n, shape):
    """K1 in one pass a call (`out=`, three chained calls, the planes
    swapped as the solve loop swaps them; n = 20 in passes): planes and
    residual bitwise the plain version's, q untouched, one launch a call
    by the wrapper's count."""
    jmax, imax = shape
    coef = sk.sor_coefficients(1 / imax, 1 / jmax, 1.9)
    q, f = (stack_quarters(_rand((jmax + 2, imax + 2), dtype, cuda, s))
            for s in (61, 62))
    qk, qp, out = q.clone(), q.clone(), torch.empty_like(q)
    launches = sk.RB_SOR_QUARTERS.launches
    for _ in range(3):
        keep = qk.clone()
        rk = sk.rb_sor_quarters(qk, f, n, *coef, out=out)
        assert torch.equal(qk, keep)
        qk, out = out, qk
        rp = sk.rb_sor_quarters_plain(qp, f, n, *coef)
        assert torch.equal(qk, qp) and torch.equal(rk, rp)
    assert sk.RB_SOR_QUARTERS.launches == launches + 3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 20])
@pytest.mark.parametrize("shape", [(256, 384), (63, 31), (100, 100),
                                   (258, 386)])
def test_k2_one_pass_matches_plain(cuda, dtype, n, shape):
    """Plain K2 in one pass a call (`out=`, three chained calls, the fields
    swapped as the Poisson loop swaps them; n = 20 in passes), then in
    place: field and residual bitwise the plain version's, p untouched by
    the `out=` form, one launch a call by the wrapper's count."""
    jmax, imax = shape
    coef = sk.sor_coefficients(1 / imax, 1 / jmax, 1.9)
    p, f = (_rand((jmax + 2, imax + 2), dtype, cuda, s) for s in (71, 72))
    pk, pp, out = p.clone(), p.clone(), torch.empty_like(p)
    launches = sk.RB_SOR_CHECKERBOARD.launches
    for _ in range(3):
        keep = pk.clone()
        rk = sk.rb_sor_checkerboard(pk, f, n, *coef, out=out)
        assert torch.equal(pk, keep)
        pk, out = out, pk
        rp = sk.rb_sor_checkerboard_plain(pp, f, n, *coef)
        assert torch.equal(pk, pp) and torch.equal(rk, rp)
    assert sk.RB_SOR_CHECKERBOARD.launches == launches + 3
    ri = sk.rb_sor_checkerboard(pk, f, n, *coef)
    rp = sk.rb_sor_checkerboard_plain(pp, f, n, *coef)
    assert torch.equal(pk, pp) and torch.equal(ri, rp)


@pytest.mark.parametrize("layout", ["checkerboard"])
def test_poisson_checkerboard_loop_on_card_matches_cpu(cuda, layout):
    """The Poisson checkerboard loop (K2 out of place, the fields swapped)
    on a 64x50 float64 grid: the card's iterations and field are the
    CPU's (the plain version), bitwise."""
    from pampi_tpu_torch.models.poisson import make_solver_fn

    imax, jmax = 50, 64
    dx, dy = 1.0 / imax, 1.0 / jmax
    p0 = _rand((jmax + 2, imax + 2), torch.float64, "cpu", 81)
    rhs = _rand((jmax + 2, imax + 2), torch.float64, "cpu", 82)
    rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()
    runs = []
    for dev in ("cpu", cuda):
        solve = make_solver_fn(imax, jmax, dx, dy, 1.7, 1e-6, 3000,
                               torch.float64, n_inner=1, layout=layout)
        p, res, it = solve(p0.to(dev).clone(), rhs.to(dev))
        runs.append((p.cpu(), res, it))
    assert runs[0][2] == runs[1][2] and runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][0], runs[1][0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_sor_class_k2_out_form_writes_every_cell(cuda, dtype):
    """K2's class mode out of place into a block that held NaN, n = 4, 1
    and 30 (passes): every cell written (dead cells and the lane that does
    not solve copied), bitwise the plain version."""
    _u, _v, p, rhs, ext, geo, _c, _dt, solving = _sor_class_batch(
        64, dtype, cuda, 331)
    pk, pp = p.clone(), p.clone()
    for n in (4, 1, 30):
        out = torch.full_like(pk, float("nan"))
        rk = sk.rb_sor_class(pk, rhs, n, ext, geo, solving, out=out)
        rp = sk.rb_sor_class_plain(pp, rhs, n, ext, geo, solving)
        pk = out
        assert torch.equal(pk, pp) and torch.equal(rk, rp)
    assert torch.equal(pk[-1], p[-1]) and float(rk[-1]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("problem", ["dcavity", "canal"])
def test_sor_class_k3_k4_match_plain(cuda, dtype, problem):
    """K3/K4's class mode against their plain versions in the 64² class:
    boundary copies, dead cells and maxima bitwise, F/G/rhs and the
    projected fields to the tolerance, the inactive lane untouched."""
    u, v, p, _r, ext, _g, cell, dt, active = _sor_class_batch(
        64, dtype, cuda, 401)
    for k, (j, i) in enumerate(ext.tolist()):  # dead cells hold 0
        for a in (u, v):
            a[k, j + 2:] = 0.0
            a[k, :, i + 2:] = 0.0
    cfg = nf.StepConfig.from_param(Parameter(
        name=problem, bcLeft=3 if problem == "canal" else 1,
        bcRight=3 if problem == "canal" else 1, ylength=4.0))
    uk, vk = u.clone(), v.clone()
    fk, gk, rk = nf.ns2d_pre(uk, vk, dt, cfg, ext=ext, geo=cell,
                             active=active)
    up, vp, fp, gp, rp = nf.ns2d_pre_plain(u, v, dt, cfg, ext=ext, geo=cell,
                                           active=active)
    assert torch.equal(uk, up) and torch.equal(vk, vp)
    for a, b in ((fk, fp), (gk, gp), (rk, rp)):
        _assert_close(a, b, dtype)
    mk = nf.ns2d_post(uk, vk, fk, gk, p, dt, None, None, ext=ext, geo=cell,
                      active=active)
    u2, v2, *mp = nf.ns2d_post_plain(up, vp, fk, gk, p, dt, None, None,
                                     ext=ext, geo=cell, active=active)
    _assert_close(uk, u2, dtype)
    _assert_close(vk, v2, dtype)
    for a, b, f in zip(mk, mp, (uk, vk)):
        assert torch.equal(a, b)
        assert torch.equal(a, f.abs().amax((-2, -1)))
    assert torch.equal(uk[-1], u[-1]) and torch.equal(vk[-1], v[-1])
    for k, (j, i) in enumerate(ext.tolist()):
        assert not uk[k, j + 2:].any() and not vk[k, :, i + 2:].any()


def test_sor_class_fleet_on_card_matches_cpu(cuda):
    """Mixed-grid sor requests (dcavity and canal, f64, tpu_fuse_phases
    auto and on) through FleetScheduler(classes="on") on the card and on
    the CPU: class buckets, the same steps, fields within 1e-9 of scale,
    only K2/K3/K4's class modes launched."""
    from pampi_tpu_torch.fleet import FleetScheduler
    from pampi_tpu_torch.kernels import build as kb

    base = dict(tpu_mesh="1", tpu_solver="sor", re=10.0, tau=0.5,
                itermax=50, eps=1e-4, gamma=0.9, te=0.05, omg=1.7)
    reqs = {}
    for knob in ("auto", "on"):
        reqs.update({
            f"d0{knob}": dict(base, name="dcavity", imax=12, jmax=12,
                              tpu_fuse_phases=knob),
            f"d1{knob}": dict(base, name="dcavity", imax=16, jmax=9,
                              u_init=0.1, tpu_fuse_phases=knob),
            f"c0{knob}": dict(base, name="canal", imax=24, jmax=10,
                              xlength=3.0, bcLeft=3, bcRight=3, re=100.0,
                              tpu_fuse_phases=knob)})
    runs = {}
    for dev in ("cuda", "cpu"):
        sched = FleetScheduler(classes="on", device=dev)
        for sid, kw in reqs.items():
            sched.submit_param(sid, Parameter(**kw))
        kb.reset_launches()
        runs[dev] = sched.run()
        if dev == "cuda":
            used = {k for k, v in kb.KERNELS.items() if v.launches}
            assert used == {"rb_sor_class", "ns2d_pre_class",
                            "ns2d_post_class"}
    for sid in reqs:
        a, b = runs["cuda"].by_sid(sid), runs["cpu"].by_sid(sid)
        assert a.nt == b.nt and a.mode == b.mode == "class"
        assert not a.diverged
        for x, y in zip(a.fields, b.fields):
            scale = max(1.0, float(np.abs(y).max()))
            assert np.abs(x - y).max() <= 1e-9 * scale


def _class3d_batch(cls, dtype, device, seed):
    """Lane-stacked inputs of K7/K8's class mode in a cls³ class: a
    full-class lane, an 8³ one, a ragged one, a canal3d-shaped one (30x4x4
    box) and one that does not step; u, v, w, p random on each live
    corner, 0 on the dead cells. Returns (u, v, w, p, ext, cell, dt,
    active)."""
    from pampi_tpu_torch.fleet import shapeclass as sc

    lanes = [(cls, cls, cls), (8, 8, 8), (cls - 3, cls - 1, cls - 6),
             (cls // 2, cls // 2, cls), (cls, cls - 5, cls - 2)]
    lengths = [(1.0,) * 3, (1.0,) * 3, (1.0,) * 3, (30.0, 4.0, 4.0),
               (1.0,) * 3]
    rng = np.random.default_rng(seed)
    n = len(lanes)
    fields = np.zeros((4, n) + (cls + 2,) * 3)
    gm = []
    for q, ((k, j, i), (xl, yl, zl)) in enumerate(zip(lanes, lengths)):
        fields[:, q, :k + 2, :j + 2, :i + 2] = rng.normal(
            size=(4, k + 2, j + 2, i + 2))
        gm.append(sc.lane_geometry_3d(Parameter(
            name="dcavity3d", imax=i, jmax=j, kmax=k, xlength=xl,
            ylength=yl, zlength=zl)))
    gm = np.array(gm)
    real = np.float64 if dtype == torch.float64 else np.float32
    cells = [sc.G3_DX, sc.G3_DY, sc.G3_DZ]
    return (*(torch.from_numpy(x).to(device, dtype) for x in fields),
            torch.tensor(lanes, dtype=torch.int32, device=device),
            torch.from_numpy(np.ascontiguousarray(gm[:, cells], real)).to(
                device),
            torch.from_numpy(0.01 + 0.002 * np.arange(n)).to(device, dtype),
            torch.tensor([True] * (n - 1) + [False], device=device))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("problem", ["dcavity3d", "canal3d"])
@pytest.mark.parametrize("cls", [16, 32])
def test_class_k7_k8_match_plain(cuda, dtype, problem, cls):
    """K7/K8's class mode against their plain versions: boundary copies,
    dead cells and maxima bitwise, F/G/H/rhs and the projected fields to
    the tolerance, the inactive lane untouched, 5 and 2 launches a call
    counted once each."""
    u, v, w, p, ext, cell, dt, active = _class3d_batch(cls, dtype, cuda,
                                                       501 + cls)
    bc = dict(bcLeft=3, bcRight=3) if problem == "canal3d" else {}
    cfg = nf3.StepConfig3D.from_param(Parameter(name=problem, **bc))
    kw = dict(ext=ext, geo=cell, active=active)
    uk, vk, wk = u.clone(), v.clone(), w.clone()
    counts = (nf3.NS3D_PRE_CLASS.launches, nf3.NS3D_POST_CLASS.launches)
    fk, gk, hk, rk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, **kw)
    up, vp, wp, fp, gp, hp, rp = nf3.ns3d_pre_plain(u, v, w, dt, cfg, **kw)
    for a, b in ((uk, up), (vk, vp), (wk, wp)):
        assert torch.equal(a, b)
    for a, b in ((fk, fp), (gk, gp), (hk, hp), (rk, rp)):
        _assert_close(a, b, dtype)
    mk = nf3.ns3d_post(uk, vk, wk, fk, gk, hk, p, dt, None, None, None, **kw)
    *uvw, m1, m2, m3 = nf3.ns3d_post_plain(up, vp, wp, fk, gk, hk, p, dt,
                                           None, None, None, **kw)
    for a, b in zip((uk, vk, wk), uvw):
        _assert_close(a, b, dtype)
    for a, b, f in zip(mk, (m1, m2, m3), (uk, vk, wk)):
        assert torch.equal(a, b)
        assert torch.equal(a, f.abs().amax((-3, -2, -1)))
    for a, b in ((uk, u), (vk, v), (wk, w)):
        assert torch.equal(a[-1], b[-1])
    for q, (k, j, i) in enumerate(ext.tolist()):
        for a in (uk, vk, wk):
            assert not a[q, k + 2:].any() and not a[q, :, j + 2:].any()
            assert not a[q, :, :, i + 2:].any()
    assert (nf3.NS3D_PRE_CLASS.launches, nf3.NS3D_POST_CLASS.launches) == (
        counts[0] + 1, counts[1] + 1)


def test_class3d_fleet_on_card_matches_cpu(cuda):
    """Mixed-grid 3-D sor requests (dcavity3d and canal3d, f64,
    tpu_fuse_phases auto and off) through FleetScheduler(classes="on") on
    the card and on the CPU: class buckets, the same steps, fields within
    1e-9 of scale; under auto only K7/K8's class modes launched."""
    from pampi_tpu_torch.fleet import FleetScheduler
    from pampi_tpu_torch.kernels import build as kb

    base = dict(tpu_mesh="1", tpu_solver="sor", re=10.0, tau=0.5,
                itermax=20, eps=1e-4, gamma=0.9, te=0.05, omg=1.7)
    reqs = {}
    for knob in ("auto", "off"):
        reqs.update({
            f"d0{knob}": dict(base, name="dcavity3d", imax=8, jmax=8,
                              kmax=8, tpu_fuse_phases=knob),
            f"d1{knob}": dict(base, name="dcavity3d", imax=10, jmax=9,
                              kmax=8, u_init=0.1, tpu_fuse_phases=knob),
            f"c0{knob}": dict(base, name="canal3d", imax=20, jmax=10,
                              kmax=10, xlength=30.0, ylength=4.0,
                              zlength=4.0, u_init=1.0, bcLeft=3, bcRight=3,
                              re=100.0, te=0.5, tpu_fuse_phases=knob)})
    runs = {}
    for dev in ("cuda", "cpu"):
        sched = FleetScheduler(classes="on", device=dev)
        for sid, kw in reqs.items():
            sched.submit_param(sid, Parameter(**kw))
        kb.reset_launches()
        runs[dev] = sched.run()
        if dev == "cuda":
            used = {k for k, v in kb.KERNELS.items() if v.launches}
            assert used == {"ns3d_pre_class", "ns3d_post_class"}
    for sid in reqs:
        a, b = runs["cuda"].by_sid(sid), runs["cpu"].by_sid(sid)
        assert a.nt == b.nt > 0 and a.mode == b.mode == "class"
        assert not a.diverged
        for x, y in zip(a.fields, b.fields):
            scale = max(1.0, float(np.abs(y).max()))
            assert np.abs(x - y).max() <= 1e-9 * scale


# -- the overlapped schedule: the grid-band mode of K3/K7 and the launches
# of the overlapped step ------------------------------------------------------

def _band_case(three_d, local, dims, problem):
    """(param, comm, global extents, plan) of a shard geometry."""
    from pampi_tpu_torch.parallel import overlap as ovl

    names = ("kmax", "jmax", "imax")[3 - len(dims):]
    gext = tuple(e * d - 1 for e, d in zip(local, dims))  # ragged
    param = Parameter(name=problem, re=100.0, gamma=0.9,
                      **dict(zip(names, gext)))
    comm = CartComm(ndims=len(dims), dims=dims, devices=["cuda"])
    plan = ovl.pre_plan(comm.local_shape(gext, ragged=True),
                        tuple(d > 1 for d in dims), 2,
                        nf3.BAND_ROWS if three_d else nf.BAND_ROWS)
    return param, comm, gext, plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("three_d,local,dims,problem", [
    (False, (40, 72), (2, 2), "dcavity"), (False, (33, 20), (3, 1), "canal"),
    (True, (20, 12, 16), (2, 2, 2), "dcavity3d"),
    (True, (18, 10, 9), (2, 1, 2), "canal3d")])
def test_band_k3_k7_match_full_and_plain(cuda, dtype, three_d, local, dims,
                                         problem):
    """K3's and K7's grid-band mode on every shard of a ragged mesh, both
    halves of the port's plan: the BCs and every output on the bands' rows
    bitwise the full call's, and to the tolerance of the band plain
    version (which is NaN off the bands)."""
    param, comm, gext, plan = _band_case(three_d, local, dims, problem)
    assert plan is not None
    if three_d:
        cfg, pre, plain, nfield = (nf3.StepConfig3D.from_param(param),
                                   nf3.ns3d_pre, nf3.ns3d_pre_plain, 3)
    else:
        cfg, pre, plain, nfield = (nf.StepConfig.from_param(param),
                                   nf.ns2d_pre, nf.ns2d_pre_plain, 2)
    local = comm.local_shape(gext, ragged=True)
    dt = torch.tensor(1e-3, dtype=dtype, device=cuda)
    before = (nf3.NS3D_PRE_BAND if three_d else nf.NS2D_PRE_BAND).launches
    for s in range(comm.size):
        deep = [_rand(tuple(e + 6 for e in local), dtype, cuda, 31 * s + k)
                for k in range(nfield)]
        tail = (dt, cfg, comm.offsets(s, local), gext, 2)
        full_blocks = [x.clone() for x in deep]
        full = pre(*full_blocks, *tail)
        for half in ("int_bands", "bnd_bands"):
            blocks = [x.clone() for x in deep]
            out = pre(*blocks, *tail, bands=plan[half])
            pl = plain(*deep, *tail, bands=plan[half])
            torch.cuda.synchronize()
            for a, b in zip(blocks, full_blocks):
                assert torch.equal(a, b)
            for a, b, c in zip(out, full, pl[nfield:]):
                rows = ~torch.isnan(c)
                assert rows.any() and torch.equal(a[rows], b[rows])
                _assert_close(a[rows], c[rows], dtype)
    assert (nf3.NS3D_PRE_BAND if three_d else nf.NS2D_PRE_BAND).launches \
        == before + 2 * comm.size


@pytest.mark.parametrize("three_d", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("restrict", ["off", "on"])
def test_overlap_launches_and_fields_on_card(cuda, three_d, restrict):
    """`tpu_overlap on` on the card: PRE launches twice a step and shard
    (K3/K7's band mode under `tpu_overlap_restrict on`), the side stream's
    exchange waited on where it is consumed, and the fields bitwise the
    serial step's (`off`) after the same steps."""
    from pampi_tpu_torch.kernels import build as kb

    if three_d:
        cls, dims = NS3DDistSolver, (2, 2, 2)
        param = Parameter(name="dcavity3d", imax=24, jmax=24, kmax=24,
                          re=100.0, itermax=20, tpu_dtype="float64")
        full, band = nf3.NS3D_PRE, nf3.NS3D_PRE_BAND
    else:
        cls, dims = NS2DDistSolver, (2, 2)
        param = Parameter(name="dcavity", imax=64, jmax=64, re=100.0,
                          itermax=20, tpu_dtype="float64")
        full, band = nf.NS2D_PRE, nf.NS2D_PRE_BAND
    runs = {}
    for overlap in ("on", "off"):
        s = cls(param.replace(tpu_overlap=overlap,
                              tpu_overlap_restrict=restrict),
                CartComm(ndims=len(dims), dims=dims, devices=[cuda]))
        kb.reset_launches()
        s.run_steps(4)
        torch.cuda.synchronize()
        per = 2 if overlap == "on" else 1
        banded = overlap == "on" and restrict == "on"
        assert (band if banded else full).launches == 4 * per * s.comm.size
        assert (full if banded else band).launches == 0
        runs[overlap] = s
    a, b = (runs[k].global_fields() for k in ("on", "off"))
    assert runs["on"].t == runs["off"].t
    for name in a:
        assert np.array_equal(a[name], b[name])


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(256, 384), (62, 30)])
def test_k1_bf16_matches_plain(cuda, n, shape):
    """K1's bf16-storage mode (one launch a call, `out=`) on a plane of
    several tiles and on one smaller than a tile, three chained calls:
    planes and the float32 residual bitwise the plain version's, q
    untouched; the in-place form (a second launch copies) the same."""
    jmax, imax = shape
    coef = sk.sor_coefficients(1 / imax, 1 / jmax, 1.9)
    q, f = (stack_quarters(_rand((jmax + 2, imax + 2), torch.bfloat16, cuda,
                                 s)) for s in (41, 42))
    qk, qp, qi, out = q.clone(), q.clone(), q.clone(), torch.empty_like(q)
    launches = sq.RB_SOR_QUARTERS_BF16.launches
    for _ in range(3):
        keep = qk.clone()
        rk = sk.rb_sor_quarters(qk, f, n, *coef, out=out)
        assert torch.equal(qk, keep)
        qk, out = out, qk
        rp = sk.rb_sor_quarters_plain(qp, f, n, *coef)
        ri = sk.rb_sor_quarters(qi, f, n, *coef)
    assert sq.RB_SOR_QUARTERS_BF16.launches == launches + 6
    assert rk.dtype == torch.float32
    assert torch.equal(qk, qp) and torch.equal(rk, rp)
    assert torch.equal(qi, qp) and torch.equal(ri, rp)


def test_k1_bf16_deep_call_in_passes_matches_plain(cuda):
    """n = 40 at 1024²: a call in passes (float32 between them), still
    rounded to bf16 once: bitwise the plain version."""
    coef = sk.sor_coefficients(1 / 1024, 1 / 1024, 1.9)
    assert len(sq.quarters_bf16_passes(513, 513, 40)) > 1
    q, f = (stack_quarters(_rand((1026, 1026), torch.bfloat16, cuda, s))
            for s in (43, 44))
    qp, out = q.clone(), torch.empty_like(q)
    rk = sk.rb_sor_quarters(q, f, 40, *coef, out=out)
    rp = sk.rb_sor_quarters_plain(qp, f, 40, *coef)
    assert torch.equal(out, qp) and torch.equal(rk, rp)


@pytest.mark.parametrize("problem", ["dcavity", "canal"])
def test_k3_k4_bf16_match_plain(cuda, problem):
    """K3/K4's bf16 mode on a grid taller than 256 rows (the canal's row
    index rounds in bf16): every operation rounded to bf16 in the plain
    version's order, so every output bitwise, maxima included."""
    bc = (1, 1, 1, 1) if problem == "dcavity" else (3, 3, 1, 1)
    param = Parameter(name=problem, imax=200, jmax=300, re=100.0,
                      bcLeft=bc[0], bcRight=bc[1], bcBottom=bc[2],
                      bcTop=bc[3], gx=0.1, gy=-0.2)
    cfg = nf.StepConfig.from_param(param)
    u, v, p = (_rand((302, 202), torch.bfloat16, cuda, 50 + k)
               for k in range(3))
    dt = torch.tensor(0.013, dtype=torch.bfloat16, device=cuda)
    uk, vk = u.clone(), v.clone()
    pre = nf.NS2D_PRE_BF16.launches, nf.NS2D_POST_BF16.launches
    fk, gk, rk = nf.ns2d_pre(uk, vk, dt, cfg)
    u1, v1, f1, g1, r1 = nf.ns2d_pre_plain(u, v, dt, cfg)
    for a, b in ((uk, u1), (vk, v1), (fk, f1), (gk, g1), (rk, r1)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    umax, vmax = nf.ns2d_post(uk, vk, fk, gk, p, dt, cfg.dx, cfg.dy)
    u2, v2, um2, vm2 = nf.ns2d_post_plain(u1, v1, f1, g1, p, dt, cfg.dx,
                                          cfg.dy)
    assert torch.equal(uk, u2) and torch.equal(vk, v2)
    assert torch.equal(umax, um2) and torch.equal(vmax, vm2)
    assert (nf.NS2D_PRE_BF16.launches, nf.NS2D_POST_BF16.launches) == (
        pre[0] + 1, pre[1] + 1)


def test_ns2d_bf16_on_card_matches_cpu(cuda):
    """dcavity 64² at bf16, 5 steps on the card (K1's bf16 mode, K3/K4 at
    bf16) and on the CPU (their plain versions): bitwise the same fields,
    t and step count."""
    param = Parameter(name="dcavity", imax=64, jmax=64, re=100.0, te=1e9,
                      itermax=40, eps=0.0, tpu_dtype="bfloat16")
    card, cpu = NS2DSolver(param, device="cuda"), NS2DSolver(param,
                                                             device="cpu")
    card.run_steps(5)
    cpu.run_steps(5)
    assert (card.nt, card.t) == (cpu.nt, cpu.t)
    for name in "uvp":
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
