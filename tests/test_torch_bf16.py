"""`tpu_dtype bfloat16` in the port on the CPU, where the kernels' plain
versions run, against the JAX package at bfloat16: K1's bf16-storage mode
(bf16 planes, float32 inside a call, the plane rounded once at the store,
a float32 residual), K3/K4 at bf16 (every operation rounded to bf16), and
the Poisson and NS-2D solvers and the CLI built on them.

Tolerances:
- K1 fields within 1 bf16 ulp of the field's scale max(1, max|x|), with
  fewer than 1 % of the cells differing at all (the JAX kernel runs in
  interpret mode, where XLA may contract or reorder float32 operations;
  one rounding at the store then moves a cell by at most an ulp); the
  float32 residual within 1e-5 relative (summed in another order);
- K3/K4: the boundary copies of u', v' and the maxima bitwise; F, G, rhs
  and u'', v'' within 2 bf16 ulps of scale (every operation is a bf16
  operation in both packages, in the same association); the canal inflow
  on a grid taller than 256 rows, where bf16 rounds the row index, equal;
- the solvers: iteration and step counts and t equal; fields within 2 bf16
  ulps of scale; a bf16 NS-2D run within 0.05 of the float64 run (the
  bound tests/test_ns2d.py holds the JAX package's bf16 run to);
- K1 plain at bf16 equals "upcast, float32 plain, round" bitwise, and the
  one-pass kernel's boxes, emulated here, equal the plain version bitwise
  with a halo of n quarter cells and not with n - 1.

Every other bf16 path is refused, naming ROADMAP A item 11.1 (fft keeps
the JAX package's ValueError)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.models import poisson as jpoisson
from pampi_tpu.models.ns2d import NS2DSolver as JNS2DSolver
from pampi_tpu.ops import ns2d_fused as jnf
from pampi_tpu.ops import sor_pallas as sp
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.fleet.shapeclass import ClassSolver
from pampi_tpu_torch.models import poisson as tpoisson
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.ops import ns2d_fused as nf
from pampi_tpu_torch.ops import sor_kernels as sk
from pampi_tpu_torch.ops import sor_qdist as sq
from pampi_tpu_torch.ops.sor_obsdist import SMEM_LIMIT
from pampi_tpu_torch.ops.sor_quarters import (
    rb_sweeps_quarters_r2,
    stack_quarters,
    unstack_quarters,
)
from pampi_tpu_torch.parallel import quarters_dist as qd
from pampi_tpu_torch.utils.datio import read_pressure, read_velocity
from pampi_tpu_torch.utils.params import Parameter, parameter_from_dict

ROOT = pathlib.Path(__file__).resolve().parent.parent
BF16_ULP = 2.0 ** -7  # bf16's ulp at 1: 8 significant bits
OMEGA = 1.9


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float64)).to(torch.bfloat16)


def _to_jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _within(a, b, ulps):
    """a (a torch tensor) within `ulps` bf16 ulps of b's scale; returns
    the count of cells that differ at all."""
    a = a.float().numpy()
    b = np.asarray(b).astype(np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    assert np.abs(a - b).max() <= ulps * BF16_ULP * scale
    return int((a != b).sum())


# -- K1's bf16-storage mode --------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("jmax,imax", [(32, 32), (22, 30)])
def test_k1_bf16_plain_matches_jax_interpret(jmax, imax, n):
    """Three calls with the ghosts carried across them."""
    dx, dy = 1.0 / imax, 1.0 / jmax
    coef = sk.sor_coefficients(dx, dy, OMEGA)
    rng = np.random.default_rng(n + jmax)
    p, f = (_bf16(rng.normal(size=(jmax + 2, imax + 2))) for _ in range(2))
    rb, brq, h = sp.make_rb_iter_tblock_quarters(
        imax, jmax, dx, dy, OMEGA, jnp.bfloat16, n_inner=n, interpret=True)
    qj, fj = (sp.pad_quarters(_to_jax(x), brq, h) for x in (p, f))
    qt, ft = stack_quarters(p), stack_quarters(f)
    for _ in range(3):
        qj, rj = rb(qj, fj)
        rt = sk.rb_sor_quarters(qt, ft, n, *coef)
        assert qt.dtype == torch.bfloat16 and rt.dtype == torch.float32
        assert rj.dtype == jnp.float32
        differ = _within(unstack_quarters(qt),
                         sp.unpad_quarters(qj, jmax, imax, h), 1)
        assert differ <= 0.01 * qt.numel()
        assert abs(float(rt) - float(rj)) <= 1e-5 * abs(float(rj))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_k1_bf16_plain_is_float32_rounded_once(n):
    """Upcast, the float32 plain iterations, round: the same planes bit
    for bit; the residual is the float32 r² summed in the per-tile order;
    the out= form leaves q alone and writes the same planes."""
    rng = np.random.default_rng(n)
    q, f = (_bf16(rng.normal(size=(4, 13, 17))) for _ in range(2))
    coef = sk.sor_coefficients(1.0 / 32, 1.0 / 24, OMEGA)
    x = q.float()
    r2 = rb_sweeps_quarters_r2(x, f.float(), n, *coef)
    qk = q.clone()
    r = sk.rb_sor_quarters(qk, f, n, *coef)
    assert torch.equal(qk, x.to(torch.bfloat16))
    (pl,) = sq.quarters_bf16_passes(13, 17, n)
    assert torch.equal(r, sk.tiled_residual(r2, pl.th, pl.tw))
    assert torch.equal(r, torch.tensor(_tile_order_sum(r2, pl.th, pl.tw),
                                       dtype=torch.float32))
    out = torch.empty_like(q)
    q0 = q.clone()
    r_out = sk.rb_sor_quarters(q, f, n, *coef, out=out)
    assert torch.equal(q, q0) and torch.equal(out, qk)
    assert torch.equal(r_out, r)


def _tile_order_sum(r2, th, tw):
    """The kernels' residual written out in numpy (float32): per tile
    (row-major), thread (tx, ty) of 32 x 16 adds the tile's cells (ty + 16
    k, tx + 32 m), slot by slot, k-major, and a halving tree over 32 ty +
    tx sums the threads; then thread t of 512 adds partials t, t + 512,
    ... and a halving tree."""
    def tree(v):
        st = len(v) // 2
        while st:
            v = v[:st] + v[st:2 * st]
            st //= 2
        return v[0]

    r2 = np.asarray(r2, np.float32)
    ej, ei = r2.shape[-2:]
    parts = []
    for j0 in range(0, ej, th):
        for i0 in range(0, ei, tw):
            acc = np.zeros(512, np.float32)
            for s in range(r2.shape[0]):
                for j in range(j0, min(j0 + th, ej)):
                    for i in range(i0, min(i0 + tw, ei)):
                        acc[32 * ((j - j0) % 16) + (i - i0) % 32] += r2[s, j, i]
            parts.append(tree(acc))
    acc = np.zeros(512, np.float32)
    for k, v in enumerate(parts):
        acc[k % 512] += v
    return tree(acc)


def _emulate_k1(x, f, n, coef, ht):
    """The one-pass kernel's tiling on the CPU, in float32: each tile's
    box (the tile and ht quarter cells a side, clipped to the plane) run
    as a plane of its own, a box cell updating where it lies in its slot's
    global interior and its one-sided stencil stays in the box (even rows
    read the row below, odd rows the row above; even columns the column
    left, odd ones right), the wall selects everywhere; the tile's cells
    and r² kept. Returns (planes, r²)."""
    g = sq.quarters_geom(x.shape[1], x.shape[2])
    m = qd.q_masks(g, 0, 0, ring=False)
    gn = dataclasses.replace(g, n=n)  # rb_sweeps_q reads n as its count
    out, r2 = torch.empty_like(x), torch.empty_like(x)
    for j0, j1, i0, i1 in sq.qdist_tiles(g, 4, n):
        box = (slice(max(0, j0 - ht), min(g.jq, j1 + ht)),
               slice(max(0, i0 - ht), min(g.iq, i1 + ht)))
        R, W = (sl.stop - sl.start for sl in box)
        a = torch.arange(R)[:, None]
        b = torch.arange(W)[None, :]
        mb = {k: v[box] for k, v in m.items() if k not in ("upd", "own")}
        mb["own"] = [o[box] for o in m["own"]]
        mb["upd"] = [u[box] & (a >= 1 if pr == 0 else a <= R - 2)
                     & (b >= 1 if pc == 0 else b <= W - 2)
                     for u, (pr, pc) in zip(m["upd"], qd.SLOT_PARITY)]
        new, rr = qd.rb_sweeps_q(x[(slice(None),) + box],
                                 f[(slice(None),) + box], gn, mb, *coef)
        own = (slice(None), slice(j0, j1), slice(i0, i1))
        inner = (slice(None), slice(j0 - box[0].start, j1 - box[0].start),
                 slice(i0 - box[1].start, i1 - box[1].start))
        out[own], r2[own] = new[inner], rr[inner]
    return out, r2


@pytest.fixture()
def small_boxes(monkeypatch):
    """K1 bf16's plans with boxes of 3x5 owned quarter cells and the halo
    (the plan caches cleared around the patch)."""
    def patch(n):
        monkeypatch.setattr(sq, "_BOX", {4: (2 * n + 3, 2 * n + 5)})
        monkeypatch.setattr(sq, "_MIN_TILE", (1, 1))
        sq.quarters_bf16_passes.cache_clear()

    yield patch
    sq.quarters_bf16_passes.cache_clear()


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k1_bf16_box_emulation(small_boxes, n):
    """Boxes of 3x5 owned quarter cells and the halo on a 48x40 grid's
    plane (25x21, tiles cutting every wall): with the halo n every box
    gives the plain version's planes and r² bitwise, and the residual is
    the per-tile sum of those r²; with n - 1 some box does not."""
    small_boxes(n)
    (pl,) = sq.quarters_bf16_passes(25, 21, n)
    assert pl.ht == n and (pl.th, pl.tw) == (3, 5)
    rng = np.random.default_rng(40 + n)
    q, f = (_bf16(rng.normal(size=(4, 25, 21))) for _ in range(2))
    coef = sk.sor_coefficients(1.0 / 40, 1.0 / 48, OMEGA)
    x, fx = q.float(), f.float()
    ref = x.clone()
    ref_r2 = rb_sweeps_quarters_r2(ref, fx, n, *coef)
    planes, r2 = _emulate_k1(x, fx, n, coef, n)
    assert torch.equal(planes, ref) and torch.equal(r2, ref_r2)
    qk = q.clone()
    r = sk.rb_sor_quarters(qk, f, n, *coef)
    assert torch.equal(qk, planes.to(torch.bfloat16))
    assert torch.equal(r, sk.tiled_residual(r2, pl.th, pl.tw))
    short, _ = _emulate_k1(x, fx, n, coef, n - 1)
    assert not torch.equal(short, ref)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 40])
def test_k1_bf16_plans_fit_and_split(n):
    """At 4096² each pass's float32 boxes fit shared memory; n = 1..8 is
    one pass (one launch a call), n = 40 splits into passes whose first
    writes a float32 plane and whose last rounds to bf16."""
    passes = sq.quarters_bf16_passes(2049, 2049, n)
    assert all(pl.smem <= SMEM_LIMIT for pl in passes)
    assert sum(pl.iters for pl in passes) == n
    stages = [stage for stage, _, _ in sq.quarters_bf16_plan(2049, 2049, n)]
    assert stages == ([0] if n <= 8 else [1] + [2] * (len(stages) - 2) + [3])


# -- K3/K4 at bf16 -----------------------------------------------------------


@pytest.mark.parametrize("problem,bcs,jmax,imax", [
    ("dcavity", (1, 1, 1, 1), 16, 24),
    ("canal", (3, 1, 2, 1), 300, 8),
], ids=["dcavity", "canal-300-rows"])
def test_k3_k4_bf16_plain_match_jax_interpret(problem, bcs, jmax, imax):
    """The canal on a grid of 300 rows, where the inflow's row index
    rounds in bf16 (257 -> 256, ...)."""
    kw = dict(name=problem, imax=imax, jmax=jmax, re=100.0, gamma=0.9,
              gx=0.1, gy=-0.2, bcLeft=bcs[0], bcRight=bcs[1],
              bcBottom=bcs[2], bcTop=bcs[3])
    rng = np.random.default_rng(7)
    u, v, p = (_bf16(rng.normal(size=(jmax + 2, imax + 2)))
               for _ in range(3))
    dt = 0.013
    pre, post, pad, unpad, _h = jnf.make_fused_step_2d(
        JParameter(**kw), jmax, imax, 1.0 / imax, 1.0 / jmax, jnp.bfloat16,
        interpret=True)
    offs = jnp.zeros((2,), jnp.int32)
    dt11 = jnp.full((1, 1), dt, jnp.bfloat16)
    up, vp, fp, gp, rp = pre(offs, dt11, pad(_to_jax(u)), pad(_to_jax(v)))
    up2, vp2, um, vm = post(offs, dt11, up, vp, fp, gp, pad(_to_jax(p)))

    cfg = nf.StepConfig.from_param(Parameter(**kw))
    ut, vt = u.clone(), v.clone()
    dtt = torch.tensor(dt, dtype=torch.bfloat16)
    f, g, rhs = nf.ns2d_pre(ut, vt, dtt, cfg)
    u1, v1 = ut.clone(), vt.clone()
    umax, vmax = nf.ns2d_post(ut, vt, f, g, p, dtt, cfg.dx, cfg.dy)
    assert _within(u1, unpad(up), 0) == 0  # the copies and the inflow
    assert _within(v1, unpad(vp), 0) == 0
    for a, b in ((f, fp), (g, gp), (rhs, rp), (ut, up2), (vt, vp2)):
        assert a.dtype == torch.bfloat16
        _within(a, unpad(b), 2)
    assert float(umax) == float(um) and float(vmax) == float(vm)


def test_k3_k4_bf16_refuse_the_other_modes():
    u = torch.zeros(10, 10, dtype=torch.bfloat16)
    dt = torch.tensor(0.01, dtype=torch.bfloat16)
    cfg = nf.StepConfig.from_param(Parameter(name="dcavity", imax=8, jmax=8))
    flags = torch.ones(10, 10, dtype=torch.uint8)
    with pytest.raises(ValueError, match="single-device mode only"):
        nf.ns2d_pre(u, u.clone(), dt, cfg, flags=flags)
    with pytest.raises(ValueError, match="single-device mode only"):
        nf.ns2d_post(u, u.clone(), u, u, u, dt, 0.1, 0.1, offs=(0, 0),
                     gext=(8, 8))


# -- the solvers -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4])
def test_poisson_bf16_matches_jax(n):
    """eps 0, 40 iterations: the JAX package's quarters solve at bf16 (K1
    in interpret mode) from the same bf16 fields."""
    param = Parameter(name="poisson", imax=16, jmax=16, eps=0.0, itermax=40,
                      omg=1.7, tpu_dtype="bfloat16", tpu_sor_inner=n)
    s = tpoisson.PoissonSolver(param, device="cpu")
    assert s.p.dtype == torch.bfloat16
    solve = jpoisson.make_solver_fn(
        16, 16, 1 / 16, 1 / 16, 1.7, 0.0, 40, jnp.bfloat16,
        backend="pallas", n_inner=n, layout="quarters")
    pj, resj, itj = jax.jit(solve)(_to_jax(s.p), _to_jax(s.rhs))
    it, res = s.solve()
    assert it == int(itj) == 40
    assert abs(res - float(resj)) <= 1e-5 * float(resj)
    _within(s.p, pj, 2)


def _dcavity_bf16(name, **kw):
    return jread_parameter(str(ROOT / "configs" / "dcavity.par")).replace(
        name=name, te=1e9, tpu_chunk=10, tpu_dtype="bfloat16",
        tpu_sor_inner=2, eps=0.0, itermax=20, tpu_fuse_phases="on",
        tpu_mesh="1", **kw)


@pytest.mark.parametrize("name,kw", [
    ("dcavity", dict(imax=16, jmax=16)),
    ("canal", dict(imax=24, jmax=8, bcLeft=3, bcRight=3)),
])
def test_ns2d_bf16_matches_jax_fused_chunk(name, kw):
    """10 steps against the JAX package's fused chunk at bf16 (K3/K4 and
    K1 in interpret mode); dcavity also within 0.05 of the port's float64
    run, as tests/test_ns2d.py holds the JAX package's (the canal's
    20-iteration solves of its inflow transient leave 0.12 between bf16
    and float64, in both packages alike: the bf16 fields equal JAX's)."""
    jparam = _dcavity_bf16(name, **kw)
    js = JNS2DSolver(jparam)
    ju, jv, jp, jt, jnt = js._build_chunk(backend="pallas")(
        *js.initial_state())[:5]
    param = parameter_from_dict(dataclasses.asdict(jparam))
    s = NS2DSolver(param, device="cpu")
    s.run_steps(10)
    assert s.nt == int(jnt) == 10
    assert s.t == float(jt)
    for x, ref in ((s.u, ju), (s.v, jv), (s.p, jp)):
        assert x.dtype == torch.bfloat16
        _within(x, ref, 2)
    if name != "dcavity":
        return
    s64 = NS2DSolver(param.replace(tpu_dtype="float64"), device="cpu")
    s64.run_steps(10)
    for x, ref in ((s.u, s64.u), (s.v, s64.v)):
        assert (x.double() - ref).abs().max() <= 0.05


def test_cli_bf16_writes_dat_files(tmp_path, monkeypatch, capsys):
    """configs/dcavity.par at bf16 with te 2e-4 (two steps of 1000
    iterations: eps 1e-3 lies under the bf16 floor, so every solve runs
    to itermax, and warns so)."""
    text = (ROOT / "configs" / "dcavity.par").read_text()
    par = tmp_path / "dcavity.par"
    par.write_text(text.replace("te         10.0", "te         2e-4")
                   .replace("tpu_dtype  float64", "tpu_dtype  bfloat16"))
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="residual floor"):
        assert cli.main(["pampi_tpu_torch", "--device", "cpu",
                         str(par)]) == 0
    assert "Solution took" in capsys.readouterr().out
    p = read_pressure(str(tmp_path / "pressure.dat"))
    u, v = read_velocity(str(tmp_path / "velocity.dat"))
    assert p.shape == u.shape == v.shape == (100, 100)
    assert np.isfinite(p).all() and np.abs(u).max() > 0


def test_state_from_jax_bf16_arrays_is_bitwise():
    rng = np.random.default_rng(3)
    arrs = [jnp.asarray(rng.normal(size=(18, 18)), jnp.bfloat16)
            for _ in range(3)]
    param = Parameter(name="poisson", imax=16, jmax=16,
                      tpu_dtype="bfloat16")
    s = tpoisson.PoissonSolver.from_numpy(param, arrs[0], arrs[1],
                                          device="cpu")
    ns = NS2DSolver.from_numpy_state(param.replace(name="dcavity"), *arrs,
                                     0.5, 7, device="cpu")
    for t, a in ((s.p, arrs[0]), (s.rhs, arrs[1]), (ns.u, arrs[0]),
                 (ns.v, arrs[1]), (ns.p, arrs[2])):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(a).view(np.int16))
    assert (ns.t, ns.nt) == (0.5, 7)


_REFUSED = {
    "mesh": (NS2DSolver, dict(name="dcavity", tpu_mesh="2x2")),
    "obstacles": (NS2DSolver, dict(name="canal_obstacle", imax=32,
                                   obstacles="0.2,0.2,0.4,0.4")),
    "ns3d": (NS3DSolver, dict(name="dcavity3d", imax=8, jmax=8, kmax=8)),
    "mg": (tpoisson.PoissonSolver, dict(name="poisson", tpu_solver="mg")),
    "auto": (NS2DSolver, dict(name="dcavity", tpu_solver="auto")),
    "checkerboard": (tpoisson.PoissonSolver,
                     dict(name="poisson", tpu_sor_layout="checkerboard")),
    "odd-grid": (NS2DSolver, dict(name="dcavity", imax=17)),
    "fleet": (lambda p, device: ClassSolver(p, 16, 16, device=device),
              dict(name="dcavity")),
}


@pytest.mark.parametrize("path", list(_REFUSED) + ["fft"])
def test_refused_bf16_paths_name_the_roadmap(path):
    base = dict(imax=16, jmax=16, tpu_dtype="bfloat16")
    if path == "fft":
        with pytest.raises(ValueError, match="fft needs float32/float64"):
            tpoisson.PoissonSolver(Parameter(name="poisson", tpu_solver="fft",
                                             **base), device="cpu")
        return
    build, kw = _REFUSED[path]
    with pytest.raises(NotImplementedError, match="ROADMAP A item 11.1"):
        build(Parameter(**{**base, **kw}), device="cpu")
