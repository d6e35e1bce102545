"""The port's 3-D obstacle flag fields on a 3-D mesh (ops/obstacle3d.py's
distributed solve, kernel K16's plain version in ops/sor_obsdist3d.py,
models/ns3d_dist.py) on the CPU, against the JAX package on the suite's
8-device CPU mesh and against the port's single-device solver, float64.

- K16's plain version, per shard of 32x16x16 on 2x2x2 (n = 2, H = 4), one
  call on random blocks: bitwise the JAX package's jnp twin
  ca_rb_iters_obstacle_3d run op by op (fed the JAX package's deep
  coefficient slices) on every cell the kernel updates (the twin also
  refreshes the wall cells of the block's frozen outer shell, which B.15
  and K16 leave to the next exchange).
- The coefficients the port forms from a shard's deep flag block equal
  the JAX package's deep coefficient slices, and its shard masks equal
  JAX's, under shard_map, bitwise.
- The distributed solve on that mesh, 40 iterations (ca 2): against
  make_dist_obstacle_solver_3d with backend="pallas" (B.15 in interpret
  mode) and "auto" (the jnp CA), fields to 1e-12.
- NS3DDistSolver on configs/canal3d_obstacle.par cut to 32x8x8 on 2x2x2
  and 1x2x4, fused (K7/K8 in flag mode) and with tpu_fuse_phases off,
  and on 8x1x1, whose one-cell shards take the exchange-per-half-sweep
  fallback: nt and t exactly, fields to 1e-10 against JAX (its fused
  kernels in interpret mode for the 2x2x2 fused case, its phase chain
  otherwise; XLA contracts multiply-adds), to 1e-12 against the port's
  one device (0.0 is what they give)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pampi_tpu.models.ns3d_dist import NS3DDistSolver as JDist
from pampi_tpu.ops import obstacle3d as jo3
from pampi_tpu.parallel import comm as jcomm
from pampi_tpu.parallel import stencil3d as jst3
from pampi_tpu.utils import dispatch as jdispatch
from pampi_tpu.utils.params import read_parameter as jread_parameter
from pampi_tpu_torch.models.ns3d import NS3DSolver
from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
from pampi_tpu_torch.ops import obstacle3d as o3
from pampi_tpu_torch.ops import sor3d_kernels as sk3
from pampi_tpu_torch.ops import sor_obsdist3d as sod3
from pampi_tpu_torch.parallel.comm import CartComm, scatter_blocks
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.params import parameter_from_dict

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
IMAX, JMAX, KMAX = 32, 16, 16
DIMS = (2, 2, 2)
KL, JL, IL = KMAX // 2, JMAX // 2, IMAX // 2
DX, DY, DZ = 8.0 / IMAX, 4.0 / JMAX, 4.0 / KMAX
OMEGA = 1.7
BOX = "3.0,1.5,1.5,5.0,2.5,2.5"
KEYS = ("p_mask", "eps_e", "eps_w", "eps_n", "eps_s", "eps_b", "eps_f",
        "factor")


def _fluid():
    return o3.build_fluid_3d(IMAX, JMAX, KMAX, DX, DY, DZ, BOX)


def _comm(dims=DIMS):
    return CartComm(ndims=3, dims=dims, devices=[CPU])


def _deep_masks(jm, comm, s, H):
    """The JAX package's deep coefficient slices of shard s
    (deep_obstacle_masks_3d) without shard_map: its global interior
    fields padded with H-1 zeros per side, cut at the shard's offsets."""
    k0, j0, i0 = comm.offsets(s, (KL, JL, IL))
    return {k: jnp.asarray(np.pad(np.asarray(getattr(jm, k)), H - 1)[
        k0:k0 + KL + 2 * H - 2, j0:j0 + JL + 2 * H - 2,
        i0:i0 + IL + 2 * H - 2]) for k in KEYS}


def test_plain_version_per_shard_matches_jax_twin():
    n = 2
    g = sod3.ObsGeom3(KMAX, JMAX, IMAX, KL, JL, IL, n)
    m = o3.make_masks_3d(_fluid(), DX, DY, DZ, OMEGA)
    jm = jo3.make_masks_3d(_fluid(), DX, DY, DZ, OMEGA, jnp.float64)
    comm = _comm()
    idx2, idy2, idz2 = 1 / DX**2, 1 / DY**2, 1 / DZ**2
    inner = (slice(1, -1),) * 3
    rng = np.random.default_rng(9)
    for s in range(comm.size):
        offs = comm.offsets(s, (KL, JL, IL))
        p, rhs = rng.standard_normal(g.shape), rng.standard_normal(g.shape)
        flags = o3.deep_flag_block_3d(m, comm, s, KL, JL, IL, g.H)
        x = torch.from_numpy(p.copy())
        r = sod3.rb_sor_obsdist3d(x, torch.from_numpy(rhs), flags, g, offs,
                                  OMEGA, idx2, idy2, idz2)
        cm = jst3.ca_masks_3d(KL, JL, IL, g.H, KMAX, JMAX, IMAX,
                              jnp.float64, *offs)
        om = _deep_masks(jm, comm, s, g.H)
        with jax.disable_jit():
            jx, jr2 = jo3.ca_rb_iters_obstacle_3d(
                jnp.asarray(p), jnp.asarray(rhs), n, cm, om, idx2, idy2,
                idz2)
        np.testing.assert_array_equal(x.numpy()[inner],
                                      np.asarray(jx)[inner])
        assert abs(float(r) - float(jr2)) <= 1e-12 * abs(float(jr2))


def test_deep_slices_match_jax():
    """The coefficients the port forms from each shard's deep flag block
    (deep_flag_block_3d, sor3d_kernels.masked_stencil_3d) on the global
    interior, and its shard_masks_3d, against the JAX package's
    deep_obstacle_masks_3d and shard_masks_3d under shard_map, bitwise
    (JAX's slices are 0 off the global interior)."""
    m = o3.make_masks_3d(_fluid(), DX, DY, DZ, OMEGA)
    jm = jo3.make_masks_3d(_fluid(), DX, DY, DZ, OMEGA, jnp.float64)
    comm, jc = _comm(), jcomm.CartComm(ndims=3, dims=DIMS)
    g = sod3.ObsGeom3(KMAX, JMAX, IMAX, KL, JL, IL, 2)
    H = g.H

    def kern(x):
        om = jo3.deep_obstacle_masks_3d(jm, KL, JL, IL, H)
        sm = jo3.shard_masks_3d(jm, KL, JL, IL)
        return tuple(om[k] for k in KEYS) + (sm.u_face, sm.fluid)

    spec = P("k", "j", "i")
    ext = (KL + 2 * H - 2, JL + 2 * H - 2, IL + 2 * H - 2)
    outs = jax.jit(jc.shard_map(kern, in_specs=(spec,),
                                out_specs=(spec,) * (len(KEYS) + 2),
                                check_vma=False))(
        jnp.zeros(tuple(d * e for d, e in zip(DIMS, ext))))
    inner = (slice(1, -1),) * 3
    for s in range(comm.size):
        c = [s // 4, (s // 2) % 2, s % 2]
        offs = comm.offsets(s, (KL, JL, IL))
        flags = o3.deep_flag_block_3d(m, comm, s, KL, JL, IL, H)
        fl = flags.to(torch.float64)
        cell = fl[inner]
        fac, _ = sk3.masked_stencil_3d(flags, torch.float64, OMEGA,
                                       1 / DX**2, 1 / DY**2, 1 / DZ**2)
        ours = {"p_mask": cell, "factor": fac,
                "eps_e": fl[1:-1, 1:-1, 2:] * cell,
                "eps_w": fl[1:-1, 1:-1, :-2] * cell,
                "eps_n": fl[1:-1, 2:, 1:-1] * cell,
                "eps_s": fl[1:-1, :-2, 1:-1] * cell,
                "eps_b": fl[2:, 1:-1, 1:-1] * cell,
                "eps_f": fl[:-2, 1:-1, 1:-1] * cell}
        gm, _ = sod3.obsdist3d_masks(g, offs)
        interior = (gm["odd"] | gm["even"])[inner]
        sm = o3.shard_masks_3d(m, comm, s, KL, JL, IL)
        sl = tuple(slice(ci * e, (ci + 1) * e) for ci, e in zip(c, ext))
        for k, a in zip(KEYS, outs):
            got = torch.where(interior, ours[k], torch.zeros_like(fac))
            np.testing.assert_array_equal(got.numpy(), np.asarray(a[sl]), k)
        e = (KL + 2, JL + 2, IL + 2)
        sl = tuple(slice(ci * n, (ci + 1) * n) for ci, n in zip(c, e))
        for ours_, theirs in ((sm.u_face, outs[-2]), (sm.fluid, outs[-1])):
            np.testing.assert_array_equal(ours_, np.asarray(theirs[sl]))


def _fields(seed=1):
    rng = np.random.default_rng(seed)
    shape = (KMAX + 2, JMAX + 2, IMAX + 2)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _jax_solve(backend, p0, rhs):
    jm = jo3.make_masks_3d(_fluid(), DX, DY, DZ, OMEGA, jnp.float64)
    jc = jcomm.CartComm(ndims=3, dims=DIMS)
    solve, used = jo3.make_dist_obstacle_solver_3d(
        jc, IMAX, JMAX, KMAX, KL, JL, IL, DX, DY, DZ, 1e-12, 40, jm,
        jnp.float64, ca_n=2, sor_inner=2, backend=backend)
    assert used == (backend == "pallas")
    assert jdispatch.last("obstacle3d_dist") == (
        "pallas ca2" if backend == "pallas" else "jnp_ca ca2")

    def kern(p_int, rhs_int):
        pe = jcomm.halo_exchange(jnp.pad(p_int, 1), jc)
        re = jcomm.halo_exchange(jnp.pad(rhs_int, 1), jc)
        p, res, it = solve(pe, re)
        return p[1:-1, 1:-1, 1:-1], res, it

    spec = P("k", "j", "i")
    f = jax.jit(jc.shard_map(kern, in_specs=(spec, spec),
                             out_specs=(spec, P(), P()), check_vma=False))
    inner = (slice(1, -1),) * 3
    p, res, it = f(jnp.asarray(p0[inner]), jnp.asarray(rhs[inner]))
    return np.asarray(p), float(res), int(it)


def test_dist_solve_matches_jax_interpret_kernel_and_jnp_ca():
    p0, rhs = _fields()
    comm = _comm()
    m = o3.make_masks_3d(_fluid(), DX, DY, DZ, OMEGA)
    solve, used = o3.make_dist_obstacle_solver_3d(
        comm, IMAX, JMAX, KMAX, KL, JL, IL, DX, DY, DZ, 1e-12, 40, m,
        torch.float64, 2, record_key="obstacle3d_test")
    assert used and dispatch.last("obstacle3d_test") == "pallas ca2"

    def blocks(a):
        # the JAX kernel's input: its global ghost ring is the zero pad
        g = np.zeros_like(a)
        g[1:-1, 1:-1, 1:-1] = a[1:-1, 1:-1, 1:-1]
        return [torch.from_numpy(b) for b in scatter_blocks(g, comm,
                                                            (KL, JL, IL))]

    p, res, it = solve(blocks(p0), blocks(rhs))
    full = np.zeros((KMAX, JMAX, IMAX))
    for s, b in enumerate(p):
        k0, j0, i0 = comm.offsets(s, (KL, JL, IL))
        full[k0:k0 + KL, j0:j0 + JL, i0:i0 + IL] = \
            b[1:-1, 1:-1, 1:-1].numpy()
    assert it == 40
    for backend in ("pallas", "auto"):
        jp, jres, jit_ = _jax_solve(backend, p0, rhs)
        assert jit_ == 40
        scale = max(1.0, float(np.abs(jp).max()))
        np.testing.assert_allclose(full, jp, rtol=0, atol=1e-12 * scale)
        assert abs(res - jres) <= 1e-12 * abs(jres)


def _jparam(**kw):
    """configs/canal3d_obstacle.par cut to 32x8x8, te 0.6, itermax 60,
    float64."""
    base = dict(imax=32, jmax=8, kmax=8, te=0.6, itermax=60,
                tpu_dtype="float64")
    return jread_parameter(str(ROOT / "configs" / "canal3d_obstacle.par")
                           ).replace(**{**base, **kw})


@pytest.fixture(scope="module")
def single():
    s = NS3DSolver(parameter_from_dict(dataclasses.asdict(_jparam())),
                   device="cpu")
    s.run(progress=False)
    return s


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's runs, once each: its phase chain on every mesh the tests use,
    and on 2x2x2 its fused kernels in interpret mode (tpu_fuse_phases
    on)."""
    out = {}
    for dims, fuse in (((2, 2, 2), "off"), ((2, 2, 2), "on"),
                       ((1, 2, 4), "off"), ((8, 1, 1), "off")):
        js = JDist(_jparam(tpu_fuse_phases=fuse),
                   jcomm.CartComm(ndims=3, dims=dims))
        js.run(progress=False)
        out[dims, fuse] = (js.nt, js.t, js.global_fields(),
                           jdispatch.last("obstacle3d_dist"))
    return out


@pytest.mark.parametrize("dims,fuse,label,phases", [
    ((2, 2, 2), "auto", "pallas ca1", "kernel_fused"),
    ((2, 2, 2), "off", "pallas ca1", "jnp (tpu_fuse_phases off)"),
    ((1, 2, 4), "auto", "pallas ca1", "kernel_fused"),
    ((1, 2, 4), "off", "pallas ca1", "jnp (tpu_fuse_phases off)"),
    ((8, 1, 1), "auto", "jnp_rb_fallback",
     "jnp (shard extents < deep halo 3)"),
], ids=["2x2x2-fused", "2x2x2-chain", "1x2x4-fused", "1x2x4-chain",
        "8x1x1-fallback"])
def test_dist_solver_matches_jax_and_one_device(dims, fuse, label, phases,
                                                single, jax_runs):
    s = NS3DDistSolver(parameter_from_dict(dataclasses.asdict(
        _jparam(tpu_fuse_phases=fuse))), _comm(dims))
    assert dispatch.last("ns3d_dist") == "obstacle_jnp"
    assert dispatch.last("obstacle3d_dist") == label
    assert dispatch.last("ns3d_dist_phases") == phases
    s.run(progress=False)
    jnt, jt, jg, jlabel = jax_runs[
        dims, "on" if dims == (2, 2, 2) and fuse == "auto" else "off"]
    # JAX runs its jnp CA where the port runs K16 (B.15 only on a TPU)
    assert jlabel == ("jnp_ca ca1" if label == "pallas ca1" else label)
    assert (s.nt, s.t) == (jnt, jt) == (single.nt, single.t)
    assert s.nt >= 3
    gf = s.global_fields()
    for name in "uvwp":
        assert np.abs(gf[name] - np.asarray(jg[name])).max() <= 1e-10, name
        assert np.abs(gf[name] - getattr(single, name).numpy()).max() \
            <= 1e-12, name


# -- a mesh that does not divide the grid: the JAX package's jnp path ---------

RBOX = "0.3,0.3,0.3,0.7,0.7,0.7"
# (mesh, (kmax, jmax, imax)): ragged along every axis, and eight shards
# along k of 9 planes, of which the fifth holds the HI ghost plane and the
# last three only dead cells
RAGGED = [((2, 2, 2), (9, 10, 10)), ((8, 1, 1), (9, 8, 8))]


def _rparam(shape, **kw):
    """configs/canal3d_obstacle.par on a unit box of `shape` cells with
    the box RBOX (3-4 cells a side), te 0.1, itermax 40, float64."""
    k, j, i = shape
    return _jparam(imax=i, jmax=j, kmax=k, xlength=1.0, ylength=1.0,
                   zlength=1.0, obstacles=RBOX, te=0.1, itermax=40, **kw)


@pytest.mark.parametrize("dims,shape", RAGGED, ids=["2x2x2", "8x1x1"])
def test_ragged_masks_and_coefficients_match_jax(dims, shape):
    """On a ragged mesh every shard's halo-1 masks (shard_masks_3d), its
    deep flag blocks at the fused step's H = 3 and the CA's H = 3, and
    the coefficient slices of the jnp path (deep_obstacle_masks_3d) at
    H = 3 and 1 against the JAX package's, whose HI sides are padded by
    the ceil-division overhang, under shard_map, bitwise; the dead cells
    read 0."""
    K, J, I = shape
    param = _rparam(shape)
    g = parameter_from_dict(dataclasses.asdict(param))
    dx, dy, dz = g.xlength / I, g.ylength / J, g.zlength / K
    fluid = o3.build_fluid_3d(I, J, K, dx, dy, dz, RBOX)
    m = o3.make_masks_3d(fluid, dx, dy, dz, OMEGA)
    jm = jo3.make_masks_3d(fluid, dx, dy, dz, OMEGA, jnp.float64)
    coef = o3.interior_coefficients_3d(m, dx, dy, dz)
    local = tuple(-(-n // d) for n, d in zip(shape, dims))
    over = [d * e - n for d, e, n in zip(dims, local, shape)]
    comm, jc = _comm(dims), jcomm.CartComm(ndims=3, dims=dims)
    spec = P("k", "j", "i")
    for H in (3, 1):
        ext = tuple(e + 2 * H - 2 for e in local)

        def kern(x):
            om = jo3.deep_obstacle_masks_3d(jm, *local, H, *over)
            sm = jo3.shard_masks_3d(jm, *local, *over)
            return tuple(om[k] for k in KEYS) + (sm.fluid, sm.u_face,
                                                 sm.v_face, sm.w_face)

        outs = jax.jit(jc.shard_map(kern, in_specs=(spec,),
                                    out_specs=(spec,) * (len(KEYS) + 4),
                                    check_vma=False))(
            jnp.zeros(tuple(d * e for d, e in zip(dims, ext))))
        wide = np.pad(fluid.astype(np.uint8),
                      [(2, 2 + o) for o in over])  # JAX fused_flag_blocks
        for s in range(comm.size):
            c = comm.coords(s)
            offs = comm.offsets(s, local)
            om = o3.deep_obstacle_masks_3d(coef, comm, s, *local, H,
                                           torch.float64)
            sl = tuple(slice(ci * e, (ci + 1) * e) for ci, e in zip(c, ext))
            for k, a in zip(KEYS, outs):
                np.testing.assert_array_equal(om[k].numpy(),
                                              np.asarray(a[sl]), k)
            e2 = tuple(e + 2 for e in local)
            sl = tuple(slice(ci * n, (ci + 1) * n) for ci, n in zip(c, e2))
            sm = o3.shard_masks_3d(m, comm, s, *local)
            for name, a in zip(("fluid", "u_face", "v_face", "w_face"),
                               outs[len(KEYS):]):
                np.testing.assert_array_equal(getattr(sm, name),
                                              np.asarray(a[sl]), name)
            deep = o3.deep_flag_block_3d(m, comm, s, *local, 3)
            np.testing.assert_array_equal(
                deep.numpy(), wide[tuple(slice(o, o + e + 6) for o, e in
                                         zip(offs, local))])


def _jax_counts(jparam, dims, tmp_path, monkeypatch):
    """JAX's distributed solver run one step a chunk, its flight recorder
    on: the solver and every step's iteration count."""
    import json

    tel = tmp_path / "telemetry.jsonl"
    monkeypatch.setenv("PAMPI_TELEMETRY", str(tel))

    class OneStep(JDist):
        CHUNK = 1

    js = OneStep(jparam, jcomm.CartComm(ndims=3, dims=dims))
    js.run(progress=False)
    monkeypatch.delenv("PAMPI_TELEMETRY")
    recs = [json.loads(ln) for ln in tel.read_text().splitlines()]
    return js, [r["iters"] for r in recs if r["kind"] == "chunk"]


@pytest.mark.parametrize("dims,shape,fuse,label", [
    ((2, 2, 2), (9, 10, 10), "on", "jnp_ca ca1 ragged"),
    ((8, 1, 1), (9, 8, 8), "off", "jnp_rb_fallback ragged"),
], ids=["2x2x2-fused", "8x1x1-fallback-chain"])
def test_ragged_obstacle_run_matches_jax(dims, shape, fuse, label,
                                         tmp_path, monkeypatch):
    """NS3DDistSolver with the box on a ragged mesh against JAX's: the
    jnp CA at depth 2n + 1 with the coefficient slices (JAX keeps its
    3-D kernel divisible-only, and so does the port: K16 is not run),
    or, on one-plane shards, the exchange-per-half-sweep fallback with
    one exchange more before the Neumann copy; K7/K8 in flag mode (K8's
    ragged mode) against JAX's Pallas kernels in interpret mode, or the
    phase chain. Each step's iteration count and nt exactly, t to an ulp,
    fields to 1e-10, the dispatch records JAX's."""
    jparam = _rparam(shape, tpu_fuse_phases=fuse)
    js, jits = _jax_counts(jparam, dims, tmp_path, monkeypatch)
    jlabels = (jdispatch.last("ns3d_dist"), jdispatch.last("obstacle3d_dist"))
    s = NS3DDistSolver(parameter_from_dict(dataclasses.asdict(jparam)),
                       _comm(dims))
    assert s.ragged
    assert (dispatch.last("ns3d_dist"), dispatch.last("obstacle3d_dist")) \
        == jlabels == ("obstacle_jnp ragged", label)
    its = []
    while s.t <= s.param.te:
        s.run_steps(1)
        its.append(int(s.last_it))
    assert its == jits and len(its) >= 2
    # t to an ulp: JAX's jitted chain contracts multiply-adds in the CFL dt
    assert s.nt == js.nt and abs(s.t - js.t) <= 1e-15 * js.t
    gf, jg = s.global_fields(), js.global_fields()
    for name in "uvwp":
        assert np.abs(gf[name] - np.asarray(jg[name])).max() <= 1e-10, name
    for a, b in zip(s.collect(), js.collect()):
        assert np.abs(a - np.asarray(b)).max() <= 1e-10
