"""Kernel K15's plain version (ops/sor_obsdist.py) and the port's
distributed flag-masked solve (ops/obstacle.py) against the JAX package,
float64, on the setup of its ragged obstacle-kernel test: 33x18 on a
(4, 2) mesh (jl = 5, il = 17, both axes ragged), real obstacle flags and
all-fluid ones, n = 2 iterations per exchange (H = 2n+1 = 5), itermax 40.

- Per shard, against the JAX twin ca_rb_iters_obstacle run op by op
  (jax.disable_jit, fed the JAX package's deep coefficient slices):
  bitwise on every cell the kernel updates (the twin
  also refreshes the wall cells of the block's frozen outer ring, which
  B.14 and K15 leave to the next exchange).
- Against B.14 itself in interpret mode (make_rb_iters_obsdist, and
  make_dist_obstacle_solver(backend="pallas", ragged=True)): fields within
  1e-13 of scale, iteration counts equal, residuals to 1e-12. Not bitwise:
  XLA contracts the interpret kernel's multiply-adds into fused ones,
  which the port's plain version (like the kernel, built with
  --fmad=false) never does; a numpy transcription of the TPU kernel
  agrees with the plain version bit for bit and differs from the
  interpret kernel in the same cells.
- Against backend="auto" (the jitted jnp twin, coefficients precomputed
  in float64 by make_masks): fields within 1e-13."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from pampi_tpu.ops import obstacle as jobst
from pampi_tpu.parallel import comm as jcomm
from pampi_tpu.parallel import stencil2d as jst
from pampi_tpu_torch.ops import obstacle as obst
from pampi_tpu_torch.ops import sor_obsdist as sod
from pampi_tpu_torch.ops.sor_kernels import sor_coefficients
from pampi_tpu_torch.parallel import stencil2d as st
from pampi_tpu_torch.parallel.comm import (
    CartComm,
    halo_exchange,
    scatter_blocks,
)
from pampi_tpu_torch.utils import dispatch

CPU = torch.device("cpu")
IMAX, JMAX = 33, 18
DIMS = (4, 2)
JL, IL = -(-JMAX // DIMS[0]), -(-IMAX // DIMS[1])
DX, DY = 4.0 / IMAX, 2.0 / JMAX
OMEGA = 1.7


def _fluid(kind):
    if kind == "obstacle":
        return jobst.build_fluid(IMAX, JMAX, DX, DY, "1.2,0.5,2.0,1.1")
    return np.ones((JMAX + 2, IMAX + 2), bool)


KEYS = ("p_mask", "eps_e", "eps_w", "eps_n", "eps_s", "factor")


def _deep_masks(jm, comm, s, H):
    """The JAX twin's precomputed coefficients for shard s's deep block
    (the JAX package's deep_obstacle_masks, without its shard_map): the
    global interior constants of JAX's masks `jm` padded with zeros (H-1
    per side, plus the ragged overhang on the high side) and sliced at the
    shard's offsets, cut for the block's [1:-1] region."""
    over_j = st.deep_pad_widths(H, JL, DIMS[0], JMAX)[1] - (H - 1)
    over_i = st.deep_pad_widths(H, IL, DIMS[1], IMAX)[1] - (H - 1)
    joff, ioff = comm.offsets(s, (JL, IL))
    pad = [(H - 1, H - 1 + over_j), (H - 1, H - 1 + over_i)]
    size = (JL + 2 * H - 2, IL + 2 * H - 2)
    return {k: np.pad(np.asarray(getattr(jm, k)), pad)[
        joff:joff + size[0], ioff:ioff + size[1]] for k in KEYS}


def _fields(seed=11):
    """The JAX test's ceil-padded global fields: random on the
    (jmax+2, imax+2) array, dead cells beyond it zero."""
    rng = np.random.default_rng(seed)
    pj, pi = JL * DIMS[0] + 2, IL * DIMS[1] + 2
    out = []
    for _ in range(2):
        a = np.zeros((pj, pi))
        a[:JMAX + 2, :IMAX + 2] = rng.standard_normal((JMAX + 2, IMAX + 2))
        out.append(a)
    return out


def _jax_solve(fluid, backend, p0, rhs):
    m = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    jc = jcomm.CartComm(ndims=2, dims=DIMS)
    solve, used = jobst.make_dist_obstacle_solver(
        jc, IMAX, JMAX, JL, IL, DX, DY, 1e-12, 40, m, jnp.float64, ca_n=2,
        sor_inner=2, backend=backend, ragged=True)
    assert used == (backend == "pallas")

    def kern(p_int, rhs_int):
        pe = jcomm.halo_exchange(jnp.pad(p_int, 1), jc)
        re = jcomm.halo_exchange(jnp.pad(rhs_int, 1), jc)
        p, res, it = solve(pe, re)
        return p[1:-1, 1:-1], res, it

    spec = P("j", "i")
    f = jax.jit(jc.shard_map(kern, in_specs=(spec, spec),
                             out_specs=(spec, P(), P()), check_vma=False))
    p, res, it = f(jnp.asarray(p0[1:-1, 1:-1]), jnp.asarray(rhs[1:-1, 1:-1]))
    return np.asarray(p), float(res), int(it)


def _port_solve(fluid, p0, rhs):
    comm = CartComm(ndims=2, dims=DIMS, devices=[CPU])
    m = obst.make_masks(fluid, DX, DY, OMEGA)

    def blocks(a):
        # the JAX kernel's input: its global ghost ring is the zero pad
        g = a.copy()
        g[0, :] = g[-1, :] = 0.0
        g[:, 0] = g[:, -1] = 0.0
        return [torch.from_numpy(b) for b in scatter_blocks(g, comm,
                                                            (JL, IL))]

    solve = obst.make_dist_obstacle_solver(
        comm, IMAX, JMAX, JL, IL, DX, DY, 1e-12, 40, m, torch.float64, n=2,
        ragged=True, record_key="obsdist_test")
    assert dispatch.last("obsdist_test") == "pallas ca2 ragged"
    p, res, it = solve(blocks(p0), blocks(rhs))
    full = np.zeros((JL * DIMS[0], IL * DIMS[1]))
    for s, b in enumerate(p):
        cj, ci = comm.coords(s)
        full[cj * JL:(cj + 1) * JL, ci * IL:(ci + 1) * IL] = \
            b[1:-1, 1:-1].numpy()
    return full, res, it


@pytest.mark.parametrize("kind", ["obstacle", "all-fluid"])
def test_solve_matches_interpret_kernel_and_jnp_twin(kind):
    fluid = _fluid(kind)
    p0, rhs = _fields()
    pk, rk, itk = _jax_solve(fluid, "pallas", p0, rhs)
    pa, ra, ita = _jax_solve(fluid, "auto", p0, rhs)
    p, res, it = _port_solve(fluid, p0, rhs)
    assert it == itk == ita == 40
    scale = max(1.0, float(np.abs(pk).max()))
    np.testing.assert_allclose(p, pk, rtol=0, atol=1e-13 * scale)
    assert abs(res - rk) <= 1e-12 * abs(rk)
    np.testing.assert_allclose(p, pa, rtol=0, atol=1e-13 * scale)


@pytest.mark.parametrize("kind", ["obstacle", "all-fluid"])
def test_plain_version_per_shard_matches_eager_twin_and_kernel(kind):
    """Every shard, n = 3 at the ragged depth H = 7, one call on random p
    and rhs: K15's plain version against the JAX twin run op by op
    (bitwise where the kernel updates) and against B.14 in interpret mode
    (1e-13 of scale; the residual to 1e-12)."""
    from pampi_tpu.ops import sor_pallas as sp
    from pampi_tpu.ops.sor_obsdist import make_rb_iters_obsdist

    n = 3
    H = st.ca_halo(n, True)
    g = sod.ObsGeom(JMAX, IMAX, JL, IL, n, H)
    fluid = _fluid(kind)
    jm = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    m = obst.make_masks(fluid, DX, DY, OMEGA)
    comm = CartComm(ndims=2, dims=DIMS, devices=[CPU])
    idx2, idy2 = 1.0 / (DX * DX), 1.0 / (DY * DY)
    rb, br, h = make_rb_iters_obsdist(JMAX, IMAX, JL, IL, n, DX, DY, OMEGA,
                                      jnp.float64, interpret=True,
                                      ragged=True)
    inner = (slice(1, -1), slice(1, -1))
    rng = np.random.default_rng(5)
    for s in range(comm.size):
        offs = comm.offsets(s, (JL, IL))
        p, rhs = rng.standard_normal(g.shape), rng.standard_normal(g.shape)
        flags = obst.deep_flag_block(m, comm, s, JL, IL, H, JMAX, IMAX)
        x = torch.from_numpy(p.copy())
        r = sod.rb_sor_obsdist(x, torch.from_numpy(rhs), flags, g, offs,
                               OMEGA, idx2, idy2)
        cm = jst.ca_masks(JL, IL, H, JMAX, IMAX, jnp.float64, *offs)
        om = {k: jnp.asarray(v) for k, v in _deep_masks(jm, comm, s,
                                                         H).items()}
        with jax.disable_jit():
            jx, jr2 = jobst.ca_rb_iters_obstacle(
                jnp.asarray(p), jnp.asarray(rhs), n, cm, om, idx2, idy2)
        np.testing.assert_array_equal(x.numpy()[inner],
                                      np.asarray(jx)[inner])
        assert abs(float(r) - float(jr2)) <= 1e-12 * abs(float(jr2))
        kp, kr = rb(jnp.asarray(offs, jnp.int32),
                    *(sp.pad_array(jnp.asarray(a, jnp.float64), br, h)
                      for a in (p, rhs, flags.numpy().astype(np.float64))))
        want = np.asarray(sp.unpad_array(kp, g.shape[0] - 2,
                                          g.shape[1] - 2, h))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(x.numpy(), want, rtol=0,
                                   atol=1e-13 * scale)
        assert abs(float(r) - float(kr)) <= 1e-12 * abs(float(kr))
    assert jm.n_fluid == m.n_fluid


def test_masks_and_deep_slices_match_jax():
    """make_masks against the JAX package's, bitwise (the port keeps the
    fluid field and the face masks; every solve forms its coefficients
    from the flags, and those equal JAX's host-made interior fields on
    the fluid cells, bitwise), and the deep slices the JAX twin is fed
    above (_deep_masks) against its deep_obstacle_masks under shard_map,
    bitwise."""
    from pampi_tpu_torch.ops.sor_kernels import masked_stencil_2d

    fluid = _fluid("obstacle")
    jm = jobst.make_masks(fluid, DX, DY, OMEGA, jnp.float64)
    m = obst.make_masks(fluid, DX, DY, OMEGA)
    for name in ("fluid", "u_face", "v_face"):
        np.testing.assert_array_equal(getattr(m, name),
                                      np.asarray(getattr(jm, name)))
    assert m.n_fluid == jm.n_fluid
    fl = m.flags().to(torch.float64)
    inner = fluid[1:-1, 1:-1]
    fac, _lap = masked_stencil_2d(m.flags(), torch.float64, OMEGA,
                                  1 / (DX * DX), 1 / (DY * DY))
    np.testing.assert_array_equal(fac.numpy(), np.asarray(jm.factor))
    np.testing.assert_array_equal(inner, np.asarray(jm.p_mask) != 0)
    for name, nb in (("eps_e", fl[1:-1, 2:]), ("eps_w", fl[1:-1, :-2]),
                     ("eps_n", fl[2:, 1:-1]), ("eps_s", fl[:-2, 1:-1])):
        np.testing.assert_array_equal(np.where(inner, nb.numpy(), 0.0),
                                      np.asarray(getattr(jm, name)))
    H = st.ca_halo(2, True)
    comm = CartComm(ndims=2, dims=DIMS, devices=[CPU])
    jc = jcomm.CartComm(ndims=2, dims=DIMS)
    over_j = st.ceil_overhang(DIMS[0], JL, JMAX)
    over_i = st.ceil_overhang(DIMS[1], IL, IMAX)

    def kern(x):
        om = jobst.deep_obstacle_masks(jm, JL, IL, H, over_j, over_i)
        return tuple(om[k] for k in KEYS)

    spec = P("j", "i")
    mi, mk = JL + 2 * H - 2, IL + 2 * H - 2
    stacked = jax.jit(jc.shard_map(kern, in_specs=(spec,),
                                   out_specs=(spec,) * len(KEYS),
                                   check_vma=False))(
        jnp.zeros((DIMS[0] * mi, DIMS[1] * mk)))
    for s in range(comm.size):
        cj, ci = comm.coords(s)
        sl = (slice(cj * mi, (cj + 1) * mi), slice(ci * mk, (ci + 1) * mk))
        om = _deep_masks(jm, comm, s, H)
        for k, a in zip(KEYS, stacked):
            np.testing.assert_array_equal(om[k], np.asarray(a[sl]))


def test_fallback_on_thin_ragged_shards():
    """Shards below the CA's extents (jl = 2 on a ragged axis, il = 1)
    get no K15 solve: the caller runs stencil2d.rb_exchange_per_sweep,
    whose fields equal K15's on a mesh where K15 runs (n = 1, H = 1
    against H = 3) up to the relaxation factor's rounding (1e-13 of
    scale)."""
    jmax, imax = 15, 12
    dx, dy = 1 / imax, 1 / jmax
    m = obst.make_masks(np.ones((jmax + 2, imax + 2), bool), dx, dy, OMEGA)
    comm = CartComm(ndims=2, dims=(8, 1), devices=[CPU])
    assert obst.make_dist_obstacle_solver(
        comm, imax, jmax, 2, 12, dx, dy, 1e-30, 12, m, torch.float64, n=1,
        ragged=True, record_key="obsdist_test") is None
    assert dispatch.last("obsdist_test") == "jnp_rb_fallback ragged"
    assert obst.make_dist_obstacle_solver(
        CartComm(ndims=2, dims=(1, 8), devices=[CPU]), 8, 8, 8, 1, 1 / 8,
        1 / 8, 1e-30, 12, obst.make_masks(np.ones((10, 10), bool), 1 / 8,
                                          1 / 8, OMEGA),
        torch.float64, n=1, record_key="obsdist_test") is None
    assert dispatch.last("obsdist_test") == "jnp_rb_fallback"
    rng = np.random.default_rng(4)
    full = np.zeros((8 * 2 + 2, imax + 2))
    full[:jmax + 2] = rng.standard_normal((jmax + 2, imax + 2))
    rhs = np.zeros_like(full)
    rhs[1:jmax + 1, 1:imax + 1] = rng.standard_normal((jmax, imax))
    p = [torch.from_numpy(b) for b in scatter_blocks(full, comm, (2, imax))]
    f = halo_exchange([torch.from_numpy(b) for b in
                       scatter_blocks(rhs, comm, (2, imax))], comm)
    masks = [st.ca_masks(2, imax, 1, jmax, imax, torch.float64,
                         *comm.offsets(s, (2, imax)))
             for s in range(comm.size)]
    for _ in range(12):
        p, _r2 = st.rb_exchange_per_sweep(
            p, f, masks, comm,
            st.scalar_half(masks, *sor_coefficients(dx, dy, OMEGA)),
            ragged=True)
    comm2 = CartComm(ndims=2, dims=(2, 1), devices=[CPU])
    solve2 = obst.make_dist_obstacle_solver(
        comm2, imax, jmax, 8, 12, dx, dy, 1e-30, 12, m, torch.float64, n=1,
        ragged=True, record_key="obsdist_test")
    assert dispatch.last("obsdist_test") == "pallas ca1 ragged"
    p2, res2, it2 = solve2(*([torch.from_numpy(b) for b in
                              scatter_blocks(a, comm2, (8, imax))]
                             for a in (full, rhs)))
    assert it2 == 12 and res2 > 0
    a = np.concatenate([b[1:-1].numpy() for b in p])[:jmax]
    b = np.concatenate([b[1:-1].numpy() for b in p2])[:jmax]
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-13 * max(1.0, np.abs(b).max()))
