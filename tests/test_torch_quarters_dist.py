"""The distributed quarter layout of the port
(pampi_tpu_torch/parallel/quarters_dist.py) and the plain version of K13
(ops/sor_qdist.py) against the JAX package's: packing, masks, the
quarter-space exchange, and the per-shard iterations against the JAX
interpret-mode Pallas kernel. The port's stored plane is the compact
(4, jq, iq); the JAX one pads it for the TPU (a window halo h above, lane
padding on the right), so the two are compared on the logical region
[h, h + jq) x [0, iq) of the JAX plane."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pampi_tpu.ops.sor_qdist import make_rb_iters_qdist
from pampi_tpu.parallel import comm as jcomm
from pampi_tpu.parallel import quarters_dist as jqd
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.ops import sor_qdist as sq
from pampi_tpu_torch.ops.sor_kernels import sor_coefficients
from pampi_tpu_torch.parallel import comm
from pampi_tpu_torch.parallel import quarters_dist as qd
from pampi_tpu_torch.utils.params import Parameter

JMAX = IMAX = 32
JL, IL, N = 16, 8, 2
OFFSETS = [(0, 0), (8, 4), (0, 12)]


def _logical(x, gj):
    """The JAX plane's logical region, as numpy."""
    return np.asarray(x)[..., gj.h:gj.h + gj.jq, :gj.iq]


def _geoms(jmax=JMAX, imax=IMAX, jl=JL, il=IL, n=N):
    return (jqd.make_qgeom(jmax, imax, jl, il, n, jnp.float64),
            qd.make_qgeom(jmax, imax, jl, il, n))


def _ext(seed, jl=JL, il=IL):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((jl + 2, il + 2))


def test_geometry_drops_only_the_tpu_padding():
    gj, g = _geoms()
    assert (g.jq, g.iq, g.n) == (gj.jq, gj.iq, gj.n)
    assert g.row_base == gj.row_base - gj.h and g.col_base == gj.col_base


def test_pack_unpack_round_trip_and_match_jax():
    gj, g = _geoms()
    ext = _ext(0)
    xq = qd.pack_ext_to_q(torch.from_numpy(ext), g)
    assert tuple(xq.shape) == (4, g.jq, g.iq)
    np.testing.assert_array_equal(
        xq.numpy(), _logical(jqd.pack_ext_to_q(jnp.asarray(ext), gj), gj))
    np.testing.assert_array_equal(qd.unpack_q_to_ext(xq, g).numpy(), ext)


@pytest.mark.parametrize("qoffs", OFFSETS)
def test_q_masks_match_jax(qoffs):
    gj, g = _geoms()
    want = jqd.q_masks(gj, *qoffs)
    got = qd.q_masks(g, *qoffs)
    for key in ("upd", "own"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a.numpy(), _logical(b, gj))
    walls = [k for k in want if k not in ("upd", "own")]
    assert sorted(walls) == sorted(k for k in got if k not in ("upd", "own"))
    for k in walls:
        np.testing.assert_array_equal(got[k].numpy(), _logical(want[k], gj))


@pytest.mark.parametrize("qoffs", OFFSETS)
def test_plain_version_matches_jax_interpret_kernel(qoffs):
    """The plain version of K13 against the JAX Pallas kernel (interpret
    mode) and the JAX twin, on the same stacked planes at a shard's
    offsets. Op by op (the twin run eagerly, as K13 is built without fma
    contraction) the planes agree bitwise; XLA compiles the interpret
    kernel with contracted multiply-adds, which moves the last bit of some
    cells (the JAX package's ulp contract for compound stencil
    arithmetic). The r² sums are taken in another order."""
    gj, g = _geoms()
    ext, rhse = _ext(7), _ext(8)
    factor, idx2, idy2 = sor_coefficients(1.0 / IMAX, 1.0 / JMAX, 1.9)
    xj = jqd.pack_ext_to_q(jnp.asarray(ext), gj)
    rj = jqd.pack_ext_to_q(jnp.asarray(rhse), gj)
    rb = make_rb_iters_qdist(gj, 1.0 / IMAX, 1.0 / JMAX, 1.9, jnp.float64,
                             interpret=True)
    k_x, k_r = rb(jnp.asarray(qoffs, jnp.int32), xj, rj)
    t_x, t_r = jqd.rb_iters_q_jnp(xj, rj, gj, jqd.q_masks(gj, *qoffs),
                                  factor, idx2, idy2)
    xq = qd.pack_ext_to_q(torch.from_numpy(ext), g)
    rq = qd.pack_ext_to_q(torch.from_numpy(rhse), g)
    launches = sq.RB_SOR_QDIST.launches
    yq = torch.empty_like(xq)
    r = sq.rb_sor_qdist(xq, rq, g, qoffs, factor, idx2, idy2, yq)
    assert sq.RB_SOR_QDIST.launches == launches  # a CPU tensor: plain
    np.testing.assert_array_equal(yq.numpy(), _logical(t_x, gj))
    np.testing.assert_allclose(yq.numpy(), _logical(k_x, gj), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(float(r), float(t_r), rtol=1e-13)
    np.testing.assert_allclose(float(r), float(k_r), rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_matches_jax_twin(dtype):
    """rb_iters_q against the JAX jnp twin, float32 and float64, on a
    bottom-left and an interior shard of a 48x40 grid at n = 3."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    gj = jqd.make_qgeom(48, 40, 24, 20, 3, jdt)
    g = qd.make_qgeom(48, 40, 24, 20, 3)
    ext, rhse = _ext(3, 24, 20), _ext(4, 24, 20)
    factor, idx2, idy2 = sor_coefficients(1.0 / 40, 1.0 / 48, 1.7)
    for qoffs in ((0, 0), (12, 10)):
        t_x, t_r = jqd.rb_iters_q_jnp(
            jqd.pack_ext_to_q(jnp.asarray(ext, jdt), gj),
            jqd.pack_ext_to_q(jnp.asarray(rhse, jdt), gj), gj,
            jqd.q_masks(gj, *qoffs), factor, idx2, idy2)
        x, r = qd.rb_iters_q(
            qd.pack_ext_to_q(torch.from_numpy(ext).to(dtype), g),
            qd.pack_ext_to_q(torch.from_numpy(rhse).to(dtype), g), g,
            qd.q_masks(g, *qoffs), factor, idx2, idy2)
        np.testing.assert_array_equal(x.numpy(), _logical(t_x, gj))
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        np.testing.assert_allclose(float(r), float(t_r), rtol=rtol)


def test_q_exchange_matches_jax():
    """The quarter-space exchange on a (2, 4) mesh of random planes, walls
    included: bitwise on the logical region of every shard."""
    dims = (2, 4)
    jmax, imax, jl, il, n = 32, 48, 16, 12, 3
    gj = jqd.make_qgeom(jmax, imax, jl, il, n, jnp.float64)
    g = qd.make_qgeom(jmax, imax, jl, il, n)
    rng = np.random.default_rng(11)
    planes = [rng.standard_normal((4, g.jq, g.iq)) for _ in range(8)]
    big = np.zeros((4, 2 * gj.rp, 4 * gj.w2p))
    for s, x in enumerate(planes):
        cj, ci = divmod(s, 4)
        r0, c0 = cj * gj.rp + gj.h, ci * gj.w2p
        big[:, r0:r0 + g.jq, c0:c0 + g.iq] = x
    jc = jcomm.CartComm(ndims=2, dims=dims)
    fn = jc.shard_map(lambda x: jqd.q_exchange(x, jc, gj),
                      in_specs=(P(None, "j", "i"),),
                      out_specs=P(None, "j", "i"))
    out = np.asarray(jax.jit(fn)(jnp.asarray(big)))
    got = qd.q_exchange([torch.from_numpy(x.copy()) for x in planes],
                        comm.CartComm(ndims=2, dims=dims,
                                      devices=[torch.device("cpu")]), g)
    for s, x in enumerate(got):
        cj, ci = divmod(s, 4)
        r0, c0 = cj * gj.rp + gj.h, ci * gj.w2p
        np.testing.assert_array_equal(
            x.numpy(), out[:, r0:r0 + g.jq, c0:c0 + g.iq])


def test_supported_and_clamp_match_jax():
    for jmax, imax, jl, il in ((64, 64, 16, 8), (64, 63, 16, 8),
                               (64, 64, 15, 8), (64, 64, 2, 8),
                               (8, 8, 4, 4), (36, 20, 18, 7)):
        assert qd.qdist_supported(jmax, imax, jl, il) == \
            jqd.qdist_supported(jmax, imax, jl, il)
    for n in range(1, 12):
        for jl, il in ((64, 8), (4, 4), (16, 100), (6, 6)):
            assert qd.qdist_clamp(n, jl, il) == jqd.qdist_clamp(n, jl, il)


def test_quarters_dispatch_decisions():
    """auto and quarters take the quarter layout where it fits (the port
    does so on the CPU too); checkerboard, odd grids and the ragged or
    non-sor paths do not; a forced quarters that does not fit raises the
    JAX package's ValueError."""
    for layout in ("auto", "quarters"):
        rb, g = qd.quarters_dispatch(
            Parameter(tpu_sor_layout=layout, tpu_sor_inner=4), 64, 64, 32,
            16, 1 / 64, 1 / 64, torch.float32, "k", plain_sor=True)
        assert rb is not None and g == qd.make_qgeom(64, 64, 32, 16, 4)
        # float64 checks every tpu_ca_inner iterations, unless forced
        g64 = qd.quarters_dispatch(
            Parameter(tpu_sor_layout=layout, tpu_sor_inner=4), 64, 64, 32,
            16, 1 / 64, 1 / 64, torch.float64, "k", plain_sor=True)[1]
        assert g64.n == (4 if layout == "quarters" else 1)
    for layout, dims, plain in (("checkerboard", (64, 64, 32, 16), True),
                                ("auto", (63, 64, 63, 16), True),
                                ("auto", (64, 64, 32, 16), False)):
        assert qd.quarters_dispatch(Parameter(tpu_sor_layout=layout), *dims,
                                    1 / 64, 1 / 64, torch.float64, "k",
                                    plain_sor=plain)[0] is None
    with pytest.raises(ValueError) as ours:
        qd.quarters_dispatch(Parameter(tpu_sor_layout="quarters"), 63, 64,
                             63, 16, 1 / 64, 1 / 64, torch.float64, "k",
                             plain_sor=True)
    with pytest.raises(ValueError) as theirs:
        jqd.quarters_dispatch(JParameter(tpu_sor_layout="quarters"), 63, 64,
                              63, 16, 1 / 64, 1 / 64, jnp.float64, "k",
                              plain_sor=True)
    assert str(ours.value) == str(theirs.value)
