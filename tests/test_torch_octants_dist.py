"""The distributed octant layout of the port
(pampi_tpu_torch/parallel/octants_dist.py) and the plain version of K14
(ops/sor_odist.py) against the JAX package's: geometry and eligibility,
packing, the octant-space exchange on the suite's 8-device CPU mesh, and
the per-shard iterations against the JAX twin and the JAX interpret-mode
Pallas kernel. The port's stored volume is the compact (8, kq, jq, iq); the
JAX one pads it for the TPU (a k-window halo h in front, j and i rounded
up to the tile), so the two are compared on the logical region
[h, h + kq) x [0, jq) x [0, iq) of the JAX volume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pampi_tpu.ops.sor_odist import make_rb_iters_odist
from pampi_tpu.parallel import comm as jcomm
from pampi_tpu.parallel import octants_dist as jod
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.ops import sor_odist as so
from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
from pampi_tpu_torch.parallel import comm
from pampi_tpu_torch.parallel import octants_dist as od
from pampi_tpu_torch.utils.params import Parameter

# the geometries and offsets of tests/test_octants_dist.py
TWIN_CASES = [
    (None, 8, 8, 8, ((0, 0, 0), (4, 0, 4), (0, 4, 0))),
    ((1, 2, 2), 16, 8, 8, ((0, 0, 0), (0, 4, 4), (0, 0, 4))),
    ((1, 1, 1), 16, 16, 16, ((0, 0, 0),)),
]
COEF = sor_coefficients_3d(1 / 16, 1 / 16, 1 / 16, 1.7)


def _logical(x, gj):
    """The JAX volume's logical region, as numpy."""
    return np.asarray(x)[:, gj.h:gj.h + gj.kq, :gj.jq, :gj.iq]


def _ext(seed, kl, jl, il):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((kl + 2, jl + 2, il + 2))


@pytest.mark.parametrize("dims", [None, (2, 2, 2), (1, 2, 4), (2, 1, 1),
                                  (1, 1, 1), (4, 1, 2)])
def test_geometry_drops_only_the_tpu_padding(dims):
    for kl, jl, il, n in ((8, 8, 8, 2), (16, 8, 12, 3), (4, 4, 6, 1)):
        gj = jod.make_ogeom(32, 32, 48, kl, jl, il, n, jnp.float64,
                            dims=dims)
        g = od.make_ogeom(32, 32, 48, kl, jl, il, n, dims=dims)
        assert (g.kq, g.jq, g.iq, g.n, g.d) == (gj.kq, gj.jq, gj.iq, gj.n,
                                                 gj.d)
        assert g.base == (gj.base[0] - gj.h, gj.base[1], gj.base[2])


def test_supported_and_clamp_match_jax():
    # the JAX suite's own cases first, then a sweep
    assert od.odist_clamp(8, 8, 8, 8) == jod.odist_clamp(8, 8, 8, 8) == 3
    for ext in ((16, 16, 16, 8, 4, 8), (15, 16, 16, 8, 4, 8),
                (16, 16, 16, 2, 4, 8), (16, 16, 16, 8, 8, 8),
                (16, 14, 18, 8, 7, 9), (32, 32, 32, 4, 4, 4)):
        assert od.odist_supported(*ext) == jod.odist_supported(*ext)
    for n in range(1, 10):
        for kl, jl, il in ((8, 8, 8), (4, 16, 16), (16, 4, 8), (6, 6, 20)):
            for dims in (None, (1, 1, 1), (2, 1, 4), (1, 2, 1), (2, 2, 2)):
                assert (od.odist_clamp(n, kl, jl, il, dims)
                        == jod.odist_clamp(n, kl, jl, il, dims))


def test_octants_dispatch_decisions():
    """auto and octants take the octant layout where it fits (the port
    does so on the CPU too); checkerboard and odd extents do not; a forced
    octants that does not fit raises the JAX package's ValueError."""
    for layout in ("auto", "octants"):
        rb, g, n = od.octants_dispatch(
            Parameter(tpu_sor_layout=layout, tpu_sor_inner=2), 16, 16, 16,
            8, 8, 8, 1 / 16, 1 / 16, 1 / 16, torch.float32, "k",
            dims=(2, 2, 2))
        assert rb is not None and n == 2
        assert g == od.make_ogeom(16, 16, 16, 8, 8, 8, 2, dims=(2, 2, 2))
        # float64 checks every tpu_ca_inner iterations, unless forced
        n64 = od.octants_dispatch(
            Parameter(tpu_sor_layout=layout, tpu_sor_inner=2), 16, 16, 16,
            8, 8, 8, 1 / 16, 1 / 16, 1 / 16, torch.float64, "k",
            dims=(2, 2, 2))[2]
        assert n64 == (2 if layout == "octants" else 1)
    for layout, ext in (("checkerboard", (16, 16, 16, 8, 8, 8)),
                        ("auto", (12, 12, 12, 6, 3, 6))):
        assert od.octants_dispatch(
            Parameter(tpu_sor_layout=layout), *ext, 1 / 16, 1 / 16, 1 / 16,
            torch.float64, "k")[0] is None
    # 12/4 = 3: an odd per-shard k extent (the JAX suite's refusal)
    with pytest.raises(ValueError) as ours:
        od.octants_dispatch(Parameter(tpu_sor_layout="octants"), 12, 12, 12,
                            3, 6, 12, 1 / 12, 1 / 12, 1 / 12, torch.float64,
                            "k", dims=(4, 2, 1))
    with pytest.raises(ValueError) as theirs:
        jod.octants_dispatch(JParameter(tpu_sor_layout="octants"), 12, 12,
                             12, 3, 6, 12, 1 / 12, 1 / 12, 1 / 12,
                             jnp.float64, "k", plain_sor=True,
                             dims=(4, 2, 1))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("dims", [None, (1, 2, 2), (2, 1, 1)])
def test_pack_unpack_round_trip_and_match_jax(dims):
    kl, jl, il = 8, 12, 8
    gj = jod.make_ogeom(32, 48, 32, kl, jl, il, 2, jnp.float64, dims=dims)
    g = od.make_ogeom(32, 48, 32, kl, jl, il, 2, dims=dims)
    ext = _ext(0, kl, jl, il)
    xo = od.pack_ext_to_o(torch.from_numpy(ext), g)
    assert tuple(xo.shape) == (8, g.kq, g.jq, g.iq)
    np.testing.assert_array_equal(
        xo.numpy(), _logical(jod.pack_ext_to_o(jnp.asarray(ext), gj), gj))
    np.testing.assert_array_equal(od.unpack_o_to_ext(xo, g).numpy(), ext)


@pytest.mark.parametrize("dims,kl,jl,il,offs", TWIN_CASES)
def test_masks_match_jax(dims, kl, jl, il, offs):
    gj = jod.make_ogeom(16, 16, 16, kl, jl, il, 2, jnp.float64, dims=dims)
    g = od.make_ogeom(16, 16, 16, kl, jl, il, 2, dims=dims)
    for off in offs:
        want = jod.o_masks(gj, *off)
        got = od.o_masks(g, *off)
        for key in ("upd", "own", "wall"):
            assert sorted(got[key]) == sorted(want[key])
            for k in want[key]:
                a = np.broadcast_to(got[key][k].numpy(), (g.kq, g.jq, g.iq))
                np.testing.assert_array_equal(a, _logical(
                    np.broadcast_to(want[key][k], (gj.sp, gj.jp2, gj.ip2))
                    [None], gj)[0])


@pytest.mark.parametrize("dims,kl,jl,il,offs", TWIN_CASES)
def test_plain_version_matches_jax_twin_and_interpret_kernel(dims, kl, jl,
                                                             il, offs):
    """The plain version of K14 against the JAX twin run op by op (eager,
    as K14 is built without fma contraction): bitwise; against the JAX
    Pallas kernel in interpret mode, which XLA compiles with contracted
    multiply-adds: 1e-12 of the field's scale (the r² sums in another
    order to 1e-12 relative)."""
    gj = jod.make_ogeom(16, 16, 16, kl, jl, il, 2, jnp.float64, dims=dims)
    g = od.make_ogeom(16, 16, 16, kl, jl, il, 2, dims=dims)
    ext, rhse = _ext(3, kl, jl, il), _ext(4, kl, jl, il)
    xj = jod.pack_ext_to_o(jnp.asarray(ext), gj)
    rj = jod.pack_ext_to_o(jnp.asarray(rhse), gj)
    rb = make_rb_iters_odist(gj, 1 / 16, 1 / 16, 1 / 16, 1.7, jnp.float64,
                             interpret=True)
    for off in offs:
        t_x, t_r = jod.rb_iters_o_jnp(xj, rj, gj, jod.o_masks(gj, *off),
                                      *COEF)
        k_x, k_r = rb(jnp.asarray(off, jnp.int32), xj, rj)
        xo = od.pack_ext_to_o(torch.from_numpy(ext), g)
        ro = od.pack_ext_to_o(torch.from_numpy(rhse), g)
        launches = so.RB_SOR_ODIST.launches
        out = torch.empty_like(xo)
        r = so.rb_sor_odist(xo, ro, g, off, *COEF, out)
        xo = out
        assert so.RB_SOR_ODIST.launches == launches  # a CPU tensor: plain
        np.testing.assert_array_equal(xo.numpy(), _logical(t_x, gj))
        np.testing.assert_allclose(float(r), float(t_r), rtol=1e-13)
        kx = _logical(k_x, gj)
        scale = max(1.0, float(np.abs(kx).max()))
        np.testing.assert_allclose(xo.numpy(), kx, rtol=0,
                                   atol=1e-12 * scale)
        np.testing.assert_allclose(float(r), float(k_r), rtol=1e-12)


def test_plain_version_float32_matches_interpret_kernel():
    """float32 on the (1, 2, 2) geometry against the interpret kernel:
    2e-5 of the field's scale, the r² sum to 2e-5 relative."""
    dims, kl, jl, il, offs = TWIN_CASES[1]
    gj = jod.make_ogeom(16, 16, 16, kl, jl, il, 2, jnp.float32, dims=dims)
    g = od.make_ogeom(16, 16, 16, kl, jl, il, 2, dims=dims)
    ext, rhse = _ext(5, kl, jl, il), _ext(6, kl, jl, il)
    rb = make_rb_iters_odist(gj, 1 / 16, 1 / 16, 1 / 16, 1.7, jnp.float32,
                             interpret=True)
    off = offs[1]
    k_x, k_r = rb(jnp.asarray(off, jnp.int32),
                  jod.pack_ext_to_o(jnp.asarray(ext, jnp.float32), gj),
                  jod.pack_ext_to_o(jnp.asarray(rhse, jnp.float32), gj))
    xo = od.pack_ext_to_o(torch.from_numpy(ext).float(), g)
    ro = od.pack_ext_to_o(torch.from_numpy(rhse).float(), g)
    out = torch.empty_like(xo)
    r = so.rb_sor_odist(xo, ro, g, off, *COEF, out)
    xo = out
    kx = _logical(k_x, gj)
    scale = max(1.0, float(np.abs(kx).max()))
    np.testing.assert_allclose(xo.numpy(), kx, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(float(r), float(k_r), rtol=2e-5)


@pytest.mark.parametrize("dims", [(2, 2, 2), (1, 2, 4), (2, 1, 1)])
def test_o_exchange_matches_jax(dims):
    """The octant-space exchange on random volumes, walls included:
    bitwise on the logical region of every shard."""
    ext = {(2, 2, 2): (16, 16, 16), (1, 2, 4): (16, 16, 32),
           (2, 1, 1): (16, 8, 8)}[dims]
    kl, jl, il = (e // p for e, p in zip(ext, dims))
    n = od.odist_clamp(2, kl, jl, il, dims)
    gj = jod.make_ogeom(*ext, kl, jl, il, n, jnp.float64, dims=dims)
    g = od.make_ogeom(*ext, kl, jl, il, n, dims=dims)
    rng = np.random.default_rng(11)
    vols = [rng.standard_normal((8, g.kq, g.jq, g.iq))
            for _ in range(int(np.prod(dims)))]
    Pk, Pj, Pi = dims
    big = np.zeros((8, Pk * gj.sp, Pj * gj.jp2, Pi * gj.ip2))

    def corner(s):
        ck, cj, ci = np.unravel_index(s, dims)
        return ck * gj.sp + gj.h, cj * gj.jp2, ci * gj.ip2

    for s, x in enumerate(vols):
        k0, j0, i0 = corner(s)
        big[:, k0:k0 + g.kq, j0:j0 + g.jq, i0:i0 + g.iq] = x
    jc = jcomm.CartComm(ndims=3, dims=dims)
    fn = jc.shard_map(lambda x: jod.o_exchange(x, jc, gj),
                      in_specs=(P(None, "k", "j", "i"),),
                      out_specs=P(None, "k", "j", "i"))
    out = np.asarray(jax.jit(fn)(jnp.asarray(big)))
    got = od.o_exchange([torch.from_numpy(x.copy()) for x in vols],
                        comm.CartComm(ndims=3, dims=dims,
                                      devices=[torch.device("cpu")]), g)
    for s, x in enumerate(got):
        k0, j0, i0 = corner(s)
        np.testing.assert_array_equal(
            x.numpy(), out[:, k0:k0 + g.kq, j0:j0 + g.jq, i0:i0 + g.iq])


def test_o_exchange_refuses_a_geometry_of_another_mesh():
    g = od.make_ogeom(16, 16, 16, 8, 8, 8, 2, dims=(1, 1, 1))
    xo = [torch.zeros(8, g.kq, g.jq, g.iq) for _ in range(2)]
    with pytest.raises(ValueError, match="another mesh"):
        od.o_exchange(xo, comm.CartComm(ndims=3, dims=(2, 1, 1),
                                        devices=[torch.device("cpu")]), g)
