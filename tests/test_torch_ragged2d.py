"""The port's global-index NS-2D wall handling (parallel/ragged2d.py) and
the deep-pad helpers of parallel/stencil2d.py against the JAX package's,
float64, on the meshes of its ragged suite: (4, 2) on 18x20 (ragged along
j), (2, 4) on 20x18 (along i) and (8, 1) on 18x16, where the global ghost
row opens a fully dead shard. The JAX functions run per shard under
shard_map on the suite's 8 faked CPU devices; every output is required
bitwise equal, shard by shard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from pampi_tpu.parallel import comm as jcomm
from pampi_tpu.parallel import ragged2d as jrg
from pampi_tpu.parallel import stencil2d as jst
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.parallel import ragged2d as rg
from pampi_tpu_torch.parallel import stencil2d as st
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils.params import Parameter

CPU = torch.device("cpu")
MESHES = [((4, 2), (18, 20)), ((2, 4), (20, 18)), ((8, 1), (18, 16))]
BCS = [("dcavity", (1, 1, 1, 1)), ("canal", (3, 3, 1, 1)),
       ("dcavity", (2, 2, 2, 2)), ("canal", (3, 1, 2, 3))]


def _setup(dims, shape, name="dcavity", bcs=(1, 1, 1, 1)):
    jmax, imax = shape
    kw = dict(name=name, imax=imax, jmax=jmax, ylength=2.0, bcLeft=bcs[0],
              bcRight=bcs[1], bcBottom=bcs[2], bcTop=bcs[3])
    jl, il = -(-jmax // dims[0]), -(-imax // dims[1])
    return (JParameter(**kw), Parameter(**kw), jl, il,
            jcomm.CartComm(ndims=2, dims=dims),
            CartComm(ndims=2, dims=dims, devices=[CPU]))


def _blocks(dims, jl, il, n, seed):
    """n random stacked (Pj*(jl+2), Pi*(il+2)) arrays and their per-shard
    blocks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        big = rng.normal(size=(dims[0] * (jl + 2), dims[1] * (il + 2)))
        out.append((big, _split(big, dims, jl, il)))
    return out


def _split(big, dims, jl, il):
    return [big[cj * (jl + 2):(cj + 1) * (jl + 2),
                ci * (il + 2):(ci + 1) * (il + 2)]
            for cj in range(dims[0]) for ci in range(dims[1])]


def _jax(jc, fn, *arrays, nout=1):
    spec = P("j", "i")
    f = jax.jit(jc.shard_map(fn, in_specs=(spec,) * len(arrays),
                             out_specs=(spec,) * nout if nout > 1 else spec,
                             check_vma=False))
    out = f(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(o) for o in (out if nout > 1 else (out,))]


def _assert_shards(got_per_shard, want_big, dims, jl, il):
    for s, (g, w) in enumerate(zip(got_per_shard,
                                   _split(want_big, dims, jl, il))):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"shard {s}")


@pytest.mark.parametrize("dims,shape", MESHES)
@pytest.mark.parametrize("name,bcs", BCS)
def test_bcs_and_special_bc_match_jax(dims, shape, name, bcs):
    jp, param, jl, il, jc, comm = _setup(dims, shape, name, bcs)
    jmax, imax = shape
    dy = param.ylength / jmax
    (ub, us), (vb, vs) = _blocks(dims, jl, il, 2, sum(bcs) + jl)

    def jfn(u, v):
        u, v = jrg.set_bcs_ragged(u, v, jp, jc, jl, il, jmax, imax)
        u = jrg.set_special_bc_ragged(u, jp, jc, jl, il, jmax, imax, dy,
                                      jnp.float64)
        return u, v

    ju, jv = _jax(jc, jfn, ub, vb, nout=2)
    got_u, got_v = [], []
    for s in range(comm.size):
        u, v = rg.set_bcs_ragged(torch.from_numpy(us[s].copy()),
                                 torch.from_numpy(vs[s].copy()), param, comm,
                                 s, jl, il, jmax, imax)
        got_u.append(rg.set_special_bc_ragged(u, param, comm, s, jl, il,
                                              jmax, imax, dy))
        got_v.append(v)
    _assert_shards(got_u, ju, dims, jl, il)
    _assert_shards(got_v, jv, dims, jl, il)


@pytest.mark.parametrize("dims,shape", MESHES)
def test_fixups_live_and_wall_weight_match_jax(dims, shape):
    jp, param, jl, il, jc, comm = _setup(dims, shape)
    jmax, imax = shape
    blocks = _blocks(dims, jl, il, 4, 3 + jl)

    def jfn(f, g, u, v):
        f, g = jrg.fg_fixups_ragged(f, g, u, v, jc, jl, il, jmax, imax)
        live = jrg.live_masks(jc, jl, il, jmax, imax, jnp.float64)
        w = jrg.wall_weight_ragged(jc, jl, il, jmax, imax, jnp.float64)
        return f, g, live + 0 * f, w + 0 * f

    jf, jg, jlive, jw = _jax(jc, jfn, *(b for b, _ in blocks), nout=4)
    fs, gs, us, vs = ([torch.from_numpy(x.copy()) for x in sh]
                      for _, sh in blocks)
    got = [rg.fg_fixups_ragged(fs[s], gs[s], us[s], vs[s], comm, s, jl, il,
                               jmax, imax) for s in range(comm.size)]
    _assert_shards([a for a, _ in got], jf, dims, jl, il)
    _assert_shards([b for _, b in got], jg, dims, jl, il)
    live = [rg.live_masks(comm, s, jl, il, jmax, imax, torch.float64)
            for s in range(comm.size)]
    _assert_shards(live, jlive, dims, jl, il)
    w = [rg.wall_weight_ragged(comm, s, jl, il, jmax, imax, torch.float64)
         for s in range(comm.size)]
    _assert_shards(w, jw, dims, jl, il)
    # every global position counted once over the mesh
    assert sum(float(x.sum()) for x in w) == (jmax + 2) * (imax + 2)


@pytest.mark.parametrize("dims,shape", MESHES)
def test_index_vectors_match_jax(dims, shape):
    jp, param, jl, il, jc, comm = _setup(dims, shape)
    (b, _), = _blocks(dims, jl, il, 1, 0)

    def jfn(x):
        gj, gi = jrg.global_index_vectors(jc, jl, il)
        return (gj + 0 * gi).astype(x.dtype) * 1000 + gi

    (want,) = _jax(jc, jfn, b)
    got = []
    for s in range(comm.size):
        gj, gi = rg.global_index_vectors(comm, s, jl, il)
        got.append(((gj + 0 * gi) * 1000 + gi).to(torch.float64))
    _assert_shards(got, want, dims, jl, il)


def test_pad_widths_match_jax():
    for nper, local, gmax in ((4, 5, 18), (2, 17, 33), (8, 3, 18),
                              (2, 8, 16), (3, 1366, 4096)):
        assert st.ceil_overhang(nper, local, gmax) == \
            jst.ceil_overhang(nper, local, gmax)
        for halo in (1, 3, 9):
            assert st.deep_pad_widths(halo, local, nper, gmax) == \
                jst.deep_pad_widths(halo, local, nper, gmax)
