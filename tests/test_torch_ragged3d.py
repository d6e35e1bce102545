"""The port's global-index NS-3D wall handling (parallel/ragged3d.py) and
the ragged mode of K8's plain version (ops/ns3d.post_gated(ragged=True))
against the JAX package, float64, on the meshes of a ragged 3-D mesh's
corner cases:

- (4, 2, 1) on (k, j, i) = 10x10x12, ragged along k;
- (1, 2, 4) on 10x10x18, ragged along i;
- (2, 2, 2) on 9x11x13, ragged along every axis;
- (2, 2, 2) on 7x7x7, the shards of extent 4 (at tpu_ca_inner 2 the
  ragged CA halo 2n + 1 = 5 exceeds them);
- (4, 1, 1) on 9x8x8, whose last shard holds only the HI ghost plane and
  dead cells.

The JAX ragged functions run per shard under shard_map on the suite's 8
faked CPU devices; every output of the port's is required bitwise equal,
shard by shard. K8's ragged mode (the live-mask multiply after the
projection) is held against JAX's make_fused_post_3d(ragged=True) in
interpret mode, without and with obstacle flags, on every shard of those
meshes: the projection to 1e-12 of the field's scale (XLA contracts
multiply-adds that the port keeps apart) on every cell but the HI
interface ghosts (which read p beyond the block, and which the next
exchange overwrites), the dead cells exactly 0, each package's maxima
bitwise those of its own fields."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pampi_tpu.ops import ns3d_fused as jnf3
from pampi_tpu.parallel import comm as jcomm
from pampi_tpu.parallel import ragged3d as jrg3
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.ops import ns3d_fused as nf3
from pampi_tpu_torch.parallel import ragged3d as rg3
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils.params import Parameter

CPU = torch.device("cpu")
MESHES = [((4, 2, 1), (10, 10, 12)), ((1, 2, 4), (10, 10, 18)),
          ((2, 2, 2), (9, 11, 13)), ((2, 2, 2), (7, 7, 7)),
          ((4, 1, 1), (9, 8, 8))]
IDS = ["4x2x1-k", "1x2x4-i", "2x2x2-all", "2x2x2-7cubed", "4x1x1-ghost"]
FACES = ("top", "bottom", "left", "right", "front", "back")
# (problem, (top, bottom, left, right, front, back)): the two shipped sets
# and one that mixes every kind
BCS = [("dcavity", (1, 1, 1, 1, 1, 1)), ("canal", (1, 1, 3, 3, 1, 1)),
       ("canal", (3, 2, 1, 3, 2, 3))]


def _local(dims, shape):
    return tuple(-(-n // d) for n, d in zip(shape, dims))


def _comms(dims):
    return (jcomm.CartComm(ndims=3, dims=dims),
            CartComm(ndims=3, dims=dims, devices=[CPU]))


def _blocks(dims, local, n, seed):
    """n random stacked (Pk*(kl+2), Pj*(jl+2), Pi*(il+2)) arrays and their
    per-shard blocks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        big = rng.normal(size=tuple(d * (e + 2) for d, e in
                                    zip(dims, local)))
        out.append((big, _split(big, dims, local)))
    return out


def _split(big, dims, local):
    return [big[tuple(slice(c * (e + 2), (c + 1) * (e + 2))
                      for c, e in zip((ck, cj, ci), local))]
            for ck in range(dims[0]) for cj in range(dims[1])
            for ci in range(dims[2])]


def _jax(jc, fn, *arrays, nout=1):
    spec = P("k", "j", "i")
    f = jax.jit(jc.shard_map(fn, in_specs=(spec,) * len(arrays),
                             out_specs=(spec,) * nout if nout > 1 else spec,
                             check_vma=False))
    out = f(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(o) for o in (out if nout > 1 else (out,))]


def _assert_shards(got_per_shard, want_big, dims, local):
    for s, (g, w) in enumerate(zip(got_per_shard,
                                   _split(want_big, dims, local))):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"shard {s}")


@pytest.mark.parametrize("dims,shape", MESHES, ids=IDS)
@pytest.mark.parametrize("problem,bc", BCS,
                         ids=["dcavity", "canal", "mixed"])
def test_bcs_and_special_bc_match_jax(dims, shape, problem, bc):
    jc, comm = _comms(dims)
    local = _local(dims, shape)
    bcs = dict(zip(FACES, bc))
    (ub, us), (vb, vs), (wb, ws) = _blocks(dims, local, 3,
                                           sum(bc) + sum(local))

    def jfn(u, v, w):
        u, v, w = jrg3.set_bcs_3d_ragged(u, v, w, bcs, jc, *local, *shape)
        return jrg3.set_special_bc_3d_ragged(u, problem, jc, *local,
                                             *shape), v, w

    want = _jax(jc, jfn, ub, vb, wb, nout=3)
    got = [[], [], []]
    for s in range(comm.size):
        u, v, w = rg3.set_bcs_3d_ragged(
            *(torch.from_numpy(x[s].copy()) for x in (us, vs, ws)), bcs,
            comm, s, *local, *shape)
        u = rg3.set_special_bc_3d_ragged(u, problem, comm, s, *local, *shape)
        for lst, a in zip(got, (u, v, w)):
            lst.append(a)
    for g, w in zip(got, want):
        _assert_shards(g, w, dims, local)


@pytest.mark.parametrize("dims,shape", MESHES, ids=IDS)
def test_fixups_index_grids_and_live_masks_match_jax(dims, shape):
    jc, comm = _comms(dims)
    local = _local(dims, shape)
    blocks = _blocks(dims, local, 6, 3 + sum(local))

    def jfn(f, g, h, u, v, w):
        f, g, h = jrg3.fgh_fixups_ragged(f, g, h, u, v, w, jc, *local,
                                         *shape)
        live = jrg3.live_masks_3d(jc, *local, *shape, jnp.float64)
        gk, gj, gi = jrg3.global_index_grids(jc, *local)
        index = ((gk * 1000 + gj * 100 + gi).astype(f.dtype)
                 + 0 * f)
        return f, g, h, live + 0 * f, index

    want = _jax(jc, jfn, *(b for b, _ in blocks), nout=5)
    fs, gs, hs, us, vs, ws = ([torch.from_numpy(x.copy()) for x in sh]
                              for _, sh in blocks)
    got = [rg3.fgh_fixups_ragged(fs[s], gs[s], hs[s], us[s], vs[s], ws[s],
                                 comm, s, *local, *shape)
           for s in range(comm.size)]
    for q in range(3):
        _assert_shards([g[q] for g in got], want[q], dims, local)
    live = [rg3.live_masks_3d(comm, s, *local, *shape, torch.float64)
            for s in range(comm.size)]
    _assert_shards(live, want[3], dims, local)
    index = []
    for s in range(comm.size):
        gk, gj, gi = rg3.global_index_grids(comm, s, *local)
        index.append((gk * 1000 + gj * 100 + gi).to(torch.float64)
                     + torch.zeros(tuple(e + 2 for e in local),
                                   dtype=torch.float64))
    _assert_shards(index, want[4], dims, local)
    # interior_and_live: the gates the phase chain's projection takes
    for s in range(comm.size):
        interior, lv = rg3.interior_and_live(comm, s, *local, *shape,
                                             torch.float64)
        assert torch.equal(lv, live[s])
        gk, gj, gi = rg3.global_index_grids(comm, s, *local)
        assert torch.equal(interior, (gk >= 1) & (gk <= shape[0])
                           & (gj >= 1) & (gj <= shape[1])
                           & (gi >= 1) & (gi <= shape[2]))


def _fluid(shape):
    """A fluid flag field of the global (K+2, J+2, I+2) array with a box
    obstacle 2+ cells thick inside (the ghost ring fluid)."""
    K, J, I = shape
    fl = np.ones((K + 2, J + 2, I + 2), bool)
    fl[2:K - 1, 3:J - 1, 2:I - 2] = False
    return fl


@pytest.mark.parametrize("dims,shape", MESHES, ids=IDS)
@pytest.mark.parametrize("flags", [False, True], ids=["plain", "flags"])
def test_k8_ragged_plain_version_matches_jax(dims, shape, flags):
    """K8's ragged mode (plain version, on every shard's halo-1 blocks at
    its offsets) against JAX's make_fused_post_3d(ragged=True) in
    interpret mode, built once for the mesh's shard shape and fed each
    shard's offsets (and, with flags, its halo-1 slice of the global
    flags, zero past the grid)."""
    local = _local(dims, shape)
    kw = dict(name="dcavity3d", imax=shape[2], jmax=shape[1],
              kmax=shape[0], re=100.0)
    cfg = nf3.StepConfig3D.from_param(Parameter(**kw))
    post, pad_e, unpad_e, _h = jnf3.make_fused_post_3d(
        JParameter(**kw), *shape, cfg.dx, cfg.dy, cfg.dz, jnp.float64,
        kl=local[0], jl=local[1], il=local[2],
        fluid=True if flags else None, ragged=True, interpret=True)
    comm = CartComm(ndims=3, dims=dims, devices=[CPU])
    over = [d * e - n for d, e, n in zip(dims, local, shape)]
    glob = np.pad(_fluid(shape), [(0, o) for o in over]).astype(np.uint8)
    rng = np.random.default_rng(sum(local) + 7 * flags)
    dt = 0.011
    dt11 = jnp.full((1, 1), dt, jnp.float64)
    tdt = torch.tensor(dt, dtype=torch.float64)
    for s in range(comm.size):
        offs = comm.offsets(s, local)
        ext = [rng.normal(size=tuple(e + 2 for e in local))
               for _ in range(7)]
        extra = ()
        fl = None
        if flags:
            blk = glob[tuple(slice(o, o + e + 2)
                             for o, e in zip(offs, local))]
            extra = (pad_e(jnp.asarray(blk, jnp.float64)),)
            fl = torch.from_numpy(np.ascontiguousarray(blk))
        jout = post(jnp.asarray(offs, jnp.int32), dt11,
                    *(pad_e(jnp.asarray(a)) for a in ext), *extra)
        fields = [torch.from_numpy(a.copy()) for a in ext]
        maxima = nf3.ns3d_post(*fields, tdt, cfg.dx, cfg.dy, cfg.dz, offs,
                               shape, flags=fl, ragged=True)
        grids = rg3.global_index_grids(comm, s, *local)
        gk, gj, gi = grids
        dead = ((gk > shape[0] + 1) | (gj > shape[1] + 1)
                | (gi > shape[2] + 1)).expand(fields[0].shape).numpy()
        # a HI interface ghost (the last plane of a block whose global
        # index is a neighbour's interior cell) reads p beyond the block:
        # 0 in the port, the TPU layout's padding or wrap in JAX's kernel;
        # the next exchange overwrites it, so it is compared nowhere
        seam = torch.zeros(fields[0].shape, dtype=torch.bool)
        for a, (g, e, n) in enumerate(zip(grids, local, shape)):
            at = torch.arange(e + 2).reshape([-1 if d == a else 1
                                              for d in range(3)])
            seam = seam | ((at == e + 1) & (g <= n))
        keep = ~seam.numpy()
        for a, b, m in zip(fields[:3], jout[:3], jout[3:]):
            a, b = a.numpy(), np.asarray(unpad_e(b))
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a[keep], b[keep], rtol=0,
                                       atol=1e-12 * scale,
                                       err_msg=f"shard {s}")
            assert not a[dead].any() and not b[dead].any()
            assert float(m) == float(np.abs(b).max())
        for got, field in zip(maxima, fields):
            assert float(got) == float(field.abs().max())


def test_k8_ragged_mode_needs_a_shard():
    z = torch.zeros((6, 6, 6), dtype=torch.float64)
    dt = torch.tensor(0.01, dtype=torch.float64)
    with pytest.raises(ValueError, match="ragged mode needs"):
        nf3.ns3d_post(z, z, z, z, z, z, z, dt, 0.1, 0.1, 0.1, ragged=True)
