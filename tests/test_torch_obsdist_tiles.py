"""The tile plans of kernels K15 and K16 (ops/sor_obsdist.py,
ops/sor_obsdist3d.py) on the CPU, where the kernels' plain versions run.

Each CTA of K15/K16 holds one owned tile of the shard's deep block and a
halo of ht cells a side (K16: over a slab of planes with a k-halo of ht),
clipped to the block, and runs all n iterations of a call there. The
halo is enough when the tile's owned cells and owned r² do not depend on
anything outside that box. So, for every tile of a plan: replace p, rhs
and the flags outside the box with other finite random values, run the
unchanged plain version, and require the tile's owned cells and owned r²
bitwise those of the unmodified run. The per-cell r² comes from a copy of
the plain loop that is first held bitwise against the plain version
(field and residual).

Cases: n = 1..4 on 33x18 on the ragged (4, 2) mesh (H = 2n+1; its last
row of shards overhangs the grid into dead cells), all-fluid and with an
obstacle, with small boxes so that tiles cut every shard; the real
plans at float32 and float64 on shards of several tiles with an
obstacle crossing tile edges, and on a shard smaller than one tile (the
CLI's 34² shards of configs/dcavity.par on 3x3, 64x16x16 of
configs/canal3d_obstacle.par on 2x2x2); a pass of a split call (its
smaller halo). The tiles partition the block; the launch plans fit
shared memory and split n into passes only where the ring or box would
not; the `out=` form leaves p untouched and writes the in-place result
bitwise."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pampi_tpu_torch.ops import obstacle as obst
from pampi_tpu_torch.ops import obstacle3d as o3
from pampi_tpu_torch.ops import sor_obsdist as sod
from pampi_tpu_torch.ops import sor_obsdist3d as sod3
from pampi_tpu_torch.ops.sor3d_kernels import masked_stencil_3d
from pampi_tpu_torch.ops.sor_kernels import masked_stencil_2d, ordered_r2_sum
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.parallel.stencil2d import ca_halo

CPU = torch.device("cpu")
OMEGA = 1.7


def _plain_r2_2d(p, rhs, flags, g, offs, idx2, idy2):
    """K15's plain loop (rb_iters_obsdist_plain) returning the new block
    and the per-cell r² of the last iteration over the owned cells (0
    elsewhere), on copies."""
    m = sod.obsdist_masks(g, int(offs[0]), int(offs[1]))
    inner = (slice(1, -1), slice(1, -1))
    fluid = flags[inner] != 0
    red, black = m["red"][inner] & fluid, m["black"][inner] & fluid
    fac, lap = masked_stencil_2d(flags, p.dtype, OMEGA, idx2, idy2)
    zero = torch.zeros((), dtype=p.dtype)
    x = p.clone()
    for _ in range(g.n):
        r_red = torch.where(red, rhs[inner] - lap(x), zero)
        x[inner] = x[inner] - fac * r_red
        r_blk = torch.where(black, rhs[inner] - lap(x), zero)
        x[inner] = x[inner] - fac * r_blk
        for key, shift, dim in (("row_lo", -1, 0), ("row_hi", 1, 0),
                                ("col_lo", -1, 1), ("col_hi", 1, 1)):
            x = torch.where(m[key], torch.roll(x, shift, dim), x)
    r2 = torch.zeros_like(p)
    r2[inner] = torch.where(m["owned"][inner],
                            r_red * r_red + r_blk * r_blk, zero)
    return x, r2


def _plain_r2_3d(p, rhs, flags, g, offs, coef):
    """K16's plain loop (rb_iters_obsdist3d_plain) returning the new block
    and the per-cell r² of the last iteration over the owned cells."""
    m, own = sod3.obsdist3d_masks(g, offs)
    inner = (slice(1, -1),) * 3
    fluid = flags[inner] != 0
    odd, even = m["odd"][inner] & fluid, m["even"][inner] & fluid
    fac, lap = masked_stencil_3d(flags, p.dtype, OMEGA, *coef)
    zero = torch.zeros((), dtype=p.dtype)
    x = p.clone()
    for _ in range(g.n):
        r_odd = torch.where(odd, rhs[inner] - lap(x), zero)
        x[inner] = x[inner] - fac * r_odd
        r_evn = torch.where(even, rhs[inner] - lap(x), zero)
        x[inner] = x[inner] - fac * r_evn
        for key, shift, dim in (("front", -1, 0), ("back", 1, 0),
                                ("bottom", -1, 1), ("top", 1, 1),
                                ("left", -1, 2), ("right", 1, 2)):
            x = torch.where(m[key], torch.roll(x, shift, dim), x)
    full = torch.zeros_like(p)
    full[inner] = r_odd * r_odd + r_evn * r_evn
    r2 = torch.zeros_like(p)
    r2[own] = full[own]
    return x, r2


def _box(tile, ht, shape):
    return tuple(slice(max(0, lo - ht), min(n, hi + ht))
                 for lo, hi, n in zip(tile[::2], tile[1::2], shape))


def _check_tiles(run, fields, tiles, ht, seed):
    """For every tile: p, rhs, flags outside its haloed box replaced, the
    tile's owned cells and owned r² bitwise those of the unmodified run."""
    x0, rhs, flags = fields
    ref_x, ref_r2 = run(x0, rhs, flags)
    rng = np.random.default_rng(seed)
    shape = tuple(x0.shape)
    for tile in tiles:
        inside = torch.zeros(shape, dtype=torch.bool)
        inside[_box(tile, ht, shape)] = True
        other = [torch.from_numpy(rng.normal(size=shape)).to(x0.dtype)
                 for _ in range(2)]
        fl = torch.from_numpy(rng.integers(0, 2, size=shape, dtype=np.uint8))
        x, r2 = run(torch.where(inside, x0, other[0]),
                    torch.where(inside, rhs, other[1]),
                    torch.where(inside, flags, fl))
        own = tuple(slice(lo, hi) for lo, hi in zip(tile[::2], tile[1::2]))
        assert torch.equal(x[own], ref_x[own]), tile
        assert torch.equal(r2[own], ref_r2[own]), tile


def _covers_once(tiles, shape):
    count = torch.zeros(shape, dtype=torch.int32)
    for tile in tiles:
        count[tuple(slice(lo, hi) for lo, hi in
                    zip(tile[::2], tile[1::2]))] += 1
    return bool((count == 1).all())


# -- K15 ---------------------------------------------------------------------


def _setup_2d(imax, jmax, dims, n, ragged, obstacle, dtype, seed, s=None):
    """(geometry, [(offsets, p, rhs, flags) per shard], coefficients) of
    imax x jmax on a dims mesh; shard s only when given."""
    jl, il = -(-jmax // dims[0]), -(-imax // dims[1])
    dx, dy = 4.0 / imax, 2.0 / jmax
    fluid = np.ones((jmax + 2, imax + 2), bool)
    if obstacle:
        # a box that crosses tile edges of every plan below
        fluid[jmax // 3:jmax // 3 + max(2, jmax // 3),
              imax // 3:imax // 3 + max(2, imax // 3)] = False
    m = obst.make_masks(fluid, dx, dy, OMEGA)
    comm = CartComm(ndims=2, dims=dims, devices=[CPU])
    H = ca_halo(n, ragged)
    g = sod.ObsGeom(jmax, imax, jl, il, n, H)
    rng = np.random.default_rng(seed)
    shards = []
    for k in range(comm.size) if s is None else (s,):
        p, rhs = (torch.from_numpy(rng.normal(size=g.shape)).to(dtype)
                  for _ in range(2))
        shards.append((comm.offsets(k, (jl, il)), p, rhs,
                       obst.deep_flag_block(m, comm, k, jl, il, H, jmax,
                                            imax)))
    return g, shards, (1.0 / (dx * dx), 1.0 / (dy * dy))


def _run_2d(g, offs, coef):
    return lambda p, rhs, fl: _plain_r2_2d(p, rhs, fl, g, offs, *coef)


@pytest.mark.parametrize("obstacle", [False, True])
def test_plain_loop_copy_is_the_plain_version(obstacle):
    g, shards, coef = _setup_2d(33, 18, (4, 2), 2, True, obstacle,
                                torch.float64, 3)
    for offs, p, rhs, fl in shards:
        x, r2 = _plain_r2_2d(p, rhs, fl, g, offs, *coef)
        xp = p.clone()
        r = sod.rb_iters_obsdist_plain(xp, rhs, fl, g, offs, OMEGA, *coef)
        assert torch.equal(x, xp)
        assert torch.equal(torch.sum(r2[1:-1, 1:-1].contiguous()), r)


@pytest.mark.parametrize("obstacle", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k15_tile_halo_ragged_small_tiles(monkeypatch, n, obstacle):
    """33x18 on the ragged (4, 2) mesh (H = 2n+1; the last shard row holds
    dead cells), boxes of 4x6 owned cells plus the halo: every tile of the
    first and of the overhanging shards."""
    H = ca_halo(n, True)
    monkeypatch.setattr(sod, "_BOX", {8: (2 * H + 4, 2 * H + 6)})
    monkeypatch.setattr(sod, "_MIN_TILE", (1, 1))
    for s in (0, 7):
        g, shards, coef = _setup_2d(33, 18, (4, 2), n, True, obstacle,
                                    torch.float64, 11 + n, s)
        ((offs, p, rhs, fl),) = shards
        tiles = sod.obsdist_tiles(g, 8)
        assert len(tiles) > 4 and _covers_once(tiles, g.shape)
        _check_tiles(_run_2d(g, offs, coef), (p, rhs, fl), tiles, H, 21 + s)


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
@pytest.mark.parametrize("obstacle", [False, True])
def test_k15_tile_halo_real_plan(itemsize, dtype, obstacle):
    """The shipped plans (96x128 boxes at float32, 64x96 at float64) on the
    shards of 250x130 on 2x2 (n = 4, H = 8), several tiles a shard, the
    obstacle across tile edges."""
    g, shards, coef = _setup_2d(250, 130, (2, 2), 4, False, obstacle, dtype,
                                31)
    for k, (offs, p, rhs, fl) in enumerate(shards[:2]):
        tiles = sod.obsdist_tiles(g, itemsize)
        assert len(tiles) >= 4 and _covers_once(tiles, g.shape)
        (pl,) = sod.obsdist_passes(g, itemsize)
        assert pl.ht == 2 * g.n + 1
        _check_tiles(_run_2d(g, offs, coef), (p, rhs, fl), tiles, pl.ht,
                     41 + k)


def test_k15_shard_smaller_than_a_tile():
    """configs/dcavity.par's 34² shards on 3x3 (f64, n = 1, H = 3): one
    tile, the whole block, its box every side at the block's edge."""
    g, shards, coef = _setup_2d(100, 100, (3, 3), 1, True, False,
                                torch.float64, 51)
    for itemsize in (4, 8):
        assert sod.obsdist_tiles(g, itemsize) == [(0, g.shape[0], 0,
                                                   g.shape[1])]
    offs, p, rhs, fl = shards[4]
    _check_tiles(_run_2d(g, offs, coef), (p, rhs, fl),
                 sod.obsdist_tiles(g, 8), g.H, 53)


def test_k15_split_pass_halo(monkeypatch):
    """A call split into passes (shared memory forced small): each pass
    of m iterations takes the smaller halo ca_halo(m) of the block's kind,
    and that halo is enough for the pass."""
    monkeypatch.setattr(sod, "SMEM_LIMIT", 5000)
    monkeypatch.setattr(sod, "_BOX", {8: (12, 14)})
    monkeypatch.setattr(sod, "_MIN_TILE", (1, 1))
    g, shards, coef = _setup_2d(33, 18, (4, 2), 4, True, True,
                                torch.float64, 61, 0)
    passes = sod.obsdist_passes(g, 8)
    assert [pl.n for pl in passes] == [2, 2]
    assert all(pl.ht == ca_halo(2, True) and pl.smem <= 5000
               for pl in passes)
    ((offs, p, rhs, fl),) = shards
    half = sod.ObsGeom(g.jmax, g.imax, g.jl, g.il, 2, g.H)
    _check_tiles(_run_2d(half, offs, coef), (p, rhs, fl),
                 sod.obsdist_tiles(g, 8, n=2), passes[0].ht, 63)


@pytest.mark.parametrize("n", [1, 4, 12, 40])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_k15_launch_plans_fit(n, itemsize):
    """One launch a call wherever the box fits shared memory (n up to the
    tens); the pass lengths add up to n and every box fits."""
    g = sod.ObsGeom(4096, 4096, 1366, 4096, n, ca_halo(n, True))
    passes = sod.obsdist_passes(g, itemsize)
    assert sum(pl.n for pl in passes) == n
    assert all(pl.smem <= sod.SMEM_LIMIT and pl.P % 2 == 0
               for pl in passes)
    if n <= 12:
        assert len(passes) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("obstacle", [False, True])
def test_k15_out_form(dtype, obstacle):
    """rb_sor_obsdist(..., out=) on the CPU: p untouched, out and the
    residual bitwise the in-place call's."""
    g, shards, coef = _setup_2d(33, 18, (4, 2), 2, True, obstacle, dtype, 71)
    for offs, p, rhs, fl in shards:
        keep, inplace = p.clone(), p.clone()
        out = torch.full_like(p, float("nan"))
        r_out = sod.rb_sor_obsdist(p, rhs, fl, g, offs, OMEGA, *coef,
                                   out=out)
        r_in = sod.rb_sor_obsdist(inplace, rhs, fl, g, offs, OMEGA, *coef)
        assert torch.equal(p, keep)
        assert torch.equal(out, inplace) and torch.equal(r_out, r_in)


def test_k15_out_must_not_be_p():
    g, shards, coef = _setup_2d(33, 18, (4, 2), 1, True, False,
                                torch.float64, 73, 0)
    ((offs, p, rhs, fl),) = shards
    with pytest.raises(ValueError):
        sod.rb_sor_obsdist(p, rhs, fl, g, offs, OMEGA, *coef, out=p)


# -- K16 ---------------------------------------------------------------------


def _setup_3d(G, dims, n, dtype, seed, s=None):
    """(geometry, [(offsets, p, rhs, flags) per shard], (idx2, idy2,
    idz2)) of the (kmax, jmax, imax) = G grid with a box obstacle on a
    divisible dims mesh; shard s only when given."""
    kmax, jmax, imax = G
    local = tuple(e // d for e, d in zip(G, dims))
    dx, dy, dz = 8.0 / imax, 4.0 / jmax, 4.0 / kmax
    m = o3.make_masks_3d(o3.build_fluid_3d(imax, jmax, kmax, dx, dy, dz,
                                           "3.0,1.5,1.5,5.0,2.5,2.5"),
                         dx, dy, dz, OMEGA)
    comm = CartComm(ndims=3, dims=dims, devices=[CPU])
    g = sod3.ObsGeom3(*G, *local, n)
    rng = np.random.default_rng(seed)
    shards = []
    for k in range(comm.size) if s is None else (s,):
        p, rhs = (torch.from_numpy(rng.normal(size=g.shape)).to(dtype)
                  for _ in range(2))
        shards.append((comm.offsets(k, local), p, rhs,
                       o3.deep_flag_block_3d(m, comm, k, *local, g.H)))
    return g, shards, (1 / dx**2, 1 / dy**2, 1 / dz**2)


def _run_3d(g, offs, coef):
    return lambda p, rhs, fl: _plain_r2_3d(p, rhs, fl, g, offs, coef)


def test_plain_loop_copy_is_the_plain_version_3d():
    g, shards, coef = _setup_3d((16, 16, 32), (2, 2, 2), 2, torch.float64,
                                5)
    for offs, p, rhs, fl in shards:
        x, r2 = _plain_r2_3d(p, rhs, fl, g, offs, coef)
        xp = p.clone()
        r = sod3.rb_iters_obsdist3d_plain(xp, rhs, fl, g, offs, OMEGA, *coef)
        _, own = sod3.obsdist3d_masks(g, offs)
        assert torch.equal(x, xp) and torch.equal(ordered_r2_sum(r2[own]), r)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k16_tile_halo_small_tiles(monkeypatch, n):
    """The first and last shards of 32x16x32 on (2, 2, 2) with the box
    obstacle, boxes of 4x6 owned (j, i) cells plus the halo, and k cut
    into slabs with an H-deep k-halo where the block is deep enough."""
    H = 2 * n + 1
    monkeypatch.setattr(sod3, "_BOX3", {8: (2 * H + 4, 2 * H + 6)})
    g, shards, coef = _setup_3d((32, 16, 32), (2, 2, 2), n, torch.float64,
                                81 + n)
    for k, (offs, p, rhs, fl) in enumerate(shards[::7]):
        tiles = sod3.obsdist3d_tiles(g, 8)
        assert len(tiles) > 4 and _covers_once(tiles, g.shape)
        _check_tiles(_run_3d(g, offs, coef), (p, rhs, fl), tiles, H, 91 + k)
    if n <= 2:
        assert len({t[:2] for t in sod3.obsdist3d_tiles(g, 8)}) > 1


def test_k16_tile_halo_of_2n_misses_the_wall_copy(monkeypatch):
    """Why the tiles take 2n + 1: with a halo of 2n, a tile whose owned
    cells start 2n cells past an inner box edge and hold a wall-ghost
    plane (the last shard of 32x16x32 on (2, 2, 2), n = 1) gets that
    plane from a stale interior neighbour."""
    monkeypatch.setattr(sod3, "_BOX3", {8: (7, 9)})
    g, shards, coef = _setup_3d((32, 16, 32), (2, 2, 2), 1, torch.float64,
                                82, 7)
    ((offs, p, rhs, fl),) = shards
    tiles = sod3.obsdist3d_tiles(g, 8)
    with pytest.raises(AssertionError):
        _check_tiles(_run_3d(g, offs, coef), (p, rhs, fl), tiles, 2, 92)
    _check_tiles(_run_3d(g, offs, coef), (p, rhs, fl), tiles, 3, 92)


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k16_tile_halo_real_plan(itemsize, dtype):
    """The shipped plans (32x64 ring planes at float32, 32x32 at float64)
    on a shard of 16x64x128 on (2, 2, 2) (n = 2, H = 4): several (j, i)
    tiles and k slabs, the obstacle across their edges."""
    g, shards, coef = _setup_3d((16, 64, 128), (2, 2, 2), 2, dtype, 101, 7)
    ((offs, p, rhs, fl),) = shards
    tiles = sod3.obsdist3d_tiles(g, itemsize)
    assert _covers_once(tiles, g.shape)
    assert len({t[2:] for t in tiles}) >= 4 and len({t[:2] for t in tiles}) > 1
    _check_tiles(_run_3d(g, offs, coef), (p, rhs, fl), tiles, g.H + 1, 103)


def test_k16_shard_smaller_than_a_tile():
    """configs/canal3d_obstacle.par's 64x16x16 shards on 2x2x2 (f64, n = 1,
    H = 2): one (j, i) tile across j, a few across i, k in slabs."""
    g, shards, coef = _setup_3d((32, 32, 128), (2, 2, 2), 1, torch.float64,
                                111, 3)
    ((offs, p, rhs, fl),) = shards
    tiles = sod3.obsdist3d_tiles(g, 8)
    assert {t[2:4] for t in tiles} == {(0, g.shape[1])}
    assert _covers_once(tiles, g.shape)
    _check_tiles(_run_3d(g, offs, coef), (p, rhs, fl), tiles, g.H + 1, 113)


@pytest.mark.parametrize("n,passes", [(1, [1]), (4, [4]), (5, [5]),
                                      (6, [3, 3]), (11, [4, 4, 3])])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_k16_launch_plans_fit(n, passes, itemsize):
    """One pass a call up to n = 5 at either dtype; beyond, the ring of
    2n + 2 planes outgrows shared memory and the call splits. Every plan
    fits shared memory and the threads' share of a plane."""
    g = sod3.ObsGeom3(256, 256, 1024, 128, 128, 512, n)
    plans = sod3.obsdist3d_passes(g, itemsize)
    assert [pl.n for pl in plans] == passes
    BJ, BI = sod3._BOX3[itemsize]
    for pl in plans:
        assert pl.smem <= sod.SMEM_LIMIT and pl.rs == 2 * pl.n + 2
        assert pl.rows <= BJ and pl.ti + 2 * pl.ht <= BI and pl.P % 2 == 0


def test_k16_split_pass_halo():
    """A pass of a split call (n = 6 as 3 + 3) takes the halo 2m of its m
    iterations on the block of H = 2n; that halo is enough for the
    pass."""
    g, shards, coef = _setup_3d((8, 8, 16), (1, 1, 1), 6, torch.float64,
                                121)
    ((offs, p, rhs, fl),) = shards
    (pl, _) = sod3.obsdist3d_passes(g, 8)
    assert pl.n == 3 and pl.ht == 7
    # three iterations on the deep block of H = 12
    part = SimpleNamespace(**{k: getattr(g, k) for k in (
        "kmax", "jmax", "imax", "kl", "jl", "il", "H", "shape")}, n=3)
    _check_tiles(_run_3d(part, offs, coef), (p, rhs, fl),
                 sod3.obsdist3d_tiles(g, 8, n=3), pl.ht, 123)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k16_out_form(dtype):
    """rb_sor_obsdist3d(..., out=) on the CPU: p untouched, out and the
    residual bitwise the in-place call's."""
    g, shards, coef = _setup_3d((16, 16, 32), (2, 2, 2), 2, dtype, 131)
    for offs, p, rhs, fl in shards[:3]:
        keep, inplace = p.clone(), p.clone()
        out = torch.full_like(p, float("nan"))
        r_out = sod3.rb_sor_obsdist3d(p, rhs, fl, g, offs, OMEGA, *coef,
                                      out=out)
        r_in = sod3.rb_sor_obsdist3d(inplace, rhs, fl, g, offs, OMEGA, *coef)
        assert torch.equal(p, keep)
        assert torch.equal(out, inplace) and torch.equal(r_out, r_in)
