"""The pass plans of masked K5 (ops/sor3d_kernels.py) and K14
(ops/sor_odist.py) on the CPU, where the kernels' plain versions run.

A call of n iterations runs n passes of one iteration. Each CTA of a
pass streams one owned tile of the field (masked K5) or of the
shard's stacked octant volume (K14, the same cells of the eight slots)
and a halo of ht cells a side along k, j and i, clipped to it. The halo
is enough when the tile's owned cells and owned r² do not depend on
anything outside that box. So, for every tile of a plan's first two and
last k slabs, j rows and i columns of tiles (the others repeat the
second's geometry):
replace p, rhs (and the flags) outside the box with other finite random
values, run the unchanged plain version for one pass, and require the
tile's owned cells and owned r² bitwise those of the unmodified run; and
with the halo one smaller, require that some tile differs (masked K5
takes 3, K16's halo at one iteration, K14 1: an octant slot reads the
other colour one cell away on one side per axis).

Cases: the real plans at float32 and float64 on the timed shapes cut
down to a few tiles and slabs (canal3d_obstacle's box at 512x128x128 cut
to 5 planes; a 128³ shard of 256³ on 2x2x2 cut to 10 planes), the
CLI's shapes (configs/canal3d_obstacle.par's 128x32x32, and
configs/dcavity3d.par's 64³ shards on 2x2x2, float64, n = 1), small
boxes (the threads' rows cut: many tiles on a small field), and a field
and a volume smaller than one tile. The tiles partition the field
or volume; every plan fits shared memory and the threads; the `out=`
form leaves its input untouched, and the passes chained through two
buffers equal one plain call of n iterations; K14's plain residual
is its per-tile partials summed in tile order (written out here in
numpy)."""

import dataclasses

import numpy as np
import pytest
import torch

from pampi_tpu_torch.ops import sor3d_kernels as sk3
from pampi_tpu_torch.ops import sor_odist as so
from pampi_tpu_torch.ops.sor_obsdist import SMEM_LIMIT
from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
from pampi_tpu_torch.parallel import octants_dist as od

OMEGA = 1.7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Each halo check runs many small sweeps: one intra-op thread, so
    that several test workers on one machine do not oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng_field(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape)).to(dtype)


def _flags(shape, rng):
    """uint8 flags with a box obstacle and a scatter of obstacle cells, so
    that both the all-fluid path and the eps products run."""
    fl = np.ones(shape, np.uint8)
    k, j, i = (n // 4 for n in shape)
    fl[k:2 * k + 2, j:2 * j + 2, i:2 * i + 2] = 0
    fl[rng.random(shape) < 0.05] = 0
    return torch.from_numpy(fl)


def _box(tile, ht, shape):
    """The box of `tile` (k0, k1, j0, j1, i0, i1) over the last three axes
    of `shape`, clipped, as a boolean mask of those axes."""
    inside = torch.zeros(shape[-3:], dtype=torch.bool)
    inside[tuple(slice(max(0, lo - ht), min(n, hi + ht))
                 for lo, hi, n in zip(tile[::2], tile[1::2],
                                      shape[-3:]))] = True
    return inside


def _own(tile, lead=0):
    return (slice(None),) * lead + tuple(
        slice(lo, hi) for lo, hi in zip(tile[::2], tile[1::2]))


def _tiles_hold(run, fields, tiles, ht, seed, lead=0, first_bad=False):
    """For every tile: the fields outside its box replaced (a uint8 field
    by random 0/1), the tile's owned cells and owned r² compared with those
    of the unmodified run (r2 of the run's shape). Returns the tiles that
    differ (the first only, where first_bad)."""
    ref_x, ref_r2 = run(*fields)
    rng = np.random.default_rng(seed)
    shape = tuple(fields[0].shape)
    bad = []
    for tile in tiles:
        inside = _box(tile, ht, shape)
        swapped = []
        for x in fields:
            other = (torch.from_numpy(rng.integers(0, 2, size=x.shape,
                                                   dtype=np.uint8))
                     if x.dtype == torch.uint8 else _rng_field(rng, x.shape,
                                                               x.dtype))
            swapped.append(torch.where(inside, x, other))
        x, r2 = run(*swapped)
        own = _own(tile, lead)
        if not (torch.equal(x[own], ref_x[own])
                and torch.equal(r2[own], ref_r2[own])):
            bad.append(tile)
            if first_bad:
                break
    return bad


def _some_tiles(tiles):
    """The tiles of the first two and the last k slab, j row and i column
    of tiles: every kind of box edge (the field's or volume's on either
    side, an inner one on either side) meets some of them; the others
    repeat the second's geometry."""
    keep = [sorted({t[2 * ax:2 * ax + 2] for t in tiles}) for ax in range(3)]
    keep = [set(v[:2] + v[-1:]) for v in keep]
    return [t for t in tiles
            if all(t[2 * ax:2 * ax + 2] in keep[ax] for ax in range(3))]


def _covers_once(tiles, shape):
    count = torch.zeros(shape, dtype=torch.int32)
    for t in tiles:
        count[_own(t)] += 1
    return bool((count == 1).all())


# -- masked K5 ---------------------------------------------------------------


def _k5_case(K, J, I, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (K + 2, J + 2, I + 2)
    return (_rng_field(rng, shape, dtype), _rng_field(rng, shape, dtype),
            _flags(shape, rng))


def _k5_run(coef):
    """One pass (one iteration) of the plain version: (the new field, the
    iteration's r² on the field's shape, 0 on the shell)."""
    def run(p, rhs, flags):
        x = p.clone()
        r2 = torch.zeros_like(p)
        r2[1:-1, 1:-1, 1:-1] = sk3.masked_sweeps_3d(x, rhs, flags, 1, OMEGA,
                                                     *coef)
        return x, r2
    return run


def _k5_holds(K, J, I, dtype, pl, seed, shrunk_fails=True):
    """The halo 3 holds for every tile; with 2, where shrunk_fails, some
    tile differs. A pass's staleness reaches 1 cell in from a box edge
    that lies inside the field, so the cells 2 in come out right unless
    they copy a stale neighbour: a wall-ghost layer 2 in (a tile that owns
    the ghost plane K + 1 and nothing below it) does."""
    x, f, fl = _k5_case(K, J, I, dtype, seed)
    # near-isotropic coefficients: a cell's weight on a neighbour a cell
    # away stays above float32's rounding
    coef = (1.0, 1.3, 0.8)
    tiles = sk3.masked_tiles(K, J, I, pl)
    assert _covers_once(tiles, x.shape)
    run = _k5_run(coef)
    assert _tiles_hold(run, (x, f, fl), _some_tiles(tiles), sk3.HALO5,
                       seed) == []
    if shrunk_fails:
        assert (K + 1, K + 2) in {t[:2] for t in tiles}
        assert _tiles_hold(run, (x, f, fl), tiles, sk3.HALO5 - 1, seed,
                           first_bad=True) != []
    return tiles


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k5_tile_halo_real_plan(itemsize, dtype):
    """The real pass at the timed shape's (j, i) plane (128x128, the box
    of canal3d_obstacle.par at 512x128x128) cut to 5 planes: several
    (j, i) tiles and k slabs, tiles cut at every face, the last slab the
    ghost plane alone; halo 3 holds, 2 does not."""
    K, J, I = 5, 128, 128
    pl = sk3.masked_pass(K, J, I, itemsize)
    tiles = _k5_holds(K, J, I, dtype, pl, 11)
    assert len({t[2:] for t in tiles}) > 1 and len({t[:2] for t in tiles}) > 1


def test_k5_tile_halo_cli_shape():
    """configs/canal3d_obstacle.par's 128x32x32 field at float64, n = 1:
    the real plan's halo holds (no slab of it holds the ghost plane
    alone)."""
    K, J, I = 128, 32, 32
    pl = sk3.masked_pass(K, J, I, 8)
    _k5_holds(K, J, I, torch.float64, pl, 13, shrunk_fails=False)


def test_k5_field_smaller_than_a_tile():
    """A field smaller than one (j, i) box: one tile across the plane."""
    K, J, I = 10, 12, 16
    pl = sk3.masked_pass(K, J, I, 4)
    tiles = _k5_holds(K, J, I, torch.float32, pl, 17)
    assert {t[2:] for t in tiles} == {(0, J + 2, 0, I + 2)}


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k5_tile_halo_small_boxes(monkeypatch, itemsize, dtype):
    """Small boxes (the threads' rows cut to 16, 20 SMs): many (j, i)
    tiles and k slabs on a small field, the last slab the ghost plane
    alone; halo 3 holds, 2 does not."""
    monkeypatch.setitem(sk3._ROWS5, itemsize, 16)
    K, J, I = 5, 40, 50
    pl = sk3.masked_pass(K, J, I, itemsize, sms=20)
    assert pl.rows < J + 2 and pl.ti < I + 2
    tiles = _k5_holds(K, J, I, dtype, pl, 19)
    assert len({t[2:4] for t in tiles}) > 2


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", [(512, 128, 128), (128, 32, 32),
                                   (40, 300, 90), (10, 12, 16)])
def test_k5_plans_fit(itemsize, shape):
    """The pass plan fits shared memory and the threads' columns and row
    pairs, its pitches hold a box row, and the kernel's geometry array
    holds it."""
    pl = sk3.masked_pass(*shape, itemsize)
    w = min(shape[2] + 2, pl.ti + 2 * sk3.HALO5)
    assert pl.smem <= SMEM_LIMIT
    assert w <= sk3.MTX
    assert pl.rows <= sk3._ROWS5[itemsize]
    assert pl.rows >= min(shape[1] + 2, pl.tj + 2 * sk3.HALO5)
    assert pl.P % 2 == 0 and pl.P >= w and pl.Pf >= w
    geo = list(sk3.masked_geometry(*shape, itemsize))
    assert geo == [n + 2 for n in shape] + [pl.tk, pl.tj, pl.ti, pl.rows,
                                             pl.P, pl.Pf, pl.smem]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_out_form_and_passes(dtype):
    """The `out=` form leaves p untouched and equals the plain version in
    place; the passes of m = 1 chained through two fields equal one call
    of n, field and residual."""
    K, J, I, n = 6, 9, 11, 3
    x, f, fl = _k5_case(K, J, I, dtype, 23)
    coef = (float(I * I), float(J * J), float(K * K))
    keep, out = x.clone(), torch.empty_like(x)
    r = sk3.rb_sor3d_checkerboard(x, f, n, 0.0, *coef, flags=fl,
                                  omega=OMEGA, out=out)
    assert torch.equal(x, keep)
    ref = x.clone()
    rp = sk3.rb_sor3d_masked_plain(ref, f, fl, n, OMEGA, *coef)
    assert torch.equal(out, ref) and torch.equal(r, rp)
    bufs = [x.clone(), torch.empty_like(x)]
    for _ in range(n):
        bufs[1].copy_(bufs[0])
        rr = sk3.rb_sor3d_masked_plain(bufs[1], f, fl, 1, OMEGA, *coef)
        bufs.reverse()
    assert torch.equal(bufs[0], ref) and torch.equal(rr, rp)
    with pytest.raises(ValueError):
        sk3.rb_sor3d_checkerboard(x, f, n, 0.0, *coef, flags=fl, omega=OMEGA,
                                  out=x)
    with pytest.raises(ValueError):
        sk3.rb_sor3d_checkerboard(x, f, n, 0.0, *coef, flags=fl, omega=OMEGA)


# -- K14 ---------------------------------------------------------------------


def _k14_case(ext, dims, n, coords, dtype, seed):
    """(geometry, octant offsets, volume, rhs volume, coefficients) of the
    shard at mesh coordinates `coords` of an ext grid on dims."""
    local = tuple(e // d for e, d in zip(ext, dims))
    g = od.make_ogeom(*ext, *local, n, dims=dims)
    qoffs = tuple(c * e // 2 for c, e in zip(coords, local))
    rng = np.random.default_rng(seed)
    shape = (8, g.kq, g.jq, g.iq)
    coef = sor_coefficients_3d(1 / ext[2], 1 / ext[1], 1 / ext[0], 1.8)
    return (g, qoffs, _rng_field(rng, shape, dtype),
            _rng_field(rng, shape, dtype), coef)


def _k14_run(g, qoffs, coef):
    """One pass (one iteration) of the plain version on g's volume."""
    gm = dataclasses.replace(g, n=1)
    masks = od.o_masks(gm, *qoffs)
    return lambda x, f: od.rb_iters_o(x, f, gm, masks, *coef)


def _k14_holds(ext, dims, n, coords, dtype, itemsize, seed):
    g, qoffs, x, f, coef = _k14_case(ext, dims, n, coords, dtype, seed)
    pl = so.odist_pass(g, itemsize)
    tiles = so.odist_tiles(g, pl)
    assert _covers_once(tiles, x.shape[1:])
    run = _k14_run(g, qoffs, coef)
    some = _some_tiles(tiles)
    assert _tiles_hold(run, (x, f), some, so.HALO14, seed, lead=1) == []
    assert _tiles_hold(run, (x, f), some, so.HALO14 - 1, seed, lead=1,
                       first_bad=True) != []
    return tiles


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k14_tile_halo_real_plan(itemsize, dtype):
    """The real pass on the timed shard's (j, i) plane (a 128³ shard of
    256³ on 2x2x2 at n = 4: 73x73 octant cells a slot) cut to 10 planes
    (20x256x256): several (j, i) tiles and k slabs; the shard at mesh
    coordinates (1, 1, 1) (interfaces below, walls above). Halo 1 holds,
    0 does not."""
    tiles = _k14_holds((20, 256, 256), (2, 2, 2), 4, (1, 1, 1), dtype,
                       itemsize, 29)
    assert len({t[2:] for t in tiles}) > 1 and len({t[:2] for t in tiles}) > 1


def test_k14_tile_halo_cli_shape():
    """configs/dcavity3d.par's 64³ shards on 2x2x2 at float64, n = 1 (the
    shard at the origin: walls below), the real plan."""
    _k14_holds((128, 128, 128), (2, 2, 2), 1, (0, 0, 0), torch.float64, 8,
               31)


def test_k14_volume_smaller_than_a_tile():
    """32³ on 2x2x2 at n = 2 (13³ octant cells a slot): one tile across the
    plane; and a (1, 1, 1) mesh (K6's volume, no frozen ring)."""
    tiles = _k14_holds((32, 32, 32), (2, 2, 2), 2, (1, 0, 1), torch.float32,
                       4, 37)
    assert {t[2:] for t in tiles} == {(0, 13, 0, 13)}
    _k14_holds((16, 12, 20), (1, 1, 1), 2, (0, 0, 0), torch.float64, 8, 41)


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k14_tile_halo_small_boxes(monkeypatch, itemsize, dtype):
    """Small boxes (rows capped at 6, 12 SMs) on a shard with walls on one
    side and interfaces on the other: many (j, i) tiles and k slabs; halo
    1 holds, 0 does not."""
    monkeypatch.setitem(so._ROWS, itemsize, 6)
    g, _q, _x, _f, _c = _k14_case((16, 64, 80), (1, 2, 2), 2, (0, 1, 0),
                                  dtype, 43)
    pl = so.odist_pass(g, itemsize, sms=12)
    assert pl.rows < g.jq and len(so.odist_tiles(g, pl)) > 4
    monkeypatch.setattr(so, "odist_pass",
                        lambda g, itemsize=4, sms=None, _pl=pl: _pl)
    tiles = _k14_holds((16, 64, 80), (1, 2, 2), 2, (0, 1, 0), dtype,
                       itemsize, 43)
    assert len({t[2:4] for t in tiles}) > 2


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ext,dims", [((256,) * 3, (2, 2, 2)),
                                      ((128,) * 3, (2, 2, 2)),
                                      ((32,) * 3, (2, 2, 2)),
                                      ((32, 48, 64), (1, 2, 4))])
def test_k14_plans_fit(itemsize, ext, dims):
    """The pass plan fits shared memory and the threads at n = 1..4 (the
    volume grows with n's deep halo), and the kernel's geometry array
    holds it."""
    local = tuple(e // d for e, d in zip(ext, dims))
    for n in range(1, 5):
        g = od.make_ogeom(*ext, *local, od.odist_clamp(n, *local, dims),
                          dims=dims)
        pl = so.odist_pass(g, itemsize)
        assert pl.smem <= SMEM_LIMIT
        assert pl.rows <= so._ROWS[itemsize]
        assert min(g.iq, pl.ti + 2 * so.HALO14) <= so.TX
        assert min(g.jq, pl.tj + 2 * so.HALO14) <= pl.rows
        ntiles, geo = so.launch_plan(g, itemsize, (0, 0, 0))
        assert ntiles == len(so.odist_tiles(g, pl))
        assert list(geo)[15:] == [pl.tk, pl.tj, pl.ti, pl.rows, pl.smem]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k14_out_form_and_passes(dtype):
    """The `out=` form leaves q untouched; the passes of m = 1 chained
    through two volumes equal one plain call of n; the residual is the
    last pass's."""
    g, qoffs, x, f, coef = _k14_case((32, 32, 32), (2, 2, 2), 3, (0, 1, 1),
                                     dtype, 47)
    keep, out = x.clone(), torch.empty_like(x)
    r = so.rb_sor_odist(x, f, g, qoffs, *coef, out)
    assert torch.equal(x, keep)
    ref, r2 = od.rb_iters_o(x, f, g, od.o_masks(g, *qoffs), *coef)
    assert torch.equal(out, ref)
    pl = so.odist_pass(g, x.element_size())
    assert torch.equal(r, so.odist_residual(r2, g, pl))
    bufs = [x.clone(), torch.empty_like(x)]
    run = _k14_run(g, qoffs, coef)
    for _ in range(g.n):
        new, r2 = run(bufs[0], f)
        bufs[1].copy_(new)
        bufs.reverse()
    assert torch.equal(bufs[0], ref)
    assert torch.equal(so.odist_residual(r2, g, pl), r)
    with pytest.raises(ValueError):
        so.rb_sor_odist(x, f, g, qoffs, *coef, x)


def _tree(v):
    st = len(v) // 2
    while st:
        v = v[:st] + v[st:2 * st]
        st //= 2
    return v[0]


def test_k14_residual_is_the_tile_order():
    """K14's plain residual written out in numpy: per tile (k-major, then
    j, then i), thread (tx, ty) of 32 x 16 adds, step by step of the pass,
    the box cells (ty + 16 kk, tx) of the odd octants 1, 2, 4, 7 on one
    plane, then of the even octants 0, 3, 5, 6 on the plane behind it;
    a halving tree over 32 ty + tx; then thread t of 512 adds partials t,
    t + 512, ... and a halving tree."""
    g, qoffs, x, f, coef = _k14_case((32, 48, 64), (1, 2, 4), 2, (0, 1, 2),
                                     torch.float64, 53)
    _new, r2 = od.rb_iters_o(x, f, g, od.o_masks(g, *qoffs), *coef)
    pl = so.odist_pass(g, 8)
    r2n = r2.numpy()
    parts = []
    for t in so.odist_tiles(g, pl):
        lo = [max(0, a - so.HALO14) for a in t[::2]]
        hi = [min(n, b + so.HALO14)
              for b, n in zip(t[1::2], (g.kq, g.jq, g.iq))]
        own = np.zeros(r2n.shape, bool)
        own[:, t[0]:t[1], t[2]:t[3], t[4]:t[5]] = True
        acc = np.zeros(512)
        for z in range(hi[0] - lo[0] + 1):
            for plane, slots in ((z, (1, 2, 4, 7)), (z - 1, (0, 3, 5, 6))):
                if not 0 <= plane < hi[0] - lo[0]:
                    continue
                for o in slots:
                    for a in range(hi[1] - lo[1]):
                        for b in range(hi[2] - lo[2]):
                            cell = (o, lo[0] + plane, lo[1] + a, lo[2] + b)
                            if own[cell]:
                                acc[32 * (a % 16) + b] += r2n[cell]
        parts.append(_tree(acc))
    acc = np.zeros(512)
    for k, v in enumerate(parts):
        acc[k % 512] += v
    assert float(so.odist_residual(r2, g, pl)) == _tree(acc)
