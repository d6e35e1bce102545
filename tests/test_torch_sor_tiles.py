"""The tile plans of kernels K13 (ops/sor_qdist.py) and masked K2
(ops/sor_kernels.py, the tiled template it shares with K15) on the CPU,
where the kernels' plain versions run.

Each CTA of K13 and masked K2 holds one owned tile of the plane (K13: the
same cells of the four quarter slots) or of the field, and a halo of ht
cells a side, clipped to it, and runs all n iterations of a call there.
The halo is enough when the tile's owned cells and owned r² do not depend
on anything outside that box. So, for every tile of a plan: replace p and
rhs (and the flags) outside the box with other finite random values, run
the unchanged plain loop, and require the tile's owned cells and owned r²
bitwise those of the unmodified run; and with the halo one smaller,
require that some tile differs (K13 takes n, masked K2 2n + 1). For K13,
whose quarter stencil reaches one side per axis, each box is also run as
a plane of its own under the kernel's update rule (a box cell updates
where its stencil stays in the box) and held bitwise to the plain
version.

Cases: n = 1..4 with small boxes, so that tiles cut every slot; the real
plans at float32 and float64 on the timed shapes cut down to a few tiles
(4096² on 2x2 for K13, canal_obstacle's box at 8192x2048 for masked K2);
the CLI's shapes (configs/dcavity.par's 50² shards on 2x2 for K13, one
tile; configs/canal_obstacle.par's 512x128 and canal_obstacle2048.par's
2048x512 for masked K2, at float64, n = 1), and a field smaller than one
tile. The tiles partition the plane or field; every plan fits shared
memory at n = 1..4; the `out=` form (the wrappers' only one) leaves the
input untouched and equals the plain iterations bitwise; and the plain
residual is the per-tile partials summed in CTA order (written out here
in numpy)."""

import numpy as np
import pytest
import torch

from pampi_tpu_torch.ops import obstacle as obst
from pampi_tpu_torch.ops import sor_kernels as sk
from pampi_tpu_torch.ops import sor_obsdist as sod
from pampi_tpu_torch.ops import sor_qdist as sq
from pampi_tpu_torch.parallel import quarters_dist as qd

OMEGA = 1.7


def _box(tile, ht, shape):
    """The CTA's box of `tile` (j0, j1, i0, i1) over the last two axes of
    `shape`, clipped; leading axes (K13's slots) whole."""
    lead = tuple(slice(None) for _ in shape[:-2])
    return lead + tuple(slice(max(0, lo - ht), min(n, hi + ht))
                        for lo, hi, n in zip(tile[::2], tile[1::2],
                                             shape[-2:]))


def _own(tile, shape):
    lead = tuple(slice(None) for _ in shape[:-2])
    return lead + (slice(tile[0], tile[1]), slice(tile[2], tile[3]))


def _tiles_hold(run, fields, tiles, ht, seed):
    """For every tile: the fields outside its haloed box replaced (flags,
    the third field where given, by random 0/1), the tile's owned cells and
    owned r² compared with those of the unmodified run. Returns the tiles
    that differ."""
    ref_x, ref_r2 = run(*fields)
    rng = np.random.default_rng(seed)
    shape = tuple(fields[0].shape)
    bad = []
    for tile in tiles:
        inside = torch.zeros(shape[-2:], dtype=torch.bool)
        inside[_box(tile, ht, shape)[-2:]] = True
        swapped = []
        for k, x in enumerate(fields):
            other = (torch.from_numpy(rng.integers(0, 2, size=x.shape,
                                                   dtype=np.uint8))
                     if k == 2 else
                     torch.from_numpy(rng.normal(size=x.shape)).to(x.dtype))
            swapped.append(torch.where(inside, x, other))
        x, r2 = run(*swapped)
        own = _own(tile, shape)
        if not (torch.equal(x[own], ref_x[own])
                and torch.equal(r2[own], ref_r2[own])):
            bad.append(tile)
    return bad


def _covers_once(tiles, shape):
    count = torch.zeros(shape, dtype=torch.int32)
    for j0, j1, i0, i1 in tiles:
        count[j0:j1, i0:i1] += 1
    return bool((count == 1).all())


def _tile_order_sum(r2, th, tw):
    """The kernels' residual written out in numpy: per tile (row-major),
    thread (tx, ty) of 32 x 16 adds the tile's cells (ty + 16 k, tx + 32
    m), slot by slot, k-major, and a halving tree over 32 ty + tx sums the
    threads; then thread t of 512 adds partials t, t + 512, ... and a
    halving tree."""
    def tree(v):
        st = len(v) // 2
        while st:
            v = v[:st] + v[st:2 * st]
            st //= 2
        return v[0]

    r2 = np.asarray(r2)
    r2 = r2.reshape((-1,) + r2.shape[-2:])
    ej, ei = r2.shape[-2:]
    parts = []
    for j0 in range(0, ej, th):
        for i0 in range(0, ei, tw):
            acc = np.zeros(512)
            for s in range(r2.shape[0]):
                for j in range(j0, min(j0 + th, ej)):
                    for i in range(i0, min(i0 + tw, ei)):
                        acc[32 * ((j - j0) % 16) + (i - i0) % 32] += r2[s, j, i]
            parts.append(tree(acc))
    acc = np.zeros(512)
    for k, v in enumerate(parts):
        acc[k % 512] += v
    return tree(acc)


# -- K13 ---------------------------------------------------------------------


def _qcase(jmax, imax, dims, n, dtype, seed):
    """(geometry, [(quarter offsets, planes, rhs planes) per shard],
    (factor, idx2, idy2)) of a jmax x imax grid on a dims mesh."""
    jl, il = jmax // dims[0], imax // dims[1]
    g = qd.make_qgeom(jmax, imax, jl, il, n)
    rng = np.random.default_rng(seed)
    shards = []
    for cj in range(dims[0]):
        for ci in range(dims[1]):
            x, f = (torch.from_numpy(rng.normal(size=(4, g.jq, g.iq)))
                    .to(dtype) for _ in range(2))
            shards.append(((cj * jl // 2, ci * il // 2), x, f))
    return g, shards, sk.sor_coefficients(1.0 / imax, 1.0 / jmax, 1.9)


def _qrun(g, qoffs, coef):
    m = qd.q_masks(g, *qoffs)
    return lambda x, f: qd.rb_sweeps_q(x, f, g, m, *coef)


def test_k13_sweeps_are_the_plain_version():
    """rb_sweeps_q's planes and per-cell r² give the plain version's
    planes and residual (the tile order) bitwise."""
    g, shards, coef = _qcase(64, 48, (2, 2), 3, torch.float64, 1)
    for qoffs, x, f in shards:
        new, r2 = _qrun(g, qoffs, coef)(x, f)
        xp = torch.empty_like(x)
        r = sq.rb_sor_qdist(x, f, g, qoffs, *coef, out=xp)
        pl = sq.qdist_passes(g, 8)[-1]
        assert torch.equal(new, xp)
        assert torch.equal(sk.tiled_residual(r2, pl.th, pl.tw), r)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k13_tile_halo_small_tiles(monkeypatch, n):
    """Boxes of 3x5 owned quarter cells plus the halo on every shard of
    48x40 on 2x2: the halo n holds every tile, n - 1 does not."""
    monkeypatch.setattr(sq, "_BOX", {8: (2 * n + 3, 2 * n + 5)})
    monkeypatch.setattr(sq, "_MIN_TILE", (1, 1))
    g, shards, coef = _qcase(48, 40, (2, 2), n, torch.float64, 10 + n)
    (pl,) = sq.qdist_passes(g, 8)
    assert pl.ht == n and (pl.th, pl.tw) == (3, 5)
    tiles = sq.qdist_tiles(g, 8)
    assert len(tiles) > 8 and _covers_once(tiles, (g.jq, g.iq))
    for k, (qoffs, x, f) in enumerate(shards):
        run = _qrun(g, qoffs, coef)
        assert _tiles_hold(run, (x, f), tiles, n, 20 + k) == []
        assert _tiles_hold(run, (x, f), tiles, n - 1, 20 + k) != []


def _emulate_k13(x, f, g, qoffs, coef, tiles, ht):
    """K13's tiling on the CPU: each tile's box (clipped) run as a plane of
    its own through rb_sweeps_q, a cell of the box updating where the
    plane's update mask holds and its one-sided stencil stays in the box
    (even rows read the row below, odd rows the row above; even columns
    the column left, odd ones right), the wall selects everywhere; the
    tile's cells and r² kept. Returns (planes, r²)."""
    m = qd.q_masks(g, *qoffs)
    out, r2 = torch.empty_like(x), torch.empty_like(x)
    for tile in tiles:
        box = _box(tile, ht, tuple(x.shape))[-2:]
        R, W = (sl.stop - sl.start for sl in box)
        a = torch.arange(R)[:, None]
        b = torch.arange(W)[None, :]
        mb = {k: v[box] for k, v in m.items() if k not in ("upd", "own")}
        mb["own"] = [o[box] for o in m["own"]]
        mb["upd"] = [u[box] & (a >= 1 if pr == 0 else a <= R - 2)
                     & (b >= 1 if pc == 0 else b <= W - 2)
                     for u, (pr, pc) in zip(m["upd"], qd.SLOT_PARITY)]
        new, rr = qd.rb_sweeps_q(x[(slice(None),) + box],
                                 f[(slice(None),) + box], g, mb, *coef)
        own = _own(tile, tuple(x.shape))
        inner = (slice(None), slice(tile[0] - box[0].start,
                                    tile[1] - box[0].start),
                 slice(tile[2] - box[1].start, tile[3] - box[1].start))
        out[own], r2[own] = new[inner], rr[inner]
    return out, r2


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k13_box_emulation(monkeypatch, n):
    """Each box run as a plane of its own under K13's update rule gives
    the plain version's planes and per-cell r² bitwise with the halo n,
    on every shard of 48x40 on 2x2 with boxes of 3x5 owned cells; with
    n - 1 it does not."""
    monkeypatch.setattr(sq, "_BOX", {8: (2 * n + 3, 2 * n + 5)})
    monkeypatch.setattr(sq, "_MIN_TILE", (1, 1))
    g, shards, coef = _qcase(48, 40, (2, 2), n, torch.float64, 15 + n)
    tiles = sq.qdist_tiles(g, 8)
    wrong = 0
    for qoffs, x, f in shards:
        ref = _qrun(g, qoffs, coef)(x, f)
        got = _emulate_k13(x, f, g, qoffs, coef, tiles, n)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        short = _emulate_k13(x, f, g, qoffs, coef, tiles, n - 1)
        wrong += not torch.equal(short[0], ref[0])
    assert wrong == len(shards)


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k13_tile_halo_real_plan(itemsize, dtype):
    """The shipped plans (48x64 boxes at float32, 48x32 at float64) at
    n = 4, the 4096² 2x2 case cut to 400x272 on 2x2 (109x77 planes,
    several tiles a plane): the halo n holds, n - 1 does not."""
    g, shards, coef = _qcase(400, 272, (2, 2), 4, dtype, 31)
    tiles = sq.qdist_tiles(g, itemsize)
    assert len(tiles) >= 4 and _covers_once(tiles, (g.jq, g.iq))
    (pl,) = sq.qdist_passes(g, itemsize)
    assert pl.ht == g.n
    for k, (qoffs, x, f) in enumerate(shards[::3]):
        run = _qrun(g, qoffs, coef)
        assert _tiles_hold(run, (x, f), tiles, pl.ht, 41 + k) == []
        assert _tiles_hold(run, (x, f), tiles, pl.ht - 1, 41 + k) != []
        got = _emulate_k13(x, f, g, qoffs, coef, tiles, pl.ht)
        ref = run(x, f)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_k13_cli_shard_is_one_tile():
    """configs/dcavity.par's 50² shards on 2x2 (f64, n = 1; 28² planes):
    one tile, the whole plane, at either dtype."""
    g, shards, coef = _qcase(100, 100, (2, 2), 1, torch.float64, 51)
    assert (g.jq, g.iq) == (28, 28)
    for itemsize in (4, 8):
        assert sq.qdist_tiles(g, itemsize) == [(0, 28, 0, 28)]
        assert len(sq.launch_plan(g, itemsize, 0, 0)) == 1
    qoffs, x, f = shards[3]
    assert _tiles_hold(_qrun(g, qoffs, coef), (x, f),
                       sq.qdist_tiles(g, 8), 1, 53) == []
    got = _emulate_k13(x, f, g, qoffs, coef, sq.qdist_tiles(g, 8), 1)
    ref = _qrun(g, qoffs, coef)(x, f)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k13_launch_plans_fit(itemsize, n):
    """One launch a call at n = 1..4 on the timed shard (2048² of 4096² on
    2x2) and the CLI's; the box fits shared memory; a call of n in the
    tens splits into passes that add up to n, each fitting."""
    for g in (qd.make_qgeom(4096, 4096, 2048, 2048, n),
              qd.make_qgeom(100, 100, 50, 50, n)):
        (pl,) = sq.qdist_passes(g, itemsize)
        assert pl.iters == n and pl.smem <= sod.SMEM_LIMIT
        assert pl.rows <= sq._BOX[itemsize][0] and pl.P % 2 == 0
    g = qd.make_qgeom(4096, 4096, 2048, 2048, 40)
    passes = sq.qdist_passes(g, itemsize)
    assert len(passes) > 1 and sum(p.iters for p in passes) == 40
    assert all(p.smem <= sod.SMEM_LIMIT for p in passes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k13_out_form(dtype):
    """rb_sor_qdist(..., out=) on the CPU: q untouched, out and the
    residual bitwise the plain iterations' (planes, and r² in the tile
    order); out must not be q."""
    g, shards, coef = _qcase(48, 40, (2, 2), 2, dtype, 61)
    (pl,) = sq.qdist_passes(g, torch.finfo(dtype).bits // 8)
    for qoffs, x, f in shards:
        keep = x.clone()
        out = torch.full_like(x, float("nan"))
        r_out = sq.rb_sor_qdist(x, f, g, qoffs, *coef, out=out)
        new, r2 = _qrun(g, qoffs, coef)(x, f)
        assert torch.equal(x, keep)
        assert torch.equal(out, new)
        assert torch.equal(r_out, sk.tiled_residual(r2, pl.th, pl.tw))
    with pytest.raises(ValueError):
        sq.rb_sor_qdist(x, f, g, qoffs, *coef, out=x)


def test_k13_residual_is_the_tile_order(monkeypatch):
    """The plain residual equals the per-tile partials summed in CTA
    order, written out in numpy, on a plane of several tiles (small
    boxes, so the tiles' nominal extents overhang the plane)."""
    monkeypatch.setattr(sq, "_BOX", {8: (14, 18)})
    g, shards, coef = _qcase(64, 48, (2, 2), 2, torch.float64, 71)
    pl = sq.qdist_pass_plan(g, 2, 8)
    assert len(sq.qdist_tiles(g, 8)) >= 6 and g.jq % pl.th and g.iq % pl.tw
    qoffs, x, f = shards[1]
    _, r2 = _qrun(g, qoffs, coef)(x, f)
    r = sq.rb_sor_qdist(x, f, g, qoffs, *coef, out=torch.empty_like(x))
    assert float(r) == float(_tile_order_sum(r2, pl.th, pl.tw)) > 0


# -- masked K2 ---------------------------------------------------------------


def _kcase(jmax, imax, dtype, seed, box="0.3,0.3,0.6,0.7"):
    """(p, rhs, flags, (idx2, idy2)) of a jmax x imax field on a 1x1 box
    of side lengths (imax/jmax, 1) with an obstacle crossing tile edges."""
    dx, dy = 1.0 / jmax, 1.0 / jmax
    m = obst.make_masks(obst.build_fluid(imax, jmax, dx, dy, box), dx, dy,
                        OMEGA)
    rng = np.random.default_rng(seed)
    p, rhs = (torch.from_numpy(rng.normal(size=(jmax + 2, imax + 2)))
              .to(dtype) for _ in range(2))
    return p, rhs, m.flags(), (1.0 / (dx * dx), 1.0 / (dy * dy))


def _krun(n, coef):
    def run(p, rhs, flags):
        x = p.clone()
        return x, sk.masked_sweeps(x, rhs, flags, n, OMEGA, *coef)
    return run


def _ktiles(p, n, itemsize):
    g = sk.masked_geom(p.shape[0] - 2, p.shape[1] - 2, n)
    (pl,) = sod.obsdist_passes(g, itemsize)
    return sod.obsdist_tiles(g, itemsize), pl


def test_k2_sweeps_are_the_plain_version():
    p, rhs, fl, coef = _kcase(40, 48, torch.float64, 1)
    x, r2 = _krun(3, coef)(p, rhs, fl)
    xp = p.clone()
    r = sk.rb_sor_masked_plain(xp, rhs, fl, 3, OMEGA, *coef)
    (_, pl) = _ktiles(p, 3, 8)
    assert torch.equal(x, xp)
    assert torch.equal(sk.tiled_residual(r2, pl.th, pl.tw), r)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k2_tile_halo_small_tiles(monkeypatch, n):
    """Boxes of 6x5 owned cells plus the halo on a 17x23 field with the
    obstacle: the last tile row and column start on the wall-ghost row
    J + 1 and column I + 1, whose cells copy their inward neighbour from
    the halo. The halo 2n + 1 holds every tile, 2n does not."""
    H = 2 * n + 1
    monkeypatch.setattr(sod, "_BOX", {8: (2 * H + 6, 2 * H + 5)})
    monkeypatch.setattr(sod, "_MIN_TILE", (1, 1))
    p, rhs, fl, coef = _kcase(17, 23, torch.float64, 80 + n)
    tiles, pl = _ktiles(p, n, 8)
    assert (pl.ht, pl.th, pl.tw) == (H, 6, 5)
    assert {t[0] for t in tiles} >= {18} and {t[2] for t in tiles} >= {20}
    assert _covers_once(tiles, tuple(p.shape))
    run = _krun(n, coef)
    assert _tiles_hold(run, (p, rhs, fl), tiles, H, 90 + n) == []
    assert _tiles_hold(run, (p, rhs, fl), tiles, H - 1, 90 + n) != []


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k2_tile_halo_real_plan(itemsize, dtype):
    """The shipped plans (96x128 boxes at float32, 64x96 at float64) at
    n = 4 on canal_obstacle's box cut to 300x200 (several tiles)."""
    p, rhs, fl, coef = _kcase(200, 300, dtype, 101, "1.0,0.3,1.25,0.7")
    tiles, pl = _ktiles(p, 4, itemsize)
    assert len(tiles) >= 4 and _covers_once(tiles, tuple(p.shape))
    assert pl.ht == 9
    run = _krun(4, coef)
    assert _tiles_hold(run, (p, rhs, fl), tiles, pl.ht, 103) == []


@pytest.mark.parametrize("jmax,imax", [(128, 512), (512, 2048)])
def test_k2_tile_halo_cli_shapes(jmax, imax):
    """configs/canal_obstacle.par (512x128) and canal_obstacle2048.par
    (2048x512) at float64, n = 1 (the CLI's cadence): every tile of the
    plan holds with the halo 3."""
    p, rhs, fl, coef = _kcase(jmax, imax, torch.float64, 111,
                              f"{imax / jmax * 0.25},0.4,"
                              f"{imax / jmax * 0.3},0.6")
    tiles, pl = _ktiles(p, 1, 8)
    assert pl.ht == 3 and len(tiles) > 4
    assert _covers_once(tiles, tuple(p.shape))
    assert _tiles_hold(_krun(1, coef), (p, rhs, fl), tiles, 3, 113) == []


def test_k2_field_smaller_than_a_tile():
    p, rhs, fl, coef = _kcase(40, 48, torch.float64, 121)
    for itemsize in (4, 8):
        tiles, _ = _ktiles(p, 1, itemsize)
        assert tiles == [(0, 42, 0, 50)]
    assert _tiles_hold(_krun(1, coef), (p, rhs, fl), tiles, 3, 123) == []


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k2_launch_plans_fit(itemsize, n):
    """One launch a call at n = 1..4 at 8192x2048 and the CLI shapes; every
    box fits shared memory."""
    for J, I in ((2048, 8192), (128, 512), (512, 2048)):
        (pl,) = sod.obsdist_passes(sk.masked_geom(J, I, n), itemsize)
        assert pl.n == n and pl.ht == 2 * n + 1
        assert pl.smem <= sod.SMEM_LIMIT and pl.P % 2 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_out_form(dtype):
    """rb_sor_checkerboard(..., flags=, out=) on the CPU: p untouched, out
    and the residual bitwise the plain version's (in place on a copy); the
    masked mode needs out, out must not be p; the unmasked mode's out=
    form leaves p untouched and writes the in-place call's field."""
    p, rhs, fl, coef = _kcase(40, 48, dtype, 131)
    keep, inplace = p.clone(), p.clone()
    out = torch.full_like(p, float("nan"))
    r_out = sk.rb_sor_checkerboard(p, rhs, 2, 0.0, *coef, flags=fl,
                                   omega=OMEGA, out=out)
    r_in = sk.rb_sor_masked_plain(inplace, rhs, fl, 2, OMEGA, *coef)
    assert torch.equal(p, keep)
    assert torch.equal(out, inplace) and torch.equal(r_out, r_in)
    with pytest.raises(ValueError):
        sk.rb_sor_checkerboard(p, rhs, 2, 0.0, *coef, flags=fl, omega=OMEGA)
    with pytest.raises(ValueError):
        sk.rb_sor_checkerboard(p, rhs, 2, 0.0, *coef, flags=fl, omega=OMEGA,
                               out=p)
    plain = p.clone()
    r_plain = sk.rb_sor_checkerboard(p, rhs, 2, 0.1, *coef, out=out)
    r_in = sk.rb_sor_checkerboard(plain, rhs, 2, 0.1, *coef)
    assert torch.equal(p, keep) and torch.equal(out, plain)
    assert torch.equal(r_plain, r_in)


def test_k2_residual_is_the_tile_order(monkeypatch):
    """The plain residual equals the per-tile partials summed in CTA
    order, written out in numpy, on a field of several tiles."""
    monkeypatch.setattr(sod, "_BOX", {8: (20, 26)})
    p, rhs, fl, coef = _kcase(40, 48, torch.float64, 141)
    tiles, pl = _ktiles(p, 2, 8)
    assert len(tiles) >= 6
    _, r2 = _krun(2, coef)(p, rhs, fl)
    r = sk.rb_sor_masked_plain(p.clone(), rhs, fl, 2, OMEGA, *coef)
    assert float(r) == float(_tile_order_sum(r2, pl.th, pl.tw)) > 0
