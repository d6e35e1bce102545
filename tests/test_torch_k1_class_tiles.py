"""The one-pass designs of kernel K1 (the single-device quarter plane) and
of K2's class mode (the fleet's sor class lanes), ops/sor_kernels.py, on
the CPU, where their plain versions run.

Each kernel's CTA is written out here in numpy, cell for cell as
csrc/sor_rb.cu runs it, and held bitwise against the plain version,
fields and residual:

- K1 (q_tiled): a tile's box of rows x columns quarter cells from the
  tile's corner less the halo, its cells off the plane 0; each half-sweep
  updates a cell where it lies in its slot's global interior and its
  one-sided stencil stays in the box (in a box inside the plane's inner
  cells every cell, the box's edge from clamped neighbours); the eight
  same-index wall selects
  after black; the tile's cells go out; each thread (a column of the box,
  QK rows of it) adds its owned r² in its update order, a halving tree
  over the threads, the tiles' partials in tile order. With the halo n the
  emulation is the plain version bit for bit; with n - 1 it is not.
- K2's class mode (cls_tiled): each lane's tiles from its block's corner,
  the box the tile and a halo of 2n + 1 clipped to the lane's live corner,
  the colour sweeps off the box's ring, the wall ring at the lane's
  extents; a tile past the live corner, and every tile of a lane that is
  not solving, copied; the residual per tile in (ty + 16 k, tx + 32 m)
  order and then over the lane's own tile grid. With the halo 2n + 1 it
  is the plain version bit for bit; with 2n it is not.

Small boxes (monkeypatched) make several tiles a plane or lane. Besides:
the plans (passes, shared memory), the `out=` forms, the residual orders
against a float64 sum, a lane bitwise across two rungs, and
configs/poisson.par through the port's CLI at 2388 iterations."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pampi_tpu_torch.ops import sor_kernels as sk
from pampi_tpu_torch.ops.sor_quarters import rb_sweeps_quarters_rs, stack_quarters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(v):
    h = v.shape[-1] // 2
    while h:
        v = v[..., :h] + v[..., h:2 * h]
        h //= 2
    return v[..., 0]


def _ordered(parts, threads):
    acc = np.zeros(threads, dtype=parts.dtype)
    for k in range(0, len(parts), threads):
        chunk = parts[k:k + threads]
        acc[:len(chunk)] = acc[:len(chunk)] + chunk
    return _tree(acc)


@pytest.fixture
def plans(monkeypatch):
    """Patch the kernels' box tables; the plan caches are cleared before
    and after."""
    def clear():
        for fn in (sk.quarters_passes, sk.quarters_launch_plan,
                   sk.class_passes, sk.class_launch_plan):
            fn.cache_clear()

    def patch(k1=None, box=None):
        clear()
        if k1 is not None:
            monkeypatch.setattr(sk, "K1_CTA", k1)
        if box is not None:
            monkeypatch.setattr(sk, "CLASS_BOX", box)
            monkeypatch.setattr(sk, "_CLASS_MIN_TILE", 8)
    yield patch
    monkeypatch.undo()
    clear()


# -- K1 ---------------------------------------------------------------------


def _inside(parity, gq, max2):
    return ((gq >= 1) & (gq <= max2) if parity == 0
            else (gq >= 0) & (gq <= max2 - 1))


def _emulate_k1(q, f, n, coef, cta, ht):
    """q_tiled on the CPU (numpy): the plane after n iterations, the
    residual in the kernel's order and the count of boxes inside the
    plane's inner cells, with tiles of the box less a halo of ht."""
    qw, qs, qk = cta
    rows = qs * qk
    th, tw = rows - 2 * ht, qw - 2 * ht
    dt = q.dtype
    fac, idx2, idy2 = (dt.type(c) for c in coef)
    _, j2, i2 = q.shape
    jmax2, imax2 = j2 - 1, i2 - 1
    a = np.arange(rows)[:, None]
    b = np.arange(qw)[None, :]
    out = np.full_like(q, np.nan)
    parts = []
    inner = 0

    def sh(x, da, db):  # x at (a + da, b + db), clamped to the box
        pad = np.pad(x, 1, mode="edge")
        return pad[1 + da:1 + da + x.shape[0], 1 + db:1 + db + x.shape[1]]

    def resid(c, rhs, w, e, s, nn):
        return rhs - ((e - 2 * c + w) * idx2 + (nn - 2 * c + s) * idy2)

    for by in range(-(-j2 // th)):
        for bx in range(-(-i2 // tw)):
            gr, gc = by * th - ht + a, bx * tw - ht + b
            plane = (gr >= 0) & (gr < j2) & (gc >= 0) & (gc < i2)
            grc, gcc = np.clip(gr, 0, j2 - 1), np.clip(gc, 0, i2 - 1)
            P = np.where(plane, q[:, grc, gcc], dt.type(0))
            F = np.where(plane, f[:, grc, gcc], dt.type(0))
            ok0 = _inside(0, gr, jmax2) & (a >= 1)
            ok1 = _inside(1, gr, jmax2) & (a <= rows - 2)
            c0 = _inside(0, gc, imax2) & (b >= 1)
            c1 = _inside(1, gc, imax2) & (b <= qw - 2)
            upd = (ok0 & c0, ok1 & c1, ok0 & c1, ok1 & c0)
            if (by * th - ht >= 1 and by * th - ht + rows <= jmax2
                    and bx * tw - ht >= 1 and bx * tw - ht + qw <= imax2):
                # a box inside the plane's inner cells: every cell updates
                upd = (np.ones_like(ok0 & c0),) * 4
                inner += 1
            own = ((a >= ht) & (a < ht + th) & (gr < j2)
                   & (b >= ht) & (b < ht + tw) & (gc < i2))
            ci0, ci1 = _inside(0, gc, imax2), _inside(1, gc, imax2)
            ri0, ri1 = _inside(0, gr, jmax2), _inside(1, gr, jmax2)
            rs = None
            for _ in range(n):
                R0, R1, B0, B1 = P
                r0 = resid(R0, F[0], sh(B0, 0, -1), B0, sh(B1, -1, 0), B1)
                r1 = resid(R1, F[1], B1, sh(B1, 0, 1), B0, sh(B0, 1, 0))
                P[0] = np.where(upd[0], R0 - fac * r0, R0)
                P[1] = np.where(upd[1], R1 - fac * r1, R1)
                R0, R1 = P[0], P[1]
                b0 = resid(B0, F[2], R0, sh(R0, 0, 1), sh(R1, -1, 0), R1)
                b1 = resid(B1, F[3], sh(R1, 0, -1), R1, R0, sh(R0, 1, 0))
                P[2] = np.where(upd[2], B0 - fac * b0, B0)
                P[3] = np.where(upd[3], B1 - fac * b1, B1)
                rs = (r0, r1, b0, b1)
                for cond, dst, src in (
                        ((gr == 0) & ci0, 0, 3), ((gr == 0) & ci1, 2, 1),
                        ((gr == jmax2) & ci1, 1, 2),
                        ((gr == jmax2) & ci0, 3, 0),
                        ((gc == 0) & ri0, 0, 2), ((gc == 0) & ri1, 3, 1),
                        ((gc == imax2) & ri0, 2, 0),
                        ((gc == imax2) & ri1, 1, 3)):
                    P[dst] = np.where(cond, P[src], P[dst])
            r2 = [np.where(u & own, r * r, dt.type(0)) for u, r in
                  zip(upd, rs)]
            acc = np.zeros((qs, qw), dtype=dt)
            for slots in ((0, 1), (2, 3)):
                for k in range(qk):
                    for s in slots:
                        acc = acc + r2[s].reshape(qs, qk, qw)[:, k]
            parts.append(_tree(acc.reshape(-1)))
            rows_o = gr[own.any(axis=1), 0]
            cols_o = gc[0, own.any(axis=0)]
            out[:, rows_o[0]:rows_o[-1] + 1, cols_o[0]:cols_o[-1] + 1] = (
                P[:, own.any(axis=1)][:, :, own.any(axis=0)])
    return out, _ordered(np.array(parts, dtype=dt), qw * qs), inner


def _k1_case(jmax, imax, dtype, seed):
    rng = np.random.default_rng(seed)
    p, rhs = (torch.from_numpy(rng.normal(size=(jmax + 2, imax + 2)))
              .to(dtype) for _ in range(2))
    return (stack_quarters(p), stack_quarters(rhs),
            sk.sor_coefficients(1.0 / imax, 1.0 / jmax, 1.9))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_box_emulation_halo(plans, n, dtype):
    """Boxes of 16 rows (4 segments of 4) by 32 columns on a 70x190 grid
    (36x96 quarter planes, 12 to 48 tiles, some of them inner): with the
    halo n the emulated kernel is the plain version bitwise, planes and
    residual; with n - 1 its planes differ."""
    cta = (32, 4, 4)
    plans(k1={4: cta, 8: cta})
    q, f, coef = _k1_case(70, 190, dtype, 100 + n)
    (pl,) = sk.quarters_passes(n, q.element_size())
    assert (pl.iters, pl.th, pl.tw) == (n, 16 - 2 * n, 32 - 2 * n)
    qp = q.clone()
    rp = sk.rb_sor_quarters_plain(qp, f, n, *coef)
    got, res, inner = _emulate_k1(q.numpy(), f.numpy(), n, coef, cta, n)
    assert inner > 0 and np.array_equal(got, qp.numpy())
    assert res == rp.item() and res.dtype == q.numpy().dtype
    short, _, _ = _emulate_k1(q.numpy(), f.numpy(), n, coef, cta, n - 1)
    assert not np.array_equal(short, qp.numpy())


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k1_box_emulation_real_plan(itemsize, dtype):
    """The shipped CTA (64 columns; 4 segments of 8 rows at float32, of 4
    rows at float64) at n = 4, on a plane of several tiles, some inner
    (258x386 grid): the emulation is the plain version bitwise."""
    cta = sk.K1_CTA[itemsize]
    q, f, coef = _k1_case(256, 384, dtype, 7)
    (pl,) = sk.quarters_passes(4, itemsize)
    assert -(-q.shape[1] // pl.th) * -(-q.shape[2] // pl.tw) >= 4
    qp = q.clone()
    rp = sk.rb_sor_quarters_plain(qp, f, 4, *coef)
    got, res, inner = _emulate_k1(q.numpy(), f.numpy(), 4, coef, cta, 4)
    assert inner > 0
    assert np.array_equal(got, qp.numpy()) and res == rp.item()


@pytest.mark.parametrize("itemsize", [4, 8])
def test_k1_plans(itemsize):
    """One pass where the tile keeps half the box each way, passes of
    near-equal length past it; every pass's boxes fit shared memory; the
    100² CLI plane at n = 1 takes a few tiles."""
    qw, qs, qk = sk.K1_CTA[itemsize]
    deepest = min(qs * qk, qw) // 4
    for n in range(1, 3 * deepest + 1):
        passes = sk.quarters_passes(n, itemsize)
        assert sum(p.iters for p in passes) == n
        assert len(passes) == -(-n // deepest)
        for (ntiles, geo), pl in zip(
                sk.quarters_launch_plan(513, 257, n, itemsize), passes):
            assert geo[7] == 4 * qs * qk * qw * itemsize <= 227 * 1024
            assert ntiles == -(-513 // pl.th) * -(-257 // pl.tw)
    assert len(sk.quarters_launch_plan(51, 51, 1, itemsize)) == 1
    assert sk.quarters_launch_plan(51, 51, 1, itemsize)[0][0] <= 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_out_form_and_deep_call(dtype):
    """`out=` leaves q untouched and equals the in-place form bitwise; a
    call deeper than one pass iterates the same and sums its residual over
    the last pass's tiles."""
    q, f, coef = _k1_case(62, 46, dtype, 11)
    n = 3 * min(sk.K1_CTA[q.element_size()][1:]) + 1
    assert len(sk.quarters_passes(n, q.element_size())) > 1
    keep, out = q.clone(), torch.empty_like(q)
    r_out = sk.rb_sor_quarters(q, f, n, *coef, out=out)
    assert torch.equal(q, keep)
    r_in = sk.rb_sor_quarters(q, f, n, *coef)
    assert torch.equal(q, out) and torch.equal(r_in, r_out)
    assert r_out.dtype == dtype and r_out.dim() == 0


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
def test_k1_residual_order_against_a_float64_sum(dtype, rtol):
    """The kernel's order (tiles, threads, rows) sums the same r² as a
    float64 numpy sum, within the rounding of that many adds in the
    dtype (rtol 1e-5 at float32, 1e-13 at float64), on the 4096² plane's
    tile shape cut to 1026x770."""
    q, f, coef = _k1_case(1024, 768, dtype, 21)
    rs = rb_sweeps_quarters_rs(q, f, 4, *coef)
    got = sk.quarters_residual(rs, sk.quarters_passes(4, q.element_size())[-1])
    ref = sum(float(np.sum(r.numpy().astype(np.float64) ** 2)) for r in rs)
    assert abs(float(got) - ref) <= rtol * ref


def test_poisson_par_through_the_cli_at_2388(tmp_path):
    """configs/poisson.par through `python -m pampi_tpu_torch --device cpu`
    (float64, K1's plain version at n = 1 with the kernel's residual
    order): 2388 iterations, as the reference."""
    proc = subprocess.run(
        [sys.executable, "-m", "pampi_tpu_torch", "--device", "cpu",
         os.path.join(ROOT, "configs", "poisson.par")],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert "2388 " in proc.stdout.split("Walltime")[0]
    assert (tmp_path / "p.dat").exists()


# -- K2's class mode ---------------------------------------------------------


def _emulate_class(p, rhs, n, ext, geo, solving, box, ht):
    """cls_tiled on the CPU (numpy): the blocks after n iterations and each
    lane's residual, with tiles of side box - 2(2n + 1) and boxes of a halo
    of ht clipped to the lane's live corner."""
    dt = p.dtype
    N, ej, ei = p.shape
    t = box - 2 * (2 * n + 1)
    out = p.copy()
    res = np.zeros(N, dtype=dt)
    for lane in range(N):
        J, I = (int(x) for x in ext[lane])
        if not solving[lane]:
            continue
        fac, idx2, idy2 = (dt.type(x) for x in geo[lane])
        gy, gx = -(-(J + 2) // t), -(-(I + 2) // t)
        parts = []
        for by in range(gy):
            for bx in range(gx):
                j0, i0 = by * t, bx * t
                j1, i1 = min(ej, j0 + t), min(ei, i0 + t)
                bj0, bi0 = max(0, j0 - ht), max(0, i0 - ht)
                R = min(J + 2, j1 + ht) - bj0
                W = min(I + 2, i1 + ht) - bi0
                sp = p[lane, bj0:bj0 + R, bi0:bi0 + W].copy()
                sr = rhs[lane, bj0:bj0 + R, bi0:bi0 + W].copy()
                a = np.arange(R)[:, None]
                b = np.arange(W)[None, :]
                ahi, bhi = min(R - 2, J - bj0), min(W - 2, I - bi0)
                upd = (a >= 1) & (a <= ahi) & (b >= 1) & (b <= bhi)
                for it in range(n):
                    for colour in (0, 1):
                        m = upd & ((a + bj0 + b + bi0) % 2 == colour)
                        c = sp
                        w, e = np.roll(sp, 1, 1), np.roll(sp, -1, 1)
                        s, nn = np.roll(sp, 1, 0), np.roll(sp, -1, 0)
                        r = sr - ((e - 2 * c + w) * idx2
                                  + (nn - 2 * c + s) * idy2)
                        sp = np.where(m, c - fac * r, c)
                        if it == n - 1:
                            sr = np.where(m, r * r, sr)
                    cols = slice(1, bhi + 1)
                    rows = slice(1, ahi + 1)
                    if 0 <= -bj0 < R:
                        sp[-bj0, cols] = sp[-bj0 + 1, cols]
                    if 0 <= J + 1 - bj0 < R:
                        sp[J + 1 - bj0, cols] = sp[J - bj0, cols]
                    if 0 <= -bi0 < W:
                        sp[rows, -bi0] = sp[rows, -bi0 + 1]
                    if 0 <= I + 1 - bi0 < W:
                        sp[rows, I + 1 - bi0] = sp[rows, I - bi0]
                acc = np.zeros((16, 32), dtype=dt)
                for k in range(-(-t // 16)):
                    for m_ in range(-(-t // 32)):
                        for ty in range(16):
                            for tx in range(32):
                                aa, bb = j0 + ty + 16 * k, i0 + tx + 32 * m_
                                if (aa < j1 and bb < i1 and 1 <= aa <= J
                                        and 1 <= bb <= I):
                                    acc[ty, tx] = (acc[ty, tx]
                                                   + sr[aa - bj0, bb - bi0])
                parts.append(_tree(acc.reshape(-1)))
                live = out[lane, j0:min(j1, J + 2), i0:min(i1, I + 2)]
                live[...] = sp[j0 - bj0:j0 - bj0 + live.shape[0],
                               i0 - bi0:i0 - bi0 + live.shape[1]]
        res[lane] = _ordered(np.array(parts, dtype=dt), 512)
    return out, res


def _class_case(cls, lanes, dtype, seed, solving=None):
    rng = np.random.default_rng(seed)
    N = len(lanes)
    p = np.zeros((N, cls + 2, cls + 2))
    rhs = np.zeros_like(p)
    for k, (j, i) in enumerate(lanes):
        p[k, :j + 2, :i + 2] = rng.normal(size=(j + 2, i + 2))
        rhs[k, :j + 2, :i + 2] = rng.normal(size=(j + 2, i + 2))
        p[k, j + 2:], p[k, :, i + 2:] = 7.0, -3.0  # dead cells, not zero
    geo = np.array([sk.sor_coefficients(1.0 / i, 1.0 / j, 1.7)
                    for j, i in lanes])
    solving = [True] * N if solving is None else solving
    t = (torch.from_numpy(p).to(dtype), torch.from_numpy(rhs).to(dtype),
         torch.tensor(lanes, dtype=torch.int32),
         torch.from_numpy(geo).to(dtype), torch.tensor(solving))
    return t


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_class_box_emulation_halo(plans, n, dtype):
    """Tiles of side 14 (boxes of 14 + 2(2n + 1)) in the 40² class, lanes
    of mixed extents (one tile to 3x3 tiles, one not solving): with the
    halo 2n + 1 the emulated kernel is the plain version bitwise, blocks
    (dead cells included) and every lane's residual; with 2n it is not."""
    box = 14 + 2 * (2 * n + 1)
    plans(box={4: box, 8: box})
    lanes = [(40, 40), (12, 9), (33, 21), (5, 40), (27, 27)]
    p, rhs, ext, geo, solving = _class_case(40, lanes, dtype, 30 + n,
                                            [True, True, True, False, True])
    assert sk.class_tile(n, p.element_size()) == 14
    pp = p.clone()
    rp = sk.rb_sor_class_plain(pp, rhs, n, ext, geo, solving)
    got, res = _emulate_class(p.numpy(), rhs.numpy(), n, ext.numpy(),
                              geo.numpy(), solving.numpy(), box, 2 * n + 1)
    assert np.array_equal(got, pp.numpy())
    assert np.array_equal(res, rp.numpy())
    short, _ = _emulate_class(p.numpy(), rhs.numpy(), n, ext.numpy(),
                              geo.numpy(), solving.numpy(), box, 2 * n)
    assert not np.array_equal(short, pp.numpy())


def test_class_plans():
    """The tiles depend on the dtype and n only; a 64² lane of the fleet's
    bucket A is one tile at float32, n = 4; bucket B's 256² lanes take 4x4;
    deep calls split into passes; the boxes fit two CTAs an SM."""
    assert sk.class_tile(4, 4) >= 66
    assert sk.class_launch_plan(64, 64, 4, 4)[0] == 1
    assert sk.class_launch_plan(256, 256, 4, 4)[0] == 16
    for itemsize in (4, 8):
        for n in range(1, 60):
            passes = sk.class_passes(n, itemsize)
            assert sum(passes) == n
            stride, geos = sk.class_launch_plan(256, 256, n, itemsize)
            for m, gi in zip(passes, geos):
                assert gi[3] == gi[4] == sk.class_tile(m, itemsize) >= 32
                assert gi[6] <= 227 * 1024 // 2 and gi[7] == stride


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_class_lane_bitwise_across_rungs(dtype):
    """The same two lanes in the 32² and the 64² class, beside other
    batchmates: blocks and residuals bitwise, n = 4 then 1."""
    lanes = [(32, 30), (17, 25)]
    p, rhs, ext, geo, solving = _class_case(32, lanes, dtype, 41)
    big = [(64, 64)] + lanes
    P, RHS, EXT, GEO, SOLVING = _class_case(64, big, dtype, 42)
    P[1:, :34, :34], RHS[1:, :34, :34] = p, rhs
    P[1:, 34:], P[1:, :, 34:] = 7.0, -3.0
    for n in (4, 1):
        r = sk.rb_sor_class_plain(p, rhs, n, ext, geo, solving)
        R = sk.rb_sor_class_plain(P, RHS, n, EXT, GEO, SOLVING)
        assert torch.equal(R[1:], r)
        assert torch.equal(P[1:, :34, :34], p)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
def test_class_residual_order_against_a_float64_sum(dtype, rtol):
    """Each lane's Σr² in the kernel's order against a float64 numpy sum
    of the same r² (bucket B's 256² class, three lanes)."""
    lanes = [(256, 256), (200, 131), (64, 250)]
    p, rhs, ext, geo, solving = _class_case(256, lanes, dtype, 51)
    r2 = torch.from_numpy(np.random.default_rng(5).random(p.shape)).to(dtype)
    for k, (j, i) in enumerate(lanes):
        r2[k, j + 1:] = 0
        r2[k, :, i + 1:] = 0
        r2[k, 0], r2[k, :, 0] = 0, 0
    got = sk.class_residual(r2, ext, 4)
    ref = r2.numpy().astype(np.float64).sum(axis=(1, 2))
    assert np.all(np.abs(got.numpy() - ref) <= rtol * ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_class_out_form_and_deep_call(dtype):
    """`out=` leaves p untouched and equals the in-place form bitwise,
    dead cells and the lane that is not solving included; a call deeper
    than one pass likewise."""
    lanes = [(20, 30), (9, 9), (30, 30)]
    p, rhs, ext, geo, solving = _class_case(30, lanes, dtype, 61,
                                            [True, False, True])
    for n in (4, 40):
        if n == 40:
            assert len(sk.class_passes(n, p.element_size())) > 1
        keep, out = p.clone(), torch.empty_like(p)
        r_out = sk.rb_sor_class(p, rhs, n, ext, geo, solving, out=out)
        assert torch.equal(p, keep)
        r_in = sk.rb_sor_class(p, rhs, n, ext, geo, solving)
        assert torch.equal(p, out) and torch.equal(r_in, r_out)
        assert torch.equal(p[1], keep[1]) and float(r_out[1]) == 0.0
        assert math.isfinite(float(r_out.sum()))
