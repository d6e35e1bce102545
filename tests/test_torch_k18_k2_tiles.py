"""The one-pass design of plain K2 (the checkerboard SOR on the natural
field, ops/sor_kernels.py) and the on-chip forms of K18 (the fleet's class
V-cycle, ops/mg_fused.py), on the CPU, where their plain versions run.

Each kernel's CTA is written out here in numpy, cell for cell as the CUDA
source runs it, and held bitwise against the plain version, fields and
residual:

- K2 (csrc/sor_rb.cu cb_tiled): a tile's box of rows x columns grid cells
  from the tile's corner less the halo, its cells off the field 0; each
  half-sweep updates the colour's interior cells (the box's edge from
  clamped neighbours), the wall ghosts folded into the reads (from the
  second iteration on, a cell next to a wall reads itself there), the
  ghosts written at the end from their neighbours; each thread (a column
  of the box, QK rows of it) adds its owned r² in its update order (red
  cells, then black), a halving tree over the threads, the tiles'
  partials in tile order. With the halo 2n + 1 it is the plain version
  bit for bit; with 2n it is not (a ghost alone in its tile reads its
  neighbour from the halo).
- K18 (csrc/mg_class_cycle.cu): the levels banded over a cluster's CTAs
  (rows cut by the capacity rule), the coarse levels in one CTA; every
  phase a colour, a copy or a transfer over the rows each CTA owns, its
  neighbours' edge rows read across the bands; the fine residual's sum in
  the order of the single-CTA design. The bands change nothing: the fields
  and the residual are the plain version's bit for bit, whatever form the
  capacity rule picks, and a lane re-served in a larger class gives the
  same bits.

Small boxes (monkeypatched) make several tiles a field. Besides: the plans,
the `out=` form, configs/poisson.par at 2388 iterations under `tpu_sor_layout
checkerboard`."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pampi_tpu_torch.ops import mg_fused as mf
from pampi_tpu_torch.ops import sor_kernels as sk

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
def k2_cta(monkeypatch):
    """Patch K2's CTA table; the plan caches are cleared before and
    after."""
    def clear():
        for fn in (sk.checkerboard_passes, sk.checkerboard_launch_plan):
            fn.cache_clear()

    def patch(cta):
        clear()
        monkeypatch.setattr(sk, "K2_CTA", {4: cta, 8: cta})
    yield patch
    monkeypatch.undo()
    clear()


# -- K2 ---------------------------------------------------------------------


def _emulate_k2(p, f, n, coef, cta, ht):
    """cb_tiled on the CPU (numpy): the field after n iterations and the
    residual in the kernel's order, with tiles of the box less a halo of
    ht; also the count of boxes inside the field's interior."""
    qw, qs, qk = cta
    rows = qs * qk
    th, tw = rows - 2 * ht, qw - 2 * ht
    dt = p.dtype
    fac, idx2, idy2 = (dt.type(c) for c in coef)
    J, I = p.shape[0] - 2, p.shape[1] - 2
    a = np.arange(rows)[:, None]
    b = np.arange(qw)[None, :]
    out = np.full_like(p, np.nan)
    parts = []
    inner = 0

    def sh(x, da, db):  # x at (a + da, b + db), clamped to the box
        pad = np.pad(x, 1, mode="edge")
        return pad[1 + da:1 + da + x.shape[0], 1 + db:1 + db + x.shape[1]]

    for by in range(-(-(J + 2) // th)):
        for bx in range(-(-(I + 2) // tw)):
            gr, gc = by * th - ht + a, bx * tw - ht + b
            field = (gr >= 0) & (gr <= J + 1) & (gc >= 0) & (gc <= I + 1)
            grc, gcc = np.clip(gr, 0, J + 1), np.clip(gc, 0, I + 1)
            P = np.where(field, p[grc, gcc], dt.type(0))
            F = np.where(field, f[grc, gcc], dt.type(0))
            interior = (gr >= 1) & (gr <= J) & (gc >= 1) & (gc <= I)
            if interior.all():
                inner += 1
            own = ((a >= ht) & (a < ht + th) & (gr <= J + 1)
                   & (b >= ht) & (b < ht + tw) & (gc <= I + 1))
            r2 = np.zeros_like(P)
            for t in range(n):
                for colour in (0, 1):
                    upd = interior & ((gr + gc) % 2 == colour)
                    c = P
                    w, e = sh(P, 0, -1), sh(P, 0, 1)
                    s, nn = sh(P, -1, 0), sh(P, 1, 0)
                    if t > 0:
                        w = np.where(gc == 1, c, w)
                        e = np.where(gc == I, c, e)
                        s = np.where(gr == 1, c, s)
                        nn = np.where(gr == J, c, nn)
                    r = F - ((e - 2 * c + w) * idx2 + (nn - 2 * c + s) * idy2)
                    P = np.where(upd, c - fac * r, c)
                    if t == n - 1:
                        r2 = np.where(upd & own, r * r, r2)
            # the ghosts from their neighbours' final values
            rint, cint = (gr >= 1) & (gr <= J), (gc >= 1) & (gc <= I)
            final = P.copy()
            final = np.where((gr == 0) & cint, sh(P, 1, 0), final)
            final = np.where((gr == J + 1) & cint, sh(P, -1, 0), final)
            final = np.where((gc == 0) & rint, sh(P, 0, 1), final)
            final = np.where((gc == I + 1) & rint, sh(P, 0, -1), final)
            # each thread's update order: red cells down its run, then
            # black ones
            acc = np.zeros(qs * qw, dtype=dt)
            run = r2.reshape(qs, qk, qw)
            parity = (gr + gc).reshape(qs, qk, qw) % 2
            for colour in (0, 1):
                for k in range(qk):
                    acc = acc + np.where(parity[:, k] == colour, run[:, k],
                                         dt.type(0)).reshape(-1)
            parts.append(_tree(acc))
            rows_o = gr[own.any(axis=1), 0]
            cols_o = gc[0, own.any(axis=0)]
            out[rows_o[0]:rows_o[-1] + 1, cols_o[0]:cols_o[-1] + 1] = (
                final[own.any(axis=1)][:, own.any(axis=0)])
    return out, _ordered(np.array(parts, dtype=dt), qw * qs), inner


def _k2_case(jmax, imax, dtype, seed):
    rng = np.random.default_rng(seed)
    p, rhs = (torch.from_numpy(rng.normal(size=(jmax + 2, imax + 2)))
              .to(dtype) for _ in range(2))
    return p, rhs, sk.sor_coefficients(1.0 / imax, 1.0 / jmax, 1.9)


def _k2_grid(kind, side, halo):
    """An even grid, an odd one, and one whose last tile column and row
    are 1 cell wide for the halo `halo` (J + 2 and I + 2 one past a
    multiple of the tile): a wall ghost alone in its tile."""
    t = side - 2 * halo
    return {"even": (side * 2 + 6, side * 3 - 10), "odd": (side * 2 + 7, side * 3 - 11),
            "edge1": (2 * t - 1, 3 * t - 1)}[kind]


@pytest.mark.parametrize("grid", ["even", "odd", "edge1"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_box_emulation_halo(k2_cta, grid, n, dtype):
    """Boxes of 32 rows (2 runs of 16) by 32 columns (64 by 64 at n = 4,
    one pass): with the halo 2n + 1 the emulated kernel is the plain
    version bitwise, field and residual; with 2n its field differs where a
    wall ghost is alone in its tile."""
    side = 32 if n < 4 else 64
    cta = (side, side // 16, 16)
    k2_cta(cta)
    p, f, coef = _k2_case(*_k2_grid(grid, side, 2 * n + 1), dtype,
                          10 * n + len(grid))
    (pl,) = sk.checkerboard_passes(n, p.element_size())
    t = side - 4 * n - 2
    assert (pl.iters, pl.th, pl.tw) == (n, t, t)
    x = p.clone()
    rp = sk.rb_sor_checkerboard_plain(x, f, n, *coef)
    got, res, inner = _emulate_k2(p.numpy(), f.numpy(), n, coef, cta,
                                  2 * n + 1)
    assert np.array_equal(got, x.numpy())
    assert res == rp.item() and res.dtype == p.numpy().dtype
    if grid == "even":
        assert inner > 0  # boxes without predicates are covered too
    if grid == "edge1":
        # with the halo 2n, on a field where that halo leaves a ghost
        # alone in its tile
        p, f, coef = _k2_case(*_k2_grid(grid, side, 2 * n), dtype, 5 * n)
        x = p.clone()
        sk.rb_sor_checkerboard_plain(x, f, n, *coef)
        for halo, same in ((2 * n + 1, True), (2 * n, False)):
            got, _, _ = _emulate_k2(p.numpy(), f.numpy(), n, coef, cta, halo)
            assert np.array_equal(got, x.numpy()) == same


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                            (8, torch.float64)])
def test_k2_box_emulation_real_plan(itemsize, dtype):
    """The shipped CTA (128x64 boxes at float32, 64x64 at float64) at n = 4
    on a field of several tiles: bitwise the plain version."""
    n = 4
    cta = sk.K2_CTA[itemsize]
    p, f, coef = _k2_case(150, 131, dtype, 7)
    x = p.clone()
    rp = sk.rb_sor_checkerboard_plain(x, f, n, *coef)
    got, res, _ = _emulate_k2(p.numpy(), f.numpy(), n, coef, cta,
                              2 * n + 1)
    assert np.array_equal(got, x.numpy()) and res == rp.item()


@pytest.mark.parametrize("itemsize", [4, 8])
def test_k2_plans(itemsize):
    """One pass up to n = 7 (the tile keeps half the box), several past
    it; the shared memory is the box."""
    qw, qs, qk = sk.K2_CTA[itemsize]
    for n in range(1, 8):
        (pl,) = sk.checkerboard_passes(n, itemsize)
        assert (pl.th, pl.tw) == (qs * qk - 4 * n - 2, qw - 4 * n - 2)
    assert [pl.iters for pl in sk.checkerboard_passes(12, itemsize)] == [6, 6]
    (tiles, geo), = sk.checkerboard_launch_plan(4094, 4094, 4, itemsize)
    assert list(geo)[:7] == [4094, 4094, 4, qs * qk - 18, qw - 18, qs, qk]
    assert geo[7] == qs * qk * qw * itemsize <= 48 * 1024
    assert tiles == -(-4096 // (qs * qk - 18)) * -(-4096 // (qw - 18))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_out_form_and_deep_call(dtype):
    """rb_sor_checkerboard(..., out=) on the CPU: p untouched, out and the
    residual bitwise the in-place call's; a call of 12 iterations (two
    passes) is 12 iterations of the plain sweeps, its residual over the
    last pass's tiles."""
    p, f, coef = _k2_case(40, 52, dtype, 3)
    keep, x = p.clone(), p.clone()
    out = torch.full_like(p, float("nan"))
    r_out = sk.rb_sor_checkerboard(p, f, 3, *coef, out=out)
    r_in = sk.rb_sor_checkerboard(x, f, 3, *coef)
    assert torch.equal(p, keep) and torch.equal(out, x)
    assert torch.equal(r_out, r_in)
    with pytest.raises(ValueError):
        sk.rb_sor_checkerboard(p, f, 3, *coef, out=p)
    deep, ref = p.clone(), p.clone()
    r_deep = sk.rb_sor_checkerboard(deep, f, 12, *coef)
    r2 = sk.checkerboard_sweeps(ref, f, 12, *coef)
    last = sk.checkerboard_passes(12, p.element_size())[-1]
    assert last.iters == 6 and torch.equal(deep, ref)
    assert torch.equal(r_deep, sk.checkerboard_residual(r2, last))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
def test_k2_residual_order_against_a_float64_sum(dtype, rtol):
    """The kernel's order sums the same terms as a plain float64 sum."""
    p, f, coef = _k2_case(300, 170, dtype, 5)
    r2 = sk.checkerboard_sweeps(p, f, 2, *coef)
    got = sk.checkerboard_residual(
        r2, sk.checkerboard_passes(2, p.element_size())[-1])
    want = r2.to(torch.float64).sum()
    assert abs(float(got) - float(want)) <= rtol * float(want)


def test_poisson_par_checkerboard_at_2388(tmp_path):
    """configs/poisson.par under `tpu_sor_layout checkerboard` through the
    port's CLI on the CPU: 2388 iterations, as the JAX CLI."""
    text = open(os.path.join(ROOT, "configs", "poisson.par")).read()
    par = tmp_path / "poisson.par"
    par.write_text(text + "\ntpu_sor_layout checkerboard\n")
    out = subprocess.run(
        [sys.executable, "-m", "pampi_tpu_torch", "--device", "cpu",
         str(par)], cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": ROOT}, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "2388 " in out.stdout


# -- K18 --------------------------------------------------------------------

NT18 = mf.CLASS_THREADS


class _Cluster:
    """A lane's levels as the CTAs of a K18 cluster hold them: level l <
    banded cut into bands of ceil(rows / ctas) rows, the rest whole in CTA
    0. Every phase runs CTA by CTA over the rows each owns (the kernel's
    threads take cells in any order: within a phase no cell reads another
    that the phase writes), and counts the rows it writes, to show that
    the bands cover each row exactly once. The Neumann copy is folded into
    the reads: where a level's ghosts are stale (the plain version's copy
    has run since the kernel last wrote them) a neighbour across a wall
    reads the cell itself."""

    def __init__(self, levels, ctas, banded):
        self.P, self.R, self.ext = levels
        self.ctas, self.banded = ctas, banded
        self.stale = set()

    def band(self, lvl, rank):
        rows = self.P[lvl].shape[0]
        b = -(-rows // self.ctas) if lvl < self.banded else rows
        lo = min(rank * b, rows)
        return lo, min(lo + b, rows)

    def ranks(self, lvl):
        return range(self.ctas) if lvl < self.banded else (0,)

    def resid(self, lvl, j, i, coef):
        """rhs - lap at row j, columns i (an array) of level lvl."""
        idx2, idy2, _ = coef
        J, I = self.ext[lvl]
        P, R = self.P[lvl], self.R[lvl]
        c = P[j, i]
        w, e, s, n = P[j, i - 1], P[j, i + 1], P[j - 1, i], P[j + 1, i]
        if lvl in self.stale:
            w = np.where(i == 1, c, w)
            e = np.where(i == I, c, e)
            s = c if j == 1 else s
            n = c if j == J else n
        return R[j, i] - ((e - 2 * c + w) * idx2 + (n - 2 * c + s) * idy2)

    def colour(self, lvl, par, coef):
        J, I = self.ext[lvl]
        P = self.P[lvl]
        seen = []
        for rank in self.ranks(lvl):
            lo, hi = self.band(lvl, rank)
            for j in range(max(lo, 1), min(hi, J + 1)):
                i = np.arange(1 if (1 + j) % 2 == par else 2, I + 1, 2)
                P[j, i] = P[j, i] - coef[2] * self.resid(lvl, j, i, coef)
                seen.append(j)
        assert sorted(seen) == list(range(1, J + 1))

    def smooth(self, lvl, coef, n):
        for _ in range(n):
            self.colour(lvl, 0, coef)
            self.colour(lvl, 1, coef)
            self.stale.add(lvl)

    def restrict(self, lvl, coef):
        """Coarse row jc from the CTA owning fine row max(2 jc - 1, 0)."""
        Jc, Ic = self.ext[lvl + 1]
        pc, rc = self.P[lvl + 1], self.R[lvl + 1]
        dt = pc.dtype.type
        seen = []
        for rank in self.ranks(lvl):
            lo, hi = self.band(lvl, rank)
            for jc in range(Jc + 2):
                if not lo <= max(2 * jc - 1, 0) < hi:
                    continue
                seen.append(jc)
                pc[jc, :Ic + 2] = 0
                rc[jc, :Ic + 2] = 0
                if not 1 <= jc <= Jc:
                    continue
                ic = np.arange(1, Ic + 1)
                s = None
                for k in range(4):
                    r = self.resid(lvl, 2 * jc - 1 + (k >> 1),
                                   2 * ic - 1 + (k & 1), coef)
                    s = r if s is None else s + r
                rc[jc, ic] = s / dt(4)
        assert sorted(seen) == list(range(Jc + 2))
        self.stale.discard(lvl + 1)

    def prolong_add(self, lvl, child):
        J, I = self.ext[lvl]
        P = self.P[lvl]
        for rank in self.ranks(lvl):
            lo, hi = self.band(lvl, rank)
            for j in range(lo, min(hi, J + 2)):
                row = P[j, :I + 2]
                plus0 = np.where(row == 0, np.zeros_like(row), row)
                if child and 1 <= j <= J:
                    pc = self.P[lvl + 1][(j + 1) >> 1]
                    i = np.arange(1, I + 1)
                    plus0[i] = row[i] + pc[(i + 1) >> 1]
                P[j, :I + 2] = plus0
        if child:
            self.stale.add(lvl)

    def faces(self):
        """Level 0's live faces written once, from their neighbours."""
        if 0 not in self.stale:
            return
        J, I = self.ext[0]
        P = self.P[0]
        P[0, 1:I + 1], P[J + 1, 1:I + 1] = P[1, 1:I + 1], P[J, 1:I + 1]
        P[1:J + 1, 0], P[1:J + 1, I + 1] = P[1:J + 1, 1], P[1:J + 1, I]


def _emulate_k18(p, rhs, ext, geo, active, ctas, banded):
    """K18's cluster form on the CPU (numpy): per active lane, the cycle's
    phases over the bands (_Cluster) in the kernel's order, CTA 0 running
    the levels past `banded` alone; the fine residual as the kernel's
    chain, CTA r continuing each thread's sum over its rows. Returns (p',
    rsq)."""
    out, rsq = p.copy(), np.zeros(p.shape[0], dtype=p.dtype)
    jc, ic = p.shape[1] - 2, p.shape[2] - 2
    lmax = ext.shape[1]
    for lane in np.flatnonzero(active):
        e, g = ext[lane], geo[lane]
        L = next((lvl for lvl in range(1, lmax) if not e[lvl, 2]), lmax)
        P = [out[lane]] + [np.zeros(((jc >> lvl) + 2, (ic >> lvl) + 2),
                                    dtype=p.dtype) for lvl in range(1, L)]
        R = [rhs[lane].copy()] + [np.zeros_like(x) for x in P[1:]]
        dims = [(min(max(int(e[lvl, 0]), 1), jc >> lvl),
                 min(max(int(e[lvl, 1]), 1), ic >> lvl)) for lvl in range(L)]
        cl = _Cluster((P, R, dims), ctas, banded)
        coef = [tuple(g[lvl]) for lvl in range(L)]
        for lvl in range(L):  # down: the bands, then CTA 0's levels
            cl.smooth(lvl, coef[lvl], mf.N_PRE)
            if lvl + 1 < L:
                cl.restrict(lvl, coef[lvl])
        for lvl in reversed(range(L)):
            child = lvl + 1 < L
            cl.prolong_add(lvl, child)
            if not child:
                cl.smooth(lvl, coef[lvl], mf.N_BOTTOM)
            cl.smooth(lvl, coef[lvl], mf.N_POST)
        # the residual chain (the faces written beside it)
        J, I = dims[0]
        r2 = np.concatenate([cl.resid(0, j, np.arange(1, I + 1), coef[0])
                             for j in range(1, J + 1)]) ** 2
        cl.faces()
        acc = np.zeros(NT18, dtype=p.dtype)
        for rank in range(ctas):
            lo, hi = cl.band(0, rank)
            kbeg = (max(lo, 1) - 1) * I
            kend = (min(hi, J + 1) - 1) * I
            for k in range(kbeg, kend):
                acc[k % NT18] = acc[k % NT18] + r2[k]
        rsq[lane] = _tree(acc)
    return out, rsq


def _k18_inputs(cls, lanes, dtype, seed, active=None):
    rng = np.random.default_rng(seed)
    n, lmax = len(lanes), mf.class_level_max(cls, cls)
    p = np.zeros((n, cls + 2, cls + 2))
    rhs = np.zeros((n, cls + 2, cls + 2))
    ext, geo = [], []
    for k, (jl, il) in enumerate(lanes):
        p[k, :jl + 2, :il + 2] = rng.normal(size=(jl + 2, il + 2))
        rhs[k, 1:jl + 1, 1:il + 1] = rng.normal(size=(jl, il))
        e, g = mf.class_level_plan(jl, il, float(il * il), float(jl * jl),
                                   lmax, dtype)
        ext.append(e)
        geo.append(g)
    act = torch.tensor([1] * n if active is None else active,
                       dtype=torch.int32)
    return (torch.from_numpy(p).to(dtype), torch.from_numpy(rhs).to(dtype),
            torch.stack(ext), torch.stack(geo), act)


# bucket A at small size (the 64² class on one CTA: every level in its
# shared memory) and bucket B at small size (the same class as a cluster:
# bands of 9 and 5 rows on 8 CTAs, the coarse levels in CTA 0; or 3 CTAs
# with every level banded, down to bands of 2 rows)
K18_FORMS = [(1, 5), (8, 2), (3, 5), (2, 1)]
K18_LANES = [(64, 64), (64 - 5, 48 + 5), (9, 13), (12, 12), (56, 40),
             (64, 64)]


@pytest.mark.parametrize("form", K18_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k18_cluster_emulation(form, dtype):
    """Full, ragged, one-level and early-stopping lanes and an inactive
    one in the 64² class, two chained cycles: every form's emulated kernel
    is the plain version bitwise, fields and each lane's rsq."""
    inputs = _k18_inputs(64, K18_LANES, dtype, 21,
                         active=[1, 1, 1, 1, 1, 0])
    p, rhs, ext, geo, act = inputs
    pp, pe = p, p.numpy()
    for _ in range(2):
        pp, rp = mf.class_cycle_plain(pp, rhs, ext, geo, act)
        pe, re = _emulate_k18(pe, rhs.numpy(), ext.numpy(), geo.numpy(),
                              act.numpy(), *form)
        assert np.array_equal(pe, pp.numpy())
        assert np.array_equal(re, rp.numpy())
    assert torch.equal(pp[5], p[5]) and rp[5] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k18_lane_bitwise_across_rungs_and_forms(dtype):
    """Two lanes of the 32² class re-served in the 64² class: the live
    corner and rsq are the same bits, and so is rsq in every form (one
    CTA, a cluster of 8 with CTA 0's levels, 3 CTAs all banded)."""
    lanes = [(32, 32), (30, 26)]
    small = _k18_inputs(32, lanes, dtype, 5)
    big = _k18_inputs(64, lanes, dtype, 5)
    for k, (jl, il) in enumerate(lanes):  # the same corner values
        big[0][k, :jl + 2, :il + 2] = small[0][k, :jl + 2, :il + 2]
        big[1][k, :jl + 2, :il + 2] = small[1][k, :jl + 2, :il + 2]
    ps, rs = mf.class_cycle_plain(*small)
    pb, rb = mf.class_cycle_plain(*big)
    assert torch.equal(rs, rb)
    for k, (jl, il) in enumerate(lanes):
        assert torch.equal(ps[k, :jl + 2, :il + 2], pb[k, :jl + 2, :il + 2])
    for form in K18_FORMS:
        _, re = _emulate_k18(*(x.numpy() for x in big), *form)
        assert np.array_equal(re, rb.numpy())


def test_k18_capacity_rule():
    """One CTA where every level fits a CTA's shared memory; a cluster of
    8 for the 256² class (bucket B), its coarse levels (at most 36² cells)
    whole in CTA 0; past the shared memory the finest banded levels in
    device memory; every form within the kernel's shared memory."""
    a32, a64 = mf.class_cycle_form(64, 64, 4), mf.class_cycle_form(64, 64, 8)
    assert (a32.ctas, a32.smem, a64.ctas) == (1, 47776, 1)
    b32 = mf.class_cycle_form(256, 256, 4)
    assert (b32.ctas, b32.banded, b32.gmask) == (8, 3, 0)
    assert b32.smem == 2 * 4 * (33 * 258 + 17 * 130 + 9 * 66
                                + 34 * 34 + 18 * 18 + 10 * 10 + 6 * 6)
    b64 = mf.class_cycle_form(256, 256, 8)
    assert (b64.ctas, b64.gmask, b64.smem) == (8, 0, 2 * b32.smem)
    big = mf.class_cycle_form(1024, 1024, 8)
    assert big.ctas == 8 and big.gmask == 0b11
    for cls in (16, 32, 64, 128, 256, 512, 1024, 2048):
        for itemsize in (4, 8):
            assert mf.class_cycle_form(cls, cls, itemsize).smem <= \
                mf.CLASS_SMEM
