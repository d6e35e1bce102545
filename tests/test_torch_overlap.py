"""The overlapped exchange schedule of the port's distributed NS steps
(`tpu_overlap on`, `tpu_overlap_restrict`; pampi_tpu_torch/parallel/
overlap.py, models/ns2d_dist.py, models/ns3d_dist.py) on the CPU, where
K3 and K7 run their plain versions, band mode included, against the JAX
package (its parallel/overlap.py, its banded fused PRE kernels in
interpret mode, its overlapped NS2DDistSolver / NS3DDistSolver) and
against the port's own serial step, all at float64 with JAX's own small
settings (_B2: dcavity 16², te 0.02; _B3: dcavity3d 8³; the values of
tests/test_overlap.py).

Tolerances: the region helpers equal JAX's exactly; a banded PRE equals
the full call bitwise inside its bands and JAX's banded kernel to 1e-12
of scale there (XLA contracts multiply-adds); the overlapped solvers
agree with JAX's on every step's iteration count exactly and on fields
and t to 1e-12; the port's `on` equals its `off` bitwise (torch.equal),
the 3-D obstacle runs to 1e-12 as in JAX. The split solve's residual sums
the same r² over another block shape (the halo-1 block, the CA's deep
one), so it may move by an ulp: its iteration counts are held equal, the
residual to 1e-12. The 3-D cases are in test_torch_overlap_3d.py (the
two files run on two workers of the suite).

Which solve each package dispatches decides the sweep-split record, so
each case names a layout under which both dispatch the same family: the
grid CA (split in both), or a kernel-like solve that keeps serial sweeps
(the port's K13/K15/K14 against JAX's forced quarter or octant twins and
its masked kernel). The `overlap_grid_*` record's cell counts are each
package's own layout (JAX's VMEM row blocks, the port's band launch
rows): the decision and the words are compared with JAX's, the counts
with the port's own region plan."""

import re

import numpy as np
import pytest
import torch

from pampi_tpu.models.ns2d_dist import NS2DDistSolver as JDist2
from pampi_tpu.models.ns3d_dist import NS3DDistSolver as JDist3
from pampi_tpu.parallel import overlap as jovl
from pampi_tpu.parallel.comm import CartComm as JComm
from pampi_tpu.utils import dispatch as jdispatch
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.models import ns2d_dist as md2
from pampi_tpu_torch.models import ns3d_dist as md3
from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
from pampi_tpu_torch.ops import ns2d_fused as nf
from pampi_tpu_torch.ops import ns3d_fused as nf3
from pampi_tpu_torch.parallel import comm as pc
from pampi_tpu_torch.parallel import overlap as ovl
from pampi_tpu_torch.parallel.comm import CartComm
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.params import Parameter

CPU = torch.device("cpu")
H = 3  # FUSE_DEEP_HALO

# tests/test_overlap.py's settings (its _B2 also forces the checkerboard
# layout; here each case names its own)
_B2 = dict(name="dcavity", imax=16, jmax=16, re=10.0, te=0.02, tau=0.5,
           itermax=10, eps=1e-4, omg=1.7, gamma=0.9, tpu_fuse_phases="on")
_B3 = dict(name="dcavity3d", imax=8, jmax=8, kmax=8, re=10.0, te=0.02,
           tau=0.5, itermax=8, eps=1e-4, omg=1.7, gamma=0.9,
           tpu_fuse_phases="on")
_OBST2 = dict(_B2, name="canal_obstacle", imax=24, jmax=12, eps=1e-3,
              bcLeft=3, bcRight=3, obstacles="0.3,0.3,0.6,0.6")


# -- (a) the region helpers -------------------------------------------------

_GEOMS = [((8, 8), (True, True)), ((5, 9), (True, False)),
          ((6, 6), (False, True)), ((2, 7), (True, True)),
          ((12, 1), (True, False)), ((1, 6), (False, False)),
          ((16, 4, 4), (True, True, True)), ((3, 3, 3), (True, False, True)),
          ((9, 5, 7), (True, False, False)), ((4, 6, 8), (False, True, True)),
          ((2048, 2048), (True, True)), ((64, 64, 64), (True, True, True))]


@pytest.mark.parametrize("rim", [2, 3])
@pytest.mark.parametrize("block_rows", [1, 8, 16])
@pytest.mark.parametrize("local,part", _GEOMS)
def test_region_helpers_match_jax(local, part, block_rows, rim):
    """interior_slices, interior_mask, band_cover, _merge_bands,
    region_plan and check_bands against JAX's, on (P, 1), (1, P), full and
    unpartitioned meshes, empty interiors (shards thinner than two rims)
    included."""
    assert ovl.interior_slices(local, rim, part) == \
        jovl.interior_slices(local, rim, part)
    assert ovl.interior_slices(local, rim) == jovl.interior_slices(local,
                                                                    rim)
    assert np.array_equal(ovl.interior_mask(local, rim, part).numpy(),
                          np.asarray(jovl.interior_mask(local, rim, part)))
    ext_pad = 2
    rows = local[0] + 2 + 2 * ext_pad
    nblocks = -(-rows // block_rows)
    total = nblocks * block_rows
    width = int(np.prod([e + 2 for e in local[1:]]))
    for lo, hi in ((0, 3), (ext_pad, rows), (rows - 3, rows), (1, 2)):
        assert ovl.band_cover(lo, hi, block_rows, total) == \
            jovl.band_cover(lo, hi, block_rows, total)
    raw = [ovl.band_cover(0, 3, block_rows, total),
           ovl.band_cover(rows - 4, rows, block_rows, total),
           ovl.band_cover(2, rows - 1, block_rows, total), (0, 0)]
    assert ovl._merge_bands(raw, block_rows, total) == \
        jovl._merge_bands(raw, block_rows, total)
    got = ovl.region_plan(local, rim, ext_pad, block_rows, nblocks, width,
                          part)
    want = jovl.region_plan(local, rim, ext_pad, block_rows, nblocks, width,
                            part)
    assert got == want
    for bands in ([(0, 1), (block_rows, 1)], [(0, 2), (block_rows, 1)],
                  [(total - block_rows, 1)], [(0, nblocks + 1)], [(0, 0)],
                  [(block_rows, 1), (0, 1)]):
        def verdict(fn):
            try:
                fn(bands, block_rows, nblocks)
            except ValueError as exc:
                return str(exc)
            return None
        assert verdict(ovl.check_bands) == verdict(jovl.check_bands)


def test_generation_guard_and_merge():
    """The guard passes dt when the buffers are this step's and poisons it
    with NaN otherwise; the merge is a where (-0.0 and NaN payloads
    survive)."""
    dt = torch.tensor(0.25, dtype=torch.float64)
    assert ovl.generation_guard(dt, 7, 7) is dt
    assert torch.isnan(ovl.generation_guard(dt, 6, 7))
    mask = torch.tensor([True, False, True])
    a = torch.tensor([-0.0, 1.0, float("nan")])
    b = torch.tensor([5.0, -0.0, 2.0])
    (m,) = ovl.merge_halves(mask, [a], [b])
    assert torch.equal(torch.signbit(m), torch.tensor([True, True, False]))
    assert torch.isnan(m[2]) and m[1] == 0.0


# -- (b) the grid-band mode of K3 and K7 --------------------------------------

def _shards(param, dims):
    comm = CartComm(ndims=len(dims), dims=dims, devices=[CPU])
    gext = tuple(getattr(param, k) for k in ("kmax", "jmax", "imax")[
        3 - len(dims):])
    local = comm.local_shape(gext, ragged=True)
    return comm, gext, local


def _regions(local, dims):
    """The interior mask and each half's bands of the port's plan."""
    part = tuple(d > 1 for d in dims)
    mask = ovl.interior_mask(local, ovl.OVERLAP_RIM, part)
    rows = 8 if len(dims) == 2 else 1
    plan = ovl.pre_plan(local, part, H - 1, rows)
    return mask, plan, part


def _close(a, b, where):
    a, b = a[where], b[where]
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= 1e-12 * scale


@pytest.mark.parametrize("obstacle", [False, True], ids=["plain", "flags"])
def test_banded_k3_matches_full_and_jax(obstacle):
    """K3's grid-band mode (plain version) on every shard of a ragged 3x2
    mesh: inside each half's bands bitwise the full call (NaN outside, so
    a merge that read there would show), and within 1e-12 of JAX's banded
    make_fused_pre_2d(grid_bands=) run in interpret mode, on the region
    the merge takes from that half."""
    import jax.numpy as jnp
    from pampi_tpu.ops import ns2d_fused as jnf

    from pampi_tpu_torch.ops import obstacle as obst

    kw = dict(_OBST2, jmax=29, imax=40) if obstacle else dict(
        _B2, jmax=29, imax=40)
    jparam, param = JParameter(**kw), Parameter(**kw)
    dims = (3, 2)
    comm, gext, (jl, il) = _shards(param, dims)
    mask, plan, part = _regions((jl, il), dims)
    cfg = nf.StepConfig.from_param(param)
    masks = None
    if obstacle:
        masks = obst.make_masks(obst.build_fluid(
            param.imax, param.jmax, cfg.dx, cfg.dy, param.obstacles),
            cfg.dx, cfg.dy, param.omg)
    br, _h, wp, nb = jnf.fused_deep_layout_2d(jl, il, jnp.float64, H - 1)
    jplan = jovl.region_plan((jl, il), ovl.OVERLAP_RIM, H - 1, br, nb, wp,
                             part)
    builds = {which: jnf.make_fused_pre_2d(
        jparam, param.jmax, param.imax, cfg.dx, cfg.dy, jnp.float64, jl=jl,
        il=il, ext_pad=H - 1, fluid=True if obstacle else None,
        prof_dtype=jnp.float64, interpret=True,
        grid_bands=jplan[which]) for which in ("int_bands", "bnd_bands")}
    strip = (slice(H - 1, -(H - 1)),) * 2
    dt = torch.tensor(0.011, dtype=torch.float64)
    rng = np.random.default_rng(5 + obstacle)
    for s in range(comm.size):
        off = comm.offsets(s, (jl, il))
        deep = [rng.normal(size=(jl + 2 * H, il + 2 * H)) for _ in range(2)]
        fl = None if masks is None else obst.deep_flag_block(
            masks, comm, s, jl, il, H, param.jmax, param.imax)
        full = nf.ns2d_pre_plain(*(torch.from_numpy(a) for a in deep), dt,
                                 cfg, off, gext, H - 1, fl)
        for which, region in (("int_bands", mask), ("bnd_bands", ~mask)):
            bands = plan[which]
            got = nf.ns2d_pre_plain(*(torch.from_numpy(a) for a in deep),
                                    dt, cfg, off, gext, H - 1, fl,
                                    bands=bands)
            ranges = ovl.band_ranges(bands, nf.BAND_ROWS, jl + 2 * H, H - 1,
                                     nf.MAX_BANDS)
            for k, (a, b) in enumerate(zip(got[2:], full[2:])):
                rows = ovl.band_row_mask(ranges, jl + 2, 1 if k < 2 else 0,
                                         CPU)[:, None].expand_as(a)
                assert torch.equal(a[rows], b[rows])
                assert torch.isnan(a[~rows]).all()
                # the merge's region lies inside the bands
                assert rows[region].all()
            for a, b in zip(got[:2], full[:2]):
                assert torch.equal(a, b)
            pre, pad_d, unpad_d, _h = builds[which]
            extra = () if fl is None else (pad_d(fl.numpy().astype(float)),)
            jout = [np.asarray(unpad_d(a)) for a in pre(
                jnp.asarray(off, jnp.int32), jnp.full((1, 1), 0.011),
                *(pad_d(jnp.asarray(a)) for a in deep), *extra)]
            region = region.numpy()
            for a, b in zip(got[:2], jout[:2]):
                _close(a.numpy()[strip], b[strip], region)
            for a, b in zip(got[2:], jout[2:]):
                _close(a.numpy(), b[strip], region)


def test_band_refusals():
    """Bands that overlap or overhang the deep block, too many bands, and
    bands on the single-device call are refused."""
    u = torch.zeros(10 + 2 * H, 12 + 2 * H, dtype=torch.float64)
    cfg = nf.StepConfig.from_param(Parameter(**_B2))
    dt = torch.tensor(0.01, dtype=torch.float64)
    args = (u, u.clone(), dt, cfg, (0, 0), (16, 16), H - 1)
    for bands in ([(0, 1), (4, 1)], [(8, 2)], [(0, 1)] * 5, [(0, 0)]):
        with pytest.raises(ValueError, match="grid_bands"):
            nf.ns2d_pre(*args, bands=bands)
    with pytest.raises(ValueError, match="distributed mode"):
        nf.ns2d_pre(u[2:-2, 2:-2].clone(), u[2:-2, 2:-2].clone(), dt, cfg,
                    bands=[(0, 1)])


# -- (c) against JAX's overlapped solvers, (d) on against off -----------------

# (id, Parameter keys, mesh, 3-D); the 3-D cases run in
# test_torch_overlap_3d.py
_CASES2 = [
    ("2d-plain-2x2", dict(_B2, tpu_sor_layout="quarters"), (2, 2), False),
    ("2d-split-2x2", dict(_B2, imax=18), (2, 2), False),
    ("2d-ragged-3x2", dict(_B2, tpu_sor_layout="checkerboard"), (3, 2),
     False),
    ("2d-obstacle-2x2", _OBST2, (2, 2), False),
    ("2d-obstacle-ragged-3x2", dict(_OBST2, jmax=14), (3, 2), False),
]
_CASES3 = [
    ("3d-plain-2x2x2", dict(_B3, tpu_sor_layout="checkerboard"), (2, 2, 2),
     True),
    ("3d-ragged-2x2x2", dict(_B3, imax=9, jmax=9, kmax=9), (2, 2, 2), True),
    ("3d-obstacle-2x2x2", dict(_B3, imax=12, jmax=12, kmax=12,
                               obstacles="0.3,0.3,0.3,0.7,0.7,0.7"),
     (2, 2, 2), True),
    ("3d-ragged-3x1x2", dict(_B3, kmax=10, jmax=6), (3, 1, 2), True),
]
_SPLIT = ("2d-split-2x2", "3d-plain-2x2x2", "3d-ragged-2x2x2",
          "3d-ragged-3x1x2")


def _family(three_d):
    return "ns3d_dist" if three_d else "ns2d_dist"


def _records(store, three_d):
    fam = _family(three_d)
    return {k: store.last(f"{k}_{fam}") for k in
            ("overlap", "overlap_grid", "sweep_split")}


def _jax_overlap_run(kw, dims, three_d, capfd, monkeypatch):
    """JAX's overlapped solver run to te in one chunk dispatch, with
    PAMPI_DEBUG on: the solver, every step's iteration count (from the
    "<it> Residuum: <res>" line each convergence round prints, it being
    the round's last iteration: a solve's count is its last line's it + 1,
    and a new solve starts where it stops rising) and its records."""
    monkeypatch.setenv("PAMPI_DEBUG", "1")
    js = (JDist3 if three_d else JDist2)(JParameter(**kw),
                                         JComm(ndims=len(dims), dims=dims))
    capfd.readouterr()
    js.run(progress=False)
    lines = capfd.readouterr().out.splitlines()
    monkeypatch.delenv("PAMPI_DEBUG")
    its, prev = [], None
    for it in (int(ln.split()[0]) for ln in lines if "Residuum" in ln):
        if prev is not None and it <= prev:
            its.append(prev + 1)
        prev = it
    its.append(prev + 1)
    return js, its, _records(jdispatch, three_d)


def _port(kw, dims, three_d, **more):
    cls = NS3DDistSolver if three_d else NS2DDistSolver
    return cls(Parameter(**{**kw, **more}),
               CartComm(ndims=len(dims), dims=dims, devices=[CPU]))


def _fields(s, three_d):
    g = s.global_fields()
    return [np.asarray(g[n]) for n in ("uvwp" if three_d else "uvp")]


@pytest.mark.parametrize("case,kw,dims,three_d", _CASES2,
                         ids=[c[0] for c in _CASES2])
def test_overlap_matches_jax_and_serial(case, kw, dims, three_d, capfd,
                                        monkeypatch):
    """`tpu_overlap on` against JAX's overlapped solver and the port's own
    serial step (_check_overlap_case)."""
    _check_overlap_case(case, kw, dims, three_d, capfd, monkeypatch)


def _check_overlap_case(case, kw, dims, three_d, capfd, monkeypatch):
    """`tpu_overlap on` with `tpu_overlap_restrict on` against JAX's
    overlapped solver on the same mesh: each step's iteration count, nt,
    t and the fields (1e-12), and the records; the port run one step a
    call (a prologue exchange every step) and in one call (JAX's chunk:
    one prologue, POST's maxima carried); then the port's `on` against its
    `off`, and `on` with and without the grid-band mode: bitwise (the 3-D
    obstacle run against `off` to 1e-12, as in JAX)."""
    kw = dict(kw, tpu_overlap="on", tpu_overlap_restrict="on")
    js, jits, jrec = _jax_overlap_run(kw, dims, three_d, capfd,
                                      monkeypatch)
    s = _port(kw, dims, three_d)
    rec = _records(dispatch, three_d)
    its = []
    while s.t <= s.param.te:
        s.run_steps(1)
        its.append(int(s.last_it))
    assert its == jits and len(its) >= 2
    assert s.nt == js.nt and abs(s.t - js.t) <= 1e-12 * js.t
    want = _fields(js, three_d)
    for a, b in zip(_fields(s, three_d), want):
        assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(b).max())
    # the records: the decisions equal, the grid's cell counts the port's
    # own plan's
    assert {k: rec[k] for k in ("overlap", "sweep_split")} == \
        {k: jrec[k] for k in ("overlap", "sweep_split")}
    assert rec["overlap"] == "overlap (forced)"
    split = "split (jnp rb-sor)" if case in _SPLIT else \
        "serial (pallas/other solve)"
    assert rec["sweep_split"] == split
    digits = re.compile(r"\d+")
    assert digits.sub("N", rec["overlap_grid"]) == \
        digits.sub("N", jrec["overlap_grid"])
    plan = ovl.pre_plan(s.local, tuple(d > 1 for d in dims), H - 1,
                        8 if not three_d else 1)
    if plan is not None:
        assert rec["overlap_grid"] == (
            f"restricted (forced; {plan['cells']} vs {plan['cells_full']} "
            "cells)")
    # one call: the prologue once, POST's maxima carried
    one = _port(kw, dims, three_d)
    one.run(progress=False)
    assert (one.nt, one.t) == (s.nt, s.t)
    for a, b in zip(_fields(one, three_d), _fields(s, three_d)):
        assert np.array_equal(a, b)
    # (d) the serial step and the full halves
    for more in (dict(tpu_overlap="off"), dict(tpu_overlap_restrict="off")):
        other = _port(kw, dims, three_d, **more)
        other.run(progress=False)
        assert (other.nt, other.t) == (one.nt, one.t)
        for a, b in zip(_fields(other, three_d), _fields(one, three_d)):
            if case == "3d-obstacle-2x2x2":
                assert np.abs(a - b).max() <= 1e-12
            else:
                assert np.array_equal(a, b)


@pytest.mark.parametrize("knob", ["off", "auto"])
def test_off_and_auto_are_the_serial_step(knob):
    """`off` and `auto` (no TPU) run today's serial step: its records, no
    carry, and the fields of a solver built before the schedule existed
    (the serial _step_fused called directly) bitwise."""
    kw = dict(_B2, imax=18, tpu_overlap=knob)
    s = _port(kw, (2, 2), False)
    assert s._overlap is False and s._split is False
    assert dispatch.last("overlap_ns2d_dist") == (
        "serial (tpu_overlap off)" if knob == "off" else "serial (no TPU)")
    s.run(progress=False)
    ref = _port(kw, (2, 2), False)
    while ref.t <= ref.param.te:
        dt = ref._step_fused()
        ref.t += float(dt)
        ref.nt += 1
    assert (s.nt, s.t) == (ref.nt, ref.t)
    for a, b in zip(_fields(s, False), _fields(ref, False)):
        assert np.array_equal(a, b)


# -- (e) the split solve, (f) launches, (g) the generation guard ---------------

@pytest.mark.parametrize("three_d", [False, True], ids=["2d", "3d"])
def test_split_solve_keeps_the_trajectory(three_d):
    """Under the default layout, where the port's solve is the grid CA
    (odd 2-D shards; a ragged 3-D mesh), the overlapped step's solve is the
    split form, recorded "split (jnp rb-sor)": each solve's iteration
    count and the fields equal the serial CA solve's, the residual to
    1e-12 (module docstring)."""
    if three_d:
        kw, dims = dict(_B3, imax=9, jmax=9, kmax=9, tpu_ca_inner=2), \
            (2, 2, 2)
    else:
        kw, dims = dict(_B2, imax=18, tpu_ca_inner=2), (2, 2)
    on = _port(kw, dims, three_d, tpu_overlap="on")
    assert on._split
    assert dispatch.last(f"sweep_split_{_family(three_d)}") == \
        "split (jnp rb-sor)"
    off = _port(kw, dims, three_d, tpu_overlap="off")
    assert dispatch.last(_family(three_d)).startswith("jnp_ca")
    for _ in range(3):
        on.run_steps(1)
        off.run_steps(1)
        assert on.last_it == off.last_it
        assert abs(float(on.last_res) - float(off.last_res)) <= \
            1e-12 * float(off.last_res)
    for a, b in zip(_fields(on, three_d), _fields(off, three_d)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("three_d", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("restrict", ["off", "on"])
def test_pre_calls_per_step(three_d, restrict, monkeypatch):
    """PRE runs twice a step and shard with the overlap and once without:
    on the CPU the calls of the wrapper (the launch counters move only on
    the card, tests/test_torch_cuda.py); banded calls under
    `tpu_overlap_restrict on`."""
    mod, name = (md3, "ns3d_pre") if three_d else (md2, "ns2d_pre")
    calls = []
    real = getattr(mod, name)

    def spy(*a, **kw):
        calls.append(kw.get("bands") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(mod, name, spy)
    kw, dims = ((dict(_B3, imax=9, jmax=9, kmax=9), (2, 2, 2)) if three_d
                else (_B2, (2, 2)))
    for overlap, per in (("on", 2), ("off", 1)):
        s = _port(kw, dims, three_d, tpu_overlap=overlap,
                  tpu_overlap_restrict=restrict)
        calls.clear()
        s.run_steps(3)
        assert len(calls) == 3 * per * s.comm.size
        assert all(calls) == (overlap == "on" and restrict == "on")


@pytest.mark.parametrize("three_d", [False, True], ids=["2d", "3d"])
def test_generation_skew_poisons_t(three_d, monkeypatch):
    """A forged generation skew (GEN_SKEW) makes the step consume a stale
    double buffer: dt and t go NaN, and drive_chunks stops there."""
    monkeypatch.setattr(ovl, "GEN_SKEW", 1)
    kw, dims = ((_B3, (2, 2, 2)) if three_d else (_B2, (2, 2)))
    s = _port(kw, dims, three_d, tpu_overlap="on")
    s.run(progress=False)
    assert np.isnan(s.t) and s.nt == 1


# -- (h) knobs and records, (i) the schedule cache ------------------------------

def test_knob_values_and_fallback_records():
    """Values outside auto|on|off raise the JAX package's ValueError;
    `on` without the fused step records why it stays serial."""
    with pytest.raises(ValueError, match="tpu_overlap must be"):
        _port(_B2, (2, 2), False, tpu_overlap="sometimes")
    with pytest.raises(ValueError, match="tpu_overlap_restrict must be"):
        _port(_B2, (2, 2), False, tpu_overlap="on",
              tpu_overlap_restrict="maybe")
    for three_d, kw, dims in ((False, _B2, (2, 2)),
                              (True, _B3, (2, 2, 2))):
        s = _port(kw, dims, three_d, tpu_overlap="on",
                  tpu_fuse_phases="off")
        assert not s._overlap
        assert dispatch.last(f"overlap_{_family(three_d)}") == (
            "serial (needs the fused deep-halo step (tpu_fuse_phases))")
    # the refusals that stay name their item
    for kw in (dict(tpu_exchange_depth="1"), dict(tpu_itermax_adaptive=4)):
        with pytest.raises(NotImplementedError, match=r"A\.8, item 6\.[23]"):
            _port(_B2, (2, 2), False, tpu_overlap="on", **kw)


def test_persistent_exchange_is_cached():
    """The same schedule object comes back for the same (mesh, depth,
    dtype, periodic); another key gives another; it exchanges as
    halo_exchange does, and refuses another dtype."""
    comm = CartComm(ndims=2, dims=(2, 2), devices=[CPU])
    a = pc.persistent_exchange(comm, 3, torch.float64)
    assert pc.persistent_exchange(comm, 3, torch.float64) is a
    assert pc.persistent_exchange(comm, 1, torch.float64) is not a
    assert pc.persistent_exchange(comm, 3, torch.float32) is not a
    assert pc.persistent_exchange(comm, 3, torch.float64, ("i",)) is not a
    other = CartComm(ndims=2, dims=(2, 2), devices=[CPU], tiers="j=dcn")
    assert pc.persistent_exchange(other, 3, torch.float64) is not a
    rng = np.random.default_rng(1)
    blocks = [torch.from_numpy(rng.normal(size=(10, 12))) for _ in range(4)]
    want = pc.halo_exchange([b.clone() for b in blocks], comm, depth=3)
    (got,) = a.post([blocks], lambda b: b.clone()).wait()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(TypeError, match="ExchangeSchedule built for"):
        a([b.float() for b in blocks])


def test_cli_reaches_the_overlapped_step(tmp_path, monkeypatch):
    """`tpu_overlap on` in configs/dcavity.par (16², te 0.02, 2x2) through
    the CLI (_check_cli)."""
    _check_cli("dcavity.par", "imax 16\njmax 16\nte 0.02\ntpu_mesh 2x2\n",
               tmp_path, monkeypatch)


def _check_cli(par, extra, tmp_path, monkeypatch):
    """`tpu_overlap on` and `tpu_overlap_restrict on` in a .par file reach
    the distributed solvers through `python -m pampi_tpu_torch` (records
    "overlap (forced)" and the grid's decision), and the written results
    are byte-identical to the `off` run's."""
    import pathlib

    from pampi_tpu_torch import cli

    base = (pathlib.Path(__file__).resolve().parent.parent / "configs"
            / par).read_text()
    fam = "ns3d_dist" if "3d" in par else "ns2d_dist"
    outs = {}
    for knob in ("on", "off"):
        run = tmp_path / knob
        run.mkdir()
        path = run / par
        path.write_text(base + extra + f"tpu_overlap {knob}\n"
                        "tpu_overlap_restrict on\n")
        monkeypatch.chdir(run)
        assert cli.main(["pampi_tpu_torch", "--device", "cpu",
                         str(path)]) == 0
        assert dispatch.last(f"overlap_{fam}") == (
            "overlap (forced)" if knob == "on" else
            "serial (tpu_overlap off)")
        if knob == "on":
            assert dispatch.last(f"overlap_grid_{fam}").startswith(
                ("restricted (forced;", "full (interior region empty"))
        outs[knob] = {p.name: p.read_bytes() for p in run.iterdir()
                      if p.suffix in (".dat", ".vtk")}
    assert outs["on"] and outs["on"] == outs["off"]
