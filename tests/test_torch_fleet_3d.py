"""The port's 3-D shape-class rungs (pampi_tpu_torch/fleet/shapeclass.py's
Class3DSolver with the class mode of K7/K8) against the JAX package's
(pampi_tpu/fleet/shapeclass.py), on the CPU.

Contracts:
- K7/K8's class mode, plain, against JAX's make_fused_pre_3d /
  make_fused_post_3d(ragged=True, dynamic=True) in interpret mode, one call
  each on a dcavity3d and a canal3d lane of the 16³ class, f64: the
  boundary copies bitwise, F, G, H, rhs and the projected fields within
  1e-12 of scale, dead cells 0, the maxima bitwise the maxima of the
  fields they come with and within 1e-12 of JAX's; an inactive lane passed
  through bitwise with F, G, H, rhs 0;
- make_class_solve_3d against JAX's, itermax-capped, lanes (8, 8, 8) and
  (8, 9, 10) of the 16³ class: counts equal, live cells within 1e-12 of
  scale, dead cells and a lane that is not solving untouched;
- a mixed 3-D class batch (dcavity3d 8³ and 10x9x8, canal3d 12x9x8, the
  16³ class) against JAX's Class3DSolver + BatchedSolver on its jnp chain
  (its `auto` off a TPU), f64, under the port's `auto` (the fused step on
  the kernels' plain versions) and `off` (the masked chain): each lane's
  steps and every step's iteration count equal (JAX's from its flight
  recorder, one step a chunk), fields within 1e-10 of scale, dead cells
  0; an f32 batch with eps 0 (itermax caps every solve) within 1e-5;
- a lane bitwise the same in the 16³ and 32³ classes, whatever its
  batchmates; a JAX 3-D class batch state continued in the port
  (BatchedSolver.from_numpy_state);
- FleetScheduler(classes="on", device="cpu") serves 3-D sor requests as
  class buckets, the fused and the chain step bitwise one another;
  class_lanes_3d refuses extents outside the class."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu import fleet as jfleet
from pampi_tpu.fleet import shapeclass as jsc
from pampi_tpu.ops import ns3d_fused as jnf3
from pampi_tpu.utils import telemetry as jtm
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch import fleet
from pampi_tpu_torch.fleet import shapeclass as sc
from pampi_tpu_torch.ops import ns3d_fused as nf3
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.params import parameter_from_dict

# tests/test_serve.py's _B3 knobs, te long enough for a few steps
B3 = dict(name="dcavity3d", imax=8, jmax=8, kmax=8, re=10.0, te=0.05,
          tau=0.5, itermax=8, eps=1e-4, omg=1.7, gamma=0.9, tpu_mesh="1",
          tpu_chunk=1, tpu_dtype="float64")
CANAL3 = dict(B3, name="canal3d", re=100.0, xlength=30.0, ylength=4.0,
              zlength=4.0, u_init=1.0, bcLeft=3, bcRight=3, te=0.4,
              itermax=20)
LANES = {"d0": dict(B3),
         "d1": dict(B3, imax=10, jmax=9, u_init=0.01, p_init=0.2),
         "c0": dict(CANAL3, imax=12, jmax=9)}
F64_TOL, F32_TOL = 1e-10, 1e-5


def _port(jparam):
    return parameter_from_dict(dataclasses.asdict(jparam))


def _scaled(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max()) / max(
        1.0, float(np.abs(b).max()))


def _live(kc, jc, ic, kmax, jmax, imax):
    return ((np.arange(kc + 2)[:, None, None] <= kmax + 1)
            & (np.arange(jc + 2)[None, :, None] <= jmax + 1)
            & (np.arange(ic + 2)[None, None, :] <= imax + 1))


def _gm(params):
    return np.array([sc.lane_geometry_3d(q) for q in params])


# ----------------------------------------------------------------------
# the kernels' plain versions against JAX's kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["dcavity3d", "canal3d"])
def test_class_k7_k8_plain_match_jax_dynamic_kernels(problem):
    base = B3 if problem == "dcavity3d" else CANAL3
    c = 16
    # the lane held against JAX, a full-extent lane, an inactive lane
    extents = ((8, 9, 10), (16, 16, 16), (12, 10, 9))
    params = [_port(JParameter(**{**base, "kmax": k, "jmax": j,
                                  "imax": i})) for k, j, i in extents]
    jbase = JParameter(**{**base, "kmax": c, "jmax": c, "imax": c})
    jpre, pad3, unpad3, _h = jnf3.make_fused_pre_3d(
        jbase, c, c, c, 1.0, 1.0, 1.0, jnp.float64, dynamic=True,
        interpret=True)
    jpost, _p, _u, _h2 = jnf3.make_fused_post_3d(
        jbase, c, c, c, 1.0, 1.0, 1.0, jnp.float64, ragged=True,
        dynamic=True, interpret=True)
    rng = np.random.default_rng(11)
    n = len(extents)
    u, v, w, p = (np.zeros((n, c + 2, c + 2, c + 2)) for _ in range(4))
    for k, e in enumerate(extents):
        live = _live(c, c, c, *e)
        for a in (u, v, w, p):
            a[k] = np.where(live, rng.normal(size=live.shape), 0.0)
    dt = np.array([0.013, 0.021, 0.017])
    gm = _gm(params)
    ext = torch.tensor(extents, dtype=torch.int32)
    geo = torch.from_numpy(gm[:, [sc.G3_DX, sc.G3_DY, sc.G3_DZ]].copy())
    active = torch.tensor([True, True, False])
    cfg = nf3.StepConfig3D.from_param(params[0])
    tu, tv, tw = (torch.from_numpy(a.copy()) for a in (u, v, w))
    f, g, h, rhs = nf3.ns3d_pre(tu, tv, tw, torch.from_numpy(dt), cfg,
                                ext=ext, geo=geo, active=active)
    u1, v1, w1 = tu.clone(), tv.clone(), tw.clone()
    maxima = nf3.ns3d_post(tu, tv, tw, f, g, h, torch.from_numpy(p),
                           torch.from_numpy(dt), None, None, None, ext=ext,
                           geo=geo, active=active)
    # the JAX kernels on lane 0
    offs = jnp.zeros((3,), jnp.int32)
    jext = jnp.asarray([extents[0]], jnp.int32)
    jgeo = jnp.asarray(gm[:1, [sc.G3_DX, sc.G3_DY, sc.G3_DZ]])
    dt11 = jnp.full((1, 1), dt[0])
    outs = jpre(offs, jext, jgeo, dt11,
                *(pad3(jnp.asarray(a[0])) for a in (u, v, w)))
    ju, jv, jw, jf, jg, jh, jr = (np.asarray(unpad3(x)) for x in outs)
    live = _live(c, c, c, *extents[0])
    for ours, theirs in ((u1, ju), (v1, jv), (w1, jw)):
        # JAX writes +0 on the dead cells of its windows: the live corner
        assert np.array_equal(ours[0].numpy()[live], theirs[live]), problem
    for ours, theirs in ((f, jf), (g, jg), (h, jh), (rhs, jr)):
        assert _scaled(ours[0].numpy(), theirs) <= 1e-12, problem
        assert not ours[0].numpy()[~live].any()
    pu, pv, pw, *jmax = jpost(offs, jext, jgeo, dt11, *(
        pad3(jnp.asarray(x)) for x in (ju, jv, jw, jf, jg, jh, p[0])))
    for ours, theirs in ((tu, pu), (tv, pv), (tw, pw)):
        assert _scaled(ours[0].numpy(), np.asarray(unpad3(theirs))) <= 1e-12
        assert not ours[0].numpy()[~live].any()
    for m, field, theirs in zip(maxima, (tu, tv, tw), jmax):
        assert m.shape == (n,)
        # the maxima are bitwise the maxima of the fields they come with
        assert [float(x) for x in m] == [float(a.abs().max()) for a in field]
        assert abs(float(m[0]) - float(theirs)) <= 1e-12 * float(theirs)
    # the inactive lane passes through, its F, G, H, rhs 0
    for ours, before in ((tu, u), (tv, v), (tw, w)):
        assert np.array_equal(ours[2].numpy(), before[2])
    assert not any(x[2].any() for x in (f, g, h, rhs))
    assert not np.array_equal(tu[1].numpy(), u[1])


def test_class_solve_3d_matches_jax_jnp_solve():
    p = JParameter(**{**B3, "itermax": 6, "eps": 1e-30})  # itermax-capped
    c = 16
    grids = jsc._index_grids_3d(c, c, c)
    jsolve = jsc.make_class_solve_3d(p, c, c, c, jnp.float64, grids)
    extents = ((8, 8, 8), (8, 9, 10), (16, 16, 16))
    params = [_port(p.replace(kmax=k, jmax=j, imax=i)) for k, j, i in extents]
    gm = _gm(params)
    rng = np.random.default_rng(7)
    p0 = np.zeros((3, c + 2, c + 2, c + 2))
    rhs = np.zeros_like(p0)
    for k, e in enumerate(extents):
        live = _live(c, c, c, *e)
        p0[k] = np.where(live, rng.normal(size=live.shape), 0.0)
        rhs[k] = np.where(live, rng.normal(size=live.shape), 0.0)
    lanes = sc.class_lanes_3d(gm, c, c, c, torch.float64, "cpu")
    solve = sc.make_class_solve_3d(params[0], c, c, c, torch.float64)
    solving = np.array([True, True, False])  # the third lane passes through
    pp, res, it = solve(torch.from_numpy(p0), torch.from_numpy(rhs), lanes,
                        solving)
    for k, e in enumerate(extents[:2]):
        g = [jnp.asarray(x) for x in gm[k]]
        pj, resj, itj = jsolve(
            jnp.asarray(p0[k]), jnp.asarray(rhs[k]), g[sc.G3_KMAX],
            g[sc.G3_JMAX], g[sc.G3_IMAX], g[sc.G3_FACTOR], g[sc.G3_IDX2],
            g[sc.G3_IDY2], g[sc.G3_IDZ2], g[sc.G3_NORM])
        live = _live(c, c, c, *e)
        assert int(itj) == it[k] == 6
        ours = pp[k].numpy()
        assert _scaled(ours[live], np.asarray(pj)[live]) <= 1e-12
        assert np.array_equal(ours[~live], p0[k][~live])
        assert abs(res[k] - float(resj)) <= 1e-12 * abs(float(resj))
    assert torch.equal(pp[2], torch.from_numpy(p0[2])) and it[2] == 0
    assert solve.stats["rounds"] == 6


@pytest.mark.parametrize("extents", [((8, 8, 17),), ((0, 8, 8), (8, 8, 8))])
def test_class_lanes_3d_refuse_extents_outside_the_class(extents):
    fits = _gm([_port(JParameter(**B3))])
    gm = np.repeat(fits, len(extents), axis=0)
    gm[:, [sc.G3_KMAX, sc.G3_JMAX, sc.G3_IMAX]] = extents
    with pytest.raises(ValueError, match="do not fit the class 16x16x16"):
        sc.class_lanes_3d(gm, 16, 16, 16, torch.float64, "cpu")
    lanes = sc.class_lanes_3d(fits, 16, 16, 16, torch.float64, "cpu")
    assert lanes.dims.tolist() == [[8, 8, 8]]
    assert lanes.gather.shape == (1, 512) and bool(lanes.valid.all())


# ----------------------------------------------------------------------
# the class batch against JAX's
# ----------------------------------------------------------------------

def _jax_run(jparams, sids, c, monkeypatch, tmp_path):
    """JAX's Class3DSolver + BatchedSolver (its jnp chain on the CPU), one
    step a chunk, its flight recorder on: (results, [per step: each lane's
    iteration count, 0 where the lane did not step])."""
    monkeypatch.setenv("PAMPI_TELEMETRY", str(tmp_path / "jax.jsonl"))
    tpl = jsc.Class3DSolver(jparams[0], ic=c, jc=c, kc=c)
    assert not tpl._fused
    b = jfleet.BatchedSolver(tpl, jparams, sids, family="ns3d_class")
    assert b._metrics
    state = b.initial_state()
    te, steps = b.drive_te(), []
    while float(state[b._active_index + 1]) <= te:
        nt0 = np.asarray(state[5]).copy()
        state = b._chunk_fn(*state)
        m, nt = np.asarray(state[7]), np.asarray(state[5])
        steps.append([int(m[k, jtm.M_IT]) if nt[k] > nt0[k] else 0
                      for k in range(len(sids))])
    monkeypatch.delenv("PAMPI_TELEMETRY")
    return b.results(state), steps


def _port_run(params, sids, c):
    """The port's Class3DSolver + BatchedSolver on the CPU, chunk by chunk:
    (results, per-step iteration counts, the template)."""
    tpl = sc.Class3DSolver(params[0], ic=c, jc=c, kc=c, device="cpu")
    b = fleet.BatchedSolver(tpl, params, sids)
    state = b.initial_state()
    te, steps = b.drive_te(), []
    while float(state[b.slot(fleet.batch.T_DRIVE)]) <= te:
        state = b.chunk(state)
        steps.append([int(x) for x in tpl.last_iters])
    return b.results(state), steps, tpl


def _agree(ours, theirs, tol, c, param):
    assert ours["nt"] == theirs["nt"] > 0, ours["sid"]
    assert not ours["diverged"] and not theirs["diverged"]
    assert abs(ours["t"] - theirs["t"]) <= 1e-12 * abs(theirs["t"])
    for a, b in zip(ours["fields"], theirs["fields"]):
        assert a.shape == np.asarray(b).shape == (
            param.kmax + 2, param.jmax + 2, param.imax + 2)
        assert _scaled(a, b) <= tol, ours["sid"]


@pytest.fixture(scope="module")
def jax_batches(tmp_path_factory):
    """JAX's runs of the two f64 batches (dcavity3d d0, d1; canal3d c0),
    shared by the `auto` and `off` cases."""
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for sids in (("d0", "d1"), ("c0",)):
            jparams = [JParameter(**LANES[s]) for s in sids]
            out[sids] = (jparams, *_jax_run(
                jparams, list(sids), 16, mp, tmp_path_factory.mktemp("j")))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("knob", ["auto", "off"])
def test_class_3d_batch_matches_jax_f64(knob, jax_batches):
    for sids, (jparams, jres, jsteps) in jax_batches.items():
        params = [_port(q).replace(tpu_fuse_phases=knob) for q in jparams]
        res, steps, tpl = _port_run(params, list(sids), 16)
        assert steps == jsteps, (knob, sids)
        assert any(any(s) for s in steps)
        for ours, theirs, q in zip(res, jres, params):
            _agree(ours, theirs, F64_TOL, 16, q)
        assert tpl._fused == (knob == "auto")
    assert dispatch.last("ns3d_class_phases").startswith(
        "fused class chunk on cpu" if knob == "auto" else "plain torch chain")


def test_class_3d_batch_matches_jax_f32(monkeypatch, tmp_path):
    # eps 0: every solve runs to itermax, so no count can flip in f32
    sids = ["d0", "d1"]
    jparams = [JParameter(**{**LANES[s], "eps": 0.0, "itermax": 6,
                             "tpu_dtype": "float32"}) for s in sids]
    jres, jsteps = _jax_run(jparams, sids, 16, monkeypatch, tmp_path)
    params = [_port(q) for q in jparams]
    res, steps, _tpl = _port_run(params, sids, 16)
    assert steps == jsteps
    for ours, theirs, q in zip(res, jres, params):
        assert ours["fields"][0].dtype == np.float32
        _agree(ours, theirs, F32_TOL, 16, q)


@pytest.mark.parametrize("knob", ["auto", "off"])
def test_3d_lane_is_bitwise_in_every_rung(knob):
    base = [_port(JParameter(**LANES[s], tpu_fuse_phases=knob))
            for s in ("d0", "d1")]
    mate = base[0].replace(imax=29, jmax=17, kmax=31, u_init=0.02)
    small = _port_run(base, ["d0", "d1"], 16)[0]
    big = _port_run([base[1], mate, base[0]], ["d1", "m", "d0"], 32)[0]
    big = {r["sid"]: r for r in big}
    for r in small:
        other = big[r["sid"]]
        assert r["nt"] == other["nt"] and r["t"] == other["t"]
        for a, b in zip(r["fields"], other["fields"]):
            assert np.array_equal(a, b), (knob, r["sid"])


def test_jax_3d_state_carried_into_the_port():
    sids = ["d0", "d1"]
    jparams = [JParameter(**{**LANES[s], "tpu_chunk": 2, "te": 0.08})
               for s in sids]
    tpl = jsc.Class3DSolver(jparams[0], ic=16, jc=16, kc=16)
    b = jfleet.BatchedSolver(tpl, jparams, sids, family="ns3d_class")
    assert not b._metrics
    mid = b._chunk_fn(*b.initial_state())  # one chunk of 2 steps
    final = b.results(b.run())
    mid = [np.asarray(x) for x in mid]
    assert len(mid) == 11 and list(mid[5]) == [2, 2]
    params = [_port(q) for q in jparams]
    ours = sc.Class3DSolver(params[0], ic=16, jc=16, kc=16, device="cpu")
    pb = fleet.BatchedSolver.from_numpy_state(ours, params, sids, mid)
    for r, theirs, q in zip(pb.results(pb.run()), final, params):
        _agree(r, theirs, F64_TOL, 16, q)
    with pytest.raises(ValueError, match="has 11 slots, got 10"):
        fleet.BatchedSolver.from_numpy_state(ours, params, sids, mid[:10])


def test_scheduler_serves_3d_class_buckets():
    reqs = {"d0": LANES["d0"], "d1": LANES["d1"],
            "d2": dict(LANES["d0"], imax=20, jmax=12, kmax=9),
            "c0": dict(LANES["c0"], te=0.1)}
    out = {}
    for knob in ("on", "off"):
        sched = fleet.FleetScheduler(classes="on", device="cpu")
        for sid, kw in reqs.items():
            sched.submit_param(sid, _port(JParameter(
                **kw, tpu_fuse_phases=knob)))
        out[knob] = sched.run()
        rows = sorted((tuple(r["grid"]), r["lanes"], r["mode"])
                      for r in out[knob].summary["buckets"])
        # dcavity3d in the 16³ (two lanes) and 32x16x16 classes, canal3d
        # in the 16³ class (another signature)
        assert rows == [((16, 16, 16), 1, "class"), ((16, 16, 16), 2, "class"),
                        ((32, 16, 16), 1, "class")]
        label = out[knob].by_sid("d2").bucket
        assert dispatch.last(f"fleet_{label}").startswith(
            "class (padded 32x16x16, 1 lanes)")
    for sid in reqs:
        a, b = out["on"].by_sid(sid), out["off"].by_sid(sid)
        assert a.mode == "class" and a.nt == b.nt > 0 and not a.diverged
        for x, y in zip(a.fields, b.fields):
            assert np.array_equal(x, y), sid
