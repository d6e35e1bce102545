"""The port's fleet (pampi_tpu_torch/fleet/: queue, the 2-D mg shape-class
lane, the batched runner, the scheduler) against the JAX package's
(pampi_tpu/fleet/), on the CPU.

Contracts:
- bucketing: the same groups, grids, class/exact split and labels as the
  JAX package's bucket(..., classes=True); JAX's refusal strings where JAX
  refuses (a 3-D mg lane among them); a 2-D and a 3-D sor request class
  lanes, as in JAX;
- lane_geometry and ClassSolver.lane_state bitwise JAX's;
- an f64 mg class batch (dcavity and canal, mixed grids, mixed te) against
  JAX's ClassSolver + BatchedSolver
  with tpu_mg_fused "on" (the JAX package's `auto` runs its rb-sor loop off
  a TPU): nt equal, t within 1e-12 relative, fields within 1e-10 of scale
  (the NS slices' f64 contract: XLA contracts multiply-adds under jit, and
  the residual and pressure sums take other orders), cropped shapes
  equal; an f32 batch within 1e-5 of scale;
- padding invariance in the port: the same lanes in the 16² and the 32²
  rung, bitwise;
- a JAX mid-run state carried into the port (BatchedSolver.
  from_numpy_state) ends where JAX's run ends, within 1e-10 of scale;
- a NaN lane is retired with JAX's diverged flags and nt, its batchmates
  bitwise the batch without it;
- FleetScheduler(classes="on", device="cpu") per sid against JAX's on a
  mixed queue (mg class lanes and a sor class lane), and a Poisson request
  refused with JAX's message;
- a lane larger than its class is refused ("exceeds class").

The JAX oracles run once, in one JAX FleetScheduler run over every bucket
the cases need (a module fixture): its class templates and compiled
batches are reused by the later cases."""

import dataclasses

import numpy as np
import pytest

from pampi_tpu import fleet as jfleet
from pampi_tpu.fleet import scheduler as jsched
from pampi_tpu.fleet import shapeclass as jsc
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch import fleet
from pampi_tpu_torch.fleet import shapeclass as sc
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.params import parameter_from_dict

_MG = dict(tpu_mesh="1", tpu_solver="mg", tpu_mg_fused="on", tau=0.5,
           gamma=0.9)
DCAV = dict(_MG, name="dcavity", re=10.0, te=1.0, itermax=10, eps=1e-4,
            omg=1.7)
CANAL = dict(_MG, name="canal", re=100.0, te=0.6, itermax=20, eps=1e-5,
             omg=1.8, xlength=3.0, ylength=1.0, bcLeft=3, bcRight=3,
             bcTop=1, bcBottom=1)
# sid -> request: bucket A (dcavity, 16² class, chunks of 16 steps; a1
# starts from p_init 0.3, so the step-0 normalizePressure sums a live
# corner that is not 0), bucket B (canal, 32x16 class), bucket C (dcavity
# f32), and a sor request (a class lane in both packages)
QUEUE = {
    "a0": dict(DCAV, imax=12, jmax=12, te=0.4, tpu_chunk=16),
    "a1": dict(DCAV, imax=16, jmax=10, u_init=0.01, p_init=0.3, te=0.3,
               tpu_chunk=16),
    "a2": dict(DCAV, imax=9, jmax=13, te=0.2, tpu_chunk=16),
    "b0": dict(CANAL, imax=24, jmax=10),
    "b1": dict(CANAL, imax=30, jmax=12, te=0.4),
    "c0": dict(DCAV, imax=12, jmax=12, te=0.3, tpu_dtype="float32"),
    "c1": dict(DCAV, imax=14, jmax=11, te=0.2, tpu_dtype="float32"),
    "s0": dict(DCAV, imax=12, jmax=10, te=0.1, tpu_solver="sor",
               itermax=200),
}
F64_TOL, F32_TOL = 1e-10, 1e-5


def _port(jparam):
    return parameter_from_dict(dataclasses.asdict(jparam))


def _jreqs(sids):
    return [jfleet.ScenarioRequest(sid=s, param=JParameter(**QUEUE[s]))
            for s in sids]


def _reqs(sids):
    return [fleet.ScenarioRequest(sid=s, param=_port(JParameter(**QUEUE[s])))
            for s in sids]


@pytest.fixture(scope="module")
def jax_fleet():
    """JAX's FleetScheduler(classes="on") over the whole queue."""
    jsched.reset_templates()
    sched = jfleet.FleetScheduler(_jreqs(QUEUE), classes="on")
    result = sched.run()
    yield result
    jsched.reset_templates()


def _jax_batch(sid):
    """JAX's compiled class batch that served `sid` (the scheduler's
    cache), and its bucket key."""
    key = jfleet.class_bucket_key(JParameter(**QUEUE[sid]))
    for (sig, _n, mode, _te), b in jsched._BATCHES.items():
        if sig == key.sig and mode == "class":
            return b, key
    raise KeyError(sid)


def _run_port(sids, ic, jc, params=None):
    params = params or [_port(JParameter(**QUEUE[s])) for s in sids]
    tpl = sc.ClassSolver(params[0], ic=ic, jc=jc, device="cpu")
    b = fleet.BatchedSolver(tpl, params, sids)
    return {r["sid"]: r for r in b.results(b.run())}


def _agree(ours, theirs, tol):
    assert ours["nt"] == theirs.nt, (ours["sid"], ours["nt"], theirs.nt)
    assert ours["diverged"] == theirs.diverged
    assert abs(ours["t"] - theirs.t) <= 1e-12 * abs(theirs.t)
    assert len(ours["fields"]) == len(theirs.fields)
    for a, b in zip(ours["fields"], theirs.fields):
        b = np.asarray(b)
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() / scale <= tol, ours["sid"]


# ----------------------------------------------------------------------
# intake and bucketing
# ----------------------------------------------------------------------

def test_bucketing_matches_jax():
    extra = {
        "x_auto": dict(DCAV, imax=12, jmax=12, tpu_solver="auto"),
        "x_off": dict(DCAV, imax=12, jmax=12, tpu_mg_fused="off"),
        "x_obst": dict(DCAV, name="canal", imax=32, jmax=16,
                       obstacles="0.2,0.2,0.4,0.6"),
        "x_small": dict(DCAV, imax=6, jmax=12),
        "x_mesh": dict(DCAV, imax=12, jmax=12, tpu_mesh="2x2"),
        "x_3dmg": dict(DCAV, name="dcavity3d", imax=12, jmax=12, kmax=12),
        "x_3dsor": dict(DCAV, name="dcavity3d", imax=12, jmax=12, kmax=12,
                        tpu_solver="sor"),
        "x_big": dict(DCAV, imax=40, jmax=17),
    }
    queue = {**QUEUE, **extra}
    jreqs = [jfleet.ScenarioRequest(sid=s, param=JParameter(**kw))
             for s, kw in queue.items()]
    reqs = [fleet.ScenarioRequest(sid=s, param=_port(r.param))
            for s, r in zip(queue, jreqs)]
    jb = jfleet.bucket(jreqs, classes=True)
    ours = fleet.bucket(reqs, classes=True, ndevices=8)
    jgroups = {k.label: [r.sid for r in v] for k, v in jb.items()}
    groups = {k.label: [r.sid for r in v] for k, v in ours.items()}
    for label, sids in groups.items():
        assert jgroups[label] == sids, label
    for key, rs in ours.items():
        for r in rs:
            why = sc.class_eligible(r.param, ndevices=8)
            jwhy = jsc.class_eligible(
                next(j.param for j in jreqs if j.sid == r.sid))
            assert why == jwhy, r.sid
            assert key.sig.startswith("cls") == (why is None)
    assert ours_key(ours, "a0").grid == (16, 16)
    assert ours_key(ours, "b0").grid == (32, 16)
    assert ours_key(ours, "x_big").grid == (64, 32)
    for grid in ((9, 13), (40, 17), (64, 64)):
        assert sc.padding_waste(grid) == jsc.padding_waste(grid)
    # a 3-D sor request is a class lane, as in JAX; a 3-D mg one is not
    assert sc.class_eligible(_port(JParameter(**extra["x_3dsor"]))) is None
    assert ours_key(ours, "x_3dsor").grid == (16, 16, 16)
    assert ours_key(ours, "x_3dsor").sig.startswith("cls")
    assert sc.class_eligible(_port(JParameter(**extra["x_3dmg"]))) == (
        "3-D mg lane (the one-launch class cycle is 2-D)")
    assert sc.class_eligible(_port(JParameter(**QUEUE["s0"]))) is None
    assert ours_key(ours, "s0").sig.startswith("cls")
    last = dispatch.last(f"class_{ours_key(ours, 's0').label}")
    assert last.startswith("class (padded 16x16")
    # the signature hashes are the JAX package's (the same Parameter)
    p = JParameter(**QUEUE["a1"])
    assert fleet.signature_hash(_port(p)) == jfleet.signature_hash(p)
    assert sc.class_sig_hash(_port(p)) == jsc.class_sig_hash(p)


def ours_key(buckets, sid):
    return next(k for k, v in buckets.items() if any(r.sid == sid for r in v))


def test_family_and_queue_refusals(tmp_path):
    with pytest.raises(ValueError) as ours:
        fleet.family_of(_port(JParameter(name="poisson")))
    with pytest.raises(ValueError) as theirs:
        jfleet.family_of(JParameter(name="poisson"))
    assert str(ours.value) == str(theirs.value)
    good = tmp_path / "cav.par"
    good.write_text("name dcavity\nimax 12\njmax 12\n")
    bad = tmp_path / "pois.par"
    bad.write_text("name poisson\n")
    skipped = []
    reqs = fleet.load_queue([str(good), str(bad), str(good)],
                            on_error=lambda p, e: skipped.append(p))
    assert [r.sid for r in reqs] == ["cav", "cav#1"]
    assert skipped == [str(bad)]


def test_lane_geometry_and_lane_state_match_jax(jax_fleet):
    for sid in ("a0", "a1", "b1", "c1"):
        jp = JParameter(**QUEUE[sid])
        assert sc.lane_geometry(_port(jp)) == jsc.lane_geometry(jp)
        grid = jsc.class_grid((jp.imax, jp.jmax))
        jtpl = jsc.ClassSolver(jp, ic=grid[0], jc=grid[1])
        tpl = sc.ClassSolver(_port(jp), ic=grid[0], jc=grid[1],
                             device="cpu")
        for theirs, ours in zip(jtpl.lane_state(jp),
                                tpl.lane_state(_port(jp))):
            assert np.array_equal(ours.numpy(), np.asarray(theirs)), sid
            assert ours.numpy().dtype == np.asarray(theirs).dtype, sid
    rec = dispatch.last("mg_class_fused")
    assert rec.startswith("class cycle (forced; K18"), rec


# ----------------------------------------------------------------------
# the class batch against JAX's
# ----------------------------------------------------------------------

def test_mg_class_batch_matches_jax_f64(jax_fleet):
    ours = {**_run_port(["a0", "a1", "a2"], 16, 16),
            **_run_port(["b0", "b1"], 32, 16)}
    for sid in ("a0", "a1", "a2", "b0", "b1"):
        _agree(ours[sid], jax_fleet.by_sid(sid), F64_TOL)
    assert ours["a2"]["nt"] < ours["a1"]["nt"] < ours["a0"]["nt"]
    assert ours["b1"]["fields"][0].shape == (14, 32)


def test_mg_class_batch_matches_jax_f32(jax_fleet):
    ours = _run_port(["c0", "c1"], 16, 16)
    for sid in ("c0", "c1"):
        _agree(ours[sid], jax_fleet.by_sid(sid), F32_TOL)
        assert ours[sid]["fields"][0].dtype == np.float32


def test_rungs_are_bitwise_in_the_port():
    sids = ["a1", "a2"]
    small = _run_port(sids, 16, 16)
    big = _run_port(sids, 32, 32)
    for sid in sids:
        assert small[sid]["nt"] == big[sid]["nt"]
        assert small[sid]["t"] == big[sid]["t"]
        for a, b in zip(small[sid]["fields"], big[sid]["fields"]):
            assert np.array_equal(a, b), sid


def test_jax_state_carried_into_the_port(jax_fleet):
    jb, key = _jax_batch("a0")
    sids = ["a0", "a1", "a2"]
    jb.rebind([JParameter(**QUEUE[s]) for s in sids], sids)
    mid = jb._chunk_fn(*jb.initial_state())  # one chunk of 16 steps
    mid = [np.asarray(x) for x in mid]
    assert 0 < int(mid[4][0]) < jax_fleet.by_sid("a0").nt
    params = [_port(JParameter(**QUEUE[s])) for s in sids]
    tpl = sc.ClassSolver(params[0], ic=16, jc=16, device="cpu")
    b = fleet.BatchedSolver.from_numpy_state(tpl, params, sids, mid)
    for r in b.results(b.run()):
        _agree(r, jax_fleet.by_sid(r["sid"]), F64_TOL)


def test_nan_lane_is_retired_like_jax(jax_fleet):
    jb, _key = _jax_batch("c0")
    sids = ["c0", "c1"]
    jparams = [JParameter(**QUEUE[s]) for s in sids]
    jparams[1] = jparams[1].replace(u_init=float("nan"))
    jb.rebind(jparams, sids)
    jres = jb.results(jb.run())
    ours = _run_port(sids, 16, 16, [_port(p) for p in jparams])
    clean = _run_port(["c0"], 16, 16)["c0"]
    assert [r["diverged"] for r in jres] == [False, True]
    for r in jres:
        assert ours[r["sid"]]["diverged"] == r["diverged"]
        assert ours[r["sid"]]["nt"] == r["nt"]
        assert ours[r["sid"]]["t"] == pytest.approx(r["t"], rel=1e-12)
    assert ours["c0"]["nt"] == clean["nt"]
    for a, b in zip(ours["c0"]["fields"], clean["fields"]):
        assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# the scheduler
# ----------------------------------------------------------------------

def test_scheduler_matches_jax(jax_fleet):
    sched = fleet.FleetScheduler(_reqs(QUEUE), classes="on", device="cpu")
    result = sched.run()
    assert result.summary["n_scenarios"] == len(QUEUE)
    assert result.summary["divergence_census"]["diverged"] == 0
    assert result.summary["scenarios_per_s"] > 0
    modes = {r["bucket"]: r["mode"] for r in result.summary["buckets"]}
    assert sorted(modes.values()) == ["class", "class", "class", "class"]
    for s in result.scenarios:
        theirs = jax_fleet.by_sid(s.sid)
        tol = F32_TOL if s.sid.startswith("c") else F64_TOL
        _agree(dataclasses.asdict(s), theirs, tol)
        assert s.mode == "class"
        assert theirs.mode == "class"
    sor = result.by_sid("s0").bucket
    assert dispatch.last(f"fleet_{sor}").startswith("class (padded 16x16")
    # warm: a bucket again, fresh ids, served by the cached batch
    for s, kw in QUEUE.items():
        if s.startswith("c"):
            sched.submit_param(f"w{s}", _port(JParameter(**kw)))
    warm = sched.run()
    row = warm.summary["buckets"][0]
    assert row["template_cached"] and row["mode"] == "class"
    for s in ("c0", "c1"):
        w, cold = warm.by_sid(f"w{s}"), result.by_sid(s)
        assert w.nt == cold.nt
        for a, b in zip(w.fields, cold.fields):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="scenario fleet serves the NS"):
        fleet.FleetScheduler([fleet.ScenarioRequest(
            "p", _port(JParameter(name="poisson")))], device="cpu").run()
    with pytest.raises(NotImplementedError, match="ROADMAP A item 9"):
        fleet.FleetScheduler(lanes=4, device="cpu")


def test_exceeds_class_is_refused():
    p = _port(JParameter(**QUEUE["a0"]))
    with pytest.raises(ValueError, match="exceeds class"):
        sc.ClassSolver(p.replace(imax=20), ic=16, jc=16, device="cpu")
    tpl = sc.ClassSolver(p, ic=16, jc=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds class"):
        tpl.lane_state(p.replace(jmax=17))
    with pytest.raises(ValueError, match="not class-eligible"):
        tpl.lane_state(p.replace(tpu_solver="fft"))
