"""The port's sor shape-class lane (pampi_tpu_torch/fleet/shapeclass.py with
the dynamic-extent mode of K2 and the class mode of K3/K4) against the JAX
package's (pampi_tpu/fleet/shapeclass.py), on the CPU.

Contracts:
- K2's dynamic-extent mode, plain, against JAX's make_padded_class_solve
  (Pallas interpret mode) and make_class_solve, itermax-capped: counts
  equal, live cells within 1e-12 of scale, residual within 1e-12; dead
  cells and a lane that is not solving untouched;
- K3/K4's class mode, plain, against JAX's make_fused_pre_2d /
  make_fused_post_2d(dynamic=True) in interpret mode, dcavity and canal
  lanes: the boundary copies and the maxima bitwise, F, G, rhs and the
  projected fields within 1e-12 of scale, dead cells 0;
- a mixed sor class batch against JAX's ClassSolver + BatchedSolver under
  `tpu_fuse_phases` auto (JAX's jnp chain, cadence 1), on (its fused chunk
  in interpret mode, cadence tpu_sor_inner) and off, f64: each lane's steps
  and every step's iteration count equal (JAX's from its flight recorder,
  one step a chunk), fields within 1e-10 of scale, dead cells 0; an f32
  `on` batch with eps 0 (itermax-capped) within 1e-5 of scale;
- a lane bitwise the same in the 16² and 32² classes, whatever its
  batchmates; a JAX sor class batch state continued in the port
  (BatchedSolver.from_numpy_state);
- class_cadence at its five (knob, dtype) points; class_lanes refuses a
  lane whose extents do not fit its class."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu import fleet as jfleet
from pampi_tpu.fleet import shapeclass as jsc
from pampi_tpu.ops import ns2d_fused as jnf
from pampi_tpu.ops.sor_pallas import pad_array, unpad_array
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch import fleet
from pampi_tpu_torch.fleet import shapeclass as sc
from pampi_tpu_torch.ops import ns2d_fused as nf
from pampi_tpu_torch.ops import sor_kernels as sk
from pampi_tpu_torch.utils import dispatch
from pampi_tpu_torch.utils.params import parameter_from_dict

SOR = dict(tpu_mesh="1", tpu_solver="sor", tau=0.5, gamma=0.9,
           tpu_chunk=1)
DCAV = dict(SOR, name="dcavity", re=10.0, te=0.02, itermax=40, eps=1e-4,
            omg=1.7)
CANAL = dict(SOR, name="canal", re=100.0, te=0.03, itermax=40, eps=1e-5,
             omg=1.8, xlength=3.0, ylength=1.0, bcLeft=3, bcRight=3,
             bcTop=1, bcBottom=1)
# the mixed batch: two dcavity lanes and a canal lane in the 16² class
LANES = {"d0": dict(DCAV, imax=12, jmax=10),
         "d1": dict(DCAV, imax=14, jmax=9, u_init=0.01, p_init=0.2),
         "c0": dict(CANAL, imax=14, jmax=9)}
F64_TOL, F32_TOL = 1e-10, 1e-5


def _port(jparam):
    return parameter_from_dict(dataclasses.asdict(jparam))


def _scaled(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max()) / max(
        1.0, float(np.abs(b).max()))


def _live(jc, ic, jmax, imax):
    return ((np.arange(jc + 2)[:, None] <= jmax + 1)
            & (np.arange(ic + 2)[None, :] <= imax + 1))


# ----------------------------------------------------------------------
# the kernels' plain versions against JAX's kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_inner", [1, 3])
def test_class_k2_plain_matches_jax_padded_and_jnp_solves(n_inner):
    p = JParameter(**{**DCAV, "tpu_sor_inner": n_inner, "itermax": 6,
                      "eps": 1e-30})  # itermax-capped: every solve runs 6
    jc = ic = 16
    grids = jsc._index_grids(jc, ic)
    jnp_solve = jsc.make_class_solve(p, jc, ic, jnp.float64, grids)
    pal_solve, br, h = jsc.make_padded_class_solve(p, jc, ic, jnp.float64)
    rng = np.random.default_rng(7)
    extents = ((12, 12), (10, 14))
    p0 = np.zeros((3, jc + 2, ic + 2))
    rhs = np.zeros_like(p0)
    for k, (jmax, imax) in enumerate(extents + ((16, 16),)):
        live = _live(jc, ic, jmax, imax)
        p0[k] = np.where(live, rng.normal(size=live.shape), 0.0)
        rhs[k] = np.where(live, rng.normal(size=live.shape), 0.0)
    params = [_port(p.replace(imax=i, jmax=j))
              for j, i in extents + ((16, 16),)]
    gm = np.array([sc.lane_geometry(q) for q in params])
    lanes = sc.class_lanes(gm, jc, ic, torch.float64, "cpu")
    solving = np.array([True, True, False])  # the third lane passes through
    pad_solve = sc.make_padded_class_solve(params[0], jc, ic, torch.float64,
                                           n_inner)
    pp, res_p, it_p = pad_solve(torch.from_numpy(p0.copy()),
                                torch.from_numpy(rhs), lanes, solving)
    for k, (jmax, imax) in enumerate(extents):
        g = [jnp.asarray(x) for x in gm[k]]
        pj, resj, itj = jnp_solve(jnp.asarray(p0[k]), jnp.asarray(rhs[k]),
                                  g[0], g[1], g[5], g[6], g[7], g[8])
        ext = jnp.asarray([[jmax, imax]], jnp.int32)
        sgeo = jnp.asarray([[gm[k, 5], gm[k, 6], gm[k, 7]]])
        pk, resk, itk = pal_solve(pad_array(jnp.asarray(p0[k]), br, h),
                                  pad_array(jnp.asarray(rhs[k]), br, h),
                                  ext, sgeo, g[8])
        pk = np.asarray(unpad_array(pk, jc, ic, h))
        live = _live(jc, ic, jmax, imax)
        assert int(itj) == int(itk) == it_p[k] == 6
        ours = pp[k].numpy()
        assert _scaled(ours[live], pk[live]) <= 1e-12
        assert _scaled(ours[live], np.asarray(pj)[live]) <= 1e-12
        assert np.array_equal(ours[~live], p0[k][~live])
        for theirs in (resj, resk):
            assert abs(res_p[k] - float(theirs)) <= 1e-12 * max(
                1.0, abs(float(theirs)))
    assert torch.equal(pp[2], torch.from_numpy(p0[2]))
    assert it_p[2] == 0


def test_class_k2_kernel_call_repeats_its_plain_version_on_cpu():
    # the wrapper on a CPU tensor is the plain version; `out` leaves p be
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.normal(size=(2, 18, 34)))
    rhs = torch.from_numpy(rng.normal(size=(2, 18, 34)))
    ext = torch.tensor([[16, 32], [9, 13]], dtype=torch.int32)
    geo = torch.tensor([[0.4, 2.0, 3.0], [0.3, 1.0, 1.5]],
                       dtype=torch.float64)
    solving = torch.tensor([True, True])
    out = torch.empty_like(p)
    res = sk.rb_sor_class(p, rhs, 2, ext, geo, solving, out=out)
    q = p.clone()
    ref = sk.rb_sor_class_plain(q, rhs, 2, ext, geo, solving)
    assert torch.equal(out, q) and torch.equal(res, ref)
    assert not torch.equal(out, p)



@pytest.mark.parametrize("extents", [((12, 17), (10, 10)), ((17, 12),),
                                     ((0, 12),)])
def test_class_lanes_refuse_extents_outside_the_class(extents):
    # the class kernels read each lane's extents on the card unchecked: a
    # lane past its (jc, ic) block is refused on the host, with the sizes
    fits = np.array([sc.lane_geometry(_port(JParameter(**DCAV, imax=16,
                                                       jmax=16)))])
    gm = np.repeat(fits, len(extents), axis=0)
    gm[:, [sc.G_JMAX, sc.G_IMAX]] = extents
    with pytest.raises(ValueError, match="do not fit the class 16x16"):
        sc.class_lanes(gm, 16, 16, torch.float64, "cpu")
    lanes = sc.class_lanes(fits, 16, 16, torch.float64, "cpu")
    assert lanes.dims.tolist() == [[16, 16]] and lanes.mg_ext is None

def _jax_phase_kernels(param, jc, ic):
    pre, pad, unpad, _h = jnf.make_fused_pre_2d(
        param, jc, ic, 1.0, 1.0, jnp.float64, dynamic=True)
    post, _p, _u, _h2 = jnf.make_fused_post_2d(
        param, jc, ic, 1.0, 1.0, jnp.float64, ragged=True, dynamic=True)
    return pre, post, pad, unpad


@pytest.mark.parametrize("problem", ["dcavity", "canal"])
def test_class_k3_k4_plain_match_jax_dynamic_kernels(problem):
    base = DCAV if problem == "dcavity" else CANAL
    jc = ic = 16
    extents = ((12, 10), (9, 14), (16, 16))
    params = [_port(JParameter(**base, imax=i, jmax=j)) for j, i in extents]
    jpre, jpost, pad, unpad = _jax_phase_kernels(
        JParameter(**base, imax=ic, jmax=jc), jc, ic)
    rng = np.random.default_rng(11)
    n = len(extents)
    u, v, p = (np.zeros((n, jc + 2, ic + 2)) for _ in range(3))
    for k, (jmax, imax) in enumerate(extents):
        live = _live(jc, ic, jmax, imax)
        for a in (u, v, p):
            a[k] = np.where(live, rng.normal(size=live.shape), 0.0)
    dt = np.array([0.013, 0.021, 0.017])
    gm = np.array([sc.lane_geometry(q) for q in params])
    ext = torch.tensor([[j, i] for j, i in extents], dtype=torch.int32)
    geo = torch.from_numpy(gm[:, [sc.G_DX, sc.G_DY]].copy())
    active = torch.ones(n, dtype=torch.bool)
    cfg = nf.StepConfig.from_param(params[0])
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    f, g, rhs = nf.ns2d_pre(tu, tv, torch.from_numpy(dt), cfg, ext=ext,
                            geo=geo, active=active)
    u1, v1 = tu.clone(), tv.clone()
    umax, vmax = nf.ns2d_post(tu, tv, f, g, torch.from_numpy(p),
                              torch.from_numpy(dt), None, None, ext=ext,
                              geo=geo, active=active)
    offs = jnp.zeros((2,), jnp.int32)
    for k, (jmax, imax) in enumerate(extents):
        jext = jnp.asarray([[jmax, imax]], jnp.int32)
        jgeo = jnp.asarray([[gm[k, sc.G_DX], gm[k, sc.G_DY]]])
        dt11 = jnp.full((1, 1), dt[k])
        outs = jpre(offs, jext, jgeo, dt11, pad(jnp.asarray(u[k])),
                    pad(jnp.asarray(v[k])))
        ju, jv, jf, jg, jr = (np.asarray(unpad(x)) for x in outs)
        assert np.array_equal(u1[k].numpy(), ju), (problem, k)
        assert np.array_equal(v1[k].numpy(), jv), (problem, k)
        for ours, theirs in ((f, jf), (g, jg), (rhs, jr)):
            assert _scaled(ours[k].numpy(), theirs) <= 1e-12, (problem, k)
        pu, pv, pum, pvm = jpost(
            offs, jext, jgeo, dt11, *(pad(jnp.asarray(x)) for x in (
                ju, jv, jf, jg, p[k])))
        pu, pv = np.asarray(unpad(pu)), np.asarray(unpad(pv))
        dead = ~_live(jc, ic, jmax, imax)
        for ours, theirs in ((tu, pu), (tv, pv)):
            assert _scaled(ours[k].numpy(), theirs) <= 1e-12
            assert not ours[k].numpy()[dead].any()
        # the maxima are bitwise the maxima of the fields they come with
        assert float(umax[k]) == float(tu[k].abs().max())
        assert float(vmax[k]) == float(tv[k].abs().max())
        assert abs(float(umax[k]) - float(pum)) <= 1e-12 * float(pum)
        assert abs(float(vmax[k]) - float(pvm)) <= 1e-12 * float(pvm)


def test_class_k3_k4_leave_inactive_lanes_be():
    params = [_port(JParameter(**DCAV, imax=12, jmax=10))] * 2
    rng = np.random.default_rng(5)
    u, v, p = (torch.from_numpy(rng.normal(size=(2, 18, 18)))
               for _ in range(3))
    gm = np.array([sc.lane_geometry(q) for q in params])
    ext = torch.tensor([[10, 12]] * 2, dtype=torch.int32)
    geo = torch.from_numpy(gm[:, [sc.G_DX, sc.G_DY]].copy())
    dt = torch.tensor([0.01, 0.01], dtype=torch.float64)
    active = torch.tensor([True, False])
    cfg = nf.StepConfig.from_param(params[0])
    u0, v0 = u.clone(), v.clone()
    f, g, rhs = nf.ns2d_pre(u, v, dt, cfg, ext=ext, geo=geo, active=active)
    assert torch.equal(u[1], u0[1]) and torch.equal(v[1], v0[1])
    assert not (f[1].any() or g[1].any() or rhs[1].any())
    assert not torch.equal(u[0], u0[0])
    u1, v1 = u.clone(), v.clone()
    nf.ns2d_post(u, v, f, g, p, dt, None, None, ext=ext, geo=geo,
                 active=active)
    assert torch.equal(u[1], u1[1]) and torch.equal(v[1], v1[1])


# ----------------------------------------------------------------------
# the class batch against JAX's
# ----------------------------------------------------------------------

def _jax_run(jparams, sids, ic, jc, monkeypatch, tmp_path):
    """JAX's ClassSolver + BatchedSolver, one step a chunk, its flight
    recorder on: (results, [per step: each lane's iteration count, 0 where
    the lane did not step], the chunk's dispatch record)."""
    monkeypatch.setenv("PAMPI_TELEMETRY", str(tmp_path / "jax.jsonl"))
    from pampi_tpu.utils import dispatch as jdispatch

    tpl = jsc.ClassSolver(jparams[0], ic=ic, jc=jc)
    b = jfleet.BatchedSolver(tpl, jparams, sids, family="ns2d_class")
    assert b._metrics
    state = b.initial_state()
    te, steps = b.drive_te(), []
    while float(state[b._active_index + 1]) <= te:
        nt0 = np.asarray(state[4]).copy()
        state = b._chunk_fn(*state)
        m, nt = np.asarray(state[6]), np.asarray(state[4])
        steps.append([int(m[k, 1]) if nt[k] > nt0[k] else 0
                      for k in range(len(sids))])
    monkeypatch.delenv("PAMPI_TELEMETRY")
    return b.results(state), steps, jdispatch.last("ns2d_class_phases")


def _port_run(params, sids, ic, jc):
    """The port's ClassSolver + BatchedSolver on the CPU, chunk by chunk:
    (results, per-step iteration counts, the template)."""
    tpl = sc.ClassSolver(params[0], ic=ic, jc=jc, device="cpu")
    b = fleet.BatchedSolver(tpl, params, sids)
    state = b.initial_state()
    te, steps = b.drive_te(), []
    while float(state[8]) <= te:
        state = b.chunk(state)
        steps.append([int(x) for x in tpl.last_iters])
    return b.results(state), steps, tpl


def _agree(ours, theirs, tol, jc, ic, param):
    assert ours["nt"] == theirs["nt"] > 0, ours["sid"]
    assert not ours["diverged"] and not theirs["diverged"]
    assert abs(ours["t"] - theirs["t"]) <= 1e-12 * abs(theirs["t"])
    for a, b in zip(ours["fields"], theirs["fields"]):
        assert a.shape == np.asarray(b).shape == (param.jmax + 2,
                                                  param.imax + 2)
        assert _scaled(a, b) <= tol, ours["sid"]


@pytest.mark.parametrize("knob", ["auto", "on", "off"])
def test_sor_class_batch_matches_jax_f64(knob, monkeypatch, tmp_path):
    for sids in (["d0", "d1"], ["c0"]):
        jparams = [JParameter(**LANES[s], tpu_fuse_phases=knob)
                   for s in sids]
        jres, jsteps, jphases = _jax_run(jparams, sids, 16, 16, monkeypatch,
                                         tmp_path)
        params = [_port(q) for q in jparams]
        res, steps, tpl = _port_run(params, sids, 16, 16)
        assert steps == jsteps, (knob, sids)
        assert any(any(s) for s in steps)
        for ours, theirs, q in zip(res, jres, params):
            _agree(ours, theirs, F64_TOL, 16, 16, q)
        assert tpl._fused == (knob != "off")
        assert jphases.startswith("pallas" if knob == "on" else "jnp")
    n = params[0].tpu_sor_inner if knob == "on" else 1
    assert dispatch.last("ns2d_class_solve") == (
        f"padded class solve (K2's dynamic-extent mode, n_inner={n})")


def test_sor_class_batch_matches_jax_f32_on(monkeypatch, tmp_path):
    # eps 0: every solve runs to itermax, so no count can flip in f32
    sids = ["d0", "d1"]
    jparams = [JParameter(**{**LANES[s], "eps": 0.0, "itermax": 8,
                             "tpu_dtype": "float32",
                             "tpu_fuse_phases": "on"}) for s in sids]
    jres, jsteps, _ = _jax_run(jparams, sids, 16, 16, monkeypatch, tmp_path)
    params = [_port(q) for q in jparams]
    res, steps, _tpl = _port_run(params, sids, 16, 16)
    assert steps == jsteps
    for ours, theirs, q in zip(res, jres, params):
        assert ours["fields"][0].dtype == np.float32
        _agree(ours, theirs, F32_TOL, 16, 16, q)


@pytest.mark.parametrize("knob", ["auto", "on"])
def test_sor_lane_is_bitwise_in_every_rung(knob):
    base = [_port(JParameter(**LANES[s], tpu_fuse_phases=knob))
            for s in ("d0", "d1")]
    mate = base[0].replace(imax=29, jmax=31, u_init=0.02)
    small = _port_run(base, ["d0", "d1"], 16, 16)[0]
    big = _port_run([base[1], mate, base[0]], ["d1", "m", "d0"], 32, 32)[0]
    big = {r["sid"]: r for r in big}
    for r in small:
        other = big[r["sid"]]
        assert r["nt"] == other["nt"] and r["t"] == other["t"]
        for a, b in zip(r["fields"], other["fields"]):
            assert np.array_equal(a, b), (knob, r["sid"])


def test_jax_sor_state_carried_into_the_port():
    sids = ["d0", "d1"]
    jparams = [JParameter(**{**LANES[s], "tpu_chunk": 2, "te": 0.03})
               for s in sids]
    tpl = jsc.ClassSolver(jparams[0], ic=16, jc=16)
    b = jfleet.BatchedSolver(tpl, jparams, sids, family="ns2d_class")
    assert not b._metrics
    mid = b._chunk_fn(*b.initial_state())  # one chunk of 2 steps
    final = b.results(b.run())
    mid = [np.asarray(x) for x in mid]
    assert list(mid[4]) == [2, 2]
    params = [_port(q) for q in jparams]
    ours = sc.ClassSolver(params[0], ic=16, jc=16, device="cpu")
    pb = fleet.BatchedSolver.from_numpy_state(ours, params, sids, mid)
    for r, theirs, q in zip(pb.results(pb.run()), final, params):
        _agree(r, theirs, F64_TOL, 16, 16, q)


def test_class_cadence_points():
    p = _port(JParameter(**DCAV, tpu_sor_inner=4))
    f32, f64 = torch.float32, torch.float64
    cases = {("on", f32): 4, ("on", f64): 4, ("auto", f32): 4,
             ("auto", f64): 1, ("off", f32): 1}
    for (knob, dtype), n in cases.items():
        assert sc.class_cadence(p.replace(tpu_fuse_phases=knob), dtype) == n
    assert sc.class_cadence(p.replace(tpu_fuse_phases="off"), f64) == 1
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        sc.class_cadence(p.replace(tpu_fuse_phases="yes"), f64)
