"""Shape-class batching: mixed-grid requests padded into shared class
blocks (counterpart of the 2-D part of pampi_tpu/fleet/shapeclass.py).

A class is a rung of a ladder, the next power of two per axis with a
floor of RUNG_FLOOR. Every lane of a class batch holds a (jc+2, ic+2)
block whose live corner is its own (jmax+2, imax+2) grid; the dead cells
hold exact 0 and stay out of every reduction. The lane's grid extents
and every grid-derived constant (dx, dy, the CFL bound, the SOR factor,
idx2, idy2, the residual norm) are per-lane data, computed on the host in
Python float64 with the solo solver's expressions (`lane_geometry`, the
G_* slots).

Two chunks step a class batch, as in the JAX package:

- the masked phase chain (`make_class_chunk`): the CFL dt per lane, the
  wall and special BCs, F/G and their fixups, the rhs, normalizePressure
  every 100 steps over the live corner, the solve, the projection and
  the live-mask multiply, in plain torch over the lane-stacked blocks.
  The solve of a `tpu_solver mg` lane is the one-launch class V-cycle,
  K18 (`ops/mg_fused.class_cycle`, `make_class_mg_solve`); that of a sor
  lane under `tpu_fuse_phases off` the padded class solve below at one
  iteration a residual check (the cadence of the JAX package's masked jnp
  loop there);
- the fused class chunk of a sor lane (`make_fused_class_chunk`, under
  `tpu_fuse_phases auto|on`): a step is one call of the class mode of K3
  (PRE), normalizePressure every 100 steps, the padded class solve on the
  dynamic-extent mode of K2 (`make_padded_class_solve`, `class_cadence`
  iterations a call and a residual check, one (N,) read-back a round for
  the whole batch) and one call of the class mode of K4 (POST, which also
  gives the next step's CFL maxima), for all lanes of the batch at once.

A lane stops solving when its residual is under eps² or its count has
reached itermax, and the lanes still solving go on: each lane's count and
fields are its solo's (the JAX package's vmapped while_loop). Every
per-lane reduction takes a fixed order that depends on the lane's live
extents only (K18's residual, K2's class-mode residual, the live-corner
sum of normalizePressure), so a lane's fields are bitwise the same in
every rung and whatever its batchmates are.

What stays the JAX package's alone (ROADMAP A item 9.2): the 3-D class
rungs (`Class3DSolver`, the dynamic-extent K7/K8). class_eligible keeps
such requests in their exact-shape buckets with a reason naming that
item.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from ..ops import mg_fused as mf
from ..ops import ns2d as ops
from ..ops import ns2d_fused as nf
from ..ops import sor_kernels as sk
from ..ops.sor_kernels import _tree
from ..parallel import ragged2d as rg
from ..utils import dispatch as _dispatch
from ..utils.device import resolve_device, visible_devices
from ..utils.params import is_3d_config
from ..utils.precision import resolve_dtype

RUNG_FLOOR = 16
# smallest per-axis live extent a class takes: below it the padding waste
# could exceed WASTE_BOUND, so such requests keep their exact-shape bucket
MIN_CLASS_EXTENT = 8
WASTE_BOUND = 4.0

# geometry-vector slots (per lane, float64)
G_IMAX, G_JMAX, G_DX, G_DY, G_DTB, G_FACTOR, G_IDX2, G_IDY2, G_NORM = \
    range(9)

# the class signature also leaves out the grid extents (per-lane data)
CLASS_KEYS = ("imax", "jmax", "kmax")

# the port's own refusal, naming the ROADMAP item that brings it
LANE_3D = ("3-D class rung (Class3DSolver and the dynamic-extent modes of "
           "K7/K8 are not yet ported, ROADMAP A item 9.2)")


def class_extent(n: int) -> int:
    """The rung of one live extent: next power of two, >= RUNG_FLOOR."""
    c = RUNG_FLOOR
    while c < n:
        c *= 2
    return c


def class_grid(grid) -> tuple:
    return tuple(class_extent(int(n)) for n in grid)


def padding_waste(grid) -> float:
    """Padded cells / live cells, ghost rings included."""
    padded = live = 1.0
    for n, c in zip(grid, class_grid(grid)):
        padded *= c + 2
        live *= n + 2
    return padded / live


def _jax_reason(param, ndevices: int) -> str | None:
    """The JAX package's class_eligible, its order and its strings; the
    mesh rule reads `ndevices` visible devices (the CLI's mesh_is_single)."""
    if param.obstacles.strip():
        return "obstacle flags are trace-baked geometry"
    if param.tpu_solver not in ("sor", "mg"):
        return (f"tpu_solver {param.tpu_solver} (class solves are rb-sor "
                "and the one-launch mg cycle)")
    if param.tpu_solver == "mg":
        if is_3d_config(param):
            return "3-D mg lane (the one-launch class cycle is 2-D)"
        if param.tpu_mg_fused == "off":
            return ("tpu_mg_fused off (the mg class solve IS the fused "
                    "cycle kernel)")
    if param.tpu_sor_layout not in ("auto", "checkerboard"):
        return (f"tpu_sor_layout {param.tpu_sor_layout} forced (the "
                "class solve is the checkerboard padded layout)")
    if param.tpu_flat_solve:
        return "tpu_flat_solve trips are extent-derived"
    if not _dispatch.mesh_is_single(param.tpu_mesh, ndevices):
        return "distributed lane (whole-mesh shards are shape-baked)"
    if param.tpu_fleet not in ("auto", "vmap"):
        return f"tpu_fleet {param.tpu_fleet} forced"
    extents = ((param.imax, param.jmax, param.kmax)
               if is_3d_config(param) else (param.imax, param.jmax))
    if any(n < MIN_CLASS_EXTENT for n in extents):
        return (f"grid {'x'.join(str(n) for n in extents)} below the "
                f"{MIN_CLASS_EXTENT}-cell class floor (padding waste "
                "would exceed the bound)")
    return None


def class_eligible(param, ndevices: int = 1) -> str | None:
    """None when the request may ride a class; else why it keeps its
    exact-shape bucket: the JAX package's reason where it refuses, else
    the port's (a 3-D lane). `ndevices` is the visible device count (the
    JAX package reads jax.devices())."""
    why = _jax_reason(param, ndevices)
    if why is None and is_3d_config(param):
        return LANE_3D
    return why


def class_cadence(param, dtype) -> int:
    """Red-black iterations between two residual checks of a sor class
    lane: the number the JAX package's ClassSolver takes on a TPU for the
    same `tpu_fuse_phases` and dtype (the rule utils/dispatch.sor_cadence
    applies to solo solves). `on` forces its fused chunk, whose padded
    class solve checks every `tpu_sor_inner` iterations at any dtype;
    `auto` takes the fused chunk where Mosaic lowers the dtype (at most 4
    bytes: `tpu_sor_inner`) and otherwise records "jnp (dtype not
    Mosaic-lowerable)" and runs its masked jnp loop, which checks every
    iteration (float64: 1); `off` is that jnp chain (1)."""
    knob = param.tpu_fuse_phases
    if knob not in ("auto", "on", "off"):
        raise ValueError(f"tpu_fuse_phases must be auto|on|off, got {knob!r}")
    if knob == "off" or (knob == "auto" and dtype.itemsize > 4):
        return 1
    return max(1, param.tpu_sor_inner)


def class_signature(param) -> str:
    """The queue's knob signature minus the per-lane grid extents, plus
    the rung (two rungs never share a program)."""
    from . import queue as _q

    skip = set(_q.LANE_KEYS) | set(_q.HOUSEKEEPING_KEYS) \
        | set(_q.PER_LANE_KEYS) | set(CLASS_KEYS)
    parts = [f"{f.name}={getattr(param, f.name)!r}"
             for f in dataclasses.fields(type(param)) if f.name not in skip]
    extents = ((param.imax, param.jmax, param.kmax)
               if is_3d_config(param) else (param.imax, param.jmax))
    parts.append("rung=" + "x".join(str(c) for c in class_grid(extents)))
    return "|".join(parts)


def class_sig_hash(param) -> str:
    return "cls" + hashlib.sha1(
        class_signature(param).encode()).hexdigest()[:12]


def lane_geometry(param):
    """The per-lane geometry scalars in Python float64, with the solo
    solver's expressions (the JAX package's lane_geometry)."""
    dx = param.xlength / param.imax
    dy = param.ylength / param.jmax
    inv_sqr_sum = 1.0 / (dx * dx) + 1.0 / (dy * dy)
    dt_bound = 0.5 * param.re / inv_sqr_sum
    dx2, dy2 = dx * dx, dy * dy
    factor = param.omg * 0.5 * (dx2 * dy2) / (dx2 + dy2)
    idx2, idy2 = 1.0 / dx2, 1.0 / dy2
    norm = float(param.imax * param.jmax)
    return (float(param.imax), float(param.jmax), dx, dy, dt_bound,
            factor, idx2, idy2, norm)


@dataclasses.dataclass
class Lanes:
    """The per-lane constants of a batch, derived once from its (N, 9)
    float64 geometry vectors: the kernels' per-lane arrays, dims (N, 2)
    int32 (jmax, imax), cell (N, 2) (dx, dy) and sor_geo (N, 3) (factor,
    idx2, idy2) in the lane dtype (jmax, imax, dx, dy are their (N, 1, 1)
    views); the CFL bound; the interior and live masks; the
    normalizePressure count and gather plan; and, for mg lanes only, K18's
    stacked level plans (mg_ext, mg_geo)."""

    dims: torch.Tensor
    cell: torch.Tensor
    sor_geo: torch.Tensor
    dtb: torch.Tensor
    interior: torch.Tensor
    live: torch.Tensor
    cnt: torch.Tensor
    gather: torch.Tensor
    valid: torch.Tensor
    norm: np.ndarray
    mg_ext: torch.Tensor | None = None
    mg_geo: torch.Tensor | None = None

    @property
    def jmax(self):
        return self.dims[:, 0, None, None]

    @property
    def imax(self):
        return self.dims[:, 1, None, None]

    @property
    def dx(self):
        return self.cell[:, 0, None, None]

    @property
    def dy(self):
        return self.cell[:, 1, None, None]


def class_lanes(gm, jc: int, ic: int, dtype, device, mg: bool = False
                ) -> Lanes:
    """Lanes of a batch from its geometry vectors `gm` (numpy (N, 9)), with
    K18's level plans when `mg`. Every lane's extents must fit the (jc, ic)
    class: the kernels read them on the card unchecked."""
    gm = np.asarray(gm, np.float64)
    n = gm.shape[0]
    real = mf._REAL[dtype]
    ext = gm[:, [G_JMAX, G_IMAX]]
    if ((ext < 1) | (ext > (jc, ic))).any():
        raise ValueError(f"lane extents {ext.astype(int).tolist()} do not "
                         f"fit the class {ic}x{jc}")
    gj, gi = rg.class_index_grids(jc, ic, device)

    def lane_array(slots, to):
        return torch.from_numpy(np.ascontiguousarray(
            gm[:, slots].astype(to))).to(device)

    dims = lane_array([G_JMAX, G_IMAX], np.int32)
    jmax, imax = dims[:, 0, None, None], dims[:, 1, None, None]
    # normalizePressure's sum: each lane's live corner in row-major order,
    # in the fixed order of K18's residual (thread t of CLASS_THREADS adds
    # t, t + T, ...), so the mean depends on the lane's extents only
    sizes = [(int(j) + 2, int(i) + 2) for j, i in ext]
    t = mf.CLASS_THREADS
    width = -(-max(a * b for a, b in sizes) // t) * t
    gather = np.zeros((n, width), np.int64)
    valid = np.zeros((n, width), bool)
    for lane, (rows, cols) in enumerate(sizes):
        flat = (np.arange(rows)[:, None] * (ic + 2)
                + np.arange(cols)[None, :]).reshape(-1)
        gather[lane, :flat.size] = flat
        valid[lane, :flat.size] = True
    mg_ext = mg_geo = None
    if mg:
        lmax = mf.class_level_max(jc, ic)
        plans = [mf.class_level_plan(int(g[G_JMAX]), int(g[G_IMAX]),
                                     g[G_IDX2], g[G_IDY2], lmax, dtype)
                 for g in gm]
        mg_ext = torch.stack([e for e, _ in plans]).to(device)
        mg_geo = torch.stack([g for _, g in plans]).to(device)
    return Lanes(
        dims=dims, cell=lane_array([G_DX, G_DY], real),
        sor_geo=lane_array([G_FACTOR, G_IDX2, G_IDY2], real),
        dtb=lane_array([G_DTB], real).view(n, 1, 1),
        interior=(gj >= 1) & (gj <= jmax) & (gi >= 1) & (gi <= imax),
        live=(gj <= jmax + 1) & (gi <= imax + 1),
        cnt=torch.from_numpy((ext[:, 0] + 2.0) * (ext[:, 1] + 2.0)).to(
            device=device, dtype=dtype).view(n, 1, 1),
        gather=torch.from_numpy(gather).to(device),
        valid=torch.from_numpy(valid).to(device),
        norm=gm[:, G_NORM].astype(real), mg_ext=mg_ext, mg_geo=mg_geo)


def live_sum(q, lanes: Lanes):
    """Each lane's sum over its live corner in the fixed order (N, 1, 1):
    the corner's cells in row-major order, thread t of CLASS_THREADS adding
    t, t + T, ... in turn, then a halving tree."""
    n, t = q.shape[0], mf.CLASS_THREADS
    vals = torch.where(lanes.valid, q.reshape(n, -1).gather(1, lanes.gather),
                       torch.zeros((), dtype=q.dtype, device=q.device))
    vals = vals.view(n, -1, t)
    s = torch.zeros((n, t), dtype=q.dtype, device=q.device)
    for r in range(vals.shape[1]):
        s = s + vals[:, r]
    return _tree(s)[..., 0].view(n, 1, 1)


def make_class_mg_solve(param, jc: int, ic: int, dtype, device):
    """The mg class lane's solve: V-cycles of K18 (ops/mg_fused.
    class_cycle), one launch per cycle for every lane still cycling:

        solve(p, rhs, lanes, cycling) -> (p', res, it)

    p, rhs lane-stacked (N, jc+2, ic+2); `cycling` (N,) host bools, the
    lanes to solve. A lane cycles while res >= eps² and it < itermax,
    res = its Σr² (read back, one (N,) copy a cycle) over imax·jmax in the
    lane dtype; `it` counts V-cycles. The SOR factor of the lane geometry
    is not used: the ω = 1 level factors come from the lane's level plan.
    Dead cells are zeroed on exit. res, it: numpy (N,)."""
    real = mf._REAL[dtype]
    epssq = real(param.eps * param.eps)
    itermax = param.itermax
    work = {}

    def solve(p, rhs, lanes: Lanes, cycling):
        n = p.shape[0]
        res = np.ones(n, real)
        it = np.zeros(n, np.int64)
        buf = work.get(n)
        if buf is None and p.device.type == "cuda":
            buf = work[n] = torch.empty(
                max(1, n * mf.class_work_cells(jc, ic, lanes.mg_ext.shape[1])),
                dtype=dtype, device=p.device)
        while True:
            on = cycling & (res >= epssq) & (it < itermax)
            if not on.any():
                break
            act = torch.from_numpy(on.astype(np.int32)).to(p.device)
            p, rsq = mf.class_cycle(p, rhs, lanes.mg_ext, lanes.mg_geo, act,
                                    work=buf)
            res[on] = rsq.cpu().numpy().astype(real)[on] / lanes.norm[on]
            it[on] += 1
        return torch.where(lanes.live, p, torch.zeros_like(p)), res, it

    return solve


def make_padded_class_solve(param, jc: int, ic: int, dtype, n_inner: int):
    """The sor class lane's solve (the JAX package's
    make_padded_class_solve; the masked chain's at n_inner = 1, where the
    JAX package runs its masked jnp loop): the convergence loop over K2's
    dynamic-extent mode (ops/sor_kernels.rb_sor_class), n_inner
    iterations a call for every lane still solving, then one (N,)
    read-back of the residuals for the whole batch:

        solve(p, rhs, lanes, solving) -> (p, res, it)

    in place on p. A lane solves while it is in `solving`, res >= eps² and
    it < itermax, res = its Σr² of the call's last iteration over
    imax·jmax in the lane dtype; `it` counts iterations (a multiple of
    n_inner, as on the TPU). `solve.stats` accumulates the solve's wall,
    the wall spent in the read-backs and the rounds (host clock)."""
    real = mf._REAL[dtype]
    epssq = real(param.eps * param.eps)
    itermax = param.itermax
    stats = {"solve_s": 0.0, "sync_s": 0.0, "rounds": 0}

    def solve(p, rhs, lanes: Lanes, solving):
        t0 = time.perf_counter()
        n = p.shape[0]
        res = np.ones(n, real)
        it = np.zeros(n, np.int64)
        while True:
            on = solving & (res >= epssq) & (it < itermax)
            if not on.any():
                break
            act = torch.from_numpy(on).to(p.device)
            rsq = sk.rb_sor_class(p, rhs, n_inner, lanes.dims,
                                  lanes.sor_geo, act)
            s0 = time.perf_counter()
            rsq = rsq.cpu().numpy().astype(real)
            stats["sync_s"] += time.perf_counter() - s0
            stats["rounds"] += 1
            res[on] = (rsq / lanes.norm)[on]
            it[on] += n_inner
        stats["solve_s"] += time.perf_counter() - t0
        return p, res, it

    solve.stats = stats
    return solve


def _normalize(p, nt, lanes: Lanes, stepping):
    """normalizePressure every 100 steps over each stepping lane's live
    corner (the JAX package's dynamic count, ghost ring included); dead
    cells stay 0."""
    renorm = ((nt % 100) == 0) & stepping
    if not bool(renorm.any()):
        return p
    mean = live_sum(p, lanes) / lanes.cnt
    return torch.where(renorm.view(-1, 1, 1) & lanes.live, p - mean, p)


def make_class_chunk(param, jc: int, ic: int, dtype, device,
                     chunk_default: int = 64, log=None):
    """One class's masked chain: models/ns2d's phase order over
    lane-stacked blocks with the grid extents as per-lane data (the JAX
    package's make_class_chunk):

        chunk(u, v, p, t, nt, lanes, te, running) -> (u, v, p, t, nt)

    Every lane in `running` (an (N,) bool tensor) takes steps while its
    t <= te, at most `tpu_chunk` (default chunk_default) in all; the other
    lanes pass through unchanged. One host check a step (whether any lane
    still steps) and the solve's read-back a V-cycle or an iteration.
    `log["it"]` holds each lane's solve count of the last step (numpy,
    0 for a lane that did not step)."""
    grids = rg.class_index_grids(jc, ic, device)
    adaptive = param.tau > 0.0
    chunk = param.tpu_chunk or chunk_default
    if param.tpu_solver == "mg":
        solve = make_class_mg_solve(param, jc, ic, dtype, device)
    else:
        solve = make_padded_class_solve(param, jc, ic, dtype, 1)
    log = {} if log is None else log

    def step(u, v, p, t, nt, lanes: Lanes, stepping):
        n = u.shape[0]
        if adaptive:
            dt = ops.cfl_dt(u.abs().amax((-2, -1), keepdim=True),
                            v.abs().amax((-2, -1), keepdim=True),
                            lanes.dtb, lanes.dx, lanes.dy, param.tau)
        else:
            dt = torch.full((n, 1, 1), param.dt, dtype=dtype, device=device)
        u, v = rg.set_bcs_class(u, v, param, grids, lanes.jmax, lanes.imax)
        u = rg.set_special_bc_class(u, param, grids, lanes.jmax, lanes.imax,
                                    lanes.dy)
        f, g = ops.compute_fg_interior(u, v, dt, param.re, param.gx,
                                       param.gy, param.gamma, lanes.dx,
                                       lanes.dy)
        f, g = rg.fg_fixups_class(f, g, u, v, grids, lanes.jmax, lanes.imax)
        zero = torch.zeros((), dtype=dtype, device=device)
        rhs = torch.where(lanes.interior,
                          ops.rhs_terms(f, g, dt, lanes.dx, lanes.dy), zero)
        p = _normalize(p, nt, lanes, stepping)
        p, _res, it = solve(p, rhs, lanes, stepping.cpu().numpy())
        log["it"] = it
        u_new, v_new = ops.adapt_terms(f, g, p, dt, lanes.dx, lanes.dy)
        lm = lanes.live.to(dtype)
        u = torch.where(lanes.interior, u_new, u) * lm
        v = torch.where(lanes.interior, v_new, v) * lm
        return u, v, p, t + dt.view(n).to(t.dtype), nt + 1

    def run(u, v, p, t, nt, lanes: Lanes, te, running):
        p = p.clone()  # the sor solve works in place: the caller's p stays
        for _ in range(chunk):
            stepping = running & (t <= te)
            if not bool(stepping.any()):
                break
            new = step(u, v, p, t, nt, lanes, stepping)
            m3 = stepping.view(-1, 1, 1)
            u, v, p = (torch.where(m3, a, b) for a, b in
                       zip(new[:3], (u, v, p)))
            t = torch.where(stepping, new[3], t)
            nt = torch.where(stepping, new[4], nt)
        return u, v, p, t, nt

    return run


def make_fused_class_chunk(param, jc: int, ic: int, dtype, device,
                           chunk_default: int = 64, n_inner: int = 1,
                           log=None):
    """The sor class lane's fused chunk (the JAX package's
    make_fused_class_chunk): a step is the class mode of K3 (PRE), the
    every-100-steps normalizePressure, the padded class solve on K2's
    dynamic-extent mode at n_inner iterations a call, and the class mode of
    K4 (POST, whose maxima give the next step's CFL dt), each one call for
    every lane of the batch; the lanes not stepping pass through (the
    kernels' `active` / `solving` flags). Same call and state as
    make_class_chunk; on the CPU the kernels' plain versions run.
    `solve.stats` rides on the returned function as `run.solve_stats`."""
    cfg = nf.StepConfig.from_param(param)
    adaptive = param.tau > 0.0
    chunk = param.tpu_chunk or chunk_default
    solve = make_padded_class_solve(param, jc, ic, dtype, n_inner)
    log = {} if log is None else log

    def run(u, v, p, t, nt, lanes: Lanes, te, running):
        n = u.shape[0]
        # the kernels work in place: the caller's state stays as it was
        u, v, p = u.clone(), v.clone(), p.clone()
        umax = u.abs().amax((-2, -1)).view(n, 1, 1)
        vmax = v.abs().amax((-2, -1)).view(n, 1, 1)
        for _ in range(chunk):
            stepping = running & (t <= te)
            if not bool(stepping.any()):
                break
            if adaptive:
                dt = ops.cfl_dt(umax, vmax, lanes.dtb, lanes.dx, lanes.dy,
                                param.tau).reshape(n)
            else:
                dt = torch.full((n,), param.dt, dtype=dtype, device=device)
            f, g, rhs = nf.ns2d_pre(u, v, dt, cfg, ext=lanes.dims,
                                    geo=lanes.cell, active=stepping)
            p = _normalize(p, nt, lanes, stepping)
            p, _res, it = solve(p, rhs, lanes, stepping.cpu().numpy())
            log["it"] = it
            um, vm = nf.ns2d_post(u, v, f, g, p, dt, None, None,
                                  ext=lanes.dims, geo=lanes.cell,
                                  active=stepping)
            umax, vmax = um.view(n, 1, 1), vm.view(n, 1, 1)
            t = torch.where(stepping, t + dt.to(t.dtype), t)
            nt = torch.where(stepping, nt + 1, nt)
        return u, v, p, t, nt

    run.solve_stats = solve.stats
    return run


class ClassSolver:
    """The template of one shape class (the JAX package's ClassSolver, 2-D
    lanes): built from a representative request, it serves every request
    of its class signature, of any eligible grid, through
    fleet/batch.BatchedSolver. `lane_state` gives a lane's initial state
    (fields, t, nt and the geometry vector), `crop_lane` a lane's fields
    back in its own (jmax+2, imax+2) layout.

    An mg lane steps the masked chain with K18's V-cycles. A sor lane
    steps the fused class chunk under `tpu_fuse_phases auto|on` and the
    masked chain under `off`, at `class_cadence` iterations a residual
    check (decisions under `ns2d_class_phases` and `ns2d_class_solve`).
    On the card the kernels are built (or loaded) here: the build is
    set-up, not serving. `last_iters` holds each lane's solve count of the
    last step; `solve_stats` the fused chunk's solve walls."""

    CHUNK = 64

    def __init__(self, param, ic: int, jc: int, dtype=None, device="cuda"):
        self.device = resolve_device(device)
        self._ndev = len(visible_devices(self.device))
        reason = class_eligible(param, self._ndev)
        if reason is not None:
            raise ValueError(f"request is not class-eligible: {reason}")
        if class_extent(param.imax) > ic or class_extent(param.jmax) > jc:
            raise ValueError(
                f"grid {param.imax}x{param.jmax} exceeds class {ic}x{jc}")
        self.param = param.replace(imax=ic, jmax=jc)
        self._request = param
        self.ic, self.jc = ic, jc
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None \
            else dtype
        self._mg = param.tpu_solver == "mg"
        self._log: dict = {}
        self.solve_stats = None
        self._chunk = self._build_chunk()
        self._lanes: dict[bytes, Lanes] = {}

    def _build_fused_chunk(self):
        """The sor lane's fused class chunk where `tpu_fuse_phases` takes it
        (`auto` and `on`: the policy does not depend on the device, the CPU
        runs the kernels' plain versions), else None; the decision is
        recorded either way."""
        knob = self.param.tpu_fuse_phases
        cadence = class_cadence(self.param, self.dtype)
        if knob == "off":
            _dispatch.record("ns2d_class_phases",
                             "plain torch chain (tpu_fuse_phases off)")
            return None
        how = "forced" if knob == "on" else (
            "auto" if self.dtype.itemsize <= 4 else
            "auto; float64 checks every iteration, where the JAX package "
            "runs its jnp chain")
        _dispatch.record("ns2d_class_phases",
                         f"fused class chunk on {self.device.type} ({how}: "
                         "class K3 + padded class solve + class K4)")
        _dispatch.record("ns2d_class_solve",
                         f"padded class solve (K2's dynamic-extent mode, "
                         f"n_inner={cadence})")
        if self.device.type == "cuda":
            sk._lib()
            nf._lib()
        chunk = make_fused_class_chunk(self.param, self.jc, self.ic,
                                       self.dtype, self.device, self.CHUNK,
                                       cadence, self._log)
        self.solve_stats = chunk.solve_stats
        return chunk

    def _build_chunk(self):
        if self._mg:
            _dispatch.resolve_mg_class(self.param.tpu_mg_fused,
                                       mf.class_level_max(self.jc, self.ic))
            _dispatch.record("ns2d_class_phases",
                             f"plain torch chain on {self.device.type} (mg "
                             "class lane: the solve is the one-launch class "
                             "cycle)")
            if self.device.type == "cuda":
                mf.class_cycle_library()
            self._fused = False
        else:
            fused = self._build_fused_chunk()
            self._fused = fused is not None
            if fused is not None:
                return fused
            _dispatch.record("ns2d_class_solve",
                             "padded class solve (K2's dynamic-extent mode, "
                             "n_inner=1)")
        return make_class_chunk(self.param, self.jc, self.ic, self.dtype,
                                self.device, self.CHUNK, self._log)

    @property
    def last_iters(self):
        """Each lane's solve count (iterations, or V-cycles) of the last
        step, numpy (N,); 0 for a lane that did not step."""
        return self._log.get("it")

    def lane_consts(self, gm) -> Lanes:
        """The Lanes of geometry vectors gm (numpy (N, 9)), cached."""
        gm = np.ascontiguousarray(gm, np.float64)
        key = gm.tobytes()
        lanes = self._lanes.get(key)
        if lanes is None:
            lanes = self._lanes[key] = class_lanes(gm, self.jc, self.ic,
                                                   self.dtype, self.device,
                                                   self._mg)
        return lanes

    def advance(self, u, v, p, t, nt, lanes: Lanes, te, running):
        """Up to CHUNK (or tpu_chunk) steps of every running lane."""
        return self._chunk(u, v, p, t, nt, lanes, te, running)

    def lane_state(self, param) -> tuple:
        """(u, v, p, t, nt, gm) of one request in this class: the fields
        are its constant initial values on its live corner and 0 on the
        dead cells."""
        reason = class_eligible(param, self._ndev)
        if reason is not None:
            raise ValueError(f"request is not class-eligible: {reason}")
        jc, ic = self.jc, self.ic
        if param.imax > ic or param.jmax > jc:
            raise ValueError(
                f"grid {param.imax}x{param.jmax} exceeds class {ic}x{jc}")
        live = ((np.arange(jc + 2)[:, None] <= param.jmax + 1)
                & (np.arange(ic + 2)[None, :] <= param.imax + 1))

        def field(init):
            return torch.from_numpy(np.where(live, init, 0.0)).to(
                device=self.device, dtype=self.dtype)

        return (field(param.u_init), field(param.v_init),
                field(param.p_init),
                torch.zeros((), dtype=torch.float64, device=self.device),
                torch.zeros((), dtype=torch.int32, device=self.device),
                torch.tensor(lane_geometry(param), dtype=torch.float64,
                             device=self.device))

    def crop_lane(self, fields, param) -> tuple:
        """A lane's fields in the request's own (jmax+2, imax+2) layout,
        as numpy arrays."""
        return tuple(np.asarray(f)[:param.jmax + 2, :param.imax + 2]
                     for f in fields)

    def initial_state(self) -> tuple:
        return self.lane_state(self._request)
