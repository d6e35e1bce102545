"""Shape-class batching: mixed-grid requests padded into shared class
blocks (counterpart of pampi_tpu/fleet/shapeclass.py).

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

The 3-D class rungs (`Class3DSolver`, the JAX package's): (kc, jc, ic)
blocks with each lane's (kmax, jmax, imax) and its grid constants as
per-lane data (`lane_geometry_3d`, the G3_* slots). A step of the fused
chunk (`tpu_fuse_phases auto|on`) is one call of the class mode of K7
(PRE), the masked red-black class solve in plain torch
(`make_class_solve_3d`, one (N,) read-back an iteration) and one call of
the class mode of K8 (POST, whose maxima give the next step's dt); the
masked chain (`off`) runs the same phases in plain torch. Each lane's
residual sums its interior in a fixed order (`interior_sum`), so a 3-D
lane too is bitwise the same in every rung.
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
from ..ops import ns3d as ops3
from ..ops import ns3d_fused as nf3
from ..ops import sor_kernels as sk
from ..ops.sor3d import sor_coefficients_3d
from ..ops.sor_kernels import _tree
from ..parallel import ragged2d as rg
from ..parallel import ragged3d as rg3
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


def class_eligible(param, ndevices: int = 1) -> str | None:
    """None when the request may ride a class; else why it keeps its
    exact-shape bucket: the JAX package's class_eligible, its order and
    its strings, for 2-D and 3-D requests. `ndevices` is the visible
    device count the mesh rule reads (the JAX package reads
    jax.devices(), through the CLI's mesh_is_single)."""
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

    in place on p. K2's class mode reads one block and writes another
    (every cell: the lanes that are not solving and the cells past each
    live corner are copied), so the rounds alternate p and a spare batch
    made once per shape, and a solve of an odd number of rounds copies the
    newest back into p once: the solve keeps the in-place contract that
    its callers hold (p is theirs). A lane solves while it is in
    `solving`, res >= eps² and it < itermax, res = its Σr² of the call's
    last iteration over imax·jmax in the lane dtype; `it` counts
    iterations (a multiple of n_inner, as on the TPU). `solve.stats`
    accumulates the solve's wall, the wall spent in the read-backs and the
    rounds (host clock)."""
    real = mf._REAL[dtype]
    epssq = real(param.eps * param.eps)
    itermax = param.itermax
    stats = {"solve_s": 0.0, "sync_s": 0.0, "rounds": 0}
    spares = {}

    def solve(p, rhs, lanes: Lanes, solving):
        t0 = time.perf_counter()
        n = p.shape[0]
        res = np.ones(n, real)
        it = np.zeros(n, np.int64)
        key = (tuple(p.shape), p.dtype, p.device)
        other = spares.get(key)
        if other is None:
            other = spares[key] = torch.empty_like(p)
        cur = p
        while True:
            on = solving & (res >= epssq) & (it < itermax)
            if not on.any():
                break
            act = torch.from_numpy(on).to(p.device)
            rsq = sk.rb_sor_class(cur, rhs, n_inner, lanes.dims,
                                  lanes.sor_geo, act, out=other)
            cur, other = other, cur
            s0 = time.perf_counter()
            rsq = rsq.cpu().numpy().astype(real)
            stats["sync_s"] += time.perf_counter() - s0
            stats["rounds"] += 1
            res[on] = (rsq / lanes.norm)[on]
            it[on] += n_inner
        if cur is not p:
            p.copy_(cur)
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
    n_fields = 3  # u, v, p

    def __init__(self, param, ic: int, jc: int, dtype=None, device="cuda"):
        _dispatch.check_bf16_class(param)
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


# ---------------------------------------------------------------------------
# The 3-D class rungs: the same ladder with kmax among the per-lane data,
# the masked red-black solve in plain torch, and the class mode of K7/K8
# ---------------------------------------------------------------------------

# 3-D geometry-vector slots (per lane, float64)
(G3_KMAX, G3_JMAX, G3_IMAX, G3_DX, G3_DY, G3_DZ, G3_DTB, G3_FACTOR,
 G3_IDX2, G3_IDY2, G3_IDZ2, G3_NORM) = range(12)


def lane_geometry_3d(param):
    """The 3-D per-lane geometry scalars in Python float64, with the solo
    solver's expressions and ops/sor3d.sor_coefficients_3d (the JAX
    package's lane_geometry_3d)."""
    dx = param.xlength / param.imax
    dy = param.ylength / param.jmax
    dz = param.zlength / param.kmax
    inv_sqr_sum = 1.0 / dx**2 + 1.0 / dy**2 + 1.0 / dz**2
    dt_bound = 0.5 * param.re / inv_sqr_sum
    factor, idx2, idy2, idz2 = sor_coefficients_3d(dx, dy, dz, param.omg)
    norm = float(param.imax * param.jmax * param.kmax)
    return (float(param.kmax), float(param.jmax), float(param.imax),
            dx, dy, dz, dt_bound, factor, idx2, idy2, idz2, norm)


@dataclasses.dataclass
class Lanes3D:
    """The per-lane constants of a 3-D batch, derived once from its (N, 12)
    float64 geometry vectors: K7/K8's per-lane arrays dims (N, 3) int32
    (kmax, jmax, imax) and cell (N, 3) (dx, dy, dz) in the lane dtype
    (`ext` and `cell4` are their (N, 1, 1, 1) columns); the SOR constants
    (factor, idx2, idy2, idz2), the CFL bound and the residual norm in the
    lane dtype; the class index grids; the interior and live masks, the
    colour masks (odd, even) and the six Neumann face masks with their
    rolls; and the gather plan of each lane's interior for its residual
    sum (interior_sum)."""

    dims: torch.Tensor
    cell: torch.Tensor
    sor: tuple
    dtb: torch.Tensor
    norm: torch.Tensor
    grids: tuple
    interior: torch.Tensor
    live: torch.Tensor
    odd: torch.Tensor
    even: torch.Tensor
    faces: tuple
    gather: torch.Tensor
    valid: torch.Tensor

    @property
    def ext(self):
        n = self.dims.shape[0]
        return tuple(self.dims[:, a].to(torch.int64).view(n, 1, 1, 1)
                     for a in range(3))

    @property
    def cell4(self):
        n = self.cell.shape[0]
        return tuple(self.cell[:, a].view(n, 1, 1, 1) for a in range(3))


def class_lanes_3d(gm, kc: int, jc: int, ic: int, dtype, device) -> Lanes3D:
    """Lanes3D of a batch from its geometry vectors `gm` (numpy (N, 12)).
    Every lane's extents must fit the (kc, jc, ic) class: the kernels read
    them on the card unchecked."""
    gm = np.asarray(gm, np.float64)
    n = gm.shape[0]
    real = mf._REAL[dtype]
    ext = gm[:, [G3_KMAX, G3_JMAX, G3_IMAX]]
    if ((ext < 1) | (ext > (kc, jc, ic))).any():
        raise ValueError(f"lane extents {ext.astype(int).tolist()} do not "
                         f"fit the class {ic}x{jc}x{kc}")

    def lane_array(slots, to):
        return torch.from_numpy(np.ascontiguousarray(
            gm[:, slots].astype(to))).to(device)

    def scalar(slot):
        return lane_array([slot], real).view(n, 1, 1, 1)

    dims = lane_array([G3_KMAX, G3_JMAX, G3_IMAX], np.int32)
    kmax, jmax, imax = (dims[:, a].to(torch.int64).view(n, 1, 1, 1)
                        for a in range(3))
    grids = rg3.class_index_grids_3d(kc, jc, ic, device)
    gk, gj, gi = grids
    interior, live = rg3.class_masks_3d(grids, kmax, jmax, imax)
    parity = (gk + gj + gi) % 2
    # pass 0 visits parity 1 (odd), pass 1 parity 0 (the reference's order)
    odd = (interior & (parity == 1)).to(dtype)
    even = (interior & (parity == 0)).to(dtype)
    in_k = (gk >= 1) & (gk <= kmax)
    in_j = (gj >= 1) & (gj <= jmax)
    in_i = (gi >= 1) & (gi <= imax)
    # the 6-face Neumann copy in the JAX package's order, corners untouched:
    # (mask, roll shift, axis) for front, back, bottom, top, left, right
    faces = (((gk == 0) & in_j & in_i, -1, -3),
             ((gk == kmax + 1) & in_j & in_i, 1, -3),
             ((gj == 0) & in_k & in_i, -1, -2),
             ((gj == jmax + 1) & in_k & in_i, 1, -2),
             ((gi == 0) & in_k & in_j, -1, -1),
             ((gi == imax + 1) & in_k & in_j, 1, -1))
    # each lane's interior cells in row-major order, zero-padded to a power
    # of two for the halving tree
    counts = ext.prod(axis=1).astype(np.int64)
    width = 1 << int(counts.max() - 1).bit_length()
    gather = np.zeros((n, width), np.int64)
    valid = np.zeros((n, width), bool)
    for lane, (k, j, i) in enumerate(ext.astype(int)):
        flat = ((np.arange(1, k + 1)[:, None, None] * (jc + 2)
                 + np.arange(1, j + 1)[None, :, None]) * (ic + 2)
                + np.arange(1, i + 1)[None, None, :]).reshape(-1)
        gather[lane, :flat.size] = flat
        valid[lane, :flat.size] = True
    return Lanes3D(
        dims=dims, cell=lane_array([G3_DX, G3_DY, G3_DZ], real),
        sor=tuple(scalar(s) for s in (G3_FACTOR, G3_IDX2, G3_IDY2, G3_IDZ2)),
        dtb=scalar(G3_DTB), norm=lane_array([G3_NORM], real).view(n),
        grids=grids, interior=interior, live=live, odd=odd, even=even,
        faces=faces, gather=torch.from_numpy(gather).to(device),
        valid=torch.from_numpy(valid).to(device))


def interior_sum(q, lanes: Lanes3D):
    """Each lane's sum of q over its interior cells, (N,), in a fixed order
    that depends on the lane's extents only: the cells in row-major order,
    zero-padded to a power of two, then a halving tree. Zeros past a
    lane's cells leave the tree's result as it is, so a lane's sum is
    bitwise the same in every rung and whatever its batchmates are."""
    n = q.shape[0]
    vals = torch.where(lanes.valid, q.reshape(n, -1).gather(1, lanes.gather),
                       torch.zeros((), dtype=q.dtype, device=q.device))
    return _tree(vals)[:, 0]


def make_class_solve_3d(param, kc: int, jc: int, ic: int, dtype):
    """The 3-D class solve (the JAX package's make_class_solve_3d): the
    masked red-black SOR convergence loop over lane-stacked (kc+2, jc+2,
    ic+2) blocks in plain torch. An iteration is the odd pass, the even
    pass (each r = (rhs - lap)·colour mask, p += -factor·r, over the whole
    block), then the 6-face Neumann copy:

        solve(p, rhs, lanes, solving) -> (p', res, it)

    A lane iterates while it is in `solving` (numpy (N,) bools), res >=
    eps² and it < itermax, res = (Σr²(odd) + Σr²(even)) / norm in the lane
    dtype, each Σ interior_sum's fixed order; the other lanes keep their
    p. So each lane's count and p are its solo's (the JAX package's
    vmapped while_loop). One (N,) read-back of the residuals an iteration
    for the whole batch. `solve.stats` accumulates the solve's wall, the
    wall spent in the read-backs and the iterations (host clock)."""
    real = mf._REAL[dtype]
    epssq = real(param.eps * param.eps)
    itermax = param.itermax
    stats = {"solve_s": 0.0, "sync_s": 0.0, "rounds": 0}
    roll = torch.roll

    def sweep(p, rhs, mask, lanes: Lanes3D):
        factor, idx2, idy2, idz2 = lanes.sor
        lap = ((roll(p, -1, -1) - 2.0 * p + roll(p, 1, -1)) * idx2
               + (roll(p, -1, -2) - 2.0 * p + roll(p, 1, -2)) * idy2
               + (roll(p, -1, -3) - 2.0 * p + roll(p, 1, -3)) * idz2)
        r = (rhs - lap) * mask
        return p + (-factor) * r, interior_sum(r * r, lanes)

    def solve(p, rhs, lanes: Lanes3D, solving):
        t0 = time.perf_counter()
        n = p.shape[0]
        res = np.ones(n, real)
        it = np.zeros(n, np.int64)
        while True:
            on = solving & (res >= epssq) & (it < itermax)
            if not on.any():
                break
            q, r0 = sweep(p, rhs, lanes.odd, lanes)
            q, r1 = sweep(q, rhs, lanes.even, lanes)
            for mask, shift, axis in lanes.faces:
                q = torch.where(mask, roll(q, shift, axis), q)
            p = torch.where(torch.from_numpy(on).to(p.device).view(
                n, 1, 1, 1), q, p)
            s0 = time.perf_counter()
            rn = ((r0 + r1) / lanes.norm).cpu().numpy()
            stats["sync_s"] += time.perf_counter() - s0
            stats["rounds"] += 1
            res[on] = rn[on]
            it[on] += 1
        stats["solve_s"] += time.perf_counter() - t0
        return p, res, it

    solve.stats = stats
    return solve


def make_class_chunk_3d(param, kc: int, jc: int, ic: int, dtype, device,
                        chunk_default: int = 32, fused: bool = False,
                        log=None):
    """One 3-D class's chunk (the JAX package's make_class_chunk_3d), the
    reference's 3-D phase order with the grid extents as per-lane data (no
    normalizePressure: the 3-D loop never calls it):

        chunk(u, v, w, p, t, nt, lanes, te, running) -> (u, v, w, p, t, nt)

    Every lane in `running` (an (N,) bool tensor) takes steps while its
    t <= te, at most `tpu_chunk` (default chunk_default) in all; the other
    lanes pass through unchanged. A step of the masked chain (`fused`
    false) is the CFL dt from each lane's ghost-inclusive maxima, the BCs,
    F/G/H and their fixups, the rhs (parallel/ragged3d.class_pre_3d), the
    class solve, the projection and the live-mask multiply (class_post_3d),
    in plain torch. A fused step is one call of K7's class mode, the class
    solve and one call of K8's class mode for all lanes, K8's maxima giving
    the next step's dt (at a chunk's start the maxima of the whole blocks);
    on the CPU the kernels' plain versions run. `log["it"]` holds each
    lane's iterations of the last step (numpy, 0 for a lane that did not
    step); `run.solve_stats` the solve's walls."""
    cfg = nf3.StepConfig3D.from_param(param)
    adaptive = param.tau > 0.0
    chunk = param.tpu_chunk or chunk_default
    solve = make_class_solve_3d(param, kc, jc, ic, dtype)
    log = {} if log is None else log

    def dt_of(maxima, lanes: Lanes3D, n):
        if adaptive:
            return ops3.cfl_dt_3d(*(m.view(n, 1, 1, 1) for m in maxima),
                                  lanes.dtb, *lanes.cell4,
                                  param.tau).reshape(n)
        return torch.full((n,), param.dt, dtype=dtype, device=device)

    def block_maxima(fields):
        return tuple(a.abs().amax((-3, -2, -1)) for a in fields)

    def chain(u, v, w, p, t, nt, lanes: Lanes3D, te, running):
        n = u.shape[0]
        for _ in range(chunk):
            stepping = running & (t <= te)
            if not bool(stepping.any()):
                break
            dt = dt_of(block_maxima((u, v, w)), lanes, n)
            dt4 = dt.view(n, 1, 1, 1)
            *uvw, f, g, h, rhs = rg3.class_pre_3d(
                u, v, w, dt4, cfg, lanes.grids, lanes.ext, lanes.cell4)
            q, _res, it = solve(p, rhs, lanes, stepping.cpu().numpy())
            log["it"] = it
            new = rg3.class_post_3d(*uvw, f, g, h, q, dt4, lanes.grids,
                                    lanes.ext, lanes.cell4)
            m4 = stepping.view(n, 1, 1, 1)
            u, v, w, p = (torch.where(m4, a, b) for a, b in
                          zip((*new, q), (u, v, w, p)))
            t = torch.where(stepping, t + dt.to(t.dtype), t)
            nt = torch.where(stepping, nt + 1, nt)
        return u, v, w, p, t, nt

    def fused_run(u, v, w, p, t, nt, lanes: Lanes3D, te, running):
        n = u.shape[0]
        # the kernels work in place: the caller's state stays as it was
        u, v, w = u.clone(), v.clone(), w.clone()
        maxima = block_maxima((u, v, w))
        for _ in range(chunk):
            stepping = running & (t <= te)
            if not bool(stepping.any()):
                break
            dt = dt_of(maxima, lanes, n)
            f, g, h, rhs = nf3.ns3d_pre(u, v, w, dt, cfg, ext=lanes.dims,
                                        geo=lanes.cell, active=stepping)
            p, _res, it = solve(p, rhs, lanes, stepping.cpu().numpy())
            log["it"] = it
            maxima = nf3.ns3d_post(u, v, w, f, g, h, p, dt, None, None, None,
                                   ext=lanes.dims, geo=lanes.cell,
                                   active=stepping)
            t = torch.where(stepping, t + dt.to(t.dtype), t)
            nt = torch.where(stepping, nt + 1, nt)
        return u, v, w, p, t, nt

    run = fused_run if fused else chain
    run.solve_stats = solve.stats
    return run


class Class3DSolver:
    """The template of one 3-D shape class (the JAX package's
    Class3DSolver): (kc, jc, ic) power-of-two rungs, each lane's (kmax,
    jmax, imax) per-lane data, served through fleet/batch.BatchedSolver.
    `lane_state` gives a lane's initial state (u, v, w, p, t, nt and the
    geometry vector), `crop_lane` a lane's fields back in its own (kmax+2,
    jmax+2, imax+2) layout.

    Under `tpu_fuse_phases` `on` and `auto` a step is the fused one (class
    K7, the masked class solve, class K8), on either device: on the CPU
    the kernels' plain versions run. `off` takes the masked plain-torch
    chain. Decisions under `ns3d_class_phases` and `ns3d_class_solve`.
    This is the 2-D sor lane's policy (ClassSolver._build_fused_chunk);
    the JAX package fuses under `auto` only on a TPU and runs its jnp
    chain elsewhere, which computes the same arithmetic. The solve is the
    masked red-black loop in plain torch in both steps, as in the JAX
    package (its octant kernels are exact-shape programs). On the card the
    kernels are built (or loaded) here: the build is set-up, not serving.
    `last_iters` holds each lane's iterations of the last step;
    `solve_stats` the solve's walls."""

    CHUNK = 32
    n_fields = 4  # u, v, w, p

    def __init__(self, param, ic: int, jc: int, kc: int, dtype=None,
                 device="cuda"):
        _dispatch.check_bf16_class(param)
        self.device = resolve_device(device)
        self._ndev = len(visible_devices(self.device))
        reason = class_eligible(param, self._ndev)
        if reason is not None:
            raise ValueError(f"request is not class-eligible: {reason}")
        if (class_extent(param.imax) > ic or class_extent(param.jmax) > jc
                or class_extent(param.kmax) > kc):
            raise ValueError(
                f"grid {param.imax}x{param.jmax}x{param.kmax} exceeds "
                f"class {ic}x{jc}x{kc}")
        self.param = param.replace(imax=ic, jmax=jc, kmax=kc)
        self._request = param
        self.ic, self.jc, self.kc = ic, jc, kc
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None \
            else dtype
        knob = self.param.tpu_fuse_phases
        if knob not in ("auto", "on", "off"):
            raise ValueError(f"tpu_fuse_phases must be auto|on|off, got "
                             f"{knob!r}")
        self._fused = knob != "off"
        if self._fused:
            _dispatch.record(
                "ns3d_class_phases",
                f"fused class chunk on {self.device.type} "
                f"({'forced' if knob == 'on' else 'auto'}: class K7 + "
                "masked class solve + class K8)")
            if self.device.type == "cuda":
                nf3._lib()
        else:
            _dispatch.record("ns3d_class_phases",
                             "plain torch chain (tpu_fuse_phases off)")
        _dispatch.record("ns3d_class_solve",
                         "masked red-black class solve in plain torch (one "
                         "(N,) read-back an iteration)")
        self._log: dict = {}
        self._lanes: dict[bytes, Lanes3D] = {}
        self._chunk = make_class_chunk_3d(self.param, kc, jc, ic, self.dtype,
                                          self.device, self.CHUNK,
                                          self._fused, self._log)
        self.solve_stats = self._chunk.solve_stats

    @property
    def last_iters(self):
        """Each lane's solve iterations of the last step, numpy (N,); 0
        for a lane that did not step."""
        return self._log.get("it")

    def lane_consts(self, gm) -> Lanes3D:
        """The Lanes3D of geometry vectors gm (numpy (N, 12)), cached."""
        gm = np.ascontiguousarray(gm, np.float64)
        key = gm.tobytes()
        lanes = self._lanes.get(key)
        if lanes is None:
            lanes = self._lanes[key] = class_lanes_3d(
                gm, self.kc, self.jc, self.ic, self.dtype, self.device)
        return lanes

    def advance(self, u, v, w, p, t, nt, lanes: Lanes3D, te, running):
        """Up to CHUNK (or tpu_chunk) steps of every running lane."""
        return self._chunk(u, v, w, p, t, nt, lanes, te, running)

    def lane_state(self, param) -> tuple:
        """(u, v, w, p, t, nt, gm) of one request in this class: the fields
        are its constant initial values on its live corner and 0 on the
        dead cells."""
        reason = class_eligible(param, self._ndev)
        if reason is not None:
            raise ValueError(f"request is not class-eligible: {reason}")
        kc, jc, ic = self.kc, self.jc, self.ic
        if param.imax > ic or param.jmax > jc or param.kmax > kc:
            raise ValueError(
                f"grid {param.imax}x{param.jmax}x{param.kmax} exceeds "
                f"class {ic}x{jc}x{kc}")
        live = ((np.arange(kc + 2)[:, None, None] <= param.kmax + 1)
                & (np.arange(jc + 2)[None, :, None] <= param.jmax + 1)
                & (np.arange(ic + 2)[None, None, :] <= param.imax + 1))

        def field(init):
            return torch.from_numpy(np.where(live, init, 0.0)).to(
                device=self.device, dtype=self.dtype)

        return (field(param.u_init), field(param.v_init),
                field(param.w_init), field(param.p_init),
                torch.zeros((), dtype=torch.float64, device=self.device),
                torch.zeros((), dtype=torch.int32, device=self.device),
                torch.tensor(lane_geometry_3d(param), dtype=torch.float64,
                             device=self.device))

    def crop_lane(self, fields, param) -> tuple:
        """A lane's fields in the request's own (kmax+2, jmax+2, imax+2)
        layout, as numpy arrays."""
        return tuple(np.asarray(f)[:param.kmax + 2, :param.jmax + 2,
                                   :param.imax + 2] for f in fields)

    def initial_state(self) -> tuple:
        return self.lane_state(self._request)
