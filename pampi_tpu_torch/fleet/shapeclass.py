"""Shape-class batching: mixed-grid requests padded into shared class
blocks (counterpart of the 2-D mg part of pampi_tpu/fleet/shapeclass.py).

A class is a rung of a ladder, the next power of two per axis with a
floor of RUNG_FLOOR. Every lane of a class batch holds a (jc+2, ic+2)
block whose live corner is its own (jmax+2, imax+2) grid; the dead cells
hold exact 0 and stay out of every reduction. The lane's grid extents
and every grid-derived constant (dx, dy, the CFL bound, idx2, idy2, the
residual norm) are per-lane data, computed on the host in Python float64
with the solo solver's expressions (`lane_geometry`, the G_* slots).

One step of the class chunk is the JAX package's masked phase chain over
the lane-stacked blocks (`make_class_chunk`): the CFL dt per lane, the
wall and special BCs, F/G and their fixups, the rhs, normalizePressure
every 100 steps over the live corner, the solve, the projection and the
live-mask multiply. The solve of a `tpu_solver mg` lane is the
one-launch class V-cycle, K18 (`ops/mg_fused.class_cycle`): one launch
per V-cycle for every lane of the batch still cycling, each lane's level
plan from its own extents (`make_class_mg_solve`), until its residual is
under eps² or itermax cycles are done.

What stays the JAX package's alone (ROADMAP A item 9): the rb-sor class
lane with its dynamic-extent K2/K3/K4 (`make_class_solve`,
`make_fused_class_chunk`) and the 3-D class rungs (`Class3DSolver`, the
dynamic-extent K7/K8). class_eligible keeps such requests in their
exact-shape buckets with a reason naming that item.

Every per-lane reduction takes a fixed order that depends on the lane's
live extents only (K18's residual, the live-corner sum of
normalizePressure), so a lane's fields are bitwise the same in every rung
and whatever its batchmates are.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..ops import mg_fused as mf
from ..ops import ns2d as ops
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

# the port's own refusals, naming the ROADMAP item that brings each
SOR_LANE = ("tpu_solver sor class lane (the masked rb-sor class chunk and "
            "the dynamic-extent modes of K2/K3/K4 are not yet ported, "
            "ROADMAP A item 9)")
LANE_3D = ("3-D class rung (Class3DSolver and the dynamic-extent modes of "
           "K7/K8 are not yet ported, ROADMAP A item 9)")


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
    the port's (a sor lane, a 3-D lane). `ndevices` is the visible device
    count (the JAX package reads jax.devices())."""
    why = _jax_reason(param, ndevices)
    if why is None and is_3d_config(param):
        return LANE_3D
    if why is None and param.tpu_solver == "sor":
        return SOR_LANE
    return why


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
    float64 geometry vectors: extents and cell sizes as (N, 1, 1)
    tensors, the interior and live masks, the normalizePressure count and
    gather plan, and K18's stacked level plans."""

    jmax: torch.Tensor
    imax: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dtb: torch.Tensor
    interior: torch.Tensor
    live: torch.Tensor
    cnt: torch.Tensor
    gather: torch.Tensor
    valid: torch.Tensor
    ext: torch.Tensor
    geo: torch.Tensor
    norm: np.ndarray


def class_lanes(gm, jc: int, ic: int, dtype, device) -> Lanes:
    """Lanes of a batch from its geometry vectors `gm` (numpy (N, 9))."""
    gm = np.asarray(gm, np.float64)
    n = gm.shape[0]
    real = mf._REAL[dtype]
    gj, gi = rg.class_index_grids(jc, ic, device)

    def col(slot, to=dtype):
        return torch.from_numpy(gm[:, slot].copy()).to(
            device=device, dtype=to).view(n, 1, 1)

    jmax = col(G_JMAX, torch.int64)
    imax = col(G_IMAX, torch.int64)
    interior = (gj >= 1) & (gj <= jmax) & (gi >= 1) & (gi <= imax)
    live = (gj <= jmax + 1) & (gi <= imax + 1)
    cnt = ((col(G_JMAX, torch.float64) + 2.0)
           * (col(G_IMAX, torch.float64) + 2.0)).to(dtype)
    # normalizePressure's sum: each lane's live corner in row-major order,
    # in the fixed order of K18's residual (thread t of CLASS_THREADS adds
    # t, t + T, ...), so the mean depends on the lane's extents only
    sizes = [(int(j) + 2, int(i) + 2) for j, i in
             zip(gm[:, G_JMAX], gm[:, G_IMAX])]
    t = mf.CLASS_THREADS
    width = -(-max(a * b for a, b in sizes) // t) * t
    gather = np.zeros((n, width), np.int64)
    valid = np.zeros((n, width), bool)
    for lane, (rows, cols) in enumerate(sizes):
        flat = (np.arange(rows)[:, None] * (ic + 2)
                + np.arange(cols)[None, :]).reshape(-1)
        gather[lane, :flat.size] = flat
        valid[lane, :flat.size] = True
    lmax = mf.class_level_max(jc, ic)
    plans = [mf.class_level_plan(int(g[G_JMAX]), int(g[G_IMAX]),
                                 g[G_IDX2], g[G_IDY2], lmax, dtype)
             for g in gm]
    return Lanes(
        jmax=jmax, imax=imax, dx=col(G_DX), dy=col(G_DY), dtb=col(G_DTB),
        interior=interior, live=live, cnt=cnt,
        gather=torch.from_numpy(gather).to(device),
        valid=torch.from_numpy(valid).to(device),
        ext=torch.stack([e for e, _ in plans]).to(device),
        geo=torch.stack([g for _, g in plans]).to(device),
        norm=gm[:, G_NORM].astype(real))


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
                max(1, n * mf.class_work_cells(jc, ic, lanes.ext.shape[1])),
                dtype=dtype, device=p.device)
        while True:
            on = cycling & (res >= epssq) & (it < itermax)
            if not on.any():
                break
            act = torch.from_numpy(on.astype(np.int32)).to(p.device)
            p, rsq = mf.class_cycle(p, rhs, lanes.ext, lanes.geo, act,
                                    work=buf)
            res[on] = rsq.cpu().numpy().astype(real)[on] / lanes.norm[on]
            it[on] += 1
        return torch.where(lanes.live, p, torch.zeros_like(p)), res, it

    return solve


def make_class_chunk(param, jc: int, ic: int, dtype, device,
                     chunk_default: int = 64):
    """One class's chunk: models/ns2d's phase order over lane-stacked
    blocks with the grid extents as per-lane data (the JAX package's
    make_class_chunk, mg lanes):

        chunk(u, v, p, t, nt, lanes, te, running) -> (u, v, p, t, nt)

    Every lane in `running` (an (N,) bool tensor) takes steps while its
    t <= te, at most `tpu_chunk` (default chunk_default) in all; the other
    lanes pass through unchanged. One host check a step (whether any lane
    still steps) and the solve's read-back a V-cycle."""
    if param.tpu_solver != "mg":
        raise NotImplementedError(SOR_LANE)
    grids = rg.class_index_grids(jc, ic, device)
    adaptive = param.tau > 0.0
    chunk = param.tpu_chunk or chunk_default
    solve = make_class_mg_solve(param, jc, ic, dtype, device)

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
        renorm = ((nt % 100) == 0) & stepping
        if bool(renorm.any()):
            # normalizePressure over the live corner only; dead cells stay 0
            mean = live_sum(p, lanes) / lanes.cnt
            p = torch.where(renorm.view(n, 1, 1) & lanes.live, p - mean, p)
        p, _res, _it = solve(p, rhs, lanes, stepping.cpu().numpy())
        u_new, v_new = ops.adapt_terms(f, g, p, dt, lanes.dx, lanes.dy)
        lm = lanes.live.to(dtype)
        u = torch.where(lanes.interior, u_new, u) * lm
        v = torch.where(lanes.interior, v_new, v) * lm
        return u, v, p, t + dt.view(n).to(t.dtype), nt + 1

    def run(u, v, p, t, nt, lanes: Lanes, te, running):
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


class ClassSolver:
    """The template of one shape class (the JAX package's ClassSolver, mg
    lanes): built from a representative request, it serves every request
    of its class signature, of any eligible grid, through
    fleet/batch.BatchedSolver. `lane_state` gives a lane's initial state
    (fields, t, nt and the geometry vector), `crop_lane` a lane's fields
    back in its own (jmax+2, imax+2) layout."""

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
        self.lmax = mf.class_level_max(jc, ic)
        _dispatch.resolve_mg_class(param.tpu_mg_fused, self.lmax)
        _dispatch.record("ns2d_class_phases",
                         f"plain torch chain on {self.device.type} (mg "
                         "class lane: the solve is the one-launch class "
                         "cycle)")
        if self.device.type == "cuda":
            # build (or load) K18 now: the build is set-up, not serving
            mf.class_cycle_library()
        self._chunk = make_class_chunk(self.param, jc, ic, self.dtype,
                                       self.device, self.CHUNK)
        self._lanes: dict[bytes, Lanes] = {}

    def lane_consts(self, gm) -> Lanes:
        """The Lanes of geometry vectors gm (numpy (N, 9)), cached."""
        gm = np.ascontiguousarray(gm, np.float64)
        key = gm.tobytes()
        lanes = self._lanes.get(key)
        if lanes is None:
            lanes = self._lanes[key] = class_lanes(gm, self.jc, self.ic,
                                                   self.dtype, self.device)
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
