"""Distributed NS-2D over a 2-D ("j", "i") mesh of shards (counterpart of
pampi_tpu/models/ns2d_dist.py): the time stepper of the reference's
assignment-5 MPI solver (ex5-nazifkar), with NS2DSolver's .par interface.

- Every field is a list of per-shard halo-1 extended blocks (jl+2, il+2)
  in mesh order, shard s on `comm.devices[s]` (parallel/comm.py: one
  controller loops over the shards; a mesh with more shards than cards
  shares them). A mesh that does not divide the grid is ceil-divided
  (`comm.local_shape(..., ragged=True)`): the trailing shards' cells past
  the global ghost ring are dead, every wall, lid and inflow write is
  gated by the global index, and the dead cells are zeroed after each
  projection (the live mask), as in the JAX package's pad-with-mask
  decomposition (parallel/ragged2d.py).
- The fused step (`tpu_fuse_phases` auto/on, the default): one depth-3
  deep-halo exchange of u and v; the CFL dt from the maxima of the
  exchanged deep blocks (the JAX package's order: the deep blocks hold the
  values of the global array, wall ghosts and dead zeros included, so the
  ghost-inclusive maximum is the single device's); PRE (kernel K3 in its
  distributed mode) on every shard's deep block; normalizePressure every
  100 steps; the pressure solve; POST (K4) on the halo-1 blocks, with the
  live mask on a ragged mesh. POST's per-shard maxima (`last_maxima`,
  reduced in mesh order) are not what dt reads: they include stale
  interface ghosts.
- The pressure solve, one of three, recorded under "ns2d_dist" with the
  JAX package's labels:
  - the quarter layout (parallel/quarters_dist.py, kernel K13 per shard;
    "pallas_quarters caN") on a divisible mesh with even global and
    shard extents under `tpu_sor_layout auto|quarters`;
  - the flag-masked checkerboard (ops/obstacle.make_dist_obstacle_solver
    on all-fluid flags, kernel K15 per shard; "pallas caN[ ragged]") on a
    ragged mesh, and on any mesh under `tpu_sor_layout checkerboard`. The
    JAX package runs its kernel, B.14, only on a ragged mesh (on a TPU,
    or anywhere under `checkerboard`) and its grid CA otherwise; the port
    runs K15 on every device;
  - with an `obstacles` key, the same solve on the real flags
    (recorded "obstacle (see obstacle_dist)[ ragged]", the solve itself
    under "obstacle_dist"), or on shards too thin for K15 the flag-masked
    exchange per half-sweep (ops/obstacle.make_obstacle_fallback); the
    quarter layout never runs there;
  - the grid-space CA solve (parallel/stencil2d.py, plain torch;
    "jnp_ca[ ragged]") where neither applies, or the exchange-per-half-
    sweep fallback on shards too thin for the CA's strips (extent 1, or
    below 3 on a ragged mesh, where K15 cannot run either).
  Every n iterations (utils/dispatch.sor_cadence) the residual, the
  mesh-order sum of per-shard owned sums of r², is read back and checked
  against eps² (models/_driver.mesh_convergence_loop).
- `tpu_fuse_phases off` runs the JAX package's phase chain instead
  (`_step_chain`): depth-1 exchanges around the BCs, the F/G donor-edge
  shift (commShift), the projection on the global interior times the live
  mask, in plain torch.
- Obstacle flag fields (canal_obstacle*.par): the fused step feeds K3 the
  shard's deep flag block and K4 its halo-1 block (cells beyond the
  global grid read flag 0, the JAX package's fused_flag_blocks); the
  chain applies the obstacle velocity BC, mask_fg and the masked
  projection with the shard's slices of the global masks
  (ops/obstacle.shard_masks); normalizePressure takes the fluid-weighted
  mean, the sums in mesh order.

- `tpu_overlap on` (the JAX package's overlapped schedule; `auto` takes
  it only on a TPU, so here it records "serial (no TPU)"): the fused step
  with the next step's deep exchange following POST
  (parallel/comm.ExchangeSchedule.post: on the card a second stream's
  copies, issued beside the next interior half) and carried between
  steps, PRE run twice, an interior half on
  the stale re-embedded blocks and a boundary half on the exchanged ones,
  merged by the interior mask (parallel/overlap.py), dt from POST's
  carried maxima through the generation guard; `tpu_overlap_restrict`
  bands the halves' rows (K3's grid-band mode). A `run_steps(n)` or
  `_advance(n)` call is the JAX package's chunk: its first step takes the
  prologue exchange. The grid CA solve becomes its split form
  (`_solve_split`, "split (jnp rb-sor)"); K13 and K15 keep their serial
  sweeps ("serial (pallas/other solve)"). Bitwise the serial step.

On the CPU the same composition runs the kernels' plain versions. The
fields equal NS2DSolver's to round-off where the iteration counts agree.
The depth-scheduled exchange (`tpu_exchange_depth`, with the K-step
chunks), the residual-adaptive itermax and mg/fft on a mesh are refused
(ROADMAP A.8, items 6.2-6.4), the obstacle multigrid too (A.8, item 6.4:
it runs on one device, models/ns2d.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ns2d as ops
from ..ops import obstacle as obst
from ..ops.ns2d_fused import BAND_ROWS, StepConfig, ns2d_post, ns2d_pre
from ..ops.sor_kernels import sor_coefficients
from ..parallel import comm as pc
from ..parallel import overlap as ovl
from ..parallel import quarters_dist as qd
from ..parallel import ragged2d as rg
from ..parallel.comm import (
    CartComm,
    assemble_global,
    reduction,
    scatter_blocks,
)
from ..parallel.stencil2d import (
    ca_halo,
    ca_inner,
    ca_masks,
    ca_rb_iters,
    ca_supported,
    embed_deep,
    rb_exchange_per_sweep,
    rb_split_iter,
    scalar_half,
    strip_deep,
)
from ..utils import dispatch as _dispatch
from ..utils import flags as _flags
from ..utils.datio import write_pressure, write_velocity
from ..utils.params import Parameter
from ..utils.precision import resolve_dtype
from ..utils.progress import Progress
from ._driver import clamped_dt, drive_chunks, mesh_convergence_loop

# the JAX package's ops/ns2d_fused.FUSE_DEEP_HALO: FUSE_FOOTPRINT + 1, as
# the overlapped step's interior rim (parallel/overlap.OVERLAP_RIM)
FUSE_DEEP_HALO = ovl.FUSE_FOOTPRINT + 1


def _resolve_fuse_phases(knob: str, why_not) -> bool:
    """`tpu_fuse_phases` -> whether the step runs K3/K4 on the deep blocks,
    recorded under "ns2d_dist_phases" in the JAX package's terms. The
    kernels run on every device (their plain versions on the CPU), so
    `auto` fuses wherever the shards are deep enough."""
    if knob not in ("auto", "on", "off"):
        raise ValueError(f"tpu_fuse_phases must be auto|on|off, got {knob!r}")
    if knob == "off":
        _dispatch.record("ns2d_dist_phases", "jnp (tpu_fuse_phases off)")
        return False
    if why_not is not None:
        _dispatch.record("ns2d_dist_phases", f"jnp ({why_not})")
        return False
    _dispatch.record("ns2d_dist_phases", "pallas_fused" + (
        " (forced)" if knob == "on" else ""))
    return True


class NS2DDistSolver:
    """Mesh-parallel NS-2D solver with NS2DSolver's interface. The shards
    live on `comm.devices` (default: one per visible card, the `tpu_mesh
    auto` mesh).

    `phase_hook`, when set, is called with "pre", "solve", "post" as each
    phase of a step starts and with "end" after the last one, as in
    NS2DSolver."""

    CHUNK = 64  # steps between progress-bar updates

    def __init__(self, param: Parameter, comm: CartComm | None = None,
                 dtype=None):
        self.comm = comm if comm is not None else CartComm(
            ndims=2, extents=(param.jmax, param.imax),
            tiers=param.tpu_mesh_tiers)
        if self.comm.ndims != 2:
            raise ValueError("NS-2D needs a 2-D mesh (CartComm(ndims=2))")
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None else dtype
        self.imax, self.jmax = param.imax, param.jmax
        self.dx = param.xlength / param.imax
        self.dy = param.ylength / param.jmax
        self.gext = (self.jmax, self.imax)
        self.local = self.comm.local_shape(self.gext, ragged=True)
        self.jl, self.il = self.local
        self.ragged = any(e * p != n for e, p, n in
                          zip(self.local, self.comm.dims, self.gext))
        param = _dispatch.resolve_solver(param, ragged=self.ragged)
        _dispatch.check_supported(param, mesh=True)
        if param.tpu_sor_layout not in ("auto", "checkerboard", "quarters"):
            raise ValueError(
                f"2-D SOR layout must be auto|checkerboard|quarters, got "
                f"{param.tpu_sor_layout!r} (octants is the 3-D layout)")
        self.param = param
        self.offs = [self.comm.offsets(s, self.local)
                     for s in range(self.comm.size)]
        self.masks = None
        if param.obstacles.strip():
            self.masks = obst.make_masks(
                obst.build_fluid(self.imax, self.jmax, self.dx, self.dy,
                                 param.obstacles),
                self.dx, self.dy, param.omg)
        inv_sqr_sum = 1.0 / (self.dx * self.dx) + 1.0 / (self.dy * self.dy)
        self.dt_bound = 0.5 * param.re / inv_sqr_sum
        self.t = 0.0
        self.nt = 0
        self._dt_scale = 1.0
        self._build()
        shape = (self.jl + 2, self.il + 2)
        for name, val in (("u", param.u_init), ("v", param.v_init),
                          ("p", param.p_init)):
            setattr(self, name, [torch.full(shape, val, dtype=self.dtype,
                                            device=dev)
                                 for dev in self.comm.devices])
        self.phase_hook = None
        # the last pressure solve's residual and iteration count, and the
        # last POST's mesh maxima of |u|, |v|
        self.last_res = self.last_it = self.last_maxima = None

    # ------------------------------------------------------------------
    def _build(self):
        param, comm, dtype = self.param, self.comm, self.dtype
        jl, il = self.local
        devices = comm.devices
        self._cfg = StepConfig.from_param(param)
        self._coef = sor_coefficients(self.dx, self.dy, param.omg)
        masks = self.masks
        self._rb_q, self._qg = qd.quarters_dispatch(
            param, self.jmax, self.imax, jl, il, self.dx, self.dy, dtype,
            "ns2d_dist", plain_sor=not self.ragged and masks is None,
            label="pallas")
        self._solve_k = None
        forced = param.tpu_sor_layout == "checkerboard"
        n = _dispatch.sor_cadence(param, dtype, mesh=True, forced=forced)
        if masks is not None:
            _dispatch.record("ns2d_dist", "obstacle (see obstacle_dist)"
                             + (" ragged" if self.ragged else ""))
            args = (comm, self.imax, self.jmax, jl, il, self.dx, self.dy,
                    param.eps, param.itermax, masks, dtype)
            self._solve_k = obst.make_dist_obstacle_solver(
                *args, n=n, ragged=self.ragged) or \
                obst.make_obstacle_fallback(*args, ragged=self.ragged)
        elif self._rb_q is None and (self.ragged or forced):
            # the live region is a flag field: all-fluid flags, the dead
            # cells excluded by the kernel's global gating
            live = obst.make_masks(
                np.ones((self.jmax + 2, self.imax + 2), bool), self.dx,
                self.dy, param.omg)
            self._solve_k = obst.make_dist_obstacle_solver(
                comm, self.imax, self.jmax, jl, il, self.dx, self.dy,
                param.eps, param.itermax, live, dtype, n=n,
                ragged=self.ragged, record_key="ns2d_dist")
        # the grid-space CA path: block size, halo depth and masks; shards
        # that cannot ship its depth-2n (ragged: 2n+1) strips take the
        # exchange-per-half-sweep fallback
        self._ca_ok = ca_supported(jl, il) and (
            not self.ragged or ca_halo(1, True) <= min(jl, il))
        self._n_ca = ca_inner(param, jl, il) if self._ca_ok else 1
        self._H = ca_halo(self._n_ca, self.ragged) if self._ca_ok else 1
        self._masks = None
        if self._rb_q is None and self._solve_k is None:
            _dispatch.record("ns2d_dist",
                             "jnp_ca ragged" if self.ragged else "jnp_ca")
        # the normalizePressure weight (times the fluid field with
        # obstacles), the shards' slices of the masks (the phase chain's)
        # and their deep and halo-1 flag blocks (the fused step's)
        self._weight = [rg.wall_weight_ragged(comm, s, jl, il, self.jmax,
                                              self.imax, dtype, dev)
                        for s, dev in enumerate(devices)]
        self._obs = self._flags = None
        if masks is not None:
            self._obs = [obst.shard_masks(masks, comm, s, jl, il).to(dtype,
                                                                     dev)
                         for s, dev in enumerate(devices)]
            self._weight = [w * m.fluid for w, m in zip(self._weight,
                                                        self._obs)]
            self._flags = [
                tuple(obst.deep_flag_block(masks, comm, s, jl, il, H,
                                           self.jmax, self.imax, dev)
                      for H in (FUSE_DEEP_HALO, 1))
                for s, dev in enumerate(devices)]
        why = None
        if min(jl, il) < FUSE_DEEP_HALO:
            why = f"shard extents < deep halo {FUSE_DEEP_HALO}"
        self._fused = _resolve_fuse_phases(param.tpu_fuse_phases, why)
        if not self._fused and self.ragged:
            # the phase chain's ragged projection: the global interior and
            # the live mask (K4 forms both per cell on the fused path)
            self._interior = [
                ops._global_interior(*rg.global_index_vectors(
                    comm, s, jl, il, dev), self.gext)
                for s, dev in enumerate(devices)]
            self._live = [rg.live_masks(comm, s, jl, il, self.jmax,
                                        self.imax, dtype, dev)
                          for s, dev in enumerate(devices)]
        self._build_overlap()

    def _build_overlap(self):
        """The exchange schedule (JAX: resolve_overlap, the sweep-split
        records, the region plan): under `tpu_overlap on` the overlapped
        step (`_step_overlap`) with, where the solve is the grid CA
        (`_solve_grid`), its split form; the K13/K15 solves keep their
        serial sweeps, as the JAX package keeps its Pallas solves'."""
        param, comm = self.param, self.comm
        self._overlap = _dispatch.resolve_overlap(
            param, "overlap_ns2d_dist", why_not=None if self._fused else
            "needs the fused deep-halo step (tpu_fuse_phases)")
        self._split = self._overlap and self._rb_q is None and \
            self._solve_k is None
        self._overlap_plan = self._carry = None
        if not self._overlap:
            return
        _dispatch.record("sweep_split_ns2d_dist", "split (jnp rb-sor)"
                         if self._split else "serial (pallas/other solve)")
        H = FUSE_DEEP_HALO
        # a mesh axis of size 1 exchanges nothing: no rim on its sides
        part = tuple(d > 1 for d in comm.dims)
        plan = ovl.pre_plan(self.local, part, H - 1, BAND_ROWS)
        if _dispatch.resolve_overlap_restrict(
                param, "overlap_grid_ns2d_dist", plan):
            self._overlap_plan = plan
        self._deep_sched = pc.persistent_exchange(comm, H, self.dtype)
        self._int_mask = [ovl.interior_mask(self.local, ovl.OVERLAP_RIM,
                                            part, dev)
                          for dev in comm.devices]
        if self._split:
            self._split_sched = pc.persistent_exchange(comm, 1, self.dtype)
            self._split_masks = [ovl.interior_mask(self.local, 2, part, dev)
                                 for dev in comm.devices]

    @classmethod
    def from_numpy_state(cls, param: Parameter, comm: CartComm, u, v, p, t,
                         nt, dtype=None):
        """A solver whose state is the given global reference-layout
        (jmax+2, imax+2) fields and time (e.g. a JAX solver's
        global_fields()), scattered to the shards and cast to the dtype."""
        s = cls(param, comm, dtype=dtype)
        s.set_global_fields({"u": u, "v": v, "p": p})
        s.t, s.nt = float(t), int(nt)
        return s

    def set_global_fields(self, fields: dict) -> None:
        """Scatter global reference-layout fields to the shards (the JAX
        package's set_global_fields; dead cells zero). Drops the
        overlapped step's carry, so that no buffer of the old state is
        consumed."""
        self._carry = None
        for name, arr in fields.items():
            blocks = scatter_blocks(np.array(arr), self.comm, self.local)
            setattr(self, name, [
                torch.from_numpy(b).to(device=dev, dtype=self.dtype)
                for b, dev in zip(blocks, self.comm.devices)])

    def global_fields(self) -> dict:
        """The reference-layout (jmax+2, imax+2) fields on the host,
        mesh-independent: block interiors everywhere, ghost strips from
        the wall shards, the ragged dead cells cropped."""
        return {name: assemble_global(getattr(self, name), self.comm,
                                      self.gext)
                for name in ("u", "v", "p")}

    def fields(self):
        """(u, v, p) as global reference-layout numpy arrays."""
        g = self.global_fields()
        return g["u"], g["v"], g["p"]

    def _mark(self, phase: str) -> None:
        if self.phase_hook is not None:
            self.phase_hook(phase)

    def _on_shards(self, x):
        """A 0-dim tensor (on shard 0's device) for every shard's device."""
        return [x.to(dev) for dev in self.comm.devices]

    # -- the CFL dt and normalizePressure --------------------------------
    def _maxima(self, *fields):
        """The mesh maxima of |x| (ghosts included) of each field."""
        return tuple(reduction([ops.max_element(b) for b in x], self.comm,
                               "max") for x in fields)

    def _cfl(self, umax, vmax):
        """The CFL dt from the mesh maxima of u and v, or the fixed dt
        when tau <= 0 (before the recovery clamp)."""
        param = self.param
        if param.tau > 0.0:
            return ops.cfl_dt(umax, vmax, self.dt_bound, self.dx, self.dy,
                              param.tau)
        return torch.full((), param.dt, dtype=self.dtype,
                          device=self.comm.devices[0])

    def _dt(self, u, v):
        """The CFL dt from the mesh maxima of u and v (ghosts included),
        or the fixed dt when tau <= 0."""
        umax, vmax = self._maxima(u, v) if self.param.tau > 0.0 else (
            None, None)
        return clamped_dt(self._cfl(umax, vmax), self._dt_scale)

    def _normalize(self, p):
        """normalizePressure: p minus the mean over the global
        (jmax+2, imax+2) array, each position counted once (the wall
        weight), the sum in mesh order; with obstacles the fluid-weighted
        mean (normalize_pressure_fluid), the weights' sum in mesh order
        too."""
        total = reduction([torch.sum(x * w) for x, w in
                           zip(p, self._weight)], self.comm, "sum")
        if self.masks is not None:
            mean = total / reduction([torch.sum(w) for w in self._weight],
                                     self.comm, "sum")
        else:
            mean = total / ops._const(
                float((self.imax + 2) * (self.jmax + 2)), total)
        return [x - m for x, m in zip(p, self._on_shards(mean))]

    # -- the pressure solve ----------------------------------------------
    def _solve(self, p, rhs):
        """The pressure solve on the halo-1 blocks; returns (p exchanged,
        res, it): the projection reads p across shard edges (the
        reference's trailing commExchange)."""
        if self._rb_q is not None:
            return self._solve_quarters(p, rhs)
        if self._solve_k is not None:
            return self._solve_k(p, rhs)
        if self._split:
            return self._solve_split(p, rhs)
        return self._solve_grid(p, rhs)

    def _loop(self, rounds):
        return mesh_convergence_loop(rounds, self.comm, self.dtype,
                                     self.imax * self.jmax, self.param.eps,
                                     self.param.itermax)

    def _solve_quarters(self, p, rhs):
        """The stacked-quarter CA solve, K13 on every shard."""
        comm, qg = self.comm, self._qg
        qoffs = [(jo // 2, io // 2) for jo, io in self.offs]
        rq = qd.q_exchange([qd.pack_ext_to_q(r, qg) for r in rhs], comm, qg)
        xq = [qd.pack_ext_to_q(x, qg) for x in p]
        # two lists of planes, each with the exchange's views bound to it:
        # K13 reads the first and writes the second, and the two swap, so
        # the first holds the newest planes
        planes = [xq, [torch.empty_like(x) for x in xq]]
        copies = [qd.q_exchange_copies(x, comm, qg) for x in planes]

        def rounds():
            qd.q_exchange(planes[0], comm, qg, copies[0])
            r2 = [self._rb_q(o, x, f, out=y)
                  for o, x, y, f in zip(qoffs, *planes, rq)]
            planes.reverse()
            copies.reverse()
            return r2, qg.n

        res, it = self._loop(rounds)
        p = pc.halo_exchange([qd.unpack_q_to_ext(x, qg) for x in planes[0]],
                             comm)
        return p, res, it

    def _grid_masks(self):
        if self._masks is None:
            self._masks = [ca_masks(self.jl, self.il, self._H, self.jmax,
                                    self.imax, self.dtype, *off, device=dev)
                           for off, dev in zip(self.offs, self.comm.devices)]
        return self._masks

    def _solve_grid(self, p, rhs):
        """The grid-space CA solve (one depth-2n exchange per n exact
        iterations), or the exchange-per-half-sweep fallback on shards
        too thin for its strips."""
        comm, H, masks = self.comm, self._H, self._grid_masks()
        pd = [embed_deep(x, H) for x in p]
        rd = pc.halo_exchange([embed_deep(x, H) for x in rhs], comm, depth=H)

        def rounds():
            if not self._ca_ok:
                new, r2 = rb_exchange_per_sweep(
                    pd, rd, masks, comm, scalar_half(masks, *self._coef),
                    ragged=self.ragged)
                pd[:] = new
                return r2, 1
            pc.halo_exchange(pd, comm, depth=H)
            r2 = []
            for s, (m, f) in enumerate(zip(masks, rd)):
                pd[s], r = ca_rb_iters(pd[s], f, self._n_ca, m, *self._coef)
                r2.append(r)
            return r2, self._n_ca

        res, it = self._loop(rounds)
        p = pc.halo_exchange([strip_deep(x, H).contiguous() for x in pd],
                             comm)
        return p, res, it

    def _solve_split(self, p, rhs):
        """The grid CA solve's twin under the overlapped schedule (JAX
        _solve_sor_split): the same residual cadence (n iterations a
        check), each half-sweep's depth-1 exchange posted beside the
        interior update (parallel/stencil2d.rb_split_iter), on the halo-1
        blocks; bitwise the CA trajectory."""
        comm = self.comm
        masks = [ca_masks(self.jl, self.il, 1, self.jmax, self.imax,
                          self.dtype, *off, device=dev)
                 for off, dev in zip(self.offs, comm.devices)]
        blocks = list(p)

        def rounds():
            r2 = None
            for _ in range(self._n_ca):
                blocks[:], r2 = rb_split_iter(
                    blocks, rhs, masks, self._split_sched, self._split_masks,
                    *self._coef, ragged=self.ragged)
            return r2, self._n_ca

        res, it = self._loop(rounds)
        return pc.halo_exchange(blocks, comm), res, it

    def _pressure(self, rhs):
        """normalizePressure every 100 steps, then the solve."""
        if self.nt % 100 == 0:
            self.p = self._normalize(self.p)
        self.p, self.last_res, self.last_it = self._solve(self.p, rhs)

    # -- the steps ---------------------------------------------------------
    def _step_fused(self):
        """One step through K3 and K4 (JAX step_fused): one deep exchange
        feeds PRE, the solve, POST on the halo-1 blocks."""
        comm, H = self.comm, FUSE_DEEP_HALO
        self._mark("pre")
        ud, vd = (pc.halo_exchange([embed_deep(b, H) for b in x], comm,
                                   depth=H) for x in (self.u, self.v))
        dt = self._dt(ud, vd)
        dts = self._on_shards(dt)
        f, g, rhs = [], [], []
        flags = self._flags or [(None, None)] * comm.size
        for s in range(comm.size):
            out = ns2d_pre(ud[s], vd[s], dts[s], self._cfg, self.offs[s],
                           self.gext, H - 1, flags[s][0])
            for lst, a in zip((f, g, rhs), out):
                lst.append(a)
        u, v = ([strip_deep(b, H).contiguous() for b in x] for x in (ud, vd))
        self._mark("solve")
        self._pressure(rhs)
        self._mark("post")
        maxima = [ns2d_post(u[s], v[s], f[s], g[s], self.p[s], dts[s],
                            self.dx, self.dy, self.offs[s], self.gext,
                            self.ragged, flags[s][1])
                  for s in range(comm.size)]
        self.last_maxima = tuple(reduction(list(m), comm, "max")
                                 for m in zip(*maxima))
        self.u, self.v = u, v
        self._mark("end")
        return dt

    def _exchange_buffers(self, u, v, ready=None):
        """Post the deep exchange of u and v (the double buffer's fill):
        embed_deep and the depth-3 exchange, on the card on the side
        stream after `ready` (parallel/comm.ExchangeSchedule.post)."""
        H = FUSE_DEEP_HALO
        return self._deep_sched.post([u, v], lambda b: embed_deep(b, H),
                                     ready=ready)

    def _overlap_prologue(self):
        """The carry's first generation (JAX: the overlapped chunk's
        prologue): the deep exchange of the current u, v, waited on, and
        the CFL maxima of the exchanged blocks (the serial step's dt
        inputs); later steps carry POST's maxima."""
        posted = self._exchange_buffers(self.u, self.v)
        um, vm = self._maxima(*posted.wait())
        self._carry = (lambda: posted, um, vm, self.nt)

    def _step_overlap(self):
        """One overlapped step (JAX step_overlap): dt from the carried
        maxima through the generation guard; PRE twice, the interior half
        on the stale re-embedded blocks (K3 writes its BCs in place, so on
        copies) and the boundary half on the double buffer, merged by the
        interior mask; the solve; POST, whose maxima feed the next dt. The
        next step's deep exchange follows POST: on the card its copies
        wait on events recorded right after POST, and the host issues them
        after the next step's interior half, so that the two run side by
        side; only the boundary half waits on them. With
        `tpu_overlap_restrict` the halves run K3's grid-band mode over the
        region plan's bands."""
        comm, H = self.comm, FUSE_DEEP_HALO
        if self._carry is None:
            self._overlap_prologue()
        start, um, vm, gen = self._carry
        self._mark("pre")
        dt = clamped_dt(ovl.generation_guard(self._cfl(um, vm), gen, self.nt),
                        self._dt_scale)
        dts = self._on_shards(dt)
        flags = self._flags or [(None, None)] * comm.size
        plan = self._overlap_plan
        bands = (None, None) if plan is None else (plan["int_bands"],
                                                   plan["bnd_bands"])

        def half(ud, vd, b):
            outs = [ns2d_pre(ud[s], vd[s], dts[s], self._cfg, self.offs[s],
                             self.gext, H - 1, flags[s][0], bands=b)
                    for s in range(comm.size)]
            return [[strip_deep(ud[s], H), strip_deep(vd[s], H), *outs[s]]
                    for s in range(comm.size)]

        inner = half(*([embed_deep(x, H) for x in f] for f in (self.u,
                                                              self.v)),
                     bands[0])
        outer = half(*start().wait(), bands[1])
        u, v, f, g, rhs = (list(x) for x in zip(*(
            ovl.merge_halves(m, a, b)
            for m, a, b in zip(self._int_mask, inner, outer))))
        self._mark("solve")
        self._pressure(rhs)
        self._mark("post")
        maxima = [ns2d_post(u[s], v[s], f[s], g[s], self.p[s], dts[s],
                            self.dx, self.dy, self.offs[s], self.gext,
                            self.ragged, flags[s][1])
                  for s in range(comm.size)]
        um, vm = self.last_maxima = tuple(
            reduction(list(m), comm, "max") for m in zip(*maxima))
        self.u, self.v = u, v
        ready = pc.ready_events(comm)
        self._carry = (lambda: self._exchange_buffers(u, v, ready), um, vm,
                       self.nt + 1)
        self._mark("end")
        return dt

    def _step_chain(self):
        """One step of the phase chain (JAX step, `tpu_fuse_phases off`):
        exchanges around the BCs, the F/G donor-edge shift before the RHS,
        the projection on the global interior times the live mask. The
        BCs and fixups are gated by the global index (parallel/ragged2d.py)
        on every mesh; what they write on interface ghosts the following
        exchange overwrites. With obstacles the velocity BC follows the
        exchanged BCs (and one more exchange), F/G carry U/V on non-fluid
        faces and the projection runs on fluid-fluid faces, with the
        shard's slices of the global masks."""
        comm, cfg, param = self.comm, self._cfg, self.param
        jl, il = self.local
        J, I = self.gext
        self._mark("pre")
        for x in (self.u, self.v):
            pc.halo_exchange(x, comm)
        dt = self._dt(self.u, self.v)
        dts = self._on_shards(dt)
        for s in range(comm.size):
            u, v = rg.set_bcs_ragged(self.u[s], self.v[s], param, comm, s,
                                     jl, il, J, I)
            self.u[s] = rg.set_special_bc_ragged(u, param, comm, s, jl, il,
                                                 J, I, self.dy)
            self.v[s] = v
        for x in (self.u, self.v):
            pc.halo_exchange(x, comm)
        if self._obs is not None:
            for s in range(comm.size):
                self.u[s], self.v[s] = obst.apply_obstacle_velocity_bc(
                    self.u[s], self.v[s], self._obs[s])
            for x in (self.u, self.v):
                pc.halo_exchange(x, comm)
        f, g = [], []
        for s in range(comm.size):
            u, v = self.u[s], self.v[s]
            fs, gs = rg.fg_fixups_ragged(
                *ops.compute_fg_interior(u, v, dts[s], cfg.re, cfg.gx, cfg.gy,
                                         cfg.gamma, self.dx, self.dy),
                u, v, comm, s, jl, il, J, I)
            if self._obs is not None:
                fs, gs = obst.mask_fg(fs, gs, u, v, self._obs[s])
            f.append(fs)
            g.append(gs)
        pc.halo_shift(f, comm, "i")
        pc.halo_shift(g, comm, "j")
        rhs = [ops.compute_rhs(a, b, d, self.dx, self.dy)
               for a, b, d in zip(f, g, dts)]
        self._mark("solve")
        self._pressure(rhs)
        self._mark("post")
        for s in range(comm.size):
            if self._obs is None:
                ua, va = ops.adapt_uv(self.u[s], self.v[s], f[s], g[s],
                                      self.p[s], dts[s], self.dx, self.dy)
            else:
                ua, va = obst.adapt_uv_obstacle(
                    self.u[s], self.v[s], f[s], g[s], self.p[s], dts[s],
                    self.dx, self.dy, self._obs[s])
            if self.ragged:
                m, live = self._interior[s], self._live[s]
                self.u[s] = torch.where(m, ua, self.u[s]) * live
                self.v[s] = torch.where(m, va, self.v[s]) * live
            else:
                self.u[s], self.v[s] = ua, va
        self._mark("end")
        return dt

    def _step(self) -> None:
        dt = (self._step_overlap() if self._overlap else
              self._step_fused() if self._fused else self._step_chain())
        dt_host = float(dt)
        self.t += dt_host
        self.nt += 1
        if _flags.verbose():
            pc.master_print(self.comm, "TIME {} , TIMESTEP {}", self.t,
                            dt_host)

    def run_steps(self, n: int) -> None:
        """Advance exactly n steps, whatever te says. Under the overlapped
        schedule a call is the JAX package's chunk dispatch: it starts
        with the prologue exchange."""
        self._carry = None
        for _ in range(n):
            self._step()

    def _advance(self, n: int) -> float:
        te = self.param.te
        self._carry = None
        for _ in range(n):
            if not self.t <= te:
                break
            self._step()
        return self.t

    def run(self, progress: bool = True) -> None:
        """Advance from t to te (a step runs whenever t <= te at its
        start), drawing the progress bar every CHUNK steps."""
        bar = Progress(self.param.te,
                       enabled=progress and not _flags.verbose())
        drive_chunks(self._advance, self.t, self.param.te, bar,
                     self.param.tpu_chunk or self.CHUNK)

    # -- output ----------------------------------------------------------
    def write_result(self, pressure_path: str = "pressure.dat",
                     velocity_path: str = "velocity.dat") -> None:
        """pressure.dat and velocity.dat from the gathered global fields."""
        u, v, p = self.fields()
        write_pressure(p, self.dx, self.dy, pressure_path)
        write_velocity(u, v, self.dx, self.dy, velocity_path)
