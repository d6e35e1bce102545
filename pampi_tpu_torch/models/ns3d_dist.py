"""Distributed NS-3D over a 3-D ("k", "j", "i") mesh of shards
(counterpart of pampi_tpu/models/ns3d_dist.py). The reference's
assignment-6 hands out the MPI bodies of comm.c as `// fill` skeletons; the
JAX package completes them and this module ports that solver.

- Every field is a list of per-shard halo-1 extended blocks (kl+2, jl+2,
  il+2) in mesh order, shard s on `comm.devices[s]` (parallel/comm.py: one
  controller loops over the shards; a mesh with more shards than cards
  shares them).
- Any grid runs on any mesh: the blocks are ceil-divided
  (`comm.local_shape(..., ragged=True)`), and on a mesh that does not
  divide the grid the trailing shards' cells past the global ghost ring
  are dead (the JAX package's pad-with-mask decomposition,
  parallel/ragged3d.py). Every BC and fixup is gated by the global index,
  so the HI walls may sit anywhere inside a trailing shard; the
  projection zeroes the dead cells (K8's ragged mode, the chain's live
  mask), so the ghost-inclusive CFL maxima never read them. There the
  solve is the grid-space CA path at depth ca_halo(n, True) = 2n + 1 (the
  octants are not dispatched), or with obstacles the JAX package's jnp
  path (ops/obstacle3d.make_dist_obstacle_solver_3d(ragged=True)), and
  `tpu_solver mg|fft` raise the JAX package's ValueError.
- The fused step (`tpu_fuse_phases` auto/on, the default): one depth-3
  deep-halo exchange of u, v, w; the CFL dt from the maxima of the
  exchanged deep blocks (the JAX package's order, which equals the
  single-device solver's maxima of the previous POST); PRE (kernel K7 in
  its distributed mode) on every shard's deep block; the pressure solve;
  POST (K8) on the halo-1 blocks, whose per-shard maxima are reduced in
  mesh order (`last_maxima`).
- The pressure solve: the octant layout (parallel/octants_dist.py, kernel
  K14 per shard, one depth-n octant exchange per n iterations) where every
  shard extent is even and at least 4, else the grid-space CA path
  (parallel/stencil3d.py, plain torch; `tpu_sor_layout checkerboard`).
  The residual is the mesh-order sum of per-shard owned sums of r², read
  back and checked against eps² every n iterations, as in
  models/poisson_dist.py.
- `tpu_fuse_phases off` runs the JAX package's phase chain instead
  (`_step_chain`): depth-1 exchanges, the BCs gated by the global index,
  the F/G/H donor-edge shift (commShift) and the projection in plain
  torch.
- Obstacle flag fields (ops/obstacle3d.py): the global masks are built
  once and every shard cuts its own blocks from them. The octants are
  not dispatched; the solve is make_dist_obstacle_solver_3d (kernel K16
  per shard, one depth-2n exchange per n iterations, the residual
  normalised by the fluid cells). The fused step feeds K7/K8 the shard's
  deep flag block (PRE) and halo-1 one (POST); the chain applies the
  obstacle velocity BC, mask_fgh and the masked projection on the
  shard's masks, with one more exchange after the obstacle BC, as the
  JAX package's chain does.
- `tpu_overlap on`: the overlapped schedule of models/ns2d_dist.py one
  dimension up (`_step_overlap`; seven fields merged, K7's grid-band mode
  over k-planes under `tpu_overlap_restrict`, the grid CA solve split,
  K14 and the obstacle solve serial); `auto` records "serial (no TPU)".
  The depth-scheduled exchange and the residual-adaptive itermax are
  refused (ROADMAP A.8, items 6.2 and 6.3).

On the CPU the same composition runs the kernels' plain versions. Every
path keeps the single-device trajectory: the fields equal NS3DSolver's
bitwise where the iteration counts agree (they can differ only at the eps
threshold, where the residual is summed in another order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ns3d as ops
from ..ops import obstacle3d as obst3
from ..ops.ns3d_fused import BAND_ROWS, StepConfig3D, ns3d_post, ns3d_pre
from ..ops.sor3d import sor_coefficients_3d
from ..parallel import comm as pc
from ..parallel import octants_dist as od
from ..parallel import overlap as ovl
from ..parallel import ragged3d as rg3
from ..parallel.comm import (
    CartComm,
    assemble_global,
    reduction,
    scatter_blocks,
)
from ..parallel.stencil2d import (
    ca_clamp,
    ca_halo,
    ca_inner,
    ca_supported,
    embed_deep,
    strip_deep,
)
from ..parallel.stencil3d import (
    ca_masks_3d,
    ca_rb_iters_3d,
    rb_exchange_per_sweep_3d,
    rb_split_iter_3d,
)
from ..utils import dispatch as _dispatch
from ..utils import flags as _flags
from ..utils.grid import Grid
from ..utils.params import Parameter
from ..utils.precision import resolve_dtype
from ..utils.progress import Progress
from ..utils.vtkio import ShardedVtkWriter, VtkWriter
from ._driver import clamped_dt, drive_chunks, mesh_convergence_loop

# the JAX package's ops/ns2d_fused.FUSE_DEEP_HALO: FUSE_FOOTPRINT + 1, as
# the overlapped step's interior rim (parallel/overlap.OVERLAP_RIM)
FUSE_DEEP_HALO = ovl.FUSE_FOOTPRINT + 1


def _resolve_fuse_phases(knob: str, why_not) -> bool:
    """`tpu_fuse_phases` -> whether the step runs K7/K8 on the deep blocks,
    recorded under "ns3d_dist_phases" in the JAX package's terms. The
    kernels run on every device (their plain versions on the CPU), so
    `auto` fuses wherever the shards are deep enough."""
    if knob not in ("auto", "on", "off"):
        raise ValueError(f"tpu_fuse_phases must be auto|on|off, got {knob!r}")
    if knob == "off":
        _dispatch.record("ns3d_dist_phases", "jnp (tpu_fuse_phases off)")
        return False
    if why_not is not None:
        _dispatch.record("ns3d_dist_phases", f"jnp ({why_not})")
        return False
    _dispatch.record("ns3d_dist_phases", "kernel_fused" + (
        " (forced)" if knob == "on" else ""))
    return True


class NS3DDistSolver:
    """Mesh-parallel NS-3D solver with NS3DSolver's interface. The shards
    live on `comm.devices` (default: one per visible card, the `tpu_mesh
    auto` mesh).

    `phase_hook`, when set, is called with "pre", "solve", "post" as each
    phase of a step starts and with "end" after the last one, as in
    NS3DSolver."""

    CHUNK = 32  # steps between progress-bar updates

    def __init__(self, param: Parameter, comm: CartComm | None = None,
                 dtype=None):
        self.comm = comm if comm is not None else CartComm(
            ndims=3, extents=(param.kmax, param.jmax, param.imax),
            tiers=param.tpu_mesh_tiers)
        if self.comm.ndims != 3:
            raise ValueError("NS-3D needs a 3-D mesh (CartComm(ndims=3))")
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None else dtype
        self.grid = g = Grid(imax=param.imax, jmax=param.jmax,
                             kmax=param.kmax, xlength=param.xlength,
                             ylength=param.ylength, zlength=param.zlength)
        self.gext = (g.kmax, g.jmax, g.imax)
        self.local = self.comm.local_shape(self.gext, ragged=True)
        self.kl, self.jl, self.il = self.local
        self.ragged = any(e * p != n for e, p, n in
                          zip(self.local, self.comm.dims, self.gext))
        param = _dispatch.resolve_solver(param, ragged=self.ragged)
        if self.ragged and param.tpu_solver in ("mg", "fft"):
            raise ValueError(
                f"tpu_solver {param.tpu_solver} needs a divisible grid/mesh "
                f"(grid {g.kmax}x{g.jmax}x{g.imax} on {self.comm.dims}); "
                "ragged pad-with-mask runs use tpu_solver sor (obstacles "
                "compose)")
        _dispatch.check_supported(param, mesh=True)
        if param.tpu_sor_layout not in ("auto", "checkerboard", "octants"):
            raise ValueError(
                f"3-D SOR layout must be auto|checkerboard|octants, got "
                f"{param.tpu_sor_layout!r} (quarters is the 2-D layout)")
        self.param = param
        self.offs = [self.comm.offsets(s, self.local)
                     for s in range(self.comm.size)]
        # obstacle flag fields: the global static masks, which every shard
        # cuts its blocks from (check_supported leaves only sor here)
        self.masks = None
        if param.obstacles.strip():
            self.masks = obst3.make_masks_3d(
                obst3.build_fluid_3d(g.imax, g.jmax, g.kmax, g.dx, g.dy,
                                     g.dz, param.obstacles),
                g.dx, g.dy, g.dz, param.omg)
        inv_sqr_sum = 1.0 / g.dx**2 + 1.0 / g.dy**2 + 1.0 / g.dz**2
        self.dt_bound = 0.5 * param.re / inv_sqr_sum
        self.t = 0.0
        self.nt = 0
        self._dt_scale = 1.0
        self._build()
        shape = tuple(e + 2 for e in self.local)
        for name, val in (("u", param.u_init), ("v", param.v_init),
                          ("w", param.w_init), ("p", param.p_init)):
            setattr(self, name, [torch.full(shape, val, dtype=self.dtype,
                                            device=dev)
                                 for dev in self.comm.devices])
        self.phase_hook = None
        # the last pressure solve's residual and iteration count, and the
        # last POST's mesh maxima of |u|, |v|, |w|
        self.last_res = self.last_it = self.last_maxima = None

    # ------------------------------------------------------------------
    def _build(self):
        param, g, comm = self.param, self.grid, self.comm
        kl, jl, il = self.local
        self._cfg = StepConfig3D.from_param(param)
        self._coef = sor_coefficients_3d(g.dx, g.dy, g.dz, param.omg)
        self._rb_o, self._og, self._n_o = od.octants_dispatch(
            param, g.kmax, g.jmax, g.imax, kl, jl, il, g.dx, g.dy, g.dz,
            self.dtype, "ns3d_dist", dims=comm.dims,
            plain_sor=self.masks is None and not self.ragged)
        if self._rb_o is None:
            _dispatch.record("ns3d_dist", ("jnp_ca" if self.masks is None
                                           else "obstacle_jnp")
                             + (" ragged" if self.ragged else ""))
        self._obs_solve = self._flags = self._local_masks = None
        if self.masks is not None:
            # the kernel's depth on a divisible mesh; on a ragged one the
            # JAX package's jnp path, which takes tpu_ca_inner at every
            # dtype
            n = (param.tpu_ca_inner if self.ragged else _dispatch.sor_cadence(
                param, self.dtype, mesh=True,
                clamp=lambda n: ca_clamp(n, kl, jl, il)))
            self._obs_solve, _ = obst3.make_dist_obstacle_solver_3d(
                comm, g.imax, g.jmax, g.kmax, kl, jl, il, g.dx, g.dy, g.dz,
                param.eps, param.itermax, self.masks, self.dtype, n,
                ragged=self.ragged)
            # the fused kernels' flag blocks: the deep block for PRE, the
            # halo-1 block for POST (the JAX package's fused_flag_blocks)
            self._flags = [
                tuple(obst3.deep_flag_block_3d(self.masks, comm, s, kl, jl,
                                               il, H, dev)
                      for H in (FUSE_DEEP_HALO, 1))
                for s, dev in enumerate(comm.devices)]
        # the grid-space CA path: block size, halo depth and masks
        self._ca_ok = ca_supported(kl, jl, il)
        self._n_ca = ca_inner(param, kl, jl, il) if self._ca_ok else 1
        self._H = ca_halo(self._n_ca, self.ragged) if self._ca_ok else 1
        self._masks = None
        why = None
        if min(self.local) < FUSE_DEEP_HALO:
            why = f"shard extents < deep halo {FUSE_DEEP_HALO}"
        self._fused = _resolve_fuse_phases(param.tpu_fuse_phases, why)
        self._gates = None
        if not self._fused and self.ragged:
            # the phase chain's ragged projection: the global interior and
            # the live mask (K8 forms both per cell on the fused path)
            self._gates = [rg3.interior_and_live(
                comm, s, kl, jl, il, g.kmax, g.jmax, g.imax, self.dtype, dev)
                for s, dev in enumerate(comm.devices)]
        self._build_overlap()

    def _build_overlap(self):
        """The exchange schedule (JAX: resolve_overlap, the sweep-split
        records, the region plan over k-planes): under `tpu_overlap on`
        the overlapped step (`_step_overlap`) with, where the solve is the
        grid CA (`_solve_grid`), its split form; the K14 and obstacle
        solves keep their serial sweeps."""
        param, comm = self.param, self.comm
        self._overlap = _dispatch.resolve_overlap(
            param, "overlap_ns3d_dist", why_not=None if self._fused else
            "needs the fused deep-halo step (tpu_fuse_phases)")
        self._split = self._overlap and self._obs_solve is None and \
            self._rb_o is None
        self._overlap_plan = self._carry = None
        if not self._overlap:
            return
        _dispatch.record("sweep_split_ns3d_dist", "split (jnp rb-sor)"
                         if self._split else "serial (pallas/other solve)")
        H = FUSE_DEEP_HALO
        part = tuple(d > 1 for d in comm.dims)
        plan = ovl.pre_plan(self.local, part, H - 1, BAND_ROWS)
        if _dispatch.resolve_overlap_restrict(
                param, "overlap_grid_ns3d_dist", plan):
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
    def from_numpy_state(cls, param: Parameter, comm: CartComm, u, v, w, p,
                         t, nt, dtype=None):
        """A solver whose state is the given global reference-layout
        (kmax+2, jmax+2, imax+2) fields and time (e.g. a JAX solver's
        global_fields()), scattered to the shards and cast to the dtype."""
        s = cls(param, comm, dtype=dtype)
        s.set_global_fields({"u": u, "v": v, "w": w, "p": p})
        s.t, s.nt = float(t), int(nt)
        return s

    def set_global_fields(self, fields: dict) -> None:
        """Scatter global reference-layout fields to the shards (the JAX
        package's set_global_fields). Drops the overlapped step's carry,
        so that no buffer of the old state is consumed."""
        self._carry = None
        for name, arr in fields.items():
            blocks = scatter_blocks(np.array(arr), self.comm, self.local)
            setattr(self, name, [
                torch.from_numpy(b).to(device=dev, dtype=self.dtype)
                for b, dev in zip(blocks, self.comm.devices)])

    def global_fields(self) -> dict:
        """The reference-layout (kmax+2, jmax+2, imax+2) fields on the
        host, mesh-independent."""
        return {name: assemble_global(getattr(self, name), self.comm,
                                      self.gext)
                for name in ("u", "v", "w", "p")}

    def _mark(self, phase: str) -> None:
        if self.phase_hook is not None:
            self.phase_hook(phase)

    def _on_shards(self, x):
        """A 0-dim tensor (on shard 0's device) for every shard's device."""
        return [x.to(dev) for dev in self.comm.devices]

    # -- the CFL dt ------------------------------------------------------
    def _maxima(self, *fields):
        """The mesh maxima of |x| (ghosts included) of each field."""
        return tuple(reduction([ops.max_element(b) for b in x], self.comm,
                               "max") for x in fields)

    def _cfl(self, umax, vmax, wmax):
        """The CFL dt from the mesh maxima of u, v, w, or the fixed dt when
        tau <= 0 (before the recovery clamp)."""
        param, g = self.param, self.grid
        if param.tau > 0.0:
            return ops.cfl_dt_3d(umax, vmax, wmax, self.dt_bound, g.dx,
                                 g.dy, g.dz, param.tau)
        return torch.full((), param.dt, dtype=self.dtype,
                          device=self.comm.devices[0])

    def _dt(self, u, v, w):
        """The CFL dt from the mesh maxima of u, v, w (ghosts included), or
        the fixed dt when tau <= 0."""
        maxima = self._maxima(u, v, w) if self.param.tau > 0.0 else (
            None,) * 3
        return clamped_dt(self._cfl(*maxima), self._dt_scale)

    # -- the pressure solve ----------------------------------------------
    def _loop(self, rounds):
        g = self.grid
        return mesh_convergence_loop(rounds, self.comm, self.dtype,
                                     g.imax * g.jmax * g.kmax,
                                     self.param.eps, self.param.itermax)

    def _solve(self, p, rhs):
        """The pressure solve on the halo-1 blocks; returns (p exchanged,
        res, it)."""
        if self._obs_solve is not None:
            return self._obs_solve(p, rhs)
        if self._rb_o is not None:
            return self._solve_octants(p, rhs)
        if self._split:
            return self._solve_split(p, rhs)
        return self._solve_grid(p, rhs)

    def _solve_octants(self, p, rhs):
        """The stacked-octant CA solve, K14 on every shard; returns the
        exchanged halo-1 blocks (the projection reads p across shard
        edges, the reference's trailing commExchange)."""
        comm, og = self.comm, self._og
        qoffs = [tuple(o // 2 for o in off) for off in self.offs]
        ro = od.o_exchange([od.pack_ext_to_o(r, og) for r in rhs], comm, og)
        xo = [od.pack_ext_to_o(x, og) for x in p]
        # two lists of volumes, each with the exchange's views bound to it:
        # K14 reads the first and writes the second, and the two swap, so
        # the first holds the newest volumes
        vols = [xo, [torch.empty_like(x) for x in xo]]
        copies = [od.o_exchange_copies(x, comm, og) for x in vols]

        def rounds():
            od.o_exchange(vols[0], comm, og, copies[0])
            r2 = [self._rb_o(q, x, f, y)
                  for q, x, y, f in zip(qoffs, *vols, ro)]
            vols.reverse()
            copies.reverse()
            return r2, og.n

        res, it = self._loop(rounds)
        p = pc.halo_exchange([od.unpack_o_to_ext(x, og) for x in vols[0]],
                             comm)
        return p, res, it

    def _grid_masks(self):
        if self._masks is None:
            g = self.grid
            self._masks = [ca_masks_3d(
                *self.local, self._H, g.kmax, g.jmax, g.imax, self.dtype,
                *off, device=dev)
                for off, dev in zip(self.offs, self.comm.devices)]
        return self._masks

    def _solve_grid(self, p, rhs):
        """The grid-space CA solve (one depth-2n exchange per n exact
        iterations), or the exchange-per-half-sweep fallback on extent-1
        shards."""
        comm, H, masks = self.comm, self._H, self._grid_masks()
        pd = [embed_deep(x, H) for x in p]
        rd = pc.halo_exchange([embed_deep(x, H) for x in rhs], comm, depth=H)

        def rounds():
            if not self._ca_ok:
                new, r2 = rb_exchange_per_sweep_3d(pd, rd, masks, comm,
                                                   *self._coef,
                                                   ragged=self.ragged)
                pd[:] = new
                return r2, 1
            pc.halo_exchange(pd, comm, depth=H)
            r2 = []
            for s, (m, f) in enumerate(zip(masks, rd)):
                pd[s], r = ca_rb_iters_3d(pd[s], f, self._n_ca, m,
                                          *self._coef)
                r2.append(r)
            return r2, self._n_ca

        res, it = self._loop(rounds)
        p = pc.halo_exchange([strip_deep(x, H).contiguous() for x in pd],
                             comm)
        return p, res, it

    def _solve_split(self, p, rhs):
        """The grid CA solve's twin under the overlapped schedule (JAX
        _solve_sor_split): the same residual cadence, each half-sweep's
        depth-1 exchange posted beside the interior update
        (parallel/stencil3d.rb_split_iter_3d), on the halo-1 blocks;
        bitwise the CA trajectory."""
        comm, g = self.comm, self.grid
        masks = [ca_masks_3d(*self.local, 1, g.kmax, g.jmax, g.imax,
                             self.dtype, *off, device=dev)
                 for off, dev in zip(self.offs, comm.devices)]
        blocks = list(p)

        def rounds():
            r2 = None
            for _ in range(self._n_ca):
                blocks[:], r2 = rb_split_iter_3d(
                    blocks, rhs, masks, self._split_sched, self._split_masks,
                    *self._coef, ragged=self.ragged)
            return r2, self._n_ca

        res, it = self._loop(rounds)
        return pc.halo_exchange(blocks, comm), res, it

    # -- the steps ---------------------------------------------------------
    def _step_fused(self):
        """One step through K7 and K8 (JAX step_fused): one deep exchange
        feeds PRE, the solve, POST on the halo-1 blocks."""
        comm, g, H = self.comm, self.grid, FUSE_DEEP_HALO
        self._mark("pre")
        deep = [pc.halo_exchange([embed_deep(b, H) for b in x], comm,
                                 depth=H)
                for x in (self.u, self.v, self.w)]
        dt = self._dt(*deep)
        dts = self._on_shards(dt)
        flags = self._flags or [(None, None)] * comm.size
        f, gg, h, rhs = [], [], [], []
        for s in range(comm.size):
            out = ns3d_pre(deep[0][s], deep[1][s], deep[2][s], dts[s],
                           self._cfg, self.offs[s], self.gext, H - 1,
                           flags=flags[s][0])
            for lst, a in zip((f, gg, h, rhs), out):
                lst.append(a)
        u, v, w = ([strip_deep(b, H).contiguous() for b in x] for x in deep)
        self._mark("solve")
        self.p, self.last_res, self.last_it = self._solve(self.p, rhs)
        self._mark("post")
        maxima = [ns3d_post(u[s], v[s], w[s], f[s], gg[s], h[s], self.p[s],
                            dts[s], g.dx, g.dy, g.dz, self.offs[s],
                            self.gext, flags=flags[s][1], ragged=self.ragged)
                  for s in range(comm.size)]
        self.last_maxima = tuple(reduction(list(m), comm, "max")
                                 for m in zip(*maxima))
        self.u, self.v, self.w = u, v, w
        self._mark("end")
        return dt

    def _exchange_buffers(self, u, v, w, ready=None):
        """Post the deep exchange of u, v, w (embed_deep and the depth-3
        exchange; on the card on the side stream after `ready`)."""
        H = FUSE_DEEP_HALO
        return self._deep_sched.post([u, v, w], lambda b: embed_deep(b, H),
                                     ready=ready)

    def _overlap_prologue(self):
        """The carry's first generation: the deep exchange of the current
        u, v, w, waited on, and the CFL maxima of the exchanged blocks."""
        posted = self._exchange_buffers(self.u, self.v, self.w)
        self._carry = (lambda: posted, self._maxima(*posted.wait()), self.nt)

    def _step_overlap(self):
        """One overlapped step (JAX step_overlap; see
        models/ns2d_dist._step_overlap): dt from the carried maxima
        through the generation guard, K7 as an interior half on copies of
        the stale blocks and a boundary half on the double buffer (u, v,
        w, F, G, H and rhs merged by the interior mask), the solve, K8,
        and the next step's deep exchange following POST, its copies
        issued beside the next interior half. With `tpu_overlap_restrict`
        the halves run K7's grid-band mode over k-plane bands."""
        comm, g, H = self.comm, self.grid, FUSE_DEEP_HALO
        if self._carry is None:
            self._overlap_prologue()
        start, maxima, gen = self._carry
        self._mark("pre")
        dt = clamped_dt(ovl.generation_guard(self._cfl(*maxima), gen,
                                             self.nt), self._dt_scale)
        dts = self._on_shards(dt)
        flags = self._flags or [(None, None)] * comm.size
        plan = self._overlap_plan
        bands = (None, None) if plan is None else (plan["int_bands"],
                                                   plan["bnd_bands"])

        def half(deep, b):
            outs = [ns3d_pre(*(x[s] for x in deep), dts[s], self._cfg,
                             self.offs[s], self.gext, H - 1,
                             flags=flags[s][0], bands=b)
                    for s in range(comm.size)]
            return [[strip_deep(x[s], H) for x in deep] + list(outs[s])
                    for s in range(comm.size)]

        inner = half([[embed_deep(x, H) for x in f]
                      for f in (self.u, self.v, self.w)], bands[0])
        outer = half(start().wait(), bands[1])
        u, v, w, f, gg, h, rhs = (list(x) for x in zip(*(
            ovl.merge_halves(m, a, b)
            for m, a, b in zip(self._int_mask, inner, outer))))
        self._mark("solve")
        self.p, self.last_res, self.last_it = self._solve(self.p, rhs)
        self._mark("post")
        maxima = [ns3d_post(u[s], v[s], w[s], f[s], gg[s], h[s], self.p[s],
                            dts[s], g.dx, g.dy, g.dz, self.offs[s],
                            self.gext, flags=flags[s][1], ragged=self.ragged)
                  for s in range(comm.size)]
        self.last_maxima = tuple(reduction(list(m), comm, "max")
                                 for m in zip(*maxima))
        self.u, self.v, self.w = u, v, w
        ready = pc.ready_events(comm)
        self._carry = (lambda: self._exchange_buffers(u, v, w, ready),
                       self.last_maxima, self.nt + 1)
        self._mark("end")
        return dt

    def _step_chain(self):
        """One step of the phase chain (JAX step, `tpu_fuse_phases off`):
        depth-1 exchanges around the BCs, the F/G/H donor-edge shift before
        the RHS, the projection on every shard. The walls, lid/inflow and
        F/G/H fixups are gated by the global index on the halo-1 blocks
        (parallel/ragged3d.py, on a divisible mesh too), as in the PRE
        kernel; what they write on interface ghosts the following exchange
        overwrites."""
        comm, g, cfg = self.comm, self.grid, self._cfg
        blk = (*self.local, *self.gext)  # the ragged3d forms' extents
        self._mark("pre")
        for x in (self.u, self.v, self.w):
            pc.halo_exchange(x, comm)
        dt = self._dt(self.u, self.v, self.w)
        dts = self._on_shards(dt)
        for s in range(comm.size):
            u, v, w = rg3.set_bcs_3d_ragged(self.u[s], self.v[s], self.w[s],
                                            cfg.bcs, comm, s, *blk)
            self.u[s], self.v[s], self.w[s] = (
                rg3.set_special_bc_3d_ragged(u, cfg.problem, comm, s, *blk),
                v, w)
        for x in (self.u, self.v, self.w):
            pc.halo_exchange(x, comm)
        lm = self._shard_masks()
        if lm is not None:
            # the obstacle BC reads the fully exchanged post-BC state; one
            # more exchange refreshes what it wrote on interface ghosts
            for s in range(comm.size):
                self.u[s], self.v[s], self.w[s] = \
                    obst3.apply_obstacle_velocity_bc_3d(
                        self.u[s], self.v[s], self.w[s], lm[s])
            for x in (self.u, self.v, self.w):
                pc.halo_exchange(x, comm)
        f, gg, h = [], [], []
        for s in range(comm.size):
            u, v, w = self.u[s], self.v[s], self.w[s]
            fs, gs, hs = rg3.fgh_fixups_ragged(
                *ops.compute_fgh_interior(u, v, w, dts[s], cfg.re, cfg.gx,
                                          cfg.gy, cfg.gz, cfg.gamma, g.dx,
                                          g.dy, g.dz),
                u, v, w, comm, s, *blk)
            if lm is not None:
                fs, gs, hs = obst3.mask_fgh(fs, gs, hs, u, v, w, lm[s])
            f.append(fs)
            gg.append(gs)
            h.append(hs)
        pc.halo_shift(f, comm, "i")
        pc.halo_shift(gg, comm, "j")
        pc.halo_shift(h, comm, "k")
        rhs = [ops.compute_rhs(a, b, c, d, g.dx, g.dy, g.dz)
               for a, b, c, d in zip(f, gg, h, dts)]
        self._mark("solve")
        self.p, self.last_res, self.last_it = self._solve(self.p, rhs)
        self._mark("post")
        for s in range(comm.size):
            old = (self.u[s], self.v[s], self.w[s])
            args = (*old, f[s], gg[s], h[s], self.p[s], dts[s], g.dx, g.dy,
                    g.dz)
            new = (ops.adapt_uvw(*args) if lm is None
                   else obst3.adapt_uvw_obstacle(*args, lm[s]))
            if self._gates is not None:
                # only the global interior updates (ghost planes stored in
                # a block's interior keep their BC values) and the dead
                # cells go to zero, for the plain and the obstacle
                # projections alike
                interior, live = self._gates[s]
                new = tuple(torch.where(interior, a, b) * live
                            for a, b in zip(new, old))
            self.u[s], self.v[s], self.w[s] = new
        self._mark("end")
        return dt

    def _shard_masks(self):
        """Every shard's masks (ops/obstacle3d.shard_masks_3d) as tensors
        on its device, or None without obstacles."""
        if self.masks is not None and self._local_masks is None:
            self._local_masks = [
                obst3.shard_masks_3d(self.masks, self.comm, s,
                                     *self.local).to(self.dtype, dev)
                for s, dev in enumerate(self.comm.devices)]
        return self._local_masks

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
    def _cell_centred(self):
        """Per shard, the cell-centred numpy slabs (u, v, w, p) of its
        global-interior cells, (kl, jl, il) on a mesh that divides the grid
        (a ragged mesh's dead cells are cropped: a shard past the grid
        gives empty slabs), and the slab's global origin.
        Staggered-to-centre averaging reads the minus-side ghosts, so u,
        v, w are exchanged first (on copies: the state is left as it is).
        The averages are taken on the host in the field's dtype, as
        NS3DSolver.collect takes them."""
        u, v, w = (pc.halo_exchange([b.clone() for b in x], self.comm)
                   for x in (self.u, self.v, self.w))
        out = []
        for s in range(self.comm.size):
            us, vs, ws, ps = (a[s].detach().cpu().numpy()
                              for a in (u, v, w, self.p))
            own = tuple(slice(0, max(0, min(e, n - o))) for o, e, n in
                        zip(self.offs[s], self.local, self.gext))
            out.append(tuple(a[own] for a in (
                (us[1:-1, 1:-1, 1:-1] + us[1:-1, 1:-1, :-2]) / 2.0,
                (vs[1:-1, 1:-1, 1:-1] + vs[1:-1, :-2, 1:-1]) / 2.0,
                (ws[1:-1, 1:-1, 1:-1] + ws[:-2, 1:-1, 1:-1]) / 2.0,
                ps[1:-1, 1:-1, 1:-1])) + (self.offs[s],))
        return out

    def collect(self):
        """Cell-centred global fields (ug, vg, wg, pg), each (kmax, jmax,
        imax), as numpy arrays on the host."""
        slabs = self._cell_centred()
        fields = [np.empty(self.gext, slabs[0][0].dtype) for _ in range(4)]
        for *arrs, off in slabs:
            sl = tuple(slice(o, o + e) for o, e in zip(off, arrs[0].shape))
            for full, a in zip(fields, arrs):
                full[sl] = a
        return tuple(fields)

    def write_result(self, path=None, fmt: str = "ascii") -> None:
        """The VTK output (pressure scalar, velocity vector) to path, by
        default `<problem>.vtk`, gathered on the host."""
        ug, vg, wg, pg = self.collect()
        writer = VtkWriter(self._cfg.problem, self.grid, fmt=fmt, path=path)
        writer.scalar("pressure", pg)
        writer.vector("velocity", ug, vg, wg)
        writer.close()

    def write_result_sharded(self, path=None) -> None:
        """`tpu_vtk sharded`: the binary VTK written slab by slab, each
        shard's cell-centred block at its own byte offsets, with no global
        array assembled (the reference's scaffolded MPI-IO write,
        vtkWriter.c:118-143, completed). The bytes are those of
        write_result(fmt="binary"). On a mesh that does not divide the
        grid it is that gathered binary write, as in the JAX package."""
        if self.ragged:
            self.write_result(path=path, fmt="binary")
            return
        slabs = self._cell_centred()
        writer = ShardedVtkWriter(self._cfg.problem, self.grid, path=path)
        writer.scalar("pressure", [(ps, off) for *_, ps, off in slabs])
        writer.vector("velocity", [(us, vs, ws, off)
                                   for us, vs, ws, _p, off in slabs])
        writer.close()
