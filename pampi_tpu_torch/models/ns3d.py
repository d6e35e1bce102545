"""NS-3D incompressible Navier-Stokes time stepper, lid-driven cavity and
canal (counterpart of pampi_tpu/models/ns3d.py, the reference's
assignment-6).

One step is dt -> PRE (kernel K7: the six wall BCs, the special BC, F/G/H,
RHS) -> the pressure solve (`tpu_solver`: 3-D red-black SOR, K6 on the
octants of an even grid and K5 on the checkerboard otherwise; multigrid,
through the fused-cycle kernels K11/K12; or the DCT direct solve) -> POST
(kernel K8: the projection and the maxima of |u|, |v|, |w|). Unlike NS-2D
there is no normalizePressure in the loop, as in the reference. The
maxima are carried to the next step's CFL dt, the order of the JAX
package's fused chunk (`_build_fused_chunk`), so dt is computed on the
device from three scalars. On the CPU the same composition runs the
kernels' plain versions.

The step updates u, v, w in place and replaces p with the solved field.
t accumulates on the host in float64 (one readback of dt per step), which
is what the JAX chunk carries (`t + dt.astype(f64)`).

Obstacle flag fields (the .par `obstacles` key, 3-D boxes; ops/
obstacle3d.py) run under `tpu_solver sor` and `mg`: the masks are built
from the geometry, K7 and K8 run in their flag mode (the obstacle
velocity BC and the masked F/G/H in PRE, the projection on fluid-fluid
faces in POST), and the solve, its residual normalised by the fluid
cells, is the masked mode of K5 (make_obstacle_solver_fn_3d) under sor
and the obstacle multigrid (ops/multigrid.make_obstacle_mg_solve_3d: the
masked mode of K11/K12, or its ladder on masked K5) under mg. The
distributed solver is models/ns3d_dist.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ns3d as ops
from ..ops.dctpoisson import make_dct_solve_3d
from ..ops.multigrid import make_mg_solve_3d, make_obstacle_mg_solve_3d
from ..ops.ns3d_fused import StepConfig3D, ns3d_post, ns3d_pre
from ..ops.sor3d import sor_coefficients_3d
from ..ops.sor3d_kernels import rb_sor3d_checkerboard, rb_sor3d_octants
from ..ops.sor_octants import stack_octants, unstack_octants
from ..utils import flags as _flags
from ..utils.device import resolve_device
from ..utils.dispatch import (
    check_supported,
    record,
    resolve_solver,
    sor_cadence,
)
from ..utils.grid import Grid
from ..ops import obstacle3d as obst3
from ..utils.params import Parameter, validate_obstacle_layout
from ..utils.precision import resolve_dtype
from ..utils.progress import Progress
from ..utils.vtkio import VtkWriter
from ._driver import clamped_dt, drive_chunks
from .poisson import make_convergence_loop


def resolve_layout_3d(imax: int, jmax: int, kmax: int,
                      layout: str = "auto") -> str:
    """`tpu_sor_layout` -> "octants" or "checkerboard": auto takes the
    octants on even imax, jmax, kmax and the checkerboard otherwise."""
    if layout not in ("auto", "checkerboard", "octants"):
        raise ValueError(
            f"3-D SOR layout must be auto|checkerboard|octants, got "
            f"{layout!r} (quarters is the 2-D layout)")
    even = imax % 2 == 0 and jmax % 2 == 0 and kmax % 2 == 0
    if layout == "octants" and not even:
        raise ValueError("octant layout needs even imax, jmax, kmax")
    return "octants" if even and layout != "checkerboard" else "checkerboard"


def make_pressure_solve_3d(imax, jmax, kmax, dx, dy, dz, omega, eps, itermax,
                           dtype, n_inner: int = 1, solver: str = "sor",
                           layout: str = "auto", stall_rtol=None,
                           mg_fused: str = "auto", *, device):
    """The 3-D pressure solve of one step, solve(p, rhs) -> (p, res, it).
    `sor`: one kernel call = n_inner red-black iterations (NS3DSolver
    passes the dtype's sor_cadence), `it += n_inner`,
    the residual Σr²/(imax·jmax·kmax) read back and checked against eps²
    after every call (the JAX make_tblock_solve_loop contract). `mg`:
    multigrid V-cycles (K11/K12 in the fused cycle), `it` counts cycles.
    `fft`: the DCT direct solve, `it` = 1. `device` is where the MG and
    DCT solves build their level data and matrices."""
    if solver == "mg":
        return make_mg_solve_3d(imax, jmax, kmax, dx, dy, dz, eps, itermax,
                                dtype, stall_rtol=stall_rtol,
                                fused=mg_fused, device=device)
    if solver == "fft":
        return make_dct_solve_3d(imax, jmax, kmax, dx, dy, dz, dtype,
                                 device=device)
    if solver != "sor":
        raise ValueError(f"pressure solve supports sor|mg|fft, got "
                         f"{solver!r} (resolve auto first)")
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    factor, idx2, idy2, idz2 = sor_coefficients_3d(dx, dy, dz, omega)
    if resolve_layout_3d(imax, jmax, kmax, layout) == "octants":
        def step(q, f):
            return rb_sor3d_octants(q, f, n_inner, factor, idx2, idy2, idz2)

        prep, post = stack_octants, unstack_octants
    else:
        def step(p, rhs):
            return rb_sor3d_checkerboard(p, rhs, n_inner, factor, idx2, idy2,
                                         idz2)

        def prep(x):
            return x.contiguous()

        post = prep
    return make_convergence_loop(step, prep, post, n_inner,
                                 imax * jmax * kmax, eps, itermax, dtype)


class NS3DSolver:
    """Driver-facing NS-3D solver (the reference's assignment-6 Solver
    struct and main loop). Fields live on `device` ("cuda" by default;
    "cpu" runs the kernels' plain versions).

    `phase_hook`, when set, is called with "pre", "solve", "post" as each
    phase of a step starts and with "end" after the last one, as in
    NS2DSolver."""

    CHUNK = 32  # steps between progress-bar updates

    def __init__(self, param: Parameter, dtype=None, device="cuda"):
        param = resolve_solver(param)
        check_supported(param)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None else dtype
        self.param = param
        self.grid = g = Grid(imax=param.imax, jmax=param.jmax,
                             kmax=param.kmax, xlength=param.xlength,
                             ylength=param.ylength, zlength=param.zlength)
        shape = (g.kmax + 2, g.jmax + 2, g.imax + 2)
        for name, val in (("u", param.u_init), ("v", param.v_init),
                          ("w", param.w_init), ("p", param.p_init)):
            setattr(self, name, torch.full(shape, val, dtype=self.dtype,
                                           device=self.device))
        inv_sqr_sum = 1.0 / g.dx**2 + 1.0 / g.dy**2 + 1.0 / g.dz**2
        self.dt_bound = 0.5 * param.re / inv_sqr_sum
        self.t = 0.0
        self.nt = 0
        self._dt_scale = 1.0
        self._cfg = StepConfig3D.from_param(param)
        solver, layout = param.tpu_solver, "auto"
        # the JAX package's residual cadence for the dtype
        n_inner = sor_cadence(param, self.dtype)
        self.masks = self._flags = None
        if param.obstacles.strip():
            # check_supported leaves sor and mg here
            validate_obstacle_layout(param.tpu_sor_layout)
            self.masks = obst3.make_masks_3d(
                obst3.build_fluid_3d(g.imax, g.jmax, g.kmax, g.dx, g.dy,
                                     g.dz, param.obstacles),
                g.dx, g.dy, g.dz, param.omg)
            if solver == "mg":
                self._solve = make_obstacle_mg_solve_3d(
                    g.imax, g.jmax, g.kmax, g.dx, g.dy, g.dz, param.eps,
                    param.itermax, self.masks, self.dtype,
                    stall_rtol=param.tpu_mg_stall_rtol,
                    fused=param.tpu_mg_fused, device=self.device)
                solver = ("mg obstacle "
                          + ("fused" if self._solve.fused else "ladder"))
            else:
                self._solve = obst3.make_obstacle_solver_fn_3d(
                    g.imax, g.jmax, g.kmax, g.dx, g.dy, g.dz, param.eps,
                    param.itermax, self.masks, self.dtype, n_inner=n_inner,
                    device=self.device)
                solver = f"sor masked checkerboard n_inner={n_inner}"
            self._flags = self._solve.flags
        else:
            if solver == "sor":
                layout = resolve_layout_3d(g.imax, g.jmax, g.kmax,
                                           param.tpu_sor_layout)
                solver = f"sor {layout} n_inner={n_inner}"
            self._solve = make_pressure_solve_3d(
                g.imax, g.jmax, g.kmax, g.dx, g.dy, g.dz, param.omg,
                param.eps, param.itermax, self.dtype, n_inner=n_inner,
                solver=param.tpu_solver, layout=layout,
                stall_rtol=param.tpu_mg_stall_rtol,
                mg_fused=param.tpu_mg_fused, device=self.device)
        record("ns3d_step", f"pre -> {solver} -> post on {self.device.type}")
        self.phase_hook = None
        # the last pressure solve's residual and iteration (V-cycle) count
        self.last_res = self.last_it = None
        self._maxima = None

    @classmethod
    def from_numpy_state(cls, param: Parameter, u, v, w, p, t, nt,
                         device="cuda"):
        """A solver whose state is the given fields and time (e.g. a JAX
        solver's), cast to the configured dtype. Obstacle masks are
        rebuilt from the param's geometry."""
        s = cls(param, device=device)
        for name, arr in (("u", u), ("v", v), ("w", w), ("p", p)):
            # a copy: the solver updates its fields in place
            setattr(s, name, torch.from_numpy(np.array(arr)).to(
                device=s.device, dtype=s.dtype).contiguous())
        s.t, s.nt = float(t), int(nt)
        return s

    def _mark(self, phase: str) -> None:
        if self.phase_hook is not None:
            self.phase_hook(phase)

    def _start(self) -> None:
        """Maxima of the current fields, as the JAX chunk takes them on
        entry; every later step reads them from POST."""
        self._maxima = tuple(ops.max_element(a)
                             for a in (self.u, self.v, self.w))

    def _step(self) -> None:
        param, g = self.param, self.grid
        self._mark("pre")
        if param.tau > 0.0:
            dt = ops.cfl_dt_3d(*self._maxima, self.dt_bound, g.dx, g.dy,
                               g.dz, param.tau)
        else:
            dt = torch.full((), param.dt, dtype=self.dtype,
                            device=self.device)
        dt = clamped_dt(dt, self._dt_scale)
        f, gg, h, rhs = ns3d_pre(self.u, self.v, self.w, dt, self._cfg,
                                 flags=self._flags)
        self._mark("solve")
        self.p, self.last_res, self.last_it = self._solve(self.p, rhs)
        self._mark("post")
        self._maxima = ns3d_post(self.u, self.v, self.w, f, gg, h, self.p,
                                 dt, g.dx, g.dy, g.dz, flags=self._flags)
        self._mark("end")
        dt_host = float(dt)
        self.t += dt_host
        self.nt += 1
        if _flags.verbose():
            print(f"TIME {self.t} , TIMESTEP {dt_host}")

    def run_steps(self, n: int) -> None:
        """Advance exactly n steps, whatever te says."""
        self._start()
        for _ in range(n):
            self._step()

    def _advance(self, n: int) -> float:
        te = self.param.te
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
        self._start()
        drive_chunks(self._advance, self.t, self.param.te, bar,
                     self.param.tpu_chunk or self.CHUNK)

    def collect(self):
        """Cell-centred fields (numpy float64 on the host): p's interior
        and each velocity averaged from its two staggered faces."""
        u, v, w, p = (a.detach().cpu().numpy()
                      for a in (self.u, self.v, self.w, self.p))
        pg = p[1:-1, 1:-1, 1:-1]
        ug = (u[1:-1, 1:-1, 1:-1] + u[1:-1, 1:-1, :-2]) / 2.0
        vg = (v[1:-1, 1:-1, 1:-1] + v[1:-1, :-2, 1:-1]) / 2.0
        wg = (w[1:-1, 1:-1, 1:-1] + w[:-2, 1:-1, 1:-1]) / 2.0
        return ug, vg, wg, pg

    def write_result(self, path=None, fmt: str = "ascii") -> None:
        """The VTK output (pressure scalar, velocity vector) to path, by
        default `<problem>.vtk` (dcavity.vtk, canal.vtk)."""
        ug, vg, wg, pg = self.collect()
        writer = VtkWriter(self.param.name.replace("3d", ""), self.grid,
                           fmt=fmt, path=path)
        writer.scalar("pressure", pg)
        writer.vector("velocity", ug, vg, wg)
        writer.close()
