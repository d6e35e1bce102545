"""NS-2D incompressible Navier-Stokes time stepper, lid-driven cavity,
canal and canal with obstacles (counterpart of pampi_tpu/models/ns2d.py,
the reference's assignment-5).

One step is dt -> PRE (kernel K3: wall BCs, special BC, F/G, RHS) ->
normalizePressure every 100 steps -> the pressure solve (`tpu_solver`:
red-black SOR, K1 on even grids and K2 otherwise; multigrid, through the
fused-cycle kernels K9/K10; or the DCT direct solve) -> POST (kernel K4:
adaptUV and the maxima of |u| and |v|). The maxima are carried to the next step's CFL dt, as in the
JAX package's fused chunk (`_build_fused_chunk`), so dt is computed on the
device from two scalars. On the CPU the same composition runs the kernels'
plain versions, in the same order.

With an `obstacles` key (canal_obstacle*.par: flag-field rectangles,
ops/obstacle.py) the step is the same composition in flag mode: PRE (K3
with the flags: the obstacle velocity BC after the special BC, F/G
carrying U/V on non-fluid faces), the fluid-weighted normalizePressure
every 100 steps, the solve (residual over the fluid cells) on the masked
mode of K2 under `tpu_solver sor` or the obstacle multigrid under `mg`
(ops/multigrid.make_obstacle_mg_solve_2d: the masked mode of K9/K10, or
its ladder on masked K2), POST (K4 with the flags: the projection on
fluid-fluid faces). The JAX package runs that step as its
phase chain on the CPU and as these kernels on a TPU.

The step updates u and v in place and replaces p with the solved field.
t accumulates on the host in float64 (one readback of dt per step), which
is what the JAX package carries in its chunk (`t + dt.astype(f64)`); dt
is formed in the field's dtype.

At `tpu_dtype bfloat16` (dcavity and canal on one device under the
quarters SOR; utils/dispatch.check_supported refuses the rest) the step is
the JAX package's fused chunk at bf16: K3 and K4 in their bf16 mode (every
operation rounded to bf16), dt from the bf16 maxima, normalizePressure in
bf16, and K1's bf16-storage mode for the solve (float32 inside a call, a
float32 residual).
"""

from __future__ import annotations

import torch

from ..ops import ns2d as ops
from ..ops import obstacle as obst
from ..ops.multigrid import make_obstacle_mg_solve_2d
from ..ops.ns2d_fused import StepConfig, ns2d_post, ns2d_pre
from ..utils import flags as _flags
from ..utils.datio import write_pressure, write_velocity
from ..utils.device import resolve_device
from ..utils.dispatch import (
    check_supported,
    record,
    resolve_solver,
    sor_cadence,
)
from ..utils.params import Parameter, validate_obstacle_layout
from ..utils.precision import resolve_dtype, tensor_from_array
from ..utils.progress import Progress
from ._driver import clamped_dt, drive_chunks
from .poisson import make_pressure_solve_for, solve_label


class NS2DSolver:
    """Driver-facing NS-2D solver (the reference's Solver struct and main
    loop). Fields live on `device` ("cuda" by default; "cpu" runs the
    kernels' plain versions).

    `phase_hook`, when set, is called with "pre", "solve", "post" as each
    phase of a step starts and with "end" after the last one, so a caller
    can place CUDA events around the phases without another code path."""

    CHUNK = 64  # steps between progress-bar updates

    def __init__(self, param: Parameter, dtype=None, device="cuda"):
        param = resolve_solver(param)
        check_supported(param)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None else dtype
        self.param = param
        self.imax, self.jmax = param.imax, param.jmax
        self.dx = param.xlength / param.imax
        self.dy = param.ylength / param.jmax
        shape = (param.jmax + 2, param.imax + 2)
        self.u = torch.full(shape, param.u_init, dtype=self.dtype,
                            device=self.device)
        self.v = torch.full(shape, param.v_init, dtype=self.dtype,
                            device=self.device)
        self.p = torch.full(shape, param.p_init, dtype=self.dtype,
                            device=self.device)
        inv_sqr_sum = 1.0 / (self.dx * self.dx) + 1.0 / (self.dy * self.dy)
        self.dt_bound = 0.5 * param.re / inv_sqr_sum
        self.t = 0.0
        self.nt = 0
        self._dt_scale = 1.0
        self._cfg = StepConfig.from_param(param)
        # obstacle flag fields: the host masks, the fluid field on the
        # device (normalizePressure's weight) and the kernels' uint8 flags
        self.masks = self._fluid = self._flags = None
        if param.obstacles.strip():
            validate_obstacle_layout(param.tpu_sor_layout)
            self.masks = obst.make_masks(
                obst.build_fluid(self.imax, self.jmax, self.dx, self.dy,
                                 param.obstacles),
                self.dx, self.dy, param.omg)
            self._fluid = torch.from_numpy(self.masks.fluid).to(
                device=self.device, dtype=self.dtype)
            if param.tpu_solver == "mg":
                self._solve = make_obstacle_mg_solve_2d(
                    self.imax, self.jmax, self.dx, self.dy, param.eps,
                    param.itermax, self.masks, self.dtype,
                    stall_rtol=param.tpu_mg_stall_rtol,
                    fused=param.tpu_mg_fused, device=self.device)
                label = ("mg obstacle "
                         + ("fused" if self._solve.fused else "ladder"))
            else:
                n = sor_cadence(param, self.dtype)
                self._solve = obst.make_obstacle_solver_fn(
                    self.imax, self.jmax, self.dx, self.dy, param.eps,
                    param.itermax, self.masks, self.dtype, n,
                    device=self.device)
                label = f"sor masked checkerboard n_inner={n}"
            self._flags = self._solve.flags
        else:
            self._solve = make_pressure_solve_for(param, self.dx, self.dy,
                                                  self.dtype, self.device)
            label = solve_label(param, self.dtype)
        record("ns2d_step", f"pre -> {label} -> post on {self.device.type}")
        self.phase_hook = None
        # the last pressure solve's residual and iteration (V-cycle) count
        self.last_res = self.last_it = None
        self._umax = self._vmax = None

    @classmethod
    def from_numpy_state(cls, param: Parameter, u, v, p, t, nt,
                         device="cuda"):
        """A solver whose state is the given fields and time (e.g. a JAX
        solver's), cast to the configured dtype."""
        s = cls(param, device=device)
        for name, arr in (("u", u), ("v", v), ("p", p)):
            # a copy: the solver updates its fields in place
            setattr(s, name, tensor_from_array(arr, s.dtype, s.device))
        s.t, s.nt = float(t), int(nt)
        return s

    def _mark(self, phase: str) -> None:
        if self.phase_hook is not None:
            self.phase_hook(phase)

    def _start(self) -> None:
        """Maxima of the current fields, as the JAX chunk takes them on
        entry; every later step reads them from POST."""
        self._umax, self._vmax = ops.max_element(self.u), ops.max_element(self.v)

    def _step(self) -> None:
        param = self.param
        self._mark("pre")
        if param.tau > 0.0:
            dt = ops.cfl_dt(self._umax, self._vmax, self.dt_bound, self.dx,
                            self.dy, param.tau)
        else:
            dt = torch.full((), param.dt, dtype=self.dtype,
                            device=self.device)
        dt = clamped_dt(dt, self._dt_scale)
        f, g, rhs = ns2d_pre(self.u, self.v, dt, self._cfg,
                             flags=self._flags)
        self._mark("solve")
        if self.nt % 100 == 0:
            self.p = (ops.normalize_pressure(self.p) if self._fluid is None
                      else obst.normalize_pressure_fluid(self.p, self._fluid))
        self.p, self.last_res, self.last_it = self._solve(self.p, rhs)
        self._mark("post")
        self._umax, self._vmax = ns2d_post(self.u, self.v, f, g, self.p, dt,
                                           self.dx, self.dy,
                                           flags=self._flags)
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

    def write_result(self, pressure_path: str = "pressure.dat",
                     velocity_path: str = "velocity.dat") -> None:
        write_pressure(self.p, self.dx, self.dy, pressure_path)
        write_velocity(self.u, self.v, self.dx, self.dy, velocity_path)
