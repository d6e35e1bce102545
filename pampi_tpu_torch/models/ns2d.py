"""NS-2D incompressible Navier-Stokes time stepper, lid-driven cavity and
canal (counterpart of pampi_tpu/models/ns2d.py, the reference's
assignment-5).

One step is dt -> PRE (kernel K3: wall BCs, special BC, F/G, RHS) ->
normalizePressure every 100 steps -> the red-black SOR pressure solve (K1
on even grids, K2 otherwise) -> POST (kernel K4: adaptUV and the maxima of
|u| and |v|). The maxima are carried to the next step's CFL dt, as in the
JAX package's fused chunk (`_build_fused_chunk`), so dt is computed on the
device from two scalars. On the CPU the same composition runs the kernels'
plain versions, in the same order.

The step updates u and v in place and replaces p with the solved field.
t accumulates on the host in float64 (one readback of dt per step), which
is what the JAX package carries in its chunk (`t + dt.astype(f64)`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ns2d as ops
from ..ops.ns2d_fused import StepConfig, ns2d_post, ns2d_pre
from ..utils import flags as _flags
from ..utils.datio import write_pressure, write_velocity
from ..utils.device import resolve_device
from ..utils.dispatch import check_supported, record, resolve_solver
from ..utils.params import Parameter
from ..utils.precision import resolve_dtype
from ..utils.progress import Progress
from ._driver import clamped_dt, drive_chunks
from .poisson import make_solver_fn, resolve_layout


def make_pressure_solve(imax, jmax, dx, dy, omega, eps, itermax, dtype,
                        n_inner: int = 1, solver: str = "sor",
                        layout: str = "auto", flat: bool = False):
    """The pressure-Poisson solve of one step (solve -> (p, res, it)):
    the Poisson model's red-black convergence loop. Only `sor` is ported."""
    resolve_solver(solver)
    return make_solver_fn(imax, jmax, dx, dy, omega, eps, itermax, dtype,
                          n_inner=n_inner, layout=layout, flat=flat)


class NS2DSolver:
    """Driver-facing NS-2D solver (the reference's Solver struct and main
    loop). Fields live on `device` ("cuda" by default; "cpu" runs the
    kernels' plain versions).

    `phase_hook`, when set, is called with "pre", "solve", "post" as each
    phase of a step starts and with "end" after the last one, so a caller
    can place CUDA events around the phases without another code path."""

    CHUNK = 64  # steps between progress-bar updates

    def __init__(self, param: Parameter, dtype=None, device="cuda"):
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
        self._solve = make_pressure_solve(
            param.imax, param.jmax, self.dx, self.dy, param.omg, param.eps,
            param.itermax, self.dtype, n_inner=param.tpu_sor_inner,
            solver=param.tpu_solver, layout=param.tpu_sor_layout,
            flat=bool(param.tpu_flat_solve))
        layout = resolve_layout(param.imax, param.jmax, param.tpu_sor_layout)
        record("ns2d_step", f"pre -> sor {layout} n_inner="
               f"{param.tpu_sor_inner} -> post on {self.device.type}")
        self.phase_hook = None
        self._umax = self._vmax = None

    @classmethod
    def from_numpy_state(cls, param: Parameter, u, v, p, t, nt,
                         device="cuda"):
        """A solver whose state is the given fields and time (e.g. a JAX
        solver's), cast to the configured dtype."""
        s = cls(param, device=device)
        for name, arr in (("u", u), ("v", v), ("p", p)):
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
        f, g, rhs = ns2d_pre(self.u, self.v, dt, self._cfg)
        self._mark("solve")
        if self.nt % 100 == 0:
            self.p = ops.normalize_pressure(self.p)
        self.p, _res, _it = self._solve(self.p, rhs)
        self._mark("post")
        self._umax, self._vmax = ns2d_post(self.u, self.v, f, g, self.p, dt,
                                           self.dx, self.dy)
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
