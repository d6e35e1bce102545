"""2-D Poisson solver: red-black SOR with a residual-convergence loop
(counterpart of pampi_tpu/models/poisson.py, the reference's assignment-4).
`tpu_solver mg` and `fft` (and `auto`, which resolves to `fft` here) take
the multigrid and DCT solves of ops/multigrid.py and ops/dctpoisson.py
instead; the rest of this docstring is about the SOR loop.

One solve call advances the field by `eff_inner` red-black iterations with
kernel K1 (quarter layout) or K2 (checkerboard), then reads the residual
back to the host and checks `res >= eps² and it < itermax`. That is one
host sync per check, where the JAX package keeps the whole loop on the
device in a `while_loop`; moving the loop onto the device is later work.
The iteration count `it` advances by exactly `eff_inner` per call, as in
the JAX package's convergence loops. `eff_inner` is the JAX package's
cadence for the dtype (utils/dispatch.sor_cadence): `tpu_sor_inner` at
float32, where its TPU kernels run, and 1 at float64, where it steps its
jnp path one iteration at a time.

The residual is normalised and compared on the host in the residual's
dtype (numpy float32 or float64 arithmetic), which is what the JAX loop
computes on the device: `rsq / norm` in promote(dtype, float32), compared
with eps² cast to that dtype. At `tpu_dtype bfloat16` (the quarters layout
only, utils/dispatch.check_supported) K1 runs its bf16-storage mode: the
planes are bf16, every call iterates in float32 and returns a float32
Σr², and the cadence is `tpu_sor_inner`, as at float32.

Layout policy (`tpu_sor_layout`, as in make_rb_loop of the JAX package):
`auto` is the quarter layout on even grids and the checkerboard otherwise;
`checkerboard` and `quarters` force one (quarters needs even imax, jmax).
The policy does not depend on the device: on the CPU the same loop runs the
kernels' plain versions. The JAX package's folded p-layout solve
(make_padded_solver_fn) has no counterpart of its own: every kernel of the
port takes the natural (jmax+2, imax+2) array, so the checkerboard solve of
make_solver_fn is that solve with no conversion.

Init parity (initSolver): p = sin(4π·i·dx) + sin(4π·j·dy) on the FULL array
incl. ghosts; rhs = sin(2π·i·dx) for problem 2, else 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.dctpoisson import make_dct_solve_2d
from ..ops.multigrid import make_mg_solve_2d
from ..ops.sor_kernels import (
    rb_sor_blocked,
    rb_sor_checkerboard,
    rb_sor_quarters,
    sor_coefficients,
)
from ..ops.sor_quarters import stack_quarters, unstack_quarters
from ..utils import flags as _flags
from ..utils.datio import write_matrix
from ..utils.device import resolve_device
from ..utils.dispatch import (
    check_supported,
    record,
    resolve_solver,
    sor_cadence,
)
from ..utils.params import Parameter
from ..utils.precision import (
    check_eps_floor,
    res_dtype,
    resolve_dtype,
    tensor_from_array,
)


def init_fields(param: Parameter, problem: int = 2, dtype=torch.float64,
                device="cpu"):
    """Initial p and rhs (assignment-4 initSolver), made in numpy float64
    and cast, as the JAX package does."""
    imax, jmax = param.imax, param.jmax
    dx = param.xlength / imax
    dy = param.ylength / jmax
    i = np.arange(imax + 2)[None, :]
    j = np.arange(jmax + 2)[:, None]
    p = np.sin(2.0 * math.pi * i * dx * 2.0) + np.sin(2.0 * math.pi * j * dy * 2.0)
    if problem == 2:
        rhs = np.broadcast_to(np.sin(2.0 * math.pi * i * dx), p.shape).copy()
    else:
        rhs = np.zeros_like(p)
    return (torch.from_numpy(p).to(device=device, dtype=dtype),
            torch.from_numpy(rhs).to(device=device, dtype=dtype))


def resolve_layout(imax: int, jmax: int, layout: str = "auto") -> str:
    """`tpu_sor_layout` -> "quarters" or "checkerboard"."""
    if layout not in ("auto", "checkerboard", "quarters"):
        raise ValueError(
            f"2-D SOR layout must be auto|checkerboard|quarters, got {layout!r}")
    even = imax % 2 == 0 and jmax % 2 == 0
    if layout == "quarters" and not even:
        raise ValueError("quarters layout needs even imax and jmax")
    return "quarters" if even and layout != "checkerboard" else "checkerboard"


def make_rb_loop(imax, jmax, dx, dy, omega, n_inner: int = 1,
                 layout: str = "auto"):
    """The loop-carried red-black step: returns (step, prep, post,
    eff_inner). prep turns a (jmax+2, imax+2) array into the carried
    layout, post turns it back; step(carry, rhs_carry) performs eff_inner
    iterations on carry and returns their last Σr² (0-dim tensor, not yet
    normalised). The quarters layout carries a pair of stacked planes,
    newest first: K1 reads one and writes the other, one launch a call."""
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    factor, idx2, idy2 = sor_coefficients(dx, dy, omega)
    if resolve_layout(imax, jmax, layout) == "quarters":
        def step(pair, f):
            # pair = [newest, the other planes (made at the first call)]
            if len(pair) == 1:
                pair.append(torch.empty_like(pair[0]))
            r = rb_sor_quarters(pair[0], f[0], n_inner, factor, idx2, idy2,
                                out=pair[1])
            pair.reverse()
            return r

        def prep(x):
            return [stack_quarters(x)]

        def post(pair):
            return unstack_quarters(pair[0])

        return step, prep, post, n_inner

    def step(p, rhs):
        return rb_sor_checkerboard(p, rhs, n_inner, factor, idx2, idy2)

    def ident(x):
        return x.contiguous()

    return step, ident, ident, n_inner


def make_rb_step_padded(imax, jmax, dx, dy, omega, dtype,
                        kernel: str = "fused", n_inner: int = 4, *, device):
    """One red-black step on the pressure array, as the JAX package's
    make_rb_step_padded: returns (step, pad, unpad), where step(p, rhs)
    updates p in place and returns (p, Σr²/(imax·jmax)), the Neumann ghost
    copy included, the residual a 0-dim tensor in the field's dtype (no
    host sync). `kernel` "tblock" runs K2 with n_inner iterations a step,
    "fused" K2 with one, "blocked" K17 (one iteration, the JAX package's
    _rb_kernel). Their plain versions run on CPU tensors.

    The port keeps the natural (jmax+2, imax+2) layout: the TPU's sublane
    and lane padding (sor_pallas.pad_array, padded_width) is the TPU's
    tiling and is not ported, so pad and unpad return a contiguous copy
    (on `device`), which the caller carries through its loop as the JAX
    package carries its padded array."""
    if kernel == "fused":
        kernel, n_inner = "tblock", 1
    if kernel not in ("tblock", "blocked"):
        raise ValueError(f"kernel must be fused|tblock|blocked, got "
                         f"{kernel!r}")
    device = resolve_device(device)
    factor, idx2, idy2 = sor_coefficients(dx, dy, omega)
    norm = torch.full((), float(imax * jmax), dtype=dtype, device=device)

    if kernel == "tblock":
        def rsq(p, rhs):
            return rb_sor_checkerboard(p, rhs, n_inner, factor, idx2, idy2)
    else:
        def rsq(p, rhs):
            return rb_sor_blocked(p, rhs, factor, idx2, idy2)

    def step(p, rhs):
        return p, rsq(p, rhs) / norm

    def pad(x):
        return x.to(device=device, dtype=dtype, copy=True).contiguous()

    return step, pad, pad


def make_solver_fn(imax, jmax, dx, dy, omega, eps, itermax, dtype,
                   n_inner: int = 1, layout: str = "auto",
                   flat: bool = False):
    """The convergence loop: solve(p, rhs) -> (p, res, it), updating p in
    place. Convergence is checked every n_inner iterations (the caller's
    sor_cadence), so a solve may run up to n_inner-1 iterations past the
    first one below eps (they only lower the residual); `it` is the true
    iteration count.
    flat=True runs exactly ceil(itermax/eff_inner) calls with no check in
    between (no host sync inside the solve); res is then the last one."""
    check_eps_floor(eps, imax * jmax, dtype, f"sor {imax}x{jmax}")
    step, prep, post, eff = make_rb_loop(imax, jmax, dx, dy, omega, n_inner,
                                         layout)
    return make_convergence_loop(step, prep, post, eff, imax * jmax, eps,
                                 itermax, dtype, flat)


def make_convergence_loop(step, prep, post, eff, ncells, eps, itermax, dtype,
                          flat: bool = False):
    """solve(p, rhs) -> (p, res, it) around a red-black step of eff
    iterations (make_rb_loop's contract), shared by the 2-D and 3-D
    solvers: res = Σr² / ncells in the residual's dtype (res_dtype: the
    field's, float32 at bfloat16, whose kernel returns a float32 Σr²),
    checked against eps² after every call (make_solver_fn says the
    rest)."""
    real = np.float64 if res_dtype(dtype) == torch.float64 else np.float32
    norm = real(ncells)
    epssq = real(eps * eps)

    def solve(p, rhs):
        carry, rhs_carry = prep(p), prep(rhs)
        res, it = real(1.0), 0
        if flat:
            rsq = None
            for _ in range(-(-itermax // eff)):
                rsq = step(carry, rhs_carry)
                it += eff
            if rsq is not None:
                res = real(float(rsq)) / norm
        else:
            while res >= epssq and it < itermax:
                rsq = step(carry, rhs_carry)
                res = real(float(rsq)) / norm
                if _flags.debug():
                    # the reference's -DDEBUG "%d Residuum: %e" line, with
                    # the 0-based index of the last iteration done
                    print(f"{it + eff - 1} Residuum: {float(res)}")
                it += eff
        out = post(carry)
        if out is not p:
            p.copy_(out)
        return p, float(res), it

    return solve


def make_pressure_solve(imax, jmax, dx, dy, omega, eps, itermax, dtype,
                        n_inner: int = 1, solver: str = "sor",
                        layout: str = "auto", flat: bool = False,
                        stall_rtol=None, mg_fused: str = "auto", *, device):
    """The 2-D pressure-Poisson solve (solve -> (p, res, it)), as the JAX
    make_pressure_solve dispatches it: `sor` the red-black convergence
    loop, `mg` multigrid V-cycles (`it` counts cycles; `stall_rtol`,
    `mg_fused` are tpu_mg_stall_rtol and tpu_mg_fused), `fft` the DCT
    direct solve (`it` = 1). `device` is where the MG and DCT solves build
    their level data and matrices."""
    if solver == "mg":
        return make_mg_solve_2d(imax, jmax, dx, dy, eps, itermax, dtype,
                                stall_rtol=stall_rtol, fused=mg_fused,
                                device=device)
    if solver == "fft":
        return make_dct_solve_2d(imax, jmax, dx, dy, dtype, device=device)
    if solver != "sor":
        raise ValueError(f"pressure solve supports sor|mg|fft, got "
                         f"{solver!r} (resolve auto first)")
    return make_solver_fn(imax, jmax, dx, dy, omega, eps, itermax, dtype,
                          n_inner=n_inner, layout=layout, flat=flat)


def solve_label(param: Parameter, dtype) -> str:
    """The dispatch record's name of a resolved Parameter's 2-D solve."""
    if param.tpu_solver != "sor":
        return param.tpu_solver
    layout = resolve_layout(param.imax, param.jmax, param.tpu_sor_layout)
    return f"sor {layout} n_inner={sor_cadence(param, dtype)}"


def make_pressure_solve_for(param: Parameter, dx, dy, dtype, device):
    """make_pressure_solve with every knob taken from a resolved
    Parameter: the one build of the 2-D solve for PoissonSolver and
    NS2DSolver, checking convergence at the dtype's sor_cadence."""
    return make_pressure_solve(
        param.imax, param.jmax, dx, dy, param.omg, param.eps, param.itermax,
        dtype, n_inner=sor_cadence(param, dtype), solver=param.tpu_solver,
        layout=param.tpu_sor_layout, flat=bool(param.tpu_flat_solve),
        stall_rtol=param.tpu_mg_stall_rtol, mg_fused=param.tpu_mg_fused,
        device=device)


class PoissonSolver:
    """Driver-facing Poisson solver (the reference's Solver struct with
    init/solve/writeResult). Fields live on `device` ("cuda" by default;
    "cpu" runs the kernels' plain versions)."""

    def __init__(self, param: Parameter, problem: int = 2, dtype=None,
                 device="cuda"):
        param = resolve_solver(param)
        check_supported(param)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None else dtype
        self.param = param
        self.imax, self.jmax = param.imax, param.jmax
        self.dx = param.xlength / param.imax
        self.dy = param.ylength / param.jmax
        self.p, self.rhs = init_fields(param, problem, self.dtype, self.device)
        self._solve = self._make_solve()

    def _make_solve(self):
        """The solve the resolved `tpu_solver` selects (the JAX
        PoissonSolver._make_solve)."""
        record("poisson_solver",
               f"{solve_label(self.param, self.dtype)} on {self.device.type}")
        return make_pressure_solve_for(self.param, self.dx, self.dy,
                                       self.dtype, self.device)

    @classmethod
    def from_numpy(cls, param: Parameter, p, rhs, device="cuda"):
        """A solver whose p and rhs are the given arrays (e.g. a JAX
        solver's fields), cast to the configured dtype."""
        s = cls(param, device=device)
        # copies: the solver updates p in place
        s.p = tensor_from_array(p, s.dtype, s.device)
        s.rhs = tensor_from_array(rhs, s.dtype, s.device)
        return s

    def solve(self):
        """Run the convergence loop; returns (iterations, residual)."""
        self.p, res, it = self._solve(self.p, self.rhs)
        return it, res

    def write_result(self, path: str = "p.dat") -> None:
        write_matrix(self.p, path)
