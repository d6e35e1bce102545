"""2-D Poisson solver: red-black SOR with a residual-convergence loop
(counterpart of pampi_tpu/models/poisson.py, the reference's assignment-4).

One solve call advances the field by `eff_inner` red-black iterations with
kernel K1 (quarter layout) or K2 (checkerboard), then reads the residual
back to the host and checks `res >= eps² and it < itermax`. That is one
host sync per check, where the JAX package keeps the whole loop on the
device in a `while_loop`; moving the loop onto the device is later work.
The iteration count `it` advances by exactly `eff_inner` per call, as in
the JAX package's convergence loops.

The residual is normalised and compared on the host in the field's dtype
(numpy float32 or float64 arithmetic), which is what the JAX loop computes
on the device: `rsq / norm` in the field dtype, compared with eps² cast to
that dtype.

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

from ..ops.sor_kernels import rb_sor_checkerboard, rb_sor_quarters, sor_coefficients
from ..ops.sor_quarters import stack_quarters, unstack_quarters
from ..utils import flags as _flags
from ..utils.datio import write_matrix
from ..utils.device import resolve_device
from ..utils.dispatch import check_supported, record
from ..utils.params import Parameter
from ..utils.precision import check_eps_floor, resolve_dtype


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
    iterations in place on carry and returns their last Σr² (0-dim tensor,
    not yet normalised)."""
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    factor, idx2, idy2 = sor_coefficients(dx, dy, omega)
    if resolve_layout(imax, jmax, layout) == "quarters":
        def step(q, f):
            return rb_sor_quarters(q, f, n_inner, factor, idx2, idy2)

        return step, stack_quarters, unstack_quarters, n_inner

    def step(p, rhs):
        return rb_sor_checkerboard(p, rhs, n_inner, factor, idx2, idy2)

    def ident(x):
        return x.contiguous()

    return step, ident, ident, n_inner


def make_solver_fn(imax, jmax, dx, dy, omega, eps, itermax, dtype,
                   n_inner: int = 1, layout: str = "auto",
                   flat: bool = False):
    """The convergence loop: solve(p, rhs) -> (p, res, it), updating p in
    place. Convergence is checked every eff_inner iterations, so a solve
    may run up to eff_inner-1 iterations past the first one below eps
    (they only lower the residual); `it` is the true iteration count.
    flat=True runs exactly ceil(itermax/eff_inner) calls with no check in
    between (no host sync inside the solve); res is then the last one."""
    check_eps_floor(eps, imax * jmax, dtype, f"sor {imax}x{jmax}")
    step, prep, post, eff = make_rb_loop(imax, jmax, dx, dy, omega, n_inner,
                                         layout)
    real = np.float32 if dtype == torch.float32 else np.float64
    norm = real(imax * jmax)
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


class PoissonSolver:
    """Driver-facing Poisson solver (the reference's Solver struct with
    init/solve/writeResult). Fields live on `device` ("cuda" by default;
    "cpu" runs the kernels' plain versions)."""

    def __init__(self, param: Parameter, problem: int = 2, dtype=None,
                 device="cuda"):
        check_supported(param)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None else dtype
        self.param = param
        self.imax, self.jmax = param.imax, param.jmax
        self.dx = param.xlength / param.imax
        self.dy = param.ylength / param.jmax
        self.p, self.rhs = init_fields(param, problem, self.dtype, self.device)
        layout = resolve_layout(self.imax, self.jmax, param.tpu_sor_layout)
        record("poisson_sor", f"{layout} n_inner={param.tpu_sor_inner} "
               f"on {self.device.type}")
        self._solve = make_solver_fn(
            self.imax, self.jmax, self.dx, self.dy, param.omg, param.eps,
            param.itermax, self.dtype, n_inner=param.tpu_sor_inner,
            layout=param.tpu_sor_layout, flat=bool(param.tpu_flat_solve))

    @classmethod
    def from_numpy(cls, param: Parameter, p, rhs, device="cuda"):
        """A solver whose p and rhs are the given arrays (e.g. a JAX
        solver's fields), cast to the configured dtype."""
        s = cls(param, device=device)
        # copies: the solver updates p in place
        s.p = torch.from_numpy(np.array(p)).to(device=s.device, dtype=s.dtype)
        s.rhs = torch.from_numpy(np.array(rhs)).to(device=s.device,
                                                   dtype=s.dtype)
        return s

    def solve(self):
        """Run the convergence loop; returns (iterations, residual)."""
        self.p, res, it = self._solve(self.p, self.rhs)
        return it, res

    def write_result(self, path: str = "p.dat") -> None:
        write_matrix(self.p, path)
