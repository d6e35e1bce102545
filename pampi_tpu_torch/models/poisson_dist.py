"""Distributed 2-D Poisson: red-black SOR over a 2-D mesh of shards
(counterpart of pampi_tpu/models/poisson_dist.py; the reference's
assignment-4 MPI skeleton and the 2-D model of
assignment-5/ex5-nazifkar/src/solver.c:406-660).

- The field is a list of interior-only (jl, il) blocks, one per shard in
  mesh order (parallel/comm.py). Ghost layers exist only inside a solve.
- The quarter-layout path (parallel/quarters_dist.py) runs kernel K13 on
  every shard, one depth-n quarter exchange per n iterations; the grid
  communication-avoiding path (parallel/stencil2d.py, plain torch) serves
  `tpu_sor_layout checkerboard`, ragged meshes and odd shard extents, with
  the exchange-per-half-sweep fallback for extent-1 shards. Every path
  keeps the sequential red-black trajectory, so the count of iterations
  does not depend on the mesh or on n.
- The residual: per-shard owned sums of r², summed over the shards in mesh
  order (parallel/comm.reduction), normalised by the global imax·jmax, and
  compared with eps² on the host in the field's dtype, every n iterations
  (the iteration count advances by n per check).
- Ragged grids are padded with masked dead cells (pad-with-mask), as in
  the JAX package.

One host sync per convergence check, where the JAX package keeps the loop
on the device in a while_loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.sor_kernels import sor_coefficients
from ..parallel import quarters_dist as qd
from ..parallel.comm import CartComm, halo_exchange
from ..parallel.stencil2d import (
    ca_halo,
    ca_inner,
    ca_masks,
    ca_rb_iters,
    ca_supported,
    neumann_masked,
    rb_exchange_per_sweep,
    scalar_half,
)
from ..utils import dispatch as _dispatch
from ..utils.datio import write_matrix
from ..utils.params import Parameter
from ..utils.precision import resolve_dtype
from ._driver import mesh_convergence_loop

PI = math.pi


class DistPoissonSolver:
    """Mesh-parallel Poisson solver, with PoissonSolver's interface. The
    shards live on `comm.devices` (default: one per visible card, the
    `tpu_mesh auto` mesh)."""

    def __init__(self, param: Parameter, comm: CartComm | None = None,
                 problem: int = 2, dtype=None):
        if param.tpu_solver in ("sor_lex", "sor_rba"):
            # the assignment-4 oracle modes are sequential by definition
            raise ValueError(
                f"tpu_solver {param.tpu_solver} is a single-device oracle "
                "mode; distributed Poisson takes sor|mg|fft")
        self.comm = comm if comm is not None else CartComm(
            ndims=2, extents=(param.jmax, param.imax),
            tiers=param.tpu_mesh_tiers)
        self.dtype = resolve_dtype(param.tpu_dtype) if dtype is None else dtype
        self.imax, self.jmax = param.imax, param.jmax
        self.dx = param.xlength / param.imax
        self.dy = param.ylength / param.jmax
        # ceil-divided blocks; the trailing dead cells are masked
        self.jl, self.il = self.comm.local_shape((self.jmax, self.imax),
                                                 ragged=True)
        Pj, Pi = self.comm.dims
        self.ragged = self.jl * Pj != self.jmax or self.il * Pi != self.imax
        param = _dispatch.resolve_solver(param, ragged=self.ragged)
        if self.ragged and param.tpu_solver in ("mg", "fft"):
            raise ValueError(
                f"tpu_solver {param.tpu_solver} needs a divisible grid/mesh "
                f"(grid {self.jmax}x{self.imax} on {self.comm.dims}); ragged "
                "pad-with-mask runs use tpu_solver sor")
        _dispatch.check_supported(param, mesh=True)
        if param.tpu_sor_layout not in ("auto", "checkerboard", "quarters"):
            raise ValueError(
                "2-D SOR layout must be auto|checkerboard|quarters, got "
                f"{param.tpu_sor_layout!r}")
        self.param = param
        self.problem = problem
        self._build()
        self.p = [self._analytic_ext(s, 1)[1:-1, 1:-1].contiguous()
                  for s in range(self.comm.size)]
        self.res = None
        self.it = None
        self._started = False

    def _build(self):
        param, jl, il = self.param, self.jl, self.il
        self.factor, self.idx2, self.idy2 = sor_coefficients(
            self.dx, self.dy, param.omg)
        # communication-avoiding block size and halo depth of the grid path
        self.supported = ca_supported(jl, il)
        self.n_ca = ca_inner(param, jl, il) if self.supported else 1
        self.H = ca_halo(self.n_ca, self.ragged) if self.supported else 1
        self.rb_q, self.qg = qd.quarters_dispatch(
            param, self.jmax, self.imax, jl, il, self.dx, self.dy,
            self.dtype, "poisson_dist", plain_sor=not self.ragged)
        if self.rb_q is None:
            tag = f"jnp_ca ca{self.n_ca}" if self.supported else \
                "jnp_rb_fallback"
            _dispatch.record("poisson_dist",
                             tag + (" ragged" if self.ragged else ""))

    # -- per-shard fields at global indices -------------------------------
    def _index(self, s, halo):
        """Global extended indices (j, i) of shard s's halo-`halo` block, in
        float64: local a <-> global a - (halo - 1) + offset."""
        joff, ioff = self.comm.offsets(s, (self.jl, self.il))
        jj = np.arange(self.jl + 2 * halo) - (halo - 1) + joff
        ii = np.arange(self.il + 2 * halo) - (halo - 1) + ioff
        return jj.astype(np.float64), ii.astype(np.float64)

    def _vector(self, s, x):
        """A float64 numpy vector, moved to shard s's device."""
        return torch.from_numpy(x).to(self.comm.devices[s])

    def _analytic_ext(self, s, halo):
        """initSolver's p = sin(4π·i·dx) + sin(4π·j·dy) at the global
        extended indices of shard s's block (values at positions outside
        the domain are dead: masked from every update and read). The sines
        are taken in numpy float64, the sum in float64 on the shard's
        device (one IEEE add, the same bits everywhere), then cast."""
        jj, ii = self._index(s, halo)
        si = self._vector(s, np.sin(4.0 * PI * (ii * self.dx)))
        sj = self._vector(s, np.sin(4.0 * PI * (jj * self.dy)))
        return (si[None, :] + sj[:, None]).to(self.dtype)

    def _rhs_ext(self, s, halo):
        _jj, ii = self._index(s, halo)
        row = (np.sin(2.0 * PI * (ii * self.dx)) if self.problem == 2
               else np.zeros(ii.shape))
        row = self._vector(s, row).to(self.dtype)
        return row[None, :].expand(self.jl + 2 * halo, -1).contiguous()

    def _masks(self, s, halo):
        joff, ioff = self.comm.offsets(s, (self.jl, self.il))
        return ca_masks(self.jl, self.il, halo, self.jmax, self.imax,
                        self.dtype, joff, ioff, self.comm.devices[s])

    def _ext(self, s, halo, first):
        """Shard s's halo-`halo` block with its interior. Ghost
        reconstruction: on the first solve the walls carry the analytic
        init values (the sequential first sweep reads them); on a resumed
        solve the Neumann copies the previous solve ended with."""
        H = halo
        ext = self._analytic_ext(s, H)
        ext[H:-H, H:-H] = self.p[s]
        if not first:
            ext = neumann_masked(ext, self._masks(s, H))
        return ext

    # -- the convergence loop ------------------------------------------
    def _loop(self, rounds):
        return mesh_convergence_loop(rounds, self.comm, self.dtype,
                                     self.imax * self.jmax, self.param.eps,
                                     self.param.itermax)

    def _solve_quarters(self, first):
        g, comm = self.qg, self.comm
        xq, rq, qoffs = [], [], []
        for s in range(comm.size):
            joff, ioff = comm.offsets(s, (self.jl, self.il))
            xq.append(qd.pack_ext_to_q(self._ext(s, 1, first), g))
            rq.append(qd.pack_ext_to_q(self._rhs_ext(s, 1), g))
            qoffs.append((joff // 2, ioff // 2))
        qd.q_exchange(rq, comm, g)
        # two lists of planes, each with the exchange's views bound to it:
        # K13 reads the first and writes the second, and the two swap, so
        # the first holds the newest planes
        planes = [xq, [torch.empty_like(x) for x in xq]]
        copies = [qd.q_exchange_copies(x, comm, g) for x in planes]

        def rounds():
            qd.q_exchange(planes[0], comm, g, copies[0])
            r2 = [self.rb_q(o, x, f, out=y)
                  for o, x, y, f in zip(qoffs, *planes, rq)]
            planes.reverse()
            copies.reverse()
            return r2, g.n

        res, it = self._loop(rounds)
        self.p = [qd.unpack_q_to_ext(x, g)[1:-1, 1:-1].contiguous()
                  for x in planes[0]]
        return res, it

    def _solve_grid(self, first):
        comm, H = self.comm, self.H
        masks = [self._masks(s, H) for s in range(comm.size)]
        ps = [self._ext(s, H, first) for s in range(comm.size)]
        rhs = [self._rhs_ext(s, H) for s in range(comm.size)]
        coef = (self.factor, self.idx2, self.idy2)

        def rounds():
            if not self.supported:
                new, r2 = rb_exchange_per_sweep(
                    ps, rhs, masks, comm, scalar_half(masks, *coef),
                    ragged=self.ragged)
                ps[:] = new
                return r2, 1
            halo_exchange(ps, comm, depth=H)
            r2 = []
            for s, (m, f) in enumerate(zip(masks, rhs)):
                ps[s], r = ca_rb_iters(ps[s], f, self.n_ca, m, *coef)
                r2.append(r)
            return r2, self.n_ca

        res, it = self._loop(rounds)
        self.p = [p[H:-H, H:-H].contiguous() for p in ps]
        return res, it

    # -- solver API ----------------------------------------------------
    def solve(self):
        """Run the convergence loop; returns (iterations, residual)."""
        first = not self._started
        self._started = True
        if self.rb_q is not None:
            self.res, self.it = self._solve_quarters(first)
        else:
            self.res, self.it = self._solve_grid(first)
        return self.it, self.res

    def full_field(self) -> np.ndarray:
        """The reference's full (jmax+2, imax+2) array: the interior from
        the shards (dead cells of a ragged mesh stripped), Neumann edge
        ghosts, and the corner ghosts' untouched init values, for p.dat."""
        interior = self.comm.collect(self.p)
        jmax, imax = self.jmax, self.imax
        full = np.zeros((jmax + 2, imax + 2))
        full[1:-1, 1:-1] = interior[:jmax, :imax]
        full[0, 1:-1] = full[1, 1:-1]
        full[-1, 1:-1] = full[-2, 1:-1]
        full[1:-1, 0] = full[1:-1, 1]
        full[1:-1, -1] = full[1:-1, -2]
        i = np.array([0, imax + 1])
        for jc in (0, jmax + 1):
            full[jc, i] = np.sin(4.0 * PI * i * self.dx) + np.sin(
                4.0 * PI * jc * self.dy)
        return full

    def write_result(self, path: str = "p.dat") -> None:
        write_matrix(self.full_field(), path)
