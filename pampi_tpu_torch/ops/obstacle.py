"""Flag-field obstacle cells for NS-2D (counterpart of
pampi_tpu/ops/obstacle.py): axis-aligned rectangles from the .par
`obstacles` key ("x0,y0,x1,y1[;...]"), the static masks, the obstacle
velocity BC, the masked F/G and projection, the fluid-weighted pressure
normalisation, and the flag-masked pressure solve on one device and on a
2-D mesh (divisible or ragged).

- velocity: normal components on faces touching an obstacle are zeroed;
  a u face buried in obstacles mirrors the fluid-fluid face one row north
  (else south), a v face the one one column east (else west), so the
  interpolated wall velocity vanishes;
- momentum: F/G carry U/V on non-fluid faces (`mask_fg`), so the RHS sees
  no flux across an obstacle wall and the projection
  (`adapt_uv_obstacle`) leaves those faces alone;
- pressure: per-direction fluid coefficients eps_E/W/N/S in {0, 1} in the
  Laplacian and in the relaxation factor omega/((eps_E + eps_W)/dx² +
  (eps_N + eps_S)/dy²) (homogeneous Neumann on obstacle surfaces); the
  residual is normalised by the number of fluid cells. On one device the
  solve runs the masked mode of kernel K2 (ops/sor_kernels.py); on a mesh
  kernel K15 per shard (ops/sor_obsdist.py), or on shards too thin for
  its strips an exchange per half-sweep; each on its plain version for
  CPU tensors.

Obstacles must be at least 2 cells thick. The masks are numpy float64
arrays, as the JAX package computes them on the host; `ObstacleMasks.to`
moves them to a device in the field's dtype (the JAX package's cast).
The pressure solve reads only the uint8 flags: every solve forms its
coefficients from them (ops/sor_kernels.masked_stencil_2d), as the TPU
kernels form them, so the JAX package's float64 host arrays of interior
coefficients (eps_*, factor, p_mask) and its precomputed-coefficient
thin-shard path (deep_obstacle_masks, _obstacle_half,
ca_rb_iters_obstacle) are not kept. The ragged NS-2D solve without
obstacles runs the same distributed solve on all-fluid flags: a
ceil-divided block's dead cells lie outside the global interior, and the
kernel's global gating excludes them. Layout as in ops/ns2d.py:
(jmax+2, imax+2) arrays [j, i]; u on east faces, v on north faces; the
ghost ring counts as fluid.

The obstacle multigrid on one device is ops/multigrid.py's
make_obstacle_mg_solve_2d (it reads these masks' fluid field); its
distributed form is not ported (ROADMAP A.8, item 6.4), and neither is the
JAX package's padded TPU layout (`sor_pallas.pad_array`,
`sor_obsdist.padded_deep_exchange`): the port exchanges the unpadded deep
block (parallel/comm.halo_exchange).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models._driver import mesh_convergence_loop
from ..parallel import comm as pc
from ..parallel.comm import CartComm
from ..parallel.stencil2d import (
    ca_clamp,
    ca_halo,
    ca_masks,
    ca_supported,
    deep_pad_widths,
    embed_deep,
    rb_exchange_per_sweep,
    strip_deep,
)
from ..utils import dispatch as _dispatch
from ..utils.precision import check_eps_floor
from .ns2d import _const
from .sor_kernels import masked_stencil_2d, rb_sor_checkerboard
from .sor_obsdist import ObsGeom, rb_sor_obsdist


def parse_obstacles(spec: str) -> list[tuple[float, float, float, float]]:
    """Parse `obstacles` as rectangles "x0,y0,x1,y1[;x0,y0,x1,y1]..."
    (empty: none)."""
    rects = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        vals = [float(v) for v in part.split(",")]
        if len(vals) != 4:
            raise ValueError(
                f"obstacle rectangle needs 4 values x0,y0,x1,y1, got {part!r}"
            )
        x0, y0, x1, y1 = vals
        rects.append((min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1)))
    return rects


def build_fluid(imax: int, jmax: int, dx: float, dy: float,
                spec: str) -> np.ndarray:
    """Boolean fluid mask (jmax+2, imax+2), True = fluid: a cell is an
    obstacle when its centre lies inside a rectangle. The ghost ring is
    always fluid (the domain walls belong to the wall BCs)."""
    fluid = np.ones((jmax + 2, imax + 2), dtype=bool)
    x = (np.arange(imax + 2) - 0.5) * dx
    y = (np.arange(jmax + 2) - 0.5) * dy
    for (x0, y0, x1, y1) in parse_obstacles(spec):
        inside = ((x[None, :] > x0) & (x[None, :] < x1)
                  & (y[:, None] > y0) & (y[:, None] < y1))
        fluid &= ~inside
    fluid[0, :] = fluid[-1, :] = True
    fluid[:, 0] = fluid[:, -1] = True
    _validate(fluid)
    return fluid


def _validate(fluid: np.ndarray) -> None:
    obs = ~fluid[1:-1, 1:-1]
    thin_h = obs & fluid[1:-1, :-2] & fluid[1:-1, 2:]
    thin_v = obs & fluid[:-2, 1:-1] & fluid[2:, 1:-1]
    if thin_h.any() or thin_v.any():
        raise ValueError(
            "obstacle cells with fluid on two opposite sides (1-cell-thin "
            "walls) are not representable; make obstacles >= 2 cells thick"
        )


_FULL = ("fluid", "u_face", "v_face")


@dataclass(frozen=True)
class ObstacleMasks:
    """The static masks of one geometry and grid on a (J+2, I+2) array:
    numpy float64 from make_masks, torch tensors after `to`."""

    fluid: object   # 0/1 cell is fluid (the ghost ring is fluid)
    u_face: object  # 1 where u[j, i] is a fluid-fluid face
    v_face: object
    n_fluid: float  # interior fluid cells (of the global grid)
    omega: float

    def to(self, dtype, device="cpu") -> "ObstacleMasks":
        """The masks as tensors of `dtype` on `device` (the JAX package's
        jnp.asarray(a, dtype) cast of the float64 host arrays)."""
        return dataclasses.replace(self, **{
            name: torch.from_numpy(np.ascontiguousarray(
                getattr(self, name))).to(device=device, dtype=dtype)
            for name in _FULL})

    def flags(self, device="cpu") -> torch.Tensor:
        """The fluid field as uint8 (1 byte a cell), the kernels' input."""
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(self.fluid) != 0).astype(
                np.uint8)).to(device)


def make_masks(fluid_np: np.ndarray, dx: float, dy: float,
               omega: float) -> ObstacleMasks:
    """The masks of a boolean fluid field (jmax+2, imax+2), in float64
    numpy as the JAX package computes them, including its fix of the
    wrapping roll on the last ghost column and row (always a face: ghosts
    are fluid). dx, dy are the JAX signature's; the solves form their
    coefficients from the flags."""
    f = np.asarray(fluid_np, dtype=bool)
    u_face = f & np.roll(f, -1, axis=1)
    u_face[:, -1] = True
    v_face = f & np.roll(f, -1, axis=0)
    v_face[-1, :] = True
    return ObstacleMasks(
        fluid=f.astype(np.float64), u_face=u_face.astype(np.float64),
        v_face=v_face.astype(np.float64),
        n_fluid=float(f[1:-1, 1:-1].sum()), omega=float(omega))


@dataclass(frozen=True)
class Faces:
    """The fields the velocity BC, mask_fg and the projection read: the
    fluid field and the two face masks, on one block (ObstacleMasks has
    the same three)."""

    fluid: torch.Tensor
    u_face: torch.Tensor
    v_face: torch.Tensor


def block_faces(flags, gj, gi, gext, dtype) -> Faces:
    """The face masks of a block from its own uint8 flags: a face is
    fluid-fluid where the cell and its + neighbour are fluid, the +
    neighbour a roll that wraps on the block, and the last global ghost
    column (row) is forced to a u (v) face, make_masks' fix (the JAX
    window form ns2d_fused._obstacle_faces). (gj, gi) are the cells'
    global indices (ops/ns2d.index_grids_2d), gext the global interior
    extents. On the whole (J+2, I+2) array these are make_masks' faces."""
    J, I = gext
    fl = flags.to(dtype)
    one = torch.ones((), dtype=dtype, device=fl.device)
    return Faces(fl,
                 torch.where(gi == I + 1, one, fl * torch.roll(fl, -1, 1)),
                 torch.where(gj == J + 1, one, fl * torch.roll(fl, -1, 0)))


def apply_obstacle_velocity_bc(u, v, m):
    """No-slip on obstacle surfaces: zero the normal components on every
    face touching an obstacle, then mirror a face buried in obstacles from
    the fluid-fluid face one row north, else south (u), one column east,
    else west (v). Every mirror reads its component as it is after the
    zeroing (the JAX function is functional). `m` holds fluid, u_face,
    v_face (ObstacleMasks.to, Faces or shard_masks). Returns new
    tensors."""
    one = torch.ones((), dtype=u.dtype, device=u.device)
    r = torch.roll
    u = u * m.u_face
    v = v * m.v_face
    both_u = (one - m.fluid) * (one - r(m.fluid, -1, 1))
    uf_n, uf_s = r(m.u_face, -1, 0), r(m.u_face, 1, 0)
    u = u + both_u * (uf_n * (-r(u, -1, 0))
                      + (one - uf_n) * uf_s * (-r(u, 1, 0)))
    both_v = (one - m.fluid) * (one - r(m.fluid, -1, 0))
    vf_e, vf_w = r(m.v_face, -1, 1), r(m.v_face, 1, 1)
    v = v + both_v * (vf_e * (-r(v, -1, 1))
                      + (one - vf_e) * vf_w * (-r(v, 1, 1)))
    return u, v


def mask_fg(f, g, u, v, m):
    """F/G carry U/V on every non-fluid face (the obstacle form of the
    reference's wall fixups, solver.c:425-435). Returns new tensors."""
    one = torch.ones((), dtype=f.dtype, device=f.device)
    return (m.u_face * f + (one - m.u_face) * u,
            m.v_face * g + (one - m.v_face) * v)


def adapt_uv_obstacle(u, v, f, g, p, dt, dx, dy, m):
    """The projection restricted to fluid-fluid faces: interior cells get
    the corrected velocity times their face mask, ghost cells keep u, v.
    Returns new tensors."""
    fx = dt / _const(dx, dt)
    fy = dt / _const(dy, dt)
    c = p[1:-1, 1:-1]
    u_new = f[1:-1, 1:-1] - (p[1:-1, 2:] - c) * fx
    v_new = g[1:-1, 1:-1] - (p[2:, 1:-1] - c) * fy
    u, v = u.clone(), v.clone()
    u[1:-1, 1:-1] = u_new * m.u_face[1:-1, 1:-1]
    v[1:-1, 1:-1] = v_new * m.v_face[1:-1, 1:-1]
    return u, v


def normalize_pressure_fluid(p, fluid):
    """p minus its mean over the fluid cells of the full array, ghosts
    counted, obstacle cells excluded (`fluid` the 0/1 field in p's
    dtype)."""
    return p - torch.sum(p * fluid) / torch.sum(fluid)


# -- the pressure solve ------------------------------------------------------


def make_obstacle_solver_fn(imax, jmax, dx, dy, eps, itermax,
                            m: ObstacleMasks, dtype, n_inner: int = 1, *,
                            device):
    """The one-device obstacle pressure solve, solve(p, rhs) -> (p, res,
    it): the masked mode of K2, n_inner iterations a call (its plain
    version on the CPU), the residual Σr²/n_fluid checked against eps²
    after every call (NS2DSolver passes the dtype's sor_cadence, so the
    iteration counts are the JAX package's). Each call reads one field and
    writes the other of a pair (K2's one-launch `out=` form), and the two
    swap; a solve that ends in the second field copies it into p once.
    The relaxation factor is formed from the flags in the field's dtype,
    as the TPU kernel forms it; the JAX package's jnp path takes a factor
    made on the host in float64, which equals it at float64."""
    from ..models.poisson import make_convergence_loop

    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    check_eps_floor(eps, imax * jmax, dtype, f"sor_obstacle {imax}x{jmax}")
    idx2, idy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    flags = m.flags(device)

    def step(pair, rhs):
        # pair = [newest field, the other one (made at the first call)]
        if len(pair) == 1:
            pair.append(torch.empty_like(pair[0]))
        r = rb_sor_checkerboard(pair[0], rhs[0], n_inner, 0.0, idx2, idy2,
                                flags=flags, omega=m.omega, out=pair[1])
        pair.reverse()
        return r

    def prep(x):
        return [x.contiguous()]

    solve = make_convergence_loop(step, prep, lambda pair: pair[0], n_inner,
                                  m.n_fluid, eps, itermax, dtype)
    solve.flags = flags
    return solve


# -- on a 2-D mesh -----------------------------------------------------------


def shard_masks(m: ObstacleMasks, comm: CartComm, s: int, jl: int,
                il: int) -> ObstacleMasks:
    """Shard s's view of the global masks: its (jl+2, il+2) halo-1 block
    sliced at its offsets, the cells past the global array (the ragged
    ceil-division overhang) zero, so dead cells read zero masks: no
    updates, no faces. Overlapping blocks agree wherever they overlap."""
    joff, ioff = comm.offsets(s, (jl, il))

    def block(a):
        out = np.zeros((jl + 2, il + 2))
        sub = np.asarray(a)[joff:joff + jl + 2, ioff:ioff + il + 2]
        out[:sub.shape[0], :sub.shape[1]] = sub
        return out

    return dataclasses.replace(m, **{name: block(getattr(m, name))
                                     for name in _FULL})


def deep_flag_block(m: ObstacleMasks, comm: CartComm, s: int, jl: int,
                    il: int, H: int, jmax: int, imax: int, device="cpu"):
    """Shard s's (jl+2H, il+2H) deep block of the fluid flags, as uint8:
    the global flags padded with dead (0) cells, H-1 per side and the
    ragged overhang on the high side (stencil2d.deep_pad_widths), sliced
    at the shard's offsets. Identical values on every shard that holds a
    cell, so the redundant halo updates agree. H = 1 gives the halo-1
    block."""
    pw_j = deep_pad_widths(H, jl, comm.axis_size("j"), jmax)
    pw_i = deep_pad_widths(H, il, comm.axis_size("i"), imax)
    wide = np.pad((np.asarray(m.fluid) != 0).astype(np.uint8), [pw_j, pw_i])
    joff, ioff = comm.offsets(s, (jl, il))
    blk = wide[joff:joff + jl + 2 * H, ioff:ioff + il + 2 * H]
    return torch.from_numpy(np.ascontiguousarray(blk)).to(device)


def make_dist_obstacle_solver(comm: CartComm, imax, jmax, jl, il, dx, dy,
                              eps, itermax, m: ObstacleMasks, dtype,
                              n: int, ragged: bool = False,
                              record_key: str = "obstacle_dist"):
    """The distributed flag-masked pressure solve, communication-avoiding:
    one depth-H halo exchange (H = ca_halo(n, ragged): 2n, 2n+1 on a
    ragged mesh) buys n exact red-black iterations, which kernel K15 runs
    on every shard's deep block (ops/sor_obsdist.py; its plain version on
    CPU tensors). The residual, normalised by the global fluid-cell count,
    is checked every n iterations. `n` is the caller's cadence
    (utils/dispatch.sor_cadence); it is clamped so that the deep strips
    come from owned cells (ca_clamp, and on a ragged mesh until 2n+1 fits
    the least extent). The JAX package also halves the depth when its
    kernel overflows the TPU's VMEM; the card has no such limit on this
    kernel, so that back-off is not ported.

    Returns solve(p, rhs) -> (p, res, it) on lists of halo-1 blocks (p
    exchanged on return: the projection reads it across shard edges), with
    the cadence, the shards' geometry, deep flag blocks and offsets as
    solve.n, solve.geom, solve.flags and solve.offs (for callers that time
    or check K15 at this solve's shapes). Shards below the CA's extents
    get None: the caller runs the exchange-per-half-sweep fallback
    (make_obstacle_fallback with obstacles, parallel/stencil2d.
    rb_exchange_per_sweep without), as the JAX package's solvers do. The
    decision is recorded under record_key with the JAX package's labels
    ("pallas caN[ ragged]", "jnp_rb_fallback[ ragged]")."""
    check_eps_floor(eps, imax * jmax, dtype,
                    f"sor_dist_obstacle {imax}x{jmax}")
    suffix = " ragged" if ragged else ""
    if not (ca_supported(jl, il)
            and (not ragged or ca_halo(1, True) <= min(jl, il))):
        _dispatch.record(record_key, f"jnp_rb_fallback{suffix}")
        return None
    idx2, idy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    n = ca_clamp(n, jl, il)
    while ragged and n > 1 and ca_halo(n, True) > min(jl, il):
        n -= 1
    H = ca_halo(n, ragged)
    geom = ObsGeom(jmax, imax, jl, il, n, H)
    offs = [comm.offsets(s, (jl, il)) for s in range(comm.size)]
    flags = [deep_flag_block(m, comm, s, jl, il, H, jmax, imax, dev)
             for s, dev in enumerate(comm.devices)]
    _dispatch.record(record_key, f"pallas ca{n}{suffix}")

    def solve(p, rhs):
        pd = [embed_deep(x, H) for x in p]
        qd = [torch.empty_like(x) for x in pd]
        rd = pc.halo_exchange([embed_deep(x, H) for x in rhs], comm, depth=H)

        def rounds():
            # K15 reads pd and writes qd; the two swap, so pd holds the
            # newest blocks
            pc.halo_exchange(pd, comm, depth=H)
            res = [rb_sor_obsdist(x, f, fl, geom, o, m.omega, idx2, idy2,
                                  out=y)
                   for x, y, f, fl, o in zip(pd, qd, rd, flags, offs)]
            pd[:], qd[:] = list(qd), list(pd)
            return res, n

        res, it = mesh_convergence_loop(rounds, comm, dtype, int(m.n_fluid),
                                        eps, itermax)
        p = [strip_deep(x, H).contiguous() for x in pd]
        return pc.halo_exchange(p, comm), res, it

    solve.n, solve.geom, solve.flags, solve.offs = n, geom, flags, offs
    return solve


def _flag_half(p, rhs, upd, fac, lap):
    """One flag-masked half-sweep on a halo-1 block, in place on p: the
    cells of `upd` relax with the flags' coefficients (fac, lap:
    sor_kernels.masked_stencil_2d). Returns r."""
    inner = (slice(1, -1), slice(1, -1))
    r = torch.where(upd, rhs[inner] - lap(p), torch.zeros_like(fac))
    p[inner] = p[inner] - fac * r
    return r


def make_obstacle_fallback(comm: CartComm, imax, jmax, jl, il, dx, dy, eps,
                           itermax, m: ObstacleMasks, dtype,
                           ragged: bool = False):
    """The distributed obstacle solve on shards too thin for the CA's
    strips (where make_dist_obstacle_solver returns None): rounds of
    parallel/stencil2d.rb_exchange_per_sweep (one red-black iteration, an
    exchange before each half-sweep) on halo-1 blocks, whose half-sweep is
    the flag-masked one with the stencil formed from each shard's halo-1
    flag block (deep_flag_block with H = 1) by masked_stencil_2d. The
    residual, normalised by the global fluid-cell count, is checked every
    iteration. Returns solve(p, rhs) -> (p, res, it) on lists of halo-1
    blocks, p exchanged on return."""
    idx2, idy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    inner = (slice(1, -1), slice(1, -1))
    cms, sweeps = [], []
    for s, dev in enumerate(comm.devices):
        cms.append(ca_masks(jl, il, 1, jmax, imax, torch.bool,
                            *comm.offsets(s, (jl, il)), device=dev))
        fl = deep_flag_block(m, comm, s, jl, il, 1, jmax, imax, dev)
        fluid = fl[inner] != 0
        sweeps.append(({c: cms[-1][c][inner] & fluid
                        for c in ("red", "black")},
                       *masked_stencil_2d(fl, dtype, m.omega, idx2, idy2)))

    def half(s, colour, p, f):
        upd, fac, lap = sweeps[s]
        return _flag_half(p, f, upd[colour], fac, lap)

    def solve(p, rhs):
        p = [x.clone() for x in p]
        rd = pc.halo_exchange([x.clone() for x in rhs], comm)

        def rounds():
            new, r2 = rb_exchange_per_sweep(p, rd, cms, comm, half, ragged)
            p[:] = new
            return r2, 1

        res, it = mesh_convergence_loop(rounds, comm, dtype, int(m.n_fluid),
                                        eps, itermax)
        return pc.halo_exchange(p, comm), res, it

    return solve
