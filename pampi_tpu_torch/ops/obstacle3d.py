"""Flag-field obstacle cells for NS-3D (counterpart of
pampi_tpu/ops/obstacle3d.py): axis-aligned boxes from the .par `obstacles`
key ("x0,y0,z0,x1,y1,z1[;...]"), the static masks, the obstacle velocity
BC, the masked F/G/H and projection, and the flag-masked pressure solve on
one device and on a 3-D mesh.

- velocity: normal components on faces touching an obstacle are zeroed;
  tangential components on faces buried in obstacles mirror the nearest
  fluid-fluid face (priority j± then k± for u, i± then k± for v, i± then
  j± for w), so the interpolated wall velocity vanishes;
- momentum: F/G/H carry U/V/W on non-fluid faces (`mask_fgh`), so the
  RHS sees no flux across an obstacle wall and the projection
  (`adapt_uvw_obstacle`) leaves those faces alone;
- pressure: per-direction fluid coefficients eps_{e,w,n,s,b,f} in {0, 1}
  in the Laplacian and in the relaxation factor omega/denom (homogeneous
  Neumann on obstacle surfaces); the residual is normalised by the number
  of fluid cells. On one device the solve runs the masked mode of kernel
  K5 (ops/sor3d_kernels.py); on a mesh that divides the grid kernel K16
  per shard (ops/sor_obsdist3d.py), each on its plain version for CPU
  tensors; on a mesh that does not divide it, and on shards too thin for
  K16, the JAX package's jnp path in plain torch (the deep-halo CA
  iterations or the exchange-per-half-sweep fallback).

Obstacles must be at least 2 cells thick per axis. The masks are numpy
float64 arrays, as the JAX package computes them on the host;
`ObstacleMasks3D.to` moves them to a device in the field's dtype (the
JAX package's cast). The kernels read only the uint8 flags: their
coefficients are formed from them (ops/sor3d_kernels.masked_stencil_3d),
as the TPU kernels form them. The jnp path's coefficient fields (p_mask,
eps_*, factor) are formed on the host in float64, as the JAX package
forms them, and cut per shard (`interior_coefficients_3d`,
`deep_obstacle_masks_3d`). Layout as in ops/ns3d.py: (kmax+2, jmax+2,
imax+2) arrays [k, j, i]; u on east faces, v on north faces, w on back
faces; the ghost shell counts as fluid. On a mesh that does not divide
the grid the dead cells past the global array read zero masks and flags.

The obstacle multigrid on one device is ops/multigrid.py's
make_obstacle_mg_solve_3d; the JAX package's distributed obstacle
multigrid is not ported (ROADMAP A.8, item 6.4), and neither is its
padded TPU layout (`pad_array_3d`, `padded_deep_exchange_3d`): the port
exchanges the unpadded deep block (parallel/comm.halo_exchange).
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
    ca_supported,
    embed_deep,
    strip_deep,
)
from ..parallel.stencil3d import _owned_r2_3d, ca_masks_3d, neumann_masked_3d
from ..utils import dispatch as _dispatch
from ..utils.precision import check_eps_floor
from .ns2d import _const
from .sor3d_kernels import rb_sor3d_checkerboard
from .sor_obsdist3d import ObsGeom3, rb_sor_obsdist3d


def parse_obstacles_3d(spec: str) -> list[tuple[float, ...]]:
    """Parse `obstacles` as 3-D boxes "x0,y0,z0,x1,y1,z1[;...]"."""
    boxes = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        vals = [float(v) for v in part.split(",")]
        if len(vals) != 6:
            raise ValueError(
                f"3-D obstacle box needs 6 values x0,y0,z0,x1,y1,z1, "
                f"got {part!r}"
            )
        x0, y0, z0, x1, y1, z1 = vals
        boxes.append((
            min(x0, x1), min(y0, y1), min(z0, z1),
            max(x0, x1), max(y0, y1), max(z0, z1),
        ))
    return boxes


def build_fluid_3d(imax, jmax, kmax, dx, dy, dz, spec: str) -> np.ndarray:
    """Boolean fluid mask (kmax+2, jmax+2, imax+2), True = fluid: a cell is
    an obstacle when its centre lies inside a box. The ghost shell is
    always fluid (the domain walls belong to the wall BCs)."""
    fluid = np.ones((kmax + 2, jmax + 2, imax + 2), dtype=bool)
    x = (np.arange(imax + 2) - 0.5) * dx
    y = (np.arange(jmax + 2) - 0.5) * dy
    z = (np.arange(kmax + 2) - 0.5) * dz
    for (x0, y0, z0, x1, y1, z1) in parse_obstacles_3d(spec):
        inside = (
            (x[None, None, :] > x0) & (x[None, None, :] < x1)
            & (y[None, :, None] > y0) & (y[None, :, None] < y1)
            & (z[:, None, None] > z0) & (z[:, None, None] < z1)
        )
        fluid &= ~inside
    fluid[0], fluid[-1] = True, True
    fluid[:, 0], fluid[:, -1] = True, True
    fluid[:, :, 0], fluid[:, :, -1] = True, True
    _validate_3d(fluid)
    return fluid


def _validate_3d(fluid: np.ndarray) -> None:
    obs = ~fluid[1:-1, 1:-1, 1:-1]
    thin_i = obs & fluid[1:-1, 1:-1, :-2] & fluid[1:-1, 1:-1, 2:]
    thin_j = obs & fluid[1:-1, :-2, 1:-1] & fluid[1:-1, 2:, 1:-1]
    thin_k = obs & fluid[:-2, 1:-1, 1:-1] & fluid[2:, 1:-1, 1:-1]
    if thin_i.any() or thin_j.any() or thin_k.any():
        raise ValueError(
            "obstacle cells with fluid on two opposite sides (1-cell-thin "
            "walls) are not representable; make obstacles >= 2 cells thick"
        )


_FULL = ("fluid", "u_face", "v_face", "w_face")


@dataclass(frozen=True)
class ObstacleMasks3D:
    """The static masks of one geometry and grid on the (K+2, J+2, I+2)
    array: numpy float64 from make_masks_3d, torch tensors after `to`."""

    fluid: object   # 0/1 cell is fluid (the ghost shell is fluid)
    u_face: object  # 1 where u[k, j, i] is a fluid-fluid face (i dir)
    v_face: object  # (j dir)
    w_face: object  # (k dir)
    n_fluid: float  # interior fluid cells
    omega: float

    def to(self, dtype, device="cpu") -> "ObstacleMasks3D":
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


def make_masks_3d(fluid_np: np.ndarray, dx, dy, dz,
                  omega) -> ObstacleMasks3D:
    """The masks of a boolean fluid field, in float64 numpy as the JAX
    package computes them, including its fixes of the wrapping roll on
    the last ghost column, row and plane (always a face: ghosts are
    fluid). dx, dy, dz are the JAX signature's; the solve forms its
    coefficients from the flags."""
    f = np.asarray(fluid_np, dtype=bool)
    u_face = f & np.roll(f, -1, axis=2)
    u_face[:, :, -1] = True
    v_face = f & np.roll(f, -1, axis=1)
    v_face[:, -1, :] = True
    w_face = f & np.roll(f, -1, axis=0)
    w_face[-1, :, :] = True
    return ObstacleMasks3D(
        fluid=f.astype(np.float64), u_face=u_face.astype(np.float64),
        v_face=v_face.astype(np.float64), w_face=w_face.astype(np.float64),
        n_fluid=float(f[1:-1, 1:-1, 1:-1].sum()), omega=float(omega))


@dataclass(frozen=True)
class Faces3D:
    """The fields the velocity BC, mask_fgh and the projection read: the
    fluid field and the three face masks, on one block (ObstacleMasks3D
    has the same four)."""

    fluid: torch.Tensor
    u_face: torch.Tensor
    v_face: torch.Tensor
    w_face: torch.Tensor


def block_faces_3d(flags, gk, gj, gi, gext, dtype) -> Faces3D:
    """The face masks of a block from its own uint8 flags: a face is
    fluid-fluid where the cell and its + neighbour are fluid, the + read a
    roll that wraps on the block, and the last global ghost plane of each
    axis is forced to a face (make_masks_3d's fixes; the JAX window form
    ns3d_fused._obstacle_faces_3d). (gk, gj, gi) are the cells' global
    indices (ops/ns3d.index_grids), gext the global interior extents. On
    the whole (K+2, J+2, I+2) array these are make_masks_3d's faces."""
    K, J, I = gext
    fl = flags.to(dtype)
    one = torch.ones((), dtype=dtype, device=fl.device)
    return Faces3D(
        fl,
        torch.where(gi == I + 1, one, fl * torch.roll(fl, -1, 2)),
        torch.where(gj == J + 1, one, fl * torch.roll(fl, -1, 1)),
        torch.where(gk == K + 1, one, fl * torch.roll(fl, -1, 0)))


def _mirror(comp, both_obs, faces_and_vals):
    """comp + both_obs · the first-hit mirror of the neighbouring
    fluid-fluid faces, in priority order [(face_mask, value), ...]."""
    one = torch.ones((), dtype=comp.dtype, device=comp.device)
    acc = torch.zeros_like(comp)
    remaining = torch.ones_like(comp)
    for fm, val in faces_and_vals:
        acc = acc + remaining * fm * (-val)
        remaining = remaining * (one - fm)
    return comp + both_obs * acc


def apply_obstacle_velocity_bc_3d(u, v, w, m):
    """No-slip on obstacle surfaces: zero the normal components on every
    face touching an obstacle, then mirror the tangential ghosts from the
    nearest fluid-fluid face. Every mirror reads its component as it is
    after the zeroing (the JAX function is functional). `m` holds fluid,
    u_face, v_face, w_face (ObstacleMasks3D.to or Faces3D). Returns new
    tensors."""
    one = torch.ones((), dtype=u.dtype, device=u.device)
    r = torch.roll
    u = u * m.u_face
    v = v * m.v_face
    w = w * m.w_face
    both_u = (one - m.fluid) * (one - r(m.fluid, -1, 2))
    u = _mirror(u, both_u, [
        (r(m.u_face, -1, 1), r(u, -1, 1)),   # north (j+1)
        (r(m.u_face, 1, 1), r(u, 1, 1)),     # south (j-1)
        (r(m.u_face, -1, 0), r(u, -1, 0)),   # back  (k+1)
        (r(m.u_face, 1, 0), r(u, 1, 0)),     # front (k-1)
    ])
    both_v = (one - m.fluid) * (one - r(m.fluid, -1, 1))
    v = _mirror(v, both_v, [
        (r(m.v_face, -1, 2), r(v, -1, 2)),   # east  (i+1)
        (r(m.v_face, 1, 2), r(v, 1, 2)),     # west  (i-1)
        (r(m.v_face, -1, 0), r(v, -1, 0)),   # back
        (r(m.v_face, 1, 0), r(v, 1, 0)),     # front
    ])
    both_w = (one - m.fluid) * (one - r(m.fluid, -1, 0))
    w = _mirror(w, both_w, [
        (r(m.w_face, -1, 2), r(w, -1, 2)),   # east
        (r(m.w_face, 1, 2), r(w, 1, 2)),     # west
        (r(m.w_face, -1, 1), r(w, -1, 1)),   # north
        (r(m.w_face, 1, 1), r(w, 1, 1)),     # south
    ])
    return u, v, w


def mask_fgh(f, g, h, u, v, w, m):
    """F/G/H carry U/V/W on every non-fluid face (the obstacle form of the
    reference's wall fixups, solver.c:771-823). Returns new tensors."""
    one = torch.ones((), dtype=f.dtype, device=f.device)
    return (m.u_face * f + (one - m.u_face) * u,
            m.v_face * g + (one - m.v_face) * v,
            m.w_face * h + (one - m.w_face) * w)


def adapt_uvw_obstacle(u, v, w, f, g, h, p, dt, dx, dy, dz, m):
    """The projection restricted to fluid-fluid faces: interior cells get
    the corrected velocity times their face mask, ghost cells keep u, v,
    w. Returns new tensors."""
    I = slice(1, -1)
    out = []
    for a, fa, face, d, nb in ((u, f, m.u_face, dx, p[I, I, 2:]),
                               (v, g, m.v_face, dy, p[I, 2:, I]),
                               (w, h, m.w_face, dz, p[2:, I, I])):
        new = fa[I, I, I] - (nb - p[I, I, I]) * (dt / _const(d, dt))
        a = a.clone()
        a[I, I, I] = new * face[I, I, I]
        out.append(a)
    return tuple(out)


# -- the pressure solve ------------------------------------------------------


def make_obstacle_solver_fn_3d(imax, jmax, kmax, dx, dy, dz, eps, itermax,
                               m: ObstacleMasks3D, dtype, n_inner: int = 1,
                               *, device):
    """The one-device obstacle pressure solve, solve(p, rhs) -> (p, res,
    it): the masked mode of K5, n_inner iterations a call (its plain
    version on the CPU), the residual Σr²/n_fluid checked against eps²
    after every call (NS3DSolver passes the dtype's sor_cadence). Each
    call reads one field and writes the other of a pair (the masked
    mode's `out=` form), and the two swap; a solve that ends in the second
    field copies it into p once. The relaxation factor is formed from the
    flags in the field's dtype, as the TPU kernel forms it; the JAX
    package's jnp path takes a factor made on the host in float64, which
    equals it at float64."""
    from ..models.poisson import make_convergence_loop

    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    check_eps_floor(eps, int(m.n_fluid), dtype,
                    f"sor_obstacle3d {imax}x{jmax}x{kmax}")
    idx2, idy2, idz2 = 1.0 / (dx * dx), 1.0 / (dy * dy), 1.0 / (dz * dz)
    flags = m.flags(device)

    def step(pair, rhs):
        # pair = [newest field, the other one (made at the first call)]
        if len(pair) == 1:
            pair.append(torch.empty_like(pair[0]))
        r = rb_sor3d_checkerboard(pair[0], rhs[0], n_inner, 0.0, idx2, idy2,
                                  idz2, flags=flags, omega=m.omega,
                                  out=pair[1])
        pair.reverse()
        return r

    def prep(x):
        return [x.contiguous()]

    solve = make_convergence_loop(step, prep, lambda pair: pair[0], n_inner,
                                  m.n_fluid, eps, itermax, dtype)
    solve.flags = flags
    return solve


# -- on a 3-D mesh -----------------------------------------------------------


def _cut(a, offs, size, lo: int = 0):
    """The (size)-box of the global array `a` whose local index 0 sits at
    global index offs - lo per axis, zero where the box runs past `a`
    (the JAX package's slice of the array padded with `lo` zeros per side
    and, on the HI sides, by the ceil-division overhang)."""
    a = np.asarray(a)
    out = np.zeros(size, a.dtype)
    src, dst = [], []
    for o, n, g in zip(offs, size, a.shape):
        start = o - lo
        lo_src, hi_src = max(0, start), min(g, start + n)
        src.append(slice(lo_src, max(lo_src, hi_src)))
        dst.append(slice(lo_src - start, max(lo_src, hi_src) - start))
    out[tuple(dst)] = a[tuple(src)]
    return out


def shard_masks_3d(m: ObstacleMasks3D, comm: CartComm, s: int, kl: int,
                   jl: int, il: int) -> ObstacleMasks3D:
    """Shard s's view of the global masks: its halo-1 block, sliced at its
    offsets; on a mesh that does not divide the grid the dead cells past
    the global array read zero masks (the JAX package's HI-side pad by the
    ceil-division overhang)."""
    offs = comm.offsets(s, (kl, jl, il))
    size = (kl + 2, jl + 2, il + 2)
    return dataclasses.replace(m, **{
        name: _cut(getattr(m, name), offs, size) for name in _FULL})


def deep_flag_block_3d(m: ObstacleMasks3D, comm: CartComm, s: int, kl: int,
                       jl: int, il: int, H: int, device="cpu"):
    """Shard s's (kl+2H, jl+2H, il+2H) deep block of the fluid flags, as
    uint8: the global flags padded with H-1 dead (0) cells per side (and,
    on a mesh that does not divide the grid, by the ceil-division overhang
    on the HI sides) and sliced at the shard's offsets (local index a is
    global a - (H-1) + offset)."""
    blk = _cut((np.asarray(m.fluid) != 0).astype(np.uint8),
               comm.offsets(s, (kl, jl, il)),
               (kl + 2 * H, jl + 2 * H, il + 2 * H), H - 1)
    return torch.from_numpy(blk).to(device)


_COEF = ("p_mask", "eps_e", "eps_w", "eps_n", "eps_s", "eps_b", "eps_f",
         "factor")


def interior_coefficients_3d(m: ObstacleMasks3D, dx, dy, dz) -> dict:
    """The global interior (kmax, jmax, imax) coefficient fields of the
    eps-coefficient stencil, in float64 numpy as the JAX package's
    make_masks_3d forms them on the host: p_mask (the cell is fluid),
    eps_e/w/n/s/b/f (the +i/-i/+j/-j/+k/-k neighbour and the cell are
    fluid) and factor = omega/denom on fluid cells."""
    f = np.asarray(m.fluid) != 0
    fi = f[1:-1, 1:-1, 1:-1]
    eps = {"eps_e": f[1:-1, 1:-1, 2:], "eps_w": f[1:-1, 1:-1, :-2],
           "eps_n": f[1:-1, 2:, 1:-1], "eps_s": f[1:-1, :-2, 1:-1],
           "eps_b": f[2:, 1:-1, 1:-1], "eps_f": f[:-2, 1:-1, 1:-1]}
    out = {k: (a & fi).astype(np.float64) for k, a in eps.items()}
    idx2, idy2, idz2 = 1.0 / (dx * dx), 1.0 / (dy * dy), 1.0 / (dz * dz)
    denom = ((out["eps_e"] + out["eps_w"]) * idx2
             + (out["eps_n"] + out["eps_s"]) * idy2
             + (out["eps_b"] + out["eps_f"]) * idz2)
    with np.errstate(divide="ignore", invalid="ignore"):
        out["factor"] = np.where(denom > 0, m.omega / denom, 0.0) * fi
    out["p_mask"] = fi.astype(np.float64)
    return out


def deep_obstacle_masks_3d(coef: dict, comm: CartComm, s: int, kl: int,
                           jl: int, il: int, halo: int, dtype,
                           device="cpu") -> dict:
    """Shard s's slices of the interior coefficient fields
    (interior_coefficients_3d) for the deep-halo CA layout (JAX
    deep_obstacle_masks_3d(over_*)): each global field padded with
    halo-1 zeros per side, and on the HI sides by the ceil-division
    overhang, cut at the shard's offsets to (kl+2H-2, jl+2H-2, il+2H-2),
    the interior of the shard's deep block, and cast to dtype. Every shard
    that sees a cell holds its values, so redundant halo updates agree
    bitwise."""
    offs = comm.offsets(s, (kl, jl, il))
    size = (kl + 2 * halo - 2, jl + 2 * halo - 2, il + 2 * halo - 2)
    return {k: torch.from_numpy(_cut(coef[k], offs, size, halo - 1)).to(
        device=device, dtype=dtype) for k in _COEF}


def _obstacle_half_3d(p, rhs, colour, om, idx2, idy2, idz2):
    """One eps-coefficient half-sweep on an extended block, in place on p,
    op for op the JAX package's _obstacle_half_3d: the cells of the float
    `colour` mask (colour times p_mask) relax with the block's
    coefficient slices `om` (deep_obstacle_masks_3d). Returns r."""
    c = p[1:-1, 1:-1, 1:-1]
    lap = (
        om["eps_e"] * (p[1:-1, 1:-1, 2:] - c)
        + om["eps_w"] * (p[1:-1, 1:-1, :-2] - c)
    ) * idx2 + (
        om["eps_n"] * (p[1:-1, 2:, 1:-1] - c)
        + om["eps_s"] * (p[1:-1, :-2, 1:-1] - c)
    ) * idy2 + (
        om["eps_b"] * (p[2:, 1:-1, 1:-1] - c)
        + om["eps_f"] * (p[:-2, 1:-1, 1:-1] - c)
    ) * idz2
    r = (rhs[1:-1, 1:-1, 1:-1] - lap) * colour
    p[1:-1, 1:-1, 1:-1] += -om["factor"] * r
    return r


def ca_rb_iters_obstacle_3d(p, rhs, n: int, cm, om, idx2, idy2, idz2):
    """n full red-black iterations of the eps-coefficient stencil (odd
    pass, even pass, the six-face Neumann refresh) on one shard's
    deep-halo block after a depth-H exchange (the obstacle twin of
    parallel/stencil3d.ca_rb_iters_3d; JAX ca_rb_iters_obstacle_3d). cm is
    the block's stencil3d.ca_masks_3d set, om its deep_obstacle_masks_3d
    set. Returns the block and the owned sum of r² of the last
    iteration."""
    odd = cm["odd"][1:-1, 1:-1, 1:-1] * om["p_mask"]
    even = cm["even"][1:-1, 1:-1, 1:-1] * om["p_mask"]
    r_odd = r_evn = None
    for _ in range(n):
        r_odd = _obstacle_half_3d(p, rhs, odd, om, idx2, idy2, idz2)
        r_evn = _obstacle_half_3d(p, rhs, even, om, idx2, idy2, idz2)
        p = neumann_masked_3d(p, cm)
    return p, _owned_r2_3d(r_odd, r_evn, cm)


def make_dist_obstacle_solver_3d(comm: CartComm, imax, jmax, kmax, kl, jl,
                                 il, dx, dy, dz, eps, itermax,
                                 m: ObstacleMasks3D, dtype, n: int,
                                 record_key: str = "obstacle3d_dist",
                                 ragged: bool = False):
    """The distributed flag-masked pressure solve, communication-avoiding:
    one depth-H halo exchange buys n exact red-black iterations. The
    residual, normalised by the global fluid-cell count, is checked every
    n iterations.

    - On a mesh that divides the grid, kernel K16 runs them on every
      shard's deep block (ops/sor_obsdist3d.py; its plain version on CPU
      tensors), H = 2n. `n` is the caller's cadence
      (utils/dispatch.sor_cadence), clamped so that the deep strips come
      from owned cells (ca_clamp). Recorded "pallas caN", the JAX
      package's label.
    - On a mesh that does not divide the grid (`ragged`) the JAX package
      keeps its solve on its jnp path, and so does the port:
      ca_rb_iters_obstacle_3d in plain torch on the shards' deep blocks,
      H = ca_halo(n, True) = 2n + 1, with the coefficients of
      deep_obstacle_masks_3d. It needs ca_halo(1, True) <= every extent;
      `n` (the JAX package's `tpu_ca_inner`) is clamped by ca_clamp and
      then lowered until 2n + 1 fits. Recorded "jnp_ca caN ragged".
    - Shards below those extents take the exchange-per-half-sweep
      fallback, as the JAX package's do (one exchange more before the
      Neumann copy on a ragged mesh), with the same coefficients on the
      halo-1 blocks. Recorded "jnp_rb_fallback[ ragged]".

    Returns (solve, used_kernel), the JAX package's shape: solve(p, rhs)
    -> (p, res, it) on lists of halo-1 blocks (p exchanged on return: the
    projection reads it across shard edges); used_kernel says whether K16
    runs. solve.n, solve.geom, solve.flags and solve.offs give the
    cadence, the shards' geometry, deep flag blocks and offsets (for
    callers that time or check K16 at this solve's shapes; geom and
    flags are None without K16)."""
    check_eps_floor(eps, int(m.n_fluid), dtype,
                    f"sor_dist_obstacle3d {imax}x{jmax}x{kmax}")
    idx2, idy2, idz2 = 1.0 / (dx * dx), 1.0 / (dy * dy), 1.0 / (dz * dz)
    local = (kl, jl, il)
    offs = [comm.offsets(s, local) for s in range(comm.size)]
    supported = ca_supported(kl, jl, il) and (
        not ragged or ca_halo(1, True) <= min(local))
    n = ca_clamp(n, kl, jl, il) if supported else 1
    if supported and ragged:
        while n > 1 and ca_halo(n, True) > min(local):
            n -= 1
    H = ca_halo(n, ragged) if supported else 1
    kernel = supported and not ragged
    geom = flags = None

    if kernel:
        geom = ObsGeom3(kmax, jmax, imax, kl, jl, il, n)
        flags = [deep_flag_block_3d(m, comm, s, kl, jl, il, H, dev)
                 for s, dev in enumerate(comm.devices)]
        _dispatch.record(record_key, f"pallas ca{n}")

        def rounds_for(pd, rd):
            qd = [torch.empty_like(x) for x in pd]

            def rounds():
                # K16 reads pd and writes qd; the two swap in place, so pd
                # (the closure's and solve's) holds the newest blocks
                pc.halo_exchange(pd, comm, depth=H)
                res = [rb_sor_obsdist3d(x, f, fl, geom, o, m.omega, idx2,
                                        idy2, idz2, out=y)
                       for x, y, f, fl, o in zip(pd, qd, rd, flags, offs)]
                pd[:], qd[:] = list(qd), list(pd)
                return res, n
            return rounds
    else:
        _dispatch.record(record_key, (f"jnp_ca ca{n}" if supported
                                      else "jnp_rb_fallback")
                         + (" ragged" if ragged else ""))
        coef = interior_coefficients_3d(m, dx, dy, dz)
        cms = [ca_masks_3d(kl, jl, il, H, kmax, jmax, imax, dtype, *o,
                           device=dev)
               for o, dev in zip(offs, comm.devices)]
        oms = [deep_obstacle_masks_3d(coef, comm, s, kl, jl, il, H, dtype,
                                      dev)
               for s, dev in enumerate(comm.devices)]
        del coef

        def rounds_for(pd, rd):
            def rounds():
                if supported:
                    pc.halo_exchange(pd, comm, depth=H)
                    r2 = []
                    for s, (cm, om) in enumerate(zip(cms, oms)):
                        pd[s], r = ca_rb_iters_obstacle_3d(
                            pd[s], rd[s], n, cm, om, idx2, idy2, idz2)
                        r2.append(r)
                    return r2, n
                r_half = []
                for colour in ("odd", "even"):
                    pc.halo_exchange(pd, comm)
                    r_half.append([_obstacle_half_3d(
                        x, f, cm[colour][1:-1, 1:-1, 1:-1] * om["p_mask"],
                        om, idx2, idy2, idz2)
                        for x, f, cm, om in zip(pd, rd, cms, oms)])
                if ragged:
                    # the wall-ghost plane can open a dead shard whose
                    # Neumann source lives on a neighbour (ca_halo)
                    pc.halo_exchange(pd, comm)
                pd[:] = [neumann_masked_3d(x, cm) for x, cm in zip(pd, cms)]
                return [_owned_r2_3d(a, b, cm)
                        for a, b, cm in zip(*r_half, cms)], 1
            return rounds

    def solve(p, rhs):
        pd = [embed_deep(x, H) for x in p]
        rd = pc.halo_exchange([embed_deep(x, H) for x in rhs], comm, depth=H)
        res, it = mesh_convergence_loop(rounds_for(pd, rd), comm, dtype,
                                        m.n_fluid, eps, itermax)
        p = [strip_deep(x, H).contiguous() for x in pd]
        return pc.halo_exchange(p, comm), res, it

    solve.n, solve.geom, solve.flags, solve.offs = n, geom, flags, offs
    return solve, kernel
