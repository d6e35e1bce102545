"""The NS-3D wall handling of a 3-D mesh by global index (counterpart of
pampi_tpu/parallel/ragged3d.py): the six-face boundary conditions, the
special BC, the F/G/H wall fixups and the live mask, as selects on global
coordinates.

On a ("k", "j", "i") mesh the grid does not divide, blocks are
ceil-divided and the trailing cells are dead (pad-with-mask), so the HI
walls (g == gmax, the ghost plane g == gmax+1) can sit anywhere inside a
trailing shard, or open a fully dead one. The reference's plane writes
become `where(mask, g(roll(x)), x)`: the roll reads the +-1 neighbour in
the shard's block, which holds fresh values after the halo exchange the
callers run first, and wraps on the block as the JAX package's roll does.

The arithmetic and the face order are ops/ns3d.py's gated forms (the plain
versions of the distributed K7), which compute the JAX ragged forms' values
op for op; this module gives them the shard's global index grids. The same
forms serve a divisible mesh, where every wall is an array edge of a wall
shard: models/ns3d_dist.py's phase chain uses them on every mesh.
Functions take one shard, s, of the mesh (the port's controller loops over
the shards) and return new tensors. The offset-0 class forms at the end
serve the fleet's 3-D shape-class lanes.
"""

from __future__ import annotations

import torch

from ..ops import ns3d as ops
from .comm import CartComm


def global_index_grids(comm: CartComm, s: int, kl: int, jl: int, il: int,
                       device="cpu"):
    """Broadcastable (gk, gj, gi) of shard s's (kl+2, jl+2, il+2) block:
    block index a is global extended index offset + a."""
    return ops.index_grids((kl + 2, jl + 2, il + 2), 0,
                           comm.offsets(s, (kl, jl, il)), device)


def interior_and_live(comm: CartComm, s: int, kl: int, jl: int, il: int,
                      kmax: int, jmax: int, imax: int, dtype, device="cpu"):
    """(the global-interior bool mask, live_masks_3d) of shard s's block:
    the ragged projection's two gates."""
    gk, gj, gi = global_index_grids(comm, s, kl, jl, il, device)
    in_k, in_j, in_i = ops._interior(gk, gj, gi, (kmax, jmax, imax))
    return in_k & in_j & in_i, _live(gk, gj, gi, kmax, jmax, imax, dtype)


def _live(gk, gj, gi, kmax, jmax, imax, dtype):
    return ((gk <= kmax + 1) & (gj <= jmax + 1) & (gi <= imax + 1)).to(dtype)


def live_masks_3d(comm: CartComm, s: int, kl: int, jl: int, il: int,
                  kmax: int, jmax: int, imax: int, dtype, device="cpu"):
    """The multiply mask that zeroes the dead cells (beyond the global
    ghost ring) of shard s's block."""
    return _live(*global_index_grids(comm, s, kl, jl, il, device), kmax,
                 jmax, imax, dtype)


def set_bcs_3d_ragged(u, v, w, bcs: dict, comm: CartComm, s: int, kl: int,
                      jl: int, il: int, kmax: int, jmax: int, imax: int):
    """set_boundary_conditions_3d as global-index selects, in the
    reference's face order (`bcs`: face -> kind, top, bottom, left, right,
    front, back); wall normals at g == gmax on HI faces, tangential ghosts
    at g == gmax+1, both at 0 on LO faces (ops/ns3d.
    apply_wall_bcs_3d_gated)."""
    g = global_index_grids(comm, s, kl, jl, il, u.device)
    return ops.apply_wall_bcs_3d_gated(u, v, w, *g, bcs, (kmax, jmax, imax))


def set_special_bc_3d_ragged(u, problem: str, comm: CartComm, s: int,
                             kl: int, jl: int, il: int, kmax: int, jmax: int,
                             imax: int):
    """setSpecialBoundaryCondition by global index: the dcavity lid (which
    skips the last interior i and k, the reference's loop-bound quirk) or
    the canal inflow (ops/ns3d.apply_special_bc_3d_gated)."""
    g = global_index_grids(comm, s, kl, jl, il, u.device)
    return ops.apply_special_bc_3d_gated(u, *g, problem, (kmax, jmax, imax))


def fgh_fixups_ragged(f, g, h, u, v, w, comm: CartComm, s: int, kl: int,
                      jl: int, il: int, kmax: int, jmax: int, imax: int):
    """The F/G/H wall fixups by global index: same-position copies from
    u/v/w on both walls of each axis, tangentially clipped
    (ops/ns3d.fgh_fixups_gated)."""
    grids = global_index_grids(comm, s, kl, jl, il, u.device)
    return ops.fgh_fixups_gated(f, g, h, u, v, w, *grids, (kmax, jmax, imax))


# ----------------------------------------------------------------------
# Offset-0 forms over lane-stacked class blocks (the fleet's 3-D shape-
# class chunk, fleet/shapeclass.py): one (kc+2, jc+2, ic+2) block per lane
# on a leading axis, each lane's grid extents as (N, 1, 1, 1) tensors. The
# JAX package reaches the same arithmetic through the functions above with
# `grids=` given.
# ----------------------------------------------------------------------


def class_index_grids_3d(kc: int, jc: int, ic: int, device="cpu"):
    """(gk, gj, gi) of a class block: the global extended index is the
    block index (offset 0)."""
    return ops.index_grids((kc + 2, jc + 2, ic + 2), 0, (0, 0, 0), device)


def class_masks_3d(grids, kmax, jmax, imax):
    """(each lane's interior, each lane's live corner) as bool masks of the
    lane-stacked blocks."""
    gk, gj, gi = grids
    in_k, in_j, in_i = ops._interior(gk, gj, gi, (kmax, jmax, imax))
    return (in_k & in_j & in_i,
            (gk <= kmax + 1) & (gj <= jmax + 1) & (gi <= imax + 1))


def set_bcs_class_3d(u, v, w, bcs: dict, grids, kmax, jmax, imax):
    """set_boundary_conditions_3d on lane-stacked class blocks, in the
    reference's face order (ops/ns3d.apply_wall_bcs_3d_gated)."""
    return ops.apply_wall_bcs_3d_gated(u, v, w, *grids, bcs,
                                       (kmax, jmax, imax))


def set_special_bc_class_3d(u, problem: str, grids, kmax, jmax, imax):
    """The dcavity lid (skipping the last interior i and k) or the canal
    inflow on lane-stacked class blocks."""
    return ops.apply_special_bc_3d_gated(u, *grids, problem,
                                         (kmax, jmax, imax))


def fgh_fixups_class_3d(f, g, h, u, v, w, grids, kmax, jmax, imax):
    """The F/G/H wall fixups on lane-stacked class blocks."""
    return ops.fgh_fixups_gated(f, g, h, u, v, w, *grids,
                                (kmax, jmax, imax))


def class_pre_3d(u, v, w, dt, cfg, grids, ext, cell):
    """The class chain's phases before the solve, on every lane (the JAX
    package's _class_step_3d, which K7's class mode computes): the wall and
    special BCs, F/G/H on each lane's interior with the wall fixups, the
    rhs on the interior. `cfg` holds the static knobs (ops/ns3d_fused.
    StepConfig3D: bcs, problem, re, gx, gy, gz, gamma); ext (kmax, jmax,
    imax) and cell (dx, dy, dz, in the fields' dtype) are (N, 1, 1, 1)
    tensors, dt too. Returns (u', v', w', F, G, H, rhs), new tensors."""
    kmax, jmax, imax = ext
    dx, dy, dz = cell
    u1, v1, w1 = set_bcs_class_3d(u, v, w, cfg.bcs, grids, kmax, jmax, imax)
    u1 = set_special_bc_class_3d(u1, cfg.problem, grids, kmax, jmax, imax)
    interior, _live = class_masks_3d(grids, kmax, jmax, imax)
    zero = ops._const(0.0, u)
    f, g, h = (torch.where(interior, a, zero)
               for a in ops.compute_fgh_interior(
                   u1, v1, w1, dt, cfg.re, cfg.gx, cfg.gy, cfg.gz, cfg.gamma,
                   dx, dy, dz))
    f, g, h = fgh_fixups_class_3d(f, g, h, u1, v1, w1, grids, kmax, jmax,
                                  imax)
    rhs = torch.where(interior, ops.compute_rhs(f, g, h, dt, dx, dy, dz),
                      zero)
    return u1, v1, w1, f, g, h, rhs


def class_post_3d(u, v, w, f, g, h, p, dt, grids, ext, cell):
    """The projection on each lane's interior, then the live-mask multiply
    (dead cells to 0, -0 where the value was negative), as class_pre_3d's
    arguments. Returns (u'', v'', w''), new tensors."""
    interior, live = class_masks_3d(grids, *ext)
    lm = live.to(u.dtype)
    out = []
    for a, new in zip((u, v, w), ops.adapt_terms_3d(f, g, h, p, dt, *cell)):
        full = a.clone()
        full[..., 1:-1, 1:-1, 1:-1] = new
        out.append(torch.where(interior, full, a) * lm)
    return tuple(out)
