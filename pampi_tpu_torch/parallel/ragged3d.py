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
the shards) and return new tensors.
"""

from __future__ import annotations

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
