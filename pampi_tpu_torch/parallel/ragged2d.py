"""The NS-2D wall handling of a 2-D mesh by global index (counterpart of
pampi_tpu/parallel/ragged2d.py): boundary conditions, special BC, F/G
fixups, the live mask and the normalizePressure weight, as selects on
global coordinates.

On a mesh the grid does not divide, blocks are ceil-divided and the
trailing cells are dead (pad-with-mask), so the high walls (gi == imax,
the ghost column gi == imax+1, and their j twins) can sit anywhere inside
a trailing shard, or open a fully dead one. The reference's strip writes
`x[wall] = g(x[src])` become `where(mask_wall, g(roll(x)), x)`: the roll
reads the +-1 neighbour in the shard's block, which holds fresh values
after the halo exchange that the callers run first. The same forms serve a
divisible mesh, where every wall is an array edge of a wall shard: the
extra cells they write are interface ghosts, which the next exchange
overwrites. models/ns2d_dist.py uses them on every mesh.

The arithmetic is ops/ns2d.py's (NOSLIP mirror, SLIP copy, OUTFLOW copy
from the interior, PERIODIC a no-op), and the selects are its gated forms,
the plain versions of the distributed K3, so the fields track the
single-device trajectory. Functions take one shard, s, of the mesh (the
port's controller loops over the shards) and return new tensors.
"""

from __future__ import annotations

import torch

from ..ops import ns2d as ops
from .comm import CartComm


def global_index_vectors(comm: CartComm, s: int, jl: int, il: int,
                         device="cpu"):
    """(gj column vector, gi row vector) of shard s's (jl+2, il+2) block:
    block index a is global extended index offset + a."""
    joff, ioff = comm.offsets(s, (jl, il))
    gj = (torch.arange(jl + 2, device=device) + joff)[:, None]
    gi = (torch.arange(il + 2, device=device) + ioff)[None, :]
    return gj, gi


def live_masks(comm: CartComm, s: int, jl: int, il: int, jmax: int,
               imax: int, dtype, device="cpu"):
    """The multiply mask that zeroes the dead cells (beyond the global
    ghost ring) of shard s's block, so that their values never reach the
    ghost-inclusive maxElement of the CFL dt."""
    gj, gi = global_index_vectors(comm, s, jl, il, device)
    return ((gj <= jmax + 1) & (gi <= imax + 1)).to(dtype)


def set_bcs_ragged(u, v, param, comm: CartComm, s: int, jl: int, il: int,
                   jmax: int, imax: int):
    """setBoundaryConditions as global-index selects, in the reference's
    wall order (left, right, bottom, top): later walls read earlier walls'
    writes (ops/ns2d.apply_wall_bcs_gated)."""
    gj, gi = global_index_vectors(comm, s, jl, il, u.device)
    return ops.apply_wall_bcs_gated(
        u, v, gj, gi, (param.bcLeft, param.bcRight, param.bcBottom,
                       param.bcTop), (jmax, imax))


def set_special_bc_ragged(u, param, comm: CartComm, s: int, jl: int,
                          il: int, jmax: int, imax: int, dy):
    """setSpecialBoundaryCondition by global index: the dcavity lid (which
    skips i == imax, the reference's loop-bound quirk) or the canal
    inflow, its y from the global row index in float64
    (ops/ns2d.apply_special_bc_gated)."""
    gj, gi = global_index_vectors(comm, s, jl, il, u.device)
    return ops.apply_special_bc_gated(u, gj, gi, param.name, (jmax, imax),
                                      dy, param.ylength)


def fg_fixups_ragged(f, g, u, v, comm: CartComm, s: int, jl: int, il: int,
                     jmax: int, imax: int):
    """The F/G wall fixups by global index: F = U on the vertical walls,
    G = V on the horizontal ones, tangentially on the global interior."""
    gj, gi = global_index_vectors(comm, s, jl, il, u.device)
    return ops.fg_fixups_gated(f, g, u, v, gj, gi, (jmax, imax))


def wall_weight_ragged(comm: CartComm, s: int, jl: int, il: int, jmax: int,
                       imax: int, dtype, device="cpu"):
    """normalizePressure's weight: over the mesh's blocks every position
    of the global (jmax+2, imax+2) array counts exactly once. Block
    interiors count up to the global ghost ring (which a ragged axis
    stores in a block's interior); a block's edge ghost counts only where
    it is a global ghost the interiors do not already hold."""
    gj, gi = global_index_vectors(comm, s, jl, il, device)
    lj = torch.arange(jl + 2, device=device)[:, None]
    li = torch.arange(il + 2, device=device)[None, :]
    edge_j = [0] if jmax + 1 <= comm.axis_size("j") * jl else [0, jmax + 1]
    edge_i = [0] if imax + 1 <= comm.axis_size("i") * il else [0, imax + 1]

    def axis_own(loc, g, n, gmax, edges):
        owned = (loc >= 1) & (loc <= n) & (g <= gmax + 1)
        at_edge = (loc == 0) | (loc == n + 1)
        edge_ok = torch.zeros_like(owned)
        for e in edges:
            edge_ok = edge_ok | (g == e)
        return owned | (at_edge & edge_ok)

    return (axis_own(lj, gj, jl, jmax, edge_j)
            & axis_own(li, gi, il, imax, edge_i)).to(dtype)
