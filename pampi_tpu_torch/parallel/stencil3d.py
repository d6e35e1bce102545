"""3-D distributed-stencil helpers in plain PyTorch (counterpart of
pampi_tpu/parallel/stencil3d.py; the reference's commIsBoundary-gated face
loops of assignment-6): the grid-space communication-avoiding (CA)
red-black iterations of stencil2d.py one dimension up.

One depth-2n halo exchange buys n exact red-black iterations on a
deep-halo extended block (stencil2d.py gives the argument). Shards with
an extent of 1 take the exchange-per-half-sweep fallback
(`rb_exchange_per_sweep_3d`). This path serves `tpu_sor_layout
checkerboard`, odd shard extents and the octant layout's refusals; the
octant path of parallel/octants_dist.py serves the rest.

Every update has the arithmetic of ops/sor3d.sor_pass_3d (sliced
laplacian, float mask multiply) in the JAX package's association. The
per-shard functions update their block in place; the collective one takes
the list of blocks.
"""

from __future__ import annotations

import torch

from .comm import CartComm, halo_exchange
from .stencil2d import split_half, split_refresh


def ca_masks_3d(kl: int, jl: int, il: int, halo: int, kmax: int, jmax: int,
                imax: int, dtype, koff: int, joff: int, ioff: int,
                device="cpu"):
    """Masks on the (kl+2H, jl+2H, il+2H) extended block of the shard at
    global offsets (koff, joff, ioff): local cell a is global extended
    index a - (H - 1) + offset, the owned interior starts at local index H.
    'odd'/'even' follow the reference's pass order (pass 0 is (i+j+k)
    parity 1) and are float masks in `dtype` (the update is then op for op
    sor_pass_3d's); the wall masks are tangentially clipped to the global
    interior; 'owned' marks the shard's own cells (residual accounting).
    halo=1 is the classic one-ghost-layer layout of the fallback."""
    H = halo

    def axis(n, off, shape):
        a = torch.arange(n + 2 * H, device=device).reshape(shape)
        return a, a - (H - 1) + off

    lk, gk = axis(kl, koff, (-1, 1, 1))
    lj, gj = axis(jl, joff, (1, -1, 1))
    li, gi = axis(il, ioff, (1, 1, -1))
    in_k = (gk >= 1) & (gk <= kmax)
    in_j = (gj >= 1) & (gj <= jmax)
    in_i = (gi >= 1) & (gi <= imax)
    interior = in_k & in_j & in_i
    par = (gi + gj + gk) % 2
    owned = ((lk >= H) & (lk < H + kl) & (lj >= H) & (lj < H + jl)
             & (li >= H) & (li < H + il))
    return {
        "odd": (interior & (par == 1)).to(dtype),
        "even": (interior & (par == 0)).to(dtype),
        "owned": owned,
        "wall_klo": (gk == 0) & in_j & in_i,
        "wall_khi": (gk == kmax + 1) & in_j & in_i,
        "wall_jlo": (gj == 0) & in_k & in_i,
        "wall_jhi": (gj == jmax + 1) & in_k & in_i,
        "wall_ilo": (gi == 0) & in_k & in_j,
        "wall_ihi": (gi == imax + 1) & in_k & in_j,
    }


def ca_half_sweep_3d(p, rhs, mask_interior, factor, idx2, idy2, idz2):
    """One masked half-sweep on an extended block, in place on p, with the
    arithmetic of ops/sor3d.sor_pass_3d. `mask_interior` is the
    [1:-1, 1:-1, 1:-1] slice of an odd/even mask. Returns (p, r)."""
    x = p
    c = x[1:-1, 1:-1, 1:-1]
    lap = (
        (x[1:-1, 1:-1, 2:] - 2.0 * c + x[1:-1, 1:-1, :-2]) * idx2
        + (x[1:-1, 2:, 1:-1] - 2.0 * c + x[1:-1, :-2, 1:-1]) * idy2
        + (x[2:, 1:-1, 1:-1] - 2.0 * c + x[:-2, 1:-1, 1:-1]) * idz2
    )
    r = (rhs[1:-1, 1:-1, 1:-1] - lap) * mask_interior
    p[1:-1, 1:-1, 1:-1] += -factor * r
    return p, r


def neumann_masked_3d(p, masks):
    """The 6-face homogeneous-Neumann wall-ghost refresh through the wall
    masks (global-coordinate gated, tangentially clipped). Returns a new
    block."""
    for key, shift, dim in (("wall_klo", -1, 0), ("wall_khi", 1, 0),
                            ("wall_jlo", -1, 1), ("wall_jhi", 1, 1),
                            ("wall_ilo", -1, 2), ("wall_ihi", 1, 2)):
        p = torch.where(masks[key], torch.roll(p, shift, dim), p)
    return p


def _owned_r2_3d(r_odd, r_evn, masks):
    """Sum of r² over the owned cells only."""
    r2 = r_odd * r_odd + r_evn * r_evn
    return torch.sum(torch.where(masks["owned"][1:-1, 1:-1, 1:-1], r2,
                                 torch.zeros_like(r2)))


def ca_rb_iters_3d(p, rhs, n: int, masks, factor, idx2, idy2, idz2):
    """n full red-black iterations (odd pass, even pass, 6-face Neumann
    refresh: the sequential loop order) on one shard's deep-halo block,
    after a depth-ca_halo(n) exchange (2n, and 2n + 1 on a ragged mesh: the
wall-ghost plane can open a dead shard). Returns the block and the owned sum
    of r² of the last iteration."""
    odd = masks["odd"][1:-1, 1:-1, 1:-1]
    even = masks["even"][1:-1, 1:-1, 1:-1]
    r_odd = r_evn = None
    for _ in range(n):
        p, r_odd = ca_half_sweep_3d(p, rhs, odd, factor, idx2, idy2, idz2)
        p, r_evn = ca_half_sweep_3d(p, rhs, even, factor, idx2, idy2, idz2)
        p = neumann_masked_3d(p, masks)
    return p, _owned_r2_3d(r_odd, r_evn, masks)


def rb_exchange_per_sweep_3d(blocks, rhs, masks, comm: CartComm, factor,
                             idx2, idy2, idz2, ragged: bool = False):
    """The extent-1 fallback over every shard: one red-black iteration
    with an exchange before each half-sweep, on halo-1 blocks. Ragged
    layouts exchange once more before the Neumann copy (the wall-ghost
    plane can open a dead shard whose Neumann source is a neighbour's
    plane). Returns the blocks and the per-shard owned sums of r²."""
    coef = (factor, idx2, idy2, idz2)
    halo_exchange(blocks, comm)
    r_odd = [ca_half_sweep_3d(p, f, m["odd"][1:-1, 1:-1, 1:-1], *coef)[1]
             for p, f, m in zip(blocks, rhs, masks)]
    halo_exchange(blocks, comm)
    r_evn = [ca_half_sweep_3d(p, f, m["even"][1:-1, 1:-1, 1:-1], *coef)[1]
             for p, f, m in zip(blocks, rhs, masks)]
    if ragged:
        halo_exchange(blocks, comm)
    blocks = [neumann_masked_3d(p, m) for p, m in zip(blocks, masks)]
    return blocks, [_owned_r2_3d(a, b, m)
                    for a, b, m in zip(r_odd, r_evn, masks)]


def rb_split_iter_3d(blocks, rhs, masks, sched, int_masks, factor, idx2,
                     idy2, idz2, ragged: bool = False):
    """One red-black iteration of every shard with each half-sweep split
    interior/boundary (the JAX package's rb_split_iter_3d; stencil2d.
    split_half), on halo-1 blocks: bitwise the exchange-per-half-sweep
    form. `sched` is the persistent depth-1 ExchangeSchedule,
    `int_masks` each shard's rim-2 interior mask. Returns the blocks and
    the per-shard owned sums of r²."""
    coef = (factor, idx2, idy2, idz2)

    def half(parity):
        def update(s, p, f):
            return ca_half_sweep_3d(p, f, masks[s][parity][1:-1, 1:-1, 1:-1],
                                    *coef)[1]
        return update

    blocks, r_odd = split_half(blocks, rhs, sched, int_masks, half("odd"))
    blocks, r_evn = split_half(blocks, rhs, sched, int_masks, half("even"))
    if ragged:
        blocks = split_refresh(blocks, sched, int_masks,
                               lambda s, p: neumann_masked_3d(p, masks[s]))
    else:
        blocks = [neumann_masked_3d(p, m) for p, m in zip(blocks, masks)]
    return blocks, [_owned_r2_3d(a, b, m)
                    for a, b, m in zip(r_odd, r_evn, masks)]
