"""2-D distributed-stencil helpers in plain PyTorch (counterpart of
pampi_tpu/parallel/stencil2d.py): wall-gated Neumann ghost copies, global
(i+j)-parity colouring, and the communication-avoiding (CA) red-black
iterations on the natural grid.

One depth-2n halo exchange buys n exact red-black iterations computed on a
deep-halo extended block: each iteration consumes two layers of ghost
validity, and ghost cells are recomputed by both neighbouring shards with
the same arithmetic, so the distributed trajectory equals the sequential
red-black solver's (the reference pays one exchange per half-sweep,
assignment-5/ex5-nazifkar/src/solver.c:609). Extent-1 shards, which cannot
ship a depth-2 strip, take the exchange-per-half-sweep fallback
(`rb_exchange_per_sweep`). This path serves `tpu_sor_layout checkerboard`,
ragged meshes and odd shard extents; the quarter-layout path of
parallel/quarters_dist.py serves the rest. Under the overlapped schedule
(`tpu_overlap`) the solve takes the split form `rb_split_iter` instead:
an exchange per half-sweep, posted beside the interior update.

Every update has the arithmetic of ops/sor.sor_pass (sliced laplacian,
float mask multiply) in the JAX package's association. The per-shard
functions update their block in place; the collective ones take the list
of blocks.
"""

from __future__ import annotations

import torch

from .comm import CartComm, halo_exchange, ready_events


def ca_masks(jl: int, il: int, halo: int, jmax: int, imax: int, dtype,
             joff: int, ioff: int, device="cpu"):
    """Masks on the (jl+2·halo, il+2·halo) extended block of the shard at
    global offsets (joff, ioff): local cell (a, b) is global extended index
    (joff + a - halo + 1, ioff + b - halo + 1), the owned interior starts at
    local index `halo`. Returns the red/black update masks (global interior
    and parity, in `dtype`, multiplied in), the wall-ghost refresh masks
    per side (tangentially clipped to the global interior), and the owned
    cells (residual accounting)."""
    H = halo
    la = torch.arange(jl + 2 * H, device=device)[:, None]
    lb = torch.arange(il + 2 * H, device=device)[None, :]
    gj = la - (H - 1) + joff
    gi = lb - (H - 1) + ioff
    interior = (gj >= 1) & (gj <= jmax) & (gi >= 1) & (gi <= imax)
    par = (gi + gj) % 2
    owned = (la >= H) & (la < H + jl) & (lb >= H) & (lb < H + il)
    tan_j = (gj >= 1) & (gj <= jmax)
    tan_i = (gi >= 1) & (gi <= imax)
    return {
        "red": (interior & (par == 0)).to(dtype),
        "black": (interior & (par == 1)).to(dtype),
        "owned": owned,
        "wall_jlo": (gj == 0) & tan_i,
        "wall_jhi": (gj == jmax + 1) & tan_i,
        "wall_ilo": (gi == 0) & tan_j,
        "wall_ihi": (gi == imax + 1) & tan_j,
    }


def ca_half_sweep(p, rhs, mask_interior, factor, idx2, idy2):
    """One masked half-sweep on an extended block, in place on p, with
    the arithmetic of ops/sor.sor_pass. `mask_interior` is the [1:-1, 1:-1]
    slice of a red/black mask. Returns (p, r)."""
    x = p
    lap = (x[1:-1, 2:] - 2.0 * x[1:-1, 1:-1] + x[1:-1, :-2]) * idx2 + (
        x[2:, 1:-1] - 2.0 * x[1:-1, 1:-1] + x[:-2, 1:-1]
    ) * idy2
    r = (rhs[1:-1, 1:-1] - lap) * mask_interior
    p[1:-1, 1:-1] += -factor * r
    return p, r


def neumann_masked(p, masks):
    """Homogeneous-Neumann wall-ghost refresh through the wall masks
    (global-coordinate gated, tangentially clipped, corners untouched).
    Returns a new block."""
    p = torch.where(masks["wall_jlo"], torch.roll(p, -1, 0), p)
    p = torch.where(masks["wall_jhi"], torch.roll(p, 1, 0), p)
    p = torch.where(masks["wall_ilo"], torch.roll(p, -1, 1), p)
    p = torch.where(masks["wall_ihi"], torch.roll(p, 1, 1), p)
    return p


def _owned_r2(r_red, r_blk, masks):
    """Sum of r² over owned cells only (ghost cells are the neighbours'
    cells, recomputed here)."""
    r2 = r_red * r_red + r_blk * r_blk
    return torch.sum(torch.where(masks["owned"][1:-1, 1:-1], r2,
                                 torch.zeros_like(r2)))


def ca_rb_iters(p, rhs, n: int, masks, factor, idx2, idy2):
    """n red-black iterations (each with the Neumann wall refresh) on one
    shard's deep-halo block, after a depth-ca_halo(n) exchange. Returns the
    block and the owned sum of r² of the last iteration."""
    red = masks["red"][1:-1, 1:-1]
    black = masks["black"][1:-1, 1:-1]
    r_red = r_blk = None
    for _ in range(n):
        p, r_red = ca_half_sweep(p, rhs, red, factor, idx2, idy2)
        p, r_blk = ca_half_sweep(p, rhs, black, factor, idx2, idy2)
        p = neumann_masked(p, masks)
    return p, _owned_r2(r_red, r_blk, masks)


def scalar_half(masks, factor, idx2, idy2):
    """The all-fluid half-sweep for rb_exchange_per_sweep: ca_half_sweep
    with the scalar factor on shard s's colour mask."""
    def half(s, colour, p, f):
        return ca_half_sweep(p, f, masks[s][colour][1:-1, 1:-1], factor,
                             idx2, idy2)[1]
    return half


def rb_exchange_per_sweep(blocks, rhs, masks, comm: CartComm, half,
                          ragged: bool = False):
    """The extent-1 fallback over every shard: one red-black iteration with
    an exchange before each half-sweep, on halo-1 blocks. `half(s, colour,
    p, f)` relaxes colour ("red" or "black") of shard s's block p in place
    and returns its r (scalar_half, or the obstacle solve's flag-masked
    half-sweep). Ragged layouts exchange once more before the wall copy (a
    wall-ghost row can open a dead shard whose Neumann source is a
    neighbour's row). Returns the blocks and the per-shard owned sums of
    r²."""
    halo_exchange(blocks, comm)
    r_red = [half(s, "red", p, f) for s, (p, f) in enumerate(zip(blocks, rhs))]
    halo_exchange(blocks, comm)
    r_blk = [half(s, "black", p, f)
             for s, (p, f) in enumerate(zip(blocks, rhs))]
    if ragged:
        halo_exchange(blocks, comm)
    blocks = [neumann_masked(p, m) for p, m in zip(blocks, masks)]
    return blocks, [_owned_r2(a, b, m) for a, b, m in zip(r_red, r_blk, masks)]


def split_half(blocks, rhs, sched, int_masks, update):
    """One half-sweep of every shard split interior/boundary (the solve's
    twin of the overlapped PRE split): the depth-1 exchange is posted on
    copies of the blocks, the interior update runs in place on the
    unexchanged blocks meanwhile, the boundary update on the exchanged
    copies after it; the interior mask (rim 2: cells whose stencil never
    reads the ghost ring) merges the two. `update(s, p, f)` relaxes shard
    s's block p in place and returns its r (of the block's [1:-1, ...]
    slice). Returns the merged blocks and r. On the card the interior
    update is issued before the exchange's copies, which wait only for
    the clones (events recorded after them, ready_events), so that the
    two run side by side."""
    copies = [b.clone() for b in blocks]
    ready = ready_events(sched.comm)
    r_int = [update(s, p, f) for s, (p, f) in enumerate(zip(blocks, rhs))]
    (ex,) = sched.post([copies], ready=ready).wait()
    r_bnd = [update(s, p, f) for s, (p, f) in enumerate(zip(ex, rhs))]
    inner = (slice(1, -1),) * blocks[0].dim()
    return ([torch.where(m, a, b) for m, a, b in zip(int_masks, blocks, ex)],
            [torch.where(m[inner], a, b)
             for m, a, b in zip(int_masks, r_int, r_bnd)])


def split_refresh(blocks, sched, int_masks, refresh):
    """The ragged layouts' pre-Neumann exchange, split as split_half:
    `refresh(s, p)` (the wall-ghost copy, a new block) on the unexchanged
    and on the exchanged blocks, merged by the interior mask."""
    (ex,) = sched.post([[b.clone() for b in blocks]]).wait()
    return [torch.where(m, refresh(s, a), refresh(s, b))
            for s, (m, a, b) in enumerate(zip(int_masks, blocks, ex))]


def rb_split_iter(blocks, rhs, masks, sched, int_masks, factor, idx2, idy2,
                  ragged: bool = False):
    """One red-black iteration of every shard with each half-sweep split
    interior/boundary (the JAX package's rb_split_iter; split_half), on
    halo-1 blocks. `sched` is the persistent depth-1 ExchangeSchedule
    (parallel/comm.persistent_exchange), `int_masks` each shard's rim-2
    interior mask (parallel/overlap.interior_mask(local, 2,
    partitioned)). The values are bitwise the exchange-per-half-sweep
    form's (rb_exchange_per_sweep), itself bitwise the CA form's: interior
    cells compute the same values from either block, boundary cells read
    the exchanged one. Ragged layouts split the extra pre-Neumann refresh
    the same way. Returns the blocks and the per-shard owned sums of
    r²."""
    def half(colour):
        def update(s, p, f):
            return ca_half_sweep(p, f, masks[s][colour][1:-1, 1:-1], factor,
                                 idx2, idy2)[1]
        return update

    blocks, r_red = split_half(blocks, rhs, sched, int_masks, half("red"))
    blocks, r_blk = split_half(blocks, rhs, sched, int_masks, half("black"))
    if ragged:
        blocks = split_refresh(blocks, sched, int_masks,
                               lambda s, p: neumann_masked(p, masks[s]))
    else:
        blocks = [neumann_masked(p, m) for p, m in zip(blocks, masks)]
    return blocks, [_owned_r2(a, b, m) for a, b, m in zip(r_red, r_blk, masks)]


def ca_halo(n: int, ragged: bool = False) -> int:
    """Halo depth consumed by n red-black iterations: 2n, and one more on
    ragged meshes (a wall-ghost row can open a dead shard, whose Neumann
    refresh reads the innermost halo cell)."""
    return 2 * n + (1 if ragged else 0)


def ca_supported(*local_extents) -> bool:
    """Whether every shard owns the depth-2 strips it ships (extent >= 2);
    below that the solvers use rb_exchange_per_sweep."""
    return min(local_extents) >= 2


def ca_clamp(n: int, *local_extents) -> int:
    """Clamp a CA block size so that the 2n-deep strips come from owned
    cells (2n <= the least local extent)."""
    cap = min(local_extents) // 2
    return max(1, min(n, cap))


def ca_inner(param, *local_extents) -> int:
    """The effective CA block size: `tpu_ca_inner` through ca_clamp."""
    return ca_clamp(param.tpu_ca_inner, *local_extents)


def ceil_overhang(nper: int, local: int, gmax: int) -> int:
    """Trailing dead cells of a ceil-divided axis (0 when divisible)."""
    return max(0, nper * local - gmax)


def deep_pad_widths(halo: int, local: int, nper: int, gmax: int):
    """(lo, hi) pad widths that turn a global (gmax+2)-extent constant
    into one from which every shard's (local + 2·halo)-extent deep block
    is a plain slice at the shard's offset: halo-1 on the low side, and on
    the high side halo-1 plus the ragged ceil-division overhang (without
    it the trailing shards' slices would run past the array)."""
    return (halo - 1, halo - 1 + ceil_overhang(nper, local, gmax))


def embed_deep(x, halo: int):
    """Grow a 1-ghost-layer extended block into the deep-halo layout (any
    rank): along each axis of owned extent L, the old ghost layers land at
    local indices H-1 and H+L (wall ghosts keep their values); the new
    outer layers are zero until the first deep exchange fills them.
    Returns a new contiguous block."""
    return torch.nn.functional.pad(x, (halo - 1,) * (2 * x.dim()))


def strip_deep(x, halo: int):
    """Inverse of embed_deep: the 1-ghost-layer extended block, as a view."""
    return x[tuple(slice(halo - 1, d - (halo - 1)) for d in x.shape)]
