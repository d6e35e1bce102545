"""The interior/boundary split of the overlapped distributed NS step
(counterpart of pampi_tpu/parallel/overlap.py; `tpu_overlap`).

The overlapped step restructures the fused deep-halo step so that the
deep exchange for step N+1 is posted right after step N's POST (the
moment the new edge cells exist) and is consumed one step later by the
BOUNDARY half of PRE only. The INTERIOR half of PRE runs on the stale
re-embedded block, so nothing it reads waits on the exchange: on the card
the exchange's strip copies run on a second stream beside it
(parallel/comm.ExchangeSchedule.post).

Both halves are the same globally gated kernel (K3 or K7, ops/ns2d_fused,
ops/ns3d_fused) on the two blocks, merged by `merge_halves` with the
interior mask below. The cells of the interior region have a dependency
cone that never reaches the exchanged strips (the outer FUSE_DEEP_HALO
layers of the deep block), so the interior half's values there are those
of the serial step; the boundary half reads the exchanged block, which is
the block the serial step exchanges. So the merge gives the serial
trajectory bit for bit.

`region_plan` bands the two halves' grids over the leading axis (rows in
2-D, k-planes in 3-D; `tpu_overlap_restrict`): the interior half sweeps
the rows of the interior core only, the boundary half the OVERLAP_RIM
bands, or every row when a non-leading axis is partitioned (its column
strips live in every row). The band frame is the deep block's: row r of a
band is row r of the deep block, and a plan of `nblocks` blocks of
`block_rows` rows covers the deep block's rows.

The carried buffers wear a generation tag (the step they were exchanged
for); `generation_guard` poisons dt with NaN on a mismatch, so t goes NaN
and the drive loop stops (models/_driver.drive_chunks): a skewed double
buffer is detected, never consumed. GEN_SKEW forges the mismatch.
"""

from __future__ import annotations

import math

import torch

# Test hook: a nonzero offset forges a step that consumes a stale double
# buffer (the generation-skew mutation test). 0 in production.
GEN_SKEW = 0

# the FUSE_CHAIN footprint of the fused PRE (wall BC -> obstacle BC ->
# F/G -> rhs reads two cells out; the JAX package's FUSE_FOOTPRINT) plus
# the interface ghost: the rim of the overlap's interior mask
FUSE_FOOTPRINT = 2
OVERLAP_RIM = FUSE_FOOTPRINT + 1


def interior_slices(local_extents, rim: int, partitioned=None):
    """Per-axis slices [rim, l+2-rim) of the interior region on the
    (l+2)-extended block; empty when a shard is thinner than two rims
    (the split is then boundary-everywhere). `partitioned` (per-axis
    bools, default all True) drops the rim on an axis of mesh size 1,
    which exchanges nothing."""
    if partitioned is None:
        partitioned = (True,) * len(local_extents)
    return tuple(
        slice(rim if part else 0, ext + 2 - (rim if part else 0))
        for ext, part in zip(local_extents, partitioned))


def interior_mask(local_extents, rim: int, partitioned=None,
                  device="cpu"):
    """Boolean interior mask on the extended block (the merge gate of
    `merge_halves`)."""
    m = torch.zeros(tuple(e + 2 for e in local_extents), dtype=torch.bool,
                    device=device)
    m[interior_slices(local_extents, rim, partitioned)] = True
    return m


def merge_halves(mask, interior_vals, boundary_vals):
    """The interior cells from the stale-block call, the rest from the
    exchanged-block call: a `torch.where`, not a masked sum, so that -0.0
    and NaN payloads survive bit for bit."""
    return tuple(torch.where(mask, i, b)
                 for i, b in zip(interior_vals, boundary_vals))


def check_bands(grid_bands, block_rows: int, nblocks: int,
                label: str = "block_rows") -> None:
    """Refuse a band list that is not sorted and disjoint or that
    overhangs the nblocks·block_rows rows of the plan."""
    last_end = 0
    for s, n in grid_bands:
        if s < last_end or n < 1 or s + n * block_rows > \
                nblocks * block_rows:
            raise ValueError(
                f"grid_bands {grid_bands} do not tile the padded "
                f"layout ({label}={block_rows}, nblocks={nblocks}) "
                "disjointly")
        last_end = s + n * block_rows


def band_cover(lo: int, hi: int, block_rows: int, total_rows: int):
    """The (start_row, n_blocks) band of block_rows-row blocks that covers
    rows [lo, hi) inside [0, total_rows): the start moves down when the
    rounded-up cover would overhang."""
    n = -(-(hi - lo) // block_rows)
    start = max(0, min(lo, total_rows - n * block_rows))
    return (start, n)


def _merge_bands(bands, block_rows, total_rows):
    """Coalesce overlapping or adjacent bands, so that no row is swept
    twice, each inside [0, total_rows); a merged band is clamped again,
    which can overlap the previous one, hence the fixpoint loop (bands
    only move down and merge, so it ends)."""
    out = [b for b in bands if b[1] > 0]
    while True:
        merged = []
        for s, n in sorted(out):
            if merged and s <= merged[-1][0] + merged[-1][1] * block_rows:
                ps, pn = merged[-1]
                end = max(ps + pn * block_rows, s + n * block_rows)
                merged[-1] = (ps, -(-(end - ps) // block_rows))
            else:
                merged.append((s, n))
        clamped = [(max(0, min(s, total_rows - n * block_rows)), n)
                   for s, n in merged]
        if clamped == out:
            return tuple(clamped)
        out = clamped


def region_plan(local_extents, rim: int, ext_pad: int, block_rows: int,
                nblocks: int, width: int, partitioned):
    """The banded plan of the two PRE halves of one shard geometry over
    the leading axis, or None when the interior region is empty. A dict:

      int_bands / bnd_bands   ((start_row, n_blocks), ...) of the
                              interior / boundary half
      cells                   cells the two banded sweeps visit
                              (blocks x block_rows x width)
      cells_full              the two full sweeps' count
      win                     cells < cells_full (`auto`'s predicate)

    The interior band covers exactly the rows of the merge's interior
    region (interior_slices with the same `partitioned`), the boundary
    band the rim rows, or every row when a non-leading axis is
    partitioned."""
    L0 = local_extents[0]
    R = nblocks * block_rows
    lead = partitioned[0]
    cross = any(partitioned[1:])
    rim0 = rim if lead else 0
    int_lo = ext_pad + rim0
    int_hi = ext_pad + L0 + 2 - rim0
    if int_hi <= int_lo:
        return None
    int_bands = _merge_bands(
        [band_cover(int_lo, int_hi, block_rows, R)], block_rows, R)
    if cross:
        bnd = [band_cover(ext_pad, ext_pad + L0 + 2, block_rows, R)]
    elif lead:
        bnd = [band_cover(ext_pad, ext_pad + rim, block_rows, R),
               band_cover(ext_pad + L0 + 2 - rim, ext_pad + L0 + 2,
                          block_rows, R)]
    else:
        return None
    bnd_bands = _merge_bands(bnd, block_rows, R)
    blocks = sum(n for _, n in int_bands) + sum(n for _, n in bnd_bands)
    cells = blocks * block_rows * width
    cells_full = 2 * R * width
    return {
        "int_bands": int_bands,
        "bnd_bands": bnd_bands,
        "cells": cells,
        "cells_full": cells_full,
        "win": cells < cells_full,
    }


def band_ranges(bands, block_rows: int, deep_rows: int, ext_pad: int,
                max_bands: int) -> tuple:
    """The grid-band mode of the fused PRE (K3, K7): `bands`
    ((start_row, n_blocks), ...) of block_rows-row blocks in the deep
    block's frame (deep_rows rows; `pre_plan`) -> the (first, end) row
    ranges of the halo-1 block (deep row r is halo-1 row r - ext_pad),
    clipped to it. Refuses bands that overlap or overhang the deep
    block's ceil(deep_rows / block_rows) blocks (check_bands), more than
    max_bands, and bands that cover no row of the halo-1 block."""
    bands = tuple((int(s), int(n)) for s, n in bands)
    if not 1 <= len(bands) <= max_bands:
        raise ValueError(f"grid_bands takes 1..{max_bands} bands, got "
                         f"{len(bands)}")
    check_bands(bands, block_rows, -(-deep_rows // block_rows))
    rows = deep_rows - 2 * ext_pad
    out = []
    for s, n in bands:
        lo, hi = max(0, s - ext_pad), min(rows, s - ext_pad + n * block_rows)
        if hi > lo:
            out.append((lo, hi))
    if not out:
        raise ValueError(f"grid_bands {bands} cover no row of the halo-1 "
                         "block")
    return tuple(out)


def band_row_mask(ranges, rows: int, widen: int, device):
    """Bool (rows,): the rows of `ranges`, each range's start moved
    `widen` rows down (F/G/H are written one row below each band, where
    rhs reads them)."""
    m = torch.zeros(rows, dtype=torch.bool, device=device)
    for lo, hi in ranges:
        m[max(0, lo - widen):hi] = True
    return m


def band_plain(outputs, ranges, like):
    """The plain version of the grid-band mode: the full call's halo-1
    outputs (F, G[, H], rhs) with NaN on every row outside the bands (F,
    G, H keep the row below each band too), so that a merge that reads
    outside the bands shows."""
    rows = outputs[0].shape[0]
    shape = (rows,) + (1,) * (outputs[0].dim() - 1)
    nan = torch.full((), math.nan, dtype=like.dtype, device=like.device)
    fgh, rhs = (band_row_mask(ranges, rows, w, like.device).view(shape)
                for w in (1, 0))
    return tuple(torch.where(fgh, a, nan) for a in outputs[:-1]) + (
        torch.where(rhs, outputs[-1], nan),)


def pre_plan(local_extents, partitioned, ext_pad: int, block_rows: int):
    """region_plan at the port's PRE layout: the deep block's leading
    extent (l0 + 2 + 2·ext_pad) in blocks of block_rows rows (8 rows in
    2-D, one k-plane in 3-D, the rows a CTA of the band launch covers),
    each row as wide as the halo-1 block's row (the cells a band launch
    visits)."""
    rows = local_extents[0] + 2 + 2 * ext_pad
    width = math.prod(e + 2 for e in local_extents[1:])
    return region_plan(local_extents, OVERLAP_RIM, ext_pad, block_rows,
                       -(-rows // block_rows), width, partitioned)


def generation_guard(dt, gen: int, nt: int):
    """dt when the carried buffers were exchanged for this step (gen ==
    nt, GEN_SKEW 0), else NaN in dt's dtype, on dt's device."""
    if gen + GEN_SKEW == nt:
        return dt
    return torch.full_like(dt, math.nan)
