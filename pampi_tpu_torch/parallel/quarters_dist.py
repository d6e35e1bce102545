"""Distributed red-black SOR in the QUARTER layout: geometry, packing, the
deep-halo exchange in quarter space, the masks, and the plain version of
the per-shard kernel K13 (counterpart of pampi_tpu/parallel/quarters_dist.py).

The quarter decomposition of ops/sor_quarters.py (every 5-point neighbour a
uniform shift of a dense plane) is carried across the distributed
convergence loop, one depth-n quarter exchange per n red-black iterations,
as the grid-space CA path of parallel/stencil2d.py does with a depth-2n
exchange.

LAYOUT. Every quarter of a shard is globally aligned: stored row r of each
slot holds global quarter row gqr = r - n + qoff_j (qoff_j = joff/2), stored
column c holds gqc = c - n + qoff_i. Shard extents are even, so joff/ioff
are even, local parity is global parity, and the same-index identities of
the single-device quarters hold verbatim. Only which stored rows a shard
owns depends on the parity: even rows own [n+1, n+jl/2], odd rows
[n, n+jl/2-1] (columns likewise).

The stored plane is the compact (4, jq, iq) = (4, jl/2+2n+1, il/2+2n+1),
as K1's planes are compact. The JAX geometry pads it for the TPU (a window
halo h above and below, rows to a block multiple, columns to 128 lanes);
the port drops that padding, so its row_base is n where the JAX one is
h + n, and every mask formula keeps its meaning with h = 0.

CA semantics: one iteration consumes one quarter row of ghost validity per
side, so a depth-n exchange buys n exact iterations; ghost cells are
recomputed by both neighbouring shards with the same arithmetic, and the
distributed trajectory equals the single-device one. Updates are clipped to
the stored plane's interior (its outermost ring stays frozen, as the grid
path's [1:-1] slice), so no cell reads outside the plane.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.sor_quarters import unpack_quarters
from .comm import CartComm

# (pr, pc) = global row/col parity of the slots R0, R1, B0, B1
SLOT_PARITY = ((0, 0), (1, 1), (0, 1), (1, 0))
# the slot pairs that share row offsets (exchanged over "j") and column
# offsets (exchanged over "i"), as views of the stacked planes
_ROW_PAIRS = ((0, slice(0, 4, 2)), (1, slice(1, 4, 2)))  # (R0, B0), (R1, B1)
_COL_PAIRS = ((0, slice(0, 4, 3)), (1, slice(1, 3)))     # (R0, B1), (R1, B0)


@dataclass(frozen=True)
class QGeom:
    """Static geometry of one shard's stacked quarter plane."""

    jmax: int  # global interior rows
    imax: int
    jl: int  # per-shard interior rows (even)
    il: int
    n: int  # CA depth in quarter rows = RB iterations per exchange
    jq: int  # stored rows: jl/2 + 2n + 1
    iq: int  # stored columns: il/2 + 2n + 1

    @property
    def row_base(self) -> int:
        """Stored row of global quarter row qoff_j."""
        return self.n

    @property
    def col_base(self) -> int:
        return self.n


def make_qgeom(jmax, imax, jl, il, n) -> QGeom:
    return QGeom(jmax, imax, jl, il, n, jl // 2 + 2 * n + 1,
                 il // 2 + 2 * n + 1)


def qdist_supported(jmax, imax, jl, il) -> bool:
    """Even global dims (quarter structure), even shard extents (parity
    alignment) and enough owned rows to ship a depth-1 strip."""
    return (
        jmax % 2 == 0 and imax % 2 == 0
        and jl % 2 == 0 and il % 2 == 0
        and jl >= 4 and il >= 4
    )


def qdist_clamp(n: int, jl: int, il: int) -> int:
    """Ghost strips come from owned cells: n <= min(jl, il)/2 - 1 (odd
    parity rows own jl/2 with a one-row stagger; keep a one-row margin)."""
    return max(1, min(n, min(jl, il) // 2 - 1))


def quarters_dispatch(param, jmax, imax, jl, il, dx, dy, dtype,
                      record_key: str, plain_sor: bool, label="kernel"):
    """The layout decision of the 2-D distributed solvers: whether the
    quarter-layout path runs. Returns (rb_q, qg), where rb_q(qoffs, xq,
    rq, out) runs K13 (or, on a CPU tensor, its plain version) on one
    shard, reading xq and writing out; rb_q is None when the caller should
    run its grid-space CA path. Raises ValueError on a forced
    `tpu_sor_layout quarters` that does not fit.
    The depth n (iterations per exchange) is the dtype's
    utils/dispatch.sor_cadence, clamped by qdist_clamp. The decision is
    recorded under record_key as "<label>_quarters caN" (the JAX package's
    NS-2D records "pallas_quarters").

    Unlike the JAX package, which takes the quarters under `auto` only
    where its Pallas kernel is live (a TPU), the port takes them wherever
    qdist_supported holds, on the CPU as on the card: K13 takes float32
    and float64, and its plain version runs on the CPU, so the CPU runs the
    card's choreography."""
    from ..ops.sor_kernels import sor_coefficients
    from ..ops.sor_qdist import rb_sor_qdist
    from ..utils import dispatch as _dispatch

    layout = param.tpu_sor_layout
    qsup = qdist_supported(jmax, imax, jl, il)
    if layout == "quarters" and not (qsup and plain_sor):
        raise ValueError(
            "tpu_sor_layout quarters needs even global and per-shard "
            "extents (>= 4) and the plain tpu_solver sor path")
    if not (plain_sor and qsup and layout in ("auto", "quarters")):
        return None, None
    n_q = _dispatch.sor_cadence(param, dtype, mesh=True,
                                forced=layout == "quarters",
                                clamp=lambda n: qdist_clamp(n, jl, il))
    qg = make_qgeom(jmax, imax, jl, il, n_q)
    factor, idx2, idy2 = sor_coefficients(dx, dy, param.omg)

    def rb_q(qoffs, xq, rq, out):
        return rb_sor_qdist(xq, rq, qg, qoffs, factor, idx2, idy2, out)

    _dispatch.record(record_key, f"{label}_quarters ca{n_q}")
    return rb_q, qg


# ----------------------------------------------------------------------
# Packing: (jl+2, il+2) extended block <-> stacked (4, jq, iq)
# ----------------------------------------------------------------------


def pack_ext_to_q(ext, g: QGeom):
    """Extended halo-1 block -> stacked quarter plane: all four quarters
    land at stored rows [n, n + jl/2] and columns [n, n + il/2] (the ghost
    row and column included); the rest is zero until an exchange."""
    out = ext.new_zeros((4, g.jq, g.iq))
    out[:, g.row_base:g.row_base + g.jl // 2 + 1,
        g.col_base:g.col_base + g.il // 2 + 1] = torch.stack([
            ext[0::2, 0::2],  # R0 (even, even)
            ext[1::2, 1::2],  # R1 (odd, odd)
            ext[0::2, 1::2],  # B0 (even, odd)
            ext[1::2, 0::2],  # B1 (odd, even)
        ])
    return out


def unpack_q_to_ext(xq, g: QGeom):
    """Inverse of pack_ext_to_q."""
    j2, i2 = g.jl // 2 + 1, g.il // 2 + 1
    q = xq[:, g.row_base:g.row_base + j2, g.col_base:g.col_base + i2]
    return unpack_quarters(q[0], q[1], q[2], q[3])


# ----------------------------------------------------------------------
# Deep-halo exchange in quarter space
# ----------------------------------------------------------------------


def _owned_start(g: QGeom, parity: int) -> int:
    """First owned stored row (or column) of a parity; the row and column
    bases are equal."""
    return g.row_base + (1 if parity == 0 else 0)


def q_exchange_copies(xq, comm: CartComm, g: QGeom):
    """The (ghost strip, owned strip) view pairs of one quarter-space
    exchange over the planes xq, in the order they are copied: rows over
    "j" first, then columns over "i" with full strips, so the corners are
    consistent. Slots that share offsets travel as one strided pair: per
    axis, parity and direction one copy per shard. The views stay valid as
    long as the planes, so a solve builds them once."""
    n = g.n
    copies = []
    for dim, axis, half, pairs in ((1, "j", g.jl // 2, _ROW_PAIRS),
                                   (2, "i", g.il // 2, _COL_PAIRS)):
        if comm.axis_size(axis) == 1:
            continue
        for s, x in enumerate(xq):
            lo = comm.neighbour(s, axis, -1)
            hi = comm.neighbour(s, axis, 1)
            for parity, slots in pairs:
                os = _owned_start(g, parity)
                if lo is not None:  # low ghosts <- the owned top strip below
                    src = xq[lo][slots].narrow(dim, os + half - n, n)
                    copies.append((x[slots].narrow(dim, os - n, n), src))
                if hi is not None:  # high ghosts <- the owned bottom above
                    copies.append((x[slots].narrow(dim, os + half, n),
                                   xq[hi][slots].narrow(dim, os, n)))
    return copies


def q_exchange(xq, comm: CartComm, g: QGeom, copies=None):
    """commExchange in quarter space, in place on every shard's plane: the
    depth-n ghost strips of each quarter from the +-1 neighbours, wall
    ghosts kept (the depth-2n grid exchange, n quarter rows being 2n grid
    rows). `copies` is q_exchange_copies(xq, comm, g), built here when not
    given. Within an axis the sources are owned cells and the destinations
    ghosts, so no copy reads what another one of that axis writes."""
    if copies is None:
        copies = q_exchange_copies(xq, comm, g)
    for dst, src in copies:
        dst.copy_(src)
    return xq


# ----------------------------------------------------------------------
# Masks and the plain version of K13
# ----------------------------------------------------------------------


def q_masks(g: QGeom, qoff_j: int, qoff_i: int, device="cpu"):
    """Per-slot boolean masks on the (jq, iq) stored plane from global
    quarter coordinates: 'upd' (global interior within the plane's
    interior), 'own' (the owned region, residual accounting) and the eight
    wall-refresh masks, keyed like the kernel's select order. K13 computes
    the same formulas per cell (csrc/sor_qdist.cu). The JAX masks also AND a
    `valid` region that excludes the TPU padding; the compact plane is all
    valid."""
    rho = torch.arange(g.jq, device=device)[:, None]
    col = torch.arange(g.iq, device=device)[None, :]
    gqr = rho - g.n + qoff_j
    gqc = col - g.n + qoff_i
    # the outermost stored ring stays frozen: its neighbours lie outside
    valid_upd = (rho >= 1) & (rho <= g.jq - 2) & (col >= 1) & (col <= g.iq - 2)

    def row_int(pr):
        if pr == 0:
            return (gqr >= 1) & (gqr <= g.jmax // 2)
        return (gqr >= 0) & (gqr <= g.jmax // 2 - 1)

    def col_int(pc):
        if pc == 0:
            return (gqc >= 1) & (gqc <= g.imax // 2)
        return (gqc >= 0) & (gqc <= g.imax // 2 - 1)

    def own(pr, pc):
        r0, c0 = _owned_start(g, pr), _owned_start(g, pc)
        return ((rho >= r0) & (rho < r0 + g.jl // 2)
                & (col >= c0) & (col < c0 + g.il // 2))

    m = {"upd": [row_int(pr) & col_int(pc) & valid_upd
                 for pr, pc in SLOT_PARITY],
         "own": [own(pr, pc) for pr, pc in SLOT_PARITY]}
    m["row_lo_pc0"] = (gqr == 0) & col_int(0)  # gj == 0, even i
    m["row_lo_pc1"] = (gqr == 0) & col_int(1)  # gj == 0, odd i
    m["row_hi_pc0"] = (gqr == g.jmax // 2) & col_int(0)
    m["row_hi_pc1"] = (gqr == g.jmax // 2) & col_int(1)
    m["col_lo_pr0"] = (gqc == 0) & row_int(0)
    m["col_lo_pr1"] = (gqc == 0) & row_int(1)
    m["col_hi_pr0"] = (gqc == g.imax // 2) & row_int(0)
    m["col_hi_pr1"] = (gqc == g.imax // 2) & row_int(1)
    return m


def _upd(center, rhs_q, w, e, s, n_, mask, factor, idx2, idy2):
    """The kernel's per-cell arithmetic in the reference association; a
    select, not a multiply, so garbage outside the mask cannot leak in
    through inf·0."""
    r = rhs_q - ((e - 2.0 * center + w) * idx2
                 + (n_ - 2.0 * center + s) * idy2)
    rm = torch.where(mask, r, torch.zeros_like(r))
    return center - factor * rm, rm


def rb_iters_q(xq, rhsq, g: QGeom, m, factor, idx2, idy2):
    """n red-black iterations, each with the Neumann wall refresh, on one
    shard's stacked plane: the plain version of K13 (the twin of the JAX
    rb_iters_q_jnp). Returns (new planes, the owned sum of r² of the last
    iteration, in K13's order: ops/sor_kernels.tiled_residual over the
    tiles of the call's last pass)."""
    from ..ops.sor_kernels import tiled_residual
    from ..ops.sor_qdist import qdist_passes

    new, r2 = rb_sweeps_q(xq, rhsq, g, m, factor, idx2, idy2)
    pl = qdist_passes(g, xq.element_size())[-1]
    return new, tiled_residual(r2, pl.th, pl.tw)


def rb_sweeps_q(xq, rhsq, g: QGeom, m, factor, idx2, idy2):
    """rb_iters_q's iterations (the JAX rb_iters_q_jnp's neighbour
    identities, selects and order; the rolls wrap only into cells every
    mask excludes). Returns (new planes, the last iteration's r² on the
    owned cells of each slot, 0 elsewhere: (4, jq, iq))."""
    R0, R1, B0, B1 = xq.unbind(0)
    F0, F1, G0, G1 = rhsq.unbind(0)

    def east(x):
        return torch.roll(x, -1, 1)

    def west(x):
        return torch.roll(x, 1, 1)

    def north(x):
        return torch.roll(x, -1, 0)

    def south(x):
        return torch.roll(x, 1, 0)

    rs = ()
    for _ in range(g.n):
        R0, r0 = _upd(R0, F0, west(B0), B0, south(B1), B1, m["upd"][0],
                      factor, idx2, idy2)
        R1, r1 = _upd(R1, F1, B1, east(B1), B0, north(B0), m["upd"][1],
                      factor, idx2, idy2)
        B0, r2 = _upd(B0, G0, R0, east(R0), south(R1), R1, m["upd"][2],
                      factor, idx2, idy2)
        B1, r3 = _upd(B1, G1, west(R1), R1, R0, north(R0), m["upd"][3],
                      factor, idx2, idy2)
        rs = (r0, r1, r2, r3)
        R0 = torch.where(m["row_lo_pc0"], B1, R0)
        B0 = torch.where(m["row_lo_pc1"], R1, B0)
        R1 = torch.where(m["row_hi_pc1"], B0, R1)
        B1 = torch.where(m["row_hi_pc0"], R0, B1)
        R0 = torch.where(m["col_lo_pr0"], B0, R0)
        B1 = torch.where(m["col_lo_pr1"], R1, B1)
        B0 = torch.where(m["col_hi_pr0"], R0, B0)
        R1 = torch.where(m["col_hi_pr1"], B1, R1)

    r2 = torch.stack([torch.where(own, rq * rq, torch.zeros_like(rq))
                      for rq, own in zip(rs, m["own"])])
    return torch.stack([R0, R1, B0, B1]), r2
