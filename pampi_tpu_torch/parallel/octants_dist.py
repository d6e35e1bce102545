"""Distributed red-black SOR in the OCTANT layout: geometry, packing, the
deep-halo exchange in octant space, the masks, and the plain version of
the per-shard kernel K14 (counterpart of pampi_tpu/parallel/
octants_dist.py; the 3-D form of parallel/quarters_dist.py).

The octant decomposition of ops/sor_octants.py (every 7-point neighbour a
uniform shift of a dense array) is carried across the distributed
convergence loop of models/ns3d_dist.py, one depth-n octant exchange per
n red-black iterations.

LAYOUT. Every octant of a shard is globally aligned: stored index
(s, r, c) of every slot holds global octant coordinates

    go_k = s - d_k + qoff_k,  go_j = r - d_j + qoff_j,  go_i = c - d_i + qoff_i

with qoff = shard offset / 2. Shard extents are even, so offsets are even,
local parity is global parity, and the single-device neighbour and
Neumann identities hold verbatim. Per parity bit b of an axis, the owned
stored indices start at d_ax + (1 if b == 0 else 0).

d_ax is the per-axis deep-halo depth: n on mesh axes that exchange (size
> 1), 0 on axes the shard owns whole. A size-1 axis has physical walls on
both sides, whose ghosts the in-kernel Neumann refresh keeps every
iteration, as on one device, so it stores no CA ghost planes; with
d = (0, 0, 0) (a (1, 1, 1) mesh) the shard is geometrically the
single-device octant array of kernel K6.

The stored volume is the compact (8, kq, jq, iq) with kq = kl/2 + 2·d_k + 1
(and likewise for j, i). The JAX geometry pads it for the TPU (a k-window
halo h, k-blocks, sublane/lane rounding of j and i); the port drops that
padding, so its base is (d_k, d_j, d_i) where the JAX one is
(h + d_k, d_j, d_i), and every mask formula keeps its meaning with h = 0.

CA semantics, on exchanged axes: one iteration consumes one octant plane of
validity per side; the outermost stored ring stays frozen (in grid space it
is the outermost ghost plane of the depth-2n grid exchange); ghost cells
are recomputed by both neighbouring shards with the same arithmetic;
residuals count owned cells only. On d_ax = 0 axes there is no frozen ring:
the per-parity global bounds alone clip the updates, as in K6.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..ops.sor_octants import BITS, EVEN, ODD, _flip
from .comm import CartComm

# slot index per bits tuple (pk, pj, pi) in the stacked (8, ...) array
QIDX = {bits: i for i, bits in enumerate(BITS)}


@dataclass(frozen=True)
class OGeom:
    """Static geometry of one shard's stacked octant volume."""

    kmax: int  # global interior extents
    jmax: int
    imax: int
    kl: int  # per-shard interior extents (even)
    jl: int
    il: int
    n: int  # RB iterations per exchange
    kq: int  # stored extents: l/2 + 2·d + 1
    jq: int
    iq: int
    d: tuple  # stored deep-halo depth per axis (n, or 0 on size-1 axes)

    @property
    def base(self) -> tuple:
        """Stored index of global octant coordinate qoff, per axis."""
        return self.d

    def gmax2(self, axis: int) -> int:
        return (self.kmax, self.jmax, self.imax)[axis] // 2

    def local2(self, axis: int) -> int:
        return (self.kl, self.jl, self.il)[axis] // 2

    def span(self, axis: int) -> int:
        return (self.kq, self.jq, self.iq)[axis]


def make_ogeom(kmax, jmax, imax, kl, jl, il, n, dims=None) -> OGeom:
    """dims = the mesh sizes per ("k", "j", "i") axis; axes of size 1 store
    no deep halo. dims=None stores depth n on every axis (the conservative
    layout, for any shard offsets)."""
    d = (n, n, n) if dims is None else tuple(n if sz > 1 else 0
                                             for sz in dims)
    return OGeom(kmax, jmax, imax, kl, jl, il, n, kl // 2 + 2 * d[0] + 1,
                 jl // 2 + 2 * d[1] + 1, il // 2 + 2 * d[2] + 1, d)


def odist_supported(kmax, jmax, imax, kl, jl, il) -> bool:
    """Even global dims (octant structure), even shard extents (parity
    alignment) and at least 4 cells a shard on every axis."""
    return (
        kmax % 2 == 0 and jmax % 2 == 0 and imax % 2 == 0
        and kl % 2 == 0 and jl % 2 == 0 and il % 2 == 0
        and kl >= 4 and jl >= 4 and il >= 4
    )


def odist_clamp(n: int, kl: int, jl: int, il: int, dims=None) -> int:
    """CA-depth clamp: the ghost slabs come from owned cells, so n is
    bounded by the exchanged axes' extents (n <= l/2 - 1); an axis of mesh
    size 1 imposes no bound, except k, which bounds n whatever its mesh
    size (the JAX kernel's k window carries n halo planes)."""
    exts = [kl]
    if dims is None:
        exts = [kl, jl, il]
    else:
        exts += [e for e, sz in zip((kl, jl, il), dims) if sz > 1]
    return max(1, min(n, min(exts) // 2 - 1))


def octants_dispatch(param, kmax, jmax, imax, kl, jl, il, dx, dy, dz,
                     dtype, record_key: str, dims=None,
                     plain_sor: bool = True):
    """The layout decision of the distributed NS-3D solver: whether the
    octant-layout path runs. Returns (rb_o, og, n_o), where rb_o(qoffs, xo,
    ro, out) runs K14 (or, on a CPU tensor, its plain version) on one
    shard, reading xo and writing out;
    rb_o is None when the caller should run its grid-space CA path, or,
    with `plain_sor` False (obstacle flag fields), its own solve. Raises
    ValueError on a forced `tpu_sor_layout octants` that does not fit or
    has no plain SOR to run. The
    depth n is the dtype's utils/dispatch.sor_cadence, clamped by
    odist_clamp.

    Unlike the JAX package, which takes the octants under `auto` only where
    its Pallas kernel is live (a TPU), the port takes them wherever
    odist_supported holds, on the CPU as on the card, as
    quarters_dist.quarters_dispatch does."""
    from ..ops.sor3d import sor_coefficients_3d
    from ..ops.sor_odist import rb_sor_odist
    from ..utils import dispatch as _dispatch

    layout = param.tpu_sor_layout
    osup = odist_supported(kmax, jmax, imax, kl, jl, il)
    if layout == "octants" and not (osup and plain_sor):
        raise ValueError(
            "tpu_sor_layout octants needs even global and per-shard "
            "extents (>= 4) and the plain tpu_solver sor path"
        )
    if not (plain_sor and osup and layout in ("auto", "octants")):
        return None, None, 0
    n_o = _dispatch.sor_cadence(
        param, dtype, mesh=True, forced=layout == "octants",
        clamp=lambda n: odist_clamp(n, kl, jl, il, dims))
    og = make_ogeom(kmax, jmax, imax, kl, jl, il, n_o, dims=dims)
    factor, idx2, idy2, idz2 = sor_coefficients_3d(dx, dy, dz, param.omg)

    def rb_o(qoffs, xo, ro, out):
        return rb_sor_odist(xo, ro, og, qoffs, factor, idx2, idy2, idz2,
                            out)

    _dispatch.record(record_key, f"kernel_octants ca{n_o}")
    return rb_o, og, n_o


def _owned_start(g: OGeom, axis: int, bit: int) -> int:
    return g.base[axis] + (1 if bit == 0 else 0)


# ----------------------------------------------------------------------
# Packing: (kl+2, jl+2, il+2) extended block <-> stacked (8, kq, jq, iq)
# ----------------------------------------------------------------------


def pack_ext_to_o(ext, g: OGeom):
    """Extended halo-1 block -> stacked octant volume: the eight octants
    land at stored indices [d, d + l/2] per axis (the ghost planes
    included); the rest is zero until an exchange."""
    out = ext.new_zeros((8, g.kq, g.jq, g.iq))
    bk, bj, bi = g.base
    out[:, bk:bk + g.kl // 2 + 1, bj:bj + g.jl // 2 + 1,
        bi:bi + g.il // 2 + 1] = torch.stack(
            [ext[b[0]::2, b[1]::2, b[2]::2] for b in BITS])
    return out


def unpack_o_to_ext(xo, g: OGeom):
    """Inverse of pack_ext_to_o."""
    k2, j2, i2 = g.kl // 2 + 1, g.jl // 2 + 1, g.il // 2 + 1
    bk, bj, bi = g.base
    out = xo.new_empty((2 * k2, 2 * j2, 2 * i2))
    for qi, b in enumerate(BITS):
        out[b[0]::2, b[1]::2, b[2]::2] = xo[qi, bk:bk + k2, bj:bj + j2,
                                            bi:bi + i2]
    return out


# ----------------------------------------------------------------------
# Deep-halo exchange in octant space
# ----------------------------------------------------------------------


def o_exchange_copies(xo, comm: CartComm, g: OGeom):
    """The (ghost slab, owned slab) view pairs of one octant-space exchange
    over the volumes xo, in the order they are copied: axis by axis (k, j,
    i) with full slabs, so the edges and corners are consistent. The four
    slots that share a parity bit on an axis travel as one strided view:
    per axis, bit and direction one copy per shard (12 in all on a mesh
    split along every axis). The views stay valid as long as the volumes,
    so a solve builds them once. Axes of mesh size 1 store no deep halo and
    are skipped."""
    copies = []
    for axis, name in enumerate(("k", "j", "i")):
        nper = comm.axis_size(name)
        n = g.d[axis]
        if nper > 1 and n == 0:
            raise ValueError(
                f"OGeom stores no deep halo on axis {name!r} but the mesh "
                f"has {nper} shards there: the geometry was built for "
                "another mesh (pass dims=comm.dims to make_ogeom)")
        if nper == 1:
            continue
        l2 = g.local2(axis)
        dim = 2 + axis  # the spatial axis in a (2, 2, kq, jq, iq) group
        for s, x in enumerate(xo):
            lo = comm.neighbour(s, name, -1)
            hi = comm.neighbour(s, name, 1)
            for bit in (0, 1):
                os = _owned_start(g, axis, bit)

                def grp(t):
                    return t.view(2, 2, 2, g.kq, g.jq, g.iq).select(axis, bit)

                if lo is not None:  # low ghosts <- the owned top slab below
                    copies.append((grp(x).narrow(dim, os - n, n),
                                   grp(xo[lo]).narrow(dim, os + l2 - n, n)))
                if hi is not None:  # high ghosts <- the owned bottom above
                    copies.append((grp(x).narrow(dim, os + l2, n),
                                   grp(xo[hi]).narrow(dim, os, n)))
    return copies


def o_exchange(xo, comm: CartComm, g: OGeom, copies=None):
    """commExchange in octant space, in place on every shard's volume: the
    depth-d_ax ghost slabs of each octant from the +-1 neighbours, wall
    ghosts kept (the depth-2n grid exchange). `copies` is
    o_exchange_copies(xo, comm, g), built here when not given. Sources are
    owned cells (odist_clamp keeps n below the owned extent) and
    destinations ghosts, so no copy of an axis reads what another one of
    that axis writes."""
    if copies is None:
        copies = o_exchange_copies(xo, comm, g)
    for dst, src in copies:
        dst.copy_(src)
    return xo


# ----------------------------------------------------------------------
# Masks and the plain version of K14
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def o_masks(g: OGeom, qoff_k: int, qoff_j: int, qoff_i: int,
            device="cpu"):
    """Per-slot boolean masks on the (kq, jq, iq) stored volume from global
    octant coordinates: m["upd"][bits] (global interior within the frozen
    ring on deep-halo axes), m["own"][bits] (the owned region, residual
    accounting) and the 24 Neumann face selects m["wall"][(axis, hi,
    bits)] on the target slot. K14 computes the same formulas per cell
    (csrc/sor_odist.cu); keep the two in lockstep. The JAX masks also AND a
    `valid` region that excludes the TPU padding; the compact volume is
    all valid. Cached: the masks of a shard do not change during a run."""
    lam = (torch.arange(g.kq, device=device)[:, None, None],
           torch.arange(g.jq, device=device)[None, :, None],
           torch.arange(g.iq, device=device)[None, None, :])
    qoff = (qoff_k, qoff_j, qoff_i)
    go = tuple(lam[a] - g.d[a] + qoff[a] for a in range(3))
    # the frozen outermost ring exists only on deep-halo axes
    valid_upd = torch.ones((), dtype=torch.bool, device=device)
    for a in range(3):
        if g.d[a] > 0:
            valid_upd = valid_upd & (lam[a] >= 1) & (lam[a] <= g.span(a) - 2)

    def ax_int(axis, bit):
        if bit == 0:
            return (go[axis] >= 1) & (go[axis] <= g.gmax2(axis))
        return (go[axis] >= 0) & (go[axis] <= g.gmax2(axis) - 1)

    def ax_own(axis, bit):
        os = _owned_start(g, axis, bit)
        return (lam[axis] >= os) & (lam[axis] < os + g.local2(axis))

    m = {"upd": {}, "own": {}, "wall": {}}
    for bits in BITS:
        m["upd"][bits] = (ax_int(0, bits[0]) & ax_int(1, bits[1])
                          & ax_int(2, bits[2]) & valid_upd)
        m["own"][bits] = (ax_own(0, bits[0]) & ax_own(1, bits[1])
                          & ax_own(2, bits[2]))
    for axis in range(3):
        for hi in (False, True):
            plane = go[axis] == (g.gmax2(axis) if hi else 0)
            for bits in BITS:
                if bits[axis] != (1 if hi else 0):
                    continue
                a2, a3 = [a for a in range(3) if a != axis]
                m["wall"][(axis, hi, bits)] = (
                    plane & ax_int(a2, bits[a2]) & ax_int(a3, bits[a3]))
    return m


def rb_iters_o(xo, rhso, g: OGeom, m, factor, idx2, idy2, idz2):
    """g.n red-black iterations (odd octants, even octants, the 24 globally
    gated Neumann selects) on one shard's stacked volume: the plain version
    of K14 (the twin of the JAX rb_iters_o_jnp: the same neighbour
    identities, selects and order; the rolls wrap only into cells every
    mask excludes). Returns (the new volume, the last iteration's r² on
    the owned cells, 0 elsewhere, as a stacked volume: K14 sums it in its
    tile order, ops/sor_odist.odist_residual)."""
    octs = {bits: xo[QIDX[bits]] for bits in BITS}
    rhs_o = {bits: rhso[QIDX[bits]] for bits in BITS}

    def nbrs(bits):
        def ax_pair(axis):
            partner = octs[_flip(bits, axis)]
            if bits[axis] == 0:
                return torch.roll(partner, 1, axis), partner
            return partner, torch.roll(partner, -1, axis)

        f, bk = ax_pair(0)
        s, n = ax_pair(1)
        w, e = ax_pair(2)
        return w, e, s, n, f, bk

    resids = {}
    for _ in range(g.n):
        for group in (ODD, EVEN):
            for bits in group:
                cen = octs[bits]
                w, e, s, n, f, bk = nbrs(bits)
                r = rhs_o[bits] - (
                    (e - 2.0 * cen + w) * idx2
                    + (n - 2.0 * cen + s) * idy2
                    + (bk - 2.0 * cen + f) * idz2
                )
                rm = torch.where(m["upd"][bits], r, torch.zeros_like(r))
                octs[bits] = cen - factor * rm
                resids[bits] = rm
        for axis in range(3):
            for hi in (False, True):
                for bits in BITS:
                    if bits[axis] != (1 if hi else 0):
                        continue
                    octs[bits] = torch.where(m["wall"][(axis, hi, bits)],
                                             octs[_flip(bits, axis)],
                                             octs[bits])

    r2 = torch.stack([torch.where(m["own"][bits], rq * rq,
                                  torch.zeros_like(rq))
                      for bits, rq in ((b, resids[b]) for b in BITS)])
    return torch.stack([octs[bits] for bits in BITS]), r2
