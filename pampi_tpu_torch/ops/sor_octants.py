"""3-D red-black SOR in the OCTANT decomposition, in plain PyTorch
(counterpart of pampi_tpu/ops/sor_octants.py): the 3-D form of the quarter
layout of ops/sor_quarters.py.

An even-shaped (K, J, I) array splits by the parity of all three indices
into eight dense (K/2, J/2, I/2) octants, keyed by bits (pk, pj, pi):

    O[pk,pj,pi][s, r, c] = p[2s + pk, 2r + pj, 2c + pi]

The colour (k + j + i) % 2 is (pk + pj + pi) % 2, so each colour is four
octants, and every 7-point neighbour lives in the octant with ONE bit
flipped, at a uniform index: along an axis with bit b,

    b = 0:  coord-1 -> partner[idx-1],  coord+1 -> partner[idx]
    b = 1:  coord-1 -> partner[idx],    coord+1 -> partner[idx+1]

An octant's interior drops index 0 along its parity-0 axes (the ghost
plane 0) and the last index along its parity-1 axes (the ghost plane
max+1), so on that interior the minus neighbour is always the partner's
[:-1] slice along the axis and the plus neighbour its [1:] slice. The
6-face Neumann refresh is 24 same-index plane copies between partners,
clipped like the interiors: disjoint and order-free.

The stacked form (8, K/2, J/2, I/2) holds the octants in BITS order; it is
the layout of the K6 kernel (ops/sor3d_kernels.py). Pass order is the
reference's: ODD parity first, then EVEN.
"""

from __future__ import annotations

import torch

BITS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
ODD = [b for b in BITS if sum(b) % 2 == 1]   # first half-sweep
EVEN = [b for b in BITS if sum(b) % 2 == 0]  # second half-sweep


def _flip(bits, axis):
    out = list(bits)
    out[axis] = 1 - out[axis]
    return tuple(out)


def pack_octants(p):
    """(K, J, I) even-shaped array -> {bits: strided (K/2, J/2, I/2) view}."""
    if any(d % 2 for d in p.shape):
        raise ValueError(f"octants need an even-shaped array, got {tuple(p.shape)}")
    return {b: p[b[0]::2, b[1]::2, b[2]::2] for b in BITS}


def unpack_octants(octs):
    """{bits: octant} -> the (K, J, I) array."""
    K2, J2, I2 = octs[(0, 0, 0)].shape
    p = octs[(0, 0, 0)].new_empty((2 * K2, 2 * J2, 2 * I2))
    for b, q in octs.items():
        p[b[0]::2, b[1]::2, b[2]::2] = q
    return p


def stack_octants(p):
    """(K, J, I) -> contiguous (8, K/2, J/2, I/2) in BITS order."""
    octs = pack_octants(p)
    return torch.stack([octs[b] for b in BITS])


def unstack_octants(q):
    """Inverse of stack_octants."""
    return unpack_octants(dict(zip(BITS, q.unbind(0))))


def interior_slices(bits):
    """An octant's rectangular interior: parity-0 axes drop index 0,
    parity-1 axes drop the last."""
    return tuple(slice(1, None) if b == 0 else slice(0, -1) for b in bits)


def neighbours(octs, bits):
    """(w, e, s, n, f, bk): the neighbour views aligned with the interior
    of octant `bits` (module docstring)."""
    inner = interior_slices(bits)

    def pair(axis):
        partner = octs[_flip(bits, axis)]
        minus, plus = list(inner), list(inner)
        minus[axis], plus[axis] = slice(None, -1), slice(1, None)
        return partner[tuple(minus)], partner[tuple(plus)]

    f, bk = pair(0)
    s, n = pair(1)
    w, e = pair(2)
    return w, e, s, n, f, bk


def ghost_pairs(octs):
    """The Neumann refresh as 24 (dst, src) views: each face's ghost plane
    in the four octants that hold it, copied from the partner across the
    face at the same index."""
    pairs = []
    for axis in range(3):
        for hi in (False, True):
            for bits in BITS:
                if bits[axis] != (1 if hi else 0):
                    continue
                sl = list(interior_slices(bits))
                sl[axis] = -1 if hi else 0
                sl = tuple(sl)
                pairs.append((octs[bits][sl], octs[_flip(bits, axis)][sl]))
    return pairs


def neumann_bc_octants(octs):
    """The 24 ghost-plane copies, in place."""
    for dst, src in ghost_pairs(octs):
        dst.copy_(src)
    return octs


def _sweep_views(octs, rhs_octs):
    """Per half-sweep, (center, rhs, w, e, s, n, f, bk) views of each of its
    four octants' interiors. Views, so they are formed once per solve."""
    def views(group):
        out = []
        for bits in group:
            inner = interior_slices(bits)
            out.append((octs[bits][inner], rhs_octs[bits][inner],
                        *neighbours(octs, bits)))
        return out

    return views(ODD), views(EVEN)


def _update(center, rhs, w, e, s, n, f, bk, factor, idx2, idy2, idz2):
    """r = rhs - ((e - 2c + w)·idx2 + (n - 2c + s)·idy2 + (bk - 2c + f)·idz2);
    center -= factor·r, in place. Returns r."""
    r = rhs - (
        (e - 2.0 * center + w) * idx2
        + (n - 2.0 * center + s) * idy2
        + (bk - 2.0 * center + f) * idz2
    )
    center -= factor * r
    return r


def sweeps_octants(octs, rhs_octs, n_inner, factor, idx2, idy2, idz2):
    """n_inner full red-black iterations (odd pass, even pass, Neumann
    refresh) in octant space, in place on the octants. Returns {bits: r}
    of the last iteration on each octant's interior, in ODD + EVEN
    order."""
    odd, even = _sweep_views(octs, rhs_octs)
    ghosts = ghost_pairs(octs)
    rs = ()
    for _ in range(n_inner):
        # an octant reads only the other colour's octants, so updating a
        # colour's four octants one after another is its half-sweep
        rs = tuple(_update(*v, factor, idx2, idy2, idz2) for v in odd + even)
        for dst, src in ghosts:
            dst.copy_(src)
    return dict(zip(ODD + EVEN, rs))


def octant_sums(rs):
    """Σr² of sweeps_octants' residuals, octant by octant in ODD + EVEN
    order."""
    rs = list(rs.values())
    total = torch.sum(rs[0] * rs[0])
    for r in rs[1:]:
        total = total + torch.sum(r * r)
    return total


def rb_iter_octants(octs, rhs_octs, factor, idx2, idy2, idz2):
    """One full red-black iteration in octant space, in place on the
    octants ({bits: tensor}; views of a stacked tensor work). Returns Σr²
    over both passes."""
    return octant_sums(sweeps_octants(octs, rhs_octs, 1, factor, idx2, idy2,
                                      idz2))
