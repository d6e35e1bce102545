"""Red-black SOR in the QUARTER decomposition, in plain PyTorch
(counterpart of pampi_tpu/ops/sor_quarters.py).

An even-shaped (jmax+2, imax+2) array splits by row and column parity into
four dense planes

    R0[r,c] = p[2r,   2c  ]   red   on even rows
    R1[r,c] = p[2r+1, 2c+1]   red   on odd rows
    B0[r,c] = p[2r,   2c+1]   black on even rows
    B1[r,c] = p[2r+1, 2c  ]   black on odd rows

in which every 5-point neighbour is a uniform shift:

    R0: W=B0[c-1] E=B0[c]   S=B1[r-1] N=B1[r]
    R1: W=B1[c]   E=B1[c+1] S=B0[r]   N=B0[r+1]
    B0: W=R0[c]   E=R0[c+1] S=R1[r-1] N=R1[r]
    B1: W=R1[c-1] E=R1[c]   S=R0[r]   N=R0[r+1]

and the Neumann ghost refresh is eight same-index edge copies between
planes. The kernel layout stacks the planes into one (4, J2, I2) tensor
[R0, R1, B0, B1] (`stack_quarters`).
"""

from __future__ import annotations

import torch


def pack_quarters(p):
    """(J, I) even-shaped array -> (R0, R1, B0, B1) strided views."""
    assert p.shape[0] % 2 == 0 and p.shape[1] % 2 == 0, p.shape
    return p[0::2, 0::2], p[1::2, 1::2], p[0::2, 1::2], p[1::2, 0::2]


def unpack_quarters(R0, R1, B0, B1):
    J2, I2 = R0.shape
    p = R0.new_empty((2 * J2, 2 * I2))
    p[0::2, 0::2] = R0
    p[1::2, 1::2] = R1
    p[0::2, 1::2] = B0
    p[1::2, 0::2] = B1
    return p


def stack_quarters(p):
    """(J, I) -> contiguous (4, J/2, I/2) [R0, R1, B0, B1]."""
    return torch.stack(pack_quarters(p))


def unstack_quarters(q):
    """Inverse of stack_quarters."""
    return unpack_quarters(q[0], q[1], q[2], q[3])


def _ghost_pairs(R0, R1, B0, B1):
    """The Neumann refresh in quarter space as eight (dst, src) views,
    clipped to the interior exactly like the reference's BC loops (corners
    untouched). No copy reads a cell another one writes."""
    return (
        (R0[0, 1:], B1[0, 1:]),        # p[0,i]=p[1,i], even i
        (B0[0, :-1], R1[0, :-1]),      # p[0,i]=p[1,i], odd i
        (R1[-1, :-1], B0[-1, :-1]),    # p[jmax+1,i]=p[jmax,i], odd i
        (B1[-1, 1:], R0[-1, 1:]),      # p[jmax+1,i]=p[jmax,i], even i
        (R0[1:, 0], B0[1:, 0]),        # p[j,0]=p[j,1], even j
        (B1[:-1, 0], R1[:-1, 0]),      # p[j,0]=p[j,1], odd j
        (B0[1:, -1], R0[1:, -1]),      # p[j,imax+1]=p[j,imax], even j
        (R1[:-1, -1], B1[:-1, -1]),    # p[j,imax+1]=p[j,imax], odd j
    )


def neumann_bc_quarters(R0, R1, B0, B1):
    """Ghost refresh in quarter space, in place, corners untouched."""
    for dst, src in _ghost_pairs(R0, R1, B0, B1):
        dst.copy_(src)
    return R0, R1, B0, B1


def _upd(center, rhs, w, e, s, n, factor, idx2, idy2):
    """Reference association: r = rhs - ((e - 2c + w)·idx2 + (n - 2c + s)·idy2);
    center -= factor·r. Updates `center` in place and returns r. (2c is
    exact, so forming it once changes no bit.)"""
    c2 = 2.0 * center
    r = (e - c2).add_(w).mul_(idx2)
    r.add_((n - c2).add_(s).mul_(idy2))
    r = torch.sub(rhs, r, out=r)
    center.sub_(factor * r)
    return r


# each quarter's interior (the cells it updates), as slices of its plane
_INTERIORS = ((slice(1, None), slice(1, None)),   # R0
              (slice(None, -1), slice(None, -1)),  # R1
              (slice(1, None), slice(None, -1)),   # B0
              (slice(None, -1), slice(1, None)))   # B1


def _sweep_views(q, rhsq):
    """The slices one red-black iteration reads and writes, per colour:
    (center, rhs, w, e, s, n) for each quarter's interior, then the eight
    Neumann (dst, src) copies. Views, so they are formed once per solve."""
    R0, R1, B0, B1 = q
    F0, F1, G0, G1 = rhsq
    red = (  # interiors: R0 [1:,1:], R1 [:-1,:-1]
        (R0[1:, 1:], F0[1:, 1:], B0[1:, :-1], B0[1:, 1:], B1[:-1, 1:], B1[1:, 1:]),
        (R1[:-1, :-1], F1[:-1, :-1], B1[:-1, :-1], B1[:-1, 1:], B0[:-1, :-1], B0[1:, :-1]),
    )
    black = (  # interiors: B0 [1:,:-1], B1 [:-1,1:]
        (B0[1:, :-1], G0[1:, :-1], R0[1:, :-1], R0[1:, 1:], R1[:-1, :-1], R1[1:, :-1]),
        (B1[:-1, 1:], G1[:-1, 1:], R1[:-1, :-1], R1[:-1, 1:], R0[:-1, 1:], R0[1:, 1:]),
    )
    return red, black, _ghost_pairs(*q)


def _sweeps(q, rhsq, n_inner, factor, idx2, idy2, views=None):
    """n_inner iterations in place on the planes of q; returns the last
    iteration's r of each quarter's interior (R0, R1, B0, B1)."""
    red, black, ghosts = _sweep_views(q, rhsq) if views is None else views
    rs = ()
    for _ in range(n_inner):
        rs = tuple(_upd(*v, factor, idx2, idy2) for v in red + black)
        for dst, src in ghosts:
            dst.copy_(src)
    return rs


def rb_sweeps_quarters(q, rhsq, n_inner, factor, idx2, idy2):
    """n_inner full red-black iterations + Neumann refresh in quarter space,
    in place on the planes of q. Returns Σr² over both half-sweeps of the
    last iteration."""
    r0, r1, r2, r3 = _sweeps(q, rhsq, n_inner, factor, idx2, idy2)
    return (torch.sum(r0 * r0) + torch.sum(r1 * r1)
            + torch.sum(r2 * r2) + torch.sum(r3 * r3))


# the views of the last few CPU (planes, rhs) pairs that
# rb_sweeps_quarters_rs iterated: a solve loop alternates two planes over
# one rhs, and forming the ~40 views anew cost more host time a call than
# the iterations' arithmetic at the CLI's 100² grid. A cached view keeps
# its storage alive, so no other tensor can take its address while it is
# cached (on the card, where the plain version only checks the kernel,
# nothing is cached).
_VIEWS: dict = {}
_VIEWS_KEPT = 4


def rb_sweeps_quarters_rs(q, rhsq, n_inner, factor, idx2, idy2):
    """rb_sweeps_quarters on a stacked plane q (4, J2, I2), in place;
    returns the last iteration's r of each quarter's interior (R0, R1, B0,
    B1), for a residual summed in a kernel's order."""
    if q.device.type != "cpu":
        return _sweeps(tuple(q.unbind(0)), tuple(rhsq.unbind(0)), n_inner,
                       factor, idx2, idy2)
    key = (q.data_ptr(), rhsq.data_ptr(), tuple(q.shape), q.stride(),
           rhsq.stride(), q.dtype)
    views = _VIEWS.get(key)
    if views is None:
        if len(_VIEWS) >= _VIEWS_KEPT:
            _VIEWS.pop(next(iter(_VIEWS)))
        views = _VIEWS[key] = _sweep_views(tuple(q.unbind(0)),
                                           tuple(rhsq.unbind(0)))
    return _sweeps(None, None, n_inner, factor, idx2, idy2, views)


def rb_sweeps_quarters_r2(q, rhsq, n_inner, factor, idx2, idy2):
    """rb_sweeps_quarters on a stacked plane q (4, J2, I2), in place;
    returns the last iteration's r² as a (4, J2, I2) field, 0 outside each
    quarter's interior (for a residual summed in a kernel's order)."""
    rs = _sweeps(tuple(q.unbind(0)), tuple(rhsq.unbind(0)), n_inner, factor,
                 idx2, idy2)
    r2 = torch.zeros_like(q)
    for k, (sl, r) in enumerate(zip(_INTERIORS, rs)):
        r2[k][sl] = r * r
    return r2


def rb_iter_quarters(q, rhsq, factor, idx2, idy2):
    """One full red-black iteration + Neumann refresh in quarter space, in
    place on the planes of q. q, rhsq: (R0, R1, B0, B1) tuples (views of a
    stacked tensor work). Returns sum r² over both half-sweeps."""
    return rb_sweeps_quarters(q, rhsq, 1, factor, idx2, idy2)
