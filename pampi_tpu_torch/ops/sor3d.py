"""3-D red-black SOR building blocks on the natural (kmax+2, jmax+2, imax+2)
layout, in plain PyTorch: the 3-D counterpart of ops/sor.py. The JAX
package keeps these in pampi_tpu/models/ns3d.py (checkerboard_mask_3d,
neumann_faces_3d, interior_residual_3d, sor_pass_3d, sor_coefficients_3d).

Pass 0 of the reference's sweep visits the (i + j + k) odd cells, pass 1
the even ones (1-based interior indices); the even pass sees the odd
pass's updates. Arrays are [k, j, i], i contiguous.
"""

from __future__ import annotations

import torch


def checkerboard_mask_3d(kmax: int, jmax: int, imax: int, parity: int,
                         dtype, device="cpu") -> torch.Tensor:
    """Interior mask (kmax, jmax, imax): 1 where (i + j + k) % 2 == parity."""
    kk = torch.arange(1, kmax + 1, device=device)[:, None, None]
    jj = torch.arange(1, jmax + 1, device=device)[None, :, None]
    ii = torch.arange(1, imax + 1, device=device)[None, None, :]
    return (((ii + jj + kk) % 2) == parity).to(dtype)


def neumann_faces_3d(p):
    """The 6-face homogeneous-Neumann ghost copy, in place; tangential
    ranges [1:-1], so edges and corners stay untouched and the six copies
    are disjoint."""
    p[0, 1:-1, 1:-1] = p[1, 1:-1, 1:-1]  # front
    p[-1, 1:-1, 1:-1] = p[-2, 1:-1, 1:-1]  # back
    p[1:-1, 0, 1:-1] = p[1:-1, 1, 1:-1]  # bottom
    p[1:-1, -1, 1:-1] = p[1:-1, -2, 1:-1]  # top
    p[1:-1, 1:-1, 0] = p[1:-1, 1:-1, 1]  # left
    p[1:-1, 1:-1, -1] = p[1:-1, 1:-1, -2]  # right
    return p


def interior_residual_3d(p, rhs, idx2, idy2, idz2):
    """Pointwise r = rhs - lap(p) on the interior, in the reference
    association (e - 2c + w)·idx2 + (n - 2c + s)·idy2 + (b - 2c + f)·idz2."""
    c = p[1:-1, 1:-1, 1:-1]
    lap = (
        (p[1:-1, 1:-1, 2:] - 2.0 * c + p[1:-1, 1:-1, :-2]) * idx2
        + (p[1:-1, 2:, 1:-1] - 2.0 * c + p[1:-1, :-2, 1:-1]) * idy2
        + (p[2:, 1:-1, 1:-1] - 2.0 * c + p[:-2, 1:-1, 1:-1]) * idz2
    )
    return rhs[1:-1, 1:-1, 1:-1] - lap


def sor_pass_3d(p, rhs, mask, factor, idx2, idy2, idz2):
    """One masked half-sweep of the 7-point stencil, in place on p.
    Returns (p, sum of masked r²)."""
    r = interior_residual_3d(p, rhs, idx2, idy2, idz2) * mask
    p[1:-1, 1:-1, 1:-1] -= factor * r
    return p, torch.sum(r * r)


def sor_coefficients_3d(dx: float, dy: float, dz: float, omega: float):
    """(factor, idx2, idy2, idz2) of the 3-D update, formed in double
    exactly as the JAX package forms them."""
    dx2, dy2, dz2 = dx * dx, dy * dy, dz * dz
    factor = omega * 0.5 * (dx2 * dy2 * dz2) / (dy2 * dz2 + dx2 * dz2 + dx2 * dy2)
    return factor, 1.0 / dx2, 1.0 / dy2, 1.0 / dz2
