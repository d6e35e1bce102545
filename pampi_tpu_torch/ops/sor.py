"""Red-black SOR building blocks on the natural (jmax+2, imax+2) layout, in
plain PyTorch (counterpart of pampi_tpu/ops/sor.py).

Red cells are (i + j) even, black (i + j) odd, with the reference's 1-based
interior indices; the black half-sweep sees red's updates. Arrays are
[j, i], i contiguous.
"""

from __future__ import annotations

import torch


def checkerboard_mask(jmax: int, imax: int, parity: int, dtype,
                      device="cpu") -> torch.Tensor:
    """Interior-cell mask (jmax, imax): 1 where (i + j) % 2 == parity."""
    jj = torch.arange(1, jmax + 1, device=device)[:, None]
    ii = torch.arange(1, imax + 1, device=device)[None, :]
    return (((ii + jj) % 2) == parity).to(dtype)


def interior_residual(p, rhs, idx2, idy2):
    """Pointwise r = rhs - lap(p) on the interior (jmax, imax), in the
    reference association (e - 2c + w)*idx2 + (n - 2c + s)*idy2."""
    c = p[1:-1, 1:-1]
    lap = (p[1:-1, 2:] - 2.0 * c + p[1:-1, :-2]) * idx2 + (
        p[2:, 1:-1] - 2.0 * c + p[:-2, 1:-1]
    ) * idy2
    return rhs[1:-1, 1:-1] - lap


def sor_pass(p, rhs, mask, factor, idx2, idy2):
    """One masked half-sweep, in place on p. Returns (p, sum of masked r²)."""
    r = interior_residual(p, rhs, idx2, idy2) * mask
    p[1:-1, 1:-1] -= factor * r
    return p, torch.sum(r * r)


def residual_all(p, rhs, idx2, idy2):
    """Unmasked interior residual sum of squares (diagnostic)."""
    r = interior_residual(p, rhs, idx2, idy2)
    return torch.sum(r * r)


def neumann_bc(p):
    """Homogeneous-Neumann ghost copy on all four walls, in place, corners
    untouched (reference solver.c: the loops run over the interior)."""
    p[0, 1:-1] = p[1, 1:-1]
    p[-1, 1:-1] = p[-2, 1:-1]
    p[1:-1, 0] = p[1:-1, 1]
    p[1:-1, -1] = p[1:-1, -2]
    return p
