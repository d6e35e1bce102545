"""Direct Neumann-Poisson solve by DCT diagonalisation (counterpart of
pampi_tpu/ops/dctpoisson.py:44-157).

The pressure operator is a constant-coefficient 5/7-point Laplacian on a
uniform cell-centred grid with ghost-copy Neumann walls. The orthonormal
DCT-II basis diagonalises it exactly (eigenvalues (2cos(πk/N) - 2)/h² per
axis), so the discrete solution is one forward transform per axis, a
divide, and one inverse transform per axis; the zero mode (the constants,
the operator's null space) is set to 0.

As in the JAX package each transform is a dense (N, N) matrix applied along
one axis, a plain matrix product outside any kernel (`torch.tensordot`),
not an FFT. The matrices and the eigenvalue denominator are built once per
solver, on its device and in its dtype. A float32 product must not run in
TF32 (about three decimal digits): building a float32 solve raises while
TF32 is allowed for matrix products, and never changes that setting.

Used two ways: `tpu_solver fft` (make_dct_solve_2d/3d: it = 1, res = the
true residual of the returned field) and the exact bottom of the multigrid
plans (ops/multigrid.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.precision import check_direct_dtype
from .sor import interior_residual, neumann_bc
from .sor3d import interior_residual_3d, neumann_faces_3d


def dct2_matrix(N: int) -> np.ndarray:
    """Orthonormal DCT-II analysis matrix D (k, i): D @ x gives the DCT-II
    coefficients of x; D.T is the inverse."""
    k = np.arange(N)[:, None]
    i = np.arange(N)[None, :]
    d = np.cos(np.pi * k * (2 * i + 1) / (2.0 * N))
    d *= np.sqrt(2.0 / N)
    d[0] *= np.sqrt(0.5)
    return d


def neumann_eigenvalues(N: int, h: float) -> np.ndarray:
    """Eigenvalues of the 1-D cell-centred Neumann Laplacian in the DCT-II
    basis: λ_k = (2cos(πk/N) - 2)/h², λ_0 = 0."""
    k = np.arange(N)
    return (2.0 * np.cos(np.pi * k / N) - 2.0) / (h * h)


def _check_no_tf32(dtype) -> None:
    if dtype != torch.float32:
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the DCT solve's float32 matrix products must run in full "
            "float32: set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def _apply(mat, x, axis):
    """Contract mat (K, N) with x along axis."""
    return torch.movedim(torch.tensordot(mat, x, dims=([1], [axis])), 0, axis)


def make_poisson_dct(extents, spacings, dtype, device):
    """Build apply(rhs_int) -> p_int, the exact zero-mode solve of
    lap(p) = rhs on an interior of shape `extents` (axis order j, i or k,
    j, i); spacings[a] is the cell size along axis a. The matrices and the
    denominator are built here, once."""
    check_direct_dtype(dtype)
    _check_no_tf32(dtype)
    nd = len(extents)
    mats = [torch.from_numpy(dct2_matrix(n)).to(device=device, dtype=dtype)
            for n in extents]
    mats_t = [m.T.contiguous() for m in mats]
    denom = None
    for a, (n, h) in enumerate(zip(extents, spacings)):
        shape = [1] * nd
        shape[a] = n
        lam = neumann_eigenvalues(n, h).reshape(shape)
        denom = lam if denom is None else denom + lam
    denom = torch.from_numpy(denom).to(device=device, dtype=dtype)
    nonzero = denom != 0
    safe = torch.where(nonzero, denom, torch.ones_like(denom))
    zero = torch.zeros((), dtype=dtype, device=device)

    def apply(rhs_int):
        h = rhs_int
        for a, m in enumerate(mats):
            h = _apply(m, h, a)
        ph = torch.where(nonzero, h / safe, zero)
        for a, m in enumerate(mats_t):
            ph = _apply(m, ph, a)
        return ph

    return apply


def poisson_dct_2d(rhs_int, dx: float, dy: float):
    """Exact interior solve of lap(p) = rhs (Neumann, zero-mean mode);
    rhs_int is the (jmax, imax) interior."""
    return make_poisson_dct(rhs_int.shape, (dy, dx), rhs_int.dtype,
                            rhs_int.device)(rhs_int)


def poisson_dct_3d(rhs_int, dx: float, dy: float, dz: float):
    """The 3-D twin: rhs_int (kmax, jmax, imax) -> p interior."""
    return make_poisson_dct(rhs_int.shape, (dz, dy, dx), rhs_int.dtype,
                            rhs_int.device)(rhs_int)


def _make_dct_solve(extents, spacings, dtype, device, residual, neumann):
    apply = make_poisson_dct(extents, spacings, dtype, device)
    inv2 = tuple(1.0 / (h * h) for h in reversed(spacings))  # idx2 first
    real = np.float32 if dtype == torch.float32 else np.float64
    norm = real(np.prod(extents))
    full = tuple(n + 2 for n in extents)
    inner = (slice(1, -1),) * len(extents)

    def solve(p, rhs):
        del p  # direct: the previous iterate is not needed
        pn = torch.zeros(full, dtype=dtype, device=rhs.device)
        pn[inner] = apply(rhs[inner])
        neumann(pn)
        r = residual(pn, rhs, *inv2)
        return pn, float(real(float(torch.sum(r * r))) / norm), 1

    return solve


def make_dct_solve_2d(imax, jmax, dx, dy, dtype, *, device):
    """The solve contract (p, rhs) -> (p, res, it) of the iterative
    solvers: it = 1, res = Σr²/(imax·jmax) of the returned field in the
    field's dtype (reported, not looped on)."""
    return _make_dct_solve((jmax, imax), (dy, dx), dtype, device,
                           interior_residual, neumann_bc)


def make_dct_solve_3d(imax, jmax, kmax, dx, dy, dz, dtype, *, device):
    """The 3-D twin of make_dct_solve_2d (res = Σr²/(imax·jmax·kmax))."""
    return _make_dct_solve((kmax, jmax, imax), (dz, dy, dx), dtype, device,
                           interior_residual_3d, neumann_faces_3d)
