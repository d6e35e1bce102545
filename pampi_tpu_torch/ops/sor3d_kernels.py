"""Kernels K5 and K6: 3-D red-black SOR on the H100, each beside its plain
PyTorch version (sources: pampi_tpu_torch/csrc/sor3d_rb.cu).

K5 `rb_sor3d_checkerboard` replaces pampi_tpu/ops/sor3d_pallas.py
  `_tblock3d_kernel` (make_rb_iter_tblock_3d, plain mode, pallas_call at
  :388): n_inner iterations on the natural (kmax+2, jmax+2, imax+2) array.
K6 `rb_sor3d_octants` replaces pampi_tpu/ops/sor3d_pallas.py
  `_tblock3d_octants_kernel` (make_rb_iter_tblock_3d_octants, pallas_call
  at :735): the same function on the stacked octants (8, K2, J2, I2) of
  pampi_tpu_torch/ops/sor_octants.py (even imax, jmax, kmax).

Each iteration is the odd-parity half-sweep, the even one, and the 6-face
Neumann refresh. Both update p in place and return the sum of r² over both
half-sweeps of the LAST of their n_inner iterations, as a 0-dim tensor on
p's device.

What bounds them on the H100 is memory bandwidth: the least a call must
move is p and rhs read once and p written once (3 field-sizes, ~61.5 us at
256³ f32). The design is the 2-D kernels' (ops/sor_kernels.py): a launch
per colour per iteration, a Neumann launch, per-block partial sums of r²
on the last iteration and a one-block fixed-order sum, so the residual and
every iteration count are reproducible. Temporal blocking is later work.

For a CPU tensor each wrapper runs its plain version; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as kb
from .sor3d import checkerboard_mask_3d, neumann_faces_3d, sor_pass_3d
from .sor_kernels import _SUFFIX, _check
from .sor_octants import BITS, rb_sweeps_octants

SOURCE = "pampi_tpu_torch/csrc/sor3d_rb.cu"
RB_SOR3D_CHECKERBOARD = kb.register(
    "rb_sor3d_checkerboard", SOURCE, "pampi_tpu/ops/sor3d_pallas.py:388")
RB_SOR3D_OCTANTS = kb.register(
    "rb_sor3d_octants", SOURCE, "pampi_tpu/ops/sor3d_pallas.py:735")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SOR_ARGS = [_I, _V, _V, _I, _I, _I, _I, _D, _D, _D, _D, _V, _V, _V]
_SIGNATURES = {
    f"rb_sor3d_{layout}_{t}": _SOR_ARGS
    for layout in ("checkerboard", "octants") for t in ("f32", "f64")
}
_SIGNATURES["rb_sor3d_checkerboard_partials"] = [_I, _I, _I]
_SIGNATURES["rb_sor3d_octants_partials"] = [_I, _I, _I]


def _launch(kernel, entry: str, p, rhs, dims, n_inner, factor, idx2, idy2,
            idz2):
    lib = kb.load("sor3d_rb", _SIGNATURES)
    partial = torch.empty(getattr(lib, f"{entry}_partials")(*dims),
                          dtype=p.dtype, device=p.device)
    out = torch.empty((), dtype=p.dtype, device=p.device)
    err = getattr(lib, f"{entry}_{_SUFFIX[p.dtype]}")(
        p.device.index, p.data_ptr(), rhs.data_ptr(), *dims, n_inner,
        factor, idx2, idy2, idz2, partial.data_ptr(), out.data_ptr(),
        kb.stream_of(p))
    kb.check(lib, err, entry)
    kernel.launches += 1
    return out


def rb_sor3d_checkerboard_plain(p, rhs, n_inner, factor, idx2, idy2, idz2):
    """K5's plain version: n_inner (odd, even, Neumann) iterations with
    ops/sor3d.py, in place on p."""
    kmax, jmax, imax = (n - 2 for n in p.shape)
    odd = checkerboard_mask_3d(kmax, jmax, imax, 1, p.dtype, p.device)
    even = checkerboard_mask_3d(kmax, jmax, imax, 0, p.dtype, p.device)
    for _ in range(n_inner):
        _, r0 = sor_pass_3d(p, rhs, odd, factor, idx2, idy2, idz2)
        _, r1 = sor_pass_3d(p, rhs, even, factor, idx2, idy2, idz2)
        neumann_faces_3d(p)
    return r0 + r1


def rb_sor3d_checkerboard(p, rhs, n_inner, factor, idx2, idy2, idz2):
    """K5 on a (kmax+2, jmax+2, imax+2) p, in place. Returns Σr² of the
    last iteration (0-dim tensor)."""
    if p.device.type == "cpu":
        return rb_sor3d_checkerboard_plain(p, rhs, n_inner, factor, idx2,
                                           idy2, idz2)
    _check(p, rhs, n_inner)
    if p.dim() != 3:
        raise ValueError(f"checkerboard p must be 3-D, got {tuple(p.shape)}")
    return _launch(RB_SOR3D_CHECKERBOARD, "rb_sor3d_checkerboard", p, rhs,
                   tuple(n - 2 for n in p.shape), n_inner, factor, idx2,
                   idy2, idz2)


def rb_sor3d_octants_plain(q, f, n_inner, factor, idx2, idy2, idz2):
    """K6's plain version: ops/sor_octants.rb_sweeps_octants, in place on
    the octants of q."""
    return rb_sweeps_octants(dict(zip(BITS, q.unbind(0))),
                             dict(zip(BITS, f.unbind(0))), n_inner, factor,
                             idx2, idy2, idz2)


def rb_sor3d_octants(q, f, n_inner, factor, idx2, idy2, idz2):
    """K6 on stacked octants q, f of shape (8, K2, J2, I2), in place on q.
    Returns Σr² of the last iteration (0-dim tensor)."""
    if q.device.type == "cpu":
        return rb_sor3d_octants_plain(q, f, n_inner, factor, idx2, idy2, idz2)
    _check(q, f, n_inner)
    if q.dim() != 4 or q.shape[0] != 8 or min(q.shape[1:]) < 2:
        raise ValueError(f"octants must be (8, K2, J2, I2), got {tuple(q.shape)}")
    return _launch(RB_SOR3D_OCTANTS, "rb_sor3d_octants", q, f,
                   tuple(q.shape[1:]), n_inner, factor, idx2, idy2, idz2)
