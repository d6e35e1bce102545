"""Kernels K1 and K2: red-black SOR on the H100, each beside its plain
PyTorch version (sources: pampi_tpu_torch/csrc/sor_rb.cu).

K1 `rb_sor_quarters` replaces pampi_tpu/ops/sor_pallas.py
  `_tblock_quarters_kernel` (make_rb_iter_tblock_quarters, pallas_call at
  :964): n_inner iterations on the stacked quarter planes (4, J2, I2) =
  [R0, R1, B0, B1] of pampi_tpu_torch/ops/sor_quarters.py.
K2 `rb_sor_checkerboard` replaces pampi_tpu/ops/sor_pallas.py
  `_tblock_kernel` (make_rb_iter_tblock, plain mode, pallas_call at :620):
  the same function on the natural (jmax+2, imax+2) checkerboard.

Both update p in place and return the sum of r² over both half-sweeps of
the LAST of their n_inner iterations, as a 0-dim tensor on p's device.

What bounds them on the H100 is memory bandwidth (~10 flops per cell
update). The least any implementation must move per call is p and rhs read
once and p written once: ~60 us at 4096² f32 whatever n_inner is. The design
is simple first: a launch per colour per iteration (black sees red through
the launch boundary), a Neumann launch, per-block partial sums of r² on the
last iteration and a one-block fixed-order sum, so the residual and every
iteration count are reproducible. Each iteration therefore reads and writes
p from device memory; temporal blocking (several iterations per pass, as
the TPU kernels do) is later work.

For a CPU tensor each wrapper runs its plain version; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as kb
from .sor import checkerboard_mask, neumann_bc, sor_pass
from .sor_quarters import rb_sweeps_quarters

SOURCE = "pampi_tpu_torch/csrc/sor_rb.cu"
RB_SOR_QUARTERS = kb.register(
    "rb_sor_quarters", SOURCE, "pampi_tpu/ops/sor_pallas.py:964")
RB_SOR_CHECKERBOARD = kb.register(
    "rb_sor_checkerboard", SOURCE, "pampi_tpu/ops/sor_pallas.py:620")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SOR_ARGS = [_I, _V, _V, _I, _I, _I, _D, _D, _D, _V, _V, _V]
_SIGNATURES = {
    f"rb_sor_{layout}_{t}": _SOR_ARGS
    for layout in ("checkerboard", "quarters") for t in ("f32", "f64")
}
_SIGNATURES["rb_sor_checkerboard_partials"] = [_I, _I]
_SIGNATURES["rb_sor_quarters_partials"] = [_I, _I]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def sor_coefficients(dx: float, dy: float, omega: float):
    """(factor, idx2, idy2) of the red-black update, formed in double
    exactly as the JAX package forms them (sor_pallas.py:595)."""
    dx2, dy2 = dx * dx, dy * dy
    factor = omega * 0.5 * (dx2 * dy2) / (dx2 + dy2)
    return factor, 1.0 / dx2, 1.0 / dy2


def _check(p: torch.Tensor, rhs: torch.Tensor, n_inner: int) -> None:
    if p.device.type != "cuda":
        raise ValueError(f"SOR kernels take CPU or CUDA tensors, not {p.device}")
    if rhs.device != p.device or rhs.dtype != p.dtype or rhs.shape != p.shape:
        raise ValueError("p and rhs must share device, dtype and shape")
    if p.dtype not in _SUFFIX:
        raise ValueError(f"SOR kernels take float32 or float64, not {p.dtype}")
    if not (p.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("SOR kernels need contiguous p and rhs")
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")


def _launch(kernel, entry: str, partials: str, p, rhs, a: int, b: int,
            n_inner: int, factor: float, idx2: float, idy2: float):
    lib = kb.load("sor_rb", _SIGNATURES)
    partial = torch.empty(getattr(lib, partials)(a, b), dtype=p.dtype,
                          device=p.device)
    out = torch.empty((), dtype=p.dtype, device=p.device)
    err = getattr(lib, f"{entry}_{_SUFFIX[p.dtype]}")(
        p.device.index, p.data_ptr(), rhs.data_ptr(), a, b, n_inner,
        factor, idx2, idy2, partial.data_ptr(), out.data_ptr(),
        kb.stream_of(p))
    kb.check(lib, err, entry)
    kernel.launches += 1
    return out


def rb_sor_checkerboard_plain(p, rhs, n_inner, factor, idx2, idy2):
    """K2's plain version: n_inner (red, black, Neumann) iterations with
    ops/sor.py, in place on p."""
    jmax, imax = p.shape[0] - 2, p.shape[1] - 2
    red = checkerboard_mask(jmax, imax, 0, p.dtype, p.device)
    black = checkerboard_mask(jmax, imax, 1, p.dtype, p.device)
    for _ in range(n_inner):
        _, r0 = sor_pass(p, rhs, red, factor, idx2, idy2)
        _, r1 = sor_pass(p, rhs, black, factor, idx2, idy2)
        neumann_bc(p)
    return r0 + r1


def rb_sor_checkerboard(p, rhs, n_inner, factor, idx2, idy2):
    """K2 on a (jmax+2, imax+2) p, in place. Returns Σr² of the last
    iteration (0-dim tensor)."""
    if p.device.type == "cpu":
        return rb_sor_checkerboard_plain(p, rhs, n_inner, factor, idx2, idy2)
    _check(p, rhs, n_inner)
    if p.dim() != 2:
        raise ValueError(f"checkerboard p must be 2-D, got {tuple(p.shape)}")
    jmax, imax = p.shape[0] - 2, p.shape[1] - 2
    return _launch(RB_SOR_CHECKERBOARD, "rb_sor_checkerboard",
                   "rb_sor_checkerboard_partials", p, rhs, jmax, imax,
                   n_inner, factor, idx2, idy2)


def rb_sor_quarters_plain(q, f, n_inner, factor, idx2, idy2):
    """K1's plain version: ops/sor_quarters.rb_sweeps_quarters, in place
    on the planes of q."""
    return rb_sweeps_quarters(tuple(q.unbind(0)), tuple(f.unbind(0)),
                              n_inner, factor, idx2, idy2)


def rb_sor_quarters(q, f, n_inner, factor, idx2, idy2):
    """K1 on stacked quarters q, f of shape (4, J2, I2), in place on q.
    Returns Σr² of the last iteration (0-dim tensor)."""
    if q.device.type == "cpu":
        return rb_sor_quarters_plain(q, f, n_inner, factor, idx2, idy2)
    _check(q, f, n_inner)
    if q.dim() != 3 or q.shape[0] != 4:
        raise ValueError(f"quarters must be (4, J2, I2), got {tuple(q.shape)}")
    return _launch(RB_SOR_QUARTERS, "rb_sor_quarters",
                   "rb_sor_quarters_partials", q, f, q.shape[1], q.shape[2],
                   n_inner, factor, idx2, idy2)
