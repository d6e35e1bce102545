"""dtype policy: the `tpu_dtype` .par key selects the compute precision.

The reference is double everywhere. The H100 runs float64 natively, so the
port's kernels take float32 and float64 alike. bfloat16 is the JAX
package's storage mode: Poisson and NS-2D on one device under the quarters
SOR (K1 stores bf16 and iterates in float32 inside a call; K3/K4 round
every operation to bf16), with the residual carried at `res_dtype`
(float32). Every other bfloat16 path is refused by
utils/dispatch.check_supported (ROADMAP A item 11.1)."""

from __future__ import annotations

import warnings

import numpy as np
import torch

_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "f64": torch.float64,
    "f32": torch.float32,
    "bf16": torch.bfloat16,
}


def resolve_dtype(name: str) -> torch.dtype:
    """Resolve a `tpu_dtype` .par value to the torch field dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown tpu_dtype {name!r}; expected one of "
            f"{sorted(_DTYPES)}") from None


def res_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a solve carries its residual in: the JAX package's
    promote_types(dtype, float32), float32 for bfloat16 (8 mantissa bits
    cannot hold a sum of squares) and the field dtype otherwise."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def tensor_from_array(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy of array `a` (numpy, or anything np.array takes: a JAX
    array) as a contiguous tensor of `dtype` on `device`. A bfloat16 array
    (ml_dtypes' numpy type, which torch.from_numpy refuses) is carried bit
    for bit through its 16-bit integer view."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype).contiguous()


def check_direct_dtype(dtype: torch.dtype) -> None:
    """The direct (fft) solve returns after one application, with no loop
    to absorb arithmetic error: a dtype under 32 bits is refused (the JAX
    package's _check_direct_dtype)."""
    if torch.finfo(dtype).bits < 32:
        raise ValueError(
            "tpu_solver fft needs float32/float64 (a one-shot direct solve "
            "cannot iterate bf16 error away); use sor or mg for bfloat16")


def residual_floor(ncells: int, dtype: torch.dtype) -> float:
    """The smallest residual a reduced-precision solve can tell from zero:
    machine epsilon scaled by sqrt(ncells); 0.0 for float64."""
    if dtype.is_floating_point and torch.finfo(dtype).bits < 64:
        return float(torch.finfo(dtype).eps) * float(ncells) ** 0.5
    return 0.0


def check_eps_floor(eps: float, ncells: int, dtype, where: str) -> bool:
    """Warn when a convergence `eps` sits within a decade of the dtype's
    residual floor (convergence there measures summation-order noise).
    eps <= 0 (run every solve to itermax) is always silent. Returns True
    when the warning fired."""
    floor = residual_floor(ncells, dtype)
    if not (0.0 < float(eps) < 10.0 * floor):
        return False
    warnings.warn(
        f"{where}: eps={eps:g} is within a decade of the {dtype} residual "
        f"floor (~{floor:.3g} at {ncells} cells); compare at fixed "
        "iteration counts (eps=0) instead.",
        stacklevel=3,
    )
    return True
