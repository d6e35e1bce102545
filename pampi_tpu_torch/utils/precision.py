"""dtype policy: the `tpu_dtype` .par key selects the compute precision.

The reference is double everywhere. The H100 runs float64 natively, so the
port's kernels take float32 and float64 alike; the bfloat16 storage mode
of the JAX quarters kernel is not ported yet."""

from __future__ import annotations

import warnings

import torch

_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "f64": torch.float64,
    "f32": torch.float32,
}


def resolve_dtype(name: str) -> torch.dtype:
    """Resolve a `tpu_dtype` .par value to the torch compute dtype."""
    if name in ("bfloat16", "bf16"):
        raise NotImplementedError(
            "tpu_dtype bfloat16 (bf16 storage of the quarters SOR kernel) "
            "is not yet ported (ROADMAP A.12)")
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown tpu_dtype {name!r}; expected one of "
            f"{sorted(_DTYPES) + ['bfloat16']}") from None


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
