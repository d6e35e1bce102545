"""The chunked time loop of the NS solvers (counterpart of the plain path of
pampi_tpu/models/_driver.py `drive_chunks`): advance in chunks of steps
while t <= te at the start of each step (the reference's main loop), update
the progress bar after every chunk, and stop on a NaN time. The JAX
package's transient retry, kernel fallback, ring recovery and coordinator
are not ported (ROADMAP A.9)."""

from __future__ import annotations


def clamped_dt(dt, scale: float):
    """The recovery dt clamp: dt itself at scale 1.0, dt·scale otherwise."""
    if scale == 1.0:
        return dt
    return dt * scale


def drive_chunks(advance, t: float, te: float, bar, chunk: int) -> float:
    """Call `advance(chunk)` (which runs up to `chunk` steps, each only
    while t <= te, and returns the new t) until t > te or t is NaN.
    Returns the final t."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    while t <= te:
        t = advance(chunk)
        if t == t:  # a NaN time ends the loop; the bar cannot draw it
            bar.update(t)
    bar.stop()
    return t


def mesh_convergence_loop(rounds, comm, dtype, cells: int, eps: float,
                          itermax: int):
    """The distributed SOR solves' convergence loop: run `rounds()` (one
    exchange and n iterations on every shard, returning the per-shard owned
    sums of r² and n) until the residual, their mesh-order sum over
    `cells`, falls below eps² or itermax iterations are done. The residual
    is read back and compared on the host in the residual's dtype
    (utils/precision.res_dtype). Returns
    (res, it)."""
    import numpy as np
    import torch

    from ..parallel.comm import master_print, reduction
    from ..utils import flags
    from ..utils.precision import res_dtype

    real = np.float64 if res_dtype(dtype) == torch.float64 else np.float32
    norm = real(cells)
    epssq = real(eps * eps)
    res, it = real(1.0), 0
    while res >= epssq and it < itermax:
        r2, n = rounds()
        res = real(float(reduction(r2, comm, "sum"))) / norm
        if flags.debug():
            master_print(comm, "{} Residuum: {}", it + n - 1, float(res))
        it += n
    return float(res), it
