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
