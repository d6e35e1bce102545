"""Runtime flags, read from the environment at call time (the reference's
build-time `-D` options):

  PAMPI_DEBUG    pressure residual per convergence check, "%d Residuum: %e"
                 (one line every tpu_sor_inner iterations)
  PAMPI_VERBOSE  per-timestep "TIME %f , TIMESTEP %f" instead of the
                 progress bar
"""

from __future__ import annotations

import os


def env(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def _on(name: str) -> bool:
    return env(name) not in ("", "0")


def debug() -> bool:
    return _on("PAMPI_DEBUG")


def verbose() -> bool:
    return _on("PAMPI_VERBOSE")
