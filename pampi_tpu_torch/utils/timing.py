"""Monotonic wall-clock timing (reference timing.c: CLOCK_MONOTONIC)."""

import time


def get_timestamp() -> float:
    return time.monotonic()
