"""10-segment progress bar over simulated time (reference progress.c): a
`\\r`-redrawn `[####      ]` bar that redraws only when the decile changes."""

import sys


class Progress:
    def __init__(self, end: float, out=None, enabled: bool = True):
        self._end = end
        self._current = 0
        self._out = out if out is not None else sys.stdout
        self._enabled = enabled
        if enabled:
            self._out.write("[          ]")
            self._out.flush()

    def update(self, current: float) -> None:
        if not self._enabled:
            return
        new = int(round((current / self._end) * 10.0))
        if new > self._current:
            self._current = new
            bar = "#" * min(new, 10) + " " * max(10 - new, 0)
            self._out.write(f"\r[{bar}]")
        self._out.flush()

    def stop(self) -> None:
        if self._enabled:
            self._out.write("\n")
            self._out.flush()
