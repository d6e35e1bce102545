"""Grid descriptor (counterpart of pampi_tpu/utils/grid.py): cell counts,
box lengths and the cell sizes derived from them."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Grid:
    imax: int
    jmax: int
    kmax: int = 1
    xlength: float = 1.0
    ylength: float = 1.0
    zlength: float = 1.0

    @property
    def dx(self) -> float:
        return self.xlength / self.imax

    @property
    def dy(self) -> float:
        return self.ylength / self.jmax

    @property
    def dz(self) -> float:
        return self.zlength / self.kmax
