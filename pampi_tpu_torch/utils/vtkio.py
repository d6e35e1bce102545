"""Legacy-VTK STRUCTURED_POINTS writer, ASCII and BINARY big-endian, in
numpy (counterpart of the Python path of pampi_tpu/utils/vtkio.py; the
bytes are the same).

The reference's format (assignment-6 vtkWriter.c): the header, `SCALARS
<name> double 1` + `LOOKUP_TABLE default` with one `%f` per line, `VECTORS
<name> double` with `%f %f %f` per line; in binary mode a big-endian
float64 stream ended by a newline. Values are cell-centred (ORIGIN at
dx/2), i fastest, then j, then k. The JAX package's sharded writer and its
native C writer are not ported (ROADMAP A.8)."""

from __future__ import annotations

import numpy as np

from .grid import Grid


class VtkWriter:
    def __init__(self, problem: str, grid: Grid, fmt: str = "ascii",
                 path=None):
        if fmt not in ("ascii", "binary"):
            raise ValueError(f"VTK format must be ascii or binary, got {fmt!r}")
        self.grid = grid
        self.fmt = fmt
        self.path = path or f"{problem}.vtk"
        self.fh = open(self.path, "wb")
        self._header()

    def _w(self, s: str) -> None:
        self.fh.write(s.encode())

    def _header(self) -> None:
        g = self.grid
        self._w("# vtk DataFile Version 3.0\n")
        self._w("PAMPI cfd solver output\n")
        self._w("ASCII\n" if self.fmt == "ascii" else "BINARY\n")
        self._w("DATASET STRUCTURED_POINTS\n")
        self._w("DIMENSIONS %d %d %d\n" % (g.imax, g.jmax, g.kmax))
        self._w("ORIGIN %f %f %f\n" % (g.dx * 0.5, g.dy * 0.5, g.dz * 0.5))
        self._w("SPACING %f %f %f\n" % (g.dx, g.dy, g.dz))
        self._w("POINT_DATA %d\n" % (g.imax * g.jmax * g.kmax))

    def scalar(self, name: str, s) -> None:
        """s: (kmax, jmax, imax) cell-centred array."""
        arr = np.asarray(s, dtype=np.float64)
        self._w("SCALARS %s double 1\n" % name)
        self._w("LOOKUP_TABLE default\n")
        if self.fmt == "ascii":
            self._w("".join("%f\n" % val for val in arr.ravel()))
        else:
            self.fh.write(arr.astype(">f8").tobytes())
            self._w("\n")

    def vector(self, name: str, u, v, w) -> None:
        """u, v, w: (kmax, jmax, imax) cell-centred arrays."""
        uu, vv, ww = (np.asarray(a, dtype=np.float64).ravel()
                      for a in (u, v, w))
        self._w("VECTORS %s double\n" % name)
        if self.fmt == "ascii":
            self._w("".join("%f %f %f\n" % t for t in zip(uu, vv, ww)))
        else:
            self.fh.write(np.stack([uu, vv, ww], axis=1).astype(">f8")
                          .tobytes())
            self._w("\n")

    def close(self) -> None:
        self.fh.close()


def read_vtk_ascii(path: str):
    """Parse an ASCII legacy VTK file into ({name: array}, {name: (u, v,
    w)}); arrays are (kmax, jmax, imax)."""
    scalars, vectors = {}, {}
    with open(path) as fh:
        lines = fh.read().splitlines()
    dims = None
    i = 0
    while i < len(lines):
        ln = lines[i].split()
        if not ln:
            i += 1
            continue
        if ln[0] == "DIMENSIONS":
            dims = (int(ln[3]), int(ln[2]), int(ln[1]))  # (kmax, jmax, imax)
        elif ln[0] in ("SCALARS", "VECTORS"):
            ncomp = 1 if ln[0] == "SCALARS" else 3
            n = ncomp * dims[0] * dims[1] * dims[2]
            vals = []
            j = i + (2 if ncomp == 1 else 1)  # skip LOOKUP_TABLE
            while len(vals) < n:
                vals.extend(float(x) for x in lines[j].split())
                j += 1
            if ncomp == 1:
                scalars[ln[1]] = np.array(vals).reshape(dims)
            else:
                arr = np.array(vals).reshape(-1, 3)
                vectors[ln[1]] = tuple(arr[:, c].reshape(dims)
                                       for c in range(3))
            i = j - 1
        i += 1
    return scalars, vectors
