"""Legacy-VTK STRUCTURED_POINTS writer, ASCII and BINARY big-endian, in
numpy (counterpart of the Python path of pampi_tpu/utils/vtkio.py; the
bytes are the same).

The reference's format (assignment-6 vtkWriter.c): the header, `SCALARS
<name> double 1` + `LOOKUP_TABLE default` with one `%f` per line, `VECTORS
<name> double` with `%f %f %f` per line; in binary mode a big-endian
float64 stream ended by a newline. Values are cell-centred (ORIGIN at
dx/2), i fastest, then j, then k. `ShardedVtkWriter` writes the binary
file slab by slab, each shard's block at its own byte offsets (the JAX
package's sharded writer); the JAX package's native C writer is not
ported."""

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


class ShardedVtkWriter:
    """The MPI-IO pattern of the reference's scaffolded parallel write
    (assignment-6 vtkWriter.c:118-143), completed: each subdomain slab is
    written at the byte ranges it owns inside one shared file (a seek and a
    write per i-row, the contiguous runs a subarray filetype describes),
    with no global array assembled. BINARY only: ASCII `%f` records vary in
    width and are not offset-addressable. The bytes are those of
    VtkWriter(fmt="binary").

    Sections are written in order, as a collective write would:
        w = ShardedVtkWriter("dcavity", grid, path="out.vtk")
        w.scalar("pressure", [(slab, (k0, j0, i0)), ...])
        w.vector("velocity", [(us, vs, ws, (k0, j0, i0)), ...])
        w.close()
    """

    def __init__(self, problem: str, grid: Grid, path=None):
        self.grid = grid
        self.path = path or f"{problem}.vtk"
        header = (
            "# vtk DataFile Version 3.0\n"
            "PAMPI cfd solver output\n"
            "BINARY\n"
            "DATASET STRUCTURED_POINTS\n"
            "DIMENSIONS %d %d %d\n" % (grid.imax, grid.jmax, grid.kmax)
            + "ORIGIN %f %f %f\n" % (grid.dx * 0.5, grid.dy * 0.5,
                                     grid.dz * 0.5)
            + "SPACING %f %f %f\n" % (grid.dx, grid.dy, grid.dz)
            + "POINT_DATA %d\n" % (grid.imax * grid.jmax * grid.kmax)
        ).encode()
        # truncate: one process writes the whole file here (several hosts
        # would each open it without truncating, as the JAX writer does)
        self.fh = open(self.path, "w+b")
        self.fh.write(header)
        self._offset = len(header)  # start of the next section
        self._n = grid.imax * grid.jmax * grid.kmax

    def _write_slab(self, data_base: int, vals, origin, ncomp: int) -> None:
        """vals: (dk, dj, di[, ncomp]) big-endian float64, one seek and
        write per i-row."""
        g = self.grid
        dk, dj, di = vals.shape[:3]
        k0, j0, i0 = origin
        if not (0 <= k0 and k0 + dk <= g.kmax and 0 <= j0
                and j0 + dj <= g.jmax and 0 <= i0 and i0 + di <= g.imax):
            raise ValueError(f"slab {vals.shape[:3]} at {origin} exceeds the "
                             f"({g.kmax},{g.jmax},{g.imax}) domain")
        for k in range(dk):
            for j in range(dj):
                idx = ((k0 + k) * g.jmax + (j0 + j)) * g.imax + i0
                self.fh.seek(data_base + idx * ncomp * 8)
                self.fh.write(vals[k, j].tobytes())

    def _section(self, head: str, ncomp: int) -> int:
        """Write a section's header and its trailing newline; return where
        its data starts."""
        head = head.encode()
        self.fh.seek(self._offset)
        self.fh.write(head)
        data_base = self._offset + len(head)
        self.fh.seek(data_base + self._n * 8 * ncomp)
        self.fh.write(b"\n")
        self._offset = data_base + self._n * 8 * ncomp + 1
        return data_base

    def scalar(self, name: str, slabs) -> None:
        """slabs: iterable of (array (dk, dj, di), origin (k0, j0, i0))."""
        base = self._section(
            "SCALARS %s double 1\nLOOKUP_TABLE default\n" % name, 1)
        for arr, origin in slabs:
            vals = np.ascontiguousarray(np.asarray(arr, np.float64)
                                        .astype(">f8"))
            self._write_slab(base, vals, origin, 1)

    def vector(self, name: str, slabs) -> None:
        """slabs: iterable of (u, v, w arrays (dk, dj, di), origin)."""
        base = self._section("VECTORS %s double\n" % name, 3)
        for u, v, w, origin in slabs:
            inter = np.stack([np.asarray(a, np.float64) for a in (u, v, w)],
                             axis=-1).astype(">f8")
            self._write_slab(base, np.ascontiguousarray(inter), origin, 3)

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
