"""Gnuplot-compatible `.dat` writers and readers, in numpy.

Byte-for-byte the reference's formats (and the JAX package's writers):
 - write_matrix: the Poisson `p.dat` — the full array incl. ghost layers,
   `%f ` per value, one line per j row.
 - write_pressure / write_velocity: the NS-2D `pressure.dat` /
   `velocity.dat` at cell centres, velocity averaged from the staggered
   faces.
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().cpu()
        if x.is_floating_point() and x.element_size() == 2:
            x = x.float()  # numpy has no bfloat16; float32 holds it exactly
        x = x.numpy()
    return np.asarray(x, dtype=np.float64)


def write_matrix(p, path: str) -> None:
    """Write the full (jmax+2, imax+2) array, `%f `-formatted, row per j."""
    arr = _host(p)
    with open(path, "w") as fh:
        for row in arr:
            fh.write("".join("%f " % v for v in row))
            fh.write("\n")


def read_matrix(path: str) -> np.ndarray:
    return np.loadtxt(path)


def write_pressure(p, dx: float, dy: float, path: str) -> None:
    """x y p triples at cell centres, blank line between j rows."""
    arr = _host(p)
    jmax, imax = arr.shape[0] - 2, arr.shape[1] - 2
    with open(path, "w") as fh:
        for j in range(1, jmax + 1):
            y = (j - 0.5) * dy
            for i in range(1, imax + 1):
                x = (i - 0.5) * dx
                fh.write("%.2f %.2f %f\n" % (x, y, arr[j, i]))
            fh.write("\n")


def write_velocity(u, v, dx: float, dy: float, path: str) -> None:
    """x y u v |vel| at cell centres; u, v averaged from staggered faces."""
    ua = _host(u)
    va = _host(v)
    jmax, imax = ua.shape[0] - 2, ua.shape[1] - 2
    with open(path, "w") as fh:
        for j in range(1, jmax + 1):
            y = dy * (j - 0.5)
            for i in range(1, imax + 1):
                x = dx * (i - 0.5)
                uc = (ua[j, i] + ua[j, i - 1]) / 2.0
                vc = (va[j, i] + va[j - 1, i]) / 2.0
                ln = np.sqrt(uc * uc + vc * vc)
                fh.write("%.2f %.2f %f %f %f\n" % (x, y, uc, vc, ln))


def read_pressure(path: str) -> np.ndarray:
    """Read a pressure.dat back into a (jmax, imax) interior array."""
    rows = []
    block = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                if block:
                    rows.append(block)
                    block = []
                continue
            block.append(float(line.split()[2]))
    if block:
        rows.append(block)
    return np.array(rows)


def read_velocity(path: str):
    """Read velocity.dat -> (u_center, v_center), each (jmax, imax)."""
    data = np.loadtxt(path)
    x = data[:, 0]
    resets = np.where(np.diff(x) < 0)[0]
    imax = int(resets[0]) + 1 if len(resets) else data.shape[0]
    jmax = data.shape[0] // imax
    return data[:, 2].reshape(jmax, imax), data[:, 3].reshape(jmax, imax)
