"""Halo-exchange debug dump (counterpart of pampi_tpu/parallel/halo_debug.py,
the reference's rank-id checker, assignment-6/src/test.c): fill every
shard's extended block with its rank id, run the real halo exchange, and
dump each ghost face to `halo-<dir>-r<rank>.txt`, so that a reader (or a
test) can see the neighbour's id in every inner ghost face and the own id
at every wall.

    python -m pampi_tpu_torch --halo-test [2|3] [--mesh 2x4] [--device cpu]

runs on `tpu_mesh auto` (one shard per visible card), or on the mesh
`--mesh` names, whose shards share the cards when they outnumber them.
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import CartComm, halo_exchange


def _faces(block, ndims):
    """(name, ghost face) pairs of an extended block: the low and high face
    per array dim, in the reference's Direction order."""
    if ndims == 2:
        return [
            ("bottom", block[0, :]),
            ("top", block[-1, :]),
            ("left", block[:, 0]),
            ("right", block[:, -1]),
        ]
    return [
        ("front", block[0, :, :]),
        ("back", block[-1, :, :]),
        ("bottom", block[:, 0, :]),
        ("top", block[:, -1, :]),
        ("left", block[:, :, 0]),
        ("right", block[:, :, -1]),
    ]


def rank_id_blocks(comm: CartComm, local_interior):
    """Fill each shard's extended block (float32) with its rank id, exchange
    every halo, and return the host blocks keyed by mesh coordinates."""
    ext = tuple(e + 2 for e in local_interior)
    blocks = [torch.full(ext, float(s), dtype=torch.float32, device=dev)
              for s, dev in enumerate(comm.devices)]
    halo_exchange(blocks, comm)
    return {comm.coords(s): b.cpu().numpy() for s, b in enumerate(blocks)}


def dump_halos(comm: CartComm, local_interior=None, outdir=".") -> list[str]:
    """Write halo-<dir>-r<rank>.txt per shard and ghost face; returns the
    paths."""
    if local_interior is None:
        local_interior = (4,) * comm.ndims
    paths = []
    for coords, blk in rank_id_blocks(comm, local_interior).items():
        rid = comm.rank(coords)
        for name, face in _faces(blk, comm.ndims):
            path = f"{outdir}/halo-{name}-r{rid}.txt"
            np.savetxt(path, np.atleast_2d(face), fmt="%5.1f")
            paths.append(path)
    return paths


def main(ndims: int, mesh: str | None, device: str) -> int:
    from ..utils.device import visible_devices

    dims = None if mesh is None else tuple(int(t) for t in mesh.split("x"))
    comm = CartComm(ndims=ndims, dims=dims, devices=visible_devices(device))
    comm.print_config()
    paths = dump_halos(comm)
    print(f"wrote {len(paths)} ghost-face dumps (halo-<dir>-r<rank>.txt)")
    return 0
