"""Flag-masked red-black SOR on a 2-D mesh (counterpart of the part of
pampi_tpu/ops/obstacle.py that the ragged NS-2D solve uses): the static
obstacle masks, the shards' deep flag blocks and the distributed
flag-masked solve.

The pressure stencil takes per-direction fluid coefficients eps_E/W/N/S in
{0, 1} in both the Laplacian and its relaxation factor omega/((eps_E +
eps_W)/dx² + (eps_N + eps_S)/dy²), so dp/dn = 0 on obstacle faces and,
away from them, the stencil is the uniform one. The ragged NS-2D solve
(models/ns2d_dist.py) runs it on all-fluid flags: a ceil-divided block's
dead cells lie outside the global interior, so the kernel's global gating
excludes them and the flags need no obstacle at all.

The obstacle geometry itself (build_fluid), the velocity BCs on obstacle
faces, the masked F/G and projection, the fluid-weighted pressure
normalisation, and the precomputed-coefficient masks and grid-space
half-sweep of the JAX package's obstacle fallback (deep_obstacle_masks,
ca_rb_iters_obstacle) wait for obstacles on a mesh (ROADMAP A.4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models._driver import mesh_convergence_loop
from ..parallel import comm as pc
from ..parallel.comm import CartComm
from ..parallel.stencil2d import (
    ca_clamp,
    ca_halo,
    ca_supported,
    deep_pad_widths,
    embed_deep,
    strip_deep,
)
from ..utils import dispatch as _dispatch
from ..utils.precision import check_eps_floor
from .sor_obsdist import ObsGeom, rb_sor_obsdist


@dataclass(frozen=True)
class ObstacleMasks:
    """The static masks of one geometry and grid: `fluid` on the full
    (J+2, I+2) array, the rest on the (J, I) interior, as numpy arrays
    (the solves cut and move them to the shards' devices)."""

    fluid: np.ndarray   # 0/1 cell is fluid (the ghost ring is fluid)
    u_face: np.ndarray  # 1 where u[j, i] is a fluid-fluid face
    v_face: np.ndarray
    p_mask: np.ndarray  # interior fluid cells (residual accounting)
    eps_e: np.ndarray   # east neighbour fluid (and the cell itself)
    eps_w: np.ndarray
    eps_n: np.ndarray
    eps_s: np.ndarray
    factor: np.ndarray  # omega / denom, 0 in obstacles (float64)
    n_fluid: float      # interior fluid cells
    omega: float


def make_masks(fluid_np: np.ndarray, dx: float, dy: float,
               omega: float) -> ObstacleMasks:
    """The masks of a boolean fluid field (jmax+2, imax+2), in float64
    numpy, as the JAX package computes them on the host."""
    f = np.asarray(fluid_np, dtype=bool)
    u_face = f & np.roll(f, -1, axis=1)
    u_face[:, -1] = True  # the roll wraps on the ghost column (fluid)
    v_face = f & np.roll(f, -1, axis=0)
    v_face[-1, :] = True
    fi = f[1:-1, 1:-1]
    eps_e = (f[1:-1, 2:] & fi).astype(np.float64)
    eps_w = (f[1:-1, :-2] & fi).astype(np.float64)
    eps_n = (f[2:, 1:-1] & fi).astype(np.float64)
    eps_s = (f[:-2, 1:-1] & fi).astype(np.float64)
    idx2, idy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    denom = (eps_e + eps_w) * idx2 + (eps_n + eps_s) * idy2
    with np.errstate(divide="ignore", invalid="ignore"):
        factor = np.where(denom > 0, omega / denom, 0.0) * fi
    return ObstacleMasks(
        fluid=f.astype(np.float64), u_face=u_face.astype(np.float64),
        v_face=v_face.astype(np.float64), p_mask=fi.astype(np.float64),
        eps_e=eps_e, eps_w=eps_w, eps_n=eps_n, eps_s=eps_s, factor=factor,
        n_fluid=float(fi.sum()), omega=float(omega))


def deep_flag_block(m: ObstacleMasks, comm: CartComm, s: int, jl: int,
                    il: int, H: int, jmax: int, imax: int, device="cpu"):
    """Shard s's (jl+2H, il+2H) deep block of the fluid flags, as uint8:
    the global flags padded with dead (0) cells, H-1 per side and the
    ragged overhang on the high side (stencil2d.deep_pad_widths), sliced
    at the shard's offsets. Identical values on every shard that holds a
    cell, so the redundant halo updates agree."""
    pw_j = deep_pad_widths(H, jl, comm.axis_size("j"), jmax)
    pw_i = deep_pad_widths(H, il, comm.axis_size("i"), imax)
    wide = np.pad(m.fluid.astype(np.uint8), [pw_j, pw_i])
    joff, ioff = comm.offsets(s, (jl, il))
    blk = wide[joff:joff + jl + 2 * H, ioff:ioff + il + 2 * H]
    return torch.from_numpy(np.ascontiguousarray(blk)).to(device)


def make_dist_obstacle_solver(comm: CartComm, imax, jmax, jl, il, dx, dy,
                              eps, itermax, m: ObstacleMasks, dtype,
                              n: int, ragged: bool = False,
                              record_key: str = "obstacle_dist"):
    """The distributed flag-masked pressure solve, communication-avoiding:
    one depth-H halo exchange (H = ca_halo(n, ragged): 2n, 2n+1 on a
    ragged mesh) buys n exact red-black iterations, which kernel K15 runs
    on every shard's deep block (ops/sor_obsdist.py; its plain version on
    CPU tensors). The residual, normalised by the global fluid-cell count,
    is checked every n iterations. `n` is the caller's cadence
    (utils/dispatch.sor_cadence); it is clamped so that the deep strips
    come from owned cells (ca_clamp, and on a ragged mesh until 2n+1 fits
    the least extent). The JAX package also halves the depth when its
    kernel overflows the TPU's VMEM; the card has no such limit on this
    kernel, so that back-off is not ported.

    Returns solve(p, rhs) -> (p, res, it) on lists of halo-1 blocks (p
    exchanged on return: the projection reads it across shard edges), with
    the cadence, the shards' geometry, deep flag blocks and offsets as
    solve.n, solve.geom, solve.flags and solve.offs (for callers that time
    or check K15 at this solve's shapes). Shards below the CA's extents
    get None: the caller runs the exchange-per-half-sweep fallback
    (parallel/stencil2d.rb_exchange_per_sweep), as the JAX package's
    NS-2D solver runs its own. The decision is recorded under record_key
    with the JAX package's labels ("pallas caN[ ragged]",
    "jnp_rb_fallback[ ragged]")."""
    check_eps_floor(eps, imax * jmax, dtype,
                    f"sor_dist_obstacle {imax}x{jmax}")
    suffix = " ragged" if ragged else ""
    if not (ca_supported(jl, il)
            and (not ragged or ca_halo(1, True) <= min(jl, il))):
        _dispatch.record(record_key, f"jnp_rb_fallback{suffix}")
        return None
    idx2, idy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    n = ca_clamp(n, jl, il)
    while ragged and n > 1 and ca_halo(n, True) > min(jl, il):
        n -= 1
    H = ca_halo(n, ragged)
    geom = ObsGeom(jmax, imax, jl, il, n, H)
    offs = [comm.offsets(s, (jl, il)) for s in range(comm.size)]
    flags = [deep_flag_block(m, comm, s, jl, il, H, jmax, imax, dev)
             for s, dev in enumerate(comm.devices)]
    _dispatch.record(record_key, f"pallas ca{n}{suffix}")

    def solve(p, rhs):
        pd = [embed_deep(x, H) for x in p]
        rd = pc.halo_exchange([embed_deep(x, H) for x in rhs], comm, depth=H)

        def rounds():
            pc.halo_exchange(pd, comm, depth=H)
            return [rb_sor_obsdist(x, f, fl, geom, o, m.omega, idx2, idy2)
                    for x, f, fl, o in zip(pd, rd, flags, offs)], n

        res, it = mesh_convergence_loop(rounds, comm, dtype, int(m.n_fluid),
                                        eps, itermax)
        p = [strip_deep(x, H).contiguous() for x in pd]
        return pc.halo_exchange(p, comm), res, it

    solve.n, solve.geom, solve.flags, solve.offs = n, geom, flags, offs
    return solve
