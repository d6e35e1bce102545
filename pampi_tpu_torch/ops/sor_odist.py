"""Kernel K14: the per-shard red-black SOR of the distributed octant
layout on the H100, beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/sor_odist.cu).

K14 `rb_sor_odist` replaces pampi_tpu/ops/sor_odist.py `_odist_kernel`
(make_rb_iters_odist, pallas_call at :264): g.n red-black iterations, each
with the globally gated Neumann wall refresh, on one shard's stacked octant
volume (8, kq, jq, iq) of parallel/octants_dist.py, in place, with the
shard's global octant offsets (koff/2, joff/2, ioff/2) as arguments.
Updates are clipped to the global interior and, on the exchanged axes, to
the stored interior (the outermost ring stays frozen); the residual is the
sum of r² of the last iteration over the shard's OWNED cells, returned as
a 0-dim tensor on q's device. On a (1, 1, 1) mesh the volume is K6's
octant array, and K14 computes what K6 computes.

Bound: memory, as K6 (q and rhs read once, q written once per call: ~11 us
for a 128³ shard at float32). The design is K6's and K13's: a launch per
colour per iteration and one for the wall refresh, per-block partial sums
of r² on the last iteration and a one-block fixed-order sum; temporal
blocking is later work.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches K14 or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as kb
from ..parallel.octants_dist import OGeom, o_masks, rb_iters_o
from .sor_kernels import _SUFFIX, _check

SOURCE = "pampi_tpu_torch/csrc/sor_odist.cu"
RB_SOR_ODIST = kb.register(
    "rb_sor_odist", SOURCE, "pampi_tpu/ops/sor_odist.py:264")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    f"rb_sor_odist_{t}": [_I, _V, _V, _V, _I, _D, _D, _D, _D, _V, _V, _V]
    for t in ("f32", "f64")
}
_SIGNATURES["rb_sor_odist_partials"] = [_I, _I, _I]


def rb_sor_odist_plain(q, f, g: OGeom, qoffs, factor, idx2, idy2, idz2):
    """K14's plain version: parallel/octants_dist.rb_iters_o, in place on
    q."""
    m = o_masks(g, *(int(o) for o in qoffs), q.device)
    out, rsq = rb_iters_o(q, f, g, m, factor, idx2, idy2, idz2)
    q.copy_(out)
    return rsq


def rb_sor_odist(q, f, g: OGeom, qoffs, factor, idx2, idy2, idz2):
    """K14 on one shard's stacked volume q, f of shape (8, g.kq, g.jq,
    g.iq), in place on q; qoffs = (koff/2, joff/2, ioff/2). Returns the
    owned Σr² of the last iteration (0-dim tensor)."""
    if q.device.type == "cpu":
        return rb_sor_odist_plain(q, f, g, qoffs, factor, idx2, idy2, idz2)
    _check(q, f, g.n)
    if tuple(q.shape) != (8, g.kq, g.jq, g.iq):
        raise ValueError(f"the volume must be (8, {g.kq}, {g.jq}, {g.iq}), "
                         f"got {tuple(q.shape)}")
    lib = kb.load("sor_odist", _SIGNATURES)
    partial = torch.empty(lib.rb_sor_odist_partials(g.kq, g.jq, g.iq),
                          dtype=q.dtype, device=q.device)
    out = torch.empty((), dtype=q.dtype, device=q.device)
    geo = (ctypes.c_int * 15)(
        g.kq, g.jq, g.iq, *g.d, g.kl // 2, g.jl // 2, g.il // 2,
        g.kmax // 2, g.jmax // 2, g.imax // 2, *(int(o) for o in qoffs))
    # the shards of a mesh lie on several cards: the launch selects q's
    # card, and the guard gives the caller its current card back
    with torch.cuda.device(q.device):
        err = getattr(lib, f"rb_sor_odist_{_SUFFIX[q.dtype]}")(
            q.device.index, q.data_ptr(), f.data_ptr(), geo, g.n, factor,
            idx2, idy2, idz2, partial.data_ptr(), out.data_ptr(),
            kb.stream_of(q))
    kb.check(lib, err, "rb_sor_odist")
    RB_SOR_ODIST.launches += 1
    return out
