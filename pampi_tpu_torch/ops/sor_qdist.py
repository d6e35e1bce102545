"""Kernel K13: the per-shard red-black SOR of the distributed quarter
layout on the H100, beside its plain PyTorch version (source:
pampi_tpu_torch/csrc/sor_qdist.cu).

K13 `rb_sor_qdist` replaces pampi_tpu/ops/sor_qdist.py `_qdist_kernel`
(make_rb_iters_qdist, pallas_call at :249): g.n red-black iterations, each
with the globally gated Neumann wall refresh, on one shard's stacked plane
(4, jq, iq) of parallel/quarters_dist.py, in place, with the shard's global
quarter offsets (qoff_j, qoff_i) as arguments. Updates are clipped to the
plane's interior and to the global interior; the residual is the sum of r²
of the last iteration over the shard's OWNED cells (ghost cells are the
neighbours', recomputed here). Returned as a 0-dim tensor on q's device.

Bound: memory, as K1 (q and rhs read once, q written once per call: ~15 us
for a 2048² shard at float32). The design is K1's: a launch per colour per
iteration and one for the wall refresh, per-block partial sums of r² on the
last iteration and a one-block fixed-order sum; temporal blocking is later
work.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches K13 or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as kb
from ..parallel.quarters_dist import QGeom, q_masks, rb_iters_q
from .sor_kernels import _SUFFIX, _check

SOURCE = "pampi_tpu_torch/csrc/sor_qdist.cu"
RB_SOR_QDIST = kb.register(
    "rb_sor_qdist", SOURCE, "pampi_tpu/ops/sor_qdist.py:249")

_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    f"rb_sor_qdist_{t}": [_I, _V, _V] + [_I] * 9 + [_D, _D, _D, _V, _V, _V]
    for t in ("f32", "f64")
}
_SIGNATURES["rb_sor_qdist_partials"] = [_I, _I]


def rb_sor_qdist_plain(q, f, g: QGeom, qoffs, factor, idx2, idy2):
    """K13's plain version: parallel/quarters_dist.rb_iters_q, in place on
    q."""
    m = q_masks(g, int(qoffs[0]), int(qoffs[1]), q.device)
    out, rsq = rb_iters_q(q, f, g, m, factor, idx2, idy2)
    q.copy_(out)
    return rsq


def rb_sor_qdist(q, f, g: QGeom, qoffs, factor, idx2, idy2):
    """K13 on one shard's stacked plane q, f of shape (4, g.jq, g.iq), in
    place on q; qoffs = (joff/2, ioff/2). Returns the owned Σr² of the last
    iteration (0-dim tensor)."""
    if q.device.type == "cpu":
        return rb_sor_qdist_plain(q, f, g, qoffs, factor, idx2, idy2)
    _check(q, f, g.n)
    if tuple(q.shape) != (4, g.jq, g.iq):
        raise ValueError(f"the plane must be (4, {g.jq}, {g.iq}), got "
                         f"{tuple(q.shape)}")
    lib = kb.load("sor_qdist", _SIGNATURES)
    partial = torch.empty(lib.rb_sor_qdist_partials(g.jq, g.iq),
                          dtype=q.dtype, device=q.device)
    out = torch.empty((), dtype=q.dtype, device=q.device)
    # the shards of a mesh lie on several cards: the launch selects q's
    # card, and the guard gives the caller its current card back
    with torch.cuda.device(q.device):
        err = getattr(lib, f"rb_sor_qdist_{_SUFFIX[q.dtype]}")(
            q.device.index, q.data_ptr(), f.data_ptr(), g.jq, g.iq,
            g.jl // 2, g.il // 2, g.n, g.jmax // 2, g.imax // 2,
            int(qoffs[0]), int(qoffs[1]), factor, idx2, idy2,
            partial.data_ptr(), out.data_ptr(), kb.stream_of(q))
    kb.check(lib, err, "rb_sor_qdist")
    RB_SOR_QDIST.launches += 1
    return out
