"""The shape-class V-cycle of the port (ops/mg_fused.py: class_level_max,
class_level_plan, class_cycle_plain, the K18 wrapper class_cycle) against
the JAX package's (pampi_tpu/ops/mg_fused.py, make_class_cycle_2d in
interpret mode).

Contracts: the level plan bitwise (the lane dtype cast before the 4^l
division, the factor in that dtype); one cycle on lane-stacked inputs made
with numpy from a seed, in the 16² class (float64 and float32) and the
32² class (float64; each case is one interpret-mode JAX compile), lanes
of mixed live extents (a full-class lane, an odd one with a one-level
plan, one whose plan stops early): fields within 1e-12 of scale at
float64 and 2e-5 at float32 (the K9/K10 contract of
tests/test_torch_mg_fused.py; the JAX interpret kernel runs under jit,
where XLA contracts multiply-adds), the residual sum within the same
relative tolerance (it is summed in another order); an inactive lane
passes through bitwise; the wrapper refuses wrong shapes and dtypes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.ops import mg_fused as jmf
from pampi_tpu_torch.ops import mg_fused as mf

TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
# (jmax, imax) lanes per class: full, odd (one level), early stop, mixed
LANES = {16: [(16, 16), (13, 9), (12, 12), (10, 16)],
         32: [(32, 32), (30, 17), (28, 28), (32, 24)]}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_class_level_plan_bitwise(dtype):
    for jc in (16, 64, 256, 12, 48):
        for ic in (16, 32, 256):
            assert mf.class_level_max(jc, ic) == jmf.class_level_max(jc, ic)
    assert [mf.class_level_max(n, n) for n in (16, 64, 256)] == [3, 5, 7]
    for jl, il in ((12, 12), (13, 9), (16, 16), (28, 28), (30, 17),
                   (60, 60), (64, 48)):
        idx2, idy2 = float(il * il) / 0.9, float(jl * jl) / 1.3
        for lmax in (3, 5):
            ext, geo = mf.class_level_plan(jl, il, idx2, idy2, lmax, dtype)
            jext, jgeo = jmf.class_level_plan(jl, il, idx2, idy2, lmax,
                                              JDT[dtype])
            assert ext.dtype == torch.int32 and geo.dtype == dtype
            assert np.array_equal(ext.numpy(), np.asarray(jext))
            assert np.array_equal(geo.numpy(), np.asarray(jgeo))


def _lanes(cls, dtype, seed):
    """Lane-stacked class blocks: random p on each lane's live corner,
    random rhs on its interior, 0 elsewhere; with each lane's plan."""
    rng = np.random.default_rng(seed)
    lanes = LANES[cls]
    n, lmax = len(lanes), mf.class_level_max(cls, cls)
    p = np.zeros((n, cls + 2, cls + 2))
    rhs = np.zeros((n, cls + 2, cls + 2))
    plans = []
    for k, (jl, il) in enumerate(lanes):
        p[k, :jl + 2, :il + 2] = rng.normal(size=(jl + 2, il + 2))
        rhs[k, 1:jl + 1, 1:il + 1] = rng.normal(size=(jl, il))
        plans.append(mf.class_level_plan(jl, il, float(il * il),
                                          float(jl * jl), lmax, dtype))
    ext = torch.stack([e for e, _ in plans])
    geo = torch.stack([g for _, g in plans])
    return (torch.from_numpy(p).to(dtype), torch.from_numpy(rhs).to(dtype),
            ext, geo)


@pytest.fixture(scope="module")
def jax_cycles():
    """JAX's one-launch class cycle (interpret mode), one jit per class
    and dtype, shared by the cases."""
    cache = {}

    def get(cls, dtype):
        if (cls, dtype) not in cache:
            cycle, plane, _lmax = jmf.make_class_cycle_2d(
                cls, cls, JDT[dtype], interpret=True)
            cache[(cls, dtype)] = (jax.jit(cycle), plane)
        return cache[(cls, dtype)]

    return get


@pytest.mark.parametrize("cls,dtype", [(16, torch.float64),
                                       (16, torch.float32),
                                       (32, torch.float64)])
def test_class_cycle_plain_matches_jax(jax_cycles, cls, dtype):
    p, rhs, ext, geo = _lanes(cls, dtype, seed=cls)
    n = p.shape[0]
    active = torch.ones(n, dtype=torch.int32)
    out, rsq = mf.class_cycle(p, rhs, ext, geo, active)
    assert out.shape == p.shape and rsq.shape == (n,)
    cycle, plane = jax_cycles(cls, dtype)
    tol = TOL[dtype]
    for k in range(n):
        jp, jr = cycle(jmf.pad_plane(jnp.asarray(p[k].numpy()), plane),
                       jmf.pad_plane(jnp.asarray(rhs[k].numpy()), plane),
                       jnp.asarray(ext[k].numpy()),
                       jnp.asarray(geo[k].numpy()))
        ref = np.asarray(jp)[:cls + 2, :cls + 2]
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(out[k].numpy() - ref).max() / scale <= tol, (k, cls)
        assert abs(float(rsq[k]) - float(jr)) <= tol * float(jr), (k, cls)
    # the input is not modified
    assert torch.equal(p, _lanes(cls, dtype, seed=cls)[0])


def test_inactive_lane_passes_through_bitwise():
    p, rhs, ext, geo = _lanes(16, torch.float64, seed=3)
    p[1, 0, 0] = -0.0  # even a signed zero of the corner passes
    active = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    out, rsq = mf.class_cycle(p, rhs, ext, geo, active)
    for k in (1, 3):
        assert torch.equal(out[k], p[k]) and float(rsq[k]) == 0.0
        assert torch.equal(torch.signbit(out[k]), torch.signbit(p[k]))
    full, rfull = mf.class_cycle(p, rhs, ext, geo,
                                 torch.ones(4, dtype=torch.int32))
    for k in (0, 2):
        # an active lane does not depend on its batchmates
        assert torch.equal(out[k], full[k]) and rsq[k] == rfull[k]
        # cells outside its live corner keep their values
        jl, il = LANES[16][k]
        assert torch.equal(out[k, jl + 2:], p[k, jl + 2:])
        assert torch.equal(out[k, :, il + 2:], p[k, :, il + 2:])


def test_class_cycle_refuses_wrong_shapes_and_dtypes():
    p, rhs, ext, geo = _lanes(16, torch.float64, seed=5)
    act = torch.ones(4, dtype=torch.int32)
    bad = [
        (p[0], rhs, ext, geo, act),                      # not lane-stacked
        (p, rhs[:, :-1], ext, geo, act),                 # rhs shape
        (p.half(), rhs.half(), ext, geo.half(), act),    # dtype
        (p, rhs.float(), ext, geo, act),                 # mixed dtypes
        (p, rhs, ext.long(), geo, act),                  # ext dtype
        (p, rhs, ext[:, :2], geo, act),                  # lmax of the class
        (p, rhs, ext, geo.float(), act),                 # geo dtype
        (p, rhs, ext, geo, act[:3]),                     # active shape
        (p, rhs, ext, geo, act.bool()),                  # active dtype
    ]
    for args in bad:
        with pytest.raises(ValueError):
            mf.class_cycle(*args)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mf.class_cycle(p.to("meta"), rhs.to("meta"), ext.to("meta"),
                       geo.to("meta"), act.to("meta"))
