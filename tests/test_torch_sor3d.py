"""The port's 3-D red-black SOR (kernels K5 and K6 through their plain
versions on CPU tensors) against the JAX package at float64:

- K5's plain version against the checkerboard Pallas kernel in interpret
  mode (make_rb_iter_tblock_3d) and against the jnp sor_pass_3d /
  neumann_faces_3d chain, on (kmax, jmax, imax) = (10, 12, 14) and
  (7, 9, 11), with n_inner 1, 2 and 4 over three calls (the ghosts carried
  across calls);
- K6's plain version against the jnp octant oracle (sor_octants.
  rb_iter_octants) and the octant Pallas kernel in interpret mode
  (make_rb_iter_tblock_3d_octants), on even shapes;
- the octant pack/unpack round trip, the building blocks of ops/sor3d.py,
  the layout rule and the convergence loop;
- K6's capacity rule and tile plan (the on-chip design's tiles partition
  octant space; the main-path fields fit, 256³ float32 does not), and the
  on-chip residual order, which the plain version repeats, against a
  numpy loop written from the kernel's thread order.

Fields agree to 1e-12 of their scale and Σr² to 1e-12 relative: the
association of every term is the same, the sums run in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pampi_tpu.models import ns3d as jns3d
from pampi_tpu.ops import sor3d_pallas as jsp3
from pampi_tpu.ops import sor_octants as jso
from pampi_tpu_torch.models.ns3d import make_pressure_solve_3d, resolve_layout_3d
from pampi_tpu_torch.ops import sor3d
from pampi_tpu_torch.ops import sor3d_kernels as sk3
from pampi_tpu_torch.ops import sor_octants as so
from pampi_tpu_torch.utils import dispatch

TOL = 1e-12
OMEGA = 1.7


def _fields(K, J, I, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K + 2, J + 2, I + 2)),
            rng.standard_normal((K + 2, J + 2, I + 2)))


def _coef(K, J, I):
    return sor3d.sor_coefficients_3d(1.0 / I, 1.0 / J, 1.0 / K, OMEGA)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(a, b):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=TOL * scale)


def _jnp_iter(K, J, I):
    factor, idx2, idy2, idz2 = _coef(K, J, I)
    odd = jns3d.checkerboard_mask_3d(K, J, I, 1, jnp.float64)
    even = jns3d.checkerboard_mask_3d(K, J, I, 0, jnp.float64)

    def one(p, rhs):
        p, r0 = jns3d.sor_pass_3d(p, rhs, odd, factor, idx2, idy2, idz2)
        p, r1 = jns3d.sor_pass_3d(p, rhs, even, factor, idx2, idy2, idz2)
        return jns3d.neumann_faces_3d(p), r0 + r1

    return one


@pytest.mark.parametrize("shape", [(10, 12, 14), (7, 9, 11)])
@pytest.mark.parametrize("n_inner", [1, 2, 4])
def test_checkerboard_plain_matches_jax(shape, n_inner):
    K, J, I = shape
    p0, rhs = _fields(K, J, I, seed=K + n_inner)
    coef = _coef(K, J, I)
    rb, bk = jsp3.make_rb_iter_tblock_3d(I, J, K, 1.0 / I, 1.0 / J, 1.0 / K,
                                         OMEGA, jnp.float64, n_inner=n_inner,
                                         interpret=True)
    pp = jsp3.pad_array_3d(jnp.asarray(p0), bk, n_inner)
    rp = jsp3.pad_array_3d(jnp.asarray(rhs), bk, n_inner)
    one = _jnp_iter(K, J, I)
    want = jnp.asarray(p0)
    p, f = _t(p0), _t(rhs)
    for _call in range(3):
        pp, res = rb(pp, rp)
        for _ in range(n_inner):
            want, wres = one(want, jnp.asarray(rhs))
        got = sk3.rb_sor3d_checkerboard(p, f, n_inner, *coef)
        kern = jsp3.unpad_array_3d(pp, K, J, I, n_inner)
        _close(p, kern)
        _close(p, want)
        for ref in (res, wres):
            assert abs(float(got) - float(ref)) <= TOL * float(ref)


@pytest.mark.parametrize("shape", [(10, 12, 14), (8, 6, 16)])
@pytest.mark.parametrize("n_inner", [1, 3])
def test_octants_plain_matches_jax(shape, n_inner):
    K, J, I = shape
    p0, rhs = _fields(K, J, I, seed=2 * K + n_inner)
    coef = _coef(K, J, I)
    rb, bk, _h = jsp3.make_rb_iter_tblock_3d_octants(
        I, J, K, 1.0 / I, 1.0 / J, 1.0 / K, OMEGA, jnp.float64,
        n_inner=n_inner, interpret=True)
    po = jsp3.pad_octants(jnp.asarray(p0), bk, n_inner)
    ro = jsp3.pad_octants(jnp.asarray(rhs), bk, n_inner)
    octs = jso.pack_octants(jnp.asarray(p0))
    rocts = jso.pack_octants(jnp.asarray(rhs))
    q, f = so.stack_octants(_t(p0)), so.stack_octants(_t(rhs))
    for _call in range(3):
        po, res = rb(po, ro)
        for _ in range(n_inner):
            octs, wres = jso.rb_iter_octants(octs, rocts, *coef)
        got = sk3.rb_sor3d_octants(q, f, n_inner, *coef)
        p = so.unstack_octants(q)
        _close(p, jsp3.unpad_octants(po, K, J, I, n_inner))
        _close(p, jso.unpack_octants(octs))
        for ref in (res, wres):
            assert abs(float(got) - float(ref)) <= TOL * float(ref)


def test_octant_layout_round_trip_and_views():
    p, _ = _fields(6, 8, 10, seed=3)
    t = _t(p)
    q = so.stack_octants(t)
    assert q.shape == (8, 4, 5, 6) and q.is_contiguous()
    assert torch.equal(so.unstack_octants(q), t)
    assert torch.equal(so.unpack_octants(so.pack_octants(t)), t)
    joct = jso.pack_octants(jnp.asarray(p))
    for i, bits in enumerate(so.BITS):
        assert np.array_equal(q[i].numpy(), np.asarray(joct[bits]))
    assert so.BITS == jso.BITS and so.ODD == jso.ODD and so.EVEN == jso.EVEN
    for bits in so.BITS:
        assert so.interior_slices(bits) == jso.interior_slices(bits)
    # the 24 ghost copies are the JAX refresh, bitwise
    octs = dict(zip(so.BITS, q.clone().unbind(0)))
    so.neumann_bc_octants(octs)
    want = jso.neumann_bc_octants(joct)
    for bits in so.BITS:
        assert np.array_equal(octs[bits].numpy(), np.asarray(want[bits]))
    with pytest.raises(ValueError):
        so.pack_octants(torch.zeros(3, 4, 4))


def test_rb_iter_octants_on_strided_views_matches_jax():
    """One iteration in place on pack_octants' strided views of p."""
    K, J, I = 6, 8, 10
    p, rhs = _fields(K, J, I, seed=9)
    t = _t(p)
    got = so.rb_iter_octants(so.pack_octants(t), so.pack_octants(_t(rhs)),
                             *_coef(K, J, I))
    joct, want = jso.rb_iter_octants(jso.pack_octants(jnp.asarray(p)),
                                     jso.pack_octants(jnp.asarray(rhs)),
                                     *_coef(K, J, I))
    _close(t, jso.unpack_octants(joct))
    assert abs(float(got) - float(want)) <= TOL * float(want)


def test_neighbour_views_match_jax_rolls():
    p, _ = _fields(4, 6, 8, seed=4)
    octs = so.pack_octants(_t(p))
    joct = jso.pack_octants(jnp.asarray(p))
    for bits in so.BITS:
        inner = so.interior_slices(bits)
        for mine, theirs in zip(so.neighbours(octs, bits),
                                jso.neighbours(joct, bits)):
            assert np.array_equal(mine.numpy(), np.asarray(theirs)[inner])


def test_building_blocks_match_jax():
    K, J, I = 5, 6, 7
    p, rhs = _fields(K, J, I, seed=5)
    factor, idx2, idy2, idz2 = _coef(K, J, I)
    assert (factor, idx2, idy2, idz2) == jns3d.sor_coefficients_3d(
        1.0 / I, 1.0 / J, 1.0 / K, OMEGA)
    for parity in (0, 1):
        assert np.array_equal(
            sor3d.checkerboard_mask_3d(K, J, I, parity, torch.float64).numpy(),
            np.asarray(jns3d.checkerboard_mask_3d(K, J, I, parity,
                                                  jnp.float64)))
    _close(sor3d.interior_residual_3d(_t(p), _t(rhs), idx2, idy2, idz2),
           jns3d.interior_residual_3d(jnp.asarray(p), jnp.asarray(rhs), idx2,
                                      idy2, idz2))
    mask = sor3d.checkerboard_mask_3d(K, J, I, 1, torch.float64)
    tp, rsq = sor3d.sor_pass_3d(_t(p), _t(rhs), mask, factor, idx2, idy2,
                                idz2)
    jp, jrsq = jns3d.sor_pass_3d(jnp.asarray(p), jnp.asarray(rhs),
                                 jnp.asarray(mask.numpy()), factor, idx2,
                                 idy2, idz2)
    _close(tp, jp)
    assert abs(float(rsq) - float(jrsq)) <= TOL * float(jrsq)
    assert np.array_equal(sor3d.neumann_faces_3d(_t(p)).numpy(),
                          np.asarray(jns3d.neumann_faces_3d(jnp.asarray(p))))


def test_layout_rule():
    assert resolve_layout_3d(8, 10, 12) == "octants"
    assert resolve_layout_3d(8, 10, 11) == "checkerboard"
    assert resolve_layout_3d(8, 10, 12, "checkerboard") == "checkerboard"
    assert resolve_layout_3d(8, 10, 12, "octants") == "octants"
    with pytest.raises(ValueError, match="even"):
        resolve_layout_3d(8, 9, 12, "octants")
    with pytest.raises(ValueError, match="quarters is the 2-D layout"):
        resolve_layout_3d(8, 10, 12, "quarters")


@pytest.mark.parametrize("solver", ["mg", "fft"])
def test_other_solvers_refused(solver):
    """mg and fft are ported now: each builds a 3-D solve that returns a
    field and its V-cycle count (fft: it = 1) on an 8³ problem."""
    p0, rhs = _fields(8, 8, 8, seed=4)
    rhs[1:-1, 1:-1, 1:-1] -= rhs[1:-1, 1:-1, 1:-1].mean()
    solve = make_pressure_solve_3d(8, 8, 8, 0.1, 0.1, 0.1, 1.7, 1e-4, 10,
                                   torch.float64, solver=solver,
                                   device="cpu")
    p, res, it = solve(_t(p0), _t(rhs))
    assert it == 1 if solver == "fft" else it >= 1
    assert res < 1e-8 and p.shape == (10, 10, 10)
    assert bool(torch.isfinite(p).all())


def test_pressure_solve_matches_jax_jnp_loop():
    """tpu_sor_inner 1: the same iteration count, residual and field as
    the JAX jnp convergence loop (which checks every iteration)."""
    K, J, I = 9, 8, 10
    p0, rhs = _fields(K, J, I, seed=6)
    rhs[1:-1, 1:-1, 1:-1] -= rhs[1:-1, 1:-1, 1:-1].mean()
    args = (I, J, K, 1.0 / I, 1.0 / J, 1.0 / K, 1.7, 1e-3, 500)
    jp, jres, jit = jns3d.make_pressure_solve_3d(*args, jnp.float64,
                                                 backend="jnp")(
        jnp.asarray(p0), jnp.asarray(rhs))
    for layout in ("auto", "checkerboard"):
        solve = make_pressure_solve_3d(*args, torch.float64, n_inner=1,
                                       layout=layout, device="cpu")
        p, res, it = solve(_t(p0), _t(rhs))
        assert it == int(jit)
        assert abs(res - float(jres)) <= TOL * float(jres)
        _close(p, jp)


def test_wrappers_refuse_other_devices():
    z = torch.zeros(6, 6, 6, dtype=torch.float64, device="meta")
    q = torch.zeros(8, 3, 3, 3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        sk3.rb_sor3d_checkerboard(z, z, 1, 1.0, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError):
        sk3.rb_sor3d_octants(q, q, 1, 1.0, 1.0, 1.0, 1.0)


@pytest.mark.parametrize("shape,itemsize", [
    ((65, 65, 65), 4), ((26, 26, 101), 8), ((6, 7, 8), 8), ((9, 13, 17), 4),
    ((2, 2, 2), 4)])
def test_octant_tiles_partition(shape, itemsize):
    """The on-chip plan's tiles, in tile order, cover every octant index
    once; at most OCT_TILES_MAX of them, each CTA's boxes within
    SMEM_LIMIT; the geometry array is the plan's."""
    pl = sk3.octant_tiles(*shape, itemsize)
    assert pl is not None and pl.tiles <= sk3.OCT_TILES_MAX
    box = (pl.ts + 1) * (pl.tr + 1) * (pl.tc + 1)
    assert pl.smem == itemsize * (8 * box + 8 * pl.ts * pl.tr * pl.tc + 32)
    assert pl.smem <= sk3.SMEM_LIMIT
    seen = np.zeros(shape, dtype=np.int64)
    tiles = sk3.octant_tile_list(*shape, pl)
    assert len(tiles) == pl.tiles
    for s0, s1, r0, r1, c0, c1 in tiles:
        assert s1 > s0 and r1 > r0 and c1 > c0
        seen[s0:s1, r0:r1, c0:c1] += 1
    assert (seen == 1).all()
    assert list(sk3.octant_geometry(*shape, itemsize)) == [
        *shape, pl.ts, pl.tr, pl.tc, pl.ns, pl.nr, pl.nc, pl.smem]


def test_octant_capacity_rule():
    """Both NS-3D main-path fields run K6 on chip (dcavity3d.par's 128³
    float32, canal3d.par's 200x50x50 float64); 256³ float32 and 128³
    float64 exceed the card's shared memory and run the multi-launch
    design, and the record says so."""
    def octants(kmax, jmax, imax):
        return ((kmax + 2) // 2, (jmax + 2) // 2, (imax + 2) // 2)

    assert sk3.octant_tiles(*octants(128, 128, 128), 4) is not None
    assert sk3.octant_tiles(*octants(50, 50, 200), 8) is not None
    assert sk3.octant_tiles(*octants(256, 256, 256), 4) is None
    assert sk3.octant_tiles(*octants(128, 128, 128), 8) is None
    pl = sk3.octant_tiles(65, 65, 65, 4)
    assert sk3.octant_design(pl, 4) == (
        "on chip: 125 tiles of 13x13x13, one cooperative launch a call")
    assert sk3.octant_design(None, 4) == "multi-launch (13 launches a call)"
    q = torch.zeros(8, 3, 4, 5, dtype=torch.float64)
    sk3.rb_sor3d_octants(q, q.clone(), 2, 1.0, 1.0, 1.0, 1.0)
    assert dispatch.last("sor3d_octants").startswith("on chip")


def _kernel_order_sum(r2, pl):
    """The on-chip kernel's Σr², written from its thread order in numpy
    loops: per tile, thread t of nt = OCT_THREADS adds its run of c =
    ceil(8 ts tr tc / nt) cells of (slot, s, r, c) (extents ts, tr, tc;
    past the octants or off a slot's interior 0) from the first, lane 0 of
    each warp adds its lanes' sums in order, thread 0 the warp sums in
    order; then the tiles' partials in tile order."""
    nt = sk3.OCT_THREADS
    total = r2.dtype.type(0)
    for s0, _s1, r0, _r1, c0, _c1 in sk3.octant_tile_list(*r2.shape[1:], pl):
        cells = np.zeros((8, pl.ts, pl.tr, pl.tc), dtype=r2.dtype)
        for k, bits in enumerate(so.BITS):
            inner = np.zeros(r2.shape[1:], dtype=bool)
            inner[so.interior_slices(bits)] = True
            box = np.where(inner, r2[k], 0)[s0:s0 + pl.ts, r0:r0 + pl.tr,
                                             c0:c0 + pl.tc]
            cells[k, :box.shape[0], :box.shape[1], :box.shape[2]] = box
        flat = cells.reshape(-1)
        c = -(-flat.size // nt)
        part = r2.dtype.type(0)
        for w in range(nt // 32):
            wsum = r2.dtype.type(0)
            for lane in range(32):
                acc = r2.dtype.type(0)
                for e in range((w * 32 + lane) * c,
                               min(flat.size, (w * 32 + lane + 1) * c)):
                    acc = acc + flat[e]
                wsum = wsum + acc
            part = part + wsum
        total = total + part
    return total


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_octant_tile_residual_is_the_kernel_order(dtype):
    """octant_tile_residual, which the plain version uses on chip, sums in
    the kernel's stated order, bit for bit, on a plan of 128 tiles, the
    last ones sticking out of the octants on every axis, each of more
    cells than a CTA's threads (runs of several cells a thread)."""
    shape = (27, 26, 31)
    pl = sk3.octant_tiles(*shape, np.dtype(dtype).itemsize)
    assert pl.tiles > 1 and 8 * pl.ts * pl.tr * pl.tc > sk3.OCT_THREADS
    assert any(n % t for n, t in zip(shape, (pl.ts, pl.tr, pl.tc)))
    rng = np.random.default_rng(3)
    r2 = (rng.standard_normal((8, *shape)) ** 2).astype(dtype)
    got = sk3.octant_tile_residual(torch.from_numpy(r2), pl)
    assert got.item() == _kernel_order_sum(r2, pl)
