"""The overlapped exchange schedule's 3-D half (test_torch_overlap.py
holds the 2-D half and the docstring of both; the two files run on two
workers of the suite): K7's grid-band mode against the full call and JAX's
banded kernel, and NS3DDistSolver under `tpu_overlap on` against JAX's
overlapped solver and the port's own serial step, float64."""

import numpy as np
import pytest
import torch
from test_torch_overlap import (
    _B3,
    _CASES3,
    CPU,
    H,
    _check_cli,
    _check_overlap_case,
    _close,
    _regions,
    _shards,
)

from pampi_tpu.parallel import overlap as jovl
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch.ops import ns3d_fused as nf3
from pampi_tpu_torch.parallel import overlap as ovl
from pampi_tpu_torch.utils.params import Parameter


@pytest.mark.parametrize("obstacle", [False, True], ids=["plain", "flags"])
def test_banded_k7_matches_full_and_jax(obstacle):
    """K7's grid-band mode (plain version) over k-plane bands on every
    shard of a ragged 2x1x2 mesh: bitwise the full call inside the bands
    (NaN outside), within 1e-12 of JAX's banded make_fused_pre_3d on the
    region the merge takes from each half."""
    import jax.numpy as jnp
    from pampi_tpu.ops import ns3d_fused as jnf3

    from pampi_tpu_torch.ops import obstacle3d as obst3

    kw = dict(_B3, kmax=21, jmax=6, imax=10)
    if obstacle:
        kw["obstacles"] = "0.3,0.3,0.3,0.7,0.7,0.7"
    jparam, param = JParameter(**kw), Parameter(**kw)
    dims = (2, 1, 2)
    comm, gext, local = _shards(param, dims)
    mask, plan, part = _regions(local, dims)
    assert plan is not None
    cfg = nf3.StepConfig3D.from_param(param)
    masks = None
    if obstacle:
        masks = obst3.make_masks_3d(obst3.build_fluid_3d(
            param.imax, param.jmax, param.kmax, cfg.dx, cfg.dy, cfg.dz,
            param.obstacles), cfg.dx, cfg.dy, cfg.dz, param.omg)
    bk, _h, pw, nbk = jnf3.fused_deep_layout_3d(*local, jnp.float64, H - 1,
                                                masked=obstacle)
    jplan = jovl.region_plan(local, ovl.OVERLAP_RIM, H - 1, bk, nbk, pw,
                             part)
    builds = {which: jnf3.make_fused_pre_3d(
        jparam, param.kmax, param.jmax, param.imax, cfg.dx, cfg.dy, cfg.dz,
        jnp.float64, kl=local[0], jl=local[1], il=local[2], ext_pad=H - 1,
        fluid=True if obstacle else None, interpret=True,
        grid_bands=jplan[which]) for which in ("int_bands", "bnd_bands")}
    strip = (slice(H - 1, -(H - 1)),) * 3
    dt = torch.tensor(0.011, dtype=torch.float64)
    rng = np.random.default_rng(7 + obstacle)
    for s in range(comm.size):
        off = comm.offsets(s, local)
        deep = [rng.normal(size=tuple(e + 2 * H for e in local))
                for _ in range(3)]
        fl = None if masks is None else obst3.deep_flag_block_3d(
            masks, comm, s, *local, H)
        full = nf3.ns3d_pre_plain(*(torch.from_numpy(a) for a in deep), dt,
                                  cfg, off, gext, H - 1, fl)
        for which, region in (("int_bands", mask), ("bnd_bands", ~mask)):
            bands = plan[which]
            got = nf3.ns3d_pre_plain(*(torch.from_numpy(a) for a in deep),
                                     dt, cfg, off, gext, H - 1, fl,
                                     bands=bands)
            ranges = ovl.band_ranges(bands, nf3.BAND_ROWS,
                                     local[0] + 2 * H, H - 1, nf3.MAX_BANDS)
            for k, (a, b) in enumerate(zip(got[3:], full[3:])):
                rows = ovl.band_row_mask(ranges, local[0] + 2,
                                         1 if k < 3 else 0,
                                         CPU)[:, None, None].expand_as(a)
                assert torch.equal(a[rows], b[rows])
                assert torch.isnan(a[~rows]).all()
                assert rows[region].all()
            for a, b in zip(got[:3], full[:3]):
                assert torch.equal(a, b)
            pre, pad_d, unpad_d, _h = builds[which]
            extra = () if fl is None else (pad_d(fl.numpy().astype(float)),)
            jout = [np.asarray(unpad_d(a)) for a in pre(
                jnp.asarray(off, jnp.int32), jnp.full((1, 1), 0.011),
                *(pad_d(jnp.asarray(a)) for a in deep), *extra)]
            region = region.numpy()
            for a, b in zip(got[:3], jout[:3]):
                _close(a.numpy()[strip], b[strip], region)
            for a, b in zip(got[3:], jout[3:]):
                _close(a.numpy(), b[strip], region)


@pytest.mark.parametrize("case,kw,dims,three_d", _CASES3,
                         ids=[c[0] for c in _CASES3])
def test_overlap_matches_jax_and_serial_3d(case, kw, dims, three_d, capfd,
                                           monkeypatch):
    """`tpu_overlap on` on 3-D meshes, plain, ragged and obstacle, against
    JAX's overlapped solver and the port's own serial step
    (test_torch_overlap._check_overlap_case)."""
    _check_overlap_case(case, kw, dims, three_d, capfd, monkeypatch)


def test_cli_reaches_the_overlapped_step_3d(tmp_path, monkeypatch):
    """`tpu_overlap on` in configs/dcavity3d.par (8³ float64, te 0.02,
    2x2x2) through the CLI (test_torch_overlap._check_cli)."""
    _check_cli("dcavity3d.par", "imax 8\njmax 8\nkmax 8\nte 0.02\n"
               "tpu_mesh 2x2x2\ntpu_dtype float64\n", tmp_path, monkeypatch)
