"""The port's distributed layer (pampi_tpu_torch/parallel/comm.py,
halo_debug.py) against the JAX package's on the suite's 8-device CPU mesh:
the same numpy inputs through `shard_map` on the JAX side and through the
port's shard lists (every shard on the CPU) on the other. Exchanges and
halo dumps must agree bitwise."""

import itertools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pampi_tpu import cli as jcli
from pampi_tpu.parallel import comm as jcomm
from pampi_tpu.parallel import halo_debug as jhalo
from pampi_tpu.utils.params import Parameter as JParameter
from pampi_tpu_torch import cli
from pampi_tpu_torch.models.ns2d import NS2DSolver
from pampi_tpu_torch.parallel import comm
from pampi_tpu_torch.parallel import halo_debug
from pampi_tpu_torch.utils.dispatch import mesh_is_single
from pampi_tpu_torch.utils.params import read_parameter

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
CPU = torch.device("cpu")


def _comms(dims, **kw):
    return (jcomm.CartComm(ndims=len(dims), dims=dims, **kw),
            comm.CartComm(ndims=len(dims), dims=dims, devices=[CPU], **kw))


def _tile(blocks, dims):
    """Per-shard blocks in mesh order -> the global array shard_map takes."""
    shape = blocks[0].shape
    out = np.empty(tuple(d * e for d, e in zip(dims, shape)))
    for s, b in enumerate(blocks):
        c = np.unravel_index(s, dims)
        out[tuple(slice(ci * e, (ci + 1) * e) for ci, e in zip(c, shape))] = b
    return out


def _untile(glob, dims):
    shape = tuple(g // d for g, d in zip(glob.shape, dims))
    return [glob[tuple(slice(ci * e, (ci + 1) * e)
                       for ci, e in zip(np.unravel_index(s, dims), shape))]
            for s in range(int(np.prod(dims)))]


def _jax_exchange(jc, blocks, depth, periodic=()):
    fn = jc.shard_map(
        lambda x: jcomm.halo_exchange(x, jc, periodic=periodic, depth=depth),
        in_specs=(jc.spec(),), out_specs=jc.spec())
    out = np.asarray(jax.jit(fn)(jnp.asarray(_tile(blocks, jc.dims))))
    return _untile(out, jc.dims)


@pytest.mark.parametrize("n", range(1, 9))
def test_dims_create_matches_jax(n):
    for ndims in (1, 2, 3):
        assert comm.dims_create(n, ndims) == jcomm.dims_create(n, ndims)
    for extents in ((50, 200), (100, 100), (36, 20), (7, 64)):
        assert (comm.dims_create(n, 2, extents)
                == jcomm.dims_create(n, 2, extents))
    for extents in ((50, 50, 200), (16, 32, 8)):
        assert (comm.dims_create(n, 3, extents)
                == jcomm.dims_create(n, 3, extents))


def test_local_shape_matches_jax():
    for dims, shape in (((2, 4), (64, 64)), ((2, 3), (36, 20)),
                        ((8, 1), (8, 8)), ((1, 8), (100, 100)),
                        ((3, 2), (100, 100))):
        jc, tc = _comms(dims)
        assert tc.local_shape(shape, ragged=True) == \
            jc.local_shape(shape, ragged=True)
        try:
            want = jc.local_shape(shape)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                tc.local_shape(shape)
            assert str(got.value) == str(exc)
        else:
            assert tc.local_shape(shape) == want


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("dims,local", [((2, 4), (5, 3)), ((1, 8), (6, 1)),
                                        ((8, 1), (2, 7))])
def test_halo_exchange_matches_jax(dims, local, depth):
    """Random extended blocks, wall ghosts included; (1, 8) with owned
    width 1 below depth 2 exercises strips that cover ghosts."""
    rng = np.random.default_rng(sum(dims) + depth)
    ext = tuple(e + 2 * depth for e in local)
    blocks = [rng.standard_normal(ext) for _ in range(int(np.prod(dims)))]
    jc, tc = _comms(dims)
    want = _jax_exchange(jc, blocks, depth)
    got = comm.halo_exchange([torch.from_numpy(b.copy()) for b in blocks], tc,
                             depth=depth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("periodic", [("i",), ("j", "i")])
def test_periodic_halo_exchange_matches_jax(periodic):
    rng = np.random.default_rng(5)
    dims = (2, 4)
    blocks = [rng.standard_normal((6, 5)) for _ in range(8)]
    jc, tc = _comms(dims)
    want = _jax_exchange(jc, blocks, 1, periodic)
    got = comm.halo_exchange([torch.from_numpy(b.copy()) for b in blocks], tc,
                             periodic=periodic)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_halo_exchange_3d_matches_jax():
    rng = np.random.default_rng(3)
    dims = (2, 2, 2)
    blocks = [rng.standard_normal((6, 6, 7)) for _ in range(8)]
    jc, tc = _comms(dims)
    for depth in (1, 2):
        want = _jax_exchange(jc, blocks, depth)
        got = comm.halo_exchange([torch.from_numpy(b.copy()) for b in blocks],
                                 tc, depth=depth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dims", [(1, 2, 4), (2, 1, 1), (2, 2, 2)])
def test_halo_exchange_3d_deep_matches_jax(dims):
    """3-D blocks at depth 1 and at the fused step's depth 3, on meshes with
    extent-1 axes; owned extents of 2 below depth 3 take the read-all-
    strips-first path."""
    rng = np.random.default_rng(sum(dims))
    jc, tc = _comms(dims)
    for depth, local in ((1, (4, 3, 2)), (3, (4, 3, 2)), (3, (5, 6, 4))):
        ext = tuple(e + 2 * depth for e in local)
        blocks = [rng.standard_normal(ext) for _ in range(int(np.prod(dims)))]
        want = _jax_exchange(jc, blocks, depth)
        got = comm.halo_exchange([torch.from_numpy(b.copy()) for b in blocks],
                                 tc, depth=depth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dims", [(2, 2, 2), (1, 2, 4)])
def test_halo_shift_matches_jax(dims):
    """commShift along each axis: the low ghost strip from the minus
    neighbour's last owned strip, walls and high ghosts kept."""
    rng = np.random.default_rng(5)
    blocks = [rng.standard_normal((5, 6, 7))
              for _ in range(int(np.prod(dims)))]
    jc, tc = _comms(dims)
    for axis in ("k", "j", "i"):
        fn = jc.shard_map(lambda x, a=axis: jcomm.halo_shift(x, jc, a),
                          in_specs=(jc.spec(),), out_specs=jc.spec())
        want = _untile(np.asarray(jax.jit(fn)(
            jnp.asarray(_tile(blocks, dims)))), dims)
        got = comm.halo_shift([torch.from_numpy(b.copy()) for b in blocks],
                              tc, axis)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_embed_strip_deep_and_global_blocks_match_jax():
    """stencil2d.embed_deep/strip_deep and the reference-layout
    assemble_global/scatter_blocks against the JAX package's."""
    from pampi_tpu.parallel import stencil2d as jst
    from pampi_tpu.utils import checkpoint as jckpt
    from pampi_tpu_torch.parallel import stencil2d as st

    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 5, 6))
    deep = st.embed_deep(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(deep.numpy(),
                                  np.asarray(jst.embed_deep(x, 3)))
    np.testing.assert_array_equal(st.strip_deep(deep, 3).numpy(), x)
    dims, local = (2, 1, 2), (4, 6, 3)
    full = rng.standard_normal((10, 8, 8))
    tc = comm.CartComm(ndims=3, dims=dims, devices=[CPU])
    blocks = comm.scatter_blocks(full, tc, local)
    want = _untile(jckpt.scatter_blocks(full, dims, local), dims)
    for b, w in zip(blocks, want):
        np.testing.assert_array_equal(b, w)
    back = comm.assemble_global([torch.from_numpy(b) for b in blocks], tc,
                                (8, 6, 6))
    np.testing.assert_array_equal(back, jckpt.assemble_global(
        _tile(want, dims), dims, local, (8, 6, 6)))
    np.testing.assert_array_equal(back, full)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_reduction_matches_jax(op):
    vals = np.random.default_rng(9).standard_normal(8)
    jc, tc = _comms((2, 4))
    fn = jc.shard_map(lambda x: jcomm.reduction(x[0, 0], jc, op),
                      in_specs=(jc.spec(),), out_specs=P())
    want = float(jax.jit(fn)(jnp.asarray(vals.reshape(2, 4))))
    got = comm.reduction([torch.tensor(v) for v in vals], tc, op)
    assert got.dim() == 0
    # a sum of eight doubles in mesh order; the psum's order may differ
    np.testing.assert_allclose(float(got), want, rtol=1e-15, atol=0)
    if op == "max":
        assert float(got) == want


@pytest.mark.parametrize("dims,local", [((2, 4), (4, 4)), ((4, 2), (4, 6)),
                                        ((2, 2, 2), (2, 3, 2))])
def test_halo_dumps_byte_identical_to_jax(dims, local, tmp_path):
    jc, tc = _comms(dims)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = jhalo.dump_halos(jc, local, outdir=str(tmp_path / "jax"))
    got = halo_debug.dump_halos(tc, local, outdir=str(tmp_path / "torch"))
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("ndims,mesh", [(2, "2x4"), (3, "2x2x2")])
def test_halo_test_cli_matches_jax(ndims, mesh, tmp_path, monkeypatch,
                                   capsys):
    """`python -m pampi_tpu_torch --halo-test` on a mesh of shards sharing
    the CPU writes the bytes JAX's dump_halos writes on that mesh."""
    dims = tuple(int(t) for t in mesh.split("x"))
    (tmp_path / "jax").mkdir()
    jhalo.dump_halos(jcomm.CartComm(ndims=ndims, dims=dims),
                     outdir=str(tmp_path / "jax"))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["pampi_tpu_torch", "--halo-test", str(ndims), "--mesh",
                     mesh, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "share 1 device(s)" in out
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == np.prod(dims) * 2 * ndims
    for name in names:
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("ndevices", range(1, 9))
def test_mesh_is_single_follows_jax(ndevices, monkeypatch):
    """`auto` is single exactly when one device is visible, as
    pampi_tpu/cli.py decides; an explicit mesh is single when all ones
    (with one device the JAX package also takes an explicit mesh as
    single, where the port places its shards on that device)."""
    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * ndevices)
    for mesh in ("auto", "1", "1x1", "2x2", "1x8", "4x1"):
        ours = mesh_is_single(mesh, ndevices)
        theirs = jcli.mesh_is_single(JParameter(tpu_mesh=mesh))
        if ndevices > 1 or mesh in ("auto", "1", "1x1"):
            assert ours == theirs, mesh
        else:
            assert not ours, mesh
    assert mesh_is_single("auto", ndevices) == (ndevices == 1)
    with pytest.raises(ValueError, match="PJxPI"):
        mesh_is_single("2by2", ndevices)


@pytest.mark.parametrize("ndevices", [1, 4])
def test_cli_auto_mesh_over_visible_devices(ndevices, tmp_path, monkeypatch,
                                            capsys):
    """The CLI resolves `tpu_mesh auto` over the visible devices: with one
    it runs single-device; with four, Poisson sor and NS-2D sor run on a
    2x2 mesh, and the solves the distributed layer does not run yet
    (Poisson and NS-2D fft) run on one device with a note naming ROADMAP
    A.8. An explicit mesh for them exits with that error. The solver
    classes themselves run on the device they are given."""
    from pampi_tpu_torch.utils import device as tdevice

    monkeypatch.setattr(tdevice, "visible_devices",
                        lambda device="cuda": [CPU] * ndevices)
    monkeypatch.chdir(tmp_path)
    text = (CONFIGS / "poisson.par").read_text().replace("1000000", "40")
    for solver, mesh_run in (("sor", ndevices == 4), ("fft", False)):
        par = tmp_path / f"poisson_{solver}.par"
        par.write_text(f"{text}\ntpu_solver {solver}\n")
        assert cli.main(["pampi_tpu_torch", "--device", "cpu", str(par)]) == 0
        out = capsys.readouterr().out
        assert ("Shard 3 (1, 1): cpu" in out) == mesh_run
        assert ("ROADMAP A.8" in out) == (ndevices == 4 and solver == "fft")
        assert ("40 Walltime" if solver == "sor" else "1 Walltime") in out
    text = (CONFIGS / "dcavity.par").read_text()
    for key, value in (("imax", "16"), ("jmax", "16"), ("te", "0.1")):
        text = re.sub(rf"^{key} .*$", f"{key} {value}", text, flags=re.M)
    for mesh in ("auto", "2x2"):
        par = tmp_path / f"dcavity_{mesh}.par"
        par.write_text(re.sub(r"^tpu_mesh .*$", f"tpu_mesh {mesh}", text,
                              flags=re.M))
        rc = cli.main(["pampi_tpu_torch", "--device", "cpu", str(par)])
        out, err = capsys.readouterr()
        assert rc == 0 and "ROADMAP A.8" not in out + err
        assert ("Shard 3 (1, 1): cpu" in out) == (mesh == "2x2"
                                                  or ndevices == 4)
        fft = tmp_path / f"dcavity_fft_{mesh}.par"
        fft.write_text(par.read_text() + "\ntpu_solver fft\n")
        rc = cli.main(["pampi_tpu_torch", "--device", "cpu", str(fft)])
        out, err = capsys.readouterr()
        assert (rc, "ROADMAP A.8" in err) == ((1, True) if mesh == "2x2"
                                              else (0, False))
        assert ("ROADMAP A.8" in out) == (mesh == "auto" and ndevices == 4)
    assert NS2DSolver(read_parameter(str(tmp_path / "dcavity_auto.par")),
                      device="cpu").nt == 0
    par = tmp_path / "poisson_mg.par"
    par.write_text((CONFIGS / "poisson.par").read_text().replace(
        "tpu_mesh   auto", "tpu_mesh   2x2") + "\ntpu_solver mg\n")
    assert cli.main(["pampi_tpu_torch", "--device", "cpu", str(par)]) == 1
    assert "ROADMAP A.8" in capsys.readouterr().err


def test_placement_round_robin_and_print_config():
    cards = [torch.device("cuda", i) for i in range(4)]
    c = comm.CartComm(ndims=2, dims=(2, 3), devices=cards)
    assert c.devices == [cards[s % 4] for s in range(6)]
    assert c.shared
    c = comm.CartComm(ndims=2, devices=cards)  # auto: one shard per device
    assert c.dims == (2, 2) and c.devices == cards and not c.shared
    c = comm.CartComm(ndims=2, devices=cards, extents=(50, 200))
    assert c.dims == jcomm.dims_create(4, 2, (50, 200))
    c = comm.CartComm(ndims=2, dims=(2, 2), devices=[CPU] * 4)
    assert c.devices == [CPU] * 4 and c.is_master
    lines = []

    class Out:
        def write(self, s):
            lines.append(s)

    c.print_config(Out())
    text = "".join(lines)
    assert "Mesh dims: (2, 2) axes ('j', 'i')" in text
    assert "Shard 3 (1, 1): cpu" in text
    assert "4 shards share 1 device(s)" in text
    with pytest.raises(ValueError, match="2-D mesh"):
        comm.CartComm(ndims=2, dims=(2, 2, 2), devices=[CPU])
    with pytest.raises(ValueError, match="positive"):
        comm.CartComm(ndims=2, dims=(0, 2), devices=[CPU])


def test_coordinates_offsets_walls_and_tiers():
    c = comm.CartComm(ndims=2, dims=(2, 3), devices=[CPU])
    for s, (cj, ci) in enumerate(itertools.product(range(2), range(3))):
        assert c.coords(s) == (cj, ci) and c.rank((cj, ci)) == s
        assert c.offsets(s, (5, 4)) == (5 * cj, 4 * ci)
        assert c.is_boundary(s, "j", "lo") == (cj == 0)
        assert c.is_boundary(s, "i", "hi") == (ci == 2)
    assert c.neighbour(0, "i", -1) is None
    assert c.neighbour(0, "i", -1, periodic=True) == 2
    assert c.neighbour(1, "j", 1) == 4
    for spec in ("auto", "i=dcn", "j=dcn,i=ici"):
        assert comm.parse_mesh_tiers(spec, ("j", "i")) == \
            jcomm.parse_mesh_tiers(spec, ("j", "i"))
    for bad in ("x=dcn", "i=fast", "idcn"):
        with pytest.raises(ValueError):
            comm.parse_mesh_tiers(bad, ("j", "i"))
    assert comm.CartComm(ndims=2, dims=(2, 2), devices=[CPU],
                         tiers={"i": "dcn"}).tiers == {"j": "ici", "i": "dcn"}


def test_collect_assembles_the_global_array():
    c = comm.CartComm(ndims=2, dims=(2, 3), devices=[CPU])
    glob = np.arange(4 * 9, dtype=np.float64).reshape(4, 9)
    blocks = [torch.from_numpy(b.copy()) for b in _untile(glob, (2, 3))]
    np.testing.assert_array_equal(c.collect(blocks), glob)
