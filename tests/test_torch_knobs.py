"""The execution knobs' ranges (ROADMAP fault C.4): the port's CLI refuses
the values that the JAX package's CLI refuses, with the same error line and
exit code 1, before any time step. configs/dcavity.par, dcavity3d.par and
poisson.par are cut to 16² (8 k-planes), te 0.001, and each run adds one
knob line. The JAX package's Poisson solve reads neither tpu_chunk_fuse
nor tpu_fuse_phases (its CLI runs such a file), so those lines are held on
the NS problems only. A K-step fused chunk, which the port does not run,
is refused naming its ROADMAP item."""

import pathlib
import re

import pytest

from pampi_tpu import cli as jcli
from pampi_tpu_torch import cli

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
LINES = ("tpu_lookahead -1", "tpu_coord bogus", "tpu_ckpt_elastic 2",
         "tpu_coord_timeout -1", "tpu_recover_dt_scale 2")
NS_LINES = ("tpu_chunk_fuse bogus", "tpu_chunk_fuse 0",
            "tpu_fuse_phases bogus")
CASES = [(par, line) for par in ("dcavity.par", "dcavity3d.par", "poisson.par")
         for line in LINES + (NS_LINES if par != "poisson.par" else ())]


def _par(tmp_path, par, line):
    text = (CONFIGS / par).read_text()
    for key, val in (("imax", 16), ("jmax", 16), ("kmax", 8), ("te", 0.001)):
        text = re.sub(rf"^{key} .*$", f"{key} {val}", text, flags=re.M)
    path = tmp_path / par
    path.write_text(f"{text}\n{line}\n")
    return str(path)


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    err = cap.err.strip().splitlines()
    return rc, err[-1] if err else "", cap.out


@pytest.mark.parametrize("par,line", CASES)
def test_knob_refused_as_jax_refuses_it(par, line, tmp_path, monkeypatch,
                                        capsys):
    monkeypatch.chdir(tmp_path)
    path = _par(tmp_path, par, line)
    theirs = _run(jcli.main, ["pampi_tpu", path], capsys)
    ours = _run(cli.main, ["pampi_tpu_torch", "--device", "cpu", path],
                capsys)
    assert theirs[0] == ours[0] == 1
    assert theirs[1].startswith("Error: ")
    assert ours[1] == theirs[1]
    # refused before any step: nothing written, no wall time printed
    assert "Solution took" not in ours[2] and "Walltime" not in ours[2]
    assert not list(tmp_path.glob("*.dat")) and not list(
        tmp_path.glob("*.vtk"))


@pytest.mark.parametrize("par", ["dcavity.par", "dcavity3d.par"])
@pytest.mark.parametrize("value", ["on", "2"])
def test_k_step_chunk_refused_naming_its_item(par, value, tmp_path,
                                              monkeypatch, capsys):
    """`tpu_chunk_fuse on` (or a K of 2 or more) had no effect in the port;
    it is refused as `tpu_exchange_depth` is, naming A item 6.2."""
    monkeypatch.chdir(tmp_path)
    path = _par(tmp_path, par, f"tpu_chunk_fuse {value}")
    rc, err, out = _run(cli.main, ["pampi_tpu_torch", "--device", "cpu",
                                   path], capsys)
    assert rc == 1
    assert err == (f"Error: tpu_chunk_fuse {value}: the K-step fused chunk "
                   "is not yet ported (ROADMAP A.8, item 6.2)")
    assert "Solution took" not in out
