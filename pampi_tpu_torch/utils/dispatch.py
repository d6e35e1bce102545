"""Dispatch record and the port's feature gate.

`record`/`last`/`snapshot` keep a per-process record of which path each
solver took (kernel or plain version, layout), like the JAX package's
`utils/dispatch.py`. `check_supported` refuses, loudly, every option the
port does not run yet, naming the ROADMAP item that will bring it."""

from __future__ import annotations

_RECORD: dict[str, str] = {}


def record(key: str, value: str) -> None:
    _RECORD[key] = value


def last(key: str) -> str | None:
    return _RECORD.get(key)


def snapshot() -> dict[str, str]:
    return dict(_RECORD)


_SOLVER_ITEMS = {
    "fft": "A.5",
    "mg": "A.5",
    "auto": "A.5",
    "sor_lex": "A.12",
    "sor_rba": "A.12",
}


def resolve_solver(name: str) -> str:
    """`tpu_solver` -> the solver the port runs. Only `sor` is ported;
    `auto` resolves to a non-sor solver in the JAX package, so it is
    refused as well."""
    if name == "sor":
        return name
    if name in _SOLVER_ITEMS:
        raise NotImplementedError(
            f"tpu_solver {name} is not yet ported "
            f"(ROADMAP {_SOLVER_ITEMS[name]})")
    raise ValueError(
        f"tpu_solver must be auto|sor|mg|fft|sor_lex|sor_rba, got {name!r}")


def mesh_is_single(tpu_mesh: str) -> bool:
    """`auto` means one device here (the port drives one card); an
    explicit mesh must be all ones."""
    if tpu_mesh == "auto":
        return True
    try:
        return all(int(t) == 1 for t in tpu_mesh.split("x"))
    except ValueError:
        raise ValueError(
            f"tpu_mesh must be auto or PJxPI, got {tpu_mesh!r}") from None


def check_supported(param) -> None:
    """Raise NotImplementedError for every configuration outside the
    ported single-device red-black SOR stack."""
    resolve_solver(param.tpu_solver)
    if param.obstacles.strip():
        raise NotImplementedError(
            "obstacle flag fields are not yet ported (ROADMAP A.4)")
    if not mesh_is_single(param.tpu_mesh):
        raise NotImplementedError(
            f"tpu_mesh {param.tpu_mesh}: the distributed layer is not yet "
            "ported (ROADMAP A.8)")
    if param.tpu_sor_layout not in ("auto", "checkerboard", "quarters"):
        raise ValueError(
            "2-D SOR layout must be auto|checkerboard|quarters, got "
            f"{param.tpu_sor_layout!r}")
    if param.tpu_sor_inner < 1:
        raise ValueError(
            f"tpu_sor_inner must be >= 1, got {param.tpu_sor_inner}")
    if param.tpu_checkpoint or param.tpu_restart or param.tpu_recover_ring:
        raise NotImplementedError(
            "checkpoint, restart and ring recovery are not yet ported "
            "(ROADMAP A.9)")
