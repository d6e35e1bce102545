"""Dispatch record and the port's feature gate.

`record`/`last`/`snapshot` keep a per-process record of which path each
solver took (kernel or plain version, layout, fused or ladder MG cycle,
the exchange schedule, the fleet's class and bucket decisions), like the
JAX package's `utils/dispatch.py`. `resolve_solver`, `resolve_mg_fused`,
`resolve_mg_class`, `resolve_overlap`, `resolve_overlap_restrict` and
`resolve_class` port that module's policies,
`mesh_is_single` the CLI's mesh policy. `check_supported` refuses, loudly,
every option the port does not run yet, naming the ROADMAP item that will
bring it."""

from __future__ import annotations

import math

import torch

from .params import is_3d_config
from .precision import check_direct_dtype

_RECORD: dict[str, str] = {}


def record(key: str, value: str) -> None:
    _RECORD[key] = value


def last(key: str) -> str | None:
    return _RECORD.get(key)


def snapshot() -> dict[str, str]:
    return dict(_RECORD)


_SOLVERS = ("auto", "sor", "mg", "fft", "sor_lex", "sor_rba")
_NOT_PORTED = {"sor_lex": "A.12", "sor_rba": "A.12"}


def check_solver(name: str) -> None:
    """Refuse a `tpu_solver` the port does not run: `sor_lex` and
    `sor_rba` name their ROADMAP item, anything else outside the JAX
    package's set is a ValueError."""
    if name not in _SOLVERS:
        raise ValueError(
            f"tpu_solver must be auto|sor|mg|fft|sor_lex|sor_rba, got {name!r}")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"tpu_solver {name} is not yet ported "
            f"(ROADMAP {_NOT_PORTED[name]})")


def resolve_solver(param, ragged: bool = False):
    """`tpu_solver auto` -> the solver for the run's structure, as the JAX
    package resolves it (pampi_tpu/utils/dispatch.py resolve_solver): a
    ragged distributed grid takes `sor`, a plain grid `fft` (the exact DCT
    direct solve), an obstacle grid `mg` (the obstacle multigrid, on one
    device; check_supported refuses it on a mesh). Every other value
    passes through. The
    decision is recorded under "solver_auto". Returns the param with a
    concrete solver; the models resolve through here first. A 2-D
    obstacle run under `sor_lex` gets the JAX package's ValueError (its
    NS2DSolver refuses the pair) before the unported solver is named."""
    if (param.tpu_solver == "sor_lex" and param.obstacles.strip()
            and not is_3d_config(param)
            and not param.name.startswith("poisson")):
        raise ValueError(_OBSTACLE_SOLVER_2D.format("sor_lex"))
    check_solver(param.tpu_solver)
    if param.tpu_solver != "auto":
        return param
    if ragged:
        choice, why = "sor", "ragged decomposition (mg/fft unsupported)"
    elif param.obstacles.strip():
        choice, why = "mg", "obstacles: dense-bottom MG, converged solves"
    else:
        choice, why = "fft", "plain grid: exact DCT direct solve"
    record("solver_auto", f"{choice} ({why})")
    return param.replace(tpu_solver=choice)


def sor_cadence(param, dtype, mesh: bool = False, forced: bool = False,
                clamp=None) -> int:
    """Red-black iterations between two residual checks of a SOR solve:
    the number the JAX package takes for the same dtype, layout and mesh
    when it runs on a TPU. Its Pallas kernels take dtypes of at most 4
    bytes; at float64 it steps its jnp path one iteration at a time on one
    device and `tpu_ca_inner` iterations per exchange on a mesh. So:

    - a dtype of at most 4 bytes: the kernel's depth, `tpu_sor_inner` on
      one device and max(`tpu_ca_inner`, `tpu_sor_inner`) on a mesh;
    - float64 on one device: 1;
    - float64 on a mesh: `tpu_ca_inner`, except under a layout the JAX
      package forces onto its kernel whatever the dtype (`forced`:
      `tpu_sor_layout quarters`, `octants` or, on a 2-D mesh,
      `checkerboard`), which keeps the kernel's depth.

    `clamp` bounds a mesh's depth by the shard extents (ca_clamp,
    qdist_clamp, odist_clamp)."""
    wide = dtype.itemsize > 4
    if not mesh:
        return 1 if wide else param.tpu_sor_inner
    n = (param.tpu_ca_inner if wide and not forced
         else max(param.tpu_ca_inner, param.tpu_sor_inner))
    return n if clamp is None else clamp(n)


def resolve_mg_fused(knob: str, levels, key: str) -> bool:
    """`tpu_mg_fused` -> whether an MG build runs the fused V-cycle (the
    DOWN and UP kernels of ops/mg_fused.py with the exact bottom between
    them) instead of the per-level ladder, in the JAX package's decision
    order minus its TPU-only checks: `off` and a single-level plan take
    the ladder, `auto` and `on` the fused cycle. `on` differs from `auto`
    only in the JAX package, whose `auto` also checks the TPU; the port
    takes it so that the JAX package's .par files run unchanged. The
    policy does not depend on the device: on the CPU the fused cycle runs
    the kernels' plain versions. Recorded under `key` ("mg2d_fused",
    "mg3d_fused")."""
    if knob not in ("auto", "on", "off"):
        raise ValueError(f"tpu_mg_fused must be auto|on|off, got {knob!r}")
    if knob == "off":
        record(key, "ladder (tpu_mg_fused off)")
        return False
    if len(levels) < 2:
        record(key, "ladder (single-level plan: the direct bottom solve is "
               "the whole cycle (ragged/odd or budget-truncated grid))")
        return False
    how = "forced" if knob == "on" else "auto"
    record(key, f"fused cycle ({how}; DOWN + bottom + UP, "
           f"levels={len(levels)})")
    return True


def resolve_mg_class(knob: str, lmax: int, key: str = "mg_class_fused"
                     ) -> bool:
    """`tpu_mg_fused` for the fleet's mg class lanes: whether the lane's
    solve is the one-launch class V-cycle (K18, ops/mg_fused.class_cycle).
    `off` never reaches here (fleet/shapeclass.class_eligible keeps such
    requests in their exact-shape bucket, as the JAX package does); `auto`
    and `on` both take the cycle, as resolve_mg_fused does for K9-K12. On
    a TPU the JAX package's `auto` also refuses float64 (Mosaic cannot
    lower it) and runs its rb-SOR class loop there; the port runs K18 at
    float64 too, as all its Hopper kernels do. On the CPU the cycle runs
    K18's plain version. Recorded under `key`."""
    if knob not in ("auto", "on", "off"):
        raise ValueError(f"tpu_mg_fused must be auto|on|off, got {knob!r}")
    if knob == "off":
        record(key, "refused (tpu_mg_fused off: the mg class solve is the "
               "one-launch cycle)")
        return False
    how = "forced" if knob == "on" else "auto"
    record(key, f"class cycle ({how}; K18, launches=1 a cycle, "
           f"levels<={lmax})")
    return True


def resolve_overlap(param, key: str, why_not: str | None = None) -> bool:
    """`tpu_overlap` -> whether a distributed NS build runs the overlapped
    exchange schedule (parallel/overlap.py: the PRE split into an
    interior and a boundary half, the next step's deep exchange posted
    after POST) instead of the serial exchange-then-compute step, in the
    JAX package's decision order and words (pampi_tpu/utils/dispatch.py
    resolve_overlap). `why_not` marks a build that cannot take it (the
    schedule rides the fused deep-halo step). `auto` overlaps only on a
    TPU in the JAX package; the card is not one, so `auto` records
    "serial (no TPU)" on the CPU and on the card alike; `on` forces the
    schedule. Recorded under `key` ("overlap_ns2d_dist",
    "overlap_ns3d_dist")."""
    knob = param.tpu_overlap
    if knob not in ("auto", "on", "off"):
        raise ValueError(f"tpu_overlap must be auto|on|off, got {knob!r}")
    if knob == "off":
        record(key, "serial (tpu_overlap off)")
        return False
    if why_not is not None:
        record(key, f"serial ({why_not})")
        return False
    if knob == "on":
        record(key, "overlap (forced)")
        return True
    record(key, "serial (no TPU)")
    return False


def resolve_overlap_restrict(param, key: str, plan,
                             why_not: str | None = None) -> bool:
    """`tpu_overlap_restrict` -> whether the overlapped PRE halves run in
    the grid-band mode of K3/K7 (parallel/overlap.pre_plan: the interior
    half over the interior core's rows, the boundary half over the rim's)
    instead of two full sweeps, in the JAX package's order and words
    (resolve_overlap_restrict). `plan` is the region plan (None: the
    interior region is empty). `auto` restricts where the plan's banded
    cells beat the two full sweeps, `on` forces it, `off` keeps the full
    halves. The cell counts are of the port's own layout (rows of the
    deep block in blocks of the band launch's rows, each row as wide as
    the halo-1 block's). Recorded under `key`
    ("overlap_grid_<family>")."""
    knob = param.tpu_overlap_restrict
    if knob not in ("auto", "on", "off"):
        raise ValueError(
            f"tpu_overlap_restrict must be auto|on|off, got {knob!r}")
    if knob == "off":
        record(key, "full (tpu_overlap_restrict off)")
        return False
    if why_not is not None:
        record(key, f"full ({why_not})")
        return False
    if plan is None:
        record(key, "full (interior region empty: boundary-everywhere)")
        return False
    cells, full = plan["cells"], plan["cells_full"]
    if knob == "on":
        record(key, f"restricted (forced; {cells} vs {full} cells)")
        return True
    if plan["win"]:
        record(key, f"restricted (grid plan wins: {cells} vs {full} "
                    "cells)")
        return True
    record(key, f"full (banding cannot win at this shard geometry: "
                f"{cells} vs {full} cells)")
    return False


def resolve_class(key: str, grid, why_not: str | None) -> bool:
    """Shape-class eligibility of one request, recorded per bucket (the
    JAX package's resolve_class): `key` is `class_<bucket>`, the class
    bucket's label when eligible and the exact-shape bucket's when not,
    `grid` the padded class rungs, `why_not` the
    fleet/shapeclass.class_eligible refusal. Returns whether the request
    rides a class bucket."""
    if why_not is not None:
        record(key, f"exact ({why_not})")
        return False
    record(key, f"class (padded {'x'.join(str(g) for g in grid)})")
    return True


def mesh_dims(tpu_mesh: str) -> tuple[int, ...] | None:
    """`tpu_mesh` -> the mesh's dims, None for `auto`."""
    if tpu_mesh == "auto":
        return None
    try:
        return tuple(int(t) for t in tpu_mesh.split("x"))
    except ValueError:
        raise ValueError(
            f"tpu_mesh must be auto or PJxPI, got {tpu_mesh!r}") from None


def mesh_is_single(tpu_mesh: str, ndevices: int) -> bool:
    """Whether `tpu_mesh` resolves to the single-device path with
    `ndevices` visible devices (pampi_tpu/cli.py mesh_is_single): `auto`
    builds a mesh over every device, so it is single exactly when there is
    one; an explicit mesh is single when all its dims are 1. (The JAX
    package also takes an explicit mesh as single on a one-device machine,
    where it could not place it; the port places the shards on the devices
    it has, parallel/comm.py.)"""
    dims = mesh_dims(tpu_mesh)
    return ndevices == 1 if dims is None else all(d == 1 for d in dims)


def check_supported(param, mesh: bool = False) -> None:
    """Raise NotImplementedError for every configuration outside the
    ported stacks, ValueError for a value no package takes. The port runs
    2-D and 3-D single device with the red-black SOR, multigrid and DCT
    pressure solvers, obstacle flag fields under the SOR (2-D on one
    device and on any mesh) and under the obstacle multigrid (one
    device), and on a mesh (`tpu_mesh PJxPI`, `PKxPJxPI`) under
    `tpu_solver sor` the distributed 2-D Poisson solve and the
    distributed NS-2D and NS-3D time steppers, on a mesh that divides the
    grid or not (ragged). `param` has been through resolve_solver, which
    checks `tpu_solver`; `tpu_mg_fused` is checked where an MG build
    resolves it (resolve_mg_fused). `mesh` says that the solve runs on a
    mesh (the distributed solvers pass it); otherwise only an explicit
    mesh of several shards is held to the distributed layer's reach, since
    `auto` is resolved over the visible cards by the CLI
    (cli._make_comm). A ragged mesh under mg or fft is refused by the
    distributed solvers, with the JAX package's ValueError, before this
    check."""
    if param.tpu_solver == "fft" and param.tpu_dtype in ("bfloat16", "bf16"):
        # the direct solve's refusal, before the dtype itself is refused as
        # not yet ported
        check_direct_dtype(torch.bfloat16)
    three_d = is_3d_config(param)
    dims = mesh_dims(param.tpu_mesh)
    on_mesh = mesh or (dims is not None and math.prod(dims) > 1)
    if param.obstacles.strip():
        _check_obstacles(param, three_d, on_mesh)
    if on_mesh:
        _check_mesh(param, three_d)
    # the SOR layout is checked where it is resolved
    # (models/poisson.resolve_layout, models/ns3d.resolve_layout_3d)
    if three_d and param.tpu_vtk not in ("ascii", "binary", "sharded"):
        raise ValueError(
            f"tpu_vtk must be ascii|binary|sharded, got {param.tpu_vtk!r}")
    if param.tpu_sor_inner < 1:
        raise ValueError(
            f"tpu_sor_inner must be >= 1, got {param.tpu_sor_inner}")
    if param.tpu_checkpoint or param.tpu_restart or param.tpu_recover_ring:
        raise NotImplementedError(
            "checkpoint, restart and ring recovery are not yet ported "
            "(ROADMAP A.9)")


# the JAX package's refusals of a solver that cannot take obstacle flag
# fields: its NS2DSolver's, and its NS3DSolver's and distributed solvers'
_OBSTACLE_SOLVER_2D = (
    "tpu_solver {} cannot solve obstacle flag fields (fft: non-constant "
    "coefficients; sor_lex: the lex oracle has no eps-coefficient form); "
    "use sor or mg")
_OBSTACLE_FFT = ("tpu_solver fft cannot solve obstacle flag fields (the "
                 "stencil is not constant-coefficient); use sor or mg")


def _check_obstacles(param, three_d: bool, mesh: bool) -> None:
    """Obstacle flag fields: under `tpu_solver sor` on one device and on
    any mesh, divisible or ragged; under `tpu_solver mg` (which `auto`
    resolves to on an obstacle grid) the obstacle multigrid on one
    device. The Poisson problems refuse the
    key and fft refuses the fields, each with the JAX package's ValueError
    (pampi_tpu/cli.py, models/ns2d.py, ns2d_dist.py, ns3d.py); obstacle
    multigrid on a mesh is not ported (ROADMAP A.8, item 6.4)."""
    if param.name.startswith("poisson"):
        raise ValueError("the obstacles key is supported for NS problems "
                         "only")
    if param.tpu_solver == "fft":
        raise ValueError(_OBSTACLE_SOLVER_2D.format("fft")
                         if not (three_d or mesh) else _OBSTACLE_FFT)
    if param.tpu_solver == "mg" and mesh:
        raise NotImplementedError(
            "tpu_solver mg with obstacle flag fields on a mesh: the "
            "distributed obstacle multigrid is not yet ported (ROADMAP A.8, "
            "item 6.4); use tpu_solver sor, or one device")


def _check_mesh(param, three_d: bool) -> None:
    """The distributed layer's reach, all under `tpu_solver sor`: the 2-D
    Poisson solve (models/poisson_dist.py), and the NS-2D and NS-3D time
    steppers (models/ns2d_dist.py, models/ns3d_dist.py) on any mesh, one
    that divides the grid or a ragged one; the NS steppers with the serial
    or the overlapped exchange schedule (`tpu_overlap`, resolve_overlap)
    and a fixed solve budget."""
    where = f"tpu_mesh {param.tpu_mesh}"
    ns = param.name in ("dcavity3d", "canal3d", "dcavity", "canal",
                        "canal_obstacle")
    if not (param.name.startswith("poisson") and not three_d) and not ns:
        raise NotImplementedError(
            f"{where}: the distributed {param.name} solver is not yet "
            "ported (ROADMAP A.8)")
    if param.tpu_solver in ("mg", "fft"):
        raise NotImplementedError(
            f"tpu_solver {param.tpu_solver} on a mesh: the distributed "
            "mg/fft solves are not yet ported (ROADMAP A.8)")
    if not ns:
        return
    if param.tpu_exchange_depth not in ("auto", "off"):
        raise NotImplementedError(
            f"tpu_exchange_depth {param.tpu_exchange_depth}: the K-step "
            "fused exchange schedule is not yet ported (ROADMAP A.8, item "
            "6.2)")
    if param.tpu_itermax_adaptive > 0:
        raise NotImplementedError(
            "tpu_itermax_adaptive > 0: the residual-adaptive solve budget "
            "of the distributed SOR paths is not yet ported (ROADMAP A.8, "
            "item 6.3)")
