"""CLI driver: `python -m pampi_tpu_torch [--device cuda|cpu] <file.par>`
(counterpart of pampi_tpu/cli.py): read the .par, echo it, run the solver
the `name` key selects, write the outputs and print the wall time.

  poisson            -> 2-D Poisson (p.dat); prints the iteration count,
                        the V-cycle count under `tpu_solver mg`, 1 under
                        `fft`; on a mesh (`tpu_mesh PJxPI`, or `auto` with
                        several cards) the distributed red-black solve
  dcavity/canal/     -> NS-2D time stepper (pressure.dat, velocity.dat);
  canal_obstacle        on a mesh (`tpu_mesh PJxPI`, or `auto` with
                        several cards) the distributed time stepper, on a
                        mesh that divides the grid or a ragged one; with
                        an `obstacles` key (rectangles, e.g.
                        configs/canal_obstacle.par) the flag-masked
                        obstacle run under `tpu_solver sor` or `mg`
                        (the obstacle multigrid, one device)
  dcavity3d/canal3d  -> NS-3D time stepper (dcavity.vtk / canal.vtk, in
                        the `tpu_vtk` format: ascii, binary, or sharded,
                        the binary file written slab by slab on a mesh
                        that divides the grid);
                        on a mesh (`tpu_mesh PKxPJxPI`, or `auto` with
                        several cards) the distributed time stepper; with
                        an `obstacles` key (3-D boxes, e.g.
                        configs/canal3d_obstacle.par) the flag-masked
                        obstacle run under `tpu_solver sor`, on one
                        device or any mesh, or `mg` (the obstacle
                        multigrid, one device); a mesh need not divide
                        the grid (the ragged pad-with-mask
                        decomposition, as in the JAX package)

Every problem takes `tpu_solver sor|mg|fft|auto` (auto resolves to fft on
these plain grids, to sor on a ragged mesh, to mg on an obstacle grid,
where mg runs the obstacle multigrid, `tpu_mg_fused auto|on|off` choosing
its cycle form, and fft exits with the JAX package's error). A Poisson
.par with an `obstacles` key, and mg or fft on a mesh that does not
divide an NS-3D grid, exit with the JAX package's error.

`tpu_mesh` follows the JAX package: `auto` is one shard per visible card
(the single-device path on one card), an explicit mesh one of that shape,
whose shards share the cards when they outnumber them (parallel/comm.py).
The distributed layer runs Poisson, NS-2D and NS-3D under `tpu_solver
sor` and prints the shard placement. mg/fft on a mesh that divides the
grid (obstacle multigrid included) exit with an error naming ROADMAP A.8
on an explicit mesh; under `auto` with several cards they run on one
card, with a note.

    python -m pampi_tpu_torch --halo-test [2|3] [--mesh PJxPI] [--device cpu]

fills every shard with its rank id, exchanges the halos and writes the
ghost faces to halo-<dir>-r<rank>.txt (parallel/halo_debug.py).

A dcavity/canal .par that configures the third dimension (kmax, zlength,
bcFront or bcBack) runs NS-3D, as in the JAX package. Other problems, and
the JAX package's DMVM form `<N> <iter>` (ROADMAP A.7), are not yet
ported and exit with an error naming the ROADMAP item. The device
defaults to cuda; without a GPU the run fails unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import sys

from .utils.params import (
    Parameter,
    is_3d_config,
    print_parameter,
    read_parameter,
)
from .utils.timing import get_timestamp


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m pampi_tpu_torch")
    ap.add_argument("config", help="the .par configuration file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the fields live (default: cuda)")
    return ap.parse_args(argv)


def _halo_test(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m pampi_tpu_torch --halo-test")
    ap.add_argument("ndims", nargs="?", type=int, choices=(2, 3), default=2)
    ap.add_argument("--mesh", help="PJxPI (or PKxPJxPI); default: auto")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from .parallel.halo_debug import main as halo_main

    return halo_main(args.ndims, args.mesh, args.device)


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) > 1 and argv[1] == "--halo-test":
        return _halo_test(argv[2:])
    if len(argv) > 1 and argv[1].isdigit():
        # the JAX package's DMVM form, `<N> <iter>` (assignment-3a/3b)
        print("Error: the DMVM ring benchmark (<N> <iter>) is not yet "
              "ported (ROADMAP A.7)", file=sys.stderr)
        return 1
    args = _parse(argv[1:])
    param = read_parameter(args.config, Parameter())
    print_parameter(param)
    try:
        return _dispatch(param, args.device)
    except (NotImplementedError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1


def _make_comm(param: Parameter, devices, ndims: int = 2):
    """`tpu_mesh` -> an `ndims`-D CartComm over the visible devices, or
    None for the single-device path (pampi_tpu/cli.py _make_comm)."""
    from .utils.dispatch import mesh_dims, mesh_is_single

    if mesh_is_single(param.tpu_mesh, len(devices)):
        return None
    from .parallel.comm import CartComm

    # the grid's extents make `auto` prefer factorizations the grid divides
    extents = ((param.kmax, param.jmax, param.imax) if ndims == 3
               else (param.jmax, param.imax))
    return CartComm(ndims=ndims, dims=mesh_dims(param.tpu_mesh),
                    devices=devices, extents=extents,
                    tiers=param.tpu_mesh_tiers)


def _auto_single(param: Parameter, exc: NotImplementedError) -> None:
    """A mesh for a solve the distributed layer does not run yet: an
    explicit one fails with exc (naming ROADMAP A.8); under `auto` the solve
    takes one device, with a note, so that the configs shipped with `auto`
    run on a host with several cards as they do on one."""
    if param.tpu_mesh != "auto":
        raise exc
    print(f"tpu_mesh auto: {exc}; running on one device")


def build_ns_solver(param: Parameter, device, announce: bool = False):
    """The NS solver this CLI runs for `param` on `device`: the
    distributed one on a mesh of several shards (the mesh's banner printed
    when `announce`), else the single-device one (the fleet's solo mode
    builds its solvers here too)."""
    from .utils.device import visible_devices

    three_d = is_3d_config(param)
    comm = _make_comm(param, visible_devices(device),
                      ndims=3 if three_d else 2)
    if comm is not None:
        if three_d:
            from .models.ns3d_dist import NS3DDistSolver as Dist
        else:
            from .models.ns2d_dist import NS2DDistSolver as Dist
        try:
            solver = Dist(param, comm)
        except NotImplementedError as exc:
            _auto_single(param, exc)
        else:
            if announce:
                comm.print_config()
            return solver
    if three_d:
        from .models.ns3d import NS3DSolver

        return NS3DSolver(param, device=device)
    from .models.ns2d import NS2DSolver

    return NS2DSolver(param, device=device)


_NS_NAMES = ("dcavity", "canal", "canal_obstacle", "dcavity3d", "canal3d")


def check_knobs(param: Parameter, ns: bool) -> None:
    """The execution knobs' ranges, refused with the JAX package's own
    error lines (pampi_tpu/cli._dispatch; for the NS problems also
    utils/dispatch.resolve_fuse_phases and resolve_chunk_fuse), before any
    field is built. A K-step fused chunk (`tpu_chunk_fuse on` or a K >= 2),
    which the JAX package runs, is not ported and is refused too, naming
    its ROADMAP item."""
    if param.tpu_chunk < 0 or param.tpu_lookahead < 0:
        raise ValueError(
            "tpu_chunk and tpu_lookahead must be >= 0 "
            f"(got {param.tpu_chunk}, {param.tpu_lookahead})")
    if (param.tpu_recover_ring < 0 or param.tpu_recover_max < 1
            or not 0.0 < param.tpu_recover_dt_scale <= 1.0
            or param.tpu_retry_replenish < 0):
        raise ValueError(
            "recovery knobs out of range — need tpu_recover_ring >= 0, "
            "tpu_recover_max >= 1, 0 < tpu_recover_dt_scale <= 1, "
            "tpu_retry_replenish >= 0 (got "
            f"{param.tpu_recover_ring}, {param.tpu_recover_max}, "
            f"{param.tpu_recover_dt_scale}, {param.tpu_retry_replenish})")
    if (param.tpu_coord not in ("auto", "on", "off")
            or param.tpu_ckpt_elastic not in (0, 1)):
        raise ValueError(
            "tpu_coord must be auto|on|off and tpu_ckpt_elastic 0|1 (got "
            f"{param.tpu_coord!r}, {param.tpu_ckpt_elastic})")
    if param.tpu_coord_timeout < 0 or param.tpu_dead_resume not in (0, 1):
        raise ValueError(
            "tpu_coord_timeout must be >= 0 (seconds; 0 disables the "
            "boundary watchdog) and tpu_dead_resume 0|1 (got "
            f"{param.tpu_coord_timeout}, {param.tpu_dead_resume})")
    if not ns:
        # the JAX package's Poisson solve reads neither knob
        return
    if param.tpu_fuse_phases not in ("auto", "on", "off"):
        raise ValueError(f"tpu_fuse_phases must be auto|on|off, got "
                         f"{param.tpu_fuse_phases!r}")
    knob = param.tpu_chunk_fuse
    if knob in ("auto", "off"):
        return
    if knob != "on":
        try:
            k = int(knob)
        except ValueError:
            raise ValueError(f"tpu_chunk_fuse must be auto|on|off|<int>, "
                             f"got {knob!r}") from None
        if k < 1:
            raise ValueError(f"tpu_chunk_fuse K must be >= 1, got {k}")
        if k == 1:
            return
    raise NotImplementedError(
        f"tpu_chunk_fuse {knob}: the K-step fused chunk is not yet ported "
        "(ROADMAP A.8, item 6.2)")


def _dispatch(param: Parameter, device: str) -> int:
    from .utils.device import visible_devices

    check_knobs(param, ns=param.name in _NS_NAMES)
    if param.name.startswith("poisson"):
        from .models.poisson import PoissonSolver

        comm, solver = _make_comm(param, visible_devices(device)), None
        if comm is not None:
            from .models.poisson_dist import DistPoissonSolver

            try:
                solver = DistPoissonSolver(param, comm, problem=2)
                comm.print_config()
            except NotImplementedError as exc:
                _auto_single(param, exc)
        if solver is None:
            solver = PoissonSolver(param, problem=2, device=device)
        start = get_timestamp()
        it, _res = solver.solve()
        end = get_timestamp()
        # the reference prints "%d " and the driver appends the walltime
        print(f"{it} ", end="")
        solver.write_result("p.dat")
        print("Walltime %.2fs" % (end - start))
        return 0
    if param.name in _NS_NAMES:
        three_d = is_3d_config(param)
        solver = build_ns_solver(param, device, announce=True)
        start = get_timestamp()
        solver.run()
        end = get_timestamp()
        print("Solution took %.2fs" % (end - start))
        if not three_d:
            solver.write_result("pressure.dat", "velocity.dat")
        elif param.tpu_vtk != "sharded":
            solver.write_result(fmt=param.tpu_vtk)
        elif hasattr(solver, "write_result_sharded"):
            solver.write_result_sharded()
        else:  # one device: the binary writer gives the same bytes
            solver.write_result(fmt="binary")
        return 0
    print(f"Unknown problem name: {param.name}", file=sys.stderr)
    return 1
