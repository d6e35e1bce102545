"""CLI driver: `python -m pampi_tpu_torch [--device cuda|cpu] <file.par>`
(counterpart of pampi_tpu/cli.py): read the .par, echo it, run the solver
the `name` key selects, write the outputs and print the wall time.

  poisson            -> 2-D Poisson (p.dat); prints the iteration count,
                        the V-cycle count under `tpu_solver mg`, 1 under
                        `fft`
  dcavity/canal      -> NS-2D time stepper (pressure.dat, velocity.dat)
  dcavity3d/canal3d  -> NS-3D time stepper (dcavity.vtk / canal.vtk, in
                        the `tpu_vtk` format, ascii or binary)

Every problem takes `tpu_solver sor|mg|fft|auto` (auto resolves to fft on
these plain grids).

A dcavity/canal .par that configures the third dimension (kmax, zlength,
bcFront or bcBack) runs NS-3D, as in the JAX package. Other problems are
not yet ported and exit with an error naming the ROADMAP item. The device
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

_NOT_PORTED = {
    "canal_obstacle": "A.4",
}


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m pampi_tpu_torch")
    ap.add_argument("config", help="the .par configuration file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the fields live (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    args = _parse(argv[1:])
    param = read_parameter(args.config, Parameter())
    print_parameter(param)
    try:
        return _dispatch(param, args.device)
    except (NotImplementedError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1


def _dispatch(param: Parameter, device: str) -> int:
    if param.name.startswith("poisson"):
        from .models.poisson import PoissonSolver

        solver = PoissonSolver(param, problem=2, device=device)
        start = get_timestamp()
        it, _res = solver.solve()
        end = get_timestamp()
        # the reference prints "%d " and the driver appends the walltime
        print(f"{it} ", end="")
        solver.write_result("p.dat")
        print("Walltime %.2fs" % (end - start))
        return 0
    if param.name in ("dcavity", "canal", "dcavity3d", "canal3d"):
        three_d = is_3d_config(param)
        if three_d:
            from .models.ns3d import NS3DSolver

            solver = NS3DSolver(param, device=device)
        else:
            from .models.ns2d import NS2DSolver

            solver = NS2DSolver(param, device=device)
        start = get_timestamp()
        solver.run()
        end = get_timestamp()
        print("Solution took %.2fs" % (end - start))
        if three_d:
            solver.write_result(fmt=param.tpu_vtk)
        else:
            solver.write_result("pressure.dat", "velocity.dat")
        return 0
    if param.name in _NOT_PORTED:
        raise NotImplementedError(
            f"problem {param.name} is not yet ported "
            f"(ROADMAP {_NOT_PORTED[param.name]})")
    print(f"Unknown problem name: {param.name}", file=sys.stderr)
    return 1
