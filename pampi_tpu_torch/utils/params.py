"""Run-time configuration: the `.par` key-value file format.

The same grammar as the JAX package's `pampi_tpu/utils/params.py` (the
reference's `parameter.c`): `#` starts a comment, the first whitespace token
is the key and the second the value, keys match by PREFIX (a token `imaxFoo`
still sets `imax`) except that an exact key name assigns only itself, unknown
keys are ignored, and every key has a default.

The port keeps the FULL key set of the JAX package, including the `tpu_*`
execution keys it does not act on yet: prefix matching depends on the key
set, so a smaller set would parse the same file differently (a
`tpu_chunk_fuse` line would fall through to `tpu_chunk`). Which keys the
port acts on, and which values it refuses, is decided in
`utils/dispatch.check_supported`.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass


@dataclass
class Parameter:
    # geometry
    xlength: float = 1.0
    ylength: float = 1.0
    zlength: float = 1.0
    imax: int = 100
    jmax: int = 100
    kmax: int = 50
    # pressure iteration
    itermax: int = 1000
    eps: float = 0.0001
    omg: float = 1.7
    rho: float = 0.99
    # flow
    re: float = 100.0
    tau: float = 0.5
    gamma: float = 0.9
    dt: float = 0.02
    te: float = 10.0
    gx: float = 0.0
    gy: float = 0.0
    gz: float = 0.0
    name: str = "poisson"
    bcLeft: int = 1
    bcRight: int = 1
    bcBottom: int = 1
    bcTop: int = 1
    bcFront: int = 1
    bcBack: int = 1
    u_init: float = 0.0
    v_init: float = 0.0
    w_init: float = 0.0
    p_init: float = 0.0
    obstacles: str = ""
    # execution keys (names shared with the JAX package)
    tpu_mesh: str = "auto"
    tpu_dtype: str = "float64"
    # red-black iterations per kernel call at float32, where convergence is
    # checked every tpu_sor_inner iterations (a solve may overshoot by up
    # to tpu_sor_inner-1 iterations); float64 checks every iteration on one
    # device and every tpu_ca_inner on a mesh, as the JAX package does
    # (utils/dispatch.sor_cadence)
    tpu_sor_inner: int = 4
    # auto: quarter layout on even grids, checkerboard otherwise
    tpu_sor_layout: str = "auto"
    tpu_ca_inner: int = 1
    tpu_solver: str = "sor"
    tpu_fuse_phases: str = "auto"
    tpu_overlap: str = "auto"
    tpu_overlap_restrict: str = "auto"
    tpu_mesh_tiers: str = "auto"
    tpu_itermax_adaptive: int = 0
    tpu_fleet: str = "auto"
    tpu_mg_stall_rtol: float = 1e-4
    tpu_mg_fused: str = "auto"
    # 1: every solve runs exactly ceil(itermax/tpu_sor_inner) kernel calls
    # with no residual check in between (no host sync inside the solve)
    tpu_flat_solve: int = 0
    tpu_lookahead: int = 2
    # steps per drive-loop chunk (0 = the model default)
    tpu_chunk: int = 0
    tpu_chunk_fuse: str = "auto"
    tpu_exchange_depth: str = "auto"
    tpu_vtk: str = "ascii"
    tpu_checkpoint: str = ""
    tpu_ckpt_every: int = 10
    tpu_restart: str = ""
    tpu_ckpt_elastic: int = 0
    tpu_coord: str = "auto"
    tpu_coord_timeout: float = 300.0
    tpu_dead_resume: int = 1
    tpu_autopilot: str = "off"
    tpu_recover_ring: int = 0
    tpu_recover_dt_scale: float = 0.5
    tpu_recover_max: int = 3
    tpu_retry_replenish: int = 8
    # keys explicitly present in the parsed file (not a .par key itself)
    seen_keys: tuple = ()

    def replace(self, **kw) -> "Parameter":
        return dataclasses.replace(self, **kw)


_FIELDS = {
    f.name: f.type
    for f in dataclasses.fields(Parameter)
    if f.name != "seen_keys"
}
_CASTS = {"int": int, "float": float, "str": str}


def _parse_line(line: str):
    line = line.split("#", 1)[0]
    toks = line.split()
    if len(toks) < 2:
        return None
    return toks[0], toks[1]


def read_parameter(path: str, base: Parameter | None = None) -> Parameter:
    """Parse a .par file. Prefix-match keys like the reference parser does;
    an exact key name assigns only itself."""
    param = dataclasses.replace(base) if base is not None else Parameter()
    try:
        fh = open(path)
    except OSError:
        print(f"Could not open parameter file: {path}", file=sys.stderr)
        raise SystemExit(1)
    seen = set(param.seen_keys)
    with fh:
        for raw in fh:
            kv = _parse_line(raw)
            if kv is None:
                continue
            tok, val = kv
            keys = ([tok] if tok in _FIELDS
                    else [k for k in _FIELDS if tok.startswith(k)])
            for key in keys:
                ftype = _FIELDS[key]
                cast = _CASTS[ftype if isinstance(ftype, str) else ftype.__name__]
                try:
                    setattr(param, key, cast(val))
                    seen.add(key)
                except ValueError:
                    print(
                        f"bad value {val!r} for parameter {key}", file=sys.stderr
                    )
                    raise SystemExit(1)
    param.seen_keys = tuple(sorted(seen))
    return param


def parameter_from_dict(d: dict) -> Parameter:
    """A `Parameter` from a plain dict — e.g. `dataclasses.asdict` of the
    JAX package's Parameter, so both packages start from one configuration.
    Keys the port does not know are ignored."""
    kw = {k: v for k, v in d.items() if k in _FIELDS}
    if "seen_keys" in d:
        kw["seen_keys"] = tuple(d["seen_keys"])
    return Parameter(**kw)


def is_3d_config(p: Parameter) -> bool:
    """True when the .par configures the third dimension."""
    return p.name.endswith("3d") or any(
        k in p.seen_keys for k in ("kmax", "zlength", "bcFront", "bcBack")
    )


def print_parameter(p: Parameter, out=None) -> None:
    """Echo the configuration (reference parameter.c format)."""
    out = out if out is not None else sys.stdout
    w = out.write
    three_d = is_3d_config(p)
    w(f"Parameters for {p.name}\n")
    if three_d:
        w(
            "Boundary conditions Left:%d Right:%d Bottom:%d Top:%d Front:%d "
            "Back:%d\n"
            % (p.bcLeft, p.bcRight, p.bcBottom, p.bcTop, p.bcFront, p.bcBack)
        )
    else:
        w(
            "Boundary conditions Left:%d Right:%d Bottom:%d Top:%d\n"
            % (p.bcLeft, p.bcRight, p.bcBottom, p.bcTop)
        )
    w("\tReynolds number: %.2f\n" % p.re)
    if three_d:
        w(
            "\tInit arrays: U:%.2f V:%.2f W:%.2f P:%.2f\n"
            % (p.u_init, p.v_init, p.w_init, p.p_init)
        )
    else:
        w("\tInit arrays: U:%.2f V:%.2f P:%.2f\n" % (p.u_init, p.v_init, p.p_init))
    w("Geometry data:\n")
    if three_d:
        w(
            "\tDomain box size (x, y, z): %.2f, %.2f, %.2f\n"
            % (p.xlength, p.ylength, p.zlength)
        )
        w("\tCells (x, y, z): %d, %d, %d\n" % (p.imax, p.jmax, p.kmax))
    else:
        w("\tDomain box size (x, y): %.2f, %.2f\n" % (p.xlength, p.ylength))
        w("\tCells (x, y): %d, %d\n" % (p.imax, p.jmax))
    w("Timestep parameters:\n")
    w("\tDefault stepsize: %.2f, Final time %.2f\n" % (p.dt, p.te))
    w("\tTau factor: %.2f\n" % p.tau)
    w("Iterative solver parameters:\n")
    w("\tMax iterations: %d\n" % p.itermax)
    w("\tepsilon (stopping tolerance) : %f\n" % p.eps)
    w("\tgamma factor: %f\n" % p.gamma)
    w("\tomega (SOR relaxation): %f\n" % p.omg)


def validate_obstacle_layout(layout: str) -> None:
    """Obstacle flag fields run only on the masked checkerboard kernel:
    reject a forced compressed layout instead of ignoring it (the JAX
    package's validate_obstacle_layout, with its message)."""
    if layout not in ("auto", "checkerboard"):
        raise ValueError(
            f"tpu_sor_layout {layout} does not support obstacle flag "
            "fields; obstacle runs use the masked checkerboard kernel "
            "(auto|checkerboard)"
        )
