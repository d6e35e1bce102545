"""Scenario request intake and bucketing (counterpart of
pampi_tpu/fleet/queue.py).

A scenario request is one `.par`-equivalent configuration plus a scenario
id. The scheduler serves requests in BUCKETS, groups that may share one
program: the bucket key is (family, grid extents, knob-signature hash).
The knob signature is the canonical string of every Parameter field that
shapes the program; the per-lane initial-field keys (`LANE_KEYS`), the
per-lane end time (`PER_LANE_KEYS`) and drive-loop housekeeping
(`HOUSEKEEPING_KEYS`) stay out of it. The port's Parameter has the JAX
package's fields, in its order, so a request's signature and hash are the
JAX package's.

Shape classes (fleet/shapeclass.py) coarsen the key when the scheduler
enables them: eligible mixed-grid requests share one power-of-two class
bucket whose grid extents are per-lane data. Every decision is recorded
under `class_<bucket>` (utils/dispatch.resolve_class). The JAX package's
request-trace marks are not ported (ROADMAP A item 9).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

from ..utils.params import Parameter, is_3d_config, read_parameter

# per-lane state-only keys: initial field values, the sweep axis
LANE_KEYS = ("u_init", "v_init", "w_init", "p_init")

# per-lane drive keys: a batch carries them per lane
PER_LANE_KEYS = ("te",)

# drive-loop housekeeping: read by the host loop, never part of a program
HOUSEKEEPING_KEYS = (
    "tpu_checkpoint", "tpu_ckpt_every", "tpu_restart", "tpu_vtk",
    "tpu_lookahead", "tpu_retry_replenish", "tpu_recover_ring",
    "tpu_recover_dt_scale", "tpu_recover_max", "tpu_fleet",
    "tpu_autopilot", "seen_keys",
)

# the signature-excluded keys that still steer a drive loop; a batch,
# which has one loop for all its lanes, takes its first request's
DRIVE_KEYS = ("tpu_lookahead", "tpu_retry_replenish", "tpu_recover_ring",
              "tpu_recover_dt_scale", "tpu_recover_max",
              "tpu_checkpoint", "tpu_ckpt_every")


@dataclasses.dataclass
class ScenarioRequest:
    """One tenant's run request: a scenario id and its configuration."""

    sid: str
    param: Parameter


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """The shared-program equivalence class of a request."""

    family: str      # ns2d | ns3d
    grid: tuple      # (imax, jmax[, kmax]), or the class rungs
    sig: str         # knob-signature hash ("cls..." for a class bucket)

    @property
    def label(self) -> str:
        return f"{self.family}_{'x'.join(str(g) for g in self.grid)}" \
               f"_{self.sig}"


def family_of(param: Parameter) -> str:
    """ns2d / ns3d from the configuration. Poisson requests and restart
    requests are refused with the JAX package's messages: the fleet serves
    the NS time steppers, and always from the .par's initial fields."""
    if param.name == "poisson":
        raise ValueError(
            "the scenario fleet serves the NS families (dcavity/canal/"
            "canal_obstacle and the 3-D twins); run poisson configs "
            "through the CLI driver"
        )
    if param.tpu_restart:
        raise ValueError(
            "fleet requests cannot restart from a checkpoint "
            "(tpu_restart is set); run restarts through the CLI driver "
            "— fleet lanes always start from their .par initial fields"
        )
    return "ns3d" if is_3d_config(param) else "ns2d"


def knob_signature(param: Parameter) -> str:
    """Canonical string of every program-shaping Parameter field."""
    skip = set(LANE_KEYS) | set(HOUSEKEEPING_KEYS) | set(PER_LANE_KEYS)
    return "|".join(f"{f.name}={getattr(param, f.name)!r}"
                    for f in dataclasses.fields(Parameter)
                    if f.name not in skip)


def signature_hash(param: Parameter) -> str:
    return hashlib.sha1(knob_signature(param).encode()).hexdigest()[:12]


def bucket_key(param: Parameter) -> BucketKey:
    family = family_of(param)
    grid = ((param.imax, param.jmax, param.kmax) if family == "ns3d"
            else (param.imax, param.jmax))
    return BucketKey(family=family, grid=grid, sig=signature_hash(param))


_UNSET = object()


def class_bucket_key(param, why_not=_UNSET,
                     ndevices: int = 1) -> BucketKey | None:
    """The shape-class bucket of a request, or None when it keeps its
    exact-shape bucket (fleet/shapeclass.class_eligible, evaluated with
    `ndevices` visible devices unless `why_not` is given)."""
    from . import shapeclass as sc

    family = family_of(param)
    if why_not is _UNSET:
        why_not = sc.class_eligible(param, ndevices)
    if why_not is not None:
        return None
    grid = sc.class_grid(
        (param.imax, param.jmax, param.kmax) if family == "ns3d"
        else (param.imax, param.jmax))
    return BucketKey(family=family, grid=grid, sig=sc.class_sig_hash(param))


def bucket(requests, classes: bool = False, ndevices: int = 1) -> dict:
    """Group requests by bucket, in first-seen order (lanes in submit
    order). `classes=True` routes eligible requests into shape-class
    buckets and records each request's decision under `class_<bucket>`;
    an ineligible request keeps its exact-shape bucket. `ndevices` is the
    visible device count the eligibility's mesh rule reads."""
    from ..utils import dispatch as _dispatch
    from . import shapeclass as sc

    out: dict[BucketKey, list[ScenarioRequest]] = {}
    for req in requests:
        key = None
        if classes:
            why_not = sc.class_eligible(req.param, ndevices)
            key = class_bucket_key(req.param, why_not=why_not)
            label = (key if key is not None
                     else bucket_key(req.param)).label
            _dispatch.resolve_class(
                f"class_{label}",
                key.grid if key is not None else (), why_not)
        if key is None:
            key = bucket_key(req.param)
        out.setdefault(key, []).append(req)
    return out


def load_queue(paths, base: Parameter | None = None,
               on_error=None) -> list[ScenarioRequest]:
    """Read a queue of `.par` files into requests; the scenario id is the
    file stem (repeated stems get #k suffixes). `on_error(path, exc)`,
    when given, takes a malformed or unreadable file, or a request the
    fleet refuses (family_of), and the file is skipped; without it the
    error propagates. read_parameter's SystemExit on bad input counts as
    such an error."""
    reqs: list[ScenarioRequest] = []
    seen: dict[str, int] = {}
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        n = seen.get(stem, 0)
        sid = stem if n == 0 else f"{stem}#{n}"
        try:
            param = read_parameter(path, base)
            if on_error is not None:
                family_of(param)
        except (SystemExit, ValueError, OSError) as exc:
            if on_error is None:
                raise
            on_error(path, exc)
            continue
        seen[stem] = n + 1
        reqs.append(ScenarioRequest(sid=sid, param=param))
    return reqs
