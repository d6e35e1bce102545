"""Fleet scheduler: queue -> buckets -> execution -> per-scenario results
and a fleet summary (counterpart of pampi_tpu/fleet/scheduler.py).

Modes of the port, one per bucket, recorded under `fleet_<bucket>`:

  class  a shape-class bucket (fleet/shapeclass.py, `classes="on"` or
         `"auto"`): one class template (ClassSolver for a 2-D bucket,
         Class3DSolver for a 3-D one) and one BatchedSolver advance every
         lane of the bucket together; an mg lane's V-cycle is one launch
         of K18 for the whole batch, a 2-D sor lane's step one call each
         of the class modes of K3, K2 and K4, a 3-D lane's one call each
         of the class modes of K7 and K8 around the masked class solve;
  solo   every exact-shape bucket: one solver per request, the one the
         port's CLI builds for that Parameter (cli.build_ns_solver), which
         is the JAX package's `solo` mode. The JAX package batches such
         buckets (vmap, mesh, pjit); those modes are not ported (ROADMAP A
         item 9), and the record says so.

Templates and batches are cached per scheduler: a second run() of the
same class signature and lane count reuses them (the warm path) and pays
no set-up. The summary keeps the JAX package's keys: n_scenarios, one row
a bucket (mode, lanes, compile and run walls), scenarios_per_s from the
run walls, the divergence census. Class rows also count their chunks.

Not ported (ROADMAP A item 9): continuous batching (`lanes > 0`),
per-bucket isolation (`isolate`), the autopilot hooks (`priority_of`,
`park_store`, `feed`), elastic_restore and shrink_resume, telemetry and
tracing records.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..utils import dispatch as _dispatch
from ..utils.device import resolve_device, visible_devices
from . import queue as _q
from .batch import BatchedSolver

_A9 = "not yet ported (ROADMAP A item 9)"


@dataclasses.dataclass
class ScenarioResult:
    sid: str
    bucket: str
    mode: str
    family: str
    t: float
    nt: int
    diverged: bool
    fields: tuple


@dataclasses.dataclass
class FleetResult:
    scenarios: list
    summary: dict

    def by_sid(self, sid: str) -> ScenarioResult:
        for s in self.scenarios:
            if s.sid == sid:
                return s
        raise KeyError(sid)


def _solo_fields(solver) -> tuple:
    """A solo solver's fields as reference-layout numpy arrays."""
    if hasattr(solver, "global_fields"):
        return tuple(np.asarray(a) for a in solver.global_fields().values())
    names = ("u", "v", "w", "p") if hasattr(solver, "w") else ("u", "v", "p")
    return tuple(getattr(solver, n).cpu().numpy() for n in names)


class FleetScheduler:
    """Submit requests, run the fleet. One scheduler serves many runs:
    its template and batch caches persist across run() calls.
    `device` is where every bucket runs ("cuda" by default; "cpu" runs the
    kernels' plain versions)."""

    def __init__(self, requests=None, classes: str = "off",
                 device="cuda", lanes: int = 0, isolate: bool = False):
        if classes not in ("on", "off", "auto"):
            raise ValueError(
                f"classes must be on|off|auto, got {classes!r}")
        if lanes < 0:
            raise ValueError(f"lanes must be >= 0, got {lanes}")
        if lanes > 0:
            raise NotImplementedError(
                f"continuous batching (lanes > 0) is {_A9}")
        if isolate:
            raise NotImplementedError(
                f"per-bucket isolation (isolate) is {_A9}")
        self.device = resolve_device(device)
        self.requests: list[_q.ScenarioRequest] = list(requests or [])
        self.classes = classes
        # the JAX package's autopilot hooks: setting one is refused at run()
        self.priority_of = None
        self.park_store = None
        self.feed = None
        self._templates: dict[str, object] = {}
        self._batches: dict[tuple, BatchedSolver] = {}

    def submit(self, request: _q.ScenarioRequest) -> None:
        self.requests.append(request)

    def submit_param(self, sid: str, param) -> None:
        self.submit(_q.ScenarioRequest(sid=sid, param=param))

    def elastic_restore(self, *args, **kwargs):
        raise NotImplementedError(f"elastic_restore is {_A9}")

    def shrink_resume(self, *args, **kwargs):
        raise NotImplementedError(f"shrink_resume is {_A9}")

    # -- execution ------------------------------------------------------
    def run(self, progress: bool = False) -> FleetResult:
        if any(h is not None for h in (self.priority_of, self.park_store,
                                       self.feed)):
            raise NotImplementedError(f"the autopilot hooks are {_A9}")
        if not self.requests:
            raise ValueError("fleet queue is empty")
        batch, self.requests = self.requests, []  # run() drains the queue
        buckets = _q.bucket(batch, classes=self.classes in ("on", "auto"),
                            ndevices=len(visible_devices(self.device)))
        scenarios: list[ScenarioResult] = []
        rows: list[dict] = []
        for key, reqs in buckets.items():
            row, results = self._run_bucket(key, reqs, progress)
            rows.append(row)
            scenarios += results
        run_wall = sum(r["run_wall_s"] for r in rows)
        diverged = [s.sid for s in scenarios if s.diverged]
        summary = {
            "n_scenarios": len(scenarios),
            "buckets": rows,
            "scenarios_per_s": (round(len(scenarios) / run_wall, 4)
                                if run_wall > 0 else None),
            "divergence_census": {"diverged": len(diverged),
                                  "scenarios": diverged},
        }
        return FleetResult(scenarios=scenarios, summary=summary)

    def _run_bucket(self, key, reqs, progress: bool):
        label = key.label
        if key.sig.startswith("cls"):
            mode = "class"
            _dispatch.record(
                f"fleet_{label}",
                f"class (padded {'x'.join(map(str, key.grid))}, "
                f"{len(reqs)} lanes)")
            row, results = self._run_class(key, reqs, progress)
        else:
            mode = "solo"
            _dispatch.record(
                f"fleet_{label}",
                f"solo (exact-shape bucket of {len(reqs)}: vmapped "
                f"exact-shape batches are {_A9})")
            row, results = self._run_solo(key, reqs, progress)
        row = {"bucket": label, "family": key.family,
               "grid": list(key.grid), "mode": mode, "lanes": len(reqs),
               **row}
        return row, [ScenarioResult(sid=r["sid"], bucket=label, mode=mode,
                                    family=key.family, t=r["t"],
                                    nt=r["nt"], diverged=r["diverged"],
                                    fields=r["fields"]) for r in results]

    def _run_solo(self, key, reqs, progress: bool):
        from ..cli import build_ns_solver

        build_wall = run_wall = 0.0
        results = []
        for req in reqs:
            b0 = time.perf_counter()
            solver = build_ns_solver(req.param, self.device)
            t0 = time.perf_counter()
            build_wall += t0 - b0
            solver.run(progress=progress)
            run_wall += time.perf_counter() - t0
            fields = _solo_fields(solver)
            diverged = not np.isfinite(solver.t) or not all(
                np.isfinite(f).all() for f in fields)
            results.append({"sid": req.sid, "t": float(solver.t),
                            "nt": int(solver.nt), "diverged": diverged,
                            "fields": fields})
        return {"template_cached": False,
                "compile_wall_s": round(build_wall, 3),
                "run_wall_s": round(run_wall, 4)}, results

    def _run_class(self, key, reqs, progress: bool):
        from .shapeclass import Class3DSolver, ClassSolver

        c0 = time.perf_counter()
        template = self._templates.get(key.sig)
        cached = template is not None
        if not cached:
            if key.family == "ns3d":  # grid (ic, jc, kc)
                template = Class3DSolver(reqs[0].param, ic=key.grid[0],
                                         jc=key.grid[1], kc=key.grid[2],
                                         device=self.device)
            else:
                template = ClassSolver(reqs[0].param, ic=key.grid[0],
                                       jc=key.grid[1], device=self.device)
            self._templates[key.sig] = template
        params = [r.param for r in reqs]
        sids = [r.sid for r in reqs]
        bkey = (key.sig, len(reqs))
        batched = self._batches.get(bkey)
        if batched is None:
            batched = self._batches[bkey] = BatchedSolver(template, params,
                                                          sids)
        else:
            batched.rebind(params, sids)
        build_wall = time.perf_counter() - c0
        t0 = time.perf_counter()
        final = batched.run(progress=progress)
        results = batched.results(final)
        run_wall = time.perf_counter() - t0
        return {"template_cached": cached,
                "compile_wall_s": round(build_wall, 3),
                "run_wall_s": round(run_wall, 4),
                "chunks": batched.chunks}, results
