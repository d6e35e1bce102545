"""Scenario-fleet serving on the port (counterpart of pampi_tpu/fleet/):
many small scenarios served in buckets that share one program.

  queue.py      request intake and bucketing, the shape-class keys
  shapeclass.py shape classes: power-of-two padded rungs whose grid
                extents are per-lane data; the 2-D mg class lane, whose
                V-cycle is one launch of K18 for a whole batch, the 2-D
                sor class lane, whose step is one call each of the class
                modes of K3, K2 and K4 for a whole batch, and the 3-D sor
                class rungs (Class3DSolver), whose step is one call each of
                the class modes of K7 and K8 around the masked class solve
  batch.py      the batched runner over a class template: lanes stacked
                on a leading axis, diverged lanes retired, per-lane te
  scheduler.py  the serving front: buckets -> `class` (a class batch) or
                `solo` (one solver per request) -> results and a summary

Not ported yet (ROADMAP A item 9): vmapped exact-shape batches,
continuous batching, the mesh and pjit modes, lane faults, telemetry and
tracing, serve.py, slo.py and autopilot.py.
"""

from .batch import BatchedSolver
from .queue import (
    BucketKey,
    ScenarioRequest,
    bucket,
    bucket_key,
    class_bucket_key,
    family_of,
    knob_signature,
    load_queue,
    signature_hash,
)
from .scheduler import FleetResult, FleetScheduler, ScenarioResult
from .shapeclass import Class3DSolver, ClassSolver

__all__ = [
    "BatchedSolver",
    "BucketKey", "ScenarioRequest", "bucket", "bucket_key",
    "class_bucket_key", "family_of", "knob_signature", "load_queue",
    "signature_hash",
    "FleetResult", "FleetScheduler", "ScenarioResult",
    "Class3DSolver", "ClassSolver",
]
