"""Batched runner: N same-class scenarios advanced together (counterpart
of pampi_tpu/fleet/batch.py over a shape-class template).

The JAX package vmaps its template's chunk over a leading scenario axis;
here the lanes are stacked on that axis explicitly and the class template
(fleet/shapeclass.ClassSolver, Class3DSolver) steps them all at once. The
state mirrors the JAX package's class batch, so a JAX state converted to
numpy continues here (`from_numpy_state`):

    (fields..., t, nt, gm, te, active, t_drive, nt_drive)

the template's `n_fields` lane-stacked fields, (u, v, p) of shape (N,
jc+2, ic+2) for a 2-D class and (u, v, w, p) of shape (N, kc+2, jc+2,
ic+2) for a 3-D one; t (N,) float64; nt (N,) int32; gm the lanes'
geometry vectors ((N, 9) or (N, 12)); te (N,) each lane's end time (class
templates always carry it, so mixed end times share a batch); active (N,)
bool; t_drive, the minimum t over the lanes still running (+inf once none
is), and nt_drive, the largest nt, are what the host loop reads.

After each chunk a lane whose t or fields are no longer finite is
retired: `active` drops and the lane is not stepped again, so it keeps
the state of the chunk it diverged in while its batchmates go on
unchanged (the JAX package freezes it with where(active, new, old); its
in-band telemetry sentinel is not ported, so the finiteness check always
stands in). The loop runs chunks while t_drive <= the largest te, each
lane stopping at its own te.

Not ported (ROADMAP A item 9): vmapped exact-shape batches over a solver
template, swap_lane / park_lane / resume_lane (continuous batching), the
mesh mode, lane fault injection, FleetRecorder telemetry, the pallas
retry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import flags as _flags
from ..utils.progress import Progress

# the state's slots after the fields, as offsets from the field count
T, NT, GM, TE, ACTIVE, T_DRIVE, NT_DRIVE = range(7)


class BatchedSolver:
    """N scenarios of one class signature through one class template."""

    def __init__(self, template, params, sids):
        if not params:
            raise ValueError("BatchedSolver needs at least one scenario")
        if not hasattr(template, "lane_consts"):
            raise NotImplementedError(
                "vmapped exact-shape batches over a solver template are not "
                "yet ported (ROADMAP A item 9); the port batches shape-class "
                "templates (fleet/shapeclass.ClassSolver, Class3DSolver)")
        self.template = template
        self.nf = template.n_fields
        self.dtype = template.dtype
        self.device = template.device
        self.rebind(params, sids)
        self._state0 = None
        self.chunks = 0  # chunks run by the last run()

    def rebind(self, params, sids) -> None:
        """Point this batch at a new request set of the same size; the
        drive-time knobs come from the first request (one loop for all
        lanes)."""
        from .queue import DRIVE_KEYS

        params, sids = list(params), list(sids)
        if hasattr(self, "n") and len(params) != self.n:
            raise ValueError(f"rebind needs {self.n} scenarios (got "
                             f"{len(params)})")
        self.params, self.sids, self.n = params, sids, len(params)
        self.param = self.template.param.replace(
            **{k: getattr(params[0], k) for k in DRIVE_KEYS})
        self._state0 = None

    def slot(self, offset: int) -> int:
        """The state index of a slot after the fields (T, NT, ...)."""
        return self.nf + offset

    @classmethod
    def from_numpy_state(cls, template, params, sids, state):
        """A batch that continues `state`: the arrays of a JAX class
        BatchedSolver's state (converted to numpy), in the layout of this
        module's docstring (10 for a 2-D class, 11 for a 3-D one). run()
        starts from it."""
        b = cls(template, params, sids)
        if len(state) != b.nf + 7:
            raise ValueError(f"a class batch state of {b.nf} fields has "
                             f"{b.nf + 7} slots, got {len(state)}")
        dev = b.device
        dtypes = (b.dtype,) * b.nf + (
            torch.float64, torch.int32, torch.float64, torch.float64,
            torch.bool, torch.float64, torch.int32)
        b._state0 = tuple(torch.from_numpy(np.array(x)).to(device=dev,
                                                          dtype=d)
                          for x, d in zip(state, dtypes))
        if b._state0[0].shape[0] != b.n:
            raise ValueError(f"state holds {b._state0[0].shape[0]} lanes, "
                             f"{b.n} requests given")
        return b

    # -- the batched chunk ---------------------------------------------
    def initial_state(self) -> tuple:
        lanes = [self.template.lane_state(p) for p in self.params]
        stacked = tuple(torch.stack(leaves) for leaves in zip(*lanes))
        dev = self.device
        te = torch.tensor([float(p.te) for p in self.params],
                          dtype=torch.float64, device=dev)
        return stacked + (te, torch.ones(self.n, dtype=torch.bool,
                                         device=dev),
                          torch.zeros((), dtype=torch.float64, device=dev),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def chunk(self, state) -> tuple:
        """One chunk of every running lane, then the retirement check and
        the drive scalars."""
        fields = state[:self.nf]
        t, nt, gm, te, active = state[self.nf:self.slot(T_DRIVE)]
        lanes = self.template.lane_consts(gm.cpu().numpy())
        *fields, t, nt = self.template.advance(*fields, t, nt, lanes, te,
                                               active)
        ok = torch.isfinite(t)
        for f in fields:
            ok = ok & torch.isfinite(f).flatten(1).all(dim=1)
        active = active & ok
        running = active & (t <= te)
        inf = torch.full((), float("inf"), dtype=t.dtype, device=t.device)
        t_drive = torch.where(running, t, inf).min()
        return (*fields, t, nt, gm, te, active, t_drive, nt.max())

    # -- drive API ------------------------------------------------------
    def drive_te(self) -> float:
        """The end time the host loop drives to: the largest lane te."""
        return max(float(p.te) for p in self.params)

    def run(self, progress: bool = False):
        """Drive the batch until no lane is running: chunks while t_drive
        <= the largest te (a chunk runs whenever t_drive <= te at its
        start). Returns the final state; read it with `results()`."""
        te = self.drive_te()
        bar = Progress(te, enabled=progress and not _flags.verbose())
        state = self._state0 if self._state0 is not None \
            else self.initial_state()
        self.chunks = 0
        while float(state[self.slot(T_DRIVE)]) <= te:
            state = self.chunk(state)
            self.chunks += 1
            td = float(state[self.slot(T_DRIVE)])
            if td == td and td != float("inf"):
                bar.update(td)
        bar.stop()
        return state

    def harvest(self, state, lane: int) -> dict:
        """One lane's result: {sid, t, nt, diverged, fields}, the fields
        cropped to the request's own grid (numpy)."""
        fields = tuple(f[lane].cpu().numpy() for f in state[:self.nf])
        return {
            "sid": self.sids[lane],
            "t": float(state[self.slot(T)][lane]),
            "nt": int(state[self.slot(NT)][lane]),
            "diverged": not bool(state[self.slot(ACTIVE)][lane]),
            "fields": self.template.crop_lane(fields, self.params[lane]),
        }

    def results(self, state) -> list[dict]:
        return [self.harvest(state, i) for i in range(self.n)]
