"""The Cartesian communication layer, driven by one process (counterpart of
pampi_tpu/parallel/comm.py, the reference's Comm API of
assignment-6/src/comm.h).

A distributed field is a list of per-shard tensors in row-major mesh order
over the axes ("j", "i"), or ("k", "j", "i") in 3-D; shard s lives on
`comm.devices[s]`. One controller loops over the shards, where the JAX
package runs one program per device under `shard_map`:

  JAX (shard_map)                      here
  -----------------------------------  ------------------------------------
  lax.axis_index(axis)                 comm.coords(s)[axis]
  get_offsets(axis, local)             comm.offsets(s, local): coordinate
                                       times the local extent
  is_boundary(axis, nper, side)        comm.is_boundary(s, axis, side)
  halo_exchange (ppermute per axis)    halo_exchange(blocks, comm): each
                                       neighbour's owned strip copied into
                                       the ghost strip (Tensor.copy_, which
                                       also crosses cards)
  ExchangeSchedule / persistent_       ExchangeSchedule / persistent_
  exchange (the overlapped step's      exchange: the same copies; `post`
  exchange, flown by XLA behind        runs them on a second CUDA stream
  compute)                             beside the work issued after it
  halo_shift (one ppermute)            halo_shift(blocks, comm, axis): the
                                       low ghost strip only (commShift)
  master_print (debug print on shard   master_print(comm, fmt, *args): one
  (0, ..., 0))                         line from the one controller
  reduction (psum / pmax)              reduction(vals, comm): a fixed-order
                                       sum or max in mesh order, on shard
                                       0's device
  the sharded global array             collect(blocks): the global array,
                                       assembled on the host

Placement. `dims=None` (`tpu_mesh auto`) gives one shard per visible device
(`dims_create`). An explicit mesh with more shards than devices places
shard s on `devices[s mod n]`, so several shards share a card; the JAX
package refuses such a mesh (it needs one device per shard, and its test
suite fakes eight CPU devices instead). A repeated device may also be
passed explicitly, as the tests do with `[torch.device("cpu")] * P`.
Multi-process launch (ROADMAP A.9) is not ported: `is_master` is always
True.

The exchange keeps the JAX package's semantics: axis by axis with full
strips (ghost corners consistent after the last axis), physical-wall
ghosts keep their old values (MPI_PROC_NULL), `depth` ghost layers per
side in one message. Mesh tiers (`tpu_mesh_tiers`) order the posting of
strips on a TPU pod and change no value; they are parsed for validation
only.
"""

from __future__ import annotations

import contextlib
import math
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.device import visible_devices

# slowest-varying first, as the reference's enum {KDIM, JDIM, IDIM}
AXIS_NAMES = ("k", "j", "i")
TIERS = ("dcn", "ici")


def parse_mesh_tiers(spec: str, axis_names) -> dict:
    """`tpu_mesh_tiers` -> {axis name: tier}: "auto" maps every axis to
    "ici"; a comma list "j=dcn,i=ici" names tiers, unlisted axes are
    "ici", unknown axes or tiers raise ValueError."""
    tiers = {name: "ici" for name in axis_names}
    spec = (spec or "auto").strip()
    if spec == "auto":
        return tiers
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"tpu_mesh_tiers entry {part!r} is not axis=tier "
                f"(axes {tuple(axis_names)}, tiers {TIERS})")
        axis, tier = (t.strip() for t in part.split("=", 1))
        if axis not in tiers:
            raise ValueError(
                f"tpu_mesh_tiers names unknown mesh axis {axis!r} "
                f"(this mesh has {tuple(axis_names)})")
        if tier not in TIERS:
            raise ValueError(
                f"tpu_mesh_tiers tier {tier!r} for axis {axis!r} not in "
                f"{TIERS}")
        tiers[axis] = tier
    return tiers


def dims_create(nranks: int, ndims: int,
                extents: tuple[int, ...] | None = None) -> tuple[int, ...]:
    """Balanced factorization of nranks over ndims (MPI_Dims_create).

    Without `extents`: non-increasing balanced factors. With `extents` (the
    grid's interior extents in mesh-axis order) the factorization looks at
    the grid: prefer every axis divisible, then the least pad-with-mask
    overhead, then the smallest cut area, then the most balanced."""
    if extents is not None and len(extents) != ndims:
        raise ValueError(
            f"extents {extents} rank does not match ndims={ndims}")

    def factorizations(n, k):
        if k == 1:
            yield (n,)
            return
        for f in range(1, n + 1):
            if n % f == 0:
                for rest in factorizations(n // f, k - 1):
                    yield (f,) + rest

    if extents is None:
        primes = []
        n = nranks
        f = 2
        while f * f <= n:
            while n % f == 0:
                primes.append(f)
                n //= f
            f += 1
        if n > 1:
            primes.append(n)
        dims = [1] * ndims
        for prime in sorted(primes, reverse=True):
            # the currently smallest dimension, the latest on ties
            k = min(range(ndims), key=lambda d: (dims[d], -d))
            dims[k] *= prime
        return tuple(sorted(dims, reverse=True))

    def score(dims):
        locals_ = [-(-e // p) for e, p in zip(extents, dims)]
        nondiv = sum(1 for e, p in zip(extents, dims) if e % p)
        pad = sum((l * p - e) / e for e, p, l in zip(extents, dims, locals_))
        padded = [l * p for l, p in zip(locals_, dims)]
        vol = math.prod(padded)
        comm_vol = sum(
            (p - 1) * vol // ep for p, ep in zip(dims, padded) if p > 1)
        spread = max(dims) - min(dims)
        return (nondiv, round(pad, 9), comm_vol, spread,
                tuple(-d for d in dims))

    return min(factorizations(nranks, ndims), key=score)


@dataclass
class CartComm:
    """Cartesian mesh of shards (the Comm struct, comm.h:104-115). The
    axis names are the last `ndims` of ("k", "j", "i"). `devices` defaults
    to every visible card."""

    ndims: int = 2
    dims: tuple[int, ...] | None = None
    devices: list | None = None
    extents: tuple[int, ...] | None = None
    tiers: str | dict | None = None
    axis_names: tuple[str, ...] = field(init=False)
    _coords: list = field(init=False, repr=False)

    def __post_init__(self):
        devs = (list(self.devices) if self.devices is not None
                else visible_devices("cuda"))
        n = len(devs)
        if self.dims is None:
            self.dims = dims_create(n, self.ndims, self.extents)
        self.dims = tuple(int(d) for d in self.dims)
        if len(self.dims) != self.ndims:
            raise ValueError(
                f"tpu_mesh has {len(self.dims)} dims {self.dims} but this "
                f"problem needs a {self.ndims}-D mesh")
        if any(d < 1 for d in self.dims):
            raise ValueError(f"mesh dims must be positive, got {self.dims}")
        # the first prod(dims) devices; round-robin when there are fewer
        self.devices = [torch.device(devs[s % n]) for s in range(self.size)]
        self.axis_names = AXIS_NAMES[3 - self.ndims:]
        self._coords = [tuple(int(c) for c in np.unravel_index(s, self.dims))
                        for s in range(self.size)]
        if isinstance(self.tiers, dict):
            self.tiers = ",".join(f"{a}={t}" for a, t in self.tiers.items())
        self.tiers = parse_mesh_tiers(self.tiers, self.axis_names)

    # --- commIsMaster: one controller, no other processes --------------
    @property
    def is_master(self) -> bool:
        return True

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def shared(self) -> bool:
        """Whether several shards live on one device."""
        return len(set(self.devices)) < self.size

    def axis_size(self, axis: str) -> int:
        return self.dims[self.axis_names.index(axis)]

    def coords(self, s: int) -> tuple[int, ...]:
        """Mesh coordinates of shard s (row-major over axis_names)."""
        return self._coords[s]

    def rank(self, coords) -> int:
        r = 0
        for c, d in zip(coords, self.dims):
            r = r * d + c
        return r

    def offsets(self, s: int, local) -> tuple[int, ...]:
        """commGetOffsets: global start of shard s's block per axis."""
        return tuple(c * e for c, e in zip(self.coords(s), local))

    def is_boundary(self, s: int, axis: str, side: str) -> bool:
        """commIsBoundary: whether shard s owns the physical wall on the
        "lo" or "hi" side of `axis`."""
        c = self.coords(s)[self.axis_names.index(axis)]
        return c == 0 if side == "lo" else c == self.axis_size(axis) - 1

    def neighbour(self, s: int, axis: str, step: int,
                  periodic: bool = False) -> int | None:
        """The shard `step` (+1 or -1) along `axis` from s, or None past a
        wall (MPI_PROC_NULL)."""
        a = self.axis_names.index(axis)
        c = list(self.coords(s))
        c[a] += step
        if not 0 <= c[a] < self.dims[a]:
            if not periodic:
                return None
            c[a] %= self.dims[a]
        return self.rank(c)

    def local_shape(self, global_shape, ragged: bool = False
                    ) -> tuple[int, ...]:
        """Uniform per-shard block extents: divisible extents, or with
        ragged=True ceil-divided blocks whose trailing cells the solvers
        mask (pad-with-mask)."""
        if ragged:
            return tuple(-(-e // p) for e, p in zip(global_shape, self.dims))
        for ext, p in zip(global_shape, self.dims):
            if ext % p:
                raise ValueError(
                    f"extent {ext} not divisible by mesh dim {p} "
                    f"(uniform-block policy; ragged pad-with-mask runs pass "
                    f"ragged=True, or change tpu_mesh)")
        return tuple(e // p for e, p in zip(global_shape, self.dims))

    # --- commPrintConfig ------------------------------------------------
    def print_config(self, out=None) -> None:
        out = out or sys.stdout
        out.write("Communication setup:\n")
        out.write(f"\tMesh dims: {self.dims} axes {self.axis_names}\n")
        for s, dev in enumerate(self.devices):
            out.write(f"\tShard {s} {self.coords(s)}: {dev}\n")
        if self.shared:
            out.write(f"\t{self.size} shards share {len(set(self.devices))}"
                      " device(s), placed round-robin\n")

    # --- commCollectResult -----------------------------------------------
    def collect(self, blocks) -> np.ndarray:
        """The global array of equal per-shard blocks, on the host."""
        local = tuple(blocks[0].shape)
        out = np.empty(tuple(d * e for d, e in zip(self.dims, local)),
                       dtype=np.float64)
        for s, blk in enumerate(blocks):
            sl = tuple(slice(o, o + e)
                       for o, e in zip(self.offsets(s, local), local))
            out[sl] = blk.detach().cpu().numpy()
        return out


def _exchange_axis(blocks, comm: CartComm, dim: int, periodic: bool,
                   depth: int) -> None:
    """Fill both `depth`-wide ghost strips of every block along array dim
    `dim` from the owned strips of the +-1 neighbours; wall ghosts keep
    their values. Every strip is read before any is written when an owned
    extent is below `depth` (its strip then covers ghosts), as the
    simultaneous ppermute of the JAX package reads them."""
    axis = comm.axis_names[dim]
    if comm.dims[dim] == 1 and not periodic:
        return
    n, d = blocks[0].shape[dim], depth
    snapshot = n - 2 * d < d
    copies = []
    for s, x in enumerate(blocks):
        for step, ghost, owned in ((-1, 0, n - 2 * d), (1, n - d, d)):
            nbr = comm.neighbour(s, axis, step, periodic)
            if nbr is None:
                continue
            src = blocks[nbr].narrow(dim, owned, d)
            copies.append((x.narrow(dim, ghost, d),
                           src.clone() if snapshot else src))
    for dst, src in copies:
        dst.copy_(src)


def halo_exchange(blocks, comm: CartComm, periodic=(), depth: int = 1):
    """commExchange: refresh, in place, every ghost layer of the extended
    per-shard blocks (`depth` ghost layers per side, array dims ordered
    like the mesh axes), axis by axis. Returns the list."""
    if len({tuple(b.shape) for b in blocks}) != 1:
        raise ValueError("halo_exchange needs equal block shapes")
    for dim, axis in enumerate(comm.axis_names):
        _exchange_axis(blocks, comm, dim, axis in periodic, depth)
    return blocks


class Posted:
    """An exchange in flight (ExchangeSchedule.post): the exchanged blocks,
    one list per posted field, and on the card the events recorded on the
    side streams after the exchange's last copy."""

    def __init__(self, blocks, events=()):
        self.blocks = blocks
        self.events = list(events)

    def wait(self):
        """Make the current stream of every device the blocks lie on wait
        for the exchange (nothing to wait for on the CPU); returns the
        blocks. Only the exchange's consumer calls it."""
        if self.events:
            for dev in {b.device for x in self.blocks for b in x}:
                stream = torch.cuda.current_stream(dev)
                for ev in self.events:
                    stream.wait_event(ev)
        return self.blocks


def _cards(comm: CartComm):
    """The comm's distinct devices, a card with its index (the devices of
    the tensors on it), or [] when the shards lie on the CPU."""
    if comm.devices[0].type != "cuda":
        return []
    return list(dict.fromkeys(
        d if d.index is not None else
        torch.device("cuda", torch.cuda.current_device())
        for d in comm.devices))


def ready_events(comm: CartComm):
    """Events recorded now on the current stream of each of the comm's
    cards (the point an exchange posted later must follow), or None on
    the CPU."""
    cards = _cards(comm)
    if not cards:
        return None
    return [torch.cuda.current_stream(d).record_event() for d in cards]


_SIDE_STREAMS: dict = {}


def side_stream(device):
    """The exchange's second stream on a card, one per device and
    process."""
    device = torch.device(device)
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class ExchangeSchedule:
    """A persistent halo-exchange schedule (the JAX package's
    parallel/comm.ExchangeSchedule): what is static about one class of
    exchange (the mesh, the depth, the dtype, the periodic axes) resolved
    once, the axes ordered by tier (dcn first; a single-tier mesh keeps
    the axis order). Reordering full-strip axis exchanges moves no value:
    a ghost corner receives the diagonal neighbour's owned value by either
    route.

    Calling it exchanges a list of blocks in place, as halo_exchange does.
    `post` starts an exchange that a later consumer waits on: on the card
    its copies run on a second stream of each device (side_stream) after
    events recorded on the current streams (at the post, or earlier by
    ready_events), so that the work issued around the post runs beside
    them until `Posted.wait`. On the CPU `post` runs the same calls in
    order."""

    def __init__(self, comm: CartComm, depth: int = 1, dtype=None,
                 periodic=()):
        self.comm = comm
        self.depth = int(depth)
        self.dtype = dtype
        self.periodic = tuple(periodic)
        self.plan = sorted(
            range(comm.ndims),
            key=lambda d: (TIERS.index(comm.tiers[comm.axis_names[d]]), d))

    def __call__(self, blocks):
        if self.dtype is not None and any(b.dtype != self.dtype
                                          for b in blocks):
            raise TypeError(
                f"ExchangeSchedule built for {self.dtype} applied to "
                f"{blocks[0].dtype}: schedules are cached per (mesh, depth, "
                "dtype); take the right one from persistent_exchange()")
        if len({tuple(b.shape) for b in blocks}) != 1:
            raise ValueError("halo_exchange needs equal block shapes")
        for dim in self.plan:
            _exchange_axis(blocks, self.comm, dim,
                           self.comm.axis_names[dim] in self.periodic,
                           self.depth)
        return blocks

    def post(self, groups, prepare=None, ready=None) -> Posted:
        """Start the exchange of every list of blocks in `groups` (one
        list per field). `prepare` maps each block to a new block to
        exchange (embed_deep, say); without it the blocks are exchanged in
        place. On the card the side streams wait for `ready`
        (ready_events, recorded when the sources were complete: the caller
        may issue work on the current streams between the two, which then
        runs beside the copies) or, without it, for events recorded now;
        they read the sources and write the new blocks, so
        Tensor.record_stream marks each for the stream that has not
        allocated it (the caching allocator then keeps its memory until
        that stream's work is done), and nothing may write a source until
        the consumer has waited."""
        devices = _cards(self.comm)
        if not devices:
            out = [[prepare(b) for b in x] if prepare else list(x)
                   for x in groups]
            for x in out:
                self(x)
            return Posted(out)
        main = {d: torch.cuda.current_stream(d) for d in devices}
        side = {d: side_stream(d) for d in devices}
        if ready is None:
            ready = [main[d].record_event() for d in devices]
        with contextlib.ExitStack() as stack:
            for d in devices:
                stack.enter_context(torch.cuda.stream(side[d]))
                for ev in ready:
                    side[d].wait_event(ev)
            out = []
            for x in groups:
                blocks = [prepare(b) for b in x] if prepare else list(x)
                self(blocks)
                out.append(blocks)
            done = [side[d].record_event() for d in devices]
        for x, y in zip(groups, out):
            for b in x:
                b.record_stream(side[b.device])
            if prepare:
                for b in y:
                    b.record_stream(main[b.device])
        return Posted(out, done)


_SCHEDULES: dict = {}


def _mesh_key(comm: CartComm) -> tuple:
    """The identity of a comm's mesh: axes, dims, devices and the tier
    map (a re-tiered mesh orders its exchange otherwise)."""
    return (tuple(comm.axis_names), tuple(comm.dims),
            tuple(str(d) for d in comm.devices),
            tuple(sorted(comm.tiers.items())))


def persistent_exchange(comm: CartComm, depth: int = 1, dtype=None,
                        periodic=()) -> ExchangeSchedule:
    """The cached ExchangeSchedule of (mesh with its tier map, depth,
    dtype, periodic axes): built once a process, the same object
    afterwards."""
    key = (_mesh_key(comm), int(depth),
           None if dtype is None else str(dtype), tuple(sorted(periodic)))
    sched = _SCHEDULES.get(key)
    if sched is None:
        sched = _SCHEDULES[key] = ExchangeSchedule(comm, depth, dtype,
                                                   periodic)
    return sched


def halo_shift(blocks, comm: CartComm, axis: str):
    """commShift (assignment-6 comm.c:196-244): the one-directional
    staggered exchange of the F/G/H donor edges, in place. Each block's LOW
    ghost strip along `axis` takes the minus neighbour's last owned strip
    (index -2); the first shard's physical ghost and every high ghost keep
    their values. Returns the list."""
    dim = comm.axis_names.index(axis)
    if comm.dims[dim] == 1:
        return blocks
    n = blocks[0].shape[dim]
    copies = []
    for s, x in enumerate(blocks):
        lo = comm.neighbour(s, axis, -1)
        if lo is not None:
            copies.append((x.narrow(dim, 0, 1),
                           blocks[lo].narrow(dim, n - 2, 1)))
    for dst, src in copies:
        dst.copy_(src)
    return blocks


def master_print(comm: CartComm, fmt: str, *args) -> None:
    """The rank-0 printing convention of the reference drivers: one line
    (`fmt` with `{}` fields, as jax.debug.print takes it), printed by the
    one controller, which is the master."""
    if comm.is_master:
        print(fmt.format(*(float(a) if isinstance(a, torch.Tensor) else a
                           for a in args)))


def reduction(vals, comm: CartComm, op: str = "sum"):
    """commReduction: the global sum or max of per-shard 0-dim tensors, in
    mesh order, on shard 0's device (a fixed order: no float atomics)."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown reduction op {op!r}")
    if len(vals) != comm.size:
        raise ValueError(f"{len(vals)} values for {comm.size} shards")
    acc = vals[0]
    for v in vals[1:]:
        v = v.to(acc.device)
        acc = acc + v if op == "sum" else torch.maximum(acc, v)
    return acc


def assemble_global(blocks, comm: CartComm, interior) -> np.ndarray:
    """Per-shard extended (l+2 per axis) blocks -> the reference-layout
    global array (interior + ghost ring, (kmax+2, jmax+2, imax+2) in 3-D):
    the block interiors everywhere, ghost strips only from the shards at a
    wall (the JAX package's utils/checkpoint.assemble_global, over the
    port's list of blocks). Keeps the blocks' dtype, on the host."""
    local = tuple(n - 2 for n in blocks[0].shape)
    host = [b.detach().cpu().numpy() for b in blocks]
    full = np.zeros([p * e + 2 for p, e in zip(comm.dims, local)],
                    host[0].dtype)
    for s, blk in enumerate(host):
        src, dst = [], []
        for c, p, e in zip(comm.coords(s), comm.dims, local):
            lo = 0 if c == 0 else 1
            hi = e + 2 if c == p - 1 else e + 1
            src.append(slice(lo, hi))
            dst.append(slice(c * e + lo, c * e + hi))
        full[tuple(dst)] = blk[tuple(src)]
    return full[tuple(slice(0, g + 2) for g in interior)]


def scatter_blocks(full, comm: CartComm, local) -> list:
    """The inverse of assemble_global: a reference-layout global array ->
    per-shard extended numpy blocks of interior extents `local`, in mesh
    order. Interface ghosts come from the neighbours' interiors (the state
    a fresh halo exchange gives), wall ghosts bit-exact; on a ragged mesh
    the dead cells past the array are zero (the JAX package's
    utils/checkpoint.scatter_blocks)."""
    full = np.asarray(full)
    pad = np.zeros([max(n, p * e + 2) for n, p, e in
                    zip(full.shape, comm.dims, local)], full.dtype)
    pad[tuple(slice(0, n) for n in full.shape)] = full
    full = pad
    return [full[tuple(slice(c * e, c * e + e + 2)
                       for c, e in zip(comm.coords(s), local))].copy()
            for s in range(comm.size)]
