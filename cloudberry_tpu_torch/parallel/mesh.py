"""Segment layout — the gp_segment_configuration analog, on one card.

The JAX package runs a distributed plan as one ``shard_map`` program over
a ``jax.sharding.Mesh`` whose ``seg`` axis holds one device per segment.
The port runs every segment on ONE CUDA device: a partitioned table is a
``(n_segments, capacity)`` tensor and segment ``s`` works on its row
views ``t[s]`` (exec/dist_executor.py). The axis keeps the reference's
name so plans and telemetry read the same.

Segment SLOTS stand in for the reference's devices. The reference's
``jax.devices()`` is the pool a survivor restriction names ids in; the
port's pool is the cluster's healthy slot count (parallel/health.py
``slot_count``), so a restriction ``[0, 1, 2, 4, 5, 6, 7]`` of an
8-segment cluster that lost slot 3 places 7 segments over the survivors
as the reference meshes 7 segments over its 7 live devices. A degrade or
failover shrinks the epoch's segment count, not the pool, so an id below
the pool stays valid and slots can come back. ``MAX_SLOTS`` bounds the
pool: the one card's stand-in for the visible device count that the
reference's ``TopologyManager.begin`` refuses to expand past.

``HostTopology`` is the host → segment layout the motion layer's
two-level gate consults (parallel/transport.py ``hier_topology``). One
card is one real host, so without a forced split the derivation yields a
single host owning every segment, and the two-level (hierarchical) motion
never fires, as in the reference on a one-host mesh.
``CBTPU_FORCE_HOSTS=N`` partitions the segments into N simulated hosts
(contiguous, uniform), the reference's stand-in for a multi-host split:
every simulated host still lives in the one card's memory, so a
cross-host hop is an index permutation of the segment dimension like any
other.

``init_distributed`` joins a cluster of processes over
``torch.distributed`` (the ``gloo`` backend: one card cannot give each
rank a device of its own, which NCCL wants, and gloo runs on the CPU
too). Each process has a LOCAL SLOT count, the counterpart of a JAX
process's local device count (``local_slots``, or ``CBTPU_LOCAL_SLOTS``),
gathered across the cluster once at the join. The cluster's slot pool is
the concatenation of the local slots in process order, the order in
which the reference's ``jax.devices()`` lists a cluster's devices; a
survivor restriction names ids in that pool. Segment ``s`` lives on the
``s``-th (surviving) slot and its process owns it (``segment_owners``),
exactly as the reference's ``segment_mesh`` and ``host_topology`` choose
devices, so a process owns a contiguous range of segments whose size may
differ between processes (``local_segments``): a degrade 8 -> 7 over
``[0, 1, 2, 4, 5, 6, 7]`` of two processes of 4 slots leaves 3 + 4, and 6
segments over them 4 + 2. Each process is one real host of
``host_topology``; a ragged grouping is not uniform, so the two-level
transport stays flat there, as in the reference. Without local slot
counts the pool is split evenly: each process owns ``n_slots / P``
slots of the pool the caller names (the segment count, or the session's
healthy slot count), which must divide. Every process holds the
catalog's whole tables and lowers only the segments it owns.
"""

from __future__ import annotations

import datetime
import os
import threading
from dataclasses import dataclass

import torch.distributed as dist

SEG_AXIS = "seg"

# The most segment slots one card hosts. Every segment is a set of row
# views of the card's tensors and a gang step lowers each segment in turn
# on the host, so the limit is a design constant, not a device count:
# a 64-segment tile step already costs eight times the 8-segment one's
# host dispatch. TopologyManager.begin refuses a larger epoch.
MAX_SLOTS = 64

# host-topology derivation cache (the key carries everything the
# derivation reads)
_topo_lock = threading.Lock()
_topo_cache: dict = {}


# how long a collective (and the rendezvous) may wait for the other
# processes before it fails the statement: a rank that never arrives or a
# peer that died must fail a run, not hang it
DIST_TIMEOUT_S = 120.0

_dist_lock = threading.Lock()

# every process's local slot count, in process order (gathered once at the
# join), or None: the pool is then split evenly over the processes
_local_slots: tuple | None = None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_slots: int | None = None) -> None:
    """Join (or start) a multi-process cluster. Arguments default to the
    CBTPU_COORDINATOR (``host:port``) / CBTPU_NUM_PROCS / CBTPU_PROC_ID /
    CBTPU_LOCAL_SLOTS environment, as in the reference. Idempotent;
    without a coordinator a no-op. The group is ``torch.distributed``'s
    default group over ``gloo``, rendezvous at ``tcp://<coordinator>``; a
    rank that does not arrive within ``DIST_TIMEOUT_S`` fails the join (no
    quiet fallback to one process). ``local_slots``: this process's
    segment slots (module docstring); every process gives one or none."""
    global _local_slots
    with _dist_lock:
        if dist.is_available() and dist.is_initialized():
            return
        coordinator = coordinator or os.environ.get("CBTPU_COORDINATOR")
        if coordinator is None:
            return
        num_processes = int(num_processes
                            or os.environ.get("CBTPU_NUM_PROCS", "1"))
        process_id = int(process_id if process_id is not None
                         else os.environ.get("CBTPU_PROC_ID", "0"))
        mine = int(local_slots if local_slots is not None
                   else os.environ.get("CBTPU_LOCAL_SLOTS", "0"))
        if mine < 0:
            raise ValueError(f"local_slots={mine} is negative")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        import torch

        every = [torch.zeros((), dtype=torch.int64)
                 for _ in range(num_processes)]
        dist.all_gather(every, torch.tensor(mine, dtype=torch.int64))
        counts = tuple(int(c) for c in every)
        if any(counts) and not all(counts):
            raise RuntimeError(
                f"local slot counts {list(counts)}: every process gives "
                "its count, or none does")
        _local_slots = counts if all(counts) else None


def _group_live() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the cluster (1 without a group)."""
    return dist.get_world_size() if _group_live() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if _group_live() else 0


def cluster_slots() -> int | None:
    """The cluster's slot pool when the processes gave local slot
    counts, else None (the caller's pool is split evenly)."""
    if _local_slots is None or process_count() == 1:
        return None
    return sum(_local_slots)


def segment_owners(n_segments: int, device_ids=None,
                   n_slots: int | None = None, procs: int | None = None,
                   local_slots=None) -> tuple:
    """The owning process of every segment. The pool is the local slot
    counts concatenated in process order (``local_slots``, default the
    cluster's), else ``n_slots`` (default ``n_segments``) split evenly
    over the ``procs`` processes (default the cluster's), which must
    divide it; ``device_ids`` restricts it to survivors, and segment
    ``s`` lives on the ``s``-th chosen slot. Every process must own at
    least one segment (the reference's rule) and a contiguous range."""
    P = process_count() if procs is None else procs
    if local_slots is None and procs is None:
        local_slots = _local_slots
    if P == 1:
        pool = [0] * (n_segments if n_slots is None else n_slots)
    elif local_slots is not None:
        pool = [p for p, c in enumerate(local_slots) for _ in range(c)]
    else:
        n_slots = n_segments if n_slots is None else n_slots
        if n_slots < P or n_slots % P != 0:
            raise RuntimeError(
                f"n_segments={n_slots} cannot be split over {P} processes: "
                "without local slot counts every process owns an equal "
                f"contiguous block of at least one slot, so {P} must "
                f"divide {n_slots}")
        pool = [i // (n_slots // P) for i in range(n_slots)]
    if device_ids is not None:
        _check_device_ids(device_ids, len(pool))
        pool = [pool[i] for i in device_ids]
    if len(pool) < n_segments:
        raise RuntimeError(
            f"config asks for {n_segments} segments but only {len(pool)} "
            "segment slots are visible")
    chosen = tuple(pool[:n_segments])
    if P > 1:
        # every host must own at least one segment: a host outside the
        # layout could neither feed its shards nor read results
        owners = set(chosen)
        if owners != set(range(P)):
            raise RuntimeError(
                f"n_segments={n_segments} covers only hosts "
                f"{sorted(owners)} of {P}; every host must own at least "
                "one segment (raise n_segments or shrink the cluster)")
        if list(chosen) != sorted(chosen):
            raise RuntimeError(
                f"device restriction {list(device_ids)} interleaves the "
                "processes' slots: every process owns a contiguous range "
                "of segments")
    return chosen


def owner_ranges(owners: tuple) -> list:
    """Each process's contiguous segment range, in process order."""
    out = []
    lo = 0
    for p in range(max(owners) + 1 if owners else 1):
        hi = lo
        while hi < len(owners) and owners[hi] == p:
            hi += 1
        out.append(range(lo, hi))
        lo = hi
    return out


def local_segments(n_segments: int, device_ids=None,
                   n_slots: int | None = None) -> range:
    """The segments this process owns (``segment_owners``); every
    segment alone."""
    if process_count() == 1:
        return range(n_segments)
    return owner_ranges(segment_owners(n_segments, device_ids,
                                       n_slots))[process_index()]


def slot_layout(session, n_segments: int, device_ids=None) -> tuple:
    """(the owning process of every segment, this process's range) of
    ``n_segments`` segments over ``session``'s slot pool
    (parallel/health.py ``slot_count``) restricted to ``device_ids``:
    the one place a session's segments are placed on the processes. One
    process owns every segment."""
    if process_count() == 1:
        return (0,) * n_segments, range(n_segments)
    from cloudberry_tpu_torch.parallel.health import slot_count

    owners = segment_owners(n_segments, device_ids, slot_count(session))
    return owners, owner_ranges(owners)[process_index()]


def session_segments(session) -> range:
    """This process's segments of ``session``'s layout: its segment
    count over its survivor restriction and slot pool."""
    return slot_layout(session, session.config.n_segments,
                       getattr(session, "_live_device_ids", None))[1]


def require_one_process(what: str) -> None:
    """Refuse a path that is not ported across processes."""
    if process_count() > 1:
        raise NotImplementedError(
            f"{what} across processes is not ported: it runs in a "
            f"one-process cluster only ({process_count()} processes)")


class DeviceRestrictionError(RuntimeError):
    """A ``device_ids`` restriction named devices the layout cannot use.

    ``kind`` is ``"stale"`` (an id at or past the live device count: an
    out-of-date survivor list) or ``"invalid"`` (a negative or duplicate
    id: the list itself is malformed)."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


def _check_device_ids(device_ids, n_slots: int) -> None:
    """A survivor restriction against the slot pool: negative or
    duplicate ids are malformed, ids at or past the pool are stale."""
    ids = list(device_ids)
    bad = [i for i in ids if i < 0]
    if bad or len(set(ids)) != len(ids):
        raise DeviceRestrictionError(
            "invalid", f"device restriction {ids} has negative or "
            "duplicate ids")
    stale = [i for i in ids if i >= n_slots]
    if stale:
        raise DeviceRestrictionError(
            "stale", f"device ids {stale} are past the {n_slots} segment "
            "slot(s)")


def check_segments(n_segments: int, device_ids=None,
                   n_slots: int | None = None) -> None:
    """The segment layout's own checks (the reference's ``segment_mesh``):
    at most ``MAX_SLOTS`` segments on one card, and a survivor
    restriction ``device_ids`` well formed against the slot pool
    ``n_slots`` (default: ``n_segments``) and covering the segments."""
    if n_segments > MAX_SLOTS:
        raise RuntimeError(
            f"config asks for {n_segments} segments but one card hosts "
            f"at most {MAX_SLOTS} segment slots")
    if device_ids is not None:
        _check_device_ids(device_ids,
                          n_segments if n_slots is None else n_slots)
        if len(device_ids) < n_segments:
            raise RuntimeError(
                f"config asks for {n_segments} segments but only "
                f"{len(device_ids)} segment slots survive")


@dataclass(frozen=True)
class HostTopology:
    """Host → segment layout. Immutable and DERIVED: rebuild it through
    ``host_topology`` whenever the segment set may have changed."""

    n_segments: int
    # host -> tuple of global segment indices it owns (ascending)
    segs_by_host: tuple
    # True when the grouping came from CBTPU_FORCE_HOSTS (simulated
    # hosts) rather than the real one-card layout
    forced: bool = False

    @property
    def n_hosts(self) -> int:
        return len(self.segs_by_host)

    @property
    def segs_per_host(self) -> int:
        """Segments per host when UNIFORM, else 0 (the two-level path
        requires uniformity)."""
        sizes = {len(s) for s in self.segs_by_host}
        return len(self.segs_by_host[0]) if len(sizes) == 1 else 0

    def host_of(self, seg: int) -> int:
        for h, segs in enumerate(self.segs_by_host):
            if seg in segs:
                return h
        raise KeyError(seg)

    def uniform_contiguous(self) -> bool:
        """True when host h owns exactly segments [h*S, (h+1)*S) and the
        hosts cover every segment — the layout the two-level transport's
        static lane algebra relies on."""
        S = self.segs_per_host
        if S == 0 or S * self.n_hosts != self.n_segments:
            return False
        return all(tuple(segs) == tuple(range(h * S, (h + 1) * S))
                   for h, segs in enumerate(self.segs_by_host))

    def as_dict(self) -> dict:
        return {
            "n_segments": self.n_segments,
            "n_hosts": self.n_hosts,
            "segs_per_host": self.segs_per_host,
            "uniform_contiguous": self.uniform_contiguous(),
            "forced": self.forced,
            "segments_by_host": {h: list(s)
                                 for h, s in enumerate(self.segs_by_host)},
        }


def host_topology(n_segments: int, device_ids=None,
                  n_slots: int | None = None) -> HostTopology:
    """The host layout of ``n_segments`` segments.

    ``CBTPU_FORCE_HOSTS=N`` yields N simulated contiguous uniform hosts
    (the survivor restriction is not read, as in the reference) and
    raises ``ValueError`` when N does not divide the segment count.
    Otherwise each process of the cluster is one host owning the
    segments ``segment_owners`` gives it (a layout that leaves a process
    without a segment raises ``RuntimeError``), and one process is one
    host owning every segment; a survivor restriction ``device_ids`` is
    checked against the slot pool ``n_slots`` (default: ``n_segments``)
    as the reference checks it against its device list. Cached per
    (segments, restriction, pool, forced count, cluster layout)."""
    force = os.environ.get("CBTPU_FORCE_HOSTS")
    procs = process_count()
    key = (n_segments,
           tuple(device_ids) if device_ids is not None else None,
           n_slots, force, procs, _local_slots)
    with _topo_lock:
        hit = _topo_cache.get(key)
    if hit is not None:
        return hit
    if force:
        n_hosts = max(int(force), 1)
        if n_segments % n_hosts != 0:
            raise ValueError(
                f"CBTPU_FORCE_HOSTS={n_hosts} does not divide "
                f"n_segments={n_segments} (simulated hosts are uniform "
                "by construction)")
        S = n_segments // n_hosts
        groups = [range(h * S, (h + 1) * S) for h in range(n_hosts)]
    else:
        groups = owner_ranges(segment_owners(n_segments, device_ids,
                                             n_slots))
    topo = HostTopology(n_segments, tuple(tuple(g) for g in groups),
                        forced=bool(force))
    with _topo_lock:
        if len(_topo_cache) >= 32:
            _topo_cache.pop(next(iter(_topo_cache)))
        _topo_cache[key] = topo
    return topo


def mesh_topology(n_segments: int) -> dict:
    """Host → segment layout (the gp_segment_configuration view), a
    rendering of ``host_topology``: the forced split applies here too,
    so the view matches what the motion layer does. ``this_host`` is
    this process's index."""
    topo = host_topology(n_segments)
    return {
        "n_segments": n_segments,
        "n_hosts": topo.n_hosts,
        "this_host": process_index(),
        "segments_by_host": {h: list(s)
                             for h, s in enumerate(topo.segs_by_host)},
    }
