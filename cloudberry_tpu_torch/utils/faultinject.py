"""Deterministic fault injection — the faultinjector.c analog.

The reference compiles ~230 named fault points into the server, armed at
runtime via gp_inject_fault() with actions (error/sleep/skip/suspend) and hit
counts (src/backend/utils/misc/faultinjector.c, SURVEY §4.2). Same model
here: code declares FAULT_POINT("name") at interesting seams; tests arm
actions. Used to provoke races/failures deterministically instead of hoping
load finds them (the reference's stance — no TSan harness, deterministic
provocation, §5.2).

Actions: 'error', 'sleep', 'skip', the cooperative 'hang' (released by
``reset_fault``, converted by a cancel or the watchdog), 'crash' (the
process dies at the seam, for a server a harness is about to restart) and
the IO actions of storage/iofault.py. A PROBABILISTIC arm (``p`` < 1) fires
each in-window hit with probability p from a per-arm seeded RNG —
randomized but REPRODUCIBLE (same seed → same firing sequence).
``list_faults()`` reports per-arm hit/fire telemetry plus every seam seen
this process; ``arm_from_env`` arms a server process from ``CBTPU_INJECT``.
"""

from __future__ import annotations

import os
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional


class InjectedFault(RuntimeError):
    pass


# IO-fault actions (consumed by storage/iofault.py): when one of these
# fires at a seam, fault_point() records it thread-locally and returns;
# the NEXT iofault write primitive on that thread implements the fault
# (torn prefix, short write, dropped fsync, ENOSPC, EIO). Arm them only
# on io_* seams — a seam with no following iofault write would leave
# the pending action to the thread's next unrelated write.
IO_ACTIONS = frozenset({"torn", "short", "fsync_drop", "enospc", "eio"})
_ACTIONS = frozenset({"error", "sleep", "skip", "hang", "crash"}) | IO_ACTIONS


@dataclass
class _Arm:
    action: str           # 'error' | 'sleep' | 'skip' | 'hang' |
    #                       'crash' | one of IO_ACTIONS
    sleep_s: float = 0.0
    start_hit: int = 1    # trigger from the Nth hit...
    end_hit: int = 1 << 30  # ...through this hit
    p: float = 1.0        # per-hit firing probability
    seed: Optional[int] = None
    hits: int = 0         # times the seam was reached while armed
    fired: int = 0        # times the action actually triggered
    rng: random.Random = None  # type: ignore[assignment]
    # interruptible wedge: 'hang' blocks on this instead of a raw sleep,
    # so reset_fault() releases a wedged thread immediately
    wake: threading.Event = field(default_factory=threading.Event)


# The seam contract of record: every fault_point() call site in the port,
# by name. Chaos tests arm seams from this list; a CPU test holds it to
# the port's call sites both ways and to the JAX package's inventory less
# the seams of modules the port does not have yet (compaction's
# compact_chunk, compact_commit and io_journal_write, cbfdist's
# fdist_get; ROADMAP Queue A 9b).
INVENTORY = frozenset({
    # planner/session dispatch
    "admission_check", "dispatch_start", "dist_execute_start",
    # storage / OCC
    "copy_from", "occ_commit_window", "storage_commit_before_current",
    "store_lock_acquire", "store_read_partition", "sync_store",
    # DML
    "dml_delete", "dml_insert_select", "dml_update",
    # serving / endpoints
    "serve_handler", "endpoint_drain",
    # matviews
    "matview_maintain", "matview_refresh",
    # scheduler (sched/dispatcher.py, sched/paramplan.py run_batch)
    "sched_enqueue", "sched_coalesce", "sched_flush",
    # tiled execution + recovery
    "tile_step", "tile_step_dist", "tiled_finalize",
    "ckpt_save", "ckpt_resume", "tile_device_lost",
    # windowed tile dispatch (exec/tilepipe.py)
    "tile_enqueue", "tile_drain",
    # asynchronous scan pipeline (exec/scanpipe.py)
    "scan_prefetch", "scan_decode",
    # device buffer pool (exec/bufferpool.py)
    "bufpool_admit", "bufpool_evict",
    # feedback-driven re-optimization (plan/feedback.py, exec/tiled.py)
    "feedback_fold", "tile_replan",
    # segment health
    "exec_device_lost", "probe_degraded",
    # online topology changes (parallel/topology.py)
    "topo_rebalance_chunk", "topo_cutover", "topo_promote",
    # write path (storage/ingest.py): 'error' on ingest_flush fails the
    # WHOLE batch before any statement commits
    "ingest_flush",
    # faulty-IO seams (storage/iofault.py): each guards ONE durable write
    # primitive — arm an IO_ACTIONS action to corrupt that write, or
    # 'crash' to kill the process there
    "io_partition_write", "io_manifest_write",
    "storage_commit_after_current", "io_atomic_json",
    "io_topology_write", "io_feedback_write",
})


_registry: dict[str, _Arm] = {}
_seen: set[str] = set()
_lock = threading.Lock()
# the fired-but-unconsumed IO action (per thread): set by fault_point
# when an IO_ACTIONS arm fires, popped by the next iofault write
_tls = threading.local()


def inject_fault(name: str, action: str = "error", sleep_s: float = 0.0,
                 start_hit: int = 1, end_hit: int = 1 << 30,
                 p: float = 1.0, seed: Optional[int] = None) -> None:
    """Arm a fault point (the gp_inject_fault() analog). ``p`` < 1 makes
    each in-window hit fire probabilistically from a per-arm RNG seeded
    by ``seed`` (default: a hash of the name, so re-arming reproduces
    the same sequence). ``sleep_s`` bounds a 'hang' (0: an hour)."""
    if action not in _ACTIONS:
        raise ValueError(f"unknown fault action {action!r}")
    arm = _Arm(action, sleep_s, start_hit, end_hit, p, seed)
    arm.rng = random.Random(
        seed if seed is not None else zlib.crc32(name.encode()))
    with _lock:
        old = _registry.get(name)
        _registry[name] = arm
    if old is not None:
        old.wake.set()  # a re-arm releases threads wedged on the old arm


def reset_fault(name: Optional[str] = None) -> None:
    with _lock:
        if name is None:
            arms = list(_registry.values())
            _registry.clear()
        else:
            arm = _registry.pop(name, None)
            arms = [arm] if arm is not None else []
    for arm in arms:  # outside the lock: waking needs no registry state
        arm.wake.set()


def fault_point(name: str) -> bool:
    """Declare a fault point. Returns True if the caller should SKIP the
    guarded step ('skip' action); raises/sleeps for other armed actions.

    'hang' is a COOPERATIVE wedge (the reference's 'suspend' with
    gp_inject_fault resume semantics): it blocks on the arm's event —
    released by reset_fault()/re-arm — while polling the statement's
    cancellation seam, so a watchdog or cancel converts the wedge into a
    StatementTimeout/StatementCancelled and the worker thread survives."""
    with _lock:
        _seen.add(name)  # under the lock: handler threads race discovery
        arm = _registry.get(name)
        if arm is None:
            return False
        arm.hits += 1
        if not (arm.start_hit <= arm.hits <= arm.end_hit):
            return False
        if arm.p < 1.0 and arm.rng.random() >= arm.p:
            return False  # in-window hit that the dice spared
        arm.fired += 1
        action = arm.action
        sleep_s = arm.sleep_s
        wake = arm.wake
    if action == "crash":
        # the process-kill arm: no atexit, no flush, no cleanup — the
        # closest in-process analog of SIGKILL
        os._exit(137)
    if action == "error":
        raise InjectedFault(f"fault injected at {name!r}")
    if action in IO_ACTIONS:
        _tls.io_action = (name, action)
        return False
    if action == "sleep":
        time.sleep(sleep_s)
        return False
    if action == "hang":
        from cloudberry_tpu_torch.lifecycle import check_cancel

        end = time.monotonic() + (sleep_s or 3600.0)
        while not wake.wait(timeout=0.05):
            check_cancel()
            if time.monotonic() >= end:
                break
        return False
    return action == "skip"


def take_io_action() -> Optional[tuple[str, str]]:
    """Pop this thread's pending (seam, io_action) pair, if any — the
    iofault write primitives call this at entry, so the IO fault lands
    on exactly the write the preceding fault_point() guarded."""
    pending = getattr(_tls, "io_action", None)
    _tls.io_action = None
    return pending


def arm_from_env(spec: Optional[str] = None) -> int:
    """Arm seams from a ``CBTPU_INJECT`` spec — how a crash harness
    injects into a real server process it is about to kill:
    semicolon-separated ``name=action[@start_hit[-end_hit]]`` entries,
    e.g. ``"io_manifest_write=crash@3"`` (crash on the 3rd hit) or
    ``"io_partition_write=torn"``. Returns the number of seams armed.
    Called once at server start (mgmt/cli.py serve)."""
    spec = spec if spec is not None else os.environ.get("CBTPU_INJECT", "")
    n = 0
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry or "=" not in entry:
            continue
        name, _, act = entry.partition("=")
        start, end = 1, 1 << 30
        if "@" in act:
            act, _, window = act.partition("@")
            lo, _, hi = window.partition("-")
            start = int(lo) if lo else 1
            end = int(hi) if hi else 1 << 30
        inject_fault(name.strip(), act.strip(), start_hit=start,
                     end_hit=end)
        n += 1
    return n


def known_fault_points() -> set[str]:
    """Fault points hit at least once this process (discovery aid)."""
    with _lock:
        return set(_seen)


def list_faults() -> dict:
    """Per-arm telemetry (the gp_inject_fault 'status' analog): which
    seams are armed, how often each was reached, and how often it
    actually fired — plus every seam this process has seen."""
    with _lock:
        armed = {name: {
            "action": a.action, "p": a.p, "seed": a.seed,
            "start_hit": a.start_hit, "end_hit": a.end_hit,
            "hits": a.hits, "fired": a.fired,
        } for name, a in _registry.items()}
        return {"armed": armed, "seen": sorted(_seen)}
