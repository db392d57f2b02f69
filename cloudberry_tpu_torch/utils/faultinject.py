"""Deterministic fault injection — the faultinjector.c analog.

The reference compiles ~230 named fault points into the server, armed at
runtime via gp_inject_fault() with actions (error/sleep/skip/suspend) and hit
counts (src/backend/utils/misc/faultinjector.c, SURVEY §4.2). Same model
here: code declares FAULT_POINT("name") at interesting seams; tests arm
actions. Used to provoke races/failures deterministically instead of hoping
load finds them (the reference's stance — no TSan harness, deterministic
provocation, §5.2).

The port carries the arms its seams use: 'error', 'sleep', 'skip' and the
IO actions of storage/iofault.py. A PROBABILISTIC arm (``p`` < 1) fires
each in-window hit with probability p from a per-arm seeded RNG —
randomized but REPRODUCIBLE (same seed → same firing sequence).
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from dataclasses import dataclass
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


@dataclass
class _Arm:
    action: str           # 'error' | 'sleep' | 'skip' | one of IO_ACTIONS
    sleep_s: float = 0.0
    start_hit: int = 1    # trigger from the Nth hit...
    end_hit: int = 1 << 30  # ...through this hit
    p: float = 1.0        # per-hit firing probability
    seed: Optional[int] = None
    hits: int = 0         # times the seam was reached while armed
    fired: int = 0        # times the action actually triggered
    rng: random.Random = None  # type: ignore[assignment]


_registry: dict[str, _Arm] = {}
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
    the same sequence)."""
    if action not in ("error", "sleep", "skip") and action not in IO_ACTIONS:
        raise ValueError(f"unknown fault action {action!r}")
    arm = _Arm(action, sleep_s, start_hit, end_hit, p, seed)
    arm.rng = random.Random(
        seed if seed is not None else zlib.crc32(name.encode()))
    with _lock:
        _registry[name] = arm


def reset_fault(name: Optional[str] = None) -> None:
    with _lock:
        if name is None:
            _registry.clear()
        else:
            _registry.pop(name, None)


def fault_point(name: str) -> bool:
    """Declare a fault point. Returns True if the caller should SKIP the
    guarded step ('skip' action); raises/sleeps for other armed actions."""
    with _lock:
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
    if action == "error":
        raise InjectedFault(f"fault injected at {name!r}")
    if action in IO_ACTIONS:
        _tls.io_action = (name, action)
        return False
    if action == "sleep":
        time.sleep(sleep_s)
        return False
    return action == "skip"


def take_io_action() -> Optional[tuple[str, str]]:
    """Pop this thread's pending (seam, io_action) pair, if any — the
    iofault write primitives call this at entry, so the IO fault lands
    on exactly the write the preceding fault_point() guarded."""
    pending = getattr(_tls, "io_action", None)
    _tls.io_action = None
    return pending
