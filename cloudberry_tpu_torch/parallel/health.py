"""Failure detection — the FTS analog, on one card.

The reference's fault-tolerance service probes every segment postmaster on
an interval, runs a per-segment state machine, and promotes mirrors on
failure (src/backend/fts/fts.c:118, ftsprobe.c:60-95). Segments have no
mirrors — recovery is re-execution (stateless segments over immutable
tables) — so the analog is:

- ``probe(session)``: one tiny reduction on the session's device, reported
  per segment SLOT (the FTS_MSG_PROBE analog);
- ``HealthMonitor``: background interval prober with a bounded status
  history and a failure callback (the bgworker loop);
- ``run_with_retry``: re-dispatch a failed statement (the job-restart
  recovery model).

Slots. The JAX package's segments each own a device, and its probe counts
the devices that answer. The port's segments are row views of one card's
tensors, so its probe reports one SLOT per segment of the cluster's
healthy epoch (``slot_count``: the current epoch's segment count, or the
count before a degrade or failover shrank it, so that slots can come
back). A probe whose reduction runs reports every slot live; the
``probe_degraded`` seam drops the last one, as the reference's drops its
last device, so an 8-segment session degrades to 7 segments, not to 1.
The slot pool is at most ``mesh.MAX_SLOTS``. In a cluster whose processes
gave local slot counts the pool is the cluster's (``mesh.cluster_slots``):
each process probes its own slots and the live masks are gathered, so a
lost slot mid-pool (process 0's last of two processes' 4 + 4) degrades
every process to the same survivors, the reference's ragged 3 + 4.

Which failures re-dispatch (``recoverable``): the ``device_lost`` text of
the fault seams (``exec_device_lost``, ``tile_device_lost``), as in the
reference. Never an out-of-memory error, a kernel build failure
(``cuda_kernels.KernelBuildError``) or an error the lifecycle taxonomy
calls semantic. The reference also re-dispatches on the XLA runtime's
errors; the port does not re-dispatch on CUDA runtime errors
(``torch.AcceleratorError``): on one card such an error is either a launch
fault that a re-run repeats, or a sticky context error (an illegal
address, a device that fell off the bus) after which every later CUDA call
of the process fails — it cannot be recovered inside the process, and a
retry loop would only spin until its budget ran out.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class ProbeResult:
    ok: bool
    n_devices: int            # LIVE slot count (the degrade input)
    latency_s: float
    error: Optional[str] = None
    # indices of the slots that answered — a loss may leave a hole in the
    # MIDDLE of the list, so recovery must place over these survivors
    live: Optional[list] = None


def slot_count(session) -> int:
    """The segment slots of the session's cluster: the cluster's slot
    pool when its processes gave local slot counts (parallel/mesh.py
    ``cluster_slots``), else the healthy epoch's segment count
    (parallel/topology.py ``healthy_nseg``)."""
    from cloudberry_tpu_torch.parallel.mesh import cluster_slots

    pool = cluster_slots()
    if pool is not None:
        return pool
    mgr = getattr(session, "_topology", None)
    if mgr is None:
        return session.config.n_segments
    return mgr.healthy_nseg()


def probe(session=None) -> ProbeResult:
    """One health probe: a reduction over a (slots, 8) tensor of ones on
    the session's device (on the card: a fill and a reduction kernel),
    each slot's row checked on the host. Without a session, the probe
    runs on the default device (CUDA when available) with one slot.

    In a cluster of processes every process probes the slots of the pool
    it owns (parallel/mesh.py ``segment_owners``; the seam drops this
    process's last slot), and the live masks are gathered, so every
    process reports the same survivors: the probe is a collective, which
    every process calls together (the session's retry hook does)."""
    import torch

    from cloudberry_tpu_torch.parallel.mesh import (process_count,
                                                    slot_layout)
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    t0 = time.time()
    cluster = session is not None and process_count() > 1
    if session is None:
        device = torch.device("cuda" if torch.cuda.is_available()
                              else "cpu")
        pool = 1
        slots = list(range(1))
    else:
        device = session.device
        pool = slot_count(session)
        slots = list(slot_layout(session, pool)[1])
    if fault_point("probe_degraded"):
        # chaos seam: report the last slot lost ('skip' action) — no slot
        # of one card can die alone, so degraded recovery is provoked
        # deterministically (faultinjector.c role)
        slots = slots[:-1]
    error = None
    try:
        x = torch.ones((len(slots), 8), dtype=torch.float32, device=device)
        sums = x.sum(dim=1).cpu().tolist()
    except Exception as e:  # noqa: BLE001 — the runtime itself is gone
        error, sums = str(e), [0.0] * len(slots)
    live = [i for i, v in zip(slots, sums) if v == 8.0]
    errors = [f"slot {i}: bad probe sum" for i, v in zip(slots, sums)
              if v != 8.0] if error is None else [error]
    if cluster:
        from cloudberry_tpu_torch.parallel.transport import cluster_reduce

        mask = torch.zeros((pool + 1,), dtype=torch.int64)
        mask[live] = 1
        mask[pool] = len(errors)
        mask = cluster_reduce(mask, "sum")
        live = [i for i in range(pool) if int(mask[i])]
        if int(mask[pool]) and not errors:
            errors = ["another process's slots failed the probe"]
    if error is not None and not live:
        return ProbeResult(False, 0, time.time() - t0, error, live=[])
    return ProbeResult(not errors, len(live), time.time() - t0,
                       "; ".join(errors) or None, live=live)


@dataclass
class HealthMonitor:
    """Interval prober (FtsProbeMain loop analog). ``history`` is a
    BOUNDED ring; ``history_maxlen`` 0 (the default) reads
    config.health.monitor_history. ``topology`` (a TopologyManager):
    every probe result feeds its persistence detector, so persistent slot
    loss promotes to a failover-shrink epoch and recovery to the
    symmetric expand back. The probe runs over ``session`` (else the
    topology manager's session)."""

    interval_s: float = 30.0
    on_failure: Optional[Callable[[ProbeResult], None]] = None
    history_maxlen: int = 0
    history: "object" = None
    topology: Optional[object] = None
    session: Optional[object] = None
    _stop: threading.Event = field(default_factory=threading.Event)
    _thread: Optional[threading.Thread] = None

    def __post_init__(self):
        if not self.history_maxlen:
            from cloudberry_tpu_torch.config import get_config

            self.history_maxlen = get_config().health.monitor_history
        self.history = collections.deque(self.history or (),
                                         maxlen=self.history_maxlen)
        if self.session is None and self.topology is not None:
            self.session = self.topology._session

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()  # allow stop() → start() restarts

        def loop():
            while not self._stop.wait(self.interval_s):
                self.probe_now()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="cbtpu_torch-fts-probe")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def probe_now(self) -> ProbeResult:
        r = probe(self.session)
        self.history.append(r)
        if self.topology is not None:
            self.topology.note_probe(r)
        if not r.ok and self.on_failure is not None:
            self.on_failure(r)
        return r


def never_redispatched(e: BaseException) -> bool:
    """An out-of-memory error, a kernel build failure or an error the
    lifecycle taxonomy calls semantic: no re-dispatch can turn it into
    a success (module docstring)."""
    import torch

    from cloudberry_tpu_torch.exec.cuda_kernels import KernelBuildError
    from cloudberry_tpu_torch.lifecycle import StatementError

    if isinstance(e, (torch.OutOfMemoryError, KernelBuildError)):
        return True
    return isinstance(e, StatementError) and not e.retryable


def recoverable(e: BaseException) -> bool:
    """Failures worth a re-dispatch: the ``device_lost`` seams' device
    loss, unless ``never_redispatched``."""
    return not never_redispatched(e) and "device_lost" in str(e)


def run_with_retry(fn: Callable, retries: int = 1,
                   backoff_s: float = 0.5,
                   on_retry: Optional[Callable] = None,
                   max_backoff_s: float = 5.0,
                   budget_s: float = 0.0,
                   jitter: float = 0.5,
                   recoverable_fn: Optional[Callable] = None) -> object:
    """Re-dispatch on a recoverable failure (stateless segments over
    immutable tables: failed statements simply re-run; the tiled
    executors' checkpoints make the re-run incremental, exec/recovery.py).

    - backoff between attempts is EXPONENTIAL with up to ``jitter``
      proportional randomization, capped at ``max_backoff_s``;
    - ``budget_s`` is the per-statement retry budget: once that much wall
      clock has gone to failed attempts + backoff, the next recoverable
      failure raises instead of retrying (0 = no budget);
    - the backoff waits on the current statement's cancel token (a cancel
      or a watchdog timeout cuts it short), never sleeps past the
      deadline, and re-checks the deadline before the next attempt; it is
      a ``recovery-backoff`` span on the statement's trace;
    - ``on_retry(exc, backoff_s)`` runs between attempts — the session
      passes its probe-and-degrade hook there;
    - ``recoverable_fn`` overrides the re-dispatch classifier (the session
      widens it for statements whose pinned topology epoch was cut over
      mid-flight).
    """
    import random

    from cloudberry_tpu_torch.lifecycle import current_handle
    from cloudberry_tpu_torch.obs import trace as OT

    rec = recoverable if recoverable_fn is None else recoverable_fn
    t0 = time.monotonic()
    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            if not rec(e) or attempt == retries:
                raise
            if budget_s and time.monotonic() - t0 >= budget_s:
                raise
            last = e
            delay = min(backoff_s * (2 ** attempt)
                        * (1.0 + jitter * random.random()),
                        max_backoff_s)
            if on_retry is not None:
                on_retry(e, delay)
            h = current_handle()
            token = getattr(h, "token", None)
            with OT.span("recovery-backoff", attempt=attempt + 1,
                         error=type(e).__name__):
                if token is not None:
                    rem = h.remaining()
                    if rem is not None:
                        delay = min(delay, max(rem, 0.0))
                    if delay > 0:
                        token.wait(delay)
                    # raises StatementTimeout/StatementCancelled when the
                    # deadline passed (or a cancel landed) during the wait
                    h.check()
                elif delay > 0:
                    time.sleep(delay)
    raise last  # unreachable
