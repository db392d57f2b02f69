"""Scheduled statements — the pg_cron analog.

The reference schedules SQL inside the database (pg_cron:
cron.schedule('job', '*/5 * * * *', 'REFRESH ...') running via a
background worker). Analog sized for this engine: jobs are
(name, interval seconds, SQL) triples persisted in the store
(``_cron/jobs.json`` — they survive restarts, like the cron catalog),
and a ``Scheduler`` thread owned by the serving process runs each job's
statement against its session when due. Failures record per-job (last
error + consecutive failure count) instead of killing the scheduler —
the bgworker restart discipline.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


class CronError(RuntimeError):
    pass


@dataclass
class Job:
    name: str
    interval_s: float
    sql: str
    next_run: float = 0.0
    runs: int = 0
    failures: int = 0
    last_error: Optional[str] = None
    last_started: Optional[float] = None


@dataclass
class Scheduler:
    """Background job runner over one session (the cron bgworker).

    ``execute`` (when given) replaces the raw ``session.sql`` call so the
    owner can interpose its own statement-level locking — the Server
    passes a callback that takes its readers-writer lock, because in
    shared-session mode a scheduled write would otherwise race concurrent
    client reads on the same Session (the data/stats swap the lock
    exists to serialize)."""

    session: object
    execute: Optional[object] = None
    tick_s: float = 0.5
    jobs: dict[str, Job] = field(default_factory=dict)
    _stop: threading.Event = field(default_factory=threading.Event)
    _thread: Optional[threading.Thread] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    # ------------------------------------------------------- persistence

    def _path(self) -> Optional[str]:
        store = getattr(self.session, "store", None)
        if store is None:
            return None
        return os.path.join(store.root, "_cron", "jobs.json")

    def _persist(self) -> None:
        path = self._path()
        if path is None:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump([{"name": j.name, "interval_s": j.interval_s,
                        "sql": j.sql} for j in self.jobs.values()], f)

    def load(self) -> "Scheduler":
        path = self._path()
        if path is not None and os.path.exists(path):
            with open(path) as f:
                for d in json.load(f):
                    # startup only: load() runs before start() spawns
                    # the tick thread
                    self.jobs[d["name"]] = Job(d["name"], d["interval_s"],
                                               d["sql"])
        return self

    # --------------------------------------------------------------- api

    def schedule(self, name: str, interval_s: float, sql: str) -> Job:
        """cron.schedule analog; re-scheduling a name replaces the job."""
        if interval_s <= 0:
            raise CronError("interval must be positive")
        with self._lock:
            job = Job(name, float(interval_s), sql,
                      next_run=time.monotonic() + float(interval_s))
            self.jobs[name] = job
            self._persist()
        return job

    def unschedule(self, name: str) -> None:
        with self._lock:
            if self.jobs.pop(name, None) is None:
                raise CronError(f"unknown cron job {name!r}")
            self._persist()

    def status(self) -> list[dict]:
        with self._lock:
            return [{"name": j.name, "interval_s": j.interval_s,
                     "sql": j.sql, "runs": j.runs, "failures": j.failures,
                     "last_error": j.last_error}
                    for j in self.jobs.values()]

    # ------------------------------------------------------------ runner

    def run_due(self, now: Optional[float] = None) -> int:
        """Run every due job once; returns how many ran. Exposed for
        deterministic tests (the loop just calls this on a tick)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            due = [j for j in self.jobs.values() if j.next_run <= now]
        ran = 0
        for j in due:
            j.last_started = now
            j.next_run = now + j.interval_s
            run = self.execute if self.execute is not None \
                else self.session.sql
            try:
                run(j.sql)
                j.runs += 1
                j.failures = 0
                j.last_error = None
            except Exception as e:  # noqa: BLE001 — job isolation
                j.failures += 1
                j.last_error = f"{type(e).__name__}: {e}"
            ran += 1
        return ran

    def start(self) -> "Scheduler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.tick_s):
                self.run_due()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="cbtpu_torch-cron")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
