"""Statement lifecycle — the error taxonomy, cancellation tokens and the
current-statement scope.

The taxonomy splits retryable failures from semantic ones (a storage write
that fails at the OS layer is retryable, a checksum mismatch is not). Every
``Session.sql`` statement runs inside a ``statement_scope`` whose handle
carries its id (the key of the tiled executors' checkpoint store,
exec/recovery.py), a deadline and a cancel token; ``check_cancel`` is the
poll point the tile loops and the scan pipeline's reader thread call.
``Watchdog`` cancels over-deadline statements through the statement log's
active handles (exec/instrument.py). The JAX package's composite batch
handles and admission circuit breaker are not carried.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class StatementError(RuntimeError):
    """Base of the lifecycle taxonomy. ``retryable`` is the contract the
    serving layer exports on the wire: True means the failure is about
    WHEN the statement ran (load, shutdown, a flapping mesh), so an
    idempotent retry may succeed; False means it is about the statement
    itself (explicitly cancelled, semantically wrong)."""

    retryable = False


class StatementCancelled(StatementError):
    """Explicitly cancelled (the pg_cancel_backend analog) — semantic:
    retrying would defeat the cancel."""

    retryable = False


class StatementTimeout(StatementError):
    """Deadline/statement_timeout exceeded — transient: a retry under
    lighter load may fit."""

    retryable = True


class StorageIOError(StatementError):
    """A storage write/read failed at the OS layer (ENOSPC, EIO, a torn
    or short write the shim surfaced) — about the ENVIRONMENT the
    statement ran in, not the statement: the commit protocol left the
    previous snapshot intact, so an idempotent retry may succeed once
    the device/space condition clears. Counted in ``storage_io_errors``
    (storage/iofault.py)."""

    retryable = True


class StorageCorruptionError(StatementError):
    """Stored bytes failed their content checksum (or a container parsed
    as garbage) — semantic and sticky: retrying re-reads the same bad
    bytes. The read path raises this INSTEAD of returning a wrong
    answer. The pg_checksums verdict class."""

    retryable = False


# errors raised OUTSIDE this module that belong to the retryable side
# (the names the JAX package's serving layer exports on the wire)
_RETRYABLE_NAMES = frozenset({
    "StatementTimeout", "ServerDraining", "BreakerOpen",
    "SchedQueueFull", "SchedDeadline",
    "TenantQueueFull", "ServerBusy", "IngestQueueFull",
    "CompactionError", "StorageIOError",
})


def is_retryable(err) -> bool:
    """One classifier for server and client: accepts an exception or an
    etype name string."""
    if isinstance(err, BaseException):
        if isinstance(err, StatementError):
            return err.retryable
        err = type(err).__name__
    return str(err) in _RETRYABLE_NAMES


# ---------------------------------------------------------- cancel token


_REASON_EXC = {
    "cancelled": StatementCancelled,
    "timeout": StatementTimeout,
}


class CancelToken:
    """One statement's cancellation flag, settable from any thread. First
    cancel wins; the recorded reason picks which taxonomy error the
    statement's own thread raises at its next poll point."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.reason: Optional[str] = None
        self.message: Optional[str] = None

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def cancel(self, reason: str = "cancelled",
               message: Optional[str] = None) -> bool:
        """Request cancellation; True if this call was the first."""
        with self._lock:
            if self._event.is_set():
                return False
            self.reason = reason
            self.message = message
            self._event.set()
            return True

    def raise_if_cancelled(self) -> None:
        if not self._event.is_set():
            return
        exc = _REASON_EXC.get(self.reason or "cancelled",
                              StatementCancelled)
        raise exc(self.message or f"statement {self.reason}")


class StatementHandle:
    """Identity + deadline + token for one executing statement.
    ``deadline`` is a MONOTONIC absolute (time.monotonic()), or None."""

    def __init__(self, statement_id: int,
                 deadline: Optional[float] = None,
                 token: Optional[CancelToken] = None):
        self.statement_id = statement_id
        self.deadline = deadline
        self.token = token if token is not None else CancelToken()
        self.started = time.monotonic()

    def check(self) -> None:
        """The CHECK_FOR_INTERRUPTS analog: raise the taxonomy error when
        cancelled or past the deadline."""
        self.token.raise_if_cancelled()
        if self.deadline is not None and time.monotonic() > self.deadline:
            self.token.cancel(
                "timeout",
                f"statement timed out after "
                f"{time.monotonic() - self.started:.2f}s "
                "(deadline/statement_timeout exceeded)")
            self.token.raise_if_cancelled()


# ------------------------------------------------- current-statement scope


_tls = threading.local()


class statement_scope:
    """Context manager installing ``handle`` as the thread's current
    statement. Nests: inner statements shadow, exit restores."""

    def __init__(self, handle: StatementHandle):
        self._handle = handle

    def __enter__(self) -> StatementHandle:
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self._handle)
        return self._handle

    def __exit__(self, *exc) -> bool:
        _tls.stack.pop()
        return False


def current_handle() -> Optional[StatementHandle]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def check_cancel() -> None:
    """Poll point for execution seams: a no-op outside a statement scope,
    raises StatementCancelled/StatementTimeout inside one."""
    h = current_handle()
    if h is not None:
        h.check()


# --------------------------------------------------------------- watchdog


class Watchdog:
    """Background canceller for over-deadline statements (the SIGALRM /
    statement_timeout enforcement role). Cooperative checks already raise
    at seams that compare the deadline; the watchdog covers statements
    wedged where only the TOKEN is polled (the interruptible ``hang``
    fault point, a blocking wait) and makes the timeout visible in the
    activity view (state flips to 'cancelling') while the serving thread
    survives to run the next statement."""

    def __init__(self, stmt_log, interval_s: float = 0.05):
        self.stmt_log = stmt_log
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="cbtpu_torch-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.scan()

    def scan(self) -> int:
        """One pass; returns how many statements it cancelled (exposed
        for deterministic tests)."""
        now = time.monotonic()
        n = 0
        for sid, handle in self.stmt_log.active_handles():
            if handle.deadline is None or now <= handle.deadline \
                    or handle.token.cancelled:
                continue
            if handle.token.cancel(
                    "timeout",
                    f"statement {sid} cancelled by watchdog "
                    f"{now - handle.started:.2f}s after start "
                    "(deadline exceeded)"):
                self.stmt_log.mark_cancelling(sid)
                self.stmt_log.bump("watchdog_timeouts")
                n += 1
        return n
