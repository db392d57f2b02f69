"""Statement lifecycle — the error taxonomy the storage layer raises.

The JAX package's lifecycle module also carries cancellation tokens, the
watchdog and the admission circuit breaker; this port carries only the
retryable-vs-semantic taxonomy its storage path needs (a storage write
that fails at the OS layer is retryable, a checksum mismatch is not).
"""

from __future__ import annotations


class StatementError(RuntimeError):
    """Base of the lifecycle taxonomy. ``retryable`` is the contract the
    serving layer exports on the wire: True means the failure is about
    WHEN the statement ran (load, shutdown, a flapping mesh), so an
    idempotent retry may succeed; False means it is about the statement
    itself (explicitly cancelled, semantically wrong)."""

    retryable = False


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
