"""One writer per cluster: the store commits of a store-backed cluster.

Cloudberry commits on the coordinator (the QD): segments compute, the
coordinator alone publishes. A cluster of port processes
(parallel/mesh.py ``init_distributed``) runs every statement on every
process; over a durable store, every process committing the same
statement races the others through the store's OCC (two manifest
versions for one INSERT, or a process that commits a table it read at
another version). So in a cluster process 0 is the writer: each manifest
commit a statement makes (``TableStore.append``, ``save_table``,
``save_stats``, ``delete_rows``, ``drop_table``, ``commit_txn``, the
sequences, the materialized-view definitions, ``Session``'s transaction
commit, ``CompactionService.run_once``) runs on process 0 alone, and
the others wait in a broadcast for its outcome: the commit's return
value (a version, a sequence value, a report) or its error, which they
raise too.

``run(fn)`` is the rule. A call made in lockstep (a statement of
``Session.sql`` in a cluster, ``lockstep()`` around it, or
``lockstep=True``) broadcasts process 0's outcome; one made outside
(a background thread, a direct API call) runs on process 0 and returns
None elsewhere, with no collective: the next statement's agreed snapshot
(``Session._cluster_snapshot``) brings every process onto what it wrote.
Calls nested in a running write (``save_table`` inside ``commit_txn``)
run directly. One process: ``fn()``, unchanged.
"""

from __future__ import annotations

import contextlib
import functools
import pickle
import threading

_tls = threading.local()


def _rank() -> tuple[int, int]:
    from cloudberry_tpu_torch.parallel.mesh import (process_count,
                                                    process_index)

    return process_count(), process_index()


def follows() -> bool:
    """Whether this process is a cluster process other than the writer."""
    n, rank = _rank()
    return n > 1 and rank != 0


def leads() -> bool:
    """Whether this process writes: process 0, or the only process."""
    return _rank()[1] == 0


@contextlib.contextmanager
def lockstep():
    """Mark the calls on this thread as made by every process of the
    cluster in the same order (one cluster statement)."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def _portable(err: BaseException) -> BaseException:
    """``err`` if it survives pickling (so the other processes raise the
    same class), else a RuntimeError naming it."""
    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:  # noqa: BLE001 — any unpicklable error
        return RuntimeError(f"{type(err).__name__}: {err}")


def run(fn, lockstep: bool | None = None):
    """``fn()`` on the writer alone (module docstring); ``lockstep``
    overrides the thread's statement state."""
    n, rank = _rank()
    if n == 1 or getattr(_tls, "writing", False):
        return fn()
    if lockstep is None:
        lockstep = getattr(_tls, "depth", 0) > 0
    if not lockstep:
        return _write(fn) if rank == 0 else None
    import torch.distributed as dist

    err = out = None
    if rank == 0:
        try:
            out = _write(fn)
        except Exception as e:  # noqa: BLE001 — raised on every process
            err = e
    msg = [(None if err is None else _portable(err), out)]
    dist.broadcast_object_list(msg, src=0)
    if err is not None:
        raise err
    if msg[0][0] is not None:
        raise msg[0][0]
    return msg[0][1]


def _write(fn):
    """``fn()`` with the calls nested in it run directly."""
    _tls.writing = True
    try:
        return fn()
    finally:
        _tls.writing = False


def one_writer(method):
    """A ``TableStore`` method that commits: under ``run``."""
    @functools.wraps(method)
    def wrapped(*args, **kwargs):
        return run(lambda: method(*args, **kwargs))
    return wrapped
