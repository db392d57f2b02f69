"""Faulty-IO shim — the storage layer's one set of write primitives.

Every durable write in the store (micro-partition bodies, v{N}.json
manifests, the CURRENT swap, _SEQUENCES/_MATVIEWS/_TOPOLOGY/_FEEDBACK
json, the compaction journal) goes through this module, which buys three
things at once:

- ONE place that gets durability right: whole-file writes fsync before
  they count (a micro-partition that only reached the page cache when
  the manifest committed was a silent torn-store bug), atomic JSON
  replaces fsync the temp file AND the directory entry (os.replace is
  only crash-durable once the directory is);
- a fault surface the chaos/torture tests drive through the existing
  faultinject inventory: the caller declares ``fault_point("io_*")`` at
  the seam, and when an armed IO action fires there this module
  implements it against the very next write — torn write (prefix only),
  short write, dropped fsync (bytes vanish at ``simulated_crash()``),
  ENOSPC, EIO;
- the ``storage_io_errors`` counter + typed taxonomy: OS-layer write
  failures surface as retryable ``StorageIOError`` (the previous
  snapshot is intact — the commit protocol guarantees it), never as a
  silent ``except OSError: pass``.

The reference analog is the xlog.c discipline: WAL/data writes funnel
through one durability layer that knows when fsync is required, and the
fault-injection build corrupts exactly that layer.
"""

from __future__ import annotations

import errno
import json
import os
import tempfile
import threading
import zlib
from typing import Optional

from cloudberry_tpu_torch.lifecycle import StorageIOError
from cloudberry_tpu_torch.utils import faultinject

# innermost leaf lock:
# guards the counter dict and the unsynced-write registry only; nothing
# is called while it is held, and rank-4 holders (the feedback store's
# _io_lock) reach it through durable_write
_lock = threading.Lock()
_counts = {"storage_io_errors": 0}
# fsync-dropped writes: path -> True if the file existed before the
# write. simulated_crash() "loses power": the buffered bytes vanish.
_unsynced: dict[str, bool] = {}


# ------------------------------------------------------------- counters


def note_io_error(path: str, exc: Optional[BaseException] = None) -> None:
    """Count one storage-layer IO failure (the ``storage_io_errors``
    counter). Callers with a StatementLog in reach mirror it there so
    the metrics exposition carries it too."""
    with _lock:
        _counts["storage_io_errors"] += 1


def io_error_count() -> int:
    with _lock:
        return _counts["storage_io_errors"]


def reset_counters() -> None:
    with _lock:
        _counts["storage_io_errors"] = 0


# ------------------------------------------------------------ checksums

# Content checksum for micro-partition column blobs: crc32 via zlib's C
# loop — the xxhash-class point (fast, non-cryptographic, catches bit
# flips and truncation) without a new dependency. Stored in the footer
# as "crc32:<hex>" so the algorithm can evolve without ambiguity.


KNOWN_HASH_ALGOS = frozenset({"crc32"})


def content_hash(data: bytes) -> str:
    return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def hash_verdict(stored: str, data: bytes) -> str:
    """``"ok"`` | ``"mismatch"`` | ``"unknown"``. An unrecognized
    algorithm prefix is indistinguishable from a corrupted label (the
    ``crc32:`` tag itself can take the bit flip), so it gets its own
    verdict: the hot read path stays lenient for forward compat, but
    the offline pass (verify_file) reports it instead of treating the
    blob as verified."""
    algo, _, _hex = stored.partition(":")
    if algo not in KNOWN_HASH_ALGOS:
        return "unknown"
    return "ok" if content_hash(data) == stored else "mismatch"


def hash_matches(stored: str, data: bytes) -> bool:
    return hash_verdict(stored, data) != "mismatch"


# --------------------------------------------------------------- writes


def _partial(path: str, data: bytes, n: int) -> None:
    """Leave a prefix on disk, unsynced — what a torn write leaves."""
    try:
        with open(path, "wb") as f:
            f.write(data[:n])
    except OSError:
        pass  # the injected failure is about to be raised anyway


def durable_write(path: str, data: bytes, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` whole-file, fsynced by default.
    Implements the thread's pending armed IO fault (the caller's
    preceding ``fault_point("io_*")`` seam); OS failures raise
    ``StorageIOError`` and count."""
    pending = faultinject.take_io_action()
    act = pending[1] if pending else None
    if act == "eio":
        note_io_error(path)
        raise StorageIOError(
            f"{path}: I/O error (injected EIO at {pending[0]!r})")
    if act == "enospc":
        _partial(path, data, len(data) // 2)
        note_io_error(path)
        e = StorageIOError(
            f"{path}: no space left on device (injected ENOSPC at "
            f"{pending[0]!r})")
        e.errno = errno.ENOSPC
        raise e
    if act == "torn":
        _partial(path, data, len(data) // 2)
        note_io_error(path)
        raise StorageIOError(
            f"{path}: torn write — {len(data) // 2} of {len(data)} "
            f"bytes reached disk (injected at {pending[0]!r})")
    if act == "short":
        _partial(path, data, max(len(data) - 8, 0))
        note_io_error(path)
        raise StorageIOError(
            f"{path}: short write — os.write returned fewer bytes "
            f"than requested (injected at {pending[0]!r})")
    existed = os.path.exists(path)
    try:
        with open(path, "wb") as f:
            f.write(data)
            if fsync and act != "fsync_drop":
                f.flush()
                os.fsync(f.fileno())
    except OSError as e:
        note_io_error(path, e)
        raise StorageIOError(f"{path}: {e}") from e
    if act == "fsync_drop":
        with _lock:
            _unsynced.setdefault(path, existed)


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync: os.replace is only crash-durable
    once the directory entry is on disk. Some filesystems refuse
    O_RDONLY-fsync on directories (EINVAL/EACCES) — those journal the
    rename anyway."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_json(path: str, obj, dirpath: Optional[str] = None) -> None:
    """Durable atomic JSON replace: temp file in ``dirpath`` (default:
    the target's directory), fsynced write, os.replace, directory
    fsync. A failure at ANY step leaves the previous file intact — torn
    JSON is structurally impossible on this path."""
    data = json.dumps(obj).encode()
    d = dirpath or os.path.dirname(path) or "."
    try:
        fd, tmp = tempfile.mkstemp(dir=d)
        os.close(fd)
    except OSError as e:
        note_io_error(path, e)
        raise StorageIOError(f"{path}: {e}") from e
    existed = os.path.exists(path)
    try:
        durable_write(tmp, data)
        os.replace(tmp, path)
    except StorageIOError:
        _unlink_quiet(tmp)
        raise
    except OSError as e:
        _unlink_quiet(tmp)
        note_io_error(path, e)
        raise StorageIOError(f"{path}: {e}") from e
    # an fsync-dropped temp write was just renamed onto the target: the
    # bytes at risk now live at the DESTINATION path (replace moves the
    # unsynced inode), so the crash simulation must lose it there — with
    # the pre-replace existence deciding truncate-vs-unlink
    _migrate_unsynced(tmp, path, existed)
    fsync_dir(d)


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _migrate_unsynced(old: str, new: str, new_existed: bool) -> None:
    """os.replace moved an unsynced write from ``old`` to ``new``."""
    with _lock:
        if old in _unsynced:
            del _unsynced[old]
            _unsynced.setdefault(new, new_existed)


# -------------------------------------------------- simulated power loss


def simulated_crash() -> list[str]:
    """Lose every fsync-dropped write, as a power cut would: files that
    did not exist before vanish; rewrites lose their buffered bytes
    (truncate — the on-disk state of an unsynced overwrite is
    undefined, and empty is the adversarial case). Returns the affected
    paths — tests assert the store recovers without them."""
    with _lock:
        items = sorted(_unsynced.items())
        _unsynced.clear()
    lost = []
    for path, existed in items:
        try:
            if existed:
                with open(path, "r+b") as f:
                    f.truncate(0)
            else:
                os.unlink(path)
            lost.append(path)
        except OSError:
            continue
    return lost


def unsynced_paths() -> list[str]:
    with _lock:
        return sorted(_unsynced)
