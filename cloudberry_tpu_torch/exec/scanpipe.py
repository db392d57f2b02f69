"""Asynchronous tiled-scan pipeline — prefetch, parallel decode and device
staging for the tiled executors (exec/tiled.py).

The tiled executors stream a table as fixed-shape tiles. Without this
module the feed is synchronous: read a micro-partition, decode every
column, concatenate, pad, upload — all on the statement thread while the
device idles. The pipeline moves that host work off the critical path:

- ``ScanPipeline``: a bounded prefetch queue (``config.scan_pipeline.
  prefetch_tiles``) fed by ONE background reader thread that runs the
  tile-producing generator. The reader installs the statement's lifecycle
  scope (lifecycle.statement_scope), so cancellation checks fire inside
  the worker as on the statement thread, and the ``scan_prefetch`` fault
  seam arms there. Producer errors buffer behind already-staged tiles and
  re-raise on the consumer — tile order and content are EXACTLY the
  synchronous feed's, so pipeline on/off is bit-identical by construction.
- ``DeviceStage``: how a host tile reaches the session's device. On CUDA
  with ``device_buffer`` on, the reader copies each tile into pinned host
  buffers, and the consumer, when it pops tile k, starts the upload of
  tile k+1 with ``copy_(non_blocking=True)`` on a side stream and records
  an event; using a tile makes the current stream wait on its event and
  marks its tensors with ``record_stream``. Each pinned buffer is kept
  until its copy's event has completed. Off, or without the pipeline, a
  tile uploads synchronously when it is used; on a CPU device the stage is
  a plain copy.
- a shared decode pool (``decode_workers`` daemon threads) for
  column-parallel micro-partition decode; the codecs release the GIL.

A tile is a dict of columns, each a numpy array, a tensor already on the
device (a buffer-pool chunk, exec/bufferpool.py) or a ``Mixed`` list of
both (a tile that crosses a pooled/cold boundary, or pads a pooled
remainder). ``DeviceStage.ready`` is the one place a Mixed column is
assembled: on the device, with ``torch.cat``, after its host pieces have
uploaded — numpy never sees a device piece, and nothing round-trips.

Each tiled run builds a fresh feed and closes it in a ``finally``
(close_feed), so adaptive grow-and-retry restarts drain and reseed the
queue and a cancelled statement leaves no orphan reader thread. Queue
memory is charged into the tiled report (queue_charge_bytes →
est_pipeline_bytes).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from cloudberry_tpu_torch.utils.faultinject import fault_point

_EOS = object()     # producer exhausted
_EMPTY = object()   # nothing queued right now (non-blocking take)


class ScanStats:
    """Per-feed host-side accounting, written by whichever thread runs the
    producing generator and read only after the feed closed (the join in
    close() is the ordering; a timed-out join marks the feed leaked and
    the snapshot is skipped)."""

    __slots__ = ("decode_s", "read_s", "parts_read", "parts_skipped",
                 "parts_resident", "bytes_decoded", "copy_rows",
                 "view_rows")

    def __init__(self):
        self.decode_s = 0.0      # pure column-decode seconds
        self.read_s = 0.0        # partition read wall (IO + decode)
        self.parts_read = 0
        self.parts_skipped = 0   # resume fast path: skipped whole files
        self.parts_resident = 0  # served from the device buffer pool
        self.bytes_decoded = 0
        self.copy_rows = 0       # rows copied on emit (each at most once)
        self.view_rows = 0       # chunk-exact zero-copy emits

    def snapshot(self) -> dict:
        return {
            "decode_s": round(self.decode_s, 6),
            "read_s": round(self.read_s, 6),
            "parts_read": self.parts_read,
            "parts_skipped": self.parts_skipped,
            "parts_resident": self.parts_resident,
            "bytes_decoded": self.bytes_decoded,
        }


# ------------------------------------------------------------ device stage


class Mixed:
    """A tile column still in pieces: numpy arrays and device tensors in
    row order (at least one), then ``pad`` zero rows. Assembled on the
    device by ``DeviceStage.ready``."""

    __slots__ = ("parts", "pad", "dtype")

    def __init__(self, parts: list, pad: int):
        self.parts = parts
        self.pad = pad
        p = parts[0]
        self.dtype = p.dtype if torch.is_tensor(p) else _torch_dtype(p.dtype)

    def __len__(self) -> int:
        return sum(len(p) for p in self.parts) + self.pad


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a`` (the CPU device's stage)."""
    return torch.from_numpy(np.array(a, copy=True, order="C"))


class DeviceStage:
    """Moves tiles onto one device. ``pin`` runs on the reader thread (host
    work only), ``upload`` and ``ready`` on the consumer thread."""

    def __init__(self, device, pinned: bool):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pinned = bool(pinned) and self.cuda
        self._stream = None
        # (event, pinned host tensors) of uploads not known complete
        self._inflight: deque = deque()

    # ---------------------------------------------------------- host side

    def pin(self, tile: dict) -> dict:
        """Copy a tile's host columns into pinned buffers (CUDA with
        ``device_buffer`` on); the identity otherwise."""
        if not self.pinned:
            return tile
        return {k: self._pin(v) for k, v in tile.items()}

    def _pin(self, v):
        if isinstance(v, np.ndarray):
            h = torch.empty(v.shape, dtype=_torch_dtype(v.dtype),
                            pin_memory=True)
            h.numpy()[...] = v
            return h
        if isinstance(v, Mixed):
            return Mixed([self._pin(p) for p in v.parts], v.pad)
        return v

    # ------------------------------------------------------ consumer side

    def _reap(self) -> None:
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()

    def upload(self, tile: dict):
        """Start moving a tile's host columns to the device; returns the
        staged tile for ``ready``. (No closure here refers to itself: a
        self-referencing closure is a reference cycle, and the device
        tensors it captured would live until the garbage collector ran.)"""
        if not self.pinned:
            return {k: self._put(v) for k, v in tile.items()}, None
        self._reap()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        pins: list = []
        side: list = []
        with torch.cuda.stream(self._stream):
            out = {k: self._put_async(v, pins, side)
                   for k, v in tile.items()}
            ev = torch.cuda.Event()
            ev.record(self._stream)
        # the pinned sources stay referenced until the copy has completed
        self._inflight.append((ev, pins))
        return out, (ev, side)

    def _put(self, v):
        """A host column on the device, synchronously (a plain copy on a
        CPU device)."""
        if isinstance(v, np.ndarray):
            if not self.cuda:
                return _host_tensor(v)
            from cloudberry_tpu_torch.exec.bufferpool import to_device

            return to_device(v, self.device)
        if isinstance(v, Mixed):
            return Mixed([self._put(p) for p in v.parts], v.pad)
        return v

    def _put_async(self, v, pins: list, side: list):
        """A pinned column's copy to the device on the side stream."""
        if isinstance(v, np.ndarray):   # not pinned by the reader
            v = torch.from_numpy(np.array(v, copy=True))
        if torch.is_tensor(v) and v.device.type == "cpu":
            d = torch.empty(v.shape, dtype=v.dtype, device=self.device)
            d.copy_(v, non_blocking=True)
            pins.append(v)
            side.append(d)
            return d
        if isinstance(v, Mixed):
            return Mixed([self._put_async(p, pins, side) for p in v.parts],
                         v.pad)
        return v

    def ready(self, staged) -> dict:
        """The staged tile as device tensors usable on the current stream
        (waits on its upload event; assembles Mixed columns on the
        device)."""
        out, pending = staged
        if pending is not None:
            ev, side = pending
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in side:
                t.record_stream(cur)
        res = {}
        for k, v in out.items():
            if isinstance(v, Mixed):     # every part is on the device now
                parts = list(v.parts)
                if v.pad:
                    parts.append(torch.zeros((v.pad,), dtype=v.dtype,
                                             device=self.device))
                v = parts[0] if len(parts) == 1 else torch.cat(parts)
            res[k] = v
        return res

    def now(self, tile: dict) -> dict:
        """Upload and ready in one step (the synchronous feed)."""
        return self.ready(self.upload(self.pin(tile)))


# ------------------------------------------------------------ the feeds


class ScanPipeline:
    """Bounded prefetch queue over a tile generator. Iterating yields
    exactly the generator's items in order (tiles on the device when a
    stage is given); ``close()`` stops the reader and joins it. All
    cross-thread state lives under ``_cond`` (a leaf: nothing is called
    while it is held); ``_staged`` is a consumer-thread-only slot."""

    def __init__(self, gen, depth: int = 2,
                 stage: Optional[DeviceStage] = None,
                 prestage: bool = False,
                 stats: Optional[ScanStats] = None):
        from cloudberry_tpu_torch.lifecycle import current_handle

        self._gen = gen
        self.depth = max(int(depth), 1)
        self._stage = stage
        self._prestage = bool(prestage) and stage is not None
        self.scan_stats = stats
        self._handle = current_handle()
        self._cond = threading.Condition()
        self._buf: deque = deque()
        self._open = True        # consumer still wants tiles
        self._done = False       # producer finished (or died)
        self._err: Optional[BaseException] = None
        # telemetry (mutations under _cond)
        self.tiles = 0           # tiles staged by the reader
        self.feed_s = 0.0        # producer busy seconds (read+decode+pad)
        self.stall_s = 0.0       # consumer blocked-on-empty-queue seconds
        self.max_depth = 0       # queue high-water mark
        self._staged = None      # consumer-only: next tile, upload started
        self._reader_leaked = False  # join timed out in close()
        self._thread = threading.Thread(target=self._reader, daemon=True,
                                        name="cbtpu_torch-scan-reader")
        self._thread.start()

    # ------------------------------------------------------------ producer

    def _reader(self) -> None:
        from cloudberry_tpu_torch.lifecycle import (check_cancel,
                                                    statement_scope)

        scope = (statement_scope(self._handle)
                 if self._handle is not None else None)
        if scope is not None:
            scope.__enter__()
        try:
            it = iter(self._gen)
            while True:
                # cancel seam INSIDE the worker: a cancelled statement
                # stops the prefetch within one tile's work
                check_cancel()
                fault_point("scan_prefetch")
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                if self._prestage:
                    tile, n = item
                    item = (self._stage.pin(tile), n)
                if not self._offer(item, time.perf_counter() - t0):
                    break  # consumer closed: stop reading
        except BaseException as e:  # noqa: BLE001 — re-raised on consumer
            with self._cond:
                self._err = e
                self._cond.notify_all()
        finally:
            close = getattr(self._gen, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            with self._cond:
                self._done = True
                self._cond.notify_all()
            if scope is not None:
                scope.__exit__(None, None, None)

    def _offer(self, item, feed_dt: float) -> bool:
        """Queue one tile, waiting while the bounded buffer is full. False
        when the consumer closed the pipeline."""
        from cloudberry_tpu_torch.lifecycle import check_cancel

        while True:
            with self._cond:
                if not self._open:
                    return False
                if len(self._buf) < self.depth:
                    self._buf.append(item)
                    self.tiles += 1
                    self.feed_s += feed_dt
                    if len(self._buf) > self.max_depth:
                        self.max_depth = len(self._buf)
                    self._cond.notify_all()
                    return True
                self._cond.wait(0.05)
            # outside the lock: the cancel token is its own leaf lock
            check_cancel()

    # ------------------------------------------------------------ consumer

    def __iter__(self) -> "ScanPipeline":
        return self

    def __next__(self):
        if self._staged is not None:
            item = self._staged
            self._staged = None
        else:
            item = self._take(block=True)
            if item is _EOS:
                raise StopIteration
            item = self._upload(item)
        # double-buffer: start the NEXT tile's upload while the caller
        # dispatches this one (non-blocking — never stalls here)
        if self._prestage:
            nxt = self._take(block=False)
            if nxt is not _EOS and nxt is not _EMPTY:
                self._staged = self._upload(nxt)
        if self._stage is None:
            return item
        staged, n = item
        return self._stage.ready(staged), n

    def _upload(self, item):
        if self._stage is None:
            return item
        tile, n = item
        if not self._prestage:
            tile = self._stage.pin(tile)
        return self._stage.upload(tile), n

    def _take(self, block: bool):
        from cloudberry_tpu_torch.lifecycle import check_cancel

        t0 = None
        while True:
            err = None
            with self._cond:
                if self._buf:
                    item = self._buf.popleft()
                    self._cond.notify_all()
                    if t0 is not None:
                        self.stall_s += time.perf_counter() - t0
                    return item
                if not block:
                    # the double-buffer probe must NEVER raise: a pending
                    # producer error belongs to the NEXT blocking take
                    return _EOS if (self._done and self._err is None) \
                        else _EMPTY
                if self._err is not None:
                    # staged tiles drained first: the error surfaces at the
                    # stream position the synchronous feed would raise it
                    err = self._err
                elif self._done:
                    return _EOS
                else:
                    if t0 is None:
                        t0 = time.perf_counter()
                    self._cond.wait(0.05)
            if err is not None:
                raise err
            check_cancel()

    # ------------------------------------------------------------ teardown

    def close(self) -> None:
        """Stop the reader and release every staged buffer. Idempotent;
        the tile loops call it in a ``finally``."""
        with self._cond:
            self._open = False
            self._buf.clear()
            self._cond.notify_all()
        self._thread.join(timeout=10.0)
        # a reader wedged past the join timeout leaks as a daemon thread;
        # record it so stats() never reads ScanStats concurrently with the
        # still-running writer
        self._reader_leaked = self._thread.is_alive()
        self._staged = None

    def stats(self) -> dict:
        with self._cond:
            feed_s = self.feed_s
            rec = {
                "enabled": True,
                "depth": self.depth,
                "tiles_prefetched": self.tiles,
                "max_depth": self.max_depth,
                "feed_s": round(feed_s, 6),
                "stall_s": round(self.stall_s, 6),
            }
        # overlap fraction: the share of producer work hidden behind
        # compute — feed time the consumer did NOT wait for
        if feed_s > 0:
            rec["overlap_frac"] = round(
                max(0.0, 1.0 - min(self.stall_s, feed_s) / feed_s), 4)
        st = self.scan_stats
        if self._reader_leaked:
            rec["reader_leaked"] = True  # snapshot would race the writer
        elif st is not None:
            rec.update(st.snapshot())
        return rec


class PlainFeed:
    """The pipeline-off twin: same close()/scan_stats surface over the raw
    generator, tiles uploaded synchronously when they are taken."""

    def __init__(self, gen, stage: Optional[DeviceStage] = None,
                 stats: Optional[ScanStats] = None):
        self._gen = gen
        self._stage = stage
        self.scan_stats = stats

    def __iter__(self):
        return self

    def __next__(self):
        tile, n = next(self._gen)
        if self._stage is not None:
            tile = self._stage.now(tile)
        return tile, n

    def close(self) -> None:
        self._gen.close()

    def stats(self) -> dict:
        rec = {"enabled": False}
        if self.scan_stats is not None:
            rec.update(self.scan_stats.snapshot())
        return rec


def maybe_pipeline(gen, config, device=None,
                   stats: Optional[ScanStats] = None,
                   min_depth: int = 1):
    """Wrap a tile generator in the prefetch pipeline when
    ``config.scan_pipeline`` enables it; a PlainFeed otherwise. With a
    ``device`` the feed yields tiles on that device (see DeviceStage).
    ``min_depth`` deepens the queue to the dispatch window
    (exec/tilepipe.py) so the feed never starves a W-deep device queue;
    it never turns the pipeline ON when the config disabled it."""
    sp = getattr(config, "scan_pipeline", None)
    on = sp is not None and sp.enabled and sp.prefetch_tiles >= 1
    stage = None
    if device is not None:
        stage = DeviceStage(device, pinned=on and sp.device_buffer)
    if on:
        return ScanPipeline(gen, depth=max(sp.prefetch_tiles, min_depth),
                            stage=stage, prestage=sp.device_buffer,
                            stats=stats)
    return PlainFeed(gen, stage=stage, stats=stats)


def close_feed(feed) -> None:
    """Deterministic feed teardown for the tile loops' ``finally``: works
    for ScanPipeline, PlainFeed and bare generators."""
    close = getattr(feed, "close", None)
    if close is not None:
        close()


def stamp_report(report: dict, feed) -> None:
    """Fold the feed's pipeline/decode accounting into the tiled run
    report. Call AFTER the loop finished and the feed closed."""
    stats_fn = getattr(feed, "stats", None)
    if stats_fn is not None:
        report["pipeline"] = stats_fn()


# ------------------------------------------------------------ decode pool


_pool = None
_pool_workers = 0
_pool_lock = threading.Lock()
# feeds currently holding each pool (id -> count), and the pools a larger
# one replaced: a replaced pool shuts down once its last holder releases
# it, so no feed ever submits to a shut-down executor
_pool_holders: dict = {}
_superseded: dict = {}


def decode_pool(config):
    """The shared column-decode thread pool (daemon workers named
    ``cbtpu_torch-scan-decode``, lazily created, grown to the largest
    requested size), held by the caller until ``release_decode_pool``.
    None when the pipeline is off, decode_workers <= 1, or the host
    exposes a single usable core; callers then decode serially on the
    reader thread."""
    global _pool, _pool_workers
    sp = getattr(config, "scan_pipeline", None)
    if sp is None or not sp.enabled or sp.decode_workers <= 1:
        return None
    import os

    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # platforms without affinity
        cores = os.cpu_count() or 1
    if cores < 2:
        return None
    from concurrent.futures import ThreadPoolExecutor

    with _pool_lock:
        if _pool is None or _pool_workers < sp.decode_workers:
            if _pool is not None:
                _retire(_pool)
            _pool = ThreadPoolExecutor(
                max_workers=sp.decode_workers,
                thread_name_prefix="cbtpu_torch-scan-decode")
            _pool_workers = sp.decode_workers
        _pool_holders[id(_pool)] = _pool_holders.get(id(_pool), 0) + 1
        return _pool


def release_decode_pool(pool) -> None:
    """A feed is done with ``pool`` (from ``decode_pool``): a superseded
    pool whose last holder this was shuts down."""
    if pool is None:
        return
    with _pool_lock:
        n = _pool_holders.get(id(pool), 0) - 1
        if n > 0:
            _pool_holders[id(pool)] = n
            return
        _pool_holders.pop(id(pool), None)
        if _superseded.pop(id(pool), None) is not None:
            pool.shutdown(wait=False)


def _retire(pool) -> None:
    """Called under ``_pool_lock`` when a larger pool replaces ``pool``:
    shut it down now if no feed holds it, else at its last release."""
    if _pool_holders.get(id(pool), 0) > 0:
        _superseded[id(pool)] = pool
    else:
        pool.shutdown(wait=False)


# --------------------------------------------------------- memory charge


def tile_host_bytes(scan, tile_rows: int, nseg: int = 1) -> int:
    """Host bytes one staged tile pins: every physical column at its dtype
    width plus one bool per validity column, times the padded tile shape
    (``nseg`` rows of ``tile_rows`` on the distributed path)."""
    width = len(scan.mask_map) + sum(np.dtype(f.type.np_dtype).itemsize
                                     for f in scan.fields)
    return width * int(tile_rows) * max(int(nseg), 1)


def queue_charge_bytes(scan, tile_rows: int, config,
                       nseg: int = 1) -> int:
    """The charge for the pipeline's staging memory: ``prefetch_tiles`` ×
    one tile's working set."""
    sp = getattr(config, "scan_pipeline", None)
    if sp is None or not sp.enabled or sp.prefetch_tiles < 1:
        return 0
    return sp.prefetch_tiles * tile_host_bytes(scan, tile_rows, nseg)
