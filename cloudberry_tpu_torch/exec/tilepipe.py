"""Windowed in-flight tile dispatch — keep the device queue full.

A tiled loop (exec/tiled.py) that reads each tile's overflow checks right
after launching its step drains the device queue to empty between tiles:
every check read is a host sync. ``TilePipe`` keeps a bounded window of W
steps in flight instead. ``submit(idx, checks, payload)`` runs right after
tile ``idx``'s step has been enqueued: it starts an asynchronous copy of
the tile's check flags (and of a staged checkpoint) into pinned host
memory, records a CUDA event behind them, and drains the oldest entries
until at most ``window-1`` remain. A drain waits on the OLDEST tile's
event only. ``submit`` never calls ``.item()``, ``.cpu()`` or ``bool()``
on a device tensor — any of them would synchronize the whole stream.
``drain_all()`` flushes the tail after the feed ends.

Correctness rules (the JAX package's, unchanged):

- **Deferred failure, bounded by W.** A capacity-overflow check of tile k
  is observed at most W tiles late, while tiles k+1..k+W-1 may already be
  enqueued. The checkpoint tick for a tile happens only once that tile has
  DRAINED CLEAN, so the last checkpoint never includes a failed tile's
  state: the adaptive retry resumes from it through the recovery store
  (exec/recovery.py) and replays at most W+K tiles at the grown capacity —
  bit-identical to the synchronous path, since tile order, operators and
  merge semantics are unchanged; only when the host LEARNS of a failure
  moves.
- **Checkpoint payloads stage at submit** (``stage_checkpoint``): a copy
  of the carried accumulator, taken on the device in stream order before
  the next step replaces it, whose host copy is read at drain time.
- **Cancellation still polls per drained tile** (``_raise_tile_checks``).
- **``inflight_tiles=1`` is the synchronous loop, exactly**: submit
  drains the tile it was given at once. That is the CPU device's default
  (``effective_window``); CUDA defaults to a window of 4.

The JAX package also donates the accumulator to the next step
(``step_donation``, ``jax.jit(donate_argnums=...)``) so XLA updates it in
place. Eager PyTorch has no counterpart: each step allocates its merged
accumulator and the old one is freed by reference counting once nothing
holds it, so the port keeps no donation rule.

Telemetry: ``drain_stall_s`` (host seconds blocked on drained flags) and
``inflight_depth`` (window high-water mark) stamp the tiled run report;
the ``tile_deferred_overflows`` counter rides the session's statement log. The
window's extra in-flight tiles are charged into the report's
``est_pipeline_bytes`` (``window_charge_bytes``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

import torch

from cloudberry_tpu_torch.utils.faultinject import fault_point

# Auto window depth on CUDA: deep enough to overlap the flag copy of tile
# k and the upload of tile k+2 with tile k+1's compute, shallow enough
# that a deferred overflow replays only a few tiles past the checkpoint.
_AUTO_ACCEL_WINDOW = 4
_MAX_WINDOW = 64


def effective_window(config, platform: str) -> int:
    """The in-flight tile window for this run. ``platform`` is the session
    device's type. ``inflight_tiles <= 0`` means auto: 1 on ``cpu`` (the
    synchronous loop, exactly), ``_AUTO_ACCEL_WINDOW`` on ``cuda``."""
    tp = getattr(config, "tile_pipeline", None)
    if tp is None or not tp.enabled:
        return 1
    w = int(tp.inflight_tiles)
    if w <= 0:
        w = 1 if platform == "cpu" else _AUTO_ACCEL_WINDOW
    return max(1, min(w, _MAX_WINDOW))


def window_charge_bytes(scan, tile_rows: int, config,
                        platform: str, nseg: int = 1) -> int:
    """Charge for the dispatch window: beyond the first tile (already in
    est_step_bytes), each additional in-flight tile pins one tile's
    working set on the device until its flags drain."""
    w = effective_window(config, platform)
    if w <= 1:
        return 0
    from cloudberry_tpu_torch.exec import scanpipe as SP

    return (w - 1) * SP.tile_host_bytes(scan, tile_rows, nseg)


class _HostCopy:
    """Tensors on their way to host memory: pinned buffers filled with
    ``copy_(non_blocking=True)`` on the current stream, and the event
    recorded behind them. ``wait`` blocks on that event alone."""

    def __init__(self, tensors: list):
        self.event = None
        self.host = []
        for t in tensors:
            if t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.host.append(h)
                if self.event is None:
                    self.event = torch.cuda.Event()
            else:
                self.host.append(t.clone())
        if self.event is not None:
            self.event.record(torch.cuda.current_stream())

    def wait(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _flags(checks: dict) -> torch.Tensor:
    """Every check reduced to one bool each, stacked on the device (no
    host read)."""
    return torch.stack([torch.as_tensor(v).reshape(-1).any()
                        for v in checks.values()])


def stage_checkpoint(acc):
    """Checkpoint staging for a windowed submit (window > 1 only): copy the
    carried accumulator (cols dict, sel) to pinned host memory behind an
    event, and return the zero-arg payload function ``RecoveryCtx.tick``
    runs at drain time — by then the copy has usually landed."""
    cols, sel = acc
    names = list(cols)
    cp = _HostCopy([cols[n] for n in names] + [sel])

    def payload():
        host = cp.wait()
        return {"cols": {n: host[i].numpy() for i, n in enumerate(names)},
                "sel": host[-1].numpy()}

    return payload


class Drained(NamedTuple):
    """One verified tile, handed back to the loop in stream order."""

    idx: int        # global tile index (n_base + local ordinal)
    payload: object  # whatever the loop attached at submit


class _InFlight(NamedTuple):
    idx: int
    names: list     # check messages, in flag order
    flags: object   # _HostCopy of the stacked flags, or None
    payload: object


class TilePipe:
    """Bounded window of in-flight tile steps whose check flags drain late.
    Single-threaded by design: the statement thread owns both ends (the
    device's stream order IS the concurrency), so an abandoned pipe (error
    unwind) just drops its entries."""

    def __init__(self, session, window: int):
        self.window = max(int(window), 1)
        self._log = getattr(session, "stmt_log", None)
        self._q: deque = deque()
        self.max_depth = 0        # in-flight high-water mark
        self.drain_stall_s = 0.0  # host blocked on drained flags
        self.deferred_fail = False  # a check fired with newer tiles live

    def submit(self, idx: int, checks: dict, payload=None) -> list:
        """Enqueue tile ``idx``'s just-launched check flags and start their
        copy to the host; drain until at most ``window-1`` entries remain.
        Returns the drained entries in stream order — at window=1 always
        exactly the submitted tile."""
        fault_point("tile_enqueue")
        names = list(checks)
        flags = _HostCopy([_flags(checks)]) if names else None
        self._q.append(_InFlight(idx, names, flags, payload))
        self.max_depth = max(self.max_depth, len(self._q))
        out = []
        while len(self._q) >= self.window:
            out.append(self.drain_one())
        return out

    def drain_one(self) -> Drained:
        """Wait for the OLDEST in-flight tile's flags, raise the first that
        fired (a failure with newer tiles still in flight is *deferred*),
        and hand the tile back."""
        from cloudberry_tpu_torch.exec.tiled import _raise_tile_checks

        entry = self._q.popleft()
        t0 = time.perf_counter()
        try:
            # inside the timed region: a slow drain is drain stall
            fault_point("tile_drain")
            fired = {}
            if entry.flags is not None:
                host = entry.flags.wait()[0].numpy()
                fired = dict(zip(entry.names, host))
            _raise_tile_checks(fired, entry.idx)
        except Exception:
            if self._q:
                self.deferred_fail = True
                if self._log is not None:
                    self._log.bump("tile_deferred_overflows")
            raise
        self.drain_stall_s += time.perf_counter() - t0
        return Drained(entry.idx, entry.payload)

    def drain_all(self) -> list:
        """Flush the window after the feed ends."""
        out = []
        while self._q:
            out.append(self.drain_one())
        return out

    def stamp(self, report: dict) -> None:
        report["tile_window"] = self.window
        report["inflight_depth"] = self.max_depth
        report["drain_stall_s"] = round(self.drain_stall_s, 6)
