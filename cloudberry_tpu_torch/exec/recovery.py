"""Tile-granular checkpoints of the tiled executors — the single-node part.

The tiled executors (exec/tiled.py) cross a host boundary after every
tile, and the state carried between tiles is small by construction (agg
partials bounded by the accumulator capacity, top-N rows bounded by the
LIMIT, sort/window run stores already in host memory). Every K-th tile
that drained clean is snapshotted to a host-side, statement-scoped
checkpoint (``RecoveryStore``, keyed by the statement id of the lifecycle
scope). A later attempt of the same statement — the adaptive retry after
an overflow that drained late, behind newer in-flight tiles
(exec/tilepipe.py) — resumes from the snapshot instead of re-streaming the
whole table, replaying at most W+K tiles.

Resume is bit-identical to an uninterrupted run: the tile stream is
deterministic (single-node consumption is a row-count prefix), and partial
merges are associative (plan/distribute.py ``_split_aggs``), so the
remaining rows may be re-tiled without changing the answer.

The JAX package's distributed half (consumed-row masks over the shard
layout, re-sharding onto a degraded mesh, the skew sentinel's replan) and
its device-loss retry belong to multi-segment execution and are not
carried.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from cloudberry_tpu_torch.obs.capacity import nbytes_of
from cloudberry_tpu_torch.utils.faultinject import fault_point


@dataclass
class TileCheckpoint:
    """One statement's resumable state at a tile boundary."""

    signature: tuple          # plan identity the resume must match
    mode: str                 # agg | topn | sort | window
    tiles_done: int           # cumulative tiles consumed across attempts
    consumed: int             # rows of the stream consumed (a prefix)
    payload: dict             # mode-specific host state (numpy only)
    g_cap: int = 0            # accumulator capacity at snapshot


class RecoveryStore:
    """Host-side, statement-scoped checkpoint store (one per session).
    Bounded LRU two ways: by statement count and by pinned host bytes
    (``config.recovery.max_bytes``). Evicting a victim only costs it a full
    replay (recovery is an optimization by contract), counted as
    ``ckpt_evictions``. Checkpoints die with their statement (the session
    discards them when the statement ends)."""

    def __init__(self, max_statements: int = 8, max_bytes: int = 0,
                 log=None):
        self._lock = threading.Lock()
        self._ckpts: dict[int, TileCheckpoint] = {}
        # tiles the CURRENT attempt of a statement has completed — the
        # resume reads it to count the tiles the failed attempt lost since
        # its last snapshot (tiles_replayed)
        self._progress: dict[int, int] = {}
        self.max_statements = max_statements
        self.max_bytes = int(max_bytes)
        self._bytes = 0
        self._log = log

    def save(self, sid: int, ckpt: TileCheckpoint) -> None:
        nb = nbytes_of(ckpt.payload)
        evicted = 0
        refused = 0
        if self.max_bytes > 0 and nb > self.max_bytes:
            # one snapshot alone over the budget: refuse the pin; the
            # statement's earlier (within-budget) checkpoint stays
            refused = 1
        else:
            with self._lock:
                old = self._ckpts.pop(sid, None)
                if old is not None:
                    self._bytes -= getattr(old, "_nbytes", 0)
                ckpt._nbytes = nb
                while self._ckpts and (
                        len(self._ckpts) >= self.max_statements
                        or (self.max_bytes > 0
                            and self._bytes + nb > self.max_bytes)):
                    victim = self._ckpts.pop(next(iter(self._ckpts)))
                    self._bytes -= getattr(victim, "_nbytes", 0)
                    evicted += 1
                self._ckpts[sid] = ckpt
                self._bytes += nb
        # counter bumps outside the store lock (a near-leaf lock)
        if self._log is not None:
            if evicted:
                self._log.bump("ckpt_evictions", evicted)
            if refused:
                self._log.bump("ckpt_oversize_refused", refused)

    def pinned_bytes(self) -> int:
        with self._lock:
            return int(self._bytes)

    def pinned_count(self) -> int:
        with self._lock:
            return len(self._ckpts)

    def load(self, sid: int, signature: tuple) -> Optional[TileCheckpoint]:
        with self._lock:
            ckpt = self._ckpts.get(sid)
            if ckpt is not None:
                # refresh recency
                self._ckpts.pop(sid)
                self._ckpts[sid] = ckpt
        if ckpt is None or ckpt.signature != signature:
            return None
        return ckpt

    def note_progress(self, sid: int, tiles_total: int) -> None:
        with self._lock:
            self._progress[sid] = tiles_total
            while len(self._progress) > 4 * self.max_statements:
                self._progress.pop(next(iter(self._progress)))

    def progress(self, sid: int) -> int:
        with self._lock:
            return self._progress.get(sid, 0)

    def discard(self, sid: int) -> None:
        with self._lock:
            ckpt = self._ckpts.pop(sid, None)
            if ckpt is not None:
                self._bytes -= getattr(ckpt, "_nbytes", 0)
            self._progress.pop(sid, None)


# ------------------------------------------------------------- signature


def plan_signature(exe) -> tuple:
    """Identity a checkpoint must match to seed a resumed run: same stream
    (table + data version + pruned part list), same mode, same carried
    state schema, same merge semantics — not the tile size, which the
    adaptive retry may change."""
    shape = exe.shape
    t = exe.session.catalog.tables.get(shape.stream.table_name)
    parts = getattr(shape.stream, "_store_parts", None)
    sig = (shape.stream.table_name,
           getattr(t, "_version", 0),
           shape.mode,
           tuple((f.name, str(np.dtype(f.type.np_dtype)))
                 for f in shape.partial_plan.fields),
           tuple(p["file"] for p in parts) if parts is not None else None)
    if shape.mode == "agg":
        sig += (tuple(n for n, _ in shape.agg.group_keys),
                tuple((s.func, s.out_name) for s in shape.merge_specs))
    else:
        sig += (repr(shape.sortnode.keys) if shape.sortnode is not None
                else None,)
    return sig


def _statement_id() -> Optional[int]:
    from cloudberry_tpu_torch.lifecycle import current_handle

    h = current_handle()
    sid = getattr(h, "statement_id", None)
    return sid if isinstance(sid, int) else None


# --------------------------------------------------------------- payloads


def acc_payload(acc) -> dict:
    """Host snapshot of an accumulator (cols dict, sel) — a device→host
    copy, read at a drain, when the tile it belongs to has verified."""
    cols, sel = acc
    return {"cols": {n: a.cpu().numpy() for n, a in cols.items()},
            "sel": sel.cpu().numpy()}


def runs_payload(runs: dict, key_runs: list) -> dict:
    """Host snapshot of a sort/window run store. The per-tile arrays are
    append-only, so shallow list copies pin the state without copying a
    byte of row data."""
    return {"runs": {n: list(arrs) for n, arrs in runs.items()},
            "key_runs": [list(arrs) for arrs in key_runs]}


def _pad_acc(payload: dict, cap: int):
    """Grow a snapshotted accumulator to the current capacity (adaptive
    g_cap growth between attempts); unchanged capacity restores
    verbatim."""
    cols, sel = payload["cols"], payload["sel"]
    old = sel.shape[-1]
    if old == cap:
        return dict(cols), sel
    extra = cap - old
    out = {}
    for n, a in cols.items():
        out[n] = np.concatenate([a, np.zeros((extra,), dtype=a.dtype)])
    sel = np.concatenate([sel, np.zeros((extra,), dtype=np.bool_)])
    return out, sel


# ------------------------------------------------------------ the context


class RecoveryCtx:
    """Per-run recovery state: loads a matching checkpoint, tracks
    progress, and snapshots the carried state every K tiles. A declined
    or absent checkpoint degrades to a fresh run — recovery is an
    optimization, never a correctness dependency."""

    def __init__(self, exe):
        self.exe = exe
        self.session = exe.session
        self.cfg = self.session.config.recovery
        self.store = self.session._recovery
        self.log = self.session.stmt_log
        self.sid = _statement_id()
        self.sig = plan_signature(exe)
        self.ckpt: Optional[TileCheckpoint] = None
        self.resumed = False
        self.tiles_base = 0
        self.skip_rows = 0
        self.replayed = 0
        self._last_snapshot = 0
        self._ckpt_broken = False
        if self.sid is None:
            return
        prior = self.store.progress(self.sid)
        ckpt = self.store.load(self.sid, self.sig)
        if ckpt is not None and fault_point("ckpt_resume"):
            ckpt = None  # chaos arm: force a fresh run
        if ckpt is not None and not self._accept(ckpt):
            self.log.bump("tile_resume_declined")
            ckpt = None
        if ckpt is not None:
            self.ckpt = ckpt
            self.resumed = True
            self.tiles_base = ckpt.tiles_done
            self._last_snapshot = ckpt.tiles_done
            self.skip_rows = int(ckpt.consumed)
            self.log.bump("tile_resumes")
        # tiles the failed attempt completed past the checkpoint are this
        # attempt's replay cost
        self.replayed = max(0, prior - self.tiles_base)
        if self.replayed:
            self.log.bump("tiles_replayed", self.replayed)
        self.store.note_progress(self.sid, self.tiles_base)

    def _accept(self, ckpt: TileCheckpoint) -> bool:
        # sort/window run stores restore as they are; an accumulator
        # restores into the same or a grown capacity (the signature already
        # pins the mode)
        if self.exe.shape.mode in ("sort", "window"):
            return True
        return ckpt.g_cap <= self._current_cap()

    def _current_cap(self) -> int:
        shape = self.exe.shape
        if shape.mode == "agg":
            return shape.g_cap if shape.agg.group_keys else 1
        return shape.g_cap

    def _decline(self) -> None:
        self.resumed = False
        self.ckpt = None
        self.tiles_base = 0
        self.skip_rows = 0
        self._last_snapshot = 0
        self.log.bump("tile_resume_declined")
        if self.sid is not None:
            self.store.note_progress(self.sid, 0)

    def restore_acc(self, acc):
        """Initial accumulator from the checkpoint (agg/topn modes), as
        tensors on ``acc``'s device. Read ``skip_rows``/``tiles_base``
        AFTER this call — a failed restore declines the resume."""
        if not self.resumed:
            return acc
        try:
            import torch

            cols, sel = _pad_acc(self.ckpt.payload, self._current_cap())
            dev = acc[1].device
            return ({n: torch.from_numpy(np.array(a)).to(dev)
                     for n, a in cols.items()},
                    torch.from_numpy(np.array(sel)).to(dev))
        except Exception:  # noqa: BLE001 — degrade to a fresh run
            self._decline()
            return acc

    def restore_runs(self, runs, key_runs):
        """Initial (runs, key_runs) from the checkpoint (sort/window
        modes); the fresh stores pass through on a declined resume."""
        if not self.resumed:
            return runs, key_runs
        try:
            p = self.ckpt.payload
            return ({n: list(arrs) for n, arrs in p["runs"].items()},
                    [list(arrs) for arrs in p["key_runs"]])
        except Exception:  # noqa: BLE001 — degrade to a fresh run
            self._decline()
            return runs, key_runs

    def snapshot_due(self, tiles_local: int) -> bool:
        """True when ``tick`` at this tile ordinal would snapshot (asked at
        submit time, so the windowed loop can stage the accumulator's
        host copy before the next step)."""
        if (self.sid is None or not self.cfg.enabled
                or self.cfg.checkpoint_every <= 0 or self._ckpt_broken):
            return False
        total = self.tiles_base + tiles_local
        return total - self._last_snapshot >= self.cfg.checkpoint_every

    def tick(self, tiles_local: int, payload_fn) -> None:
        """After every drained-clean tile: note progress; snapshot at the
        K-tile boundary. ``payload_fn`` builds the host payload lazily."""
        if self.sid is None:
            return
        total = self.tiles_base + tiles_local
        self.store.note_progress(self.sid, total)
        if not self.cfg.enabled or self.cfg.checkpoint_every <= 0:
            return
        if self._ckpt_broken:
            return
        if total - self._last_snapshot < self.cfg.checkpoint_every:
            return
        if fault_point("ckpt_save"):
            return  # chaos arm: suppress checkpointing
        try:
            self._snapshot(total, tiles_local, payload_fn())
        except Exception:  # noqa: BLE001
            # a failed snapshot must not kill an otherwise healthy
            # statement: stop checkpointing and let the run finish
            self._ckpt_broken = True
            self.log.bump("tile_ckpt_failed")

    def _snapshot(self, tiles_total: int, tiles_local: int,
                  payload: dict) -> None:
        exe = self.exe
        consumed = self.skip_rows + tiles_local * exe.tile_rows
        self.store.save(self.sid, TileCheckpoint(
            signature=self.sig, mode=exe.shape.mode, tiles_done=tiles_total,
            consumed=consumed, payload=payload,
            g_cap=self._current_cap()))
        self._last_snapshot = tiles_total
        self.log.bump("tile_checkpoints")

    def stamp_report(self, report: dict) -> None:
        report["resumed_from_tile"] = self.tiles_base
        report["tiles_replayed"] = self.replayed


def begin(exe) -> Optional[RecoveryCtx]:
    """Recovery context for one executable run, or None when the subsystem
    is off or there is no statement scope to key on. Never raises."""
    session = exe.session
    cfg = getattr(session.config, "recovery", None)
    if cfg is None or not cfg.enabled \
            or getattr(session, "_recovery", None) is None:
        return None
    try:
        return RecoveryCtx(exe)
    except Exception:  # noqa: BLE001 — resume is best-effort by contract
        session.stmt_log.bump("tile_resume_declined")
        return None
