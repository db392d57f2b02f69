"""Tile-granular checkpoints of the tiled executors.

The tiled executors (exec/tiled.py, exec/tiled_dist.py) cross a host
boundary after every tile, and the state carried between tiles is small
by construction (agg partials bounded by the accumulator capacity, top-N
rows bounded by the LIMIT, sort/window run stores already in host
memory). Every K-th tile that drained clean is snapshotted to a
host-side, statement-scoped checkpoint (``RecoveryStore``, keyed by the
statement id of the lifecycle scope). A later attempt of the same
statement resumes from the snapshot instead of re-streaming the whole
table. Three paths reach a resume:

- the session's device-loss retry (parallel/health.py
  ``run_with_retry``): a loss at a tile (the ``tile_device_lost`` seam)
  re-dispatches the statement, possibly on fewer segments after a
  degrade, and its new executable resumes from the last snapshot;
- the adaptive retry after an overflow that drained late, behind newer
  in-flight tiles (exec/tilepipe.py), replaying at most W+K tiles;
- the skew sentinel's mid-statement replan (exec/tiled.py
  ``SkewSentinel``): it forces a snapshot at the alarm tile
  (``force_snapshot``) and raises ``TileReplan``; the session re-plans
  and the NEW executable resumes from exactly there.

Resume is bit-identical to an uninterrupted run:

- the tile stream is deterministic. Single-node consumption is a
  row-count prefix; distributed consumption is a boolean mask over the
  table's global row indices, reconstructed from the deterministic
  jump-hash shard layout (``Table.shard_assignment``, the placement
  hash), so nothing extra is stored per tile;
- partial merges are associative (plan/distribute.py ``_split_aggs``), so
  the remaining rows may be re-tiled — and re-sharded at another segment
  count — without changing the answer;
- checkpointed partials re-place by mode (``REPLACEABLE``): partials that
  flow through a merge motion (two-stage agg) or a global gather (top-N)
  are placement-free and round-robin; sort/window run stores are pooled
  host-side already; colocated one-stage agg partials would need the
  group-key hash to re-place, so a changed-nseg resume declines there.

A resume at another segment count (a degrade, or a cutover that landed
between attempts) counts ``topo_resharded_resumes``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from cloudberry_tpu_torch.obs.capacity import nbytes_of
from cloudberry_tpu_torch.utils.faultinject import fault_point


class TileReplan(Exception):
    """Mid-statement adaptive replan request (NOT a failure).

    Raised by the tiled-dist skew sentinel (exec/tiled.py SkewSentinel)
    after it has (a) folded the cumulative per-destination motion rows
    into the feedback store as a partial sketch and (b) checkpointed the
    carried state via ``RecoveryCtx.force_snapshot``. The session evicts
    the cached statement, re-plans — the memo now sees the fresh sketch —
    and the new executable resumes from the checkpoint (``plan_signature``
    excludes nseg, tile size and motion choices, so a differently shaped
    plan still accepts it).

    Deliberately NOT an ExecError: the adaptive grow/halve loop
    (exec/tiled.py ``_run_adaptive``) absorbs ExecError to retry at a new
    capacity, and an adaptation request must propagate past it to the
    session."""

    def __init__(self, msg: str, tiles_done: int = 0, ratio: float = 0.0):
        super().__init__(msg)
        self.tiles_done = tiles_done
        self.ratio = ratio


# The declared re-placement rule per checkpointed mode — HOW a snapshot's
# carried state re-places onto a changed segment count. Keys must equal
# exec/tiled.py CHECKPOINT_MODES (the plan verifier's
# recovery-mode-unreplaceable rule holds the two tables together both
# ways); ``_accept`` consults both membership and the placement_free flag,
# so an undeclared mode never resumes from a checkpoint.
REPLACEABLE = {
    "agg": {"placement_free": False,
            "rule": "round-robin partials ahead of the merge motion "
                    "(colocated one-stage at changed nseg DECLINES)"},
    "topn": {"placement_free": False,
             "rule": "host-side global top-m via sort_key_u64, "
                     "then round-robin"},
    "sort": {"placement_free": True,
             "rule": "run stores are pooled already"},
    "window": {"placement_free": True,
               "rule": "run stores are pooled already"},
}


@dataclass
class TileCheckpoint:
    """One statement's resumable state at a tile boundary."""

    signature: tuple          # plan identity the resume must match
    mode: str                 # agg | topn | sort | window
    tiles_done: int           # cumulative tiles consumed across attempts
    consumed: object          # int row prefix (single) | bool mask (dist)
    payload: dict             # mode-specific host state (numpy only)
    g_cap: int = 0            # accumulator capacity at snapshot
    nseg: int = 1             # segment count the snapshot was made at
    tile_rows: int = 0        # tile size at snapshot time (telemetry)
    segs: tuple = ()          # (first, end) of the segments the payload
                              # holds (this process's; every one alone)


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
        nb = nbytes_of(ckpt.payload) + nbytes_of(ckpt.consumed)
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
    state schema, same merge semantics. Deliberately NOT nseg or the tile
    size — the adaptive retry may change the tile, a replan the motions."""
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
        sig += (tuple(_group_names(shape)),
                tuple((s.func, s.out_name) for s in shape.merge_specs))
    else:
        sig += (repr(shape.sortnode.keys) if shape.sortnode is not None
                else None,)
    return sig


def _group_names(shape) -> list:
    """The agg accumulator's group columns: a distributed shape names
    them, a single-node one holds its aggregation."""
    groups = getattr(shape, "group_names", None)
    if groups is None:
        groups = [n for n, _ in shape.agg.group_keys]
    return groups


def _statement_id() -> Optional[int]:
    from cloudberry_tpu_torch.lifecycle import current_handle

    h = current_handle()
    sid = getattr(h, "statement_id", None)
    return sid if isinstance(sid, int) else None


# --------------------------------------------------------------- payloads


def acc_payload(acc) -> dict:
    """Host snapshot of an accumulator (cols dict, sel) — a device→host
    copy, read at a drain, when the tile it belongs to has verified. A
    distributed accumulator's tensors are (nseg, capacity)."""
    cols, sel = acc
    return {"cols": {n: a.cpu().numpy() for n, a in cols.items()},
            "sel": sel.cpu().numpy()}


def runs_payload(runs: dict, key_runs: list) -> dict:
    """Host snapshot of a sort/window run store. The per-tile arrays are
    append-only, so shallow list copies pin the state without copying a
    byte of row data."""
    return {"runs": {n: list(arrs) for n, arrs in runs.items()},
            "key_runs": [list(arrs) for arrs in key_runs]}


# ----------------------------------------------------- shard-layout math
# The deterministic shard layout (Session.sharded_table): stable argsort
# of the jump-hash assignment, shard s owning sorted positions
# [starts[s], starts[s]+counts[s]). Reconstructable from the table alone,
# so checkpoints never store per-tile row identities.


def _shard_layout(table, nseg: int):
    """(row order, per-segment counts, starts): ``Table.shard_layout``,
    which keeps it per table version and segment count."""
    layout = table.shard_layout(nseg)
    if layout is None:  # replicated tables never stream (walk guarantees)
        raise ValueError("replicated table cannot be a tile stream")
    return layout


def fresh_consumed_mask(table, nseg: int, tile_rows: int,
                        tiles: int, layout=None) -> np.ndarray:
    """Global consumed-row mask after ``tiles`` lock-step tiles of the
    standard distributed feed (tiled_dist ``_dist_tile_feed``): each shard
    consumed its first min(tiles·tile_rows, count) layout rows.
    ``layout`` reuses a prior ``_shard_layout`` (invariant for a run;
    recomputing it hashes and argsorts the whole table)."""
    order, counts, starts = (layout if layout is not None
                             else _shard_layout(table, nseg))
    mask = np.zeros(table.num_rows, dtype=np.bool_)
    for s in range(nseg):
        c = int(min(tiles * tile_rows, counts[s]))
        mask[order[starts[s]:starts[s] + c]] = True
    return mask


class _ResumedDistFeed:
    """Host tile feed over the REMAINING rows of a distributed stream,
    sharded by the placement hash at the current segment count. With an
    unchanged nseg this is exactly the suffix of the original feed; at
    another nseg every plan invariant re-derives, because the sharding
    rule is the same jump hash placement uses. It yields the rows of the
    segments ``segs`` (this process's; every segment by default), at the
    cluster's lock-step tile count."""

    def __init__(self, scan, session, tile_rows: int,
                 consumed_mask: np.ndarray, nseg: int, segs=None):
        t = session.catalog.table(scan.table_name)
        t.ensure_loaded()
        self.base_mask = consumed_mask
        self.tile_rows = tile_rows
        self.nseg = nseg
        self.segs = range(nseg) if segs is None else segs
        remaining = np.flatnonzero(~consumed_mask)
        assign = t.shard_assignment(nseg)
        a = assign[remaining]
        # stable order of 16-bit segment ids (numpy's radix sort)
        order = np.argsort(a.astype(np.uint16), kind="stable")
        self.rsorted = remaining[order]
        self.counts = np.bincount(a, minlength=nseg).astype(np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.counts)])
        cols: dict[str, np.ndarray] = {}
        for phys in scan.column_map:
            cols[phys] = np.asarray(t.data[phys])
        for phys in scan.mask_map:
            vm = t.validity.get(phys)
            cols[f"$nn:{phys}"] = (np.asarray(vm, dtype=np.bool_)
                                   if vm is not None
                                   else np.ones(t.num_rows, dtype=np.bool_))
        self._cols = cols

    def __iter__(self):
        segs, tile_rows = self.segs, self.tile_rows
        max_rows = int(self.counts.max()) if len(self.counts) else 0
        lanes = np.arange(tile_rows)
        for off in range(0, max_rows, tile_rows):
            idx = np.zeros((len(segs), tile_rows), dtype=np.int64)
            tile_ns = np.clip(self.counts[segs.start:segs.stop] - off, 0,
                              tile_rows)
            for i, s in enumerate(segs):
                n_s = int(tile_ns[i])
                lo = int(self.starts[s]) + off
                idx[i, :n_s] = self.rsorted[lo:lo + n_s]
            pad = lanes[None, :] >= tile_ns[:, None]
            tile = {}
            for name, arr in self._cols.items():
                g = arr[idx]
                g[pad] = 0  # padded lanes mirror the zero-fill feed
                tile[name] = np.ascontiguousarray(g)
            yield tile, tile_ns

    def consumed_after(self, tiles_local: int) -> np.ndarray:
        mask = self.base_mask.copy()
        for s in range(self.nseg):
            c = int(min(tiles_local * self.tile_rows, self.counts[s]))
            lo = int(self.starts[s])
            mask[self.rsorted[lo:lo + c]] = True
        return mask


# ----------------------------------------------------------- restore math


def _pad_acc(payload: dict, cap: int):
    """Grow a snapshotted accumulator to the current capacity (adaptive
    g_cap growth between attempts) along its last axis; an unchanged
    capacity restores verbatim. Never shrinks — callers decline that
    resume instead."""
    cols, sel = payload["cols"], payload["sel"]
    old = sel.shape[-1]
    if old == cap:
        return dict(cols), sel
    extra = cap - old
    out = {}
    for n, a in cols.items():
        pad_shape = a.shape[:-1] + (extra,)
        out[n] = np.concatenate([a, np.zeros(pad_shape, dtype=a.dtype)],
                                axis=-1)
    sel = np.concatenate(
        [sel, np.zeros(sel.shape[:-1] + (extra,), dtype=np.bool_)],
        axis=-1)
    return out, sel


def _pooled_rows(payload: dict):
    """Selected accumulator rows pooled across every segment block."""
    sel = payload["sel"]
    flat_sel = sel.reshape(-1)
    return ({n: a.reshape(-1, *a.shape[2:])[flat_sel]
             for n, a in payload["cols"].items()},
            int(flat_sel.sum()))


def _round_robin_acc(rows: dict, n_rows: int, fields, nseg: int,
                     cap: int):
    """Place pooled partial rows round-robin onto ``nseg`` accumulator
    blocks of ``cap`` rows — legal whenever a motion (or the top-N global
    gather) re-routes partials by value at finalize time."""
    cols = {f.name: np.zeros((nseg, cap), dtype=f.type.np_dtype)
            for f in fields}
    sel = np.zeros((nseg, cap), dtype=np.bool_)
    if n_rows:
        segs = np.arange(n_rows) % nseg
        slots = np.arange(n_rows) // nseg
        for f in fields:
            cols[f.name][segs, slots] = rows[f.name]
        sel[segs, slots] = True
    return cols, sel


def _host_topn(rows: dict, n_rows: int, sort_keys, m: int):
    """The best ``m`` pooled top-N rows by the device's own key
    normalization (``kernels.sort_key_u64`` on host tensors — the same
    function, so host and device orders cannot disagree; its biased
    int64 keys order as the reference's u64 keys do). Only ColumnRef keys
    qualify; callers decline otherwise."""
    import torch

    from cloudberry_tpu_torch.exec import kernels as K
    from cloudberry_tpu_torch.plan import expr as ex

    if n_rows <= m:
        return rows, n_rows
    karr = []
    for e, asc in sort_keys:
        if not isinstance(e, ex.ColumnRef):
            return None  # caller declines
        u = K.sort_key_u64(torch.from_numpy(
            np.ascontiguousarray(rows[e.name]))).numpy()
        karr.append(u if asc else ~u)
    order = np.lexsort(tuple(reversed(karr)))[:m]
    return {n: a[order] for n, a in rows.items()}, m


def _to_device(acc, device):
    """A host (cols, sel) accumulator as tensors on ``device``."""
    import torch

    cols, sel = acc
    return ({n: torch.from_numpy(np.array(a)).to(device)
             for n, a in cols.items()},
            torch.from_numpy(np.array(sel)).to(device))


# ------------------------------------------------------------ the context


class RecoveryCtx:
    """Per-run recovery state: loads a matching checkpoint (re-sharding it
    when the segment count changed), tracks progress, and snapshots the
    carried state every K tiles. A declined or absent checkpoint degrades
    to a fresh run — recovery is an optimization, never a correctness
    dependency."""

    def __init__(self, exe, dist: bool):
        self.exe = exe
        self.dist = dist
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
        self._feed: Optional[_ResumedDistFeed] = None
        self._layout = None  # cached fresh-path _shard_layout
        self._restored_acc = None
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
            if not dist:
                self.skip_rows = int(ckpt.consumed)
            self.log.bump("tile_resumes")
            if dist and ckpt.nseg != exe.nseg:
                # the remaining rows re-shard at the new segment count
                self.log.bump("topo_resharded_resumes")
        # tiles the failed attempt completed past the checkpoint are this
        # attempt's replay cost
        self.replayed = max(0, prior - self.tiles_base)
        if self.replayed:
            self.log.bump("tiles_replayed", self.replayed)
        self.store.note_progress(self.sid, self.tiles_base)

    # ------------------------------------------------------- acceptance

    def _accept(self, ckpt: TileCheckpoint) -> bool:
        from cloudberry_tpu_torch.parallel.mesh import process_count

        exe, shape = self.exe, self.exe.shape
        mode = shape.mode
        spec = REPLACEABLE.get(mode)
        if spec is None:
            return False  # no declared re-placement rule: never resume
        if self.dist and process_count() > 1 and mode not in ("agg", "topn"):
            # a cluster's host run stores hold each process's segments
            # only: its sort and window runs restart fresh
            return False
        if spec["placement_free"]:
            return True  # host run stores need no re-placement
        cur_cap = self._current_cap()
        if self.dist:
            if not self._relayout(ckpt):
                return ckpt.g_cap <= cur_cap
            # changed segment count: only placement-free partials re-shard
            if mode == "agg":
                # colocated one-stage (the group-key hash would have to
                # re-place rows) and global single-row accumulators
                # (capacity 1 cannot absorb pooled partials) decline
                return shape.merge_motion is not None \
                    and bool(shape.group_names)
            if mode == "topn":
                from cloudberry_tpu_torch.plan import expr as ex

                return all(isinstance(e, ex.ColumnRef)
                           for e, _ in shape.sortnode.keys)
            return False
        return ckpt.g_cap <= cur_cap

    def _relayout(self, ckpt: TileCheckpoint) -> bool:
        """True when the checkpoint's payload was made for other segments
        than this run's: another segment count, or (in a cluster) another
        range of them on this process. Its partials then re-shard."""
        return ckpt.nseg != self.exe.nseg or ckpt.segs != _seg_span(self.exe)

    def _current_cap(self) -> int:
        shape = self.exe.shape
        if shape.mode == "agg":
            return shape.g_cap if _group_names(shape) else 1
        return shape.g_cap

    # --------------------------------------------------------- restoring

    def _decline(self) -> None:
        """Fall back to a fresh run mid-prepare: any restore failure must
        cost only the replay."""
        self.resumed = False
        self.ckpt = None
        self.tiles_base = 0
        self.skip_rows = 0
        self._feed = None
        self._restored_acc = None
        self._last_snapshot = 0
        self.log.bump("tile_resume_declined")
        if self.sid is not None:
            self.store.note_progress(self.sid, 0)

    def prepare_dist(self) -> None:
        """All fallible distributed-resume work in one guarded place,
        BEFORE the executable re-tiles: build the remaining-row feed, and
        at a changed segment count re-shard the pooled partials (which
        may need a larger per-segment accumulator than the fresh plan
        chose)."""
        if not (self.resumed and self.dist):
            return
        exe, shape, ckpt = self.exe, self.exe.shape, self.ckpt
        # this process's segments: the payload holds their accumulators,
        # and the re-shard places their pooled partials on them
        segs = getattr(exe, "segs", range(exe.nseg))
        reshard = self._relayout(ckpt) and shape.mode in ("agg", "topn")
        need, failed = 0, False
        try:
            self._feed = _ResumedDistFeed(
                shape.stream, self.session, exe.tile_rows, ckpt.consumed,
                exe.nseg, segs)
            if reshard:
                rows, n_rows = _pooled_rows(ckpt.payload)
                if shape.mode == "topn":
                    hit = _host_topn(rows, n_rows, shape.sortnode.keys,
                                     shape.g_cap)
                    if hit is None:  # non-ColumnRef key slipped acceptance
                        raise ValueError("topn keys not host-sortable")
                    rows, n_rows = hit
                need = -(-n_rows // len(segs)) if n_rows else 0  # ceil
        except Exception:  # noqa: BLE001 — degrade to a fresh run
            failed = True
        if reshard:
            # every process of a cluster sizes its accumulator alike, or
            # every one declines
            need, failed = _cluster_max(need, failed)
        if failed:
            self._decline()
            return
        if not reshard:
            return
        if shape.mode == "agg" and need > shape.g_cap:
            shape.g_cap = need
            exe._compiled = None
            exe._refresh_report()
        self._restored_acc = _round_robin_acc(
            rows, n_rows, shape.partial_plan.fields, len(segs),
            self._current_cap())

    def restore_acc(self, acc):
        """Initial accumulator from the checkpoint (agg/topn modes), as
        tensors on ``acc``'s device. Read ``skip_rows``/``tiles_base``
        AFTER this call — a failed restore declines the resume."""
        if not self.resumed:
            return acc
        dev = acc[1].device
        if self._restored_acc is not None:  # re-sharded partials
            return _to_device(self._restored_acc, dev)
        try:
            return _to_device(_pad_acc(self.ckpt.payload,
                                       self._current_cap()), dev)
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

    def feed(self):
        """The distributed remaining-row feed of a resumed run; None means
        the standard fresh feed applies."""
        return self._feed if self.resumed else None

    # ------------------------------------------------------ tick/snapshot

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

    def force_snapshot(self, tiles_local: int, payload_fn) -> bool:
        """Snapshot NOW, ignoring the K-tile cadence — the mid-statement
        adaptive replan checkpoints the carried state at the alarm tile so
        the replanned executable resumes from exactly here. True when the
        checkpoint was saved; an adaptation must not proceed on a failed
        save (the replanned run would replay consumed tiles)."""
        if self.sid is None or not self.cfg.enabled or self._ckpt_broken:
            return False
        total = self.tiles_base + tiles_local
        if self._last_snapshot == total:
            return True      # the cadence tick already saved this tile
        try:
            self._snapshot(total, tiles_local, payload_fn())
            return True
        except Exception:  # noqa: BLE001 — same degrade rule as tick()
            self._ckpt_broken = True
            self.log.bump("tile_ckpt_failed")
            return False

    def _snapshot(self, tiles_total: int, tiles_local: int,
                  payload: dict) -> None:
        exe = self.exe
        if self.dist:
            nseg = exe.nseg
            if self._feed is not None:
                consumed = self._feed.consumed_after(tiles_local)
            else:
                t = self.session.catalog.table(
                    exe.shape.stream.table_name)
                if self._layout is None:
                    self._layout = _shard_layout(t, nseg)
                consumed = fresh_consumed_mask(
                    t, nseg, exe.tile_rows, tiles_local,
                    layout=self._layout)
        else:
            consumed = self.skip_rows + tiles_local * exe.tile_rows
            nseg = 1
        self.store.save(self.sid, TileCheckpoint(
            signature=self.sig, mode=exe.shape.mode, nseg=nseg,
            tile_rows=exe.tile_rows, tiles_done=tiles_total,
            consumed=consumed, payload=payload,
            g_cap=self._current_cap(),
            segs=_seg_span(exe) if self.dist else ()))
        self._last_snapshot = tiles_total
        self.log.bump("tile_checkpoints")

    def stamp_report(self, report: dict) -> None:
        report["resumed_from_tile"] = self.tiles_base
        report["tiles_replayed"] = self.replayed


def _seg_span(exe) -> tuple:
    """(first, end) of a distributed executable's segments on this
    process."""
    segs = getattr(exe, "segs", range(exe.nseg))
    return (segs.start, segs.stop)


def _cluster_max(need: int, failed: bool):
    """(the largest ``need``, whether any process failed) over a
    cluster's processes; the arguments in one process."""
    import torch

    from cloudberry_tpu_torch.parallel.transport import cluster_reduce

    v = cluster_reduce(torch.tensor([need, int(failed)], dtype=torch.int64),
                       "max")
    return int(v[0]), bool(v[1])


def agree_resume(ctx: Optional[RecoveryCtx]) -> bool:
    """Whether this distributed run resumes, the same on every process
    of a cluster: a process that has no checkpoint (or declined one)
    makes every process decline. Called by every process at the same
    points of a run (``ctx`` None: no recovery context here)."""
    from cloudberry_tpu_torch.parallel.transport import cluster_all

    resumed = ctx is not None and ctx.resumed
    agreed = cluster_all(resumed)
    if resumed and not agreed:
        ctx._decline()
    return agreed


def begin(exe, dist: bool = False) -> Optional[RecoveryCtx]:
    """Recovery context for one executable run, or None when the subsystem
    is off or there is no statement scope to key on. Never raises."""
    session = exe.session
    cfg = getattr(session.config, "recovery", None)
    if cfg is None or not cfg.enabled \
            or getattr(session, "_recovery", None) is None:
        return None
    try:
        return RecoveryCtx(exe, dist)
    except Exception:  # noqa: BLE001 — resume is best-effort by contract
        session.stmt_log.bump("tile_resume_declined")
        return None
