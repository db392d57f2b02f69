"""Slow-statement flight recorder — the one statement that blew its SLO,
captured while the evidence is still warm.

When a statement crosses ``config.obs.slow_ms`` (or errors), the finish
path captures a bounded debug bundle into the session's ring
(``StatementLog.flights`` reads it newest-first):

- identity: sql, statement id, status, wall, capture reason;
- the full trace span tree when the statement was sampled
  (obs/trace.py) and the live progress snapshot (obs/progress.py);
- the plan (session.explain) plus its itemized device-byte estimate
  (obs/capacity.py) and motion rung ladder (empty at one segment);
- the statement skeleton and a literal fingerprint (sha256 over the
  hoisted literal texts) — enough to find the skeleton's row in the
  statements table without shipping user data;
- per-statement counter deltas (kernel builds) and the shared-cache-tier
  occupancy at capture time;
- the config epoch (sched/sharedcache.config_uid) + the session's
  n_segments + storage root, and for successful reads a RESULT DIGEST
  (sha256 over the decoded result columns of the host ColumnBatch) — the
  replay contract: re-executing the bundle's sql against the same store
  at the same segment count must reproduce the digest bit for bit
  (``cloudberry_tpu_torch/tools/flight_replay.py``). ``meta "flight"``
  exports the ring over the wire.

Capture is exception-safe by contract: the recorder observes a
statement that already finished — a capture failure is COUNTED
(``flight_capture_errors``) and never surfaces to the caller. The plan
re-derivation (an explain-only re-plan through the port's planner) runs
only for captured statements, which are slow or broken by definition —
never on the hot path.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np


# bundles keep the FULL statement text up to this cap — the replay
# contract executes bundle["sql"] verbatim, so any truncation makes the
# bundle forensics-only (replayable=False, sql_truncated stamped)
_SQL_CAP = 100_000

# minimum spacing between ERROR captures (engine-wide): under a
# deadline-heavy overload every expired statement errors, and paying a
# bundle build (plus ring churn — the ring holds 16) per failure would
# amplify exactly the overload being diagnosed. Slow-statement captures
# are not limited — they are rare by definition of slow_ms.
_ERROR_CAPTURE_MIN_S = 0.05

# cancellation-taxonomy errors: the statement died of lifecycle policy
# (deadline/cancel/drain/backpressure), not of its plan — capture the
# light bundle (trace/progress/counters) but never pay a re-plan for it
_CANCEL_CLASSES = frozenset({
    "StatementCancelled", "StatementTimeout", "ServerDraining",
    "SchedDeadline", "SchedQueueFull", "TenantQueueFull",
})


def param_fingerprint(sql: str) -> dict:
    """(skeleton, literal fingerprint) for the bundle: the skeleton is
    the plan-cache key, the fingerprint hashes the hoisted literal
    texts — same statement shape + same literals ⇒ same fingerprint,
    without the bundle carrying the literal values themselves."""
    from cloudberry_tpu_torch.obs.statements import skeleton_of
    from cloudberry_tpu_torch.sched import paramplan

    out = {"skeleton": skeleton_of(sql)}
    try:
        norm = paramplan.normalize(sql)
    except Exception:  # pragma: no cover - lexer drift
        norm = None
    if norm is not None:
        lits = norm[1]
        out["param_count"] = len(lits)
        out["param_fingerprint"] = hashlib.sha256(
            "\x00".join(lits).encode()).hexdigest()[:16]
    return out


def result_digest(batch) -> dict | None:
    """Bit-identity digest of a result surface: sha256 over the DECODED
    columns (name, dtype, raw bytes — object/string columns hash their
    value list). Decoded, not raw codes: a replay session re-reads the
    store, and dictionary code assignment is load-order state while the
    decoded values are the answer."""
    if not hasattr(batch, "decoded_columns"):
        return None
    cols = batch.decoded_columns()
    h = hashlib.sha256()
    for name in sorted(cols):
        arr = np.asarray(cols[name])
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        if arr.dtype == object:
            h.update("\x00".join(map(repr, arr.tolist())).encode())
        else:
            h.update(np.ascontiguousarray(arr).tobytes())
    n = len(next(iter(cols.values()))) if cols else 0
    return {"rows": int(n), "columns": sorted(cols),
            "sha256": h.hexdigest()}


def should_capture(log, status: str, wall_s: float) -> str | None:
    """The capture gate: the reason string ("slow" | "error"), or None.
    ``slow_ms`` <= 0 disables the recorder entirely."""
    if log is None or not getattr(log, "obs_enabled", False):
        return None
    slow_ms = float(getattr(log, "slow_ms", 0.0))
    if slow_ms <= 0:
        return None
    if status == "error":
        return "error"
    if wall_s * 1000.0 >= slow_ms:
        return "slow"
    return None


def _plan_section(session, query: str,
                  error: BaseException | None = None) -> dict:
    """Plan text with derived properties + the itemized device-byte
    estimate + the redistribute rung ladder, via an explain-only
    re-plan. Best-effort: a statement that errored AT planning simply
    has no plan to show."""
    from cloudberry_tpu_torch.exec.executor import all_nodes
    from cloudberry_tpu_torch.obs import capacity
    from cloudberry_tpu_torch.plan import nodes as N
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.sql.classify import read_only
    from cloudberry_tpu_torch.sql.parser import parse_sql

    out: dict = {}
    if error is not None and type(error).__name__ in _CANCEL_CLASSES:
        # lifecycle verdicts (deadline/cancel/drain/backpressure) say
        # nothing about the plan; skip the re-plan — it is the
        # expensive part of a capture, and overload produces these in
        # bulk
        out["plan_skipped"] = "lifecycle error: no re-plan at capture"
        return out
    if not read_only(query):
        # NEVER re-plan DML/DDL for forensics: planning a write is not
        # guaranteed side-effect free (folded sequence nextvals, the
        # mutation itself on some paths) — the bundle keeps the
        # statement text and counters, just no plan tree
        out["plan_skipped"] = "write statement: no re-plan at capture"
        return out
    try:
        out["plan"] = session.explain(query)
    except Exception as e:
        out["plan_error"] = f"{type(e).__name__}: {e}"
        return out
    try:
        pr = plan_statement(parse_sql(query), session, {},
                            explain_only=True)
        if not pr.is_ddl and pr.plan is not None:
            out["device_bytes"] = capacity.plan_device_bytes(
                pr.plan, session)
            out["rungs"] = [
                {"kind": n.kind, "bucket_cap": int(n.bucket_cap or 0),
                 "out_capacity": int(n.out_capacity or 0)}
                for n in all_nodes(pr.plan)
                if isinstance(n, N.PMotion)]
    except Exception:  # the explain above already captured the shape
        pass
    return out


def build_bundle(session, query: str, status: str, wall_s: float,
                 handle, reason: str, params: dict | None = None,
                 error: BaseException | None = None, result=None,
                 counters: dict | None = None) -> dict:
    """Assemble one capture. Pure data out — JSON-safe by construction
    (the wire and the replay tool both consume it verbatim)."""
    from cloudberry_tpu_torch.sched import sharedcache

    cfg = session.config
    json_params = None
    if params:
        try:
            import json

            json.dumps(params)
            json_params = dict(params)
        except (TypeError, ValueError):
            json_params = None  # non-JSON bind params: not replayable
    # replay re-executes bundle["sql"] VERBATIM, so a truncated text
    # would replay a different statement: keep the full text up to a
    # generous cap, and past it the bundle is forensics-only
    truncated = len(query) > _SQL_CAP
    bundle = {
        "statement_id": getattr(handle, "statement_id", None),
        "sql": query[:_SQL_CAP],
        "status": status,
        "reason": reason,
        "wall_s": round(float(wall_s), 6),
        "captured_at": time.time(),
        "config_epoch": sharedcache.config_uid(cfg),
        "n_segments": int(cfg.n_segments),
        "storage_root": cfg.storage.root,
        "cache_tier": sharedcache.tier_snapshot(session),
        "tiled_report": getattr(session, "last_tiled_report", None),
    }
    bundle.update(param_fingerprint(query))
    if params is not None:
        bundle["params"] = json_params
    if counters:
        bundle["counters"] = {k: int(v) for k, v in counters.items()}
    if error is not None:
        bundle["error"] = f"{type(error).__name__}: {error}"[:500]
    trace = getattr(handle, "trace", None)
    if trace is not None:
        bundle["trace"] = trace.export()
    prog = getattr(handle, "progress", None)
    if prog is not None:
        bundle["progress"] = prog.snapshot()
    # skew annotations captured by the motion layer ride the activity
    # entry's counters; the plan section re-derives the shuffle shape
    bundle.update(_plan_section(session, query, error=error))
    digest = result_digest(result) if result is not None else None
    if digest is not None:
        bundle["result"] = digest
    if truncated:
        bundle["sql_truncated"] = True
    bundle["replayable"] = bool(
        cfg.storage.root is not None
        and digest is not None
        and not truncated
        and (not params or json_params is not None))
    return bundle


def maybe_capture(session, query: str, status: str, wall_s: float,
                  handle, params: dict | None = None,
                  error: BaseException | None = None, result=None,
                  counters: dict | None = None) -> None:
    """The finish-path hook (session.sql): capture when the gate says
    so; NEVER raise — a broken recorder must not break the statement it
    observed."""
    log = getattr(session, "stmt_log", None)
    reason = should_capture(log, status, wall_s)
    if reason is None:
        return
    if reason == "error":
        # error-storm protection: under overload every expired
        # statement errors, and the 16-deep ring would discard most of
        # the bundles anyway — space error captures out and count the
        # skips (slow captures are rare by definition and not limited)
        now = time.monotonic()
        if now - getattr(log, "_flight_last_error", 0.0) \
                < _ERROR_CAPTURE_MIN_S:
            log.bump("flight_capture_ratelimited")
            return
        log._flight_last_error = now
    try:
        bundle = build_bundle(session, query, status, wall_s, handle,
                              reason, params=params, error=error,
                              result=result, counters=counters)
        log.add_flight(bundle)
    except Exception:  # noqa: BLE001 — observer failure is counted
        try:
            log.bump("flight_capture_errors")
        except Exception:  # noqa: BLE001
            pass
