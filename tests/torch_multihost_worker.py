"""Worker process for the port's two-process cluster test, the twin of
``tests/multihost_worker.py``.

Each worker is one "host": it joins the cluster through the port's
``parallel/mesh.py init_distributed`` (CBTPU_* environment; the spawner
gives each process 4 local slots, ``CBTPU_LOCAL_SLOTS``), owns 4 of the
8 segments on ``device="cpu"``, and runs the SAME statements as the JAX
package's worker over an 8-segment gang whose motions cross the process
boundary (``torch.distributed`` over gloo on 127.0.0.1). It prints one
``RESULT {json}`` line for the parent to compare across processes,
against the port's one-process run and against the JAX package's.

Beside the three statements it records: the transport's launches and the
bytes it handed to ``torch.distributed`` per statement, the collectives
on fixed stacked inputs (the 4 + 4 layout, and a ragged 4 + 2 one), a
redistribute that overflows on this cluster's first process only,
EXPLAIN ANALYZE, a direct-dispatched statement, the ring transport,
tiled distributed execution in its four modes, a degrade 8 -> 7 over
``[0, 1, 2, 4, 5, 6, 7]`` (ragged 3 + 4), a device-lost re-dispatch
that degrades the same way, an online resize 6 -> 8 (4 + 2 -> 4 + 4),
the tiled recovery paths (a resume re-sharded onto the 3 + 4 ranges, an
accumulator overflow's retry, the skew sentinel's replan and its seam
on one process), the refused cursor, and a statement whose processes
disagree on the layout.

With a directory argument (``store_copies`` made it), the store-backed
cluster too (``store_runs``): 6 segments (4 + 2) over copies of one
store, its reads, DML, a transaction and a compaction pass committed by
process 0 alone, an INSERT whose process 0 is held between its manifest
read and its commit, a process held on an older snapshot, an online
resize 6 -> 8 that moves stored partitions, its journal resume after a
chunk fault on process 0, a failover shrink, and an INSERT past the
store's disk quota.

The spawner provides the environment; this module imports no JAX and
must not change ``os.environ`` (the test imports ``QUERIES``, ``load``,
``collective_inputs``, ``skew_load`` and the store helpers from it).
"""

import json
import sys

import numpy as np
import torch

QUERIES = [
    # redistribute + two-stage agg + gathered sort
    ("SELECT g, sum(v) AS sv, count(*) AS c FROM fact "
     "JOIN dim ON fact.k = dim.k GROUP BY g ORDER BY g"),
    # broadcast join (small build) + filter
    ("SELECT count(*) AS n FROM fact JOIN dim ON fact.k = dim.k "
     "WHERE g < 3"),
    # top-N pushdown through the gather motion
    ("SELECT k, v FROM fact ORDER BY v DESC, k LIMIT 7"),
]
SKEW_QUERY = ("SELECT sum(j2.w) AS sw, count(*) AS c FROM "
              "(SELECT key AS kk FROM j1) x JOIN j2 ON kk = j2.key")
DIRECT_QUERY = "SELECT k, v FROM fact WHERE k = 17 ORDER BY v"
NSEG = 8
LOCAL_SLOTS = 4
SURVIVORS = [0, 1, 2, 4, 5, 6, 7]   # slot 3 of the 8-slot pool lost
RESIZE = (6, 8)                   # online_resize: 4 + 2 -> 4 + 4
# tests/test_spill_dist.py's join-group query, on a smaller fact table
# with a budget that still tiles it (the probe side redistributes)
SPILL_QUERY = ("SELECT g, sum(v) AS sv, count(*) AS c "
               "FROM fact JOIN dim ON fact.d = dim.d "
               "GROUP BY g ORDER BY g")
SPILL_FACT, SPILL_BUDGET = 100_000, 1 << 20
# the four tiled modes (tests/test_torch_tiled_dist.py's dist8 shapes):
# name -> (query, budget, fact rows, groups)
TILED = {
    "agg": ("SELECT g, sum(v) AS sv, count(*) AS c FROM fact JOIN dim "
            "ON fact.k = dim.k GROUP BY g ORDER BY g", 1 << 20, 120_000, 9),
    "topn": ("SELECT fact.k AS k, v, g FROM fact JOIN dim ON fact.k = "
             "dim.k WHERE v < 90 ORDER BY v, fact.k, g LIMIT 25", 1 << 20,
             120_000, 9),
    "sort": ("SELECT g, v FROM fact JOIN dim ON fact.k = dim.k "
             "WHERE v < 50 ORDER BY g, v DESC, fact.k", 1 << 20, 120_000,
             9),
    "window": ("SELECT g, v, rank() over (partition by g order by v desc)"
               " AS r, sum(v) over (partition by g) AS sv "
               "FROM fact JOIN dim ON fact.k = dim.k", 4 << 20, 240_000,
               300),
}
# recovery across the process boundary: the statements of
# tests/test_torch_dist_recovery.py and tests/test_torch_dist_adaptive.py
# on the flat exchange (the decisions under test are the processes'
# agreement on a resume, a retry and a replan, not the transport)
RECOVERY = {"resource.query_mem_bytes": 2 << 20,
            "recovery.checkpoint_every": 2,
            "planner.broadcast_threshold": 0, "health.backoff_s": 0.01,
            "health.backoff_max_s": 0.02,
            "interconnect.hierarchical": "off"}
RESUME_FACT, HOT_FRAC = 400_000, 0.85
OVERFLOW = {"resource.query_mem_bytes": 4 << 20,
            "recovery.checkpoint_every": 2, "feedback.enabled": False,
            "interconnect.hierarchical": "off"}
LATE_Q = ("SELECT k % 20000 AS kk, count(*) AS c, sum(v) AS sv "
          "FROM fact GROUP BY k % 20000 ORDER BY kk LIMIT 50")
REPLAN = {"resource.query_mem_bytes": 2 << 20,
          "planner.broadcast_threshold": 0,
          "interconnect.hierarchical": "off"}
RECOVERY_COUNTERS = ("tile_replans", "tile_resumes", "tile_checkpoints",
                     "topo_resharded_resumes", "tiles_replayed",
                     "tile_resume_declined", "recoveries")
RAGGED = (0, 0, 0, 0, 1, 1)       # the collectives' 4 + 2 layout
B, W = 4, 3
HOST_CAP = 4 * 4 * B      # a host pair's most rows: no host rung overflow
# the store-backed cluster: t (5,000 rows in 5 micro-partitions, hashed
# by k, a DECIMAL column) and d (12 rows), 6 segments (4 + 2)
STORE_ROWS, STORE_RPP, STORE_NSEG = 5000, 1000, 6
STORE_CFG = {"storage.rows_per_partition": STORE_RPP,
             "planner.autostats": "none"}
STORE_QUERIES = [
    "SELECT count(*) AS n, sum(k) AS sk, sum(v) AS sv FROM t",
    "SELECT g, count(*) AS c, sum(v) AS sv FROM t GROUP BY g ORDER BY g",
    ("SELECT w, count(*) AS c, sum(t.v) AS sv FROM t JOIN d ON t.g = d.g "
     "WHERE t.k % 7 = 1 GROUP BY w ORDER BY w"),
]
STORE_COPIES = ("reads", "dml", "race", "held", "resize", "resume",
               "quota")
COPY_FILE = "copy.txt"          # COPY's input, beside the copies
STORE_DML = [
    "INSERT INTO t VALUES (100000, 1.25, 3), (100001, 2.50, 4)",
    "DELETE FROM t WHERE k < 300",
    "UPDATE t SET v = v + 1 WHERE g = 2",
    "COPY t FROM '{copy}'",
    "BEGIN",
    "INSERT INTO t VALUES (100002, 7.75, 5)",
    "UPDATE d SET w = w + 1 WHERE g = 1",
    "COMMIT",
    # two small tails for the compaction pass to merge
    "INSERT INTO t VALUES (100003, 0.01, 6)",
    "INSERT INTO t VALUES (100004, 0.02, 7)",
]
RACE_INSERT = "INSERT INTO t VALUES (200000, 9.99, 1)"
RACE_SLEEP_S = 1.0
FAILED_INSERT = "INSERT INTO t VALUES (200001, 1.00, 2)"
QUOTA_INSERT = "INSERT INTO t VALUES (200002, 3.00, 3)"
RESUME_HIT = 3                  # the chunk fault's hit on process 0
TOPOLOGY_LAG_S = 0.2            # process 0's topology writes, delayed


def load(session):
    """The JAX worker's tables, from the same generator and seed."""
    rng = np.random.default_rng(11)  # identical on every host
    session.sql("CREATE TABLE dim (k BIGINT, g BIGINT) DISTRIBUTED BY (k)")
    session.sql(
        "CREATE TABLE fact (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
    session.catalog.table("dim").set_data(
        {"k": np.arange(400), "g": np.arange(400) % 6})
    session.catalog.table("fact").set_data(
        {"k": rng.integers(0, 400, 20_000),
         "v": rng.integers(0, 1000, 20_000)})


def skew_load(session):
    """j1 placed by ``a``; its join key is 0 on every row that lands on
    segments 0-3 (the first process's), distinct elsewhere, so the
    redistribute by key overflows only at the first process's sources."""
    session.sql("CREATE TABLE j1 (a BIGINT, key BIGINT) DISTRIBUTED BY (a)")
    session.sql("CREATE TABLE j2 (b BIGINT, key BIGINT, w BIGINT) "
                "DISTRIBUTED BY (b)")
    a = np.arange(2000)
    t = session.catalog.table("j1")
    t.set_data({"a": a, "key": a})
    seg = np.asarray(t.shard_assignment(NSEG))
    t.set_data({"a": a, "key": np.where(seg < NSEG // 2, 0, a)})
    session.catalog.table("j2").set_data(
        {"b": a, "key": a, "w": a})


def spill_load(session, n_fact=SPILL_FACT, hot_frac=0.0):
    """tests/test_spill_dist.py's tables (seed 3): dim placed by g, so the
    join on d redistributes the probe side. ``hot_frac``: that share of
    the fact rows carries join key 7 (tests/test_torch_dist_adaptive.py's
    ``_load_hot``)."""
    rng = np.random.default_rng(3)
    session.sql("CREATE TABLE dim (d BIGINT, g BIGINT) DISTRIBUTED BY (g)")
    session.sql("CREATE TABLE fact (k BIGINT, d BIGINT, v BIGINT) "
                "DISTRIBUTED BY (k)")
    session.catalog.table("dim").set_data(
        {"d": np.arange(500), "g": np.arange(500) % 9})
    d = rng.integers(0, 500, n_fact)
    if hot_frac:
        d[rng.random(n_fact) < hot_frac] = 7
    session.catalog.table("fact").set_data(
        {"k": np.arange(n_fact) % 997, "d": d,
         "v": rng.integers(0, 100, n_fact)})


def late_load(session):
    """tests/test_torch_dist_recovery.py's late overflow (seed 4): the
    first 3.2M rows hold 2,000 keys, the last 1.2M rows 30,000, so every
    segment's accumulator overflows behind two checkpoints."""
    rng = np.random.default_rng(4)
    session.sql("CREATE TABLE fact (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
    k = np.concatenate([rng.integers(0, 2_000, 3_200_000),
                        rng.integers(0, 30_000, 1_200_000)])
    session.catalog.table("fact").set_data(
        {"k": k, "v": rng.integers(0, 100, len(k))})


def pipe_load(n_fact, n_groups):
    """The dist8 mode shapes' tables (seed 3)."""
    def load(session):
        rng = np.random.default_rng(3)
        session.sql("CREATE TABLE dim (k BIGINT, g BIGINT) "
                    "DISTRIBUTED BY (k)")
        session.sql("CREATE TABLE fact (k BIGINT, v BIGINT) "
                    "DISTRIBUTED BY (k)")
        session.catalog.table("dim").set_data(
            {"k": np.arange(500), "g": np.arange(500) % n_groups})
        session.catalog.table("fact").set_data(
            {"k": rng.integers(0, 500, n_fact),
             "v": rng.integers(0, 100, n_fact)})
    return load


def store_load(session):
    """The store-backed cluster's tables (seed 13)."""
    rng = np.random.default_rng(13)
    session.sql("CREATE TABLE t (k BIGINT, v DECIMAL(12,2), g BIGINT) "
                "DISTRIBUTED BY (k)")
    session.sql("CREATE TABLE d (g BIGINT, w BIGINT) DISTRIBUTED BY (g)")
    session.catalog.table("t").set_data(
        {"k": np.arange(STORE_ROWS),
         "v": rng.integers(-100_000, 100_000, STORE_ROWS),
         "g": rng.integers(0, 12, STORE_ROWS)})
    session.catalog.table("d").set_data(
        {"g": np.arange(12), "w": np.arange(12) % 5})


def store_copies(root) -> str:
    """A base store under ``root`` (written by a one-process port
    session), a copy per ``STORE_COPIES`` name and COPY's input file;
    returns the base's path."""
    import os
    import shutil

    import cloudberry_tpu_torch as ct

    base = os.path.join(root, "base")
    store_load(ct.Session(ct.Config(n_segments=STORE_NSEG).with_overrides(
        **{"storage.root": base, **STORE_CFG}), device="cpu"))
    for name in STORE_COPIES:
        shutil.copytree(base, os.path.join(root, name))
    with open(os.path.join(root, COPY_FILE), "w") as f:
        f.write("".join(f"{300_000 + i}|{i * 1.25:.2f}|{i % 12}\n"
                        for i in range(40)))
    return base


def store_session(root, nseg=STORE_NSEG, **over):
    """A CPU session of ``nseg`` segments over the store at ``root``."""
    import cloudberry_tpu_torch as ct

    return ct.Session(ct.Config(n_segments=nseg).with_overrides(
        **{"storage.root": root, **STORE_CFG, **over}), device="cpu")


def physical(batch) -> dict:
    """Selected rows of every column as stored (DECIMALs as integers)."""
    sel = np.asarray(batch.sel)
    return {f.name: np.asarray(batch.columns[f.name])[sel].tolist()
            for f in batch.schema.fields}


def versions(root) -> dict:
    """Each stored table's CURRENT manifest version."""
    from cloudberry_tpu_torch.storage.table_store import TableStore

    ts = TableStore(root)
    return {n: ts.current_version(n) for n in ts.table_names()}


def live_by_seg(root, nseg) -> dict:
    """Live rows per destination segment of ``t``'s partitions tagged for
    ``nseg`` segments, and ``t``'s live rows in all."""
    from cloudberry_tpu_torch.storage.table_store import TableStore

    man = TableStore(root).read_manifest("t")
    segs: dict = {}
    total = 0
    for p in man["partitions"]:
        n = p["num_rows"] - len(p["deleted"])
        total += n
        if p.get("seg_nseg") == nseg:
            segs[str(p["seg"])] = segs.get(str(p["seg"]), 0) + n
    return {"segs": segs, "total": total}


def store_answers(s) -> list:
    """STORE_QUERIES on ``s``: (decoded rows, physical rows) each."""
    out = []
    for q in STORE_QUERIES:
        b = s.sql(q)
        out.append({"rows": rows(b), "physical": physical(b)})
    return out


def store_dml(s, root, copy) -> list:
    """STORE_DML on ``s`` over ``root``: each statement's status and the
    manifest versions it added per table."""
    out = []
    for q in STORE_DML:
        before = versions(root)
        status = s.sql(q.format(copy=copy))
        after = versions(root)
        out.append({"status": str(status), "added": {
            n: after[n] - before.get(n, 0) for n in after}})
    return out


def resized(s, root) -> dict:
    """``online_resize`` to 8 on ``s``: the record's counts, the layout
    and the store's live rows per destination segment."""
    rec = s._topology.online_resize(8)
    reb = rec["rebalance"]
    return {"epoch": rec["epoch"], "reason": rec["reason"],
            "moved_rows": reb["moved_rows"], "total_rows": reb["total_rows"],
            "moved_bytes": reb["moved_bytes"], "layout": _layout(s),
            "live": live_by_seg(root, 8)}


def resume_run(root, rank=None) -> dict:
    """An online resize 6 -> 8 whose chunk seam fails at RESUME_HIT on
    process 0 (``rank`` None: the only process), then a fresh session over
    the same root resuming it from ``_TOPOLOGY.json``'s journal."""
    from cloudberry_tpu_torch.utils import faultinject as FI

    s = store_session(root)
    if rank in (None, 0):
        FI.inject_fault("topo_rebalance_chunk", "error",
                        start_hit=RESUME_HIT, end_hit=RESUME_HIT)
    try:
        s._topology.online_resize(8)
        failed = ""
    except FI.InjectedFault as e:
        failed = str(e)
    finally:
        FI.reset_fault()
    s = store_session(root)
    out = resized(s, root)
    out.update(failed=failed, answers=store_answers(s))
    return out


def store_runs(top) -> dict:
    """The store-backed cluster's scenarios over the copies under
    ``top`` (module docstring). An error in one is recorded, not
    raised, so that the others still report."""
    import os

    from cloudberry_tpu_torch.parallel.mesh import process_index
    from cloudberry_tpu_torch.parallel.topology import ClusterSnapshotError
    from cloudberry_tpu_torch.storage.compact import CompactionService
    from cloudberry_tpu_torch.storage.table_store import QuotaError
    from cloudberry_tpu_torch.utils import faultinject as FI

    rank = process_index()
    at = {n: os.path.join(top, n) for n in STORE_COPIES}
    out = {}

    def scenario(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — the test names it
            out[name] = {"error": f"{type(e).__name__}: {e}"}
        finally:
            FI.reset_fault()

    def reads():
        s = store_session(at["reads"])
        rec = {"answers": store_answers(s), "layout": _layout(s)}
        # a device loss whose probe loses slot 3 (process 0's last): the
        # retry degrades to 3 + 4 and the loss promotes to a failover
        # epoch at once, over the same store
        f = store_session(at["reads"], 8, **{
            "health.retries": 2, "health.backoff_s": 0.001,
            "health.backoff_max_s": 0.002, "topology.promote_after": 1})
        FI.inject_fault("exec_device_lost", "error", start_hit=1,
                        end_hit=1)
        if rank == 0:
            FI.inject_fault("probe_degraded", "skip", start_hit=1,
                            end_hit=1)
        rec["failover"] = {"answer": store_answers(f)[0],
                           "layout": _layout(f),
                           "reason": f._topology.current.reason}
        return rec

    def dml():
        s = store_session(at["dml"])
        rec = {"statements": store_dml(s, at["dml"],
                                       os.path.join(top, COPY_FILE))}
        rec["answers"] = store_answers(s)
        before = versions(at["dml"])
        rec["compact"] = CompactionService(s).run_once(force=True)
        rec["compact_added"] = versions(at["dml"])["t"] - before["t"]
        rec["after_compact"] = store_answers(s)
        rec["live"] = live_by_seg(at["dml"], 8)["total"]
        return rec

    def race():
        s = store_session(at["race"])
        before = versions(at["race"])
        if rank == 0:
            # process 0 waits between its manifest read and its commit
            FI.inject_fault("store_lock_acquire", "sleep",
                            sleep_s=RACE_SLEEP_S)
        status = str(s.sql(RACE_INSERT))
        FI.reset_fault()
        rec = {"status": status,
               "added": versions(at["race"])["t"] - before["t"],
               "answers": store_answers(s)}
        # process 0's commit fails: the statement raises on both
        if rank == 0:
            FI.inject_fault("io_manifest_write", "error", start_hit=1,
                            end_hit=1)
        try:
            s.sql(FAILED_INSERT)
            rec["failed"] = ""
        except FI.InjectedFault as e:
            rec["failed"] = str(e)
        FI.reset_fault()
        rec["after_failed"] = store_answers(s)[0]
        return rec

    def held():
        s = store_session(at["held"])
        first = store_answers(s)[0]
        # a commit outside any statement (process 0's alone), then a
        # statement whose process 1 is held on the older snapshot
        s.store.delete_rows("d", lambda c: c["g"] == 11)
        if rank == 1:
            FI.inject_fault("sync_store", "skip", start_hit=1, end_hit=1)
        try:
            store_answers(s)
            err = ""
        except ClusterSnapshotError as e:
            err = str(e)
        FI.reset_fault()
        return {"first": first, "raised": err,
                "next": store_answers(s)[2]}

    def resize():
        s = store_session(at["resize"])
        before = store_answers(s)
        if rank == 0:
            # process 0's topology writes lag: the others must not run
            # ahead of its epoch line
            FI.inject_fault("io_topology_write", "sleep",
                            sleep_s=TOPOLOGY_LAG_S)
        rec = resized(s, at["resize"])
        FI.reset_fault()
        rec.update(before=before, answers=store_answers(s))
        return rec

    def quota():
        # a quota of one byte: the store is past it, so process 0 refuses
        # the INSERT at its commit and both processes raise
        s = store_session(at["quota"], **{"storage.quota_bytes": 1})
        first = store_answers(s)[0]
        before = versions(at["quota"])
        try:
            s.sql(QUOTA_INSERT)
            err = ""
        except QuotaError as e:
            err = str(e)
        after = versions(at["quota"])
        return {"raised": err, "first": first,
                "added": {n: after[n] - before.get(n, 0) for n in after},
                "after": store_answers(s)[0]}

    scenario("reads", reads)
    scenario("dml", dml)
    scenario("race", race)
    scenario("held", held)
    scenario("resize", resize)
    scenario("resume", lambda: resume_run(at["resume"], rank))
    scenario("quota", quota)
    return out


def tiled_report(rep) -> dict:
    """The parts of ``last_tiled_report`` the cluster test compares."""
    keys = ("tiled", "distributed", "n_segments", "mode", "n_tiles",
            "tile_rows", "acc_capacity", "topology_epoch")
    return {k: rep.get(k) for k in keys}


def ragged_inputs():
    """Fixed stacked inputs of the 6 segments of ``RAGGED``: (ints (6, 5),
    packed wire blocks (6, 6, B, W) int32)."""
    rng = np.random.default_rng(9)
    n = len(RAGGED)
    return (rng.integers(-1000, 1000, (n, 5)),
            rng.integers(0, 1 << 20, (n, n, B, W)).astype(np.int32))


def collective_inputs():
    """Fixed stacked inputs of every segment: (ints (8, 5), packed wire
    blocks (8, 8, B, W) int32 with a random validity bit, digests (8, 6)
    int32)."""
    rng = np.random.default_rng(5)
    ints = rng.integers(-1000, 1000, (NSEG, 5))
    wire = rng.integers(0, 1 << 20, (NSEG, NSEG, B, W)).astype(np.int32)
    wire[..., 0] = (wire[..., 0] & ~1) | rng.integers(0, 2, wire.shape[:3])
    digest = rng.integers(0, 1 << 30, (NSEG, 6)).astype(np.int32)
    return ints, wire, digest


def rows(batch) -> dict:
    return {c: np.asarray(v).tolist()
            for c, v in batch.decoded_columns().items()}


def _spy_transports(made: list):
    from cloudberry_tpu_torch.parallel import transport as T

    real = T.make_transport

    def spy(*a, **kw):
        tx = real(*a, **kw)
        made.append(tx)
        return tx
    T.make_transport = spy


def _statement(session, q, made):
    """(rows, hierarchical launches, bytes to torch.distributed, the
    redistributes' exchanges) of one statement."""
    made.clear()
    out = rows(session.sql(q))
    return (out, sum(getattr(tx, "launches", 0) for tx in made),
            sum(tx.total_dist_bytes for tx in made),
            [e for tx in made for e in tx.exchanges])


def _refuses(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


def _loaded(loader=None, nseg=NSEG, **over):
    """A CPU session of ``nseg`` segments holding ``loader``'s tables
    (``load``'s by default)."""
    import cloudberry_tpu_torch as ct

    s = ct.Session(ct.Config().with_overrides(n_segments=nseg, **over),
                   device="cpu")
    (loader or load)(s)
    return s


def _layout(s) -> dict:
    """The session's epoch, segment count, survivors, this process's
    segments and the host layout."""
    from cloudberry_tpu_torch.parallel.health import slot_count
    from cloudberry_tpu_torch.parallel.mesh import (host_topology,
                                                    session_segments)

    ids = s._live_device_ids
    return {"epoch": s._topology.current.epoch_id,
            "nseg": s.config.n_segments, "live": ids,
            "local": list(session_segments(s)),
            "hosts": host_topology(s.config.n_segments, ids,
                                   slot_count(s)).as_dict()}


def _recovered(s, q) -> dict:
    """``q``'s rows on ``s``, its tiled report's recovery keys and the
    session's recovery counters."""
    got = rows(s.sql(q))
    rep = s.last_tiled_report
    return {"rows": got,
            "report": {k: rep.get(k) for k in (
                "n_segments", "n_tiles", "acc_capacity", "tile_rows",
                "resumed_from_tile")},
            "counters": {k: s.stmt_log.counter(k)
                         for k in RECOVERY_COUNTERS}}


def recovery_runs(rank=None) -> dict:
    """The tiled recovery paths whose decisions a cluster's processes
    must agree on. ``rank``: this process of a cluster (None: one
    process, where every arm applies).

    - ``resume``: a device loss mid-stream whose retry's probe loses slot
      3 (process 0's last): the statement resumes on the survivors from
      its checkpoint, each process's partials re-sharded onto its new
      range (3 + 4);
    - ``overflow``: a late accumulator overflow retries with a grown
      accumulator and resumes from a checkpoint;
    - ``fires`` / ``seam_on_one``: the skew sentinel's mid-statement
      replan, and its seam skipped on process 1 alone, which disarms it
      on every process."""
    from cloudberry_tpu_torch.utils import faultinject as FI

    out = {}
    s = _loaded(lambda x: spill_load(x, RESUME_FACT), **RECOVERY)
    clean = rows(s.sql(SPILL_QUERY))
    kill = max(s.last_tiled_report["n_tiles"] // 2, 2)
    FI.inject_fault("tile_device_lost", "error", start_hit=kill + 1,
                    end_hit=kill + 1)
    if rank in (None, 0):
        FI.inject_fault("probe_degraded", "skip", start_hit=1, end_hit=1)
    try:
        out["resume"] = _recovered(s, SPILL_QUERY)
    finally:
        FI.reset_fault()
    out["resume"].update(clean=clean, layout=_layout(s))
    out["overflow"] = _recovered(_loaded(late_load, **OVERFLOW), LATE_Q)
    for name, seam_on in (("fires", None), ("seam_on_one", 1)):
        s = _loaded(lambda x: spill_load(x, RESUME_FACT, HOT_FRAC),
                    **REPLAN)
        if rank is not None and rank == seam_on:
            FI.inject_fault("tile_replan", "skip")
        try:
            out[name] = _recovered(s, SPILL_QUERY)
        finally:
            FI.reset_fault()
    return out


def _ragged_collectives() -> dict:
    """``ProcessCollectives`` and the ring over the 4 + 2 layout on this
    process's rows of fixed inputs."""
    from cloudberry_tpu_torch.parallel.mesh import (owner_ranges,
                                                    process_index)
    from cloudberry_tpu_torch.parallel.transport import (ProcessCollectives,
                                                         RingCollectives)

    ints, wire = ragged_inputs()
    rank = process_index()
    mine = owner_ranges(RAGGED)[rank]
    xs = list(torch.from_numpy(ints[mine.start:mine.stop]))
    ws = list(torch.from_numpy(wire[mine.start:mine.stop]))
    out = {}
    for name, tx in (("flat", ProcessCollectives(RAGGED, rank)),
                     ("ring", RingCollectives(len(RAGGED), owners=RAGGED,
                                              rank=rank))):
        got = {"all_gather": tx.all_gather(xs).tolist(),
               "psum": tx.psum(xs).tolist(),
               "pmax": tx.pmax(xs).tolist()}
        before = tx.dist_bytes
        got["all_to_all"] = torch.stack(tx.all_to_all(ws)).tolist()
        got["a2a_bytes"] = tx.dist_bytes - before
        got["launches"] = getattr(tx, "launches", 0)
        out[name] = got
    return out


def _collectives() -> dict:
    """The process-spanning collectives on this process's rows of the
    fixed inputs (the parent holds them against the one-process
    transports)."""
    from cloudberry_tpu_torch.parallel.mesh import (host_topology,
                                                    local_segments)
    from cloudberry_tpu_torch.parallel.transport import (
        HierarchicalCollectives, make_transport)

    ints, wire, digest = collective_inputs()
    segs = local_segments(NSEG)
    lo, hi = segs.start, segs.stop
    flat = make_transport("xla", NSEG)
    xs = list(torch.from_numpy(ints[lo:hi]))
    ws = list(torch.from_numpy(wire[lo:hi]))
    hier = HierarchicalCollectives(host_topology(NSEG), inner=flat)
    recv, hdem = hier.hier_all_to_all(ws, host_cap=HOST_CAP)
    return {
        "all_gather": flat.all_gather(xs).tolist(),
        "all_to_all": torch.stack(flat.all_to_all(ws)).tolist(),
        "psum": flat.psum(xs).tolist(),
        "pmax": flat.pmax(xs).tolist(),
        "tree_gather": hier.all_gather(ws, unsigned=True).tolist(),
        "hier_all_to_all": torch.stack(recv).tolist(),
        "host_demand": hdem.tolist(),
        "host_ring": hier.host_ring_exchange(
            torch.from_numpy(digest[lo:hi])).tolist(),
        "intra_all_gather": hier.intra_all_gather(
            torch.from_numpy(digest[lo:hi])).tolist(),
        "launches": hier.launches,
    }


def main():
    from cloudberry_tpu_torch.parallel.mesh import (init_distributed,
                                                    local_segments,
                                                    mesh_topology,
                                                    process_count)

    torch.set_num_threads(1)
    init_distributed()
    init_distributed()               # idempotent: the group stays
    import cloudberry_tpu_torch as ct

    made: list = []
    _spy_transports(made)
    topo = mesh_topology(NSEG)
    out = {"host": topo["this_host"], "topology": topo,
           "procs": process_count(),
           "local": list(local_segments(NSEG)),
           "local_6": list(local_segments(RESIZE[0]))}
    try:
        local_segments(3)
        out["indivisible"] = ""
    except RuntimeError as e:
        out["indivisible"] = str(e)

    # the JAX worker's default session ("auto": motions whose blocks
    # clear the size gate go two-level), "on", and the flat exchange
    res = {}
    for mode in ("auto", "on", "off"):
        s = _loaded(**{"interconnect.hierarchical": mode})
        res[mode] = [_statement(s, q, made) for q in QUERIES]
    out["results"] = [r[0] for r in res["auto"]]
    out["hier_results"] = [r[0] for r in res["on"]]
    out["flat_results"] = [r[0] for r in res["off"]]
    out["launches"] = {m: [r[1] for r in res[m]] for m in res}
    out["bytes"] = {m: [r[2] for r in res[m]] for m in res}
    out["exchanges"] = {m: [r[3] for r in res[m]] for m in res}

    s = _loaded()
    out["explain"] = s.explain_analyze(QUERIES[0])
    out["direct"] = rows(s.sql(DIRECT_QUERY))
    out["refusals"] = {
        "cursor": _refuses(lambda: s.sql(
            "DECLARE c PARALLEL RETRIEVE CURSOR FOR SELECT k, v FROM fact")),
    }

    # the ring transport across the process boundary
    ring = [_statement(_loaded(**{"interconnect.backend": "ring"}), q,
                       made) for q in QUERIES]
    out["ring"] = {"results": [r[0] for r in ring],
                   "launches": [r[1] for r in ring],
                   "bytes": [r[2] for r in ring],
                   "exchanges": [r[3] for r in ring]}

    # tiled distributed execution: the spill query and the four modes
    sp = _loaded(spill_load, **{"planner.broadcast_threshold": 0,
                                "resource.query_mem_bytes": SPILL_BUDGET})
    out["spill"] = {"rows": rows(sp.sql(SPILL_QUERY)),
                    "report": tiled_report(sp.last_tiled_report)}
    out["tiled"] = {}
    for name, (q, budget, n_fact, n_groups) in TILED.items():
        ts = _loaded(pipe_load(n_fact, n_groups),
                     **{"resource.query_mem_bytes": budget})
        out["tiled"][name] = {"rows": rows(ts.sql(q)),
                              "report": tiled_report(ts.last_tiled_report)}

    # a degrade 8 -> 7 over the survivors: 3 + 4
    dg = _loaded()
    dg.sql(QUERIES[0])
    dg.degrade_mesh(len(SURVIVORS), SURVIVORS)
    out["degrade"] = {"layout": _layout(dg),
                      "results": [rows(dg.sql(q)) for q in QUERIES]}

    # a device-lost statement on both processes, whose probe loses this
    # cluster's slot 3 (process 0's last): the retry degrades to 3 + 4
    from cloudberry_tpu_torch.parallel.mesh import process_index
    from cloudberry_tpu_torch.utils import faultinject as FI

    rd = _loaded(**{"health.retries": 2, "health.backoff_s": 0.001,
                    "health.backoff_max_s": 0.002})
    FI.inject_fault("exec_device_lost", "error", start_hit=1, end_hit=1)
    if process_index() == 0:
        FI.inject_fault("probe_degraded", "skip", start_hit=1, end_hit=1)
    try:
        got = rows(rd.sql(QUERIES[0]))
    finally:
        FI.reset_fault()
    out["redispatch"] = {"rows": got, "layout": _layout(rd),
                         "recoveries": rd.stmt_log.counter("recoveries")}

    # an online resize 6 -> 8: 4 + 2 -> 4 + 4
    rz = _loaded(nseg=RESIZE[0])
    before = {"layout": _layout(rz),
              "results": [rows(rz.sql(q)) for q in QUERIES]}
    rec = rz._topology.online_resize(RESIZE[1])
    out["resize"] = {"before": before, "after": {
        "layout": _layout(rz),
        "results": [rows(rz.sql(q)) for q in QUERIES]},
        "epoch": rec["epoch"], "reason": rec["reason"],
        "moved_rows": rec["rebalance"]["moved_rows"],
        "total_rows": rec["rebalance"]["total_rows"]}

    out["recovery"] = recovery_runs(process_index())

    sk = ct.Session(ct.Config().with_overrides(**{
        "n_segments": NSEG, "planner.broadcast_threshold": 0,
        "planner.runtime_filter_threshold": 0}), device="cpu")
    skew_load(sk)
    out["skew"] = {"rows": rows(sk.sql(SKEW_QUERY)),
                   "growth_events": sk.growth_events}
    out["collectives"] = _collectives()
    out["ragged"] = _ragged_collectives()

    # last: the processes disagree on the layout (process 1 alone
    # degrades), and the next statement raises on both
    from cloudberry_tpu_torch.parallel.topology import ClusterLayoutError

    mm = _loaded()
    if process_index() == 1:
        mm.degrade_mesh(len(SURVIVORS), SURVIVORS)
    try:
        mm.sql(QUERIES[1])
        out["mismatch"] = ""
    except ClusterLayoutError as e:
        out["mismatch"] = str(e)
    if len(sys.argv) > 1:
        out["store"] = store_runs(sys.argv[1])
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
