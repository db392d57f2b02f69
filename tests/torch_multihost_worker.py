"""Worker process for the port's two-process cluster test, the twin of
``tests/multihost_worker.py``.

Each worker is one "host": it joins the cluster through the port's
``parallel/mesh.py init_distributed`` (CBTPU_* environment), owns 4 of the
8 segments on ``device="cpu"``, and runs the SAME statements as the JAX
package's worker over an 8-segment gang whose motions cross the process
boundary (``torch.distributed`` over gloo on 127.0.0.1). It prints one
``RESULT {json}`` line for the parent to compare across processes,
against the port's one-process run and against the JAX package's.

Beside the three statements it records: the transport's launches and the
bytes it handed to ``torch.distributed`` per statement, the collectives
on fixed stacked inputs, a redistribute that overflows on this cluster's
first process only, EXPLAIN ANALYZE, a direct-dispatched statement, and
the paths that refuse to run across processes.

The spawner provides the environment; this module imports no JAX and
must not change ``os.environ`` (the test imports ``QUERIES``, ``load``,
``collective_inputs`` and ``skew_load`` from it).
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
B, W = 4, 3
HOST_CAP = 4 * 4 * B      # a host pair's most rows: no host rung overflow


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


def _loaded(**over):
    """A CPU session of 8 segments holding ``load``'s tables."""
    import cloudberry_tpu_torch as ct

    s = ct.Session(ct.Config().with_overrides(n_segments=NSEG, **over),
                   device="cpu")
    load(s)
    return s


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
           "local": list(local_segments(NSEG))}
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
        "ring": _refuses(lambda: _loaded(**{
            "interconnect.backend": "ring"}).sql(QUERIES[1])),
        "cursor": _refuses(lambda: s.sql(
            "DECLARE c PARALLEL RETRIEVE CURSOR FOR SELECT k, v FROM fact")),
        "topology": _refuses(lambda: s._topology.begin(4)),
        "degrade": _refuses(lambda: s.degrade_mesh(7)),
        # over budget: the one-process gang tiles it
        "tiled": _refuses(lambda: _loaded(**{
            "resource.query_mem_bytes": 1 << 16}).sql(QUERIES[0])),
    }

    sk = ct.Session(ct.Config().with_overrides(**{
        "n_segments": NSEG, "planner.broadcast_threshold": 0,
        "planner.runtime_filter_threshold": 0}), device="cpu")
    skew_load(sk)
    out["skew"] = {"rows": rows(sk.sql(SKEW_QUERY)),
                   "growth_events": sk.growth_events}
    out["collectives"] = _collectives()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
