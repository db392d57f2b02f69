"""The port's multi-process cluster on the CPU, the twin of
``tests/test_multihost.py``.

Two port processes (``tests/torch_multihost_worker.py``) join one cluster
through ``parallel/mesh.py init_distributed`` (``torch.distributed`` over
gloo on 127.0.0.1) with 4 local slots each, own 4 of 8 segments each on
``device="cpu"``, and run the JAX package's multi-host statements over a
gang whose motions cross the process boundary. Results must equal across
the processes, the port's one-process run and the JAX package's
one-process run exactly (every column is an integer or a COUNT); the
collectives on fixed inputs must equal the one-process transports', with
the same ``launches``; the bytes handed to ``torch.distributed`` for each
redistribute must equal ``flat_wire_model`` / ``two_level_wire_model``;
a redistribute that overflows on one process's segments only grows and
retries on both. Across the process boundary also: the ring transport,
tiled distributed execution in its four modes, a degrade 8 -> 7 over
``[0, 1, 2, 4, 5, 6, 7]`` (the JAX package's ragged 3 + 4 layout), a
device-lost re-dispatch that degrades alike, an online resize 6 -> 8
(4 + 2 -> 4 + 4), the tiled recovery paths (a resume re-sharded onto
the 3 + 4 ranges, an accumulator overflow's retry, the skew sentinel's
replan) and the collectives over a ragged layout; processes
that pin different layouts raise ``ClusterLayoutError``; and a parallel
retrieve cursor raises a named ``NotImplementedError`` (the JAX package
fails there too).

The same workers then run a store-backed cluster (6 segments, 4 + 2)
over copies of one store: its reads, DML and transaction commit, a
compaction pass and an online resize 6 -> 8 that moves stored
partitions, each equal to one port process (and the JAX package's one
process) over another copy, with exactly one manifest version per
written table and statement, since process 0 alone commits
(parallel/writer.py; the JAX package commits on every process, ROADMAP
C 62); an INSERT whose process 0 is held between its manifest read and
its commit still commits once; a process held on an older snapshot
raises ``ClusterSnapshotError`` on every process; a resize interrupted
by a chunk fault on process 0 resumes from the journal on every
process; a failover shrink over the store.

Both workers run once per module (the module about 75 s alone here);
every wait is bounded: the workers by ``WORKER_TIMEOUT_S``, each collective by
``mesh.DIST_TIMEOUT_S``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.parallel import mesh as TM
from cloudberry_tpu_torch.parallel import transport as TT
from torch_multihost_worker import (B, COPY_FILE, DIRECT_QUERY,
                                    HOST_CAP, LOCAL_SLOTS, NSEG, QUERIES,
                                    RACE_INSERT, RAGGED, RESIZE,
                                    SKEW_QUERY, SPILL_BUDGET, SPILL_QUERY,
                                    STORE_CFG, STORE_DML, STORE_QUERIES,
                                    SURVIVORS, TILED, W, collective_inputs,
                                    live_by_seg, load, pipe_load,
                                    ragged_inputs, recovery_runs,
                                    resume_run, rows, skew_load,
                                    spill_load, store_answers, store_copies,
                                    store_dml, store_session, tiled_report,
                                    versions)
from torch_parity import strip_timings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
WORKER_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The directory of the store copies the workers use; its ``base``
    is the untouched store the one-process runs copy."""
    top = tmp_path_factory.mktemp("cluster_stores")
    store_copies(str(top))
    return top


@pytest.fixture(scope="module")
def cluster(stores):
    """Both workers' RESULT objects, by process index."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("CBTPU_")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["CBTPU_COORDINATOR"] = f"127.0.0.1:{port}"
        env["CBTPU_NUM_PROCS"] = "2"
        env["CBTPU_PROC_ID"] = str(pid)
        env["CBTPU_LOCAL_SLOTS"] = str(LOCAL_SLOTS)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(stores)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")][-1]
            outs.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return sorted(outs, key=lambda o: o["host"])


def _port(loader=None, nseg=NSEG, **over):
    s = TorchSession(TorchConfig(n_segments=nseg).with_overrides(**over),
                     device="cpu")
    (loader or load)(s)
    return s


def _jax(loader=None, nseg=NSEG, **over):
    import cloudberry_tpu as cb
    from cloudberry_tpu.config import get_config

    s = cb.Session(get_config().with_overrides(n_segments=nseg, **over))
    (loader or load)(s)
    return s


def _jax_rows(s, q) -> dict:
    df = s.sql(q).to_pandas()
    return {c: df[c].tolist() for c in df.columns}


def _sorted_rows(r: dict) -> list:
    return sorted(zip(*r.values()))


def test_mesh_topology_reports_the_process_hosts(cluster):
    assert [o["host"] for o in cluster] == [0, 1]
    for p, o in enumerate(cluster):
        topo = o["topology"]
        assert topo["n_hosts"] == 2 and topo["this_host"] == p
        assert topo["segments_by_host"] == {"0": [0, 1, 2, 3],
                                            "1": [4, 5, 6, 7]}
        assert o["local"] == list(range(4 * p, 4 * p + 4))


def test_init_distributed_is_a_noop_without_a_coordinator(monkeypatch,
                                                         cluster):
    monkeypatch.delenv("CBTPU_COORDINATOR", raising=False)
    TM.init_distributed()
    TM.init_distributed()
    assert not torch.distributed.is_initialized()
    assert (TM.process_count(), TM.process_index()) == (1, 0)
    assert list(TM.local_segments(NSEG)) == list(range(NSEG))
    topo = TM.mesh_topology(NSEG)
    assert topo["n_hosts"] == 1 and topo["this_host"] == 0
    # the workers called it twice: one group of two processes
    assert [o["procs"] for o in cluster] == [2, 2]


def test_a_segment_count_the_processes_do_not_divide_raises(cluster):
    """3 segments over two processes of 4 local slots leave process 1
    without a segment: the reference's rule and wording. Without local
    slot counts the pool splits evenly and 2 must divide it."""
    for o in cluster:
        msg = o["indivisible"]
        assert msg == ("n_segments=3 covers only hosts [0] of 2; every host "
                       "must own at least one segment (raise n_segments "
                       "or shrink the cluster)"), msg
    with pytest.raises(RuntimeError, match="n_segments=3 cannot be split "
                       "over 2 processes"):
        TM.segment_owners(3, procs=2)


def test_two_processes_equal_each_other_flat_and_two_level(cluster):
    a, b = cluster
    assert a["results"] == b["results"]
    assert a["hier_results"] == b["hier_results"] == a["results"]
    assert a["flat_results"] == b["flat_results"] == a["results"]


def test_two_processes_equal_the_one_process_run(cluster):
    one = _port()
    want = [rows(one.sql(q)) for q in QUERIES]
    for o in cluster:
        assert o["results"] == want
        assert o["flat_results"] == want


def test_two_processes_equal_the_jax_package(cluster):
    """The oracle of ``tests/test_multihost.py``: the JAX package's
    one-process 8-segment run of the same statements."""
    import cloudberry_tpu as cb
    from cloudberry_tpu.config import get_config

    oracle = cb.Session(get_config().with_overrides(n_segments=NSEG))
    load(oracle)
    for q, got in zip(QUERIES, cluster[0]["results"]):
        df = oracle.sql(q).to_pandas()
        exp = {c: df[c].tolist() for c in df.columns}
        assert got == exp, f"two-process result differs for {q!r}"


def test_launches_equal_the_one_process_two_host_run(monkeypatch, cluster):
    """The same plan at 2 hosts of 4: one process (simulated hosts)
    counts the permutations each process of the cluster counts."""
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "2")
    made = []
    real = TT.make_transport
    monkeypatch.setattr(TT, "make_transport", lambda *a, **kw: (
        made.append(real(*a, **kw)), made[-1])[1])
    one = _port(**{"interconnect.hierarchical": "on"})
    launches, results = [], []
    for q in QUERIES:
        made.clear()
        results.append(rows(one.sql(q)))
        launches.append(sum(getattr(tx, "launches", 0) for tx in made))
    assert sum(launches) > 0
    for o in cluster:
        assert o["launches"]["on"] == launches
        assert o["hier_results"] == results


@pytest.mark.parametrize("name", [
    "all_gather", "all_to_all", "psum", "pmax", "tree_gather",
    "hier_all_to_all", "host_demand", "host_ring", "intra_all_gather"])
def test_collectives_equal_the_one_process_transports(cluster, name):
    """Each process's segments receive what the same segments receive
    from ``OneCardCollectives`` and the one-process two-level transport
    on the stacked inputs of all 8 segments; per-segment outputs are
    split by process, replicated ones equal whole."""
    ints, wire, digest = collective_inputs()
    topo = TM.HostTopology(NSEG, ((0, 1, 2, 3), (4, 5, 6, 7)))
    one = TT.OneCardCollectives()
    hier = TT.HierarchicalCollectives(topo)
    xs = list(torch.from_numpy(ints))
    ws = list(torch.from_numpy(wire))
    recv, hdem = hier.hier_all_to_all(ws, host_cap=HOST_CAP)
    whole = {
        "all_gather": one.all_gather(xs),
        "psum": one.psum(xs),
        "pmax": one.pmax(xs),
        "tree_gather": hier.all_gather(ws, unsigned=True),
    }
    per_seg = {
        "all_to_all": torch.stack(one.all_to_all(ws)),
        "hier_all_to_all": torch.stack(recv),
        "host_demand": hdem,
        "host_ring": hier.host_ring_exchange(torch.from_numpy(digest)),
        "intra_all_gather": hier.intra_all_gather(torch.from_numpy(digest)),
    }
    for p, o in enumerate(cluster):
        got = o["collectives"][name]
        if name in whole:
            assert got == whole[name].tolist()
        else:
            assert got == per_seg[name][4 * p:4 * p + 4].tolist()
        assert o["collectives"]["launches"] == hier.launches
    # the two-level exchange delivers the flat one's valid rows
    flat = per_seg["all_to_all"]
    valid = (flat[..., :1] & 1).bool()
    assert torch.equal(per_seg["hier_all_to_all"],
                       torch.where(valid, flat, torch.zeros_like(flat)))


def test_bytes_across_the_processes_equal_the_wire_models(cluster):
    """Summed over both processes, each redistribute's bytes handed to
    ``torch.distributed`` (the blocks sent to the other process) are the
    models' cross-host bytes for the plan's rungs and row width, as the
    executor stamps them (2 hosts of 4 segments): the two-level exchange
    ships one block per ordered host pair, the flat one every cross-host
    (source, destination) block."""
    seen = set()
    for mode in ("on", "off"):
        for ex0, ex1 in zip(*[o["exchanges"][mode] for o in cluster]):
            assert len(ex0) == len(ex1)
            for a, b in zip(ex0, ex1):
                assert {k: v for k, v in a.items() if k != "bytes"} == \
                    {k: v for k, v in b.items() if k != "bytes"}
                if a["op"] == "hier_all_to_all":
                    model = TT.two_level_wire_model(
                        NSEG, 2, a["bucket_cap"], a["host_bucket_cap"],
                        a["row_bytes"])
                else:
                    model = TT.flat_wire_model(NSEG, 2, a["bucket_cap"],
                                               a["row_bytes"])
                assert a["bytes"] + b["bytes"] == model["dcn_bytes"], \
                    (mode, a, model)
                seen.add(a["op"])
    assert seen == {"hier_all_to_all", "all_to_all"}


def test_skewed_overflow_on_one_process_grows_both(cluster):
    """The redistribute overflows only at the first process's source
    segments; the checks are reduced over the processes, so both grow
    and retry once, as the one-process run does, and answer alike."""
    one = TorchSession(TorchConfig(n_segments=NSEG).with_overrides(**{
        "planner.broadcast_threshold": 0,
        "planner.runtime_filter_threshold": 0}), device="cpu")
    skew_load(one)
    want = rows(one.sql(SKEW_QUERY))
    assert one.growth_events >= 1
    for o in cluster:
        assert o["skew"]["rows"] == want
        assert o["skew"]["growth_events"] == one.growth_events


def test_explain_analyze_equals_the_one_process_run(cluster):
    want = strip_timings(_port().explain_analyze(QUERIES[0]))
    for o in cluster:
        assert strip_timings(o["explain"]) == want


def test_direct_dispatch_equals_the_one_process_run(cluster):
    want = rows(_port().sql(DIRECT_QUERY))
    assert want["k"] and set(want["k"]) == {17}
    for o in cluster:
        assert o["direct"] == want


@pytest.mark.parametrize("path", ["cursor"])
def test_paths_not_ported_across_processes_raise(cluster, path):
    """A parallel retrieve cursor's endpoints stay one-process: the JAX
    package fails there too ("Fetching value for jax.Array that spans
    non-addressable devices is not possible")."""
    for o in cluster:
        msg = o["refusals"][path]
        assert "across processes is not ported" in msg, msg


# ------------------------------------------------- ragged ownership


class _Device:
    def __init__(self, process_index):
        self.process_index = process_index


def _jax_host_topology(monkeypatch, n, ids):
    """The JAX package's ``host_topology`` over 8 stand-in devices of two
    processes of 4 (``jax.devices`` patched here; the package itself is
    not touched)."""
    import jax

    from cloudberry_tpu.parallel import mesh as JM

    monkeypatch.setattr(jax, "devices",
                        lambda: [_Device(p) for p in (0,) * 4 + (1,) * 4])
    monkeypatch.setattr(JM, "_topo_cache", {})
    monkeypatch.delenv("CBTPU_FORCE_HOSTS", raising=False)
    return JM.host_topology(n, ids).as_dict()


@pytest.mark.parametrize("n,ids", [
    (NSEG, None), (RESIZE[0], None), (7, SURVIVORS),
    (7, [1, 2, 3, 4, 5, 6, 7]), (5, [0, 4, 5, 6, 7])],
    ids=["8", "6", "7-hole-3", "7-hole-0", "5-hole-1-2-3"])
def test_segment_owners_follow_the_jax_device_order(monkeypatch, n, ids):
    """Segment s lives on the s-th surviving slot of the pool of two
    processes' 4 local slots, as the JAX package meshes it over devices."""
    want = _jax_host_topology(monkeypatch, n, ids)
    owners = TM.segment_owners(n, ids, procs=2, local_slots=(4, 4))
    got = {h: list(r) for h, r in enumerate(TM.owner_ranges(owners))}
    assert got == want["segments_by_host"]


def test_a_process_without_segments_raises_like_jax(monkeypatch):
    """The JAX package's ``segment_mesh`` refuses a layout that leaves a
    host without a segment; the port raises the same words."""
    import jax

    from cloudberry_tpu.parallel import mesh as JM

    monkeypatch.setattr(jax, "devices",
                        lambda: [_Device(p) for p in (0,) * 4 + (1,) * 4])
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(RuntimeError) as want:
        JM.segment_mesh(3)
    with pytest.raises(RuntimeError) as got:
        TM.segment_owners(3, procs=2, local_slots=(4, 4))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the ring


def test_ring_equals_the_one_process_ring_and_jax(monkeypatch, cluster):
    """The ring's shifts cross the process boundary at the blocks'
    edges; results equal the port's and the JAX package's one-process
    ring runs, and each statement counts the one-process ring's shifts."""
    made = []
    real = TT.make_transport
    monkeypatch.setattr(TT, "make_transport", lambda *a, **kw: (
        made.append(real(*a, **kw)), made[-1])[1])
    one = _port(**{"interconnect.backend": "ring"})
    want, launches = [], []
    for q in QUERIES:
        made.clear()
        want.append(rows(one.sql(q)))
        launches.append(sum(tx.launches for tx in made))
    assert all(launches)
    js = _jax(**{"interconnect.backend": "ring"})
    assert [_jax_rows(js, q) for q in QUERIES] == want
    for o in cluster:
        assert o["ring"]["results"] == want == o["results"]
        assert o["ring"]["launches"] == launches


def test_ring_redistributes_hand_gloo_the_flat_model(cluster):
    """A ring all_to_all moves each block straight from its source to its
    destination: summed over both processes, each redistribute's bytes
    are the flat exchange's cross-host bytes."""
    seen = 0
    for ex0, ex1 in zip(*[o["ring"]["exchanges"] for o in cluster]):
        for a, b in zip(ex0, ex1):
            model = TT.flat_wire_model(NSEG, 2, a["bucket_cap"],
                                       a["row_bytes"])
            assert a["bytes"] + b["bytes"] == model["dcn_bytes"], (a, b)
            seen += 1
    assert seen


# ------------------------------------------- tiled distributed execution


def test_tiled_spill_query_equals_the_jax_tiled_run(cluster):
    """``test_spill_dist.py``'s join-group query, over budget: both
    processes stream their segments' tiles and equal the JAX package's
    one-process tiled run, with its decisions."""
    js = _jax(spill_load, **{"planner.broadcast_threshold": 0,
                             "resource.query_mem_bytes": SPILL_BUDGET})
    want = _jax_rows(js, SPILL_QUERY)
    jrep = js.last_tiled_report
    assert jrep["tiled"] and jrep["distributed"] and jrep["n_tiles"] > 1
    for o in cluster:
        assert o["spill"]["rows"] == want
        rep = o["spill"]["report"]
        assert rep["tiled"] and rep["distributed"]
        assert rep["n_segments"] == NSEG
        for k in ("n_tiles", "tile_rows", "acc_capacity"):
            assert rep[k] == jrep[k], k


@pytest.mark.parametrize("mode", list(TILED))
def test_tiled_modes_equal_the_one_process_run(cluster, mode):
    """Each tiled mode across the processes equals the port's
    one-process tiled run (itself held to the JAX package by
    ``test_torch_tiled_dist.py::test_dist8_modes_match_jax``), with the
    same decisions; a window's rows compare in sorted order."""
    q, budget, n_fact, n_groups = TILED[mode]
    one = _port(pipe_load(n_fact, n_groups),
                **{"resource.query_mem_bytes": budget})
    want = rows(one.sql(q))
    rep = tiled_report(one.last_tiled_report)
    assert rep["tiled"] and rep["n_tiles"] > 1
    for o in cluster:
        got = o["tiled"][mode]
        assert got["report"] == rep
        if mode == "window":
            assert _sorted_rows(got["rows"]) == _sorted_rows(want)
        else:
            assert got["rows"] == want


# ------------------------------------------ tiled recovery across processes


@pytest.fixture(scope="module")
def one_process_recovery():
    """``recovery_runs`` in this one process, the workers' counterpart
    (itself held to the JAX package by ``test_torch_dist_recovery.py``
    and ``test_torch_dist_adaptive.py``)."""
    return recovery_runs()


RESUME_COUNTERS = ("tile_resumes", "topo_resharded_resumes",
                   "tiles_replayed", "tile_resume_declined", "recoveries")


def test_degraded_resume_reshards_onto_the_ragged_ranges(
        cluster, one_process_recovery):
    """A device loss mid-stream on both processes, whose probe loses
    process 0's last slot: both resume from their checkpoints on 3 + 4,
    each re-sharding its partials onto its new range (process 0 from
    [0, 4) to [0, 3), process 1 from [4, 8) to [3, 7)), and answer as
    the clean run and the one-process degraded resume do, with its
    resume decisions."""
    one = one_process_recovery["resume"]
    assert one["counters"]["topo_resharded_resumes"] == 1
    assert one["rows"] == one["clean"]
    for p, o in enumerate(cluster):
        r = o["recovery"]["resume"]
        assert r["rows"] == r["clean"] == one["rows"]
        lay = r["layout"]
        assert (lay["epoch"], lay["nseg"], lay["live"]) == (2, 7, SURVIVORS)
        assert lay["local"] == [[0, 1, 2], [3, 4, 5, 6]][p]
        assert r["report"] == one["report"]
        assert r["report"]["resumed_from_tile"] > 0
        for k in RESUME_COUNTERS:
            assert r["counters"][k] == one["counters"][k], k


def test_accumulator_overflow_retries_alike_on_every_process(
        cluster, one_process_recovery):
    """A late accumulator overflow: both processes grow the accumulator
    to the same capacity, retry and resume from the same checkpoint, as
    the one-process run does."""
    one = one_process_recovery["overflow"]
    assert one["report"]["resumed_from_tile"] > 0
    for o in cluster:
        r = o["recovery"]["overflow"]
        assert r["rows"] == one["rows"]
        assert r["report"] == one["report"]
        assert r["counters"] == one["counters"]


@pytest.mark.parametrize("case", ["fires", "seam_on_one"])
def test_skew_replan_is_agreed_across_processes(cluster,
                                                one_process_recovery, case):
    """The skew sentinel's mid-statement replan fires on both processes
    and resumes from the same tile as in one process; with its seam
    skipped on process 1 alone, neither process replans. The rows equal
    the one-process run's either way."""
    one = one_process_recovery["fires"]
    assert one["counters"]["tile_replans"] == 1
    for o in cluster:
        r = o["recovery"][case]
        assert r["rows"] == one["rows"]
        if case == "fires":
            assert r["report"] == one["report"]
            for k in ("tile_replans", "tile_resumes"):
                assert r["counters"][k] == one["counters"][k] == 1, k
        else:
            assert r["counters"]["tile_replans"] == 0
            assert r["counters"]["tile_resumes"] == 0
            assert r["report"]["resumed_from_tile"] == 0


# ------------------------------------- degrade and topology changes


def test_degrade_gives_the_jax_ragged_layout(monkeypatch, cluster):
    want = _jax_host_topology(monkeypatch, 7, SURVIVORS)
    assert want["segments_by_host"] == {0: [0, 1, 2], 1: [3, 4, 5, 6]}
    for p, o in enumerate(cluster):
        lay = o["degrade"]["layout"]
        assert (lay["epoch"], lay["nseg"], lay["live"]) == (2, 7, SURVIVORS)
        assert {int(h): v for h, v in lay["hosts"]["segments_by_host"]
                .items()} == want["segments_by_host"]
        assert not lay["hosts"]["uniform_contiguous"]
        assert lay["local"] == want["segments_by_host"][p]


def test_degrade_results_equal_jax(cluster):
    js = _jax()
    js.sql(QUERIES[0])
    js.degrade_mesh(len(SURVIVORS), SURVIVORS)
    want = [_jax_rows(js, q) for q in QUERIES]
    for o in cluster:
        assert o["degrade"]["results"] == want


def test_device_lost_redispatch_degrades_every_process_alike(cluster):
    """A device-lost statement on both processes, whose probe loses
    process 0's last slot: the gathered probe gives both the same
    survivors, both mint epoch 2 at 3 + 4, and the retry answers as the
    one-process run does."""
    want = rows(_port().sql(QUERIES[0]))
    lays = [o["redispatch"]["layout"] for o in cluster]
    for p, (o, lay) in enumerate(zip(cluster, lays)):
        assert o["redispatch"]["rows"] == want
        assert o["redispatch"]["recoveries"] == 1
        assert (lay["epoch"], lay["nseg"], lay["live"]) == (2, 7, SURVIVORS)
        assert lay["local"] == [[0, 1, 2], [3, 4, 5, 6]][p]


def test_online_resize_6_to_8_moves_the_one_process_rows(cluster):
    """4 + 2 -> 4 + 4: epoch 2, and every process reports the cluster's
    move: the one-process run's counts."""
    one = _port(nseg=RESIZE[0])
    rec = one._topology.online_resize(RESIZE[1])
    for p, o in enumerate(cluster):
        r = o["resize"]
        assert (r["epoch"], r["reason"]) == (rec["epoch"], "expand") \
            == (2, "expand")
        assert r["before"]["layout"]["local"] == [[0, 1, 2, 3], [4, 5]][p]
        assert r["after"]["layout"]["local"] == [[0, 1, 2, 3],
                                                 [4, 5, 6, 7]][p]
        assert o["local_6"] == r["before"]["layout"]["local"]
        for k in ("moved_rows", "total_rows"):
            assert r[k] == rec["rebalance"][k] > 0, k


def test_online_resize_results_equal_jax(cluster):
    js = _jax(nseg=RESIZE[0])
    before = [_jax_rows(js, q) for q in QUERIES]
    assert js._topology.online_resize(RESIZE[1])["epoch"] == 2
    after = [_jax_rows(js, q) for q in QUERIES]
    for o in cluster:
        assert o["resize"]["before"]["results"] == before
        assert o["resize"]["after"]["results"] == after


def test_processes_that_pin_different_layouts_raise(cluster):
    """One process degraded alone: the next statement's agreement check
    raises on both instead of pairing unrelated blocks."""
    for o in cluster:
        assert o["mismatch"].startswith(
            "the processes pinned different (epoch, segment count, "
            "layout)"), o["mismatch"]


# -------------------------------------- collectives over a ragged layout


@pytest.mark.parametrize("tx", ["flat", "ring"])
@pytest.mark.parametrize("name", ["all_gather", "all_to_all", "psum",
                                  "pmax"])
def test_ragged_collectives_equal_the_one_card_exchange(cluster, tx, name):
    """Over 4 + 2 segments, ``ProcessCollectives`` and the ring deliver
    what ``OneCardCollectives`` delivers on the stacked inputs."""
    ints, wire = ragged_inputs()
    one = TT.OneCardCollectives()
    xs = list(torch.from_numpy(ints))
    want = {"all_gather": one.all_gather(xs), "psum": one.psum(xs),
            "pmax": one.pmax(xs),
            "all_to_all": torch.stack(one.all_to_all(
                list(torch.from_numpy(wire))))}[name]
    for rng, o in zip(TM.owner_ranges(RAGGED), cluster):
        got = o["ragged"][tx][name]
        if name == "all_to_all":
            assert got == want[rng.start:rng.stop].tolist()
        else:
            assert got == want.tolist()


def test_ragged_all_to_all_bytes_equal_the_extended_wire_model(cluster):
    """The flat model of a ragged layout: host h sends |h|·(nseg − |h|)
    blocks across. The ring moves the same blocks, and counts the
    one-process ring's shifts."""
    model = TT.flat_wire_model(len(RAGGED), 2, B, W * 4, sizes=[4, 2])
    assert model["dcn_bytes"] == 16 * B * W * 4
    ring = TT.RingCollectives(len(RAGGED))
    ints, wire = ragged_inputs()
    xs = list(torch.from_numpy(ints))
    ring.all_gather(xs), ring.psum(xs), ring.pmax(xs)
    ring.all_to_all(list(torch.from_numpy(wire)))
    for tx in ("flat", "ring"):
        assert sum(o["ragged"][tx]["a2a_bytes"] for o in cluster) \
            == model["dcn_bytes"], tx
    for o in cluster:
        assert o["ragged"]["ring"]["launches"] == ring.launches


# ------------------------------------------------ the store-backed cluster


def _copy(stores, tmp_path, name="one") -> str:
    """A fresh copy of the untouched store under ``tmp_path``."""
    dst = str(tmp_path / name)
    shutil.copytree(str(stores / "base"), dst)
    return dst


def _jax_store(root, nseg=6):
    import cloudberry_tpu as cb
    from cloudberry_tpu.config import get_config

    return cb.Session(get_config().with_overrides(
        n_segments=nseg, **{"storage.root": root, **STORE_CFG}))


def _store(cluster, name) -> list:
    """Both processes' record of one store scenario, which must have run."""
    recs = [o["store"][name] for o in cluster]
    for r in recs:
        assert "error" not in r, r["error"]
    return recs


def test_store_reads_equal_one_process_and_jax(cluster, stores, tmp_path):
    """Each process answers from the store as one port process does (the
    stored values, DECIMAL sums included, bit for bit) and as the JAX
    package's one process does."""
    one = store_answers(store_session(_copy(stores, tmp_path)))
    js = _jax_store(_copy(stores, tmp_path, "jax"))
    jax = [_jax_rows(js, q) for q in STORE_QUERIES]
    for p, r in enumerate(_store(cluster, "reads")):
        assert r["answers"] == one
        assert [a["rows"] for a in r["answers"]] == jax
        assert r["layout"]["local"] == [[0, 1, 2, 3], [4, 5]][p]


def test_store_failover_shrink_over_a_store(cluster):
    """A device loss on a store-backed 8-segment cluster promotes to a
    failover epoch of 7 segments (3 + 4) on both processes, answering as
    before."""
    want = _store(cluster, "reads")[0]["answers"][0]
    for p, r in enumerate(_store(cluster, "reads")):
        f = r["failover"]
        assert f["answer"] == want
        assert f["reason"] == "failover"
        assert (f["layout"]["nseg"], f["layout"]["live"]) == (7, SURVIVORS)
        assert f["layout"]["local"] == [[0, 1, 2], [3, 4, 5, 6]][p]


@pytest.fixture(scope="module")
def one_dml(stores, tmp_path_factory):
    """STORE_DML, its answers and a compaction pass in one port process
    over a copy of the store."""
    from cloudberry_tpu_torch.storage.compact import CompactionService

    root = _copy(stores, tmp_path_factory.mktemp("one_dml"))
    s = store_session(root)
    rec = {"statements": store_dml(s, root, str(stores / COPY_FILE)),
           "answers": store_answers(s)}
    before = versions(root)["t"]
    rec["compact"] = CompactionService(s).run_once(force=True)
    rec["compact_added"] = versions(root)["t"] - before
    rec["after_compact"] = store_answers(s)
    return rec


@pytest.mark.parametrize("i", range(len(STORE_DML)))
def test_store_dml_commits_once_on_process_0(cluster, one_dml, i):
    """Each statement's status equals the one-process run's, and adds
    exactly one manifest version to each table it writes (the COMMIT to
    both of its tables; none inside the transaction): one commit, by
    process 0, not one per process."""
    want = one_dml["statements"][i]
    q = STORE_DML[i].split()[0].upper()
    written = {"COMMIT": {"t": 1, "d": 1}, "BEGIN": {}}.get(q, {"t": 1})
    in_txn = 4 < i < 7
    assert want["added"] == {n: (0 if in_txn else written.get(n, 0))
                             for n in ("d", "t")}
    for r in _store(cluster, "dml"):
        assert r["statements"][i] == want


def test_store_dml_results_equal_one_process_and_jax(cluster, one_dml,
                                                     stores, tmp_path):
    """After the DML and the transaction, each process answers as the
    one port process and the JAX package's one process over copies of
    the store; so does each process after a compaction pass that process
    0 alone committed."""
    js = _jax_store(_copy(stores, tmp_path, "jax"))
    for q in STORE_DML:
        js.sql(q.format(copy=str(stores / COPY_FILE)))
    jax = [_jax_rows(js, q) for q in STORE_QUERIES]
    assert [a["rows"] for a in one_dml["answers"]] == jax
    for r in _store(cluster, "dml"):
        assert r["answers"] == one_dml["answers"]
        assert r["compact"] == one_dml["compact"]
        assert r["compact_added"] == one_dml["compact_added"] > 0
        assert r["after_compact"] == one_dml["answers"]


def test_store_insert_held_between_read_and_commit_commits_once(
        cluster, stores, tmp_path):
    """Process 0 sleeps between its manifest read and its commit: without
    one writer the other process commits meanwhile and the INSERT makes
    two manifest versions; with it, one, and the rows are the one-process
    run's."""
    root = _copy(stores, tmp_path)
    s = store_session(root)
    status = str(s.sql(RACE_INSERT))
    want = store_answers(s)
    for r in _store(cluster, "race"):
        assert (r["status"], r["added"]) == (status, 1)
        assert r["answers"] == want


def test_store_commit_error_on_process_0_raises_on_every_process(cluster):
    """Process 0's manifest write fails: the INSERT raises the same error
    on both processes, and neither keeps its rows."""
    for r in _store(cluster, "race"):
        assert r["failed"] == "fault injected at 'io_manifest_write'"
        assert r["after_failed"] == r["answers"][0]


def test_store_insert_past_the_quota_raises_on_every_process(cluster):
    """A cluster over a store past its disk quota: process 0 refuses the
    INSERT at its commit, the ``QuotaError`` raises on both processes, no
    manifest version is written, and both still answer the table's rows
    as before."""
    runs = _store(cluster, "quota")
    for r in runs:
        assert r["raised"].startswith("disk quota exceeded: store uses"), r
        assert r["raised"].endswith("quota bytes; writes to 't' refused "
                                    "(DELETE / DROP TABLE to reclaim)")
        assert set(r["added"].values()) == {0}, r["added"]
        assert r["after"] == r["first"]
    assert runs[0]["raised"] == runs[1]["raised"]


def test_store_snapshot_agreement_raises_on_every_process(cluster, stores,
                                                          tmp_path):
    """Process 0 commits outside a statement and process 1 is held on the
    older snapshot: the next statement raises on both instead of
    answering from two versions, and the one after answers from the new
    version on both."""
    root = _copy(stores, tmp_path)
    s = store_session(root)
    first = store_answers(s)[0]
    s.store.delete_rows("d", lambda c: c["g"] == 11)
    after = store_answers(s)[2]
    for r in _store(cluster, "held"):
        assert r["first"] == first
        assert r["raised"].startswith(
            "the processes pinned different store snapshots"), r["raised"]
        assert r["next"] == after


@pytest.fixture(scope="module")
def one_resize(stores, tmp_path_factory):
    """The one-process port's and the JAX package's resize 6 -> 8 over
    copies of the store."""
    top = tmp_path_factory.mktemp("one_resize")
    root = _copy(stores, top)
    s = store_session(root)
    rec = s._topology.online_resize(8)["rebalance"]
    out = {"port": {"rebalance": rec, "live": live_by_seg(root, 8),
                    "answers": store_answers(s)}}
    jroot = _copy(stores, top, "jax")
    js = _jax_store(jroot)
    jrec = js._topology.online_resize(8)["rebalance"]
    out["jax"] = {"rebalance": jrec, "live": live_by_seg(jroot, 8),
                  "answers": [_jax_rows(js, q) for q in STORE_QUERIES]}
    return out


def test_store_resize_moves_the_one_process_partitions(cluster,
                                                       one_resize):
    """Process 0 alone moves the stored delta: the same live rows per
    destination segment in the partitions tagged for 8 segments, and the
    same live total, as one port process's resize and the JAX package's;
    every process reports the mover's counts (the JAX package reports
    each process's own)."""
    port, jax = one_resize["port"], one_resize["jax"]
    assert port["live"] == jax["live"]
    assert port["rebalance"]["moved_rows"] \
        == jax["rebalance"]["moved_rows"] > 0
    for p, r in enumerate(_store(cluster, "resize")):
        assert r["live"] == port["live"]
        for k in ("moved_rows", "total_rows", "moved_bytes"):
            assert r[k] == port["rebalance"][k], k
        assert (r["epoch"], r["reason"]) == (2, "expand")
        assert r["layout"]["local"] == [[0, 1, 2, 3], [4, 5, 6, 7]][p]


def test_store_resize_results_equal_one_process_and_jax(cluster,
                                                        one_resize):
    want = one_resize["port"]["answers"]
    assert [a["rows"] for a in want] == one_resize["jax"]["answers"]
    for r in _store(cluster, "resize"):
        assert r["before"] == want == r["answers"]


def test_store_resize_resumes_from_the_journal_on_every_process(
        cluster, one_resize, stores, tmp_path):
    """A chunk fault on process 0 fails the resize on both processes; a
    fresh session resumes it from ``_TOPOLOGY.json`` on both, leaving the
    store as the uninterrupted resize does and reporting the counts of one
    port process's resume after the same fault."""
    one = resume_run(_copy(stores, tmp_path))
    assert one["failed"] and one["live"] == one_resize["port"]["live"]
    for r in _store(cluster, "resume"):
        assert r["failed"] == one["failed"]
        assert r["live"] == one["live"]
        assert r["answers"] == one_resize["port"]["answers"]
        for k in ("epoch", "moved_rows", "total_rows", "moved_bytes"):
            assert r[k] == one[k], k
