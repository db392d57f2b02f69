"""The port's multi-process cluster on the CPU, the twin of
``tests/test_multihost.py``.

Two port processes (``tests/torch_multihost_worker.py``) join one cluster
through ``parallel/mesh.py init_distributed`` (``torch.distributed`` over
gloo on 127.0.0.1), own 4 of 8 segments each on ``device="cpu"``, and
run the JAX package's multi-host statements over a gang whose motions
cross the process boundary. Results must equal across the processes, the
port's one-process 8-segment run and the JAX package's one-process
8-segment run exactly (every column is an integer or a COUNT); the
collectives on fixed inputs must equal the one-process transports', with
the same ``launches``; the bytes handed to ``torch.distributed`` for each
redistribute must equal ``flat_wire_model`` / ``two_level_wire_model``;
a redistribute that overflows on one process's segments only grows and
retries on both; and the paths not ported across processes raise a named
``NotImplementedError``.

Both workers run once per module (about 5 s here); every wait is
bounded: the workers by ``WORKER_TIMEOUT_S``, each collective by
``mesh.DIST_TIMEOUT_S``.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.parallel import mesh as TM
from cloudberry_tpu_torch.parallel import transport as TT
from torch_multihost_worker import (DIRECT_QUERY, HOST_CAP, NSEG, QUERIES,
                                    SKEW_QUERY, collective_inputs, load,
                                    rows, skew_load)
from torch_parity import strip_timings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
WORKER_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster():
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
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, cwd=REPO,
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


def _port(**over):
    s = TorchSession(TorchConfig(n_segments=NSEG).with_overrides(**over),
                     device="cpu")
    load(s)
    return s


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
    for o in cluster:
        msg = o["indivisible"]
        assert "n_segments=3" in msg and "2 processes" in msg, msg


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


@pytest.mark.parametrize("path", ["ring", "cursor", "topology", "degrade",
                                  "tiled"])
def test_paths_not_ported_across_processes_raise(cluster, path):
    for o in cluster:
        msg = o["refusals"][path]
        assert "across processes is not ported" in msg, msg
