"""The ``meta`` verb over the wire, the port's against the JAX
package's: every verb answers with the same keys (and, where the answer
is the catalog's own, the same values); the statement-lifecycle taxonomy
the wire exports; and the fault-injection inventory of the port's seams
against the JAX package's."""

import ast
import re
from pathlib import Path

import pytest

from torch_parity import twin_servers

TIMEOUT = 60
PORT = Path(__file__).resolve().parent.parent / "cloudberry_tpu_torch"
VERBS = ("tables", "columns", "stats", "views", "matviews", "sequences",
         "info", "activity", "sched", "tenants", "metrics", "statements",
         "trace", "progress", "flight", "topology", "ingest", "compaction",
         "summary")
ARG = {"columns": "t", "stats": "t", "metrics": None}
# the answers that are the catalog's own, equal in value
VALUES = ("tables", "columns", "stats", "views", "matviews", "sequences",
          "summary", "compaction")


def _keys(v):
    """An answer's shape: a dict's keys, a list's length and its first
    element's keys."""
    if isinstance(v, dict):
        return sorted(v)
    if isinstance(v, list):
        return (len(v), _keys(v[0]) if v else None)
    return type(v).__name__


@pytest.mark.parametrize("tenancy", [False, True], ids=["plain", "tenancy"])
def test_every_meta_verb_answers_the_same_keys(tmp_path, tenancy):
    def run(e):
        over = {"storage.root": e.root(), "sched.enabled": True,
                "sched.generic_plans": True, "tenancy.enabled": tenancy}
        srv = e.server(config=e.config(**over))
        c = e.client(srv, timeout=TIMEOUT, tenant="t1")
        c.sql("create table t (k bigint, v decimal(10,2), s text) "
              "distributed by (k)")
        c.sql("insert into t values (1, 1.5, 'a'), (2, null, 'b')")
        c.sql("create view vw as select k from t")
        c.sql("create sequence sq")
        c.sql("select k, v from t where k = 1")
        c.append("t", [[3, 2.5, "c"]])
        for verb in VERBS:
            out = c.meta(verb, ARG.get(verb))
            e.keep((verb, _keys(out)))
            if verb in VALUES:
                e.keep(out)
        e.keep(sorted(c.meta("metrics")["counters"]).count("requests_served"))
        e.keep(isinstance(c.meta("metrics", "prom"), str))
        e.wire(c.meta, "nope")
        e.wire(c.meta, "flight", "x")
    got = twin_servers(run, tmp_path)
    assert got[-2][:2] == ("ServerError", "ValueError")
    kinds = [g[0] for g in got if isinstance(g, tuple) and len(g) == 2
             and g[0] in VERBS]
    assert kinds == list(VERBS)


def test_taxonomy_the_wire_exports():
    """``is_retryable`` agrees with the JAX package's for every class and
    name the serving layer raises or stamps, and the three classes the
    port's retryable set named before it defined them now exist."""
    from cloudberry_tpu import lifecycle as JL
    from cloudberry_tpu.exec import resource as JR
    from cloudberry_tpu_torch import lifecycle as TL
    from cloudberry_tpu_torch.exec import resource as TR
    from cloudberry_tpu_torch.sched import dispatcher as TD

    for name in ("ServerBusy", "IngestQueueFull", "ServerDraining",
                 "StatementTimeout", "StatementCancelled", "BreakerOpen",
                 "StorageIOError", "StorageCorruptionError"):
        t, j = getattr(TL, name), getattr(JL, name)
        assert issubclass(t, TL.StatementError)
        assert TL.is_retryable(t("x")) == JL.is_retryable(j("x")), name
        assert TL.is_retryable(name) == JL.is_retryable(name), name
    assert TL.is_retryable(TR.TenantQueueFull("x")) is True
    assert TL.is_retryable(TR.TenantQueueFull("x")) == \
        JL.is_retryable(JR.TenantQueueFull("x"))
    for cls in (TD.SchedQueueFull, TD.SchedDeadline):
        assert TL.is_retryable(cls("x")) is True
    assert TL._RETRYABLE_NAMES == JL._RETRYABLE_NAMES
    tok = TL.CancelToken()
    tok.cancel("drain", "draining")
    with pytest.raises(TL.ServerDraining):
        tok.raise_if_cancelled()
    a, b = TL.StatementHandle(1), TL.StatementHandle(2)
    comp = TL.CompositeHandle([a, b])
    comp.check()
    b.token.cancel()
    with pytest.raises(TL.StatementCancelled):
        comp.check()


def _call_sites() -> set:
    names = set()
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", None)) \
                    == "fault_point" and node.args \
                    and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return names


def test_fault_inventory_against_the_reference(capsys):
    """The port's INVENTORY names every fault_point call site in the
    port and nothing else, and equals the JAX package's inventory less
    the seams of modules not ported yet (compaction, cbfdist), which the
    test prints."""
    from cloudberry_tpu.utils import faultinject as JF
    from cloudberry_tpu_torch.utils import faultinject as TF

    sites = _call_sites()
    assert sites == set(TF.INVENTORY), (sites ^ set(TF.INVENTORY))
    unported = set(JF.INVENTORY) - set(TF.INVENTORY)
    print(f"seams of unported modules: {sorted(unported)}")
    assert unported == {"compact_chunk", "compact_commit",
                        "io_journal_write", "fdist_get"}
    assert set(TF.INVENTORY) <= set(JF.INVENTORY)
    assert "compact_chunk" in capsys.readouterr().out


def test_fault_arming_from_the_environment_and_telemetry():
    """``arm_from_env`` parses the ``CBTPU_INJECT`` grammar as the JAX
    package does; ``list_faults`` reports hits and fires; a 'hang' arm
    is released by ``reset_fault`` and converted by a cancel."""
    import threading

    from cloudberry_tpu.utils import faultinject as JF
    from cloudberry_tpu_torch import lifecycle as TL
    from cloudberry_tpu_torch.utils import faultinject as TF

    spec = "sched_flush=error@2-3; serve_handler=skip;bad;x=sleep@4"
    try:
        assert TF.arm_from_env(spec) == JF.arm_from_env(spec) == 3
        for _ in range(4):
            for F in (TF, JF):
                try:
                    F.fault_point("sched_flush")
                except F.InjectedFault:
                    pass
        assert TF.list_faults()["armed"] == JF.list_faults()["armed"]
        assert TF.list_faults()["armed"]["sched_flush"]["fired"] == 2
        assert "sched_flush" in TF.known_fault_points()
        TF.inject_fault("ingest_flush", "hang")
        done = threading.Event()
        th = threading.Thread(target=lambda: (
            TF.fault_point("ingest_flush"), done.set()))
        th.start()
        assert not done.wait(0.2)
        TF.reset_fault("ingest_flush")
        assert done.wait(10)
        th.join(timeout=10)
        TF.inject_fault("ingest_flush", "hang")
        h = TL.StatementHandle(7)
        err = []

        def wedged():
            with TL.statement_scope(h):
                try:
                    TF.fault_point("ingest_flush")
                except TL.StatementCancelled as ex:
                    err.append(ex)

        th = threading.Thread(target=wedged)
        th.start()
        h.token.cancel()
        th.join(timeout=10)
        assert len(err) == 1
        with pytest.raises(ValueError, match="unknown fault action"):
            TF.inject_fault("x", "explode")
    finally:
        TF.reset_fault()
        JF.reset_fault()
