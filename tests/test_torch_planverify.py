"""The plan verification gate (plan/verify.py) and its mutation corpus
(plan/mutate.py) through the port against the JAX package, on the CPU:
counterparts of the JAX package's ``test_planverify.py``.

1. Clean plans: the 22 TPC-H plans verify clean at 1 and 8 segments in
   both engines, with the same node count and rule rows hit.
2. Seeded mutations: every ported corruption class is caught, with the
   same rule ids at the same node paths as the JAX package's on the same
   statement. The port's corpus is the JAX package's minus its three
   two-level (hierarchical) classes, whose rules the port does not have.
3. The ``debug.verify_plans`` session gate: clean statements run
   bit-identically with it on; a corrupt plan raises ``PlanVerifyError``
   on the statement path, and the gate covers the generic-plan build and
   the greedy re-plan.
4. Contract surfaces: ``$params`` and ``$nrw`` slots against the paramplan
   signature, EXPLAIN's ``dist:`` annotation, the recovery-mode registry,
   the unruled-node finding and local mode.
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.plan import mutate as JM
from cloudberry_tpu.plan import verify as JV
from cloudberry_tpu.plan.planner import plan_statement as j_plan_statement
from cloudberry_tpu.sql.parser import parse_sql as j_parse_sql
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpch
from cloudberry_tpu_torch.plan import mutate as M
from cloudberry_tpu_torch.plan import verify as V
from cloudberry_tpu_torch.plan.planner import plan_statement
from cloudberry_tpu_torch.sql.parser import parse_sql
from tools.tpchgen import load_tpch
from torch_parity import assert_same, carry_tables

SF, SEED = 0.01, 7
TWO_LEVEL = {"hier-wrong-host-grouping", "hier-inter-buffer-undersize",
             "hier-combine-forged"}


def _pair(nseg, **over):
    cfg = {"n_segments": nseg, **over}
    js = cb.Session(cb.get_config().with_overrides(**cfg))
    load_tpch(js, sf=SF, seed=SEED)
    ts = TorchSession(TorchConfig().with_overrides(**cfg), device="cpu")
    carry_tables(js, ts)
    return js, ts


@pytest.fixture(scope="module")
def dist():
    return _pair(8)


@pytest.fixture(scope="module")
def single():
    return _pair(1)


def _jplan(s, sql):
    return j_plan_statement(j_parse_sql(sql), s, {}).plan


def _tplan(s, sql):
    return plan_statement(parse_sql(sql), s, {}).plan


def _rp(findings):
    return [(f.rule, f.path) for f in findings]


# ------------------------------------------------- clean-plan baseline


@pytest.mark.parametrize("qname", sorted(tpch.QUERIES))
def test_tpch_plans_verify_clean(dist, single, qname):
    sql = tpch.QUERIES[qname]
    for js, ts in (dist, single):
        jstats = JV.verify_stats(_jplan(js, sql), js)
        tstats = V.verify_stats(_tplan(ts, sql), ts)
        assert tstats["findings"] == [], tstats["findings"]
        assert tstats == jstats


def test_rule_table_covers_walked_nodes(dist):
    js, ts = dist
    stats = V.verify_stats(_tplan(ts, tpch.QUERIES["q3"]), ts)
    assert stats["findings"] == [] and stats["nodes"] > 10
    for want in ("PScan", "PJoin", "PMotion", "PAgg", "PSort",
                 "PLimit", "PFilter", "PProject"):
        assert want in stats["rules_hit"], stats["rules_hit"]
    assert set(V.RULES) == set(JV.RULES)
    assert {k: r.doc for k, r in V.RULES.items()} == \
        {k: r.doc for k, r in JV.RULES.items()}


# ------------------------------------------- seeded mutation fuzzing


@pytest.mark.parametrize("mutation", sorted(M.MUTATIONS))
def test_mutation_caught_like_jax(dist, mutation):
    js, ts = dist
    sql, fn, expected = M.MUTATIONS[mutation]
    jsql, jfn, jexpected = JM.MUTATIONS[mutation]
    assert (sql, expected) == (jsql, jexpected)
    out = {}
    for s, planf, mfn, verify in ((js, _jplan, jfn, JV.verify_plan),
                                  (ts, _tplan, fn, V.verify_plan)):
        plan = planf(s, sql)
        assert verify(plan, s) == [], "fixture query dirty before mutation"
        hit = mfn(plan, s)
        assert hit is not None, f"{mutation!r} found no target"
        mutated, desc = hit
        out[s] = (desc, verify(mutated, s))
    (jdesc, jfind), (tdesc, tfind) = out[js], out[ts]
    assert tdesc == jdesc
    hit = [f for f in tfind if f.rule in expected]
    assert hit, (mutation, [f.render() for f in tfind])
    for f in hit:
        assert f.path and f.path[0].isupper(), f.render()
        assert f.render().startswith(f"{f.path}: {f.rule}: ")
    # the same rule ids at the same node paths as the JAX package's
    assert _rp(tfind) == _rp(jfind)


def test_mutation_corpus_size():
    """24 of the JAX package's 27 classes: the three two-level classes
    have no rule in the port."""
    assert len(M.MUTATIONS) >= 15
    assert set(JM.MUTATIONS) - set(M.MUTATIONS) == TWO_LEVEL
    assert len(M.MUTATIONS) == len(JM.MUTATIONS) - len(TWO_LEVEL) == 24
    assert not set(M.MUTATIONS) - set(JM.MUTATIONS)


# --------------------------------------------------- the session gate


def test_gate_clean_statement_bit_identical(dist):
    js, base = dist
    gated = TorchSession(TorchConfig().with_overrides(
        n_segments=8, **{"debug.verify_plans": True}), device="cpu")
    carry_tables(js, gated)
    for qname in ("q3", "q6"):
        a, b = base.sql(tpch.QUERIES[qname]), gated.sql(tpch.QUERIES[qname])
        for f in a.schema.fields:
            assert np.array_equal(np.asarray(a.columns[f.name]),
                                  np.asarray(b.columns[f.name])), f.name
        assert_same(b, js.sql(tpch.QUERIES[qname]))


def test_gate_raises_on_corrupt_plan(dist):
    js, ts = dist
    sql, fn, expected = M.MUTATIONS["drop-motion-under-join"]
    mutated, _ = fn(_tplan(ts, sql), ts)
    with pytest.raises(V.PlanVerifyError) as ei:
        V.check_plan(mutated, ts, "test")
    assert any(f.rule in expected for f in ei.value.findings)
    assert "Join" in str(ei.value) and "(test)" in str(ei.value)


def test_statement_gate_refuses_a_corrupt_plan(dist, monkeypatch):
    """With the gate on, the statement path verifies the plan before it
    runs: a planner bug (here a spliced motion) raises PlanVerifyError
    instead of a silently wrong answer. Off, nothing is checked."""
    from cloudberry_tpu_torch.plan import planner as P

    js, _ = dist
    sql, fn, _ = M.MUTATIONS["drop-motion-under-join"]
    real = P.plan_statement

    def corrupt(stmt, session, params, **kw):
        res = real(stmt, session, params, **kw)
        res.plan = fn(res.plan, session)[0]
        return res

    monkeypatch.setattr(P, "plan_statement", corrupt)
    gated = TorchSession(TorchConfig().with_overrides(
        n_segments=8, **{"debug.verify_plans": True}), device="cpu")
    carry_tables(js, gated)
    with pytest.raises(V.PlanVerifyError, match="join-not-colocated"):
        gated.sql(sql)
    with pytest.raises(V.PlanVerifyError, match="explain"):
        gated.explain(sql)


def test_gate_defaults_off_as_in_jax():
    assert TorchConfig().debug.verify_plans is False
    assert cb.get_config().debug.verify_plans is False
    on = TorchConfig().with_overrides(**{"debug.verify_plans": True})
    assert on.debug.verify_plans is True


def test_replan_owes_one_verification(dist, monkeypatch):
    """After a mid-statement replan the next plan is verified once even
    with the gate off (``_verify_next_plans``), as in the JAX package."""
    _, ts = dist
    calls = []
    monkeypatch.setattr(V, "check_plan",
                        lambda plan, s, ctx, **kw: calls.append(ctx))
    plan = _tplan(ts, tpch.QUERIES["q6"])
    ts._verify_plan(plan, "session")
    assert calls == []
    ts._verify_next_plans = 1
    ts._verify_plan(plan, "session")
    ts._verify_plan(plan, "session")
    assert calls == ["session"] and ts._verify_next_plans == 0


def test_greedy_replan_is_verified(dist, monkeypatch):
    """The greedy re-plan of a refused plan passes the gate under its own
    context name."""
    from cloudberry_tpu_torch.exec import tiled as TT

    js, _ = dist
    ts = TorchSession(TorchConfig().with_overrides(n_segments=8, **{
        "debug.verify_plans": True, "planner.enable_memo": True,
        "resource.query_mem_bytes": 768 << 10}), device="cpu")
    carry_tables(js, ts)
    contexts = []
    real_check = V.check_plan

    def spy(plan, session, context="", **kw):
        contexts.append(context)
        return real_check(plan, session, context, **kw)

    monkeypatch.setattr(V, "check_plan", spy)
    real = TT.plan_tiled
    seen = []

    def first_declines(plan, session):
        seen.append(1)
        return None if len(seen) == 1 else real(plan, session)

    monkeypatch.setattr(TT, "plan_tiled", first_declines)
    ts.sql(tpch.QUERIES["q5"])
    assert contexts[:2] == ["session", "greedy-replan"], contexts
    assert ts.last_tiled_report["distributed"]


# ------------------------------------------------ paramplan slot gate


def test_param_slots_verify_against_signature(dist):
    from cloudberry_tpu_torch.sched import paramplan
    from cloudberry_tpu_torch.types import BOOL

    _, ts = dist
    plan = _tplan(ts, "select l_orderkey from lineitem where l_quantity > 17")
    sig, bindings, keyed, slots = paramplan.analyze(ts, plan, rewrite=True)
    assert slots
    assert V.verify_plan(plan, ts, declared_slots=list(slots)) == []
    bad = V.verify_plan(plan, ts, declared_slots=[])
    assert any(f.rule == "param-slot-desync" for f in bad)
    bad = V.verify_plan(plan, ts, declared_slots=[BOOL] * len(slots))
    assert any(f.rule == "param-slot-desync" for f in bad)


def test_nrw_slots_verify_against_signature(dist):
    from cloudberry_tpu_torch.plan import nodes as N
    from cloudberry_tpu_torch.sched import paramplan

    _, ts = dist
    plan = _tplan(ts, "select count(*) as n from lineitem, orders "
                      "where l_orderkey = o_orderkey")
    sig, bindings, keyed, slots = paramplan.analyze(ts, plan, rewrite=True)
    nrw = sum(1 for k in bindings if k.startswith("$nrw"))
    assert nrw >= 2, bindings.keys()
    assert V.verify_plan(plan, ts, declared_slots=list(slots),
                         declared_nrw=nrw) == []
    bad = V.verify_plan(plan, ts, declared_nrw=nrw + 1)
    assert any(f.rule == "param-slot-desync" and "$nrw" in f.message
               for f in bad)
    scans = [n for n, _ in V._walk_paths(plan) if isinstance(n, N.PScan)
             and getattr(n, "_nrows_key", None)]
    scans[1]._nrows_key = scans[0]._nrows_key
    bad = V.verify_plan(plan, ts, declared_nrw=nrw)
    assert any(f.rule == "param-slot-desync" and "stamped on" in f.message
               for f in bad)


def test_generic_plan_build_runs_gate(monkeypatch):
    """The GenericPlan constructor verifies the rewritten ($params) form
    with its declared slots when the gate is on — and the statement still
    executes, equal to the JAX package's."""
    js, ts = _pair(1, **{"debug.verify_plans": True,
                         "sched.generic_plans": True})
    calls = []
    real = V.check_plan

    def spy(plan, session, context="", **kw):
        calls.append((context, kw.get("declared_slots") is not None))
        return real(plan, session, context, **kw)

    monkeypatch.setattr(V, "check_plan", spy)
    q = "select count(*) as n from lineitem where l_quantity > 17"
    a = ts.sql(q)
    b = ts.sql(q.replace("17", "18"))
    assert_same(a, js.sql(q))
    assert_same(b, js.sql(q.replace("17", "18")))
    na, nb = (int(np.asarray(x.columns["n"])[0]) for x in (a, b))
    assert na > nb > 0
    assert ("paramplan", True) in calls


# ------------------------------------------------- explain annotation


def test_explain_dist_annotation(dist, single):
    _, ts = dist
    txt = ts.explain(tpch.QUERIES["q3"])
    assert "dist:hashed(" in txt and "dist:singleton" in txt
    assert "dist:replicated" in txt
    for line in txt.splitlines():
        if "-> " in line:
            assert "dist:" in line, line
    assert "dist:" not in single[1].explain(tpch.QUERIES["q3"])
    assert txt == dist[0].explain(tpch.QUERIES["q3"])


def test_explain_dist_matches_stamp(dist):
    _, ts = dist
    txt = ts.explain(tpch.QUERIES["q10"])
    for line in txt.splitlines():
        if "[" in line and "dist:" in line:
            head = line.split("dist:", 1)[0]
            stamped = head.rsplit("[", 1)[1].split("]", 1)[0]
            derived = line.split("dist:", 1)[1].strip()
            assert stamped == derived, line


# ------------------------------------------------- contract registries


def test_recovery_mode_drift_is_a_finding(dist, monkeypatch):
    import cloudberry_tpu.exec.recovery as JR
    import cloudberry_tpu_torch.exec.recovery as R

    js, ts = dist
    for mod in (R, JR):
        monkeypatch.setattr(mod, "REPLACEABLE",
                            {k: v for k, v in mod.REPLACEABLE.items()
                             if k != "topn"})
    tf = V.verify_plan(_tplan(ts, tpch.QUERIES["q6"]), ts)
    jf = JV.verify_plan(_jplan(js, tpch.QUERIES["q6"]), js)
    assert any(f.rule == "recovery-mode-unreplaceable" for f in tf)
    assert [f.render() for f in tf] == [f.render() for f in jf]


def test_unruled_node_class_is_a_finding(dist):
    from cloudberry_tpu_torch.plan import nodes as N

    _, ts = dist

    class PRogue(N.PlanNode):
        pass

    rogue = PRogue()
    rogue.fields = []
    plan = _tplan(ts, tpch.QUERIES["q6"])
    rogue.children = lambda: [plan]
    findings = V.verify_plan(rogue, ts)
    assert any(f.rule == "planprops-unruled" for f in findings)


def test_verify_corpus_smoke(dist):
    """A verification sweep over TPC-H texts (the JAX package's
    ``verify_corpus`` currency): plans, nodes, rules hit, no finding —
    equal in both engines."""
    js, ts = dist
    rec = []
    for s, planf, Ver in ((js, _jplan, JV.Verifier),
                          (ts, _tplan, V.Verifier)):
        nodes, rules, findings = 0, set(), []
        for q in ("q3", "q6"):
            plan = planf(s, tpch.QUERIES[q])
            v = Ver(s, plan)
            findings += v.verify(plan)
            nodes += v.nodes_checked
            rules |= v.rules_hit
        rec.append((nodes, sorted(rules), findings))
    assert rec[1] == rec[0] and rec[1][2] == []
    assert rec[1][0] > 10 and "PMotion" in rec[1][1]


def test_verifier_local_mode_skips_distribution(single):
    from cloudberry_tpu_torch.plan import nodes as N

    _, ts = single
    plan = _tplan(ts, tpch.QUERIES["q1"])
    v = V.Verifier(ts, plan)
    assert v.local and v.verify(plan) == []

    def scans(p):
        if isinstance(p, N.PScan):
            yield p
        for c in p.children():
            yield from scans(c)
    sc = next(scans(plan))
    sc.num_rows = sc.capacity + 1
    assert any(f.rule == "scan-rows" for f in V.verify_plan(plan, ts))


@pytest.mark.parametrize("mutation", sorted(TWO_LEVEL))
def test_two_level_stamps_have_no_rule_in_the_port(dist, mutation):
    """The JAX package's two-level (hierarchical) motion checks are not
    carried (the port's distributor stamps no two-level motion): its
    mutation classes, applied to the port's plan, draw no finding, where
    the JAX package's verifier catches them on its own plan."""
    from cloudberry_tpu.exec.executor import all_nodes as j_all_nodes
    from cloudberry_tpu.plan import nodes as JN
    from cloudberry_tpu_torch.exec.executor import all_nodes
    from cloudberry_tpu_torch.plan import nodes as TN

    js, ts = dist
    sql, jfn, expected = JM.MUTATIONS[mutation]
    jplan, _ = jfn(_jplan(js, sql), js)
    assert any(f.rule in expected for f in JV.verify_plan(jplan, js))
    # the same stamps on the port plan's redistributes, motion for motion
    fields = ("hier_hosts", "host_bucket_cap", "host_combine",
              "combine_spec")
    jm = [n for n in j_all_nodes(jplan)
          if isinstance(n, JN.PMotion) and n.kind == "redistribute"]
    tplan = _tplan(ts, sql)
    tm = [n for n in all_nodes(tplan)
          if isinstance(n, TN.PMotion) and n.kind == "redistribute"]
    assert len(jm) == len(tm) > 0
    stamped = 0
    for a, b in zip(jm, tm):
        for f in fields:
            setattr(b, f, getattr(a, f))
        stamped += bool(a.hier_hosts)
    assert stamped
    assert V.verify_plan(tplan, ts) == []
