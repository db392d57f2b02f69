"""Admission (exec/resource.py) and the tiling decision (exec/tiled.py) of
the port against the JAX package, planning only, at the card's own sizes.

Every statement the card runs — the 22 TPC-H texts at SF1, the 30 TPC-DS
texts, ``tpcds.WINDOW_QUERY`` and the three tiling-phase texts (WIN_DS,
SORT_DS, TOPN_DS) at tpcds-lite scale 100 — is planned by both engines
on the same encoded tables. Under budgets of 128 MiB, 256 MiB, 512 MiB
and 4 GiB, the port's ``estimate_plan_memory`` must equal the JAX
package's integer for integer, and its decision (admit, tile or decline)
with the tile rows, mode, accumulator capacity and step estimate must
equal the JAX package's. Nothing executes there. Smaller cases run:
the skew join's admission after growth, the growth loop's fallback to
tiling, the ``_min_out_cap`` floor through ``_retile``, point lookups
unbound for tiling, and the statement scope.
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.exec import executor as JX
from cloudberry_tpu.exec import resource as JR
from cloudberry_tpu.exec import tiled as JT
from cloudberry_tpu.plan.planner import plan_statement as jplan
from cloudberry_tpu.sql.parser import parse_sql as jparse
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import lifecycle
from cloudberry_tpu_torch import tpcds as TD
from cloudberry_tpu_torch.exec import executor as X
from cloudberry_tpu_torch.exec import resource as R
from cloudberry_tpu_torch.exec import tiled as T
from cloudberry_tpu_torch.plan.planner import plan_statement as tplan
from cloudberry_tpu_torch.sql.parser import parse_sql as tparse
from cloudberry_tpu_torch.utils import faultinject as FI
from torch_parity import assert_same, budget_pair, carry_tables

BUDGETS = (128 << 20, 256 << 20, 512 << 20, 4 << 30)

SORT_DS = ("SELECT ss_ticket_number, ss_item_sk, ss_net_profit FROM "
           "store_sales JOIN date_dim ON ss_sold_date_sk = d_date_sk "
           "WHERE d_year = 2000 ORDER BY ss_net_profit DESC, "
           "ss_ticket_number, ss_item_sk")
DS_TEXTS = dict(TD.QUERIES)
DS_TEXTS["window"] = TD.WINDOW_QUERY.format(where="d_year >= 1998")
DS_TEXTS["win_ds"] = (
    "SELECT ss_store_sk, ss_ticket_number, ss_quantity, rank() over "
    "(partition by ss_store_sk order by ss_quantity desc) AS r, "
    "sum(ss_net_profit) over (partition by ss_store_sk) AS sp, "
    "avg(ss_ext_sales_price) over (partition by ss_store_sk order by "
    "ss_ticket_number rows between 2 preceding and current row) AS aw "
    "FROM store_sales JOIN date_dim ON ss_sold_date_sk = d_date_sk "
    "WHERE d_year = 2000")
DS_TEXTS["sort_ds"] = SORT_DS
DS_TEXTS["topn_ds"] = SORT_DS + " LIMIT 100"
# at the default 4 GiB budget, exactly these refuse (their plans cannot
# stream) in both engines; every other statement of the card is admitted
DEFAULT_REFUSED = {"q27", "q59", "q74", "window"}


def _decision(session, plan_fn, est_fn, tile_fn, parse, sql, budget):
    """(estimate, decision...) of one statement at one budget, planning
    only: "admit", "decline", or the tiled report's mode, tile rows,
    accumulator capacity and step estimate."""
    plan = plan_fn(parse(sql), session, {}).plan
    est = est_fn(plan).peak_bytes
    if est <= budget:
        return (est, "admit")
    texe = tile_fn(plan, session)
    if texe is None:
        return (est, "decline")
    r = texe.report
    return (est, r.get("mode", "agg"), r["tile_rows"], r["acc_capacity"],
            r["est_step_bytes"])


def _both(js, ts, sql):
    """The two engines' decisions at every budget; asserted equal."""
    out = []
    jbase, tbase = js.config, ts.config
    try:
        for b in BUDGETS:
            js.config = jbase.with_overrides(
                **{"resource.query_mem_bytes": b})
            ts.config = tbase.with_overrides(
                **{"resource.query_mem_bytes": b})
            want = _decision(js, jplan, lambda p: JR.estimate_plan_memory(p),
                             JT.plan_tiled, jparse, sql, b)
            got = _decision(ts, tplan, R.estimate_plan_memory,
                            T.plan_tiled, tparse, sql, b)
            assert got == want, (b >> 20, got, want)
            out.append(got)
    finally:
        js.config, ts.config = jbase, tbase
    return out


def _sessions(load):
    js = cb.Session(cb.get_config().with_overrides(
        n_segments=1, **{"sched.generic_plans": False}))
    load(js)
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    return js, ts


TPCH_NAMES = [f"q{i}" for i in range(1, 23)]


class TestTpchSF1Planning:
    """TPC-H SF1 (seed 1, the card's data): 22 texts × 4 budgets."""

    @pytest.fixture(scope="class")
    def sf1(self):
        from tools.tpchgen import load_tpch

        return _sessions(lambda s: load_tpch(s, sf=1.0, seed=1))

    @pytest.mark.parametrize("qn", TPCH_NAMES)
    def test_estimate_and_decision(self, sf1, qn):
        from tools.tpch_queries import QUERIES

        js, ts = sf1
        got = _both(js, ts, QUERIES[qn])
        assert got[-1][1] == "admit"      # every TPC-H text fits 4 GiB
        if qn == "q1":     # the card phase's decisions (tiles of 12)
            assert got[0][1:4] == ("agg", 524_288, 8)
        if qn == "q3":
            assert [d[1] for d in got[:2]] == ["decline", "decline"]
            assert got[2][1:4] == ("agg", 524_288, 1_880_181)
        if qn == "q5":
            assert got[1][1:4] == ("agg", 524_288, 25)
        if qn == "q18":
            assert [d[1] for d in got[:3]] == ["decline"] * 3


class TestTpcdsScale100Planning:
    """tpcds-lite scale 100 (seed 0, the card's data): 34 texts × 4
    budgets; at 4 GiB exactly ``DEFAULT_REFUSED`` raise in both engines."""

    @pytest.fixture(scope="class")
    def ds100(self):
        from tools.tpcdsgen import load_tpcds

        return _sessions(lambda s: load_tpcds(s, scale=100, seed=0))

    @pytest.mark.parametrize("qn", sorted(DS_TEXTS))
    def test_estimate_and_decision(self, ds100, qn):
        js, ts = ds100
        got = _both(js, ts, DS_TEXTS[qn])
        assert (got[-1][1] == "decline") is (qn in DEFAULT_REFUSED)
        assert got[-1][1] in ("admit", "decline")
        small = {"win_ds": ("window", 262_144, 0),
                 "sort_ds": ("sort", 524_288, 0),
                 "topn_ds": ("topn", 524_288, 100)}
        if qn in small:    # the card phase's decisions at 128 MiB
            assert got[0][1:4] == small[qn]

    @pytest.mark.parametrize("qn", sorted(DEFAULT_REFUSED))
    def test_default_budget_refuses(self, ds100, qn):
        from cloudberry_tpu.exec.resource import ResourceError as JaxRE

        js, ts = ds100
        with pytest.raises(JaxRE, match="memory estimate"):
            js.sql(DS_TEXTS[qn])
        with pytest.raises(R.ResourceError, match="memory estimate"):
            ts.sql(DS_TEXTS[qn])


# ------------------------------------------------------------ growth


def _skew(n):
    """The card's skew join at ``n`` probe rows: 25 % on key 0, which the
    build holds 12 times."""
    rng = np.random.default_rng(13)
    pk = np.where(rng.random(n) < 0.25, 0,
                  rng.integers(1, n // 10, n)).astype(np.int64)
    pv = rng.integers(0, 1000, n).astype(np.int64)
    bk = np.concatenate([np.zeros(12, dtype=np.int64),
                         np.arange(1, n // 10, dtype=np.int64)])
    bv = np.arange(len(bk), dtype=np.int64)

    def load(s):
        s.sql("CREATE TABLE f (k BIGINT, v BIGINT)")
        s.sql("CREATE TABLE d (k BIGINT, w BIGINT)")
        s.catalog.table("f").set_data({"k": pk, "v": pv})
        s.catalog.table("d").set_data({"k": bk, "w": bv})
    return load


SKEW_Q = ("select count(*) as c, sum(f.v + d.w) as s "
          "from f join d on f.k = d.k")


def test_skew_join_admission_after_growth():
    """The card's phase-6 skew join (1,200,000 probe rows), planning only:
    the estimate before and after one growth of the pair buffer, and the
    admission decision at the default budget, equal in both engines."""
    js, ts = budget_pair(_skew(1_200_000))
    jp = jplan(jparse(SKEW_Q), js, {}).plan
    tp = tplan(tparse(SKEW_Q), ts, {}).plan
    assert R.estimate_plan_memory(tp).peak_bytes == \
        JR.estimate_plan_memory(jp).peak_bytes
    assert JX.grow_expansion(jp, "expansion overflow", allow_fallback=True)
    assert X.grow_expansion(tp, "expansion overflow", allow_fallback=True)
    est = R.check_admission(tp, ts).peak_bytes
    assert est == JR.check_admission(jp, js).peak_bytes
    assert est <= 4 << 30


def test_growth_falls_back_to_tiling():
    """A plan admitted at first whose join grows past the budget is tiled,
    in both engines alike, with an equal result."""
    n = 120_000
    js0, ts0 = budget_pair(_skew(n))
    plan = tplan(tparse(SKEW_Q), ts0, {}).plan
    budget = R.estimate_plan_memory(plan).peak_bytes + 1
    js, ts = budget_pair(_skew(n), budget)
    got = ts.sql(SKEW_Q)
    assert_same(got, js.sql(SKEW_Q))
    assert_same(got, ts0.sql(SKEW_Q))
    assert ts.growth_events == js.growth_events == 1
    tr, jr = ts.last_tiled_report, js.last_tiled_report
    for k in ("tile_rows", "n_tiles", "est_step_bytes"):
        assert tr[k] == jr[k], k
    assert tr["n_tiles"] > 1


def test_min_out_cap_survives_retile():
    """A grown expansion join keeps its grown pair buffer as a floor when
    the tiled planner re-derives capacities per tile (``_retile``), in
    both engines alike."""
    def load(s):
        rng = np.random.default_rng(5)
        s.sql("CREATE TABLE dup (k BIGINT, g BIGINT)")
        s.sql("CREATE TABLE fact (k BIGINT, v BIGINT)")
        keys = np.repeat(np.arange(100), 20)
        s.catalog.table("dup").set_data({"k": keys, "g": keys % 7})
        s.catalog.table("fact").set_data(
            {"k": rng.integers(0, 100, 150_000),
             "v": rng.integers(0, 50, 150_000)})

    q = ("SELECT g, v FROM fact JOIN dup ON fact.k = dup.k "
         "ORDER BY g, v LIMIT 10")
    js, ts = budget_pair(load)
    caps = []
    for plan_fn, parse, grow, mod in (
            (jplan, jparse, JX.grow_expansion, JT),
            (tplan, tparse, X.grow_expansion, T)):
        sess = js if mod is JT else ts
        plan = plan_fn(parse(q), sess, {}).plan
        for _ in range(3):
            assert grow(plan, "expansion overflow", allow_fallback=True)
        shape = mod._analyze(plan)
        join = next(n for n in shape.spine if hasattr(n, "_min_out_cap"))
        floor = join._min_out_cap
        assert floor == join.out_capacity
        mod._retile(shape, 4096)
        assert join.out_capacity == floor      # never shrunk back
        mod._retile(shape, 1 << 22)
        caps.append((floor, join.out_capacity))
    assert caps[0] == caps[1]


def test_point_lookups_unbound_for_tiling():
    """A point-bound scan returns to a full scan before tiling (the tile
    stream and resident inputs key by table name), as in the reference."""
    from cloudberry_tpu.plan.pointlookup import unbind_point_lookups as ju
    from cloudberry_tpu_torch.plan.pointlookup import unbind_point_lookups

    def load(s):
        s.sql("CREATE TABLE big (k BIGINT, v BIGINT)")
        s.catalog.table("big").set_data(
            {"k": np.arange(200_000), "v": np.arange(200_000) % 7})

    q = "SELECT k, v FROM big WHERE k = 4242"
    js, ts = budget_pair(load)
    out = []
    for plan_fn, parse, unbind, scans, sess in (
            (jplan, jparse, ju, JX.scans_of, js),
            (tplan, tparse, unbind_point_lookups, X.scans_of, ts)):
        plan = plan_fn(parse(q), sess, {}).plan
        scan = next(iter(scans(plan)))
        assert hasattr(scan, "_point_rows") and scan.capacity == 1
        unbind(plan)
        assert not hasattr(scan, "_point_rows")
        assert not hasattr(scan, "_input_key")
        out.append((scan.capacity, scan.num_rows))
    assert out[0] == out[1] == (200_000, 200_000)


# ---------------------------------------------------- admission basics


def test_admission_seam_and_message():
    def load(s):
        s.sql("CREATE TABLE t (k BIGINT)")
        s.catalog.table("t").set_data({"k": np.arange(1000)})

    js, ts = budget_pair(load, 1 << 10,
                         **{"resource.enable_spill": False})
    with pytest.raises(R.ResourceError, match="exceeds the per-query"):
        ts.sql("SELECT k FROM t ORDER BY k")
    FI.inject_fault("admission_check", "error")
    try:
        with pytest.raises(FI.InjectedFault):
            ts.sql("SELECT k FROM t")
    finally:
        FI.reset_fault()
    ts.config = TorchConfig()
    assert ts.sql("SELECT k FROM t").num_rows() == 1000


def test_statement_scope_and_cancel():
    """Each statement runs in a scope of its own id; its checkpoints are
    discarded at the end; ``check_cancel`` raises the token's reason."""
    assert lifecycle.current_handle() is None
    lifecycle.check_cancel()          # no-op outside a scope
    ts = TorchSession(device="cpu")
    ts.sql("CREATE TABLE t (k BIGINT)")
    seen = []
    real = ts._run_with_growth

    def spy(*a):
        h = lifecycle.current_handle()
        seen.append(h.statement_id)
        ts._recovery.note_progress(h.statement_id, 3)
        return real(*a)

    ts._run_with_growth = spy
    ts.sql("SELECT k FROM t")
    ts.sql("SELECT k FROM t WHERE k > 0")   # another text: not cached
    assert len(seen) == 2 and seen[1] > seen[0]
    # the scope's id is the statement log's id
    assert seen == [e["id"] for e in ts.stmt_log.recent(2)][::-1]
    assert ts._recovery.progress(seen[0]) == 0     # discarded
    assert lifecycle.current_handle() is None
    h = lifecycle.StatementHandle(7)
    with lifecycle.statement_scope(h):
        lifecycle.check_cancel()
        h.token.cancel("timeout", "too slow")
        with pytest.raises(lifecycle.StatementTimeout, match="too slow"):
            lifecycle.check_cancel()
    assert lifecycle.is_retryable(lifecycle.StatementTimeout("x"))
    assert not lifecycle.is_retryable(lifecycle.StatementCancelled("x"))
