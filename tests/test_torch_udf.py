"""Scalar UDFs (exec/udf.py) and table functions (exec/tablefunc.py) of the
port against the JAX package, on the CPU.

The three shapes a scalar UDF binds to — the bind-time constant fold, the
dictionary rewrite over one string column, and a per-row function
(``jit=True``: a JAX function in the JAX package's registry, a torch
function over the argument tensors in the port's) — volatile functions,
and the UDF registry's version in the statement cache's and the generic
plans' validity keys. Table functions: ``generate_series`` and a
registered function, each a transient replicated table refreshed at every
referencing statement, and the bypass of both caches for statements over
their rows (``Session._any_external``). Every result equals the JAX
package's (``torch_parity.Pair``: exact but for floats, which stay within
the suite's stated tolerance).
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu import types as JT
from cloudberry_tpu.exec import tablefunc as jtf
from cloudberry_tpu.exec import udf as judf
from cloudberry_tpu.plan.binder import BindError as JBindError
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import types as TT
from cloudberry_tpu_torch.exec import tablefunc as ttf
from cloudberry_tpu_torch.exec import udf as tudf
from cloudberry_tpu_torch.plan.binder import BindError as TBindError
from torch_parity import Pair

# the port with generic plans on, the JAX package's default (the port's is
# off), so both caches' validity keys are exercised
ON = TorchConfig().with_overrides(**{"sched.generic_plans": True})

# name -> (python function, argument types, return type, options): the
# same callable registers in both engines (the jit ones take tensors of
# their engine: jax arrays there, torch tensors here — both spell x * 2)
HOST = {
    "t_initials": (lambda s: "".join(w[0].upper() for w in s.split()),
                   ("STRING",), "STRING", {}),
    "t_name_len": (lambda s: len(s), ("STRING",), "INT64", {}),
    "t_const_ans": (lambda: 42, (), "INT64", {}),
    "t_odd_null": (lambda s: None if len(s) % 2 else s.upper(),
                   ("STRING",), "STRING", {}),
    "t_suffixed": (lambda s, suf: s + suf, ("STRING", "STRING"),
                   "STRING", {}),
    "t_double_it": (lambda x: x * 2, ("INT64",), "INT64", {"jit": True}),
    "t_taxed": (lambda x, r: x * (1.0 + r), ("FLOAT64", "FLOAT64"),
                "FLOAT64", {"jit": True}),
    "t_bumped": (lambda x: x + 1, ("INT64",), "INT64",
                 {"jit": True, "volatility": "volatile"}),
    "t_vconst": (lambda: 7, (), "INT64", {"volatility": "volatile"}),
}


def _register(name, fn, args, ret, opts):
    judf.register_function(name, fn, [getattr(JT, a) for a in args],
                           getattr(JT, ret), **opts)
    tudf.register_function(name, fn, [getattr(TT, a) for a in args],
                           getattr(TT, ret), **opts)


def _unregister(name):
    judf.unregister_function(name)
    tudf.unregister_function(name)


@pytest.fixture(scope="module", autouse=True)
def _funcs():
    for name, spec in HOST.items():
        _register(name, *spec)
    yield
    for name in HOST:
        _unregister(name)


@pytest.fixture
def pair():
    p = Pair(cb.get_config().with_overrides(n_segments=1), ON)
    p.sql("create table p (k bigint, name text, sal double) "
          "distributed by (k)")
    p.sql("insert into p values (1, 'ada lovelace', 100.0), "
          "(2, 'alan turing', 200.0), (3, 'grace hopper', 300.0), "
          "(4, null, 400.0)")
    return p


def test_constant_fold(pair):
    got, _ = pair.sql("select t_const_ans() as c, t_name_len('abc') as n, "
                      "t_initials('alan mathison turing') as i")
    df = got.to_pandas()
    assert (df["c"][0], df["n"][0], df["i"][0]) == (42, 3, "AMT")


def test_dictionary_rewrite(pair):
    got, _ = pair.sql("select k, t_initials(name) as ini, "
                      "t_name_len(name) as nl from p order by k")
    assert got.to_pandas()["ini"].tolist()[:3] == ["AL", "AT", "GH"]
    pair.sql("select k from p where t_initials(name) = 'AL'")
    pair.sql("select t_name_len(name) as nl, count(*) as n from p "
             "where name is not null group by t_name_len(name) order by nl")
    pair.sql("select k, t_odd_null(name) as o from p order by k")
    pair.sql("select t_suffixed(name, '!') as x from p where k = 2")
    pair.sql("select t_name_len(null) as n from p limit 1")


def test_tensor_udf_runs_in_the_lowering(pair):
    got, _ = pair.sql("select k, t_double_it(k) as dk, "
                      "t_taxed(sal, 0.1) as tx from p order by k")
    assert got.to_pandas()["dk"].tolist() == [2, 4, 6, 8]
    pair.sql("select k from p where t_double_it(k) > 4 order by k")
    # inside an aggregate, a grouped sum of the function's values
    pair.sql("select name is null as nn, sum(t_double_it(k)) as s, "
             "count(*) as c from p group by name is null order by nn")


def test_volatile_functions(pair):
    # volatile: no fold and no dictionary rewrite; a tensor function still
    # runs per row
    pair.sql("select k, t_bumped(k) as b from p order by k")
    for s, err in ((pair.js, JBindError), (pair.ts, TBindError)):
        with pytest.raises(err, match="does not compile"):
            s.sql("select t_vconst() as v")


def test_errors(pair):
    for s, err in ((pair.js, JBindError), (pair.ts, TBindError)):
        with pytest.raises(err, match="argument"):
            s.sql("select t_name_len() from p")
        with pytest.raises(err, match="unknown function"):
            s.sql("select t_nope(k) from p")
        with pytest.raises(err, match="expected a string argument"):
            s.sql("select t_name_len(k) from p")
    assert "t_initials" in tudf.known_functions()


def test_reregistration_invalidates_cached_and_generic_plans(pair):
    """Re-registering a function (CREATE OR REPLACE) bumps the registry
    version: a cached runner and a generic plan that baked the old
    function must not serve."""
    ts = pair.ts
    _register("t_twist", lambda x: x + 1, ("INT64",), "INT64",
              {"jit": True})
    try:
        q = "select t_twist(k) as t from p where k > {} order by k"
        got, _ = pair.sql(q.format(0))
        assert got.to_pandas()["t"].tolist() == [2, 3, 4, 5]
        hits = ts.counters.counter("stmt_cache_hits")
        pair.sql(q.format(0))
        assert ts.counters.counter("stmt_cache_hits") == hits + 1
        g = ts.counters.counter("generic_hits")
        pair.sql(q.format(1))
        assert ts.counters.counter("generic_hits") == g + 1
        v = tudf.registry_version()
        _register("t_twist", lambda x: x * 10, ("INT64",), "INT64",
                  {"jit": True})
        assert tudf.registry_version() == v + 1
        b = ts.counters.counter("generic_builds")
        got, _ = pair.sql(q.format(0))
        assert got.to_pandas()["t"].tolist() == [10, 20, 30, 40]
        # neither the cached runner nor the old generic plan served
        assert ts.counters.counter("stmt_cache_hits") == hits + 1
        assert ts.counters.counter("generic_hits") == g + 1
        assert ts.counters.counter("generic_builds") == b + 1
        got, _ = pair.sql(q.format(2))
        assert got.to_pandas()["t"].tolist() == [30, 40]
        assert ts.counters.counter("generic_hits") == g + 2
    finally:
        _unregister("t_twist")


# ------------------------------------------------------ table functions


def test_generate_series(pair):
    got, _ = pair.sql("select * from generate_series(1, 5)")
    assert got.to_pandas().iloc[:, 0].tolist() == [1, 2, 3, 4, 5]
    pair.sql("select * from generate_series(0, 10, 3)")
    pair.sql("select * from generate_series(5, 1, -2)")
    pair.sql("select * from generate_series(5, 1)")
    pair.sql("select * from generate_series(null, 3)")
    pair.sql("select sum(g.generate_series) as t, count(*) as c "
             "from generate_series(1, 100) g")
    pair.sql("select k from p join generate_series(2, 3) gs "
             "on k = gs.generate_series order by k")
    pair.sql("select k from p where k in (select generate_series from "
             "generate_series(1, 2)) order by k")
    for s, err in ((pair.js, JBindError), (pair.ts, TBindError)):
        with pytest.raises(err, match="integer arguments"):
            s.sql("select * from generate_series(1.5, 3.5)")
        with pytest.raises(err, match="step must not be zero"):
            s.sql("select * from generate_series(1, 5, 0)")
        with pytest.raises(err, match="unknown table function"):
            s.sql("select * from t_no_such_fn(1)")
        with pytest.raises(err, match="must be constants"):
            s.sql("select * from generate_series(1, (select 3))")


def test_registered_table_function():
    def colors(n):
        names = np.asarray(["red", "green", "blue"], dtype=object)
        idx = np.arange(int(n)) % 3
        return {"cid": np.arange(int(n), dtype=np.int64),
                "cname": names[idx], "w": np.linspace(0.0, 1.0, int(n))}

    jtf.register_table_function("t_colors", colors)
    ttf.register_table_function("t_colors", colors)
    p = Pair(cb.get_config().with_overrides(n_segments=1), ON)
    got, _ = p.sql("select cid, cname, w from t_colors(4) order by cid")
    assert got.to_pandas()["cname"].tolist() == \
        ["red", "green", "blue", "red"]
    p.sql("select count(*) as c from t_colors(9) where cname = 'blue'")


def test_function_rows_bypass_both_caches():
    """A table function re-runs at every referencing statement (its rows
    may change between calls), so a statement over its rows is never a
    statement-cache hit and never builds or hits a generic plan."""
    calls = {"n": 0}

    def ticker():
        calls["n"] += 1
        return {"tick": np.arange(calls["n"], dtype=np.int64)}

    p = Pair(cb.get_config().with_overrides(n_segments=1), ON)
    ts = p.ts
    jtf.register_table_function("t_ticker", ticker)
    ttf.register_table_function("t_ticker", lambda: {
        "tick": np.arange(calls["n"], dtype=np.int64)})
    p.sql("create table ft (a bigint)")
    p.sql("insert into ft values (0), (1), (2), (3)")
    q = "select count(*) as c from ft join t_ticker() t on a = t.tick " \
        "where a >= {}"
    for i in range(3):
        got, _ = p.sql(q.format(0))
        assert got.to_pandas()["c"][0] == i + 1
    got, _ = p.sql(q.format(1))
    assert got.to_pandas()["c"][0] == 3
    c = ts.counters.snapshot()
    assert c.get("stmt_cache_hits", 0) == 0
    assert c.get("generic_hits", 0) == c.get("generic_builds", 0) == 0
    assert not ts._stmt_cache and not ts._generic_cache
    assert ts._any_external([n for n in ts.catalog.tables
                             if n.startswith("$tf_t_ticker")])
    # a generate_series join re-materializes at every statement too
    gs = "select count(*) as c from ft join generate_series(1, 2) g " \
         "on a = g.generate_series"
    v0 = None
    for _ in range(2):
        p.sql(gs)
        (name,) = [n for n in ts.catalog.tables
                   if n.startswith("$tf_generate_series")]
        v = ts.catalog.table(name)._version
        assert v != v0
        v0 = v
    assert not any("generate_series" in k for k in ts._stmt_cache)
