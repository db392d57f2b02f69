"""Point lookups (plan/pointlookup.py) through the port against the JAX
package, on the CPU: WHERE col = const on a RAM table of at least
``MIN_ROWS`` rows narrows the scan to the sorted-sidecar-matched rows.
The narrowed scan's capacity and row count must equal the JAX plan's,
and the results must be equal (``assert_same``). The port gathers the
matched rows from the table's device copy; the rows and their order are
the reference's host slice.
"""

import numpy as np
import pytest
import torch

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import executor as X
from cloudberry_tpu_torch.plan.pointlookup import MIN_ROWS
from torch_parity import assert_same, carry_tables, plan_scans

N = 40_000


@pytest.fixture(scope="module")
def sessions():
    assert N >= MIN_ROWS
    js = cb.Session(cb.config.Config(n_segments=1).with_overrides(
        **{"sched.generic_plans": False}))
    rng = np.random.default_rng(0)
    js.sql("create table pts (k bigint, v bigint, d decimal(8,2), c text, "
           "n bigint)")
    from cloudberry_tpu.columnar.dictionary import StringDictionary

    d = StringDictionary()
    codes = np.asarray([d.add(f"s{i % 50}") for i in range(50)])
    n = rng.integers(0, 1000, N)
    js.catalog.table("pts").set_data({
        "k": rng.permutation(N).astype(np.int64),
        "v": rng.integers(0, 100, N),
        "d": rng.integers(0, 10**6, N),
        "c": codes[rng.integers(0, 50, N)].astype(np.int32),
        "n": n}, {"c": d}, validity={"n": rng.random(N) < 0.9})
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    return js, ts


@pytest.mark.parametrize("q", [
    "select k, v, d, c from pts where k = 12345",
    "select k, v from pts where k = 777 and v > 50",
    "select count(*) as n, sum(v) as sv from pts where c = 's7'",
    "select k, n from pts where n = 17 order by k",
    "select v from pts where k = 987654321",
])
def test_point_scans_match_jax(sessions, q):
    js, ts = sessions
    (jscan,), (tscan,) = plan_scans(js, q), plan_scans(ts, q)
    assert hasattr(tscan, "_point_rows") and hasattr(jscan, "_point_rows")
    assert (tscan.capacity, tscan.num_rows) == \
        (jscan.capacity, jscan.num_rows)
    np.testing.assert_array_equal(tscan._point_rows, jscan._point_rows)
    assert "point-lookup" in ts.explain(q)
    assert_same(ts.sql(q), js.sql(q), allow_empty=True)


def test_point_slice_is_gathered_on_the_device(sessions):
    js, ts = sessions
    (scan,) = plan_scans(ts, "select k, v from pts where k = 4242")
    got = X.point_scan_slice("pts", scan._point_rows, ts)
    t = ts.catalog.table("pts")
    for c in ("k", "v", "n"):
        np.testing.assert_array_equal(got[c].numpy(),
                                      t.data[c][scan._point_rows])
    assert torch.equal(got["$nn:n"], torch.from_numpy(
        t.validity["n"][scan._point_rows]))


def test_disabled_or_small_tables_keep_the_full_scan(sessions):
    js, ts = sessions
    off = TorchSession(TorchConfig().with_overrides(
        **{"planner.enable_point_lookup": False}), device="cpu")
    carry_tables(js, off)
    q = "select k, v from pts where k = 12345"
    assert not hasattr(plan_scans(off, q)[0], "_point_rows")
    assert_same(off.sql(q), ts.sql(q))
    small = TorchSession(device="cpu")
    small.sql("create table s (k bigint, v bigint)")
    small.sql("insert into s values (1, 2), (3, 4)")
    assert not hasattr(plan_scans(small, "select v from s where k = 3")[0],
                       "_point_rows")


@pytest.mark.parametrize("existing", [(), ("b", "zz", "a")],
                         ids=["fresh", "existing"])
def test_bulk_dictionary_encode_equals_value_by_value(existing):
    """An object column encodes to the same codes, and appends the same
    values in the same order, as adding its values one at a time, also
    where it holds None and where it comes as a generator."""
    from cloudberry_tpu_torch.columnar import dictionary as D

    rng = np.random.default_rng(7)
    words = np.array([f"w{i}" for i in range(997)] + ["a", "b", "é", ""],
                     dtype=object)
    arr = words[rng.integers(0, len(words), 12_000)]
    bulk, one = D.StringDictionary(existing), D.StringDictionary(existing)
    got = bulk.encode(arr)
    want = np.array([one.add(v) for v in arr], dtype=np.int32)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert bulk.values == one.values
    assert bulk._index == one._index
    holed = arr.copy()
    holed[5] = None
    a, b = D.StringDictionary(existing), D.StringDictionary(existing)
    assert np.array_equal(a.encode(holed),
                          np.array([b.add(v) for v in holed], np.int32))
    assert a.values == b.values and None in a.values
    c = D.StringDictionary(existing)
    assert np.array_equal(c.encode(v for v in holed), a.encode(holed))
    assert c.values == a.values
