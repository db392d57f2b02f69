"""The card-side generator, run on CPU tensors at a tiny scale: the
program's schema, the encoded dtypes, dbgen's key relationships and its
value ranges."""

import numpy as np
import pytest

from cbbench.gen import tpch
from cbbench.gen.common import days, encode_chars

PHYSICAL = {"int64": np.int64, "int32": np.int32, "decimal": np.int64,
            "date": np.int32, "string": np.int32}


@pytest.fixture(scope="module")
def h():
    made = tpch.make(0.01, 2**31 + 7, "cpu", list(tpch._GROUP))
    return {k: v.to_host() for k, v in made.items()}


def _types(schema):
    from cloudberry_tpu_torch.types import DType

    base = {DType.INT64: "int64", DType.INT32: "int32",
            DType.DECIMAL: "decimal", DType.DATE: "date",
            DType.STRING: "string"}
    return [(f.name, base[f.type.base], f.type.scale) for f in schema.fields]


def test_schemas_and_dtypes_are_the_programs(h):
    from cloudberry_tpu_torch import tpch as ptpch

    tables, schemas = h, ptpch.SCHEMAS
    assert set(tables) == set(schemas)
    for name, t in tables.items():
        assert t.fields == _types(schemas[name]), name
        n = t.rows
        for col, base, _ in t.fields:
            arr = t.columns[col]
            assert arr.dtype == PHYSICAL[base] and len(arr) == n, (name, col)
            if base == "string":
                d = t.dicts[col]
                assert arr.min() >= 0 and arr.max() < len(d), (name, col)
                assert len(set(d)) == len(d), (name, col)


def test_tpch_cardinalities_and_keys(h):
    sz = tpch.sizes(0.01)
    assert h["orders"].rows == sz["orders"]
    assert h["customer"].rows == sz["customer"]
    assert h["partsupp"].rows == 4 * sz["part"]
    li, o = h["lineitem"].columns, h["orders"].columns
    assert 1 * sz["orders"] <= len(li["l_orderkey"]) <= 7 * sz["orders"]
    # dbgen's sparse orderkeys: 1..8, 33..40, 65..72, ...
    i = np.arange(sz["orders"])
    assert np.array_equal(o["o_orderkey"], (i // 8) * 32 + i % 8 + 1)
    # every line has its order; line numbers run 1..count per order
    pos = np.searchsorted(o["o_orderkey"], li["l_orderkey"])
    assert np.array_equal(o["o_orderkey"][pos], li["l_orderkey"])
    counts = np.bincount(pos, minlength=sz["orders"])
    assert counts.min() >= 1 and counts.max() <= 7
    starts = np.r_[0, np.cumsum(counts)[:-1]]
    assert np.array_equal(li["l_linenumber"][starts], np.ones(len(counts)))
    # no customer with a key divisible by 3 orders
    assert (o["o_custkey"] % 3 != 0).all()
    assert o["o_custkey"].max() <= sz["customer"]
    # a line's (part, supplier) is a partsupp row; a part's four
    # suppliers follow dbgen's bridge and differ
    ps = h["partsupp"].columns
    s_n = sz["supplier"]
    m = s_n + 1
    pairs = set((ps["ps_partkey"] * m + ps["ps_suppkey"]).tolist())
    assert set((li["l_partkey"] * m + li["l_suppkey"]).tolist()) <= pairs
    pk = ps["ps_partkey"]
    which = np.tile(np.arange(4), sz["part"])
    assert np.array_equal(
        ps["ps_suppkey"], (pk + which * (s_n // 4 + (pk - 1) // s_n)) % s_n + 1)
    assert len(pairs) == len(pk)
    # dbgen's total: each line's price less its discount plus its tax
    line = (li["l_extendedprice"] * (100 - li["l_discount"]) // 100
            * (100 + li["l_tax"]) // 100)
    total = np.zeros(sz["orders"], dtype=np.int64)
    np.add.at(total, pos, line)
    assert np.array_equal(total, o["o_totalprice"])
    # dbgen's retail price
    p = h["part"].columns["p_partkey"]
    assert np.array_equal(h["part"].columns["p_retailprice"],
                          90000 + (p // 10) % 20001 + 100 * (p % 1000))


def test_tpch_value_ranges(h):
    li = h["lineitem"].columns
    assert li["l_quantity"].min() >= 100 and li["l_quantity"].max() <= 5000
    assert li["l_discount"].min() >= 0 and li["l_discount"].max() <= 10
    assert li["l_tax"].min() >= 0 and li["l_tax"].max() <= 8
    od = h["orders"].columns["o_orderdate"]
    assert od.min() >= days("1992-01-01") and od.max() <= days("1998-08-02")
    assert (li["l_receiptdate"] > li["l_shipdate"]).all()
    flags = np.asarray(h["lineitem"].dicts["l_returnflag"])[
        li["l_returnflag"]]
    late = li["l_receiptdate"] > days("1995-06-17")
    assert (flags[late] == "N").all() and (flags[~late] != "N").all()
    d = h["lineitem"].dicts["l_comment"]
    assert all(len(c.split(" ")) >= 2 for c in d)


def test_tpch_text_columns(h):
    # a part's name: five distinct colours of the 92
    part = h["part"]
    names = np.asarray(part.dicts["p_name"])[part.columns["p_name"]]
    for n in names:
        w = n.split(" ")
        assert len(w) == 5 and len(set(w)) == 5 and set(w) <= set(tpch.P_NAMES)
    green = np.mean(["green" in n.split(" ") for n in names])
    assert 0.03 < green < 0.08  # 5 / 92 = 5.4 %
    # addresses and phones: random per row, as dbgen makes them
    for t, p in (("customer", "c_"), ("supplier", "s_")):
        tab = h[t]
        addr = np.asarray(tab.dicts[p + "address"])[tab.columns[p + "address"]]
        assert len(set(addr)) == len(addr)
        assert min(map(len, addr)) >= 10 and max(map(len, addr)) <= 40
        assert set("".join(addr)) <= set(tpch.ALNUM)
        phone = np.asarray(tab.dicts[p + "phone"])[tab.columns[p + "phone"]]
        assert len(set(phone)) > 0.99 * len(phone)
        for ph, nat in zip(phone, tab.columns[p + "nationkey"]):
            cc, a, b, c = ph.split("-")
            assert int(cc) == nat + 10 and len(ph) == 15
            assert 100 <= int(a) <= 999 and 100 <= int(b) <= 999
            assert 1000 <= int(c) <= 9999


def test_encode_chars_orders_by_bytes():
    import torch

    words = ["b", "ab", "a", "abc", "ab", "zzzzzzzzz"]
    chars = torch.zeros((len(words), 9), dtype=torch.int64)
    for i, w in enumerate(words):
        chars[i, :len(w)] = torch.tensor([ord(c) for c in w])
    codes, values = encode_chars(chars)
    assert values == sorted(set(words))
    assert [values[c] for c in codes.tolist()] == words


def test_same_seed_same_data():
    a = tpch.make(0.01, 99, "cpu", ["orders"])["orders"].to_host()
    b = tpch.make(0.01, 99, "cpu", ["orders"])["orders"].to_host()
    c = tpch.make(0.01, 100, "cpu", ["orders"])["orders"].to_host()
    for col in a.columns:
        assert np.array_equal(a.columns[col], b.columns[col])
    assert not np.array_equal(a.columns["o_custkey"], c.columns["o_custkey"])
