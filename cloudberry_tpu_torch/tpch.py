"""TPC-H data and queries for the port: a copy of the JAX package's
tools/tpchgen.py (``generate``, ``SCHEMAS``, the loaders) and of the 22
query texts of tools/tpch_queries.py, so that a run on the card needs
nothing of the JAX package.

tpchgen-lite approximates dbgen's distributions (dense keys instead of
sparse, simplified comment text); correctness checks compare against an
oracle over the SAME generated data. At sf=1 the tables have TPC-H SF1's
cardinalities: 1,500,000 orders with one to seven lines each, about six
million lineitem rows (5,997,925 at seed 1; dbgen's SF1 has 6,001,215).
"""

from __future__ import annotations

import numpy as np

from cloudberry_tpu_torch import types as T
from cloudberry_tpu_torch.types import Schema, date_to_days

_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
_CONTAINERS = [f"{a} {b}" for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
               for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]]
_TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_P_NAMES = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
            "black", "blanched", "blue", "blush", "brown", "burlywood",
            "burnished", "chartreuse", "chiffon", "chocolate", "coral",
            "cornflower", "cornsilk", "cream", "cyan", "dark", "deep", "dim",
            "dodger", "drab", "firebrick", "floral", "forest", "frosted",
            "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
            "hot", "hotpink", "indian", "ivory", "khaki", "lace", "lavender",
            "lawn", "lemon", "light", "lime", "linen", "magenta", "maroon",
            "medium", "metallic", "midnight", "mint", "misty", "moccasin",
            "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya",
            "peach", "peru", "pink", "plum", "powder", "puff", "purple",
            "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy",
            "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
            "steel", "tan", "thistle", "tomato", "turquoise", "violet",
            "wheat", "white", "yellow"]
_NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
            ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
            ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
            ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
            ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
            ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
            ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_WORDS = ["carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
          "final", "special", "pending", "regular", "express", "bold",
          "even", "silent", "daring", "unusual", "packages", "deposits",
          "requests", "accounts", "theodolites", "instructions", "platelets",
          "foxes", "ideas", "dependencies", "pinto beans", "warhorses"]

D = date_to_days


def _comments(rng, n, nwords=4):
    idx = rng.integers(0, len(_WORDS), size=(n, nwords))
    w = np.asarray(_WORDS, dtype=object)
    out = w[idx[:, 0]]
    for k in range(1, nwords):
        out = out + " " + w[idx[:, k]]
    return out


def _dec(rng, lo, hi, n):
    """decimal(2) values in [lo, hi] as float (encode_column rescales)."""
    return rng.integers(int(lo * 100), int(hi * 100) + 1, n) / 100.0


SCHEMAS: dict[str, Schema] = {
    "region": Schema.of(r_regionkey=T.INT64, r_name=T.STRING,
                        r_comment=T.STRING),
    "nation": Schema.of(n_nationkey=T.INT64, n_name=T.STRING,
                        n_regionkey=T.INT64, n_comment=T.STRING),
    "supplier": Schema.of(s_suppkey=T.INT64, s_name=T.STRING,
                          s_address=T.STRING, s_nationkey=T.INT64,
                          s_phone=T.STRING, s_acctbal=T.DECIMAL(2),
                          s_comment=T.STRING),
    "customer": Schema.of(c_custkey=T.INT64, c_name=T.STRING,
                          c_address=T.STRING, c_nationkey=T.INT64,
                          c_phone=T.STRING, c_acctbal=T.DECIMAL(2),
                          c_mktsegment=T.STRING, c_comment=T.STRING),
    "part": Schema.of(p_partkey=T.INT64, p_name=T.STRING, p_mfgr=T.STRING,
                      p_brand=T.STRING, p_type=T.STRING, p_size=T.INT32,
                      p_container=T.STRING, p_retailprice=T.DECIMAL(2),
                      p_comment=T.STRING),
    "partsupp": Schema.of(ps_partkey=T.INT64, ps_suppkey=T.INT64,
                          ps_availqty=T.INT32, ps_supplycost=T.DECIMAL(2),
                          ps_comment=T.STRING),
    "orders": Schema.of(o_orderkey=T.INT64, o_custkey=T.INT64,
                        o_orderstatus=T.STRING, o_totalprice=T.DECIMAL(2),
                        o_orderdate=T.DATE, o_orderpriority=T.STRING,
                        o_clerk=T.STRING, o_shippriority=T.INT32,
                        o_comment=T.STRING),
    "lineitem": Schema.of(l_orderkey=T.INT64, l_partkey=T.INT64,
                          l_suppkey=T.INT64, l_linenumber=T.INT32,
                          l_quantity=T.DECIMAL(2),
                          l_extendedprice=T.DECIMAL(2),
                          l_discount=T.DECIMAL(2), l_tax=T.DECIMAL(2),
                          l_returnflag=T.STRING, l_linestatus=T.STRING,
                          l_shipdate=T.DATE, l_commitdate=T.DATE,
                          l_receiptdate=T.DATE, l_shipinstruct=T.STRING,
                          l_shipmode=T.STRING, l_comment=T.STRING),
}

DIST_KEYS = {
    "region": None, "nation": None,           # replicated
    "supplier": ("s_suppkey",), "customer": ("c_custkey",),
    "part": ("p_partkey",), "partsupp": ("ps_partkey",),
    "orders": ("o_orderkey",), "lineitem": ("l_orderkey",),
}


def generate(sf: float = 0.01, seed: int = 0) -> dict[str, dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_part = max(int(200_000 * sf), 40)
    n_ord = max(int(1_500_000 * sf), 150)

    data: dict[str, dict[str, np.ndarray]] = {}

    data["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.asarray(_REGIONS, dtype=object),
        "r_comment": _comments(rng, 5),
    }
    data["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.asarray([n for n, _ in _NATIONS], dtype=object),
        "n_regionkey": np.asarray([r for _, r in _NATIONS], dtype=np.int64),
        "n_comment": _comments(rng, 25),
    }
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    data["supplier"] = {
        "s_suppkey": sk,
        "s_name": np.asarray([f"Supplier#{i:09d}" for i in sk], dtype=object),
        "s_address": _comments(rng, n_supp, 2),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int64),
        "s_phone": np.asarray([f"{rng.integers(10,35)}-{i%1000:03d}-{i%10000:04d}"
                               for i in sk], dtype=object),
        "s_acctbal": _dec(rng, -999.99, 9999.99, n_supp),
        "s_comment": _comments(rng, n_supp),
    }
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    data["customer"] = {
        "c_custkey": ck,
        "c_name": np.asarray([f"Customer#{i:09d}" for i in ck], dtype=object),
        "c_address": _comments(rng, n_cust, 2),
        "c_nationkey": rng.integers(0, 25, n_cust).astype(np.int64),
        "c_phone": np.asarray([f"{10 + i % 25}-{i%1000:03d}-{i%10000:04d}"
                               for i in ck], dtype=object),
        "c_acctbal": _dec(rng, -999.99, 9999.99, n_cust),
        "c_mktsegment": np.asarray(_SEGMENTS, dtype=object)[
            rng.integers(0, 5, n_cust)],
        "c_comment": _comments(rng, n_cust),
    }
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    nm1 = np.asarray(_P_NAMES, dtype=object)
    p_name = (nm1[rng.integers(0, len(_P_NAMES), n_part)] + " "
              + nm1[rng.integers(0, len(_P_NAMES), n_part)] + " "
              + nm1[rng.integers(0, len(_P_NAMES), n_part)])
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    t1 = np.asarray(_TYPE_1, dtype=object)[rng.integers(0, 6, n_part)]
    t2 = np.asarray(_TYPE_2, dtype=object)[rng.integers(0, 5, n_part)]
    t3 = np.asarray(_TYPE_3, dtype=object)[rng.integers(0, 5, n_part)]
    data["part"] = {
        "p_partkey": pk,
        "p_name": p_name,
        "p_mfgr": np.asarray([f"Manufacturer#{m}" for m in mfgr], dtype=object),
        "p_brand": np.asarray([f"Brand#{b}" for b in brand], dtype=object),
        "p_type": t1 + " " + t2 + " " + t3,
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": np.asarray(_CONTAINERS, dtype=object)[
            rng.integers(0, len(_CONTAINERS), n_part)],
        "p_retailprice": (90000 + (pk % 20001) + 100 * (pk % 1000)) / 100.0,
        "p_comment": _comments(rng, n_part, 2),
    }
    ps_pk = np.repeat(pk, 4)
    n_ps = len(ps_pk)
    ps_sk = ((ps_pk + (np.tile(np.arange(4), n_part)
                       * (n_supp // 4 + 1))) % n_supp) + 1
    data["partsupp"] = {
        "ps_partkey": ps_pk,
        "ps_suppkey": ps_sk.astype(np.int64),
        "ps_availqty": rng.integers(1, 10_000, n_ps).astype(np.int32),
        "ps_supplycost": _dec(rng, 1.00, 1000.00, n_ps),
        "ps_comment": _comments(rng, n_ps),
    }

    ok = np.arange(1, n_ord + 1, dtype=np.int64)
    # dbgen rule: customers with custkey % 3 == 0 place no orders — keeps
    # anti-join queries (Q13 zero-order bucket, Q22 NOT EXISTS) non-vacuous
    cust_pool = np.asarray([k for k in range(1, n_cust + 1) if k % 3 != 0],
                           dtype=np.int64)
    o_custkey = cust_pool[rng.integers(0, len(cust_pool), n_ord)]
    start, end = D("1992-01-01"), D("1998-08-02")
    o_orderdate = rng.integers(start, end + 1, n_ord).astype(np.int64)
    n_lines_per = rng.integers(1, 8, n_ord)
    l_ok = np.repeat(ok, n_lines_per)
    n_li = len(l_ok)
    l_odate = np.repeat(o_orderdate, n_lines_per)
    l_shipdate = l_odate + rng.integers(1, 122, n_li)
    l_commitdate = l_odate + rng.integers(30, 91, n_li)
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_li)
    current = D("1995-06-17")
    returnflag = np.where(
        l_receiptdate <= current,
        np.where(rng.random(n_li) < 0.5, "R", "A"), "N").astype(object)
    linestatus = np.where(l_shipdate > current, "O", "F").astype(object)
    l_qty = rng.integers(1, 51, n_li).astype(np.float64)
    l_pk = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    # supplier chosen among the part's 4 partsupp suppliers
    which = rng.integers(0, 4, n_li)
    l_sk = ((l_pk + which * (n_supp // 4 + 1)) % n_supp) + 1
    retail = (90000 + (l_pk % 20001) + 100 * (l_pk % 1000)) / 100.0
    l_price = np.round(l_qty * retail, 2)

    o_status = np.full(n_ord, "P", dtype=object)
    all_f = np.ones(n_ord, dtype=bool)
    any_f = np.zeros(n_ord, dtype=bool)
    np.logical_and.at(all_f, l_ok - 1, linestatus == "F")
    np.logical_or.at(any_f, l_ok - 1, linestatus == "F")
    o_status[all_f] = "F"
    o_status[~any_f] = "O"

    o_total = np.zeros(n_ord)
    np.add.at(o_total, l_ok - 1, l_price)
    data["orders"] = {
        "o_orderkey": ok,
        "o_custkey": o_custkey,
        "o_orderstatus": o_status,
        "o_totalprice": np.round(o_total, 2),
        "o_orderdate": o_orderdate.astype(np.int64),
        "o_orderpriority": np.asarray(_PRIORITIES, dtype=object)[
            rng.integers(0, 5, n_ord)],
        "o_clerk": np.asarray(
            [f"Clerk#{i:09d}" for i in rng.integers(1, max(n_ord // 1000, 2),
                                                    n_ord)], dtype=object),
        "o_shippriority": np.zeros(n_ord, dtype=np.int32),
        "o_comment": _comments(rng, n_ord),
    }
    lineno = np.concatenate([np.arange(1, k + 1) for k in n_lines_per])
    data["lineitem"] = {
        "l_orderkey": l_ok,
        "l_partkey": l_pk,
        "l_suppkey": l_sk.astype(np.int64),
        "l_linenumber": lineno.astype(np.int32),
        "l_quantity": l_qty,
        "l_extendedprice": l_price,
        "l_discount": _dec(rng, 0.00, 0.10, n_li),
        "l_tax": _dec(rng, 0.00, 0.08, n_li),
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": l_shipdate.astype(np.int64),
        "l_commitdate": l_commitdate.astype(np.int64),
        "l_receiptdate": l_receiptdate.astype(np.int64),
        "l_shipinstruct": np.asarray(_INSTRUCTS, dtype=object)[
            rng.integers(0, 4, n_li)],
        "l_shipmode": np.asarray(_SHIPMODES, dtype=object)[
            rng.integers(0, 7, n_li)],
        "l_comment": _comments(rng, n_li, 2),
    }
    return data


def load_tables(session, schemas, dist_keys, raw,
                only: list[str] | None = None) -> None:
    """Create + populate benchmark tables (shared by tpch/tpcds loaders)."""
    from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy
    from cloudberry_tpu_torch.columnar.batch import encode_column

    for name, schema in schemas.items():
        if only is not None and name not in only:
            continue
        keys = dist_keys[name]
        policy = (DistributionPolicy.replicated() if keys is None
                  else DistributionPolicy.hashed(*keys))
        t = session.catalog.create_table(name, schema, policy)
        encoded = {}
        for f in schema.fields:
            encoded[f.name] = encode_column(raw[name][f.name], f, t.dicts)
        t.set_data(encoded, t.dicts)


def load_tpch(session, sf: float = 0.01, seed: int = 0,
              tables: list[str] | None = None) -> None:
    """Create + populate TPC-H tables in a session's catalog."""
    load_tables(session, SCHEMAS, DIST_KEYS, generate(sf, seed), tables)


# TPC-H query texts (substitution parameters fixed to the spec's
# validation values), all 22.
QUERIES: dict[str, str] = {}

QUERIES["q1"] = """
select
    l_returnflag,
    l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from
    lineitem
where
    l_shipdate <= date '1998-12-01' - interval '90' day
group by
    l_returnflag,
    l_linestatus
order by
    l_returnflag,
    l_linestatus
"""

QUERIES["q3"] = """
select
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate,
    o_shippriority
from
    customer,
    orders,
    lineitem
where
    c_mktsegment = 'BUILDING'
    and c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and o_orderdate < date '1995-03-15'
    and l_shipdate > date '1995-03-15'
group by
    l_orderkey,
    o_orderdate,
    o_shippriority
order by
    revenue desc,
    o_orderdate
limit 10
"""

QUERIES["q5"] = """
select
    n_name,
    sum(l_extendedprice * (1 - l_discount)) as revenue
from
    customer,
    orders,
    lineitem,
    supplier,
    nation,
    region
where
    c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and l_suppkey = s_suppkey
    and c_nationkey = s_nationkey
    and s_nationkey = n_nationkey
    and n_regionkey = r_regionkey
    and r_name = 'ASIA'
    and o_orderdate >= date '1994-01-01'
    and o_orderdate < date '1994-01-01' + interval '1' year
group by
    n_name
order by
    revenue desc
"""

QUERIES["q6"] = """
select
    sum(l_extendedprice * l_discount) as revenue
from
    lineitem
where
    l_shipdate >= date '1994-01-01'
    and l_shipdate < date '1994-01-01' + interval '1' year
    and l_discount between 0.05 and 0.07
    and l_quantity < 24
"""

QUERIES["q10"] = """
select
    c_custkey,
    c_name,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    c_acctbal,
    n_name,
    c_address,
    c_phone,
    c_comment
from
    customer,
    orders,
    lineitem,
    nation
where
    c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and o_orderdate >= date '1993-10-01'
    and o_orderdate < date '1993-10-01' + interval '3' month
    and l_returnflag = 'R'
    and c_nationkey = n_nationkey
group by
    c_custkey,
    c_name,
    c_acctbal,
    c_phone,
    n_name,
    c_address,
    c_comment
order by
    revenue desc
limit 20
"""

QUERIES["q12"] = """
select
    l_shipmode,
    sum(case
        when o_orderpriority = '1-URGENT'
            or o_orderpriority = '2-HIGH'
            then 1
        else 0
    end) as high_line_count,
    sum(case
        when o_orderpriority <> '1-URGENT'
            and o_orderpriority <> '2-HIGH'
            then 1
        else 0
    end) as low_line_count
from
    orders,
    lineitem
where
    o_orderkey = l_orderkey
    and l_shipmode in ('MAIL', 'SHIP')
    and l_commitdate < l_receiptdate
    and l_shipdate < l_commitdate
    and l_receiptdate >= date '1994-01-01'
    and l_receiptdate < date '1994-01-01' + interval '1' year
group by
    l_shipmode
order by
    l_shipmode
"""

QUERIES["q14"] = """
select
    100.00 * sum(case
        when p_type like 'PROMO%'
            then l_extendedprice * (1 - l_discount)
        else 0
    end) / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from
    lineitem,
    part
where
    l_partkey = p_partkey
    and l_shipdate >= date '1995-09-01'
    and l_shipdate < date '1995-09-01' + interval '1' month
"""

QUERIES["q19"] = """
select
    sum(l_extendedprice * (1 - l_discount)) as revenue
from
    lineitem,
    part
where
    (
        p_partkey = l_partkey
        and p_brand = 'Brand#12'
        and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
        and l_quantity >= 1 and l_quantity <= 1 + 10
        and p_size between 1 and 5
        and l_shipmode in ('AIR', 'AIR REG')
        and l_shipinstruct = 'DELIVER IN PERSON'
    )
    or
    (
        p_partkey = l_partkey
        and p_brand = 'Brand#23'
        and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
        and l_quantity >= 10 and l_quantity <= 10 + 10
        and p_size between 1 and 10
        and l_shipmode in ('AIR', 'AIR REG')
        and l_shipinstruct = 'DELIVER IN PERSON'
    )
    or
    (
        p_partkey = l_partkey
        and p_brand = 'Brand#34'
        and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
        and l_quantity >= 20 and l_quantity <= 20 + 10
        and p_size between 1 and 15
        and l_shipmode in ('AIR', 'AIR REG')
        and l_shipinstruct = 'DELIVER IN PERSON'
    )
"""

QUERIES["q2"] = """
select
    s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
from
    part, supplier, partsupp, nation, region
where
    p_partkey = ps_partkey
    and s_suppkey = ps_suppkey
    and p_size = 15
    and p_type like '%BRASS'
    and s_nationkey = n_nationkey
    and n_regionkey = r_regionkey
    and r_name = 'EUROPE'
    and ps_supplycost = (
        select min(ps_supplycost)
        from partsupp, supplier, nation, region
        where p_partkey = ps_partkey
            and s_suppkey = ps_suppkey
            and s_nationkey = n_nationkey
            and n_regionkey = r_regionkey
            and r_name = 'EUROPE'
    )
order by
    s_acctbal desc, n_name, s_name, p_partkey
limit 100
"""

QUERIES["q4"] = """
select
    o_orderpriority,
    count(*) as order_count
from
    orders
where
    o_orderdate >= date '1993-07-01'
    and o_orderdate < date '1993-07-01' + interval '3' month
    and exists (
        select * from lineitem
        where l_orderkey = o_orderkey and l_commitdate < l_receiptdate
    )
group by o_orderpriority
order by o_orderpriority
"""

QUERIES["q7"] = """
select
    supp_nation, cust_nation, l_year, sum(volume) as revenue
from
    (
        select
            n1.n_name as supp_nation,
            n2.n_name as cust_nation,
            extract(year from l_shipdate) as l_year,
            l_extendedprice * (1 - l_discount) as volume
        from
            supplier, lineitem, orders, customer, nation n1, nation n2
        where
            s_suppkey = l_suppkey
            and o_orderkey = l_orderkey
            and c_custkey = o_custkey
            and s_nationkey = n1.n_nationkey
            and c_nationkey = n2.n_nationkey
            and (
                (n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
                or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE')
            )
            and l_shipdate between date '1995-01-01' and date '1996-12-31'
    ) as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""

QUERIES["q8"] = """
select
    o_year,
    sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume)
        as mkt_share
from
    (
        select
            extract(year from o_orderdate) as o_year,
            l_extendedprice * (1 - l_discount) as volume,
            n2.n_name as nation
        from
            part, supplier, lineitem, orders, customer,
            nation n1, nation n2, region
        where
            p_partkey = l_partkey
            and s_suppkey = l_suppkey
            and l_orderkey = o_orderkey
            and o_custkey = c_custkey
            and c_nationkey = n1.n_nationkey
            and n1.n_regionkey = r_regionkey
            and r_name = 'AMERICA'
            and s_nationkey = n2.n_nationkey
            and o_orderdate between date '1995-01-01' and date '1996-12-31'
            and p_type = 'ECONOMY ANODIZED STEEL'
    ) as all_nations
group by o_year
order by o_year
"""

QUERIES["q9"] = """
select
    nation, o_year, sum(amount) as sum_profit
from
    (
        select
            n_name as nation,
            extract(year from o_orderdate) as o_year,
            l_extendedprice * (1 - l_discount)
                - ps_supplycost * l_quantity as amount
        from
            part, supplier, lineitem, partsupp, orders, nation
        where
            s_suppkey = l_suppkey
            and ps_suppkey = l_suppkey
            and ps_partkey = l_partkey
            and p_partkey = l_partkey
            and o_orderkey = l_orderkey
            and s_nationkey = n_nationkey
            and p_name like '%green%'
    ) as profit
group by nation, o_year
order by nation, o_year desc
"""

QUERIES["q11"] = """
select
    ps_partkey, sum(ps_supplycost * ps_availqty) as value
from
    partsupp, supplier, nation
where
    ps_suppkey = s_suppkey
    and s_nationkey = n_nationkey
    and n_name = 'GERMANY'
group by ps_partkey
having
    sum(ps_supplycost * ps_availqty) > (
        select sum(ps_supplycost * ps_availqty) * 0.0001
        from partsupp, supplier, nation
        where ps_suppkey = s_suppkey
            and s_nationkey = n_nationkey
            and n_name = 'GERMANY'
    )
order by value desc
"""

QUERIES["q13"] = """
select
    c_count, count(*) as custdist
from
    (
        select c_custkey, count(o_orderkey) as c_count
        from customer left join orders on
            c_custkey = o_custkey
            and o_comment not like '%special%requests%'
        group by c_custkey
    ) as c_orders
group by c_count
order by custdist desc, c_count desc
"""

QUERIES["q15"] = """
select
    s_suppkey, s_name, s_address, s_phone, total_revenue
from
    supplier,
    (
        select l_suppkey as supplier_no,
               sum(l_extendedprice * (1 - l_discount)) as total_revenue
        from lineitem
        where l_shipdate >= date '1996-01-01'
            and l_shipdate < date '1996-01-01' + interval '3' month
        group by l_suppkey
    ) as revenue
where
    s_suppkey = supplier_no
    and total_revenue = (
        select max(total_revenue)
        from (
            select l_suppkey as supplier_no,
                   sum(l_extendedprice * (1 - l_discount)) as total_revenue
            from lineitem
            where l_shipdate >= date '1996-01-01'
                and l_shipdate < date '1996-01-01' + interval '3' month
            group by l_suppkey
        ) as revenue_all
    )
order by s_suppkey
"""

QUERIES["q16"] = """
select
    p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from
    partsupp, part
where
    p_partkey = ps_partkey
    and p_brand <> 'Brand#45'
    and p_type not like 'MEDIUM POLISHED%'
    and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
    and ps_suppkey not in (
        select s_suppkey from supplier
        where s_comment like '%Customer%Complaints%'
    )
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
"""

QUERIES["q17"] = """
select
    sum(l_extendedprice) / 7.0 as avg_yearly
from
    lineitem, part
where
    p_partkey = l_partkey
    and p_brand = 'Brand#23'
    and p_container = 'MED BOX'
    and l_quantity < (
        select 0.2 * avg(l_quantity)
        from lineitem
        where l_partkey = p_partkey
    )
"""

QUERIES["q18"] = """
select
    c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
    sum(l_quantity) as total_qty
from
    customer, orders, lineitem
where
    o_orderkey in (
        select l_orderkey
        from lineitem
        group by l_orderkey
        having sum(l_quantity) > 300
    )
    and c_custkey = o_custkey
    and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
"""

QUERIES["q20"] = """
select
    s_name, s_address
from
    supplier, nation
where
    s_suppkey in (
        select ps_suppkey
        from partsupp
        where ps_partkey in (
            select p_partkey from part where p_name like 'forest%'
        )
        and ps_availqty > (
            select 0.5 * sum(l_quantity)
            from lineitem
            where l_partkey = ps_partkey
                and l_suppkey = ps_suppkey
                and l_shipdate >= date '1994-01-01'
                and l_shipdate < date '1994-01-01' + interval '1' year
        )
    )
    and s_nationkey = n_nationkey
    and n_name = 'CANADA'
order by s_name
"""

QUERIES["q21"] = """
select
    s_name, count(*) as numwait
from
    supplier, lineitem l1, orders, nation
where
    s_suppkey = l1.l_suppkey
    and o_orderkey = l1.l_orderkey
    and o_orderstatus = 'F'
    and l1.l_receiptdate > l1.l_commitdate
    and exists (
        select * from lineitem l2
        where l2.l_orderkey = l1.l_orderkey
            and l2.l_suppkey <> l1.l_suppkey
    )
    and not exists (
        select * from lineitem l3
        where l3.l_orderkey = l1.l_orderkey
            and l3.l_suppkey <> l1.l_suppkey
            and l3.l_receiptdate > l3.l_commitdate
    )
    and s_nationkey = n_nationkey
    and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
"""

QUERIES["q22"] = """
select
    cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from
    (
        select substring(c_phone from 1 for 2) as cntrycode, c_acctbal
        from customer
        where substring(c_phone from 1 for 2) in
                ('13', '31', '23', '29', '30', '18', '17')
            and c_acctbal > (
                select avg(c_acctbal) from customer
                where c_acctbal > 0.00
                    and substring(c_phone from 1 for 2) in
                        ('13', '31', '23', '29', '30', '18', '17')
            )
            and not exists (
                select * from orders where o_custkey = c_custkey
            )
    ) as custsale
group by cntrycode
order by cntrycode
"""
