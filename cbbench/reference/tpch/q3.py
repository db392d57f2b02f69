"""TPC-H Q3, shipping priority: the 10 unshipped orders of a market
segment with the highest revenue."""

from cbbench.gen.common import days
from cbbench.reference.common import Date, finish, group, index_of


def answer(db, p):
    d = days(p["DATE"])
    seg = db.code("customer", "c_mktsegment", p["SEGMENT"])
    cust = db.col("customer", "c_custkey")[
        db.col("customer", "c_mktsegment") == seg]
    o_ok = db.col("orders", "o_orderdate") < d
    o_ok &= index_of(cust, db.col("orders", "o_custkey"))[0]
    okeys = db.col("orders", "o_orderkey")
    found, orow = index_of(okeys[o_ok], db.col("lineitem", "l_orderkey"))
    keep = found & (db.col("lineitem", "l_shipdate") > d)
    orow = orow[keep]
    rows = o_ok.nonzero().flatten()[orow]
    first, inv, n = group(db.col("lineitem", "l_orderkey")[keep])
    rev = (db.dec("lineitem", "l_extendedprice")[keep]
           * (1 - db.dec("lineitem", "l_discount")[keep])).sum_by(inv, n)
    o = rows[first]
    return finish([okeys[o], rev, Date(db.col("orders", "o_orderdate")[o]),
                   db.col("orders", "o_shippriority")[o].long()],
                  [(1, True), (2, False)], 10)
