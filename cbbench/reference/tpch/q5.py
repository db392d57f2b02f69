"""TPC-H Q5, local supplier volume: revenue of a region's nations from
orders of one year where customer and supplier share the nation."""

from cbbench.gen.common import days
from cbbench.reference.common import end_of, finish, group, index_of


def answer(db, p):
    lo, hi = days(p["DATE"]), end_of(p["DATE"], years=1)
    region = db.col("region", "r_regionkey")[
        db.col("region", "r_name") == db.code("region", "r_name",
                                              p["REGION"])]
    nat_ok = index_of(region, db.col("nation", "n_regionkey"))[0]
    odate = db.col("orders", "o_orderdate")
    o_ok = (odate >= lo) & (odate < hi)
    found, orow = index_of(db.col("orders", "o_orderkey"),
                           db.col("lineitem", "l_orderkey"))
    keep = found & o_ok[orow]
    _, crow = index_of(db.col("customer", "c_custkey"),
                       db.col("orders", "o_custkey")[orow[keep]])
    c_nat = db.col("customer", "c_nationkey")[crow]
    _, srow = index_of(db.col("supplier", "s_suppkey"),
                       db.col("lineitem", "l_suppkey")[keep])
    s_nat = db.col("supplier", "s_nationkey")[srow]
    _, nrow = index_of(db.col("nation", "n_nationkey"), s_nat)
    ok = (c_nat == s_nat) & nat_ok[nrow]
    idx = keep.nonzero().flatten()[ok]
    first, inv, n = group(nrow[ok])
    rev = (db.dec("lineitem", "l_extendedprice")[idx]
           * (1 - db.dec("lineitem", "l_discount")[idx])).sum_by(inv, n)
    return finish([db.text("nation", "n_name")[nrow[ok][first]], rev],
                  [(1, True)])
