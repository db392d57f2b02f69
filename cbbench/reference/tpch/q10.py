"""TPC-H Q10, returned item reporting: the 20 customers with the most
revenue lost to returns in one quarter."""

from cbbench.gen.common import days
from cbbench.reference.common import end_of, finish, group, index_of


def answer(db, p):
    lo, hi = days(p["DATE"]), end_of(p["DATE"], months=3)
    odate = db.col("orders", "o_orderdate")
    o_ok = (odate >= lo) & (odate < hi)
    found, orow = index_of(db.col("orders", "o_orderkey"),
                           db.col("lineitem", "l_orderkey"))
    keep = found & o_ok[orow] & (
        db.col("lineitem", "l_returnflag")
        == db.code("lineitem", "l_returnflag", "R"))
    cust = db.col("orders", "o_custkey")[orow[keep]]
    first, inv, n = group(cust)
    rev = (db.dec("lineitem", "l_extendedprice")[keep]
           * (1 - db.dec("lineitem", "l_discount")[keep])).sum_by(inv, n)
    _, crow = index_of(db.col("customer", "c_custkey"), cust[first])
    _, nrow = index_of(db.col("nation", "n_nationkey"),
                       db.col("customer", "c_nationkey")[crow])
    C = "customer"
    return finish([db.col(C, "c_custkey")[crow], db.text(C, "c_name")[crow],
                   rev, db.dec(C, "c_acctbal")[crow],
                   db.text("nation", "n_name")[nrow],
                   db.text(C, "c_address")[crow], db.text(C, "c_phone")[crow],
                   db.text(C, "c_comment")[crow]], [(2, True)], 20)
