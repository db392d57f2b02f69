"""TPC-H Q18, large volume customer: the 100 orders of the most value
whose quantity passes QUANTITY."""

from cbbench.reference.common import Date, finish, group, index_of


def answer(db, p):
    L = "lineitem"
    first, inv, n = group(db.col(L, "l_orderkey"))
    qty = db.dec(L, "l_quantity").sum_by(inv, n)
    cents = db.col(L, "l_quantity").new_zeros(n).index_add_(
        0, inv, db.col(L, "l_quantity"))
    big = cents > int(p["QUANTITY"]) * 100
    okey = db.col(L, "l_orderkey")[first][big]
    _, orow = index_of(db.col("orders", "o_orderkey"), okey)
    _, crow = index_of(db.col("customer", "c_custkey"),
                       db.col("orders", "o_custkey")[orow])
    O = "orders"
    return finish([db.text("customer", "c_name")[crow],
                   db.col("customer", "c_custkey")[crow], okey,
                   Date(db.col(O, "o_orderdate")[orow]),
                   db.dec(O, "o_totalprice")[orow], qty[big]],
                  [(4, True), (3, False)], 100)
