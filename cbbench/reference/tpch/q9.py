"""TPC-H Q9, product type profit: profit of parts whose name holds a
colour, by supplier nation and order year."""

from cbbench.reference.common import finish, group, index_of, year_of


def answer(db, p):
    color = p["COLOR"]
    parts = db.col("part", "p_partkey")[
        db.where("part", "p_name", lambda v: color in v)]
    keep = index_of(parts, db.col("lineitem", "l_partkey"))[0]
    idx = keep.nonzero().flatten()
    pk = db.col("lineitem", "l_partkey")[idx]
    sk = db.col("lineitem", "l_suppkey")[idx]
    m = int(db.col("partsupp", "ps_suppkey").max()) + 1
    _, psrow = index_of(db.col("partsupp", "ps_partkey") * m
                        + db.col("partsupp", "ps_suppkey"), pk * m + sk)
    _, srow = index_of(db.col("supplier", "s_suppkey"), sk)
    _, nrow = index_of(db.col("nation", "n_nationkey"),
                       db.col("supplier", "s_nationkey")[srow])
    _, orow = index_of(db.col("orders", "o_orderkey"),
                       db.col("lineitem", "l_orderkey")[idx])
    year = year_of(db.col("orders", "o_orderdate")[orow])
    amount = (db.dec("lineitem", "l_extendedprice")[idx]
              * (1 - db.dec("lineitem", "l_discount")[idx])
              - db.dec("partsupp", "ps_supplycost")[psrow]
              * db.dec("lineitem", "l_quantity")[idx])
    first, inv, n = group(nrow, year)
    return finish([db.text("nation", "n_name")[nrow[first]], year[first],
                   amount.sum_by(inv, n)], [(0, False), (1, True)])
