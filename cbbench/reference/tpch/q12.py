"""TPC-H Q12, shipping modes and order priority: late lines of two ship
modes received in one year, counted by their order's priority."""

import torch

from cbbench.gen.common import days
from cbbench.reference.common import end_of, finish, group, index_of


def answer(db, p):
    L = "lineitem"
    mode = db.col(L, "l_shipmode")
    receipt, commit = db.col(L, "l_receiptdate"), db.col(L, "l_commitdate")
    keep = (((mode == db.code(L, "l_shipmode", p["SHIPMODE1"]))
             | (mode == db.code(L, "l_shipmode", p["SHIPMODE2"])))
            & (commit < receipt) & (db.col(L, "l_shipdate") < commit)
            & (receipt >= days(p["DATE"]))
            & (receipt < end_of(p["DATE"], years=1)))
    _, orow = index_of(db.col("orders", "o_orderkey"),
                       db.col(L, "l_orderkey")[keep])
    high = db.where("orders", "o_orderpriority",
                    lambda v: v in ("1-URGENT", "2-HIGH"))[orow].long()
    text = db.text(L, "l_shipmode")[keep]
    first, inv, n = group(text.codes)
    zero = torch.zeros(n, dtype=torch.int64, device=inv.device)
    return finish([text[first], zero.index_add(0, inv, high),
                   zero.index_add(0, inv, 1 - high)], [(0, False)])
