"""TPC-H Q1, pricing summary report: lineitem shipped by 1998-12-01 less
DELTA days, grouped by return flag and line status."""

import torch

from cbbench.gen.common import days
from cbbench.reference.common import count_by, finish, group


def answer(db, p):
    L = "lineitem"
    keep = db.col(L, "l_shipdate") <= days("1998-12-01") - int(p["DELTA"])
    rf, ls = db.text(L, "l_returnflag")[keep], db.text(L, "l_linestatus")[keep]
    first, inv, n = group(rf.codes, ls.codes)
    qty = db.dec(L, "l_quantity")[keep]
    price = db.dec(L, "l_extendedprice")[keep]
    disc = db.dec(L, "l_discount")[keep]
    tax = db.dec(L, "l_tax")[keep]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    cnt = count_by(inv, n)
    sums = [x.sum_by(inv, n) for x in (qty, price, disc_price, charge, disc)]
    c = cnt.to(torch.float64)
    avgs = [torch.from_numpy(s.floats()).to(c.device) / c
            for s in (sums[0], sums[1], sums[4])]
    return finish([rf[first], ls[first], *sums[:4], *avgs, cnt],
                  [(0, False), (1, False)])
