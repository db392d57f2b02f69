"""TPC-H Q6, forecasting revenue change: one year's lines in a discount
band under a quantity."""

from cbbench.gen.common import days
from cbbench.reference.common import end_of, finish


def _cents(text: str) -> int:
    whole, _, frac = text.partition(".")
    return int(whole) * 100 + int((frac + "00")[:2])


def answer(db, p):
    L = "lineitem"
    ship = db.col(L, "l_shipdate")
    disc = db.col(L, "l_discount")
    keep = ((ship >= days(p["DATE"])) & (ship < end_of(p["DATE"], years=1))
            & (disc >= _cents(p["DISCOUNT_LO"]))
            & (disc <= _cents(p["DISCOUNT_HI"]))
            & (db.col(L, "l_quantity") < int(p["QUANTITY"]) * 100))
    rev = (db.dec(L, "l_extendedprice")[keep]
           * db.dec(L, "l_discount")[keep]).total()
    return finish([rev], [])
