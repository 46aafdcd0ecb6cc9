"""TPC-H Q6 (forecasting revenue change): DATE, DISCOUNT and QUANTITY."""
from __future__ import annotations

from decimal import Decimal

from .common import add_months, day


def run(db, p, arith):
    li = db.columns("lineitem", ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"])
    disc = int(Decimal(p["DISCOUNT"]) * 100)
    keep = (li["l_shipdate"] >= day(p["DATE"])) & \
        (li["l_shipdate"] < add_months(p["DATE"], 12)) & \
        (li["l_discount"] >= disc - 1) & (li["l_discount"] <= disc + 1) & \
        (li["l_quantity"] < int(p["QUANTITY"]) * 100)
    if not keep.any():
        return [[None]]
    return [[arith.dec(arith.total(li["l_extendedprice"][keep] * li["l_discount"][keep]), 4)]]
