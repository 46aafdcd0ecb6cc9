"""TPC-H Q22 (global sales opportunity): country codes I1 to I7.

``substring(c_phone, 1, 2)`` is the first two characters of the decoded
phone number, which the frozen generator formats as ``11 + code % 25``
followed by a dash.
"""
from __future__ import annotations

import numpy as np


def run(db, p, arith):
    wanted = [p[f"I{k}"] for k in range(1, 8)]
    c = db.columns("customer", ["c_custkey", "c_phone", "c_acctbal"])
    cc = 11 + c["c_phone"] % 25
    in_set = np.isin(cc, [int(x) for x in wanted])
    bal = c["c_acctbal"]
    pos = in_set & (bal > 0)
    if not pos.any():
        return []
    above = arith.greater(bal, arith.total(bal[pos]), int(pos.sum()))
    has_order = np.zeros(int(c["c_custkey"].max()) + 1, dtype=bool)
    has_order[db.column("orders", "o_custkey")] = True
    keep = in_set & above & ~has_order[c["c_custkey"]]
    rows = []
    for code in sorted(set(int(x) for x in cc[keep])):
        sel = keep & (cc == code)
        rows.append([str(code), int(sel.sum()), arith.dec(arith.total(bal[sel]), 2)])
    return rows
