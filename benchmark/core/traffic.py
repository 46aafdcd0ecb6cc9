"""The one traffic generator: closed-loop query streams from a cell's file.

A cell's traffic file gives ``streams`` and ``queries``. From ``--seed``,
each stream draws its own permutation of the queries and, once, each
query's substitution parameters from the domains in the query's file
(TPC-H clause 2.4, narrowed where the program's generator has a smaller
vocabulary). A stream sends its permutation round after round, each query
when the one before it has come back. The same seed gives the same
statements; the database itself is fixed by the scale factor.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Statement:
    key: str          # "s<stream>.<query>": one per stream and query
    query: str
    params: tuple     # ((name, value), ...), sorted
    sql: str

    def param_dict(self) -> Dict[str, str]:
        return dict(self.params)


def _draw(spec: dict, rng: np.random.Generator) -> Dict[str, str]:
    kind, names = spec["kind"], spec["names"]
    if kind == "choice":
        return {names[0]: str(spec["values"][rng.integers(len(spec["values"]))])}
    if kind == "sample":
        picked = rng.choice(len(spec["values"]), size=len(names), replace=False)
        return {n: str(spec["values"][i]) for n, i in zip(names, picked)}
    if kind == "int_range":
        return {names[0]: str(int(rng.integers(spec["lo"], spec["hi"] + 1)))}
    if kind == "date_range":
        lo = datetime.date.fromisoformat(spec["lo"])
        span = (datetime.date.fromisoformat(spec["hi"]) - lo).days
        return {names[0]: (lo + datetime.timedelta(days=int(rng.integers(span + 1)))).isoformat()}
    if kind == "year_start":
        return {names[0]: f"{int(rng.integers(spec['lo'], spec['hi'] + 1))}-01-01"}
    if kind == "month_start":
        year = int(rng.integers(spec["lo"], spec["hi"] + 1))
        return {names[0]: f"{year}-{int(rng.integers(1, 13)):02d}-01"}
    raise ValueError(f"unknown parameter kind {kind!r}")


def statement(query: dict, params: Dict[str, str], key: str) -> Statement:
    return Statement(key, query["name"], tuple(sorted(params.items())),
                     query["sql"].format(**params))


def streams(traffic: dict, queries: Dict[str, dict], seed: int) -> List[List[Statement]]:
    """Each stream's statements in the order it sends them, one round."""
    out = []
    for s in range(int(traffic["streams"])):
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, s])
        order = [traffic["queries"][i] for i in rng.permutation(len(traffic["queries"]))]
        params = {}
        for q in traffic["queries"]:
            drawn: Dict[str, str] = {}
            for spec in queries[q]["params"]:
                drawn.update(_draw(spec, rng))
            params[q] = drawn
        out.append([statement(queries[q], params[q], f"s{s}.{q}") for q in order])
    return out
