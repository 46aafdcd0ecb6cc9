"""Verifier of the PyTorch port: replay a query suite on two engines and
compare per-column checksums (``presto_tpu/verifier.py``).

A control and a test engine each run every query of a suite (the TPC-H or
TPC-DS texts); their results are compared column by column, without
regard to row order: exact columns as a multiset digest, floating columns
as (count, sum, NaN count) within a tolerance. The control is the sqlite
oracle over the same generated data (``--mode oracle``) or the
single-node engine with the multi-worker engine as test
(``--mode distributed``). Either side can be any callable that returns
rows, such as a ``StatementClient`` against a server.

Run: python -m presto_tpu_torch.verifier [--suite tpch|tpcds]
    [--mode oracle|distributed] [--device cuda|cpu]
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import re
from typing import Callable, Dict, List, Optional, Sequence

MATCH, MISMATCH = "MATCH", "MISMATCH"
CONTROL_ERROR, TEST_ERROR = "CONTROL_ERROR", "TEST_ERROR"


@dataclasses.dataclass
class ColumnChecksum:
    count: int
    null_count: int
    digest: Optional[int] = None      # exact columns: order-independent hash
    total: Optional[float] = None     # float columns: sum of finite values
    nan_count: int = 0

    def matches(self, other: "ColumnChecksum", rel_tol: float) -> bool:
        if (self.count, self.null_count, self.nan_count) != \
                (other.count, other.null_count, other.nan_count):
            return False
        if self.digest is not None or other.digest is not None:
            return self.digest == other.digest
        a, b = self.total or 0.0, other.total or 0.0
        return math.isclose(a, b, rel_tol=rel_tol, abs_tol=1e-6)


@dataclasses.dataclass
class VerificationResult:
    name: str
    status: str
    detail: str = ""


def _normalize(v):
    from .utils.testing import normalize_value

    v = normalize_value(v)
    # integral floats canonicalize to int so "3" (control) and "3.0" (test)
    # land in the same exact-digest column classification
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v


def column_checksums(rows: Sequence[Sequence],
                     float_round: int = 4) -> List[ColumnChecksum]:
    """Per-column order-independent checksums (ChecksumValidator analogue)."""
    if not rows:
        return []
    ncols = len(rows[0])
    out = []
    for c in range(ncols):
        vals = [_normalize(r[c]) for r in rows]
        nulls = sum(v is None for v in vals)
        present = [v for v in vals if v is not None]
        is_float = any(isinstance(v, float) for v in present)
        if is_float:
            nan = sum(1 for v in present
                      if isinstance(v, float) and math.isnan(v))
            finite = [float(v) for v in present
                      if not (isinstance(v, float) and math.isnan(v))]
            out.append(ColumnChecksum(len(vals), nulls,
                                      total=float(sum(finite)),
                                      nan_count=nan))
        else:
            digest = 0
            for v in present:
                h = hashlib.blake2b(repr(v).encode(),
                                    digest_size=8).digest()
                digest = (digest + int.from_bytes(h, "little")) % (1 << 64)
            out.append(ColumnChecksum(len(vals), nulls, digest=digest))
    return out


class Verifier:
    """Run queries on control+test, compare checksums (DataVerification)."""

    def __init__(self, control: Callable[[str], Sequence[Sequence]],
                 test: Callable[[str], Sequence[Sequence]],
                 test_sql_rewrite: Optional[Callable[[str], str]] = None,
                 rel_tol: float = 1e-4):
        self.control = control
        self.test = test
        self.rewrite = test_sql_rewrite or (lambda s: s)
        self.rel_tol = rel_tol

    def verify(self, name: str, sql: str) -> VerificationResult:
        try:
            expected = self.control(self.rewrite(sql))
        except Exception as e:  # noqa: BLE001 - reported, not raised
            return VerificationResult(name, CONTROL_ERROR, repr(e)[:300])
        try:
            actual = self.test(sql)
        except Exception as e:  # noqa: BLE001
            return VerificationResult(name, TEST_ERROR, repr(e)[:300])
        ec = column_checksums(expected)
        ac = column_checksums(actual)
        if len(ec) != len(ac):
            return VerificationResult(
                name, MISMATCH, f"column count {len(ac)} vs {len(ec)}")
        for i, (a, e) in enumerate(zip(ac, ec)):
            if not a.matches(e, self.rel_tol):
                return VerificationResult(
                    name, MISMATCH, f"column {i}: test={a} control={e}")
        return VerificationResult(name, MATCH)

    def run(self, queries: Dict[str, str]) -> List[VerificationResult]:
        return [self.verify(name, sql) for name, sql in queries.items()]


# ---------------------------------------------------------------------------
# suites + control engines
# ---------------------------------------------------------------------------

def tpch_sql_to_sqlite(sql: str) -> str:
    """Engine SQL -> sqlite dialect (dates as epoch-day ints, folded decimal
    literal arithmetic — sqlite floats would mis-bucket 0.06+0.01)."""
    import datetime
    from decimal import Decimal

    def days(y, m, d):
        return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days

    def date_arith(m):
        y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
        base = datetime.date(y, mo, d)
        op, n, unit = m.group(4), int(m.group(5)), m.group(6).lower()
        n = n if op == "+" else -n
        if unit == "day":
            out = base + datetime.timedelta(days=n)
        elif unit == "month":
            k = base.month - 1 + n
            out = base.replace(year=base.year + k // 12, month=k % 12 + 1)
        else:
            out = base.replace(year=base.year + n)
        return str((out - datetime.date(1970, 1, 1)).days)

    sql = re.sub(r"date\s+'(\d+)-(\d+)-(\d+)'\s*([+-])\s*interval\s+'(\d+)'"
                 r"\s+(day|month|year)", date_arith, sql, flags=re.I)
    sql = re.sub(r"date\s+'(\d+)-(\d+)-(\d+)'",
                 lambda m: str(days(int(m.group(1)), int(m.group(2)),
                                    int(m.group(3)))), sql, flags=re.I)
    sql = re.sub(r"extract\s*\(\s*year\s+from\s+([a-z_][a-z0-9_.]*)\s*\)",
                 r"CAST(strftime('%Y', (\1)*86400.0, 'unixepoch') AS INTEGER)",
                 sql, flags=re.I)

    def dec_fold(m):
        a, op, b = Decimal(m.group(1)), m.group(2), Decimal(m.group(3))
        return str(a + b if op == "+" else a - b)
    return re.sub(r"(\d+\.\d+)\s*([+-])\s*(\d+\.\d+)", dec_fold, sql)


def make_oracle_verifier(schema_sf: float = 0.01, device="cuda") -> Verifier:
    """The sqlite oracle at ``schema_sf`` (0.01 is ``tiny``) as control,
    the engine on ``device`` as test."""
    from .metadata import Session
    from .runner import LocalQueryRunner
    from .utils.testing import SqliteOracle

    runner = LocalQueryRunner(session=Session(catalog="tpch", schema="tiny"),
                              device=device)
    oracle = SqliteOracle()
    oracle.load_tpch(schema_sf, ["region", "nation", "supplier", "part",
                                 "partsupp", "customer", "orders", "lineitem"])
    return Verifier(control=oracle.query,
                    test=lambda s: runner.execute(s).rows,
                    test_sql_rewrite=tpch_sql_to_sqlite)


def make_distributed_verifier(device="cuda") -> Verifier:
    """The single-node engine as control, four logical workers of
    ``device`` as test."""
    from . import resolve_device
    from .parallel.mesh import MeshContext
    from .parallel.runner import DistributedQueryRunner
    from .runner import LocalQueryRunner

    dev = resolve_device(device)
    local = LocalQueryRunner(device=dev)
    dist = DistributedQueryRunner(MeshContext([dev] * 4), device=dev)
    return Verifier(control=lambda s: local.execute(s).rows,
                    test=lambda s: dist.execute(s).rows)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="presto-tpu-torch-verifier")
    ap.add_argument("--suite", default="tpch", choices=["tpch", "tpcds"])
    ap.add_argument("--mode", default="oracle",
                    choices=["oracle", "distributed"])
    ap.add_argument("--queries", default=None,
                    help="comma-separated query ids (default: whole suite)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (the default; fails "
                         "without CUDA) or cpu")
    args = ap.parse_args(argv)

    if args.suite == "tpch":
        from .models.tpch_sql import QUERIES
    else:
        from .models.tpcds_sql import QUERIES
    ids = [int(q) for q in args.queries.split(",")] if args.queries \
        else sorted(QUERIES)
    suite = {f"q{i}": QUERIES[i] for i in ids}

    if args.mode == "oracle":
        if args.suite != "tpch":
            raise SystemExit("oracle mode supports --suite tpch")
        v = make_oracle_verifier(device=args.device)
    else:
        v = make_distributed_verifier(device=args.device)
    results = v.run(suite)
    bad = 0
    for r in results:
        print(f"{r.name:>6}  {r.status:<14} {r.detail}")  # prestocheck: ignore[print-hygiene] - verifier CLI renderer
        bad += r.status != MATCH
    print(f"{len(results) - bad}/{len(results)} MATCH")  # prestocheck: ignore[print-hygiene] - verifier CLI renderer
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
