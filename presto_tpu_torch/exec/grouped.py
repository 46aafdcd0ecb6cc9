"""Grouped (lifespan) execution of the PyTorch port: run a plan once per
bucket of co-bucketed tables, so join tables and aggregation state hold
one bucket's data instead of the whole table's.

Counterpart of ``presto_tpu/exec/grouped.py``. The runner executes the
whole local plan once per bucket, its scans restricted to that bucket's
splits (``LocalExecutionPlanner(bucket_filter=b)``), each bucket with its
own memory reservation released before the next starts, and merges the
buckets' rows at the root (``merge_rows``): concatenation, then a host
re-sort, TopN or limit where the plan's spine orders or truncates (the
top N of a union is the top N of the buckets' top Ns).

``analyze_grouped`` decides whether a plan may group. It may iff
- every TableScan reads a bucketed table, all with the same bucket count
  (one engine, one bucket hash, so equal counts align);
- every join's criteria pair the bucket columns of its two sides (rows
  that join lie in the same bucket on both sides);
- every aggregation and window groups by (at least) some table's bucket
  columns, so no group spans two buckets;
- the spine above the heavy nodes is only Project, Sort, TopN and Limit,
  whose effect the merge re-establishes over the merged rows.
Anything else rejects grouping; the ungrouped path is always correct. A
scan of a connector that is not bucketed rejects before its splits are
listed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..ops.expressions import SymbolRef
from ..spi.connector import Constraint
from ..sql.planner.plan import (AggregationNode, FilterNode, JoinNode, LimitNode, Ordering,
                                OutputNode, PlanNode, ProjectNode, SortNode, TableScanNode,
                                TopNNode, WindowNode)


@dataclasses.dataclass
class GroupedExecution:
    bucket_count: int
    # the merge of the buckets' rows, applied root-down: orderings as
    # (output column index, descending, nulls_first)
    orderings: List[Tuple[int, bool, bool]]
    limit: Optional[int]


# ---------------------------------------------------------------------------
# the alignment walk

def _scan_bucket_tuple(node: TableScanNode, metadata) -> Optional[Tuple]:
    """-> (bucket_count, the symbol names carrying the table's bucket
    columns in ``bucketed_by`` order), or None if the table is not bucketed,
    a bucket column is not scanned, or a split lacks a valid bucket id."""
    conn = metadata.connector(node.table.connector_id)
    provider = conn.node_partitioning_provider()
    count = provider.bucket_count(node.table)
    if not count:
        return None
    bucket_cols = provider.bucket_columns(node.table)
    if not bucket_cols:
        return None
    by_col = {c.name: s.name for s, c in node.assignments}
    syms = tuple(by_col.get(c) for c in bucket_cols)
    if any(s is None for s in syms):
        return None
    # a bucketed table can still hold files written outside the engine's
    # bucket naming
    splits = conn.split_manager().get_splits(node.table, Constraint.all(), 8)
    if any(s.bucket is None or not (0 <= s.bucket < count) for s in splits):
        return None
    return count, syms


class _Reject(Exception):
    pass


def _walk(node: PlanNode, metadata, counts: List[int]) -> List[Tuple[str, ...]]:
    """-> the symbol tuples (by name) that carry bucket alignment at this
    node's output. An empty list: the subtree is bucket-partitioned but no
    carrier survives projection, which only a consumer that needs to see
    them (join criteria, grouping keys, window partition) rejects. Raises
    _Reject when the subtree cannot group at all."""
    if isinstance(node, TableScanNode):
        got = _scan_bucket_tuple(node, metadata)
        if got is None:
            raise _Reject()
        count, syms = got
        counts.append(count)
        return [syms]

    if isinstance(node, (FilterNode, SortNode)):
        # a filter, or an ordering within a bucket, truncates nothing
        return _walk(node.source, metadata, counts)

    if isinstance(node, (TopNNode, LimitNode)):
        # a truncation below the spine would apply per bucket, not globally
        raise _Reject()

    if isinstance(node, ProjectNode):
        tuples = _walk(node.source, metadata, counts)
        renames: Dict[str, List[str]] = {}
        for s, e in node.assignments:
            if isinstance(e, SymbolRef):
                renames.setdefault(e.name, []).append(s.name)
        return [tuple(renames[n][0] for n in t) for t in tuples
                if all(n in renames for n in t)]

    if isinstance(node, JoinNode):
        if node.type not in ("inner", "left"):
            raise _Reject()
        lt = _walk(node.left, metadata, counts)
        rt = _walk(node.right, metadata, counts)
        pairs = {(l.name, r.name) for l, r in node.criteria}
        if not any(len(a) == len(b) and all((x, y) in pairs for x, y in zip(a, b))
                   for a in lt for b in rt):
            raise _Reject()
        out_names = {s.name for s in node.outputs()}
        # a LEFT join null-extends its build side, whose key columns carry
        # NULL on unmatched rows in every bucket: only the probe side's
        # tuples still partition the output
        carriers = lt if node.type == "left" else lt + rt
        return [t for t in carriers if all(n in out_names for n in t)]

    if isinstance(node, AggregationNode):
        tuples = _walk(node.source, metadata, counts)
        keys = {s.name for s in node.keys}
        kept = [t for t in tuples if set(t) <= keys]
        if not kept:
            raise _Reject()
        return kept

    if isinstance(node, WindowNode):
        tuples = _walk(node.source, metadata, counts)
        part = {s.name for s in node.partition_keys}
        if not any(set(t) <= part for t in tuples):
            raise _Reject()
        return tuples

    raise _Reject()


def analyze_grouped(plan: OutputNode, metadata, session) -> Optional[GroupedExecution]:
    """Whether ``plan`` can run one bucket at a time, and how to merge the
    buckets' rows. None = run it ungrouped."""
    if not session.get("grouped_execution"):
        return None
    # the spine: nodes above the first heavy node, whose effect the merge
    # re-establishes. Project renames; Sort, TopN and Limit merge.
    orderings: List[Ordering] = []
    limit: Optional[int] = None
    spine = plan.source
    renames: Dict[str, str] = {s.name: s.name for s in plan.symbols}
    while True:
        if isinstance(spine, ProjectNode):
            renames = {e.name: renames[s.name] for s, e in spine.assignments
                       if s.name in renames and isinstance(e, SymbolRef)}
            spine = spine.source
        elif isinstance(spine, TopNNode):
            if orderings or limit is not None:
                return None
            orderings = list(spine.orderings)
            limit = spine.count
            spine = spine.source
        elif isinstance(spine, LimitNode):
            if limit is not None:
                return None
            limit = spine.count
            spine = spine.source
        elif isinstance(spine, SortNode):
            if orderings:
                return None
            orderings = list(spine.orderings)
            spine = spine.source
        else:
            break
    # the ordering symbols must reach the root output to re-sort there
    out_index: Dict[str, int] = {}
    for i, s in enumerate(plan.symbols):
        out_index.setdefault(s.name, i)
    merged: List[Tuple[int, bool, bool]] = []
    for o in orderings:
        name = renames.get(o.symbol.name)
        # the sort may run below the final projection: a spine rename of the
        # symbol, or the symbol itself surviving to the root
        if name is None and o.symbol.name in out_index:
            name = o.symbol.name
        if name is None or name not in out_index:
            return None
        merged.append((out_index[name], o.descending, o.nulls_first))

    counts: List[int] = []
    try:
        _walk(spine, metadata, counts)
    except _Reject:
        return None
    if not counts or len(set(counts)) != 1 or counts[0] < 2:
        return None
    return GroupedExecution(counts[0], merged, limit)


# ---------------------------------------------------------------------------
# the merge of the buckets' rows

def merge_rows(results: Sequence[List[list]], g: GroupedExecution) -> List[list]:
    """Concatenate the buckets' rows, then re-apply the ordering and limit."""
    rows = [r for res in results for r in res]
    # stable sorts, minor key first; a NULL sorts by nulls_first alone (not
    # flipped by descending), under a presence flag so that values never
    # compare with None
    for idx, desc, nulls_first in reversed(g.orderings):
        def key(row, _i=idx, _d=desc, _nf=nulls_first):
            v = row[_i]
            if v is None:
                return (0 if _nf else 1, _NULL)
            return (1 if _nf else 0, _Neg(v) if _d else _Cmp(v))
        rows.sort(key=key)
    if g.limit is not None:
        rows = rows[:g.limit]
    return rows


class _Cmp:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return self.v < other.v

    def __eq__(self, other):
        return self.v == other.v


class _Neg(_Cmp):
    def __lt__(self, other):
        return other.v < self.v


class _Null:
    """Equal to itself; compared only with other ``_Null``s (the presence
    flag keeps it from real values)."""

    def __lt__(self, other):
        return False

    def __eq__(self, other):
        return isinstance(other, _Null)


_NULL = _Null()
