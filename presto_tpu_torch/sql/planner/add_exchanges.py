"""Exchange insertion: turn an optimized single-node plan into a distributed one.

The PyTorch port's copy of ``presto_tpu/sql/planner/add_exchanges.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of presto-main sql/planner/optimizations/AddExchanges.java:132,205-253 —
walk the plan deriving each subtree's data distribution and insert REMOTE
ExchangeNodes where an operator needs a different one:

- GROUP BY       -> partial agg -> REPARTITION(keys) -> final agg
  (global agg    -> partial agg -> GATHER -> final combine;
   distinct aggs -> exchange the INPUT rows, then single-step agg)
- hash/semi join -> REPARTITION both sides on the equi keys (broadcast of the
  filtering side for null-aware anti joins, whose has-null bit must be global;
  broadcast of the build side is the CBO's call — DetermineJoinDistributionType)
- cross join     -> BROADCAST the build side
- TopN/Sort/Limit/EnforceSingleRow/Output -> local pre-step where sound, then
  GATHER to the single root partition

Distributions (SystemPartitioningHandle.java:59-65 vocabulary):
  "source"          SOURCE_DISTRIBUTION: rows split arbitrarily across workers
  ("hash", names)   FIXED_HASH: co-partitioned by those symbol names
  "single"          SINGLE: all rows on worker 0
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ...ops.aggregates import resolve_aggregate
from ...ops.expressions import SymbolRef
from .plan import (AggregationNode, BROADCAST, EnforceSingleRowNode, ExchangeNode,
                   FilterNode, FINAL, GATHER, JoinNode, LimitNode, MERGE,
                   OutputNode, PARTIAL, PlanNode, ProjectNode, REPARTITION,
                   SemiJoinNode, SINGLE, SortNode, Symbol, SymbolAllocator,
                   TableScanNode, TopNNode, UnionNode, ValuesNode)

SOURCE_DIST = "source"
SINGLE_DIST = "single"


def _hash_dist(keys) -> Tuple[str, Tuple[str, ...]]:
    return ("hash", tuple(k.name for k in keys))


class ExchangePlanner:
    """One instance per query (shares the logical planner's symbol allocator)."""

    def __init__(self, symbols: SymbolAllocator, metadata=None, session=None,
                 n_workers: int = 8):
        self.symbols = symbols
        self.metadata = metadata
        self.session = session
        # actual mesh width: the broadcast-vs-repartition cost comparison
        # scales its network/memory terms with it
        self.n_workers = n_workers

    # ------------------------------------------------ join distribution CBO

    def _distribution_type(self) -> str:
        if self.session is None:
            return "PARTITIONED"
        return str(self.session.get("join_distribution_type", "AUTOMATIC")).upper()

    def _should_broadcast(self, build: PlanNode,
                          probe: Optional[PlanNode] = None) -> bool:
        """DetermineJoinDistributionType analogue, decided BY COST: replicate
        the build side when the broadcast's network+memory terms undercut
        repartitioning both sides (cost.cheaper_to_broadcast), with the
        session threshold acting as the per-worker HBM ceiling on replicated
        builds. PARTITIONED forces hash repartition; BROADCAST forces
        replication; AUTOMATIC decides from connector stats."""
        dist = self._distribution_type()
        if dist == "PARTITIONED":
            return False
        if dist == "BROADCAST":
            return True
        if self.metadata is None or self.session is None:
            return False
        from .cost import cheaper_to_broadcast
        from .optimizer import estimate_rows

        build_rows = estimate_rows(build, self.metadata)
        probe_rows = estimate_rows(probe, self.metadata) \
            if probe is not None else build_rows * 8
        limit = int(self.session.get("broadcast_join_threshold_rows"))
        return cheaper_to_broadcast(probe_rows, build_rows, self.n_workers,
                                    limit)

    def run(self, root: OutputNode) -> OutputNode:
        node, dist = self.visit(root.source)
        if dist != SINGLE_DIST:
            node = ExchangeNode(node, GATHER, [])
        return OutputNode(node, root.column_names, root.symbols)

    # ------------------------------------------------------------- dispatch

    def visit(self, node: PlanNode):
        m = getattr(self, f"visit_{type(node).__name__}", None)
        if m is not None:
            return m(node)
        # default: distribution-preserving pass-through (Filter, Limit handled
        # explicitly; anything unknown degrades safely to a gather at the root)
        return self._passthrough(node)

    def _passthrough(self, node: PlanNode):
        children = node.children()
        if len(children) != 1:
            raise NotImplementedError(
                f"exchange planning for {type(node).__name__}")
        child, dist = self.visit(children[0])
        return node.with_children([child]), dist

    # ---------------------------------------------------------------- leafs

    def visit_TableScanNode(self, node: TableScanNode):
        return node, SOURCE_DIST

    def visit_ValuesNode(self, node: ValuesNode):
        # literal rows materialize on the single partition only
        return node, SINGLE_DIST

    # ------------------------------------------------- distribution-preserving

    def visit_FilterNode(self, node: FilterNode):
        child, dist = self.visit(node.source)
        return FilterNode(child, node.predicate), dist

    def visit_ProjectNode(self, node: ProjectNode):
        child, dist = self.visit(node.source)
        if isinstance(dist, tuple):
            # hash distribution survives only if every key rides through an
            # identity assignment under its own name
            passed = {s.name for s, e in node.assignments
                      if isinstance(e, SymbolRef) and e.name == s.name}
            if not set(dist[1]) <= passed:
                dist = SOURCE_DIST
        return ProjectNode(child, node.assignments), dist

    # ---------------------------------------------------------- aggregation

    def visit_AggregationNode(self, node: AggregationNode):
        assert node.step == SINGLE, "exchange planning runs before step splits"
        child, dist = self.visit(node.source)
        keys = node.keys

        # already co-partitioned on a subset of the grouping keys (or single):
        # a local single-step aggregation is complete
        if dist == SINGLE_DIST or (
                isinstance(dist, tuple) and set(dist[1]) <= {k.name for k in keys}):
            return AggregationNode(child, keys, node.aggregations, SINGLE), dist

        has_distinct = any(c.distinct for _, c in node.aggregations)
        # non-splittable (vector-state sketch) aggregates cannot ride their
        # state through pages between PARTIAL and FINAL — single-phase them
        has_unsplittable = any(
            not resolve_aggregate(c.name, [a.type for a in c.args], c.distinct,
                                  c.params).splittable
            for _, c in node.aggregations)
        if has_distinct or has_unsplittable:
            # distinct/sketches need every row of a group on one worker:
            # exchange the input rows, then aggregate in one step
            if keys:
                ex = ExchangeNode(child, REPARTITION, list(keys))
                return (AggregationNode(ex, keys, node.aggregations, SINGLE),
                        _hash_dist(keys))
            ex = ExchangeNode(child, GATHER, [])
            return (AggregationNode(ex, keys, node.aggregations, SINGLE),
                    SINGLE_DIST)

        # two-phase: partial per worker, exchange compacted groups, final
        intermediates: List[List[Symbol]] = []
        for sym, call in node.aggregations:
            fn = resolve_aggregate(call.name, [a.type for a in call.args],
                                   call.distinct, call.params)
            intermediates.append(
                [self.symbols.new_symbol(f"{sym.name}$s{i}", it)
                 for i, it in enumerate(fn.intermediate_types)])
        partial = AggregationNode(child, keys, node.aggregations, PARTIAL,
                                  intermediates)
        if keys:
            ex = ExchangeNode(partial, REPARTITION, list(keys))
            final = AggregationNode(ex, keys, node.aggregations, FINAL,
                                    intermediates)
            return final, _hash_dist(keys)
        ex = ExchangeNode(partial, GATHER, [])
        final = AggregationNode(ex, keys, node.aggregations, FINAL, intermediates)
        return final, SINGLE_DIST

    # ---------------------------------------------------------------- joins

    def visit_JoinNode(self, node: JoinNode):
        left, ldist = self.visit(node.left)
        right, rdist = self.visit(node.right)
        # replicated build — probe rows never move, every worker holds the full
        # build table (BroadcastOutputBuffer / REPLICATED join). Mandatory for
        # cross joins (scalar subqueries); otherwise the CBO's call.
        # FULL joins can never broadcast: every worker would re-emit the whole
        # replicated build side as unmatched rows
        can_broadcast = node.type != "full"
        if not node.criteria or (can_broadcast and
                                 self._should_broadcast(node.right,
                                                        probe=node.left)):
            right = ExchangeNode(right, BROADCAST, [])
            return (JoinNode(node.type, left, right, node.criteria,
                             node.residual, node.output_symbols), ldist)
        lkeys = [l for l, _ in node.criteria]
        rkeys = [r for _, r in node.criteria]
        if not self._partitioned_on(ldist, lkeys):
            left = ExchangeNode(left, REPARTITION, lkeys)
        if not self._partitioned_on(rdist, rkeys):
            right = ExchangeNode(right, REPARTITION, rkeys)
        return (JoinNode(node.type, left, right, node.criteria, node.residual,
                         node.output_symbols), _hash_dist(lkeys))

    def visit_SemiJoinNode(self, node: SemiJoinNode):
        src, sdist = self.visit(node.source)
        filt, fdist = self.visit(node.filtering_source)
        # NOT IN must replicate the filtering side (any NULL build key anywhere
        # empties the result globally, so every worker needs the null bit);
        # otherwise broadcast is the CBO's call for small filtering sides.
        if (node.negated and node.null_aware) or \
                self._should_broadcast(node.filtering_source,
                                       probe=node.source):
            filt = ExchangeNode(filt, BROADCAST, [])
            return (SemiJoinNode(src, filt, node.source_key, node.filtering_key,
                                 node.mark, node.negated, node.null_aware,
                                 node.residual), sdist)
        if not self._partitioned_on(sdist, [node.source_key]):
            src = ExchangeNode(src, REPARTITION, [node.source_key])
        if not self._partitioned_on(fdist, [node.filtering_key]):
            filt = ExchangeNode(filt, REPARTITION, [node.filtering_key])
        return (SemiJoinNode(src, filt, node.source_key, node.filtering_key,
                             node.mark, node.negated, node.null_aware,
                             node.residual), _hash_dist([node.source_key]))

    @staticmethod
    def _partitioned_on(dist, keys: List[Symbol]) -> bool:
        """Is `dist` already a co-partitioning usable for these equi keys?

        Requires exact key-list match: the exchange routes on the hash of the
        FULL key tuple, so a subset partitioning does not co-locate matches the
        way it would under per-column hashing."""
        return isinstance(dist, tuple) and dist[1] == tuple(k.name for k in keys)

    # --------------------------------------------------- order / limit / misc

    def visit_TopNNode(self, node: TopNNode):
        child, dist = self.visit(node.source)
        if dist == SINGLE_DIST:
            return TopNNode(child, node.count, node.orderings), SINGLE_DIST
        partial = TopNNode(child, node.count, node.orderings)
        ex = ExchangeNode(partial, GATHER, [])
        return TopNNode(ex, node.count, node.orderings), SINGLE_DIST

    def visit_SortNode(self, node: SortNode):
        child, dist = self.visit(node.source)
        if dist == SINGLE_DIST:
            return SortNode(child, node.orderings), SINGLE_DIST
        # distributed ORDER BY (no LIMIT): range-repartition by the primary
        # sort key so worker w holds the w-th value range, then each worker
        # sorts its shard LOCALLY — worker-order concatenation at the final
        # GATHER is already the global order. The sort work distributes over
        # the mesh instead of funneling raw rows to one worker (the
        # reference's per-node sort + MergeOperator, re-designed so the
        # "merge" is free: range disjointness replaces the N-way heap).
        ex = ExchangeNode(child, MERGE, [], orderings=list(node.orderings))
        return SortNode(ex, node.orderings), "ordered"

    def visit_LimitNode(self, node: LimitNode):
        child, dist = self.visit(node.source)
        if dist == SINGLE_DIST:
            return LimitNode(child, node.count), SINGLE_DIST
        partial = LimitNode(child, node.count)
        ex = ExchangeNode(partial, GATHER, [])
        return LimitNode(ex, node.count), SINGLE_DIST

    def visit_EnforceSingleRowNode(self, node: EnforceSingleRowNode):
        child, dist = self.visit(node.source)
        if dist != SINGLE_DIST:
            child = ExchangeNode(child, GATHER, [])
        return EnforceSingleRowNode(child), SINGLE_DIST

    def visit_WindowNode(self, node):
        from .plan import WindowNode
        child, dist = self.visit(node.source)
        if node.partition_keys:
            # partition-wise independent: co-partition then evaluate locally
            if not self._partitioned_on(dist, node.partition_keys):
                child = ExchangeNode(child, REPARTITION,
                                     list(node.partition_keys))
            return (WindowNode(child, node.partition_keys, node.orderings,
                               node.calls), _hash_dist(node.partition_keys))
        # no PARTITION BY: the frame spans everything -> single worker
        if dist != SINGLE_DIST:
            child = ExchangeNode(child, GATHER, [])
        return (WindowNode(child, node.partition_keys, node.orderings,
                           node.calls), SINGLE_DIST)

    def visit_UnionNode(self, node: UnionNode):
        children = [self.visit(c)[0] for c in node.sources]
        return (UnionNode(children, node.symbols, node.symbol_mappings),
                SOURCE_DIST)


def add_exchanges(root: OutputNode, symbols: SymbolAllocator,
                  metadata=None, session=None,
                  n_workers: int = 8) -> OutputNode:
    return ExchangePlanner(symbols, metadata, session, n_workers).run(root)
