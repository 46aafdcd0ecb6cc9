"""Plan fragmentation: cut the distributed plan at REMOTE exchanges.

The PyTorch port's copy of ``presto_tpu/sql/planner/fragmenter.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of presto-main sql/planner/PlanFragmenter.java:123 (createSubPlans
:142): each ExchangeNode becomes a fragment boundary — the exchange's subtree
becomes a producer fragment whose output partitioning is the exchange's kind,
and the consumer side sees a RemoteSourceNode. Fragments execute bottom-up;
SINGLE fragments run on worker 0 only (one task, like the reference's SINGLE
distribution stages).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .plan import (ExchangeNode, GATHER, OutputNode, PlanNode, RemoteSourceNode,
                   Symbol)

SOURCE_PART = "source"      # splits scattered over all workers
HASH_PART = "hash"          # input arrives repartitioned; runs on all workers
SINGLE_PART = "single"      # runs on worker 0 only


@dataclasses.dataclass
class Fragment:
    id: int
    root: PlanNode                    # subtree with RemoteSourceNodes at cuts
    partitioning: str                 # how THIS fragment executes
    # how this fragment's output is routed to its consumer (None for the root):
    output_kind: Optional[str] = None  # REPARTITION | BROADCAST | GATHER | MERGE
    output_keys: Optional[List[Symbol]] = None
    # MERGE (range) routing: the ORDER BY spec driving the splitters
    output_orderings: Optional[list] = None


@dataclasses.dataclass
class SubPlan:
    fragments: List[Fragment]         # topological order, root fragment LAST
    root_fragment: Fragment
    column_names: List[str]
    output_symbols: List[Symbol]


class PlanFragmenter:
    def __init__(self):
        self._fragments: List[Fragment] = []

    def fragment(self, root: OutputNode) -> SubPlan:
        body = self._cut(root.source)
        root_frag = Fragment(len(self._fragments), body, SINGLE_PART)
        self._fragments.append(root_frag)
        return SubPlan(self._fragments, root_frag, root.column_names,
                       root.symbols)

    def _cut(self, node: PlanNode) -> PlanNode:
        if isinstance(node, ExchangeNode):
            child = self._cut(node.source)
            frag = Fragment(
                id=len(self._fragments),
                root=child,
                partitioning=self._partitioning_of(child),
                output_kind=node.kind,
                output_keys=list(node.keys),
                output_orderings=list(node.orderings or ()))
            self._fragments.append(frag)
            return RemoteSourceNode(frag.id, list(node.outputs()))
        children = [self._cut(c) for c in node.children()]
        return node.with_children(children) if children else node

    def _partitioning_of(self, body: PlanNode) -> str:
        """A fragment whose inputs all arrive via a GATHER (or that has no
        remote/scan inputs at all, e.g. VALUES) is a single-task fragment."""
        sources: List[PlanNode] = []

        def walk(n: PlanNode):
            if isinstance(n, RemoteSourceNode):
                sources.append(n)
                return
            if not n.children():
                sources.append(n)
                return
            for c in n.children():
                walk(c)
        walk(body)
        remote = [s for s in sources if isinstance(s, RemoteSourceNode)]
        scans = [s for s in sources if not isinstance(s, RemoteSourceNode)]
        has_table_scan = any(type(s).__name__ == "TableScanNode" for s in scans)
        if has_table_scan:
            return SOURCE_PART
        if remote and all(self._fragments[r.fragment_id].output_kind == GATHER
                          for r in remote):
            return SINGLE_PART
        if remote:
            return HASH_PART
        return SINGLE_PART  # ValuesNode-only fragments


def fragment_plan(root: OutputNode) -> SubPlan:
    return PlanFragmenter().fragment(root)
