"""Fused pipeline segments: one call per page through a chain of page-local operators.

Counterpart of ``presto_tpu/ops/fused_segment.py``. The driver hands each
page from operator to operator, with the host's bookkeeping at every
boundary. For a chain of page-local operators (filter/project, the
unique-build or exact-key join probe, then optionally a hash aggregation's
per-page contribution or a TopN buffer merge) each stage is a pure
``page -> page`` (or ``page -> contribution``) function, and the local
planner (``_fuse_pipelines``, session property ``segment_fusion``) replaces
the run with one ``FusedSegmentOperatorFactory``.

- Mid stages: ``PageProcessor._process`` and ``hash_join.apply_probe_stage``;
  a terminal: ``_AggTerminal`` (the builder's sort partial, its raw rows in
  defer mode, or the DIRECT/GLOBAL state) or ``_TopNTerminal``. Join
  builds, expanding probes, sorts and the sink are barriers.
- The build side's tensors and the terminal's state are arguments of the
  composed function, never captured in it; the composition is cached in
  ``utils/kernel_cache`` under every stage's config and the input layout's
  dictionary versions, so repeated queries reuse it.
- The reference traces the composition into one jitted XLA kernel. The
  port calls the composed Python function once per input page, eagerly:
  each stage still launches its own device work (a PALLAS probe stage
  launches the probe kernel), and the segment saves the host work between
  operators. ``compiles`` counts compositions (``_install`` cache misses),
  ``dispatches`` the calls, one per page.
- A grouped terminal computes the sort partial, as in the reference: a
  fused grouping does not use the insert kernel, whatever strategy the
  builder picked for its own pages.
- The factory forwards the query's memory and disk tier to its terminal:
  after each absorbed page the terminal's builder accounts its bytes, and
  spills to host RAM (and on to disk) when the pool is over its revoke
  target.

Per segment, ``describe()`` gives the operators, dispatches, compiles and
the probe-kernel launches made inside the segment (the port's own
``probe_launches``); the runner rolls them into
``QueryResult.stats["segments"]``, and ``segments.dispatches`` and
``segments.compiles`` count them in ``utils/metrics``. Each dispatch's
wall goes into the ``segments.page_dispatch_s`` histogram and, while a
trace records, a ``segment`` span named after the segment; each
composition is a ``segment`` instant ``compile <name>``.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..block import Page
from ..utils import kernel_cache as kc
from ..utils import trace
from ..utils.metrics import METRICS
from . import pallas_hash
from .filter_project import FilterProjectOperatorFactory
from .hash_agg import (DirectAggregationBuilder, GlobalAggregationBuilder,
                       GroupedAggregationBuilder, HashAggregationOperatorFactory,
                       _builder_key)
from .hash_join import (LookupJoinOperatorFactory, apply_probe_stage, probe_plan_fusible,
                        probe_stage_aux, probe_stage_cfg, probe_stage_key)
from .operator import Operator, OperatorContext, OperatorFactory, timed
from .topn import TopNOperatorFactory, topn_merge_stage


def mid_stage_fusible(f) -> bool:
    """Plan time: can ``f`` run as a page-local mid stage of a segment?"""
    if isinstance(f, FilterProjectOperatorFactory):
        return True
    if isinstance(f, LookupJoinOperatorFactory):
        return probe_plan_fusible(f.join_type, f.probe_key_channels, f.unique_build,
                                  f.filter_fn)
    return False


def terminal_stage_fusible(f) -> bool:
    """Plan time: can ``f`` end a segment with a per-page contribution? A
    collecting aggregation cannot: it keeps raw rows, no per-page partial."""
    if isinstance(f, HashAggregationOperatorFactory):
        from .collect_agg import COLLECT_NAMES

        return not any(c.function.name in COLLECT_NAMES for c in f.calls)
    return isinstance(f, TopNOperatorFactory)


class FusedSegmentOperatorFactory(OperatorFactory):
    """One per fused segment: the member factories in chain order and the
    segment's dispatch, composition and probe-launch counts."""

    def __init__(self, operator_id: int, mid_factories: List, terminal_factory=None,
                 output_types: Optional[List] = None):
        members = list(mid_factories) + (
            [terminal_factory] if terminal_factory is not None else [])
        super().__init__(operator_id, "FusedSegment[" + "+".join(m.name for m in members) + "]")
        self.mid_factories = list(mid_factories)
        self.terminal_factory = terminal_factory
        self.member_names = [m.name for m in members]
        self.output_types = list(output_types or [])
        self._lock = threading.Lock()
        self.pages = 0           # calls of the composed function, one per input page
        self.compiles = 0        # compositions this factory made (cache misses)
        self.probe_launches = 0  # probe-kernel launches inside the segment

    def create_operator(self, worker: int = 0) -> "FusedSegmentOperator":
        tf = self.terminal_factory
        if tf is not None:
            # the terminal's builder is the segment's only revocable state
            tf.memory_ctx = self.memory_ctx
            tf.revoke_check = self.revoke_check
            tf.spill_manager = self.spill_manager
            tf.devices = self.devices
        return FusedSegmentOperator(self.context(worker), self)

    def note_pages(self, n: int, probe_launches: int) -> None:
        with self._lock:
            self.pages += n
            self.probe_launches += probe_launches
        METRICS.count("segments.dispatches", n)

    def note_compile(self) -> None:
        with self._lock:
            self.compiles += 1
        METRICS.count("segments.compiles")
        trace.instant(trace.SEGMENT, f"compile {self.name}")

    def describe(self) -> dict:
        with self._lock:
            return {"operators": list(self.member_names), "dispatches": self.pages,
                    "compiles": self.compiles, "probe_launches": self.probe_launches}


class _AggTerminal:
    """Terminal around a real HashAggregationOperator: the composed function
    computes the page's contribution, which this absorbs into the
    operator's builder (its state and result building unchanged)."""

    def __init__(self, factory: HashAggregationOperatorFactory, worker: int):
        self.op = factory.create_operator(worker)
        self.builder = self.op.builder
        if isinstance(self.builder, GroupedAggregationBuilder):
            self.mode = "grouped"
        elif isinstance(self.builder, DirectAggregationBuilder):
            self.mode = "direct"
        elif isinstance(self.builder, GlobalAggregationBuilder):
            self.mode = "global"
        else:
            raise TypeError(f"no fused terminal for {type(self.builder).__name__}")

    def variant(self) -> str:
        """Changes when the builder turns to defer mode (partial -> raw): the
        operator then composes its segment anew."""
        if self.mode == "grouped" and self.builder.defer_raw():
            return "raw"
        return "partial"

    def cache_key(self, input_dicts) -> tuple:
        tag = {"grouped": "sort", "direct": "direct", "global": "global"}[self.mode]
        return _builder_key(tag, self.builder, input_dicts) + (self.variant(),)

    def stage_plan(self):
        b = self.builder
        if self.mode == "grouped":
            if b.defer_raw():
                return ("agg_raw", b._page_raw)
            return ("agg_partial", b._page_partial)
        if self.mode == "direct":
            return ("agg_state", lambda page, st: b._accumulate(page, *st))
        return ("agg_state", lambda page, st: b._accumulate(page, st))

    def state(self):
        if self.mode == "grouped":
            return ()
        return self.builder.init_state()

    def out_groups(self, capacity: int) -> int:
        if self.mode == "grouped" and not self.builder.defer_raw():
            return self.builder.page_out_groups(capacity)
        return 0

    def absorb(self, result, capacity: int, out_groups: int) -> bool:
        b = self.builder
        if self.mode != "grouped":
            b.absorb_state(result)
            ok = True
        elif b.defer_raw() and out_groups == 0:
            b.absorb_raw(result, capacity)
            ok = True
        else:
            ok = b.absorb_partial(result, capacity, out_groups)
        if getattr(b, "memory_bytes", None) is not None:
            self.op.context.update_revocable(b.memory_bytes(), self.op.start_memory_revoke)
        return ok


class _TopNTerminal:
    """Terminal around a real TopNOperator: the composed function merges the
    page into the N-row buffer, which it takes as an argument."""

    def __init__(self, factory: TopNOperatorFactory, worker: int):
        self.op = factory.create_operator(worker)

    def variant(self) -> str:
        return "topn"

    def cache_key(self, input_dicts) -> tuple:
        op = self.op
        return ("topn", tuple(op.orders), op.n, tuple(t.name for t in op.output_types),
                tuple(kc.dict_key(d) for d in input_dicts))

    def stage_plan(self):
        orders, n = self.op.orders, self.op.n
        return ("topn", lambda page, st: topn_merge_stage(page, st, orders, n))

    def state(self):
        return self.op._buffer  # None before the first page

    def out_groups(self, capacity: int) -> int:
        return 0

    def absorb(self, result, capacity: int, out_groups: int) -> bool:
        self.op._buffer = result
        return True


def _compose(mid_plan, tkind: str):
    """-> f(page, auxes, state, out_groups, terminal): the whole segment as
    one function. The terminal's step (a bound method of one operator's
    builder) comes with each call: the process-wide cache must not keep an
    operator's builder, and its state, alive past its query."""

    def fn(page, auxes, state, out_groups, terminal):
        ai = 0
        for kind, obj in mid_plan:
            if kind == "proc":
                page = obj._process(page)
            else:  # probe
                page = apply_probe_stage(page, auxes[ai], obj)
                ai += 1
        if tkind == "none":
            return page
        if tkind == "agg_partial":
            return terminal(page, out_groups)
        if tkind == "agg_raw":
            return terminal(page)
        return terminal(page, state)  # agg_state | topn

    return fn


class FusedSegmentOperator(Operator):
    """Runs the whole segment as one call of the composed function per page."""

    def __init__(self, context: OperatorContext, factory: FusedSegmentOperatorFactory):
        super().__init__(context)
        self.f = factory
        # per-stage run-time slots in chain order; a probe stage takes its
        # lookup source through is_blocked, as LookupJoinOperator does
        self._stages = [{"factory": mf, "source": None, "aux": None}
                        for mf in factory.mid_factories]
        tf = factory.terminal_factory
        self._terminal = None
        if isinstance(tf, HashAggregationOperatorFactory):
            self._terminal = _AggTerminal(tf, context.worker)
        elif isinstance(tf, TopNOperatorFactory):
            self._terminal = _TopNTerminal(tf, context.worker)
        self._pending: Optional[Page] = None
        self._fused = None
        self._tstep = None  # the terminal's step, handed to the composed function
        self._in_key = None
        self._tvariant = None
        self._pages = 0
        self._probe_launches = 0

    @property
    def output_types(self) -> List:
        return self.f.output_types

    def is_blocked(self):
        for st in self._stages:
            mf = st["factory"]
            if not isinstance(mf, LookupJoinOperatorFactory) or st["source"] is not None:
                continue
            lf = mf.lookup_factory
            w = self.context.worker
            if lf.done(w):
                st["source"] = lf.get(w)
                continue
            return lambda: lf.done(w)
        return None

    def needs_input(self) -> bool:
        if self._finishing:
            return False
        if self._terminal is None:
            return self._pending is None
        return True

    def _install(self, page: Page, in_key) -> None:
        """Compose (or fetch) the segment for the live input layout. A
        processor whose layout drifted is rebuilt first, as its ``__call__``
        would; dictionary versions are part of the key."""
        self._in_key = in_key
        cur_types = [b.type for b in page.blocks]
        cur_dicts = [b.dictionary for b in page.blocks]
        mid_plan, keys = [], []
        for st in self._stages:
            mf = st["factory"]
            if isinstance(mf, FilterProjectOperatorFactory):
                proc = mf.processor
                proc.ensure_layout(cur_types, cur_dicts)
                mid_plan.append(("proc", proc))
                keys.append(proc.cache_key)
                cur_types = list(proc.output_types_)
                cur_dicts = list(proc.output_dicts)
                continue
            src = st["source"]
            if src is None:
                raise RuntimeError("a probe stage ran before its build finished")
            if not src.exact_keys:
                raise RuntimeError("a fused probe stage needs exact keys")
            cfg = probe_stage_cfg(mf, src)
            st["aux"] = probe_stage_aux(src)
            mid_plan.append(("probe", cfg))
            keys.append(probe_stage_key(cfg))
            cur_types = [cur_types[c] for c in cfg.probe_output_channels] + \
                [t for t, _ in cfg.payload_meta]
            cur_dicts = [cur_dicts[c] for c in cfg.probe_output_channels] + \
                [d for _, d in cfg.payload_meta]
        if self._terminal is None:
            tkind, self._tstep, tkey, self._tvariant = "none", None, ("none",), None
        else:
            tkind, self._tstep = self._terminal.stage_plan()
            tkey = self._terminal.cache_key(cur_dicts)
            self._tvariant = self._terminal.variant()
        key = ("fused-segment", page.device.type, in_key, tuple(keys), tkey)

        def make():
            self.f.note_compile()
            return _compose(mid_plan, tkind)

        self._fused = kc.get_or_install(key, make)

    def add_input(self, page: Page) -> None:
        t0 = time.perf_counter_ns()
        self.context.record_input(page, page.capacity)
        in_key = kc.layout_key([b.type for b in page.blocks],
                               [b.dictionary for b in page.blocks])
        t = self._terminal
        if self._fused is None or in_key != self._in_key or \
                (t is not None and t.variant() != self._tvariant):
            self._install(page, in_key)
        auxes = tuple(st["aux"] for st in self._stages if st["aux"] is not None)
        self._pages += 1
        launches = pallas_hash.thread_launches(pallas_hash.probe_table)
        try:
            if t is None:
                self._pending = self._fused(page, auxes, None, 0, None)
                return
            og = t.out_groups(page.capacity)
            if not t.absorb(self._fused(page, auxes, t.state(), og, self._tstep),
                            page.capacity, og):
                # the builder's shrunken partial overflowed on this page and
                # reset to full size: recompute at the new size
                og = t.out_groups(page.capacity)
                if not t.absorb(self._fused(page, auxes, t.state(), og, self._tstep),
                                page.capacity, og):
                    raise AssertionError("a full-size partial cannot overflow")
        finally:
            self._probe_launches += \
                pallas_hash.thread_launches(pallas_hash.probe_table) - launches
            dt = time.perf_counter_ns() - t0
            self.context.stats.add_input_ns += dt
            METRICS.histogram("segments.page_dispatch_s", dt / 1e9)
            trace.record(trace.SEGMENT, self.f.name, t0, dt,
                         {"rows": page.capacity} if trace.active() is not None else None)

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._terminal is None:
            out, self._pending = self._pending, None
        else:
            out = self._terminal.op.get_output()
        if out is not None:
            self.context.record_output(out, out.capacity)
        return out

    def finish(self) -> None:
        super().finish()
        if self._terminal is not None:
            self._terminal.op.finish()

    def is_finished(self) -> bool:
        if self._terminal is not None:
            return self._terminal.op.is_finished()
        return self._finishing and self._pending is None

    def close(self) -> None:
        if self._pages:
            self.f.note_pages(self._pages, self._probe_launches)
            self._pages = self._probe_launches = 0
        if self._terminal is not None:
            self._terminal.op.close()
        super().close()
