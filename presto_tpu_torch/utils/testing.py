"""Page sink of the PyTorch port (``presto_tpu/utils/testing.py``
``PageConsumerOperator``/``PageConsumerFactory``).

The sink is also a UNION branch's buffer: the planner's replay scan reads
``pages_for(worker)`` once every consumer of that worker
(``consumers_by_worker``) has finished, and the barrier mesh runner routes
each worker's pages from it. A local query creates every operator for
worker 0."""
from __future__ import annotations

from typing import Dict, List, Optional

from ..block import Page
from ..ops.operator import Operator, OperatorContext, OperatorFactory
from ..types import Type


class PageConsumerOperator(Operator):
    """Sink that keeps every page it receives."""

    def __init__(self, context: OperatorContext, types: List[Type]):
        super().__init__(context)
        self._types = types
        self.pages: List[Page] = []

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self.pages.append(page)

    def get_output(self) -> Optional[Page]:
        return None

    def rows(self) -> List[list]:
        out = []
        for p in self.pages:
            out.extend(p.to_pylists())
        return out


class PageConsumerFactory(OperatorFactory):
    def __init__(self, operator_id: int = 999, types: Optional[List[Type]] = None):
        super().__init__(operator_id, "PageConsumer")
        self.types = types or []
        self.consumers: List[PageConsumerOperator] = []
        self.consumers_by_worker: Dict[int, List[PageConsumerOperator]] = {}

    def create_operator(self, worker: int = 0) -> PageConsumerOperator:
        op = PageConsumerOperator(self.context(worker), self.types)
        self.consumers.append(op)
        self.consumers_by_worker.setdefault(worker, []).append(op)
        return op

    def rows(self) -> List[list]:
        """Python-value rows (Decimal, datetime.date, int, str) of every page."""
        out = []
        for c in self.consumers:
            out.extend(c.rows())
        return out

    def pages_for(self, worker: int) -> List[Page]:
        """Every page the consumers of ``worker`` received, in driver order."""
        return [p for c in self.consumers_by_worker.get(worker, []) for p in c.pages]
