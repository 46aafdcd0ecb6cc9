"""Live query progress of the PyTorch port (``presto_tpu/exec/progress.py``):
per-operator counters readable while a query runs.

A caller binds a query id to its thread with :func:`query_scope`; the
runner's ``_run_plan`` registers a provider for its drivers inside that
scope, and :func:`snapshot` merges every live provider of a query through
``exec/explain.rollup``, the aggregation EXPLAIN ANALYZE prints. Providers
return ``{"operators": [stat dicts], "memory_reserved_bytes": n,
"pool_steps": n}`` and must be cheap to call from another thread: reading
a plain-int counter while a driver thread writes it shows a stale value,
never a torn state.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

_TLS = threading.local()
_LOCK = threading.Lock()
_PROVIDERS: Dict[str, List[Callable[[], dict]]] = {}


class query_scope:
    """Bind ``query_id`` to the calling thread for the duration; leaving the
    scope unregisters every provider of the query (re-entrant: the previous
    binding comes back)."""

    def __init__(self, query_id: str):
        self.query_id = query_id

    def __enter__(self):
        self._prev = getattr(_TLS, "query_id", None)
        _TLS.query_id = self.query_id
        return self

    def __exit__(self, *exc):
        _TLS.query_id = self._prev
        unregister_all(self.query_id)
        return False


def current_query_id() -> Optional[str]:
    return getattr(_TLS, "query_id", None)


def register(provider: Callable[[], dict],
             query_id: Optional[str] = None) -> Callable[[], None]:
    """Attach a provider to ``query_id`` (default: the thread's scope).
    Returns its unregister callable; with no query bound it does nothing."""
    qid = query_id or current_query_id()
    if not qid:
        return lambda: None
    with _LOCK:
        _PROVIDERS.setdefault(qid, []).append(provider)

    def unregister() -> None:
        with _LOCK:
            lst = _PROVIDERS.get(qid)
            if lst is not None:
                if provider in lst:
                    lst.remove(provider)
                if not lst:
                    _PROVIDERS.pop(qid, None)
    return unregister


def unregister_all(query_id: str) -> None:
    with _LOCK:
        _PROVIDERS.pop(query_id, None)


def snapshot(query_id: str) -> Optional[dict]:
    """The query's live progress: operator counters rolled up across its
    providers, and its reserved bytes and pool steps; None when it has no
    live provider."""
    from .explain import rollup

    with _LOCK:
        providers = list(_PROVIDERS.get(query_id, ()))
    if not providers:
        return None
    operators: List[dict] = []
    memory = 0
    pool_steps = 0
    for p in providers:
        try:
            d = p() or {}
        except Exception:  # noqa: BLE001 - a read during teardown is not news
            continue
        operators.extend(d.get("operators") or ())
        memory += int(d.get("memory_reserved_bytes") or 0)
        pool_steps += int(d.get("pool_steps") or 0)
    return {"operators": rollup(operators), "memory_reserved_bytes": memory,
            "pool_steps": pool_steps}


def live_query_ids() -> List[str]:
    with _LOCK:
        return sorted(_PROVIDERS)
