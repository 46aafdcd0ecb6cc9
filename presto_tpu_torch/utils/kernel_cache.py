"""Process-wide cache of composed page functions, and the keys that name them.

Counterpart of ``presto_tpu/utils/kernel_cache.py``. The reference caches
jitted XLA kernels; the port runs eagerly, so what it caches is the composed
Python function of a fused pipeline segment (``ops/fused_segment.py``),
keyed on a fingerprint of everything the composition closed over: each
stage's static config and the input layout, with every dictionary's
identity and size. Equal keys compose behaviourally identical functions, so
repeated queries reuse one composition instead of composing it anew. A
miss's ``make()`` runs inside a ``kernel`` span ``build <key[0]>`` when a
trace is active (``utils/trace.py``); the one-time ``nvcc`` build of the
CUDA kernels lands inside whatever span wraps their first use, as XLA's
compile does in the reference.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Callable

from . import trace
from .metrics import METRICS

_LOCK = threading.Lock()
_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_MAX_ENTRIES = 2048  # least recently used entries go beyond this
_NEXT_TOKEN = itertools.count(1)


def get_or_install(key: tuple, make: Callable[[], object]):
    """The cached function for ``key``, made with ``make()`` on a miss."""
    return get_or_build(key, make)[0]


def get_or_build(key: tuple, make: Callable[[], object]):
    """-> (function, built_now): like :func:`get_or_install`, and whether
    ``make`` ran for this call. ``make`` runs under the lock (composing is
    cheap), so the drivers of one segment that miss on one key at once
    make it exactly once, and only that caller reports True.

    Callers reach this through the module attribute, as ``get_or_install``
    does: the compile sanitizer (``utils/compilesan.py``) observes every
    composition by replacing the attribute."""
    with _LOCK:
        hit = _CACHE.get(key)
        built = hit is None
        if built:
            if trace.active() is not None:
                with trace.span(trace.KERNEL, f"build {key[0] if key else '?'}"):
                    hit = make()
            else:
                hit = make()
            _CACHE[key] = hit
            while len(_CACHE) > _MAX_ENTRIES:
                _CACHE.popitem(last=False)
        _CACHE.move_to_end(key)
    # counted outside the lock, so the registry's lock never nests under it
    METRICS.count("kernel_cache.misses" if built else "kernel_cache.hits")
    return hit, built


def clear() -> None:
    """Drop every cached function (tests measure cold compositions)."""
    with _LOCK:
        _CACHE.clear()


def stats() -> dict:
    """Entries held, and compositions being made (always 0 once the lock is
    free: ``make`` runs under it), as the reference's ``stats`` has them."""
    with _LOCK:
        return {"entries": len(_CACHE), "building": 0}


def new_token() -> int:
    """A process-unique dictionary identity (never reused, unlike ``id``)."""
    return next(_NEXT_TOKEN)


def dict_key(d) -> tuple:
    """Cache identity of a Dictionary: (token, size)."""
    if d is None:
        return None
    return (d.token(), len(d))


def layout_key(types, dictionaries) -> tuple:
    return tuple((t.name, dict_key(d)) for t, d in zip(types, dictionaries))


def expr_key(e) -> tuple:
    """Canonical fingerprint of a RowExpression tree (type-aware, recursive)."""
    from ..ops import expressions as ex

    if e is None:
        return ("none",)
    t = e.type.name
    if isinstance(e, ex.InputRef):
        return ("in", e.channel, t)
    if isinstance(e, ex.SymbolRef):
        return ("sym", e.name, t)
    if isinstance(e, ex.Constant):
        v = e.value
        try:
            hash(v)
        except TypeError:
            v = repr(v)
        return ("const", t, v)
    if isinstance(e, ex.Call):
        return ("call", e.name, t) + tuple(expr_key(a) for a in e.args)
    if isinstance(e, ex.SpecialForm):
        return ("sf", e.form, t) + tuple(expr_key(a) for a in e.args)
    return ("other", repr(e))


def agg_call_key(call) -> tuple:
    """Fingerprint of one AggregateCall's static config."""
    return (call.function.fingerprint,
            tuple(call.input_channels),
            call.mask_channel,
            tuple(call.intermediate_channels or ()))
