"""Runtime lock sanitizer of the PyTorch port.

Counterpart of ``presto_tpu/utils/locksan.py``, with the same API, finding
kinds and dump schema, so ``python -m tools.prestocheck --lock-graph-diff
DUMP presto_tpu_torch`` reads its dumps. Under
``PRESTO_TPU_TORCH_LOCKSAN=1`` (or an explicit :func:`install`), every
``threading.Lock`` / ``RLock`` / ``Condition`` allocated from a file under
the repository root is an instrumented wrapper that records:

- the **acquisition-order graph**: an edge ``held -> acquired`` for every
  lock taken while another is held. An edge that closes a cycle is a
  deadlock in waiting, reported at the acquire attempt, before blocking
  (``order-cycle``), so an inverted order gives a finding, not a hang;
- **waits while holding a lock**: ``Condition.wait`` while the thread holds
  another instrumented lock serializes every other holder behind the wait
  (``wait-while-held``);
- **hold and contention-wait histograms**: ``locksan.hold_s`` and
  ``locksan.wait_s`` in :data:`~presto_tpu_torch.utils.metrics.METRICS`,
  per lock in :meth:`LockSanitizer.lock_stats`; holds and contended waits
  of 1 ms or more are also ``locksan`` spans (``trace.LOCKSAN``) on an
  active flight recorder.

Only locks allocated from files under the repository root are
instrumented; the stdlib's own (queue mutexes, Event conditions) stay raw.

One process may hold both packages, each with its own sanitizer and its
own environment variable. The sanitizer's bookkeeping uses the stdlib's
primitives, taken from ``_thread`` and the stdlib's ``Condition`` class,
never from whatever ``threading.Lock`` is when this module is imported: the
reference's sanitizer may already have replaced it. Installs stack:
:func:`uninstall` puts back what :func:`install` found, so two sanitizers
unwound in LIFO order leave the stdlib's objects in ``threading``.
"""
from __future__ import annotations

import _thread
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from . import trace
from .metrics import METRICS, Histogram


def _stdlib_condition() -> type:
    cond = threading.Condition
    if isinstance(cond, type) and cond.__module__ == "threading":
        return cond
    # another sanitizer's factory is installed: the stdlib's Event allocates
    # its condition through it, and a factory passes a stdlib caller's
    # allocation through as the stdlib class
    return type(threading.Event()._cond)


# the stdlib's primitives: the sanitizer's own bookkeeping never goes
# through an instrumented (or another sanitizer's) lock
_RAW_LOCK = _thread.allocate_lock
_RAW_RLOCK = _thread.RLock
_RAW_CONDITION = _stdlib_condition()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TRACE_CATEGORY = trace.LOCKSAN
_TRACE_WAIT_NS = 1_000_000       # holds and contended waits >= 1 ms become spans
_MAX_FINDINGS = 256
_MAX_EDGES = 8192
ENV = "PRESTO_TPU_TORCH_LOCKSAN"


def _site(depth: int = 2) -> str:
    """'relpath:lineno' of the caller `depth` frames up."""
    f = sys._getframe(depth)
    path = f.f_code.co_filename
    try:
        rel = os.path.relpath(path, REPO_ROOT)
    except ValueError:
        rel = path
    if rel.startswith(".."):
        rel = path
    return f"{rel.replace(os.sep, '/')}:{f.f_lineno}"


def _in_repo(depth: int = 2) -> bool:
    path = os.path.abspath(sys._getframe(depth).f_code.co_filename)
    return path.startswith(REPO_ROOT + os.sep)


class LockSanitizer:
    """Process-wide recorder shared by every instrumented lock."""

    def __init__(self):
        self._meta = _RAW_LOCK()
        self._tls = threading.local()
        # (held_name, acquired_name) -> first site
        self._edges: Dict[Tuple[str, str], str] = {}
        self._succ: Dict[str, Set[str]] = {}
        self._findings: List[dict] = []
        self._reported: Set[tuple] = set()
        self._hold: Dict[str, Histogram] = {}
        self._wait: Dict[str, Histogram] = {}
        self.n_locks = 0

    # ------------------------------------------------------------- held stack

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _busy(self) -> bool:
        return getattr(self._tls, "busy", False)

    class _Quiet:
        """Reentrancy guard: metrics and trace calls made by the sanitizer
        go through instrumented locks raw instead of recording again."""

        __slots__ = ("tls",)

        def __init__(self, tls):
            self.tls = tls

        def __enter__(self):
            self.tls.busy = True

        def __exit__(self, *exc):
            self.tls.busy = False
            return False

    # ------------------------------------------------------------- recording

    def note_attempt(self, lock: "_SanLock") -> None:
        """Order edges of an acquire attempt, recorded before any blocking
        so that a real deadlock still yields its cycle finding."""
        held = self._held()
        if not held or self._busy():
            return
        with self._Quiet(self._tls):
            site = _site(3)
            for h in held:
                if h[0].name != lock.name:
                    self._add_edge(h[0].name, lock.name, site)

    def _add_edge(self, a: str, b: str, site: str) -> None:
        with self._meta:
            if (a, b) in self._edges or len(self._edges) >= _MAX_EDGES:
                return
            self._edges[(a, b)] = site
            self._succ.setdefault(a, set()).add(b)
            self._succ.setdefault(b, set())
            path = self._path(b, a)
        if path is not None:
            nodes = [a, b] + path[1:]
            self._report("order-cycle", tuple(sorted(set(nodes))), site,
                         "lock-order cycle (deadlock potential): "
                         + " -> ".join(nodes + [a]),
                         locks=sorted(set(nodes)))

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src -> dst in the edge graph, dst left out (meta lock
        held)."""
        if src == dst:
            return [src]
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, trail = stack.pop()
            for nxt in self._succ.get(node, ()):
                if nxt == dst:
                    return trail
                if nxt not in seen and len(trail) < 16:
                    seen.add(nxt)
                    stack.append((nxt, trail + [nxt]))
        return None

    def _report(self, kind: str, key: tuple, site: str, message: str,
                locks: List[str]) -> None:
        t = threading.current_thread()
        with self._meta:
            if (kind, key) in self._reported:
                return
            self._reported.add((kind, key))
            if len(self._findings) >= _MAX_FINDINGS:
                return
            self._findings.append({
                "kind": kind, "message": message, "site": site,
                "locks": locks, "thread": t.name,
            })

    def _observe(self, table: Dict[str, Histogram], metric: str,
                 lock: "_SanLock", dur_ns: int) -> None:
        """One hold or wait of `lock`: its per-lock histogram and the
        process histogram."""
        secs = dur_ns / 1e9
        with self._meta:
            h = table.get(lock.name)
            if h is None:
                h = table[lock.name] = Histogram()
            h.add(secs)
        METRICS.histogram(metric, secs)

    def note_acquired(self, lock: "_SanLock", waited_ns: int,
                      contended: bool) -> None:
        self._held().append((lock, time.perf_counter_ns(), waited_ns))
        if not contended or self._busy():
            return
        with self._Quiet(self._tls):
            self._observe(self._wait, "locksan.wait_s", lock, waited_ns)

    def pop_held(self, lock: "_SanLock") -> Optional[tuple]:
        """Take `lock` off the held stack: (acquire time, wait ns), or None
        when it was not tracked."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                entry = held[i][1:]
                del held[i]
                return entry
        return None

    def note_released(self, lock: "_SanLock", entry: Optional[tuple]) -> None:
        """The hold that `pop_held` closed, recorded once the lock is
        released: a span goes through the trace recorder's own lock, which
        may be `lock` itself."""
        if entry is None or self._busy():
            return
        t0, waited_ns = entry
        now = time.perf_counter_ns()
        with self._Quiet(self._tls):
            self._observe(self._hold, "locksan.hold_s", lock, now - t0)
            if waited_ns >= _TRACE_WAIT_NS:
                trace.record(TRACE_CATEGORY, f"wait {lock.name}", t0 - waited_ns, waited_ns)
            if now - t0 >= _TRACE_WAIT_NS:
                trace.record(TRACE_CATEGORY, f"hold {lock.name}", t0, now - t0)

    def note_cond_wait(self, cond_lock: "_SanLock") -> None:
        """Condition.wait parks the thread; any other lock still held
        serializes its every other would-be holder behind this wait."""
        if self._busy():
            return
        others = [h[0].name for h in self._held() if h[0] is not cond_lock]
        if not others:
            return
        with self._Quiet(self._tls):
            self._report(
                "wait-while-held", (cond_lock.name, tuple(sorted(others))),
                _site(3),
                f"Condition.wait on `{cond_lock.name}` while holding "
                f"{', '.join('`%s`' % o for o in others)} — every other "
                "holder is blocked for the whole wait",
                locks=others + [cond_lock.name])

    def suspend_for_wait(self, lock: "_SanLock") -> Optional[tuple]:
        """Condition.wait releases its lock for the wait: close the hold
        segment and pop it, so the held stack stays truthful. Returns the
        held entry, or None when the lock was not tracked."""
        entry = self.pop_held(lock)
        if entry is not None and not self._busy():
            with self._Quiet(self._tls):
                self._observe(self._hold, "locksan.hold_s", lock,
                              time.perf_counter_ns() - entry[0])
        return entry

    def resume_after_wait(self, lock: "_SanLock") -> None:
        self._held().append((lock, time.perf_counter_ns(), 0))

    # --------------------------------------------------------------- reading

    def findings(self) -> List[dict]:
        with self._meta:
            return [dict(f) for f in self._findings]

    def order_graph(self) -> Dict[str, List[str]]:
        with self._meta:
            return {a: sorted(bs) for a, bs in self._succ.items()}

    def edges(self) -> List[dict]:
        with self._meta:
            return [{"held": a, "acquired": b, "site": s}
                    for (a, b), s in sorted(self._edges.items())]

    def lock_stats(self) -> Dict[str, dict]:
        """{lock name: {hold: {count,p50,p95,p99}, wait: {...}}}."""
        with self._meta:
            out = {}
            for n in sorted(set(self._hold) | set(self._wait)):
                entry = {}
                if n in self._hold:
                    entry["hold"] = self._hold[n].summary()
                if n in self._wait:
                    entry["wait"] = self._wait[n].summary()
                out[n] = entry
            return out

    def report(self) -> str:
        fs = self.findings()
        if not fs:
            return ("locksan: clean "
                    f"({self.n_locks} locks, {len(self.edges())} order "
                    "edges, 0 findings)")
        lines = [f"locksan: {len(fs)} finding(s):"]
        for f in fs:
            lines.append(f"  [{f['kind']}] {f['message']} "
                         f"(thread {f['thread']}, at {f['site']})")
        return "\n".join(lines)

    def assert_clean(self) -> None:
        fs = self.findings()
        assert not fs, self.report()

    def dump(self, path: str) -> str:
        """Order graph, findings and lock stats as JSON, the runtime half
        ``--lock-graph-diff`` sets against the static lock graph."""
        doc = {"locks": self.n_locks, "edges": self.edges(),
               "findings": self.findings(), "lock_stats": self.lock_stats()}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        return path

    def absorb(self, findings: List[dict]) -> None:
        """Put back findings taken before a reset(): a test isolates its
        deliberate violations without losing what the engine recorded."""
        with self._meta:
            for f in findings:
                if len(self._findings) < _MAX_FINDINGS:
                    self._findings.append(dict(f))

    def reset(self) -> None:
        with self._meta:
            self._edges.clear()
            self._succ.clear()
            self._findings.clear()
            self._reported.clear()
            self._hold.clear()
            self._wait.clear()


SANITIZER = LockSanitizer()


# ---------------------------------------------------------------------------
# instrumented primitives
# ---------------------------------------------------------------------------

class _SanLock:
    """threading.Lock with order, hold and wait bookkeeping."""

    _reentrant = False

    def __init__(self, name: str):
        self._inner = _RAW_LOCK()
        self.name = name
        with SANITIZER._meta:
            SANITIZER.n_locks += 1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        san = SANITIZER
        if san._busy():
            return self._inner.acquire(blocking, timeout)
        san.note_attempt(self)
        if self._inner.acquire(False):
            san.note_acquired(self, 0, contended=False)
            return True
        if not blocking:
            return False
        t0 = time.perf_counter_ns()
        got = self._inner.acquire(True, timeout)
        if got:
            san.note_acquired(self, time.perf_counter_ns() - t0, contended=True)
        return got

    def release(self) -> None:
        san = SANITIZER
        if san._busy():
            self._inner.release()
            return
        entry = san.pop_held(self)
        self._inner.release()
        san.note_released(self, entry)

    def locked(self) -> bool:
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    # Condition protocol: a stdlib Condition built over this wrapper (one
    # allocated from stdlib code) still keeps the books
    def _release_save(self):
        entry = SANITIZER.pop_held(self)
        self._inner.release()
        SANITIZER.note_released(self, entry)

    def _acquire_restore(self, _state) -> None:
        self.acquire()

    def _is_owned(self) -> bool:
        return any(h[0] is self for h in SANITIZER._held())

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name} {self._inner!r}>"


class _SanRLock(_SanLock):
    """threading.RLock wrapper: a reentrant acquire neither pushes the held
    stack again nor adds an order edge."""

    _reentrant = True

    def __init__(self, name: str):
        self._inner = _RAW_RLOCK()
        self.name = name
        self._owner: Optional[int] = None
        self._depth = 0
        with SANITIZER._meta:
            SANITIZER.n_locks += 1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        san = SANITIZER
        if san._busy():
            return self._inner.acquire(blocking, timeout)
        me = threading.get_ident()
        if self._owner == me:
            self._inner.acquire()
            self._depth += 1
            return True
        san.note_attempt(self)
        got = self._inner.acquire(False)
        contended, waited = False, 0
        if not got:
            if not blocking:
                return False
            t0 = time.perf_counter_ns()
            got = self._inner.acquire(True, timeout)
            waited = time.perf_counter_ns() - t0
            contended = True
        if got:
            self._owner = me
            self._depth = 1
            san.note_acquired(self, waited, contended)
        return got

    def release(self) -> None:
        if SANITIZER._busy():
            self._inner.release()
            return
        if self._owner == threading.get_ident() and self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        self._owner = None
        self._depth = 0
        entry = SANITIZER.pop_held(self)
        self._inner.release()
        SANITIZER.note_released(self, entry)

    __enter__ = acquire

    def _release_save(self):
        # Condition.wait over an RLock drops the whole recursion count
        state = self._inner._release_save()
        depth, self._depth = self._depth, 0
        self._owner = None
        SANITIZER.note_released(self, SANITIZER.pop_held(self))
        return (state, depth)

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        self._owner = threading.get_ident()
        self._depth = depth
        SANITIZER.resume_after_wait(self)

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()


class _SanCondition:
    """threading.Condition over an instrumented lock. A wait while holding
    any other instrumented lock is a finding; the condition's own lock is
    modelled as released for the wait."""

    def __init__(self, lock=None, name: str = ""):
        self.name = name or _site()
        if lock is None:
            lock = _SanRLock(self.name)
        # a foreign (raw or other-sanitizer) lock keeps no books here
        self._san_lock: Optional[_SanLock] = lock if isinstance(lock, _SanLock) else None
        self._cond = _RAW_CONDITION(lock if self._san_lock is None else lock._inner)

    def acquire(self, *a, **kw) -> bool:
        if self._san_lock is not None:
            return self._san_lock.acquire(*a, **kw)
        return self._cond.acquire(*a, **kw)

    def release(self) -> None:
        if self._san_lock is not None:
            self._san_lock.release()
        else:
            self._cond.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        lk = self._san_lock
        if lk is None:
            return self._cond.wait(timeout)
        SANITIZER.note_cond_wait(lk)
        saved_depth = None
        if lk._reentrant:
            # the raw wait releases the inner RLock entirely: clear the
            # ownership now, so another thread acquiring during the park
            # sees a clean wrapper, and restore it once the lock is back
            saved_depth = lk._depth
            lk._owner = None
            lk._depth = 0
        entry = SANITIZER.suspend_for_wait(lk)
        try:
            return self._cond.wait(timeout)
        finally:
            if lk._reentrant:
                lk._owner = threading.get_ident()
                lk._depth = saved_depth or 1
            if entry is not None:
                SANITIZER.resume_after_wait(lk)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    notifyAll = notify_all

    def __repr__(self) -> str:
        return f"<_SanCondition {self.name}>"


# ---------------------------------------------------------------------------
# factories and install
# ---------------------------------------------------------------------------

def Lock(name: Optional[str] = None) -> _SanLock:
    """Always-instrumented Lock (tests; engine code just uses threading)."""
    return _SanLock(name or _site())


def RLock(name: Optional[str] = None) -> _SanRLock:
    return _SanRLock(name or _site())


def Condition(lock=None, name: Optional[str] = None) -> _SanCondition:
    return _SanCondition(lock, name or _site())


def _lock_factory():
    if _in_repo():
        return _SanLock(_site())
    return _RAW_LOCK()


def _rlock_factory():
    if _in_repo():
        return _SanRLock(_site())
    return _RAW_RLOCK()


def _condition_factory(lock=None):
    if _in_repo():
        return _SanCondition(lock, _site())
    return _RAW_CONDITION(lock)


_FACTORIES = {"Lock": _lock_factory, "RLock": _rlock_factory,
              "Condition": _condition_factory}
_previous: Dict[str, object] = {}   # what install() replaced, for uninstall


def install() -> LockSanitizer:
    """Replace threading's Lock, RLock and Condition so that repo-allocated
    locks are instrumented. Idempotent. A lock allocated before install
    stays raw, so the env hook runs before the port allocates any."""
    if not _previous:
        for attr, factory in _FACTORIES.items():
            _previous[attr] = getattr(threading, attr)
            setattr(threading, attr, factory)
    return SANITIZER


def uninstall() -> None:
    """Put back what install() replaced. Instrumented locks keep working
    (they wrap stdlib primitives); new allocations are raw again. An
    attribute another sanitizer has replaced since is left to it."""
    for attr, prev in _previous.items():
        if getattr(threading, attr) is _FACTORIES[attr]:
            setattr(threading, attr, prev)
    _previous.clear()


def enabled() -> bool:
    return bool(_previous)


def install_from_env() -> bool:
    """The PRESTO_TPU_TORCH_LOCKSAN=1 hook of ``presto_tpu_torch/__init__``."""
    if os.environ.get(ENV) in ("1", "true", "on"):
        install()
        return True
    return False
