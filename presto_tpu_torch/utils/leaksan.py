"""Runtime leak sanitizer of the PyTorch port.

Counterpart of ``presto_tpu/utils/leaksan.py``, with the same API, finding
kinds and dump schema, so ``python -m tools.prestocheck --leak-diff DUMP
presto_tpu_torch`` reads its dumps. Under ``PRESTO_TPU_TORCH_LEAKSAN=1``
(or an explicit :func:`install`), the port's resource lifecycles are
recorded with their allocation stack, owning query and bytes, and residue
becomes a finding:

- **MemoryPool reservations** (``reserve`` / ``reserve_spill``): the net
  per (pool, query) is mirrored; a nonzero net when ``clear_query`` runs is
  the failed teardown the pool's backstop would forgive
  (``memory-residue``);
- **shared-pool clients** (``SharedWorkerPool.client`` against
  ``PoolClient.release``): a client whose count never returns to zero
  keeps its fairness slot (``pool-client-residue``);
- **SpillManager lifecycles**: a manager never ``close()``d, or its runs
  never released, leaves files and ledger bytes (``spill-residue``);
- **trace-recorder installs** (``trace.install`` / ``trace.uninstall``):
  a recorder left installed takes later queries' spans
  (``recorder-residue``);
- **repo-started threads**: a non-daemon thread still alive at exit
  (``thread-residue``); daemon pool workers die with the process.

Residue is judged at ``clear_query`` (that query's reservations and spill
managers) and at process exit or :meth:`LeakSanitizer.check_exit` (every
family). Live counts are ``leaksan.live_*`` gauges in
:data:`~presto_tpu_torch.utils.metrics.METRICS`.

The bookkeeping lock is the stdlib's (``locksan._RAW_LOCK``). Installs
stack with the reference's as locksan's do: :func:`uninstall` puts back
what :func:`install` replaced, unless another sanitizer has replaced it
since.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

from .locksan import _RAW_LOCK, REPO_ROOT
from .metrics import METRICS

_MAX_FINDINGS = 256
_MAX_STACK = 8
_THIS_FILE = os.path.abspath(__file__)
ENV = "PRESTO_TPU_TORCH_LEAKSAN"


def _stack(skip: int = 2, limit: int = _MAX_STACK) -> List[str]:
    """Repo-only allocation stack ['relpath:lineno', ...] starting `skip`
    frames up (innermost first). The sanitizer's own frames are elided."""
    frames: List[str] = []
    i = skip
    while len(frames) < limit and i < skip + 24:
        try:
            f = sys._getframe(i)
        except ValueError:
            break
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(REPO_ROOT + os.sep) and path != _THIS_FILE:
            rel = os.path.relpath(path, REPO_ROOT).replace(os.sep, "/")
            frames.append(f"{rel}:{f.f_lineno}")
        i += 1
    return frames


class LeakSanitizer:
    """Process-wide resource census shared by every instrumented surface."""

    def __init__(self):
        self._meta = _RAW_LOCK()
        self._tls = threading.local()
        self._findings: List[dict] = []
        self._reported: set = set()
        # (id(pool), query_id) -> {"ram", "spill", "site", "stack", "pool"}
        self._reservations: Dict[Tuple[int, str], dict] = {}
        # id(client) -> {"key", "refs", "site", "stack", "client"}
        self._clients: Dict[int, dict] = {}
        # id(mgr) -> {"query_id", "site", "stack", "mgr",
        #             "runs": {id(run): {...}}}
        self._spills: Dict[int, dict] = {}
        # id(recorder) -> {"query_id", "site", "stack", "recorder"}
        self._recorders: Dict[int, dict] = {}
        # id(thread) -> {"name", "site", "stack", "thread"}
        self._threads: Dict[int, dict] = {}

    # ------------------------------------------------------------ reentrancy

    def _busy(self) -> bool:
        return getattr(self._tls, "busy", False)

    class _Quiet:
        """Reentrancy guard: an instrumented call made while a note is
        already recording on this thread is skipped instead of deadlocking
        on the non-reentrant meta lock."""

        __slots__ = ("tls",)

        def __init__(self, tls):
            self.tls = tls

        def __enter__(self):
            self.tls.busy = True

        def __exit__(self, *exc):
            self.tls.busy = False
            return False

    # ------------------------------------------------------------- recording

    def note_reserve(self, pool, query_id: str, delta: int,
                     spill: bool = False) -> None:
        if self._busy() or delta == 0:
            return
        with self._Quiet(self._tls):
            key = (id(pool), query_id)
            with self._meta:
                e = self._reservations.get(key)
                if e is None:
                    e = self._reservations[key] = {
                        "ram": 0, "spill": 0, "pool": getattr(
                            pool, "id", "?"),
                        "site": "", "stack": [], "obj": pool}
                if delta > 0 and not e["site"]:
                    st = _stack(3)
                    e["site"] = st[0] if st else "<unknown>"
                    e["stack"] = st
                e["spill" if spill else "ram"] += delta
                if e["ram"] == 0 and e["spill"] == 0:
                    self._reservations.pop(key, None)

    def note_clear_query(self, pool, query_id: str) -> None:
        """Per-query residue gate, fired as ``clear_query`` runs: every
        reservation and spill manager of this query must already be clean
        — whatever the backstop is about to forgive becomes a finding."""
        if self._busy():
            return
        with self._Quiet(self._tls):
            with self._meta:
                e = self._reservations.pop((id(pool), query_id), None)
                mgrs = [m for m in self._spills.values()
                        if m["query_id"] == query_id]
                for m in mgrs:
                    self._spills.pop(id(m["obj"]), None)
            if e is not None and (e["ram"] or e["spill"]):
                self._report(
                    "memory-residue", ("mem", e["pool"], query_id, e["site"]),
                    f"query {query_id!r} cleared from pool {e['pool']!r} "
                    f"with a net of {e['ram']} reserved byte(s) and "
                    f"{e['spill']} spill byte(s) still charged — an acquire "
                    "on this stack was never released",
                    site=e["site"], stack=e["stack"], query_id=query_id,
                    nbytes=e["ram"] + e["spill"])
            for m in mgrs:
                self._report(
                    "spill-residue", ("spill", query_id, m["site"]),
                    f"SpillManager for query {query_id!r} was never "
                    f"closed ({len(m['runs'])} live run(s)) — its files "
                    "and ledger bytes outlive the query",
                    site=m["site"], stack=m["stack"], query_id=query_id,
                    nbytes=sum(r["nbytes"] for r in m["runs"].values()))

    def note_client_acquire(self, client) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            with self._meta:
                e = self._clients.get(id(client))
                if e is None:
                    st = _stack(3)
                    e = self._clients[id(client)] = {
                        "key": getattr(client, "key", "?"), "refs": 0,
                        "site": st[0] if st else "<unknown>", "stack": st,
                        "obj": client}
                e["refs"] += 1

    def note_client_release(self, client) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            with self._meta:
                e = self._clients.get(id(client))
                if e is not None:
                    e["refs"] -= 1
                    if e["refs"] <= 0:
                        self._clients.pop(id(client), None)

    def note_spill_open(self, mgr) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            st = _stack(3)
            with self._meta:
                self._spills[id(mgr)] = {
                    "query_id": getattr(mgr, "query_id", "?"),
                    "site": st[0] if st else "<unknown>", "stack": st,
                    "runs": {}, "obj": mgr}

    def note_spill_run(self, mgr, run) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            st = _stack(3)
            with self._meta:
                e = self._spills.get(id(mgr))
                if e is not None:
                    e["runs"][id(run)] = {
                        "site": st[0] if st else "<unknown>", "stack": st,
                        "nbytes": getattr(run, "nbytes", 0), "obj": run}

    def note_spill_release(self, mgr, run) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            with self._meta:
                e = self._spills.get(id(mgr))
                if e is not None:
                    e["runs"].pop(id(run), None)

    def note_spill_close(self, mgr) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            with self._meta:
                self._spills.pop(id(mgr), None)

    def note_recorder(self, recorder) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            with self._meta:
                if id(recorder) not in self._recorders:
                    st = _stack(3)
                    self._recorders[id(recorder)] = {
                        "query_id": getattr(recorder, "query_id", ""),
                        "site": st[0] if st else "<unknown>", "stack": st,
                        "obj": recorder}

    def note_recorder_gone(self, recorder) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            with self._meta:
                self._recorders.pop(id(recorder), None)

    def note_thread(self, thread) -> None:
        if self._busy():
            return
        with self._Quiet(self._tls):
            st = _stack(3)
            with self._meta:
                # opportunistic prune: started-and-finished threads are done
                for tid in [tid for tid, e in self._threads.items()
                            if e["obj"].ident is not None
                            and not e["obj"].is_alive()]:
                    self._threads.pop(tid, None)
                self._threads[id(thread)] = {
                    "name": getattr(thread, "name", "?"),
                    "site": st[0] if st else "<unknown>", "stack": st,
                    "obj": thread}

    def _report(self, kind: str, key: tuple, message: str, site: str,
                stack: List[str], query_id: str = "",
                nbytes: int = 0) -> None:
        t = threading.current_thread()
        with self._meta:
            if (kind, key) in self._reported:
                return
            self._reported.add((kind, key))
            if len(self._findings) >= _MAX_FINDINGS:
                return
            self._findings.append({
                "kind": kind, "message": message, "site": site,
                "stack": list(stack), "query_id": query_id,
                "bytes": int(nbytes), "thread": t.name,
            })

    # ------------------------------------------------------------- exit gate

    def check_exit(self) -> None:
        """Full-census residue check (atexit, or explicit in tests): every
        family, including the cross-query lifetimes clear_query must not
        judge (clients, recorders, non-daemon threads)."""
        with self._meta:
            res = list(self._reservations.items())
            clients = [dict(e) for e in self._clients.values()]
            spills = [dict(e) for e in self._spills.values()]
            recs = [dict(e) for e in self._recorders.values()]
            threads = [dict(e) for e in self._threads.values()]
        for (_pid, qid), e in res:
            if e["ram"] or e["spill"]:
                self._report(
                    "memory-residue", ("mem", e["pool"], qid, e["site"]),
                    f"query {qid!r} still holds a net of {e['ram']} "
                    f"reserved byte(s) and {e['spill']} spill byte(s) in "
                    f"pool {e['pool']!r} at exit — the acquire on this "
                    "stack was never released",
                    site=e["site"], stack=e["stack"], query_id=qid,
                    nbytes=e["ram"] + e["spill"])
        for e in clients:
            if e["refs"] > 0:
                self._report(
                    "pool-client-residue", ("client", e["key"], e["site"]),
                    f"shared-pool client {e['key']!r} still holds "
                    f"{e['refs']} reference(s) at exit — a pipeline or "
                    "exchange close path skipped its release()",
                    site=e["site"], stack=e["stack"])
        for e in spills:
            self._report(
                "spill-residue", ("spill", e["query_id"], e["site"]),
                f"SpillManager for query {e['query_id']!r} was never "
                f"closed ({len(e['runs'])} live run(s)) at exit",
                site=e["site"], stack=e["stack"], query_id=e["query_id"],
                nbytes=sum(r["nbytes"] for r in e["runs"].values()))
        for e in recs:
            self._report(
                "recorder-residue", ("recorder", e["site"]),
                f"trace recorder for query {e['query_id']!r} installed "
                "here was never uninstalled — later queries' spans would "
                "be misattributed to it",
                site=e["site"], stack=e["stack"], query_id=e["query_id"])
        for e in threads:
            t = e["obj"]
            if t.is_alive() and not t.daemon:
                self._report(
                    "thread-residue", ("thread", e["name"], e["site"]),
                    f"non-daemon thread {e['name']!r} started here is "
                    "still alive at exit — its owner never joined it",
                    site=e["site"], stack=e["stack"])

    # --------------------------------------------------------------- reading

    def live_counts(self) -> Dict[str, int]:
        """Current census — the `leaksan.live_*` gauge feed."""
        with self._meta:
            return {
                "reservations": len(self._reservations),
                "bytes": sum(e["ram"] + e["spill"]
                             for e in self._reservations.values()),
                "pool_clients": len(self._clients),
                "spill_managers": len(self._spills),
                "spill_runs": sum(len(e["runs"])
                                  for e in self._spills.values()),
                "recorders": len(self._recorders),
                "threads": sum(1 for e in self._threads.values()
                               if e["obj"].is_alive()),
            }

    def findings(self) -> List[dict]:
        with self._meta:
            return [dict(f) for f in self._findings]

    def report(self) -> str:
        fs = self.findings()
        live = self.live_counts()
        if not fs:
            return (f"leaksan: clean ({live['reservations']} live "
                    f"reservations, {live['spill_runs']} spill runs, "
                    f"{live['pool_clients']} pool clients, 0 findings)")
        lines = [f"leaksan: {len(fs)} finding(s):"]
        for f in fs:
            lines.append(f"  [{f['kind']}] {f['message']} "
                         f"(thread {f['thread']}, at {f['site']})")
            for frame in f["stack"][1:]:
                lines.append(f"      from {frame}")
        return "\n".join(lines)

    def assert_clean(self) -> None:
        fs = self.findings()
        assert not fs, self.report()

    def dump(self, path: str) -> str:
        """Findings + live census JSON — the runtime half a developer diffs
        against the static `resource-discipline` findings via
        ``python -m tools.prestocheck --leak-diff dump.json``."""
        doc = {"live": self.live_counts(), "findings": self.findings()}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        return path

    def absorb(self, findings: List[dict]) -> None:
        """Re-inject findings captured before a reset() — the test harness
        isolates deliberate-leak fixtures without losing real engine
        findings a sanitized run accumulated earlier."""
        with self._meta:
            for f in findings:
                if len(self._findings) < _MAX_FINDINGS:
                    self._findings.append(dict(f))

    def reset(self) -> None:
        with self._meta:
            self._findings.clear()
            self._reported.clear()
            self._reservations.clear()
            self._clients.clear()
            self._spills.clear()
            self._recorders.clear()
            self._threads.clear()


SANITIZER = LeakSanitizer()


# ---------------------------------------------------------------------------
# install / uninstall
# ---------------------------------------------------------------------------

_installed = False
_PATCHED: List[tuple] = []   # (owner, attr, raw, wrapper) for uninstall


def _patch(owner, attr: str, wrapper) -> None:
    _PATCHED.append((owner, attr, getattr(owner, attr), wrapper))
    setattr(owner, attr, wrapper)


def _atexit_check() -> None:
    if not _installed:
        return
    SANITIZER.check_exit()
    fs = SANITIZER.findings()
    if fs:
        print(SANITIZER.report(), file=sys.stderr)


def install() -> LeakSanitizer:
    """Instrument the resource lifecycles (idempotent). The engine modules
    are imported here, not at module top, so this file imports without the
    engine; the PRESTO_TPU_TORCH_LEAKSAN=1 hook runs at the end of the
    package's import for the same reason. Resources come into being only
    when a query runs, so the late install misses nothing."""
    global _installed
    if _installed:
        return SANITIZER
    from .. import memory as _memory
    from ..exec import shared_pools as _sp
    from ..exec import spill as _spill
    from . import trace as _trace

    raw_reserve = _memory.MemoryPool.reserve
    raw_reserve_spill = _memory.MemoryPool.reserve_spill
    raw_clear = _memory.MemoryPool.clear_query
    raw_client = _sp.SharedWorkerPool.client
    raw_release = _sp.PoolClient.release
    raw_sm_init = _spill.SpillManager.__init__
    raw_sm_write = _spill.SpillManager.write_pages
    raw_sm_release = _spill.SpillManager.release
    raw_sm_close = _spill.SpillManager.close
    raw_tr_install = _trace.install
    raw_tr_uninstall = _trace.uninstall
    raw_thread_start = threading.Thread.start

    def reserve(pool, query_id, delta, revocable=False):
        raw_reserve(pool, query_id, delta, revocable)
        SANITIZER.note_reserve(pool, query_id, int(delta))

    def reserve_spill(pool, query_id, delta):
        raw_reserve_spill(pool, query_id, delta)
        SANITIZER.note_reserve(pool, query_id, int(delta), spill=True)

    def clear_query(pool, query_id):
        SANITIZER.note_clear_query(pool, query_id)
        raw_clear(pool, query_id)

    def client(pool, key):
        c = raw_client(pool, key)
        SANITIZER.note_client_acquire(c)
        return c

    def release(pool_client):
        SANITIZER.note_client_release(pool_client)
        raw_release(pool_client)

    def sm_init(mgr, *a, **kw):
        raw_sm_init(mgr, *a, **kw)
        SANITIZER.note_spill_open(mgr)

    def sm_write(mgr, *a, **kw):
        run = raw_sm_write(mgr, *a, **kw)
        SANITIZER.note_spill_run(mgr, run)
        return run

    def sm_release(mgr, run):
        raw_sm_release(mgr, run)
        SANITIZER.note_spill_release(mgr, run)

    def sm_close(mgr):
        raw_sm_close(mgr)
        SANITIZER.note_spill_close(mgr)

    def tr_install(recorder):
        got = raw_tr_install(recorder)
        SANITIZER.note_recorder(recorder)
        return got

    def tr_uninstall(recorder):
        raw_tr_uninstall(recorder)
        SANITIZER.note_recorder_gone(recorder)

    def thread_start(thread):
        # record at start(), by the STARTING frame: repo-started threads
        # only — stdlib machinery (timers, executors) passes untouched
        path = os.path.abspath(sys._getframe(1).f_code.co_filename)
        if path.startswith(REPO_ROOT + os.sep) and path != _THIS_FILE:
            SANITIZER.note_thread(thread)
        raw_thread_start(thread)

    _patch(_memory.MemoryPool, "reserve", reserve)
    _patch(_memory.MemoryPool, "reserve_spill", reserve_spill)
    _patch(_memory.MemoryPool, "clear_query", clear_query)
    _patch(_sp.SharedWorkerPool, "client", client)
    _patch(_sp.PoolClient, "release", release)
    _patch(_spill.SpillManager, "__init__", sm_init)
    _patch(_spill.SpillManager, "write_pages", sm_write)
    _patch(_spill.SpillManager, "release", sm_release)
    _patch(_spill.SpillManager, "close", sm_close)
    _patch(_trace, "install", tr_install)
    _patch(_trace, "uninstall", tr_uninstall)
    _patch(threading.Thread, "start", thread_start)

    METRICS.set_gauge("leaksan.live_reservations",
                      lambda: SANITIZER.live_counts()["reservations"])
    METRICS.set_gauge("leaksan.live_bytes",
                      lambda: SANITIZER.live_counts()["bytes"])
    METRICS.set_gauge("leaksan.live_pool_clients",
                      lambda: SANITIZER.live_counts()["pool_clients"])
    METRICS.set_gauge("leaksan.live_spill_managers",
                      lambda: SANITIZER.live_counts()["spill_managers"])
    METRICS.set_gauge("leaksan.live_spill_runs",
                      lambda: SANITIZER.live_counts()["spill_runs"])
    METRICS.set_gauge("leaksan.live_recorders",
                      lambda: SANITIZER.live_counts()["recorders"])
    METRICS.set_gauge("leaksan.live_threads",
                      lambda: SANITIZER.live_counts()["threads"])

    atexit.register(_atexit_check)
    _installed = True
    return SANITIZER


def uninstall() -> None:
    """Put back every replaced method and function, in reverse order, so
    that stacked installs unwind; one another sanitizer has replaced since
    is left to it. The census survives (tests read findings after), but
    nothing new is recorded."""
    global _installed
    if not _installed:
        return
    while _PATCHED:
        owner, attr, raw, wrapper = _PATCHED.pop()
        if getattr(owner, attr) is wrapper:
            setattr(owner, attr, raw)
    try:
        atexit.unregister(_atexit_check)
    except Exception:
        pass  # best-effort: atexit may already be draining
    _installed = False


def enabled() -> bool:
    return _installed


def install_from_env() -> bool:
    """The PRESTO_TPU_TORCH_LEAKSAN=1 hook of ``presto_tpu_torch/__init__``,
    run after the engine modules it patches are importable."""
    if os.environ.get(ENV) in ("1", "true", "on"):
        install()
        return True
    return False
