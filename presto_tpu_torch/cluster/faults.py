"""Deterministic, seedable fault injection: the port's copy of
``presto_tpu/cluster/faults.py``, whole, with the same fire points, kinds
and spec grammar. The cluster tier fires its points from the worker's
HTTP handlers (``worker.*``), the remote-task client, exchange client and
announcer (``client.*``) and the task runtime (``worker.task_run``); the
disk rung (``exec/spill.py``) fires ``spill.write`` and ``spill.read``.

Every retry path in cluster/ exists to survive a fault that unit tests cannot
produce on demand — a worker dying mid-query, a dropped connection, a 5xx
blip. This harness makes those faults first-class test inputs instead of
hoped-for production events: hook points in the worker HTTP server, the
remote-task client, the exchange client, the announcer, and the task runtime
call :func:`fire`, and an installed :class:`FaultInjector` decides — by
deterministic call counts (``after``/``times``) or a seeded RNG
(``probability``) — whether to inject a delay, a connection reset, an HTTP
error, a task error, or a caller-supplied callback (e.g. kill a worker).

Nothing fires unless an injector is installed (production cost: one module
attribute read per hook). Install programmatically (tests), from the
``PRESTO_TPU_FAULTS`` env var (worker processes), or via the
``fault_injection`` session property (coordinator).

Spec grammar (env var / session property), rules separated by ``;``::

    point:kind[:key=value[,key=value...]]

    worker.results:disconnect:after=2,times=1
    worker.task_create:http_error:code=503,times=3
    client.results:delay:delay_s=0.05,probability=0.5,seed=7

Fire points:
  worker.task_create / worker.task_info / worker.results / worker.status
  worker.task_run   (inside SqlTask._run — fails the task itself)
  client.task_create / client.task_poll / client.results / client.announce
  spill.write / spill.read   (exec/spill.py disk-run I/O — fails the owning
                              query only; shared pools and tenants survive)
"""
from __future__ import annotations

import fnmatch
import io
import os
import re
import threading
import time
import urllib.error
from typing import Callable, Dict, List, Optional

from ..utils.metrics import METRICS

# fault kinds
DELAY = "delay"            # sleep delay_s, then continue normally
DISCONNECT = "disconnect"  # raise InjectedDisconnect (a ConnectionResetError)
HTTP_ERROR = "http_error"  # worker hooks answer `code`; client hooks raise
ERROR = "error"            # raise InjectedFault (plain exception)
CALLBACK = "callback"      # run rule.callback(ctx); it may itself raise
KINDS = (DELAY, DISCONNECT, HTTP_ERROR, ERROR, CALLBACK)

# every fire() site in the tree — the spec grammar's point vocabulary.
# from_spec validates each rule's point pattern against this list, so a
# typo'd chaos spec ("worker.resutls:...") fails LOUDLY at install time
# instead of silently injecting nothing for the whole run
FIRE_POINTS = (
    "worker.task_create", "worker.task_info", "worker.results",
    "worker.status", "worker.task_run",
    "client.task_create", "client.task_poll", "client.results",
    "client.announce",
    "spill.write", "spill.read",
)


class InjectedFault(Exception):
    """Base class for injected failures (classified retryable)."""


class InjectedDisconnect(InjectedFault, ConnectionResetError):
    """Injected peer reset — an OSError, so existing transient-failure
    handling on the clients catches it like a real dropped connection."""


class InjectedHTTPError(InjectedFault, urllib.error.HTTPError):
    """Injected HTTP failure. Doubles as a REAL urllib HTTPError so that at
    client-side hook points it flows through exactly the except clauses a
    genuine 5xx would (RemoteTask.create's transient branch,
    PageBufferClient.poll's 5xx-transient branch); worker-side hooks catch
    it explicitly and answer the request with `code` instead."""

    def __init__(self, code: int = 503, body: str = "injected fault"):
        urllib.error.HTTPError.__init__(
            self, "injected://fault", code, body, None,
            io.BytesIO(body.encode()))
        self.body = body


class FaultRule:
    """One match-and-fire rule. Matching is by fire point (fnmatch pattern),
    plus optional node id and task/location regexes. The rule fires on
    matched calls number (after, after+times]; ``times=None`` = unbounded.
    ``probability`` additionally gates each firing through the injector's
    seeded RNG (deterministic for a single-threaded call sequence)."""

    def __init__(self, point: str, kind: str, after: int = 0,
                 times: Optional[int] = 1, probability: Optional[float] = None,
                 delay_s: float = 0.0, code: int = 503,
                 node_id: Optional[str] = None,
                 task_re: Optional[str] = None,
                 location_re: Optional[str] = None,
                 callback: Optional[Callable[[dict], None]] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")
        self.point = point
        self.kind = kind
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.probability = probability
        self.delay_s = float(delay_s)
        self.code = int(code)
        self.node_id = node_id
        self.task_re = re.compile(task_re) if task_re else None
        self.location_re = re.compile(location_re) if location_re else None
        self.callback = callback
        self.matched = 0
        self.fired = 0

    def matches(self, point: str, ctx: dict) -> bool:
        if not fnmatch.fnmatch(point, self.point):
            return False
        if self.node_id is not None and ctx.get("node_id") != self.node_id:
            return False
        if self.task_re is not None and \
                not self.task_re.search(str(ctx.get("task_id") or "")):
            return False
        if self.location_re is not None and \
                not self.location_re.search(str(ctx.get("location") or "")):
            return False
        return True

    def __repr__(self):
        return (f"FaultRule({self.point}:{self.kind} after={self.after} "
                f"times={self.times} matched={self.matched} "
                f"fired={self.fired})")


class FaultInjector:
    """A seeded rule set; thread-safe match counting so concurrent hooks
    (worker handler threads, exchange pullers) see one deterministic window
    per rule."""

    def __init__(self, seed: int = 0):
        import random
        self.rules: List[FaultRule] = []
        self.rng = random.Random(seed)
        self.seed = seed
        self.total_fired = 0
        self._lock = threading.Lock()
        self._sleep = time.sleep

    def add(self, point: str, kind: str, **kw) -> FaultRule:
        rule = FaultRule(point, kind, **kw)
        self.rules.append(rule)
        return rule

    def fire(self, point: str, **ctx) -> None:
        """Called from a hook point; raises the injected failure, if any."""
        for rule in self.rules:
            with self._lock:
                if not rule.matches(point, ctx):
                    continue
                rule.matched += 1
                in_window = rule.matched > rule.after and (
                    rule.times is None
                    or rule.fired < rule.times)
                if not in_window:
                    continue
                if rule.probability is not None \
                        and self.rng.random() >= rule.probability:
                    continue
                rule.fired += 1
                self.total_fired += 1
            METRICS.count("cluster.faults_injected")
            ctx = dict(ctx, point=point, rule=rule)
            if rule.kind == DELAY:
                self._sleep(rule.delay_s)
            elif rule.kind == DISCONNECT:
                raise InjectedDisconnect(
                    f"injected disconnect at {point} ({ctx.get('node_id')})")
            elif rule.kind == HTTP_ERROR:
                raise InjectedHTTPError(rule.code)
            elif rule.kind == ERROR:
                raise InjectedFault(f"injected fault at {point}")
            elif rule.kind == CALLBACK and rule.callback is not None:
                rule.callback(ctx)

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        """Parse the ``point:kind[:k=v,...][;rule...]`` grammar above."""
        injector = cls(seed=seed)
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            pieces = part.split(":", 2)
            if len(pieces) < 2:
                raise ValueError(f"bad fault rule {part!r} "
                                 "(want point:kind[:k=v,...])")
            point, kind = pieces[0].strip(), pieces[1].strip()
            if not any(fnmatch.fnmatch(p, point) for p in FIRE_POINTS):
                raise ValueError(
                    f"unknown fault point {point!r}: pattern matches no "
                    f"fire point (one of {', '.join(FIRE_POINTS)})")
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (one of {', '.join(KINDS)})")
            kw: Dict[str, object] = {}
            if len(pieces) == 3 and pieces[2].strip():
                for item in pieces[2].split(","):
                    key, _, value = item.partition("=")
                    key = key.strip()
                    value = value.strip()
                    if key == "seed":
                        import random
                        injector.rng = random.Random(int(value))
                        injector.seed = int(value)
                        continue
                    if key in ("node_id", "task_re", "location_re"):
                        kw[key] = value
                    elif key in ("after", "times", "code"):
                        kw[key] = int(value)
                    elif key in ("delay_s", "probability"):
                        kw[key] = float(value)
                    else:
                        raise ValueError(f"unknown fault rule key {key!r}")
            injector.add(point, kind, **kw)
        return injector


# ------------------------------------------------------------ process global

_INJECTOR: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    global _INJECTOR
    _INJECTOR = injector
    return injector


def active() -> Optional[FaultInjector]:
    return _INJECTOR


def clear() -> None:
    install(None)


def fire(point: str, **ctx) -> None:
    """The hook call: no-op unless an injector is installed."""
    injector = _INJECTOR
    if injector is not None:
        injector.fire(point, **ctx)


def install_from_env(environ=None) -> Optional[FaultInjector]:
    """Install from PRESTO_TPU_FAULTS / PRESTO_TPU_FAULT_SEED if set and no
    injector is active (worker processes parse this at server start)."""
    environ = os.environ if environ is None else environ
    spec = environ.get("PRESTO_TPU_FAULTS")
    if not spec or _INJECTOR is not None:
        return _INJECTOR
    seed = int(environ.get("PRESTO_TPU_FAULT_SEED", "0"))
    return install(FaultInjector.from_spec(spec, seed=seed))
