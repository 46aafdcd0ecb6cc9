"""Shared retry machinery for the cluster tier: backoff + failure taxonomy.

The port's copy of ``presto_tpu/cluster/retry.py``, whole (Presto's
server/remotetask/Backoff.java): one jittered-exponential-delay class
with a transient-failure budget, shared by every retry loop on the
coordinator<->worker boundary (remote task create, exchange page pulls,
worker announcements, the consumer tail-poll) instead of the divergent
ad-hoc loops each of those sites grew independently.

Also home of the RetryPolicy vocabulary (SystemSessionProperties'
retry_policy) and the retryable-failure classification the coordinator uses
to decide whether a query attempt may be transparently re-run:

  NONE   — today's behavior: any task failure or node death fails the query.
  QUERY  — the coordinator re-plans and re-executes the whole query on a
           retryable failure, excluding failed nodes from placement.
  TASK   — QUERY, plus in-place recovery of failed tasks (leaf AND
           interior, mid-stream included): upstream buffers spool acked
           chunks (cluster/buffers.py), so a replacement task re-pulls its
           inputs from sequence 0 and each consumer re-issues GET from its
           chunk cursor against the replacement (cluster/exchange_client).
           The unsound remainder — a replay window retired from a bounded
           spool (HTTP 410), a nondeterministic multi-driver sink, or a
           consumer that cannot be rewired — escalates loudly to a
           query-level retry, matching the reference's split between
           pipelined and fault-tolerant (spooled) execution.
"""
from __future__ import annotations

import random
import time
import urllib.error
from typing import Callable, Optional

# RetryPolicy vocabulary (session property "retry_policy")
NONE = "NONE"
QUERY = "QUERY"
TASK = "TASK"
RETRY_POLICIES = (NONE, QUERY, TASK)


def retry_policy(session) -> str:
    policy = str(session.get("retry_policy") or NONE).upper()
    if policy not in RETRY_POLICIES:
        raise ValueError(
            f"invalid retry_policy {policy!r} (one of {RETRY_POLICIES})")
    return policy


class Backoff:
    """Jittered exponential backoff with a transient-failure budget.

    ``failure()`` records one failure and returns True when the budget is
    exhausted (at least ``min_tries`` failures AND ``max_failure_interval_s``
    elapsed since the first unhealed failure — Backoff.java:101's contract).
    ``success()`` heals the streak. ``wait()`` sleeps the current jittered
    delay and accounts it in ``total_backoff_s``.

    Clock, sleeper and RNG are injectable so tests drive every retry path
    deterministically (no sleeps-and-hope)."""

    def __init__(self, max_failure_interval_s: float = 60.0,
                 initial_delay_s: float = 0.05,
                 max_delay_s: float = 2.0,
                 min_tries: int = 3,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        assert min_tries >= 1
        self.max_failure_interval_s = max_failure_interval_s
        self.initial_delay_s = initial_delay_s
        self.max_delay_s = max_delay_s
        self.min_tries = min_tries
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        self._sleep = sleep
        self.failure_count = 0
        self.first_failure_at: Optional[float] = None
        self.last_failure_at: Optional[float] = None
        self.total_backoff_s = 0.0

    def failure(self) -> bool:
        """Record a failure; True when the transient budget is exhausted."""
        now = self._clock()
        self.failure_count += 1
        if self.first_failure_at is None:
            self.first_failure_at = now
        self.last_failure_at = now
        return (self.failure_count >= self.min_tries
                and now - self.first_failure_at >= self.max_failure_interval_s)

    def success(self) -> None:
        self.failure_count = 0
        self.first_failure_at = None

    def time_since_first_failure_s(self) -> float:
        if self.first_failure_at is None:
            return 0.0
        return self._clock() - self.first_failure_at

    def backoff_delay_s(self) -> float:
        """Current delay: initial * 2^(failures-1), capped, with 50% jitter."""
        if self.failure_count == 0:
            return 0.0
        exponent = min(self.failure_count - 1, 16)  # cap 2**k well below inf
        delay = min(self.max_delay_s, self.initial_delay_s * (2 ** exponent))
        return delay * (0.5 + 0.5 * self._rng.random())

    def wait(self) -> float:
        delay = self.backoff_delay_s()
        if delay > 0:
            self._sleep(delay)
            self.total_backoff_s += delay
        return delay


# --------------------------------------------------------------- failure taxonomy

class ClusterExecutionError(RuntimeError):
    """A cluster-tier failure with enough structure for the retry loop:
    which node (for placement exclusion) and whether re-running could help."""

    def __init__(self, message: str, node_id: Optional[str] = None,
                 retryable: bool = False):
        super().__init__(message)
        self.node_id = node_id
        self.retryable = retryable


class NodeDiedError(ClusterExecutionError):
    """A worker stopped announcing / answering with live tasks on it."""

    def __init__(self, message: str, node_id: Optional[str] = None):
        super().__init__(message, node_id=node_id, retryable=True)


class TaskFailedError(ClusterExecutionError):
    """A task reported FAILED; retryable iff the remote error looks like a
    transport/environment fault rather than a deterministic query error."""


# error types (TaskInfo.error["type"]) that indicate the environment, not the
# query: retrying elsewhere can heal these, a SQL error it cannot
_RETRYABLE_ERROR_TYPES = {
    "ConnectionResetError", "ConnectionRefusedError", "ConnectionAbortedError",
    "BrokenPipeError", "TimeoutError", "OSError", "URLError",
    "InjectedFault", "InjectedDisconnect",
}

_RETRYABLE_MESSAGE_MARKERS = (
    "unreachable", "was recreated", "connection reset", "connection refused",
    "remote end closed", "timed out", "injected fault", "worker killed",
    "output buffer failed", "task output failed",
    # spool replay unsound (410): only a full query re-run can help
    "replay window lost", "cannot replay",
)


def error_dict_retryable(error: Optional[dict]) -> bool:
    """Classify a remote TaskInfo.error dict."""
    if not error:
        return False
    if error.get("type") in _RETRYABLE_ERROR_TYPES:
        return True
    message = str(error.get("message") or "").lower()
    return any(marker in message for marker in _RETRYABLE_MESSAGE_MARKERS)


def is_retryable(exc: BaseException) -> bool:
    """May a new query attempt on (possibly different) nodes succeed?"""
    if isinstance(exc, ClusterExecutionError):
        return exc.retryable
    if isinstance(exc, (urllib.error.URLError, ConnectionError,
                        TimeoutError, OSError)):
        return True
    message = str(exc).lower()
    return any(marker in message for marker in _RETRYABLE_MESSAGE_MARKERS)
