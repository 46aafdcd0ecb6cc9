"""Cluster memory manager: cross-worker memory accounting + OOM killing.

The port's copy of ``presto_tpu/cluster/memory_manager.py``, whole; the
workers' status reports the port's ``memory.py`` pool ledgers. Analogue
of memory/ClusterMemoryManager.java:92 (coordinator polls every worker's
memory state through its status endpoint) and the
TotalReservationLowMemoryKiller policy: when the cluster's total reserved
bytes stay over the limit for `grace_polls` consecutive polls, the query
with the LARGEST total reservation across workers is killed — freeing the
most memory with one victim, exactly the reference policy's choice.

Killing is the LAST rung of the memory ladder, not the first response:
when workers report revocable bytes (their operators can still move state
device->host->disk), the manager first journals ``memory.revoke`` and
requests a revoke round, then waits exactly one more poll — the bounded
beat that lets spilling land — and only if the cluster is STILL over the
limit does it select a victim. ``query.oom_killed`` then records whether
revocation was attempted and how many revocable bytes remained, so a
post-mortem can tell "nothing left to spill" from "killed too eagerly".

Workers report {query_id: bytes} via /v1/status (see worker.py); the kill
action is injected so the coordinator wires its own task cancellation and
tests wire a recorder.
"""
from __future__ import annotations

import json
import threading
import urllib.request
from typing import Callable, Dict, List, Optional


class ClusterMemoryManager:
    def __init__(self, nodes, kill_query: Callable[[str], None],
                 limit_bytes: int = 32 << 30,
                 poll_period_s: float = 1.0,
                 grace_polls: int = 2,
                 fetch_status: Optional[Callable[[str], Dict]] = None,
                 request_revoke: Optional[Callable[[], None]] = None):
        """`nodes` provides active_nodes() (DiscoveryNodeManager); a custom
        `fetch_status(uri)` replaces the HTTP GET in tests.
        `request_revoke` (best-effort, optional) nudges workers to run a
        revoke round NOW instead of waiting for their own pressure checks;
        the revoke-before-kill beat happens regardless — operators revoke
        on their next add_input under pressure either way."""
        self.nodes = nodes
        self.kill_query = kill_query
        self.limit_bytes = limit_bytes
        self.poll_period_s = poll_period_s
        self.grace_polls = grace_polls
        self._fetch = fetch_status or self._http_status
        self.request_revoke = request_revoke
        self._over_count = 0
        self._revoke_requested = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="cluster-memory", daemon=True)
        self.last_total = 0
        self.last_by_query: Dict[str, int] = {}
        self.last_revocable: Dict[str, int] = {}
        # per-node activity from the same poll — the autoscaler's pressure
        # feed (it must never add its own status-poll storm on top of this
        # monitor loop's)
        self.last_active_tasks: Dict[str, int] = {}
        self.last_spooled: Dict[str, int] = {}
        self.killed: List[str] = []

    def saturation(self) -> float:
        """Cluster memory pressure 0.0..: last polled total reserved bytes
        over the limit (>=1.0 means the OOM ladder is in play)."""
        return self.last_total / self.limit_bytes if self.limit_bytes else 0.0

    # ------------------------------------------------------------------ api

    def start(self) -> "ClusterMemoryManager":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def poll_once(self) -> Optional[str]:
        """One poll + policy step; returns the killed query id, if any."""
        from ..utils import events
        by_query: Dict[str, int] = {}
        revocable: Dict[str, int] = {}
        per_node: Dict[str, Dict[str, int]] = {}
        active_tasks: Dict[str, int] = {}
        spooled: Dict[str, int] = {}
        total = 0
        for node in self.nodes.active_nodes():
            try:
                status = self._fetch(node.uri)
            except Exception:  # noqa: BLE001 - dead nodes are the detector's job
                continue
            name = getattr(node, "node_id", None) or getattr(node, "uri", "?")
            active_tasks[name] = int(status.get("activeTasks") or 0)
            spooled[name] = int(status.get("spooledBytes") or 0)
            node_mem = {qid: int(b)
                        for qid, b in (status.get("queryMemory") or {}).items()}
            if node_mem:
                # `name` tolerates minimal node stand-ins (tests inject bare
                # uri-only objects); the uri always identifies the worker
                per_node[name] = node_mem
            for qid, b in node_mem.items():
                by_query[qid] = by_query.get(qid, 0) + b
                total += b
            for qid, b in (status.get("queryRevocable") or {}).items():
                revocable[qid] = revocable.get(qid, 0) + int(b)
        self.last_total = total
        self.last_by_query = by_query
        self.last_revocable = revocable
        self.last_active_tasks = active_tasks
        self.last_spooled = spooled
        if total <= self.limit_bytes or not by_query:
            self._over_count = 0
            self._revoke_requested = False
            return None
        self._over_count += 1
        if self._over_count < self.grace_polls:
            return None  # transient spike: give revocation/spill a chance
        revocable_total = sum(revocable.values())
        if revocable_total > 0 and not self._revoke_requested:
            # kill is the LAST rung: the workers still hold revocable state,
            # so request a revoke round (device->host->disk) and wait
            # exactly one more poll for the spill to land before deciding
            self._revoke_requested = True
            events.emit("memory.revoke", severity=events.WARN,
                        requested_bytes=revocable_total, total_bytes=total,
                        limit_bytes=self.limit_bytes, per_node=per_node)
            if self.request_revoke is not None:
                try:
                    self.request_revoke()
                except Exception:  # noqa: BLE001 - best-effort nudge only
                    pass
            return None
        victim = max(by_query.items(), key=lambda kv: kv[1])[0]
        revoke_attempted = self._revoke_requested
        self._over_count = 0
        self._revoke_requested = False
        self.killed.append(victim)
        # journal the DECISION with the evidence that justified it: the
        # per-worker per-query byte snapshot at kill time is exactly what a
        # post-mortem needs and is gone one poll later
        events.emit("query.oom_killed", severity=events.ERROR,
                    query_id=victim,
                    victim_bytes=by_query[victim], total_bytes=total,
                    limit_bytes=self.limit_bytes, per_node=per_node,
                    revoke_attempted=revoke_attempted,
                    revocable_bytes=revocable_total)
        try:
            self.kill_query(victim)
        except Exception:  # noqa: BLE001 - kill is best-effort; retried next poll
            pass
        return victim

    # ------------------------------------------------------------- internal

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_period_s):
            self.poll_once()

    @staticmethod
    def _http_status(uri: str) -> Dict:
        # raise-through by design: poll_once classifies the failure (a dead
        # node is the failure detector's job, this poll just skips it)
        with urllib.request.urlopen(f"{uri}/v1/status", timeout=2.0) as resp:  # prestocheck: ignore[retry-discipline]
            return json.loads(resp.read())
