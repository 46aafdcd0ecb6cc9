"""Discovery + failure detection: who is in the cluster, and who is healthy.

The port's copy of ``presto_tpu/cluster/discovery.py``, whole. Presto's
analogues:
  - metadata/DiscoveryNodeManager.java:70,116 — the coordinator's view of live
    nodes, refreshed from announcements
  - failureDetector/HeartbeatFailureDetector.java:77,326-360 — coordinator
    pings every node's /v1/status; an exponentially-decayed failure ratio
    above the threshold (:92) gates the node out of scheduling
  - the worker side of airlift discovery — periodic service announcements

Workers POST /v1/announcement to the coordinator every second; the coordinator
expires nodes it has not heard from and, independently, probes them."""
from __future__ import annotations

import dataclasses
import threading
import time
import urllib.request
from typing import Dict, List, Optional

_ANNOUNCE_PERIOD_S = 1.0
_EXPIRE_S = 10.0

# HeartbeatFailureDetector defaults (scaled down: seconds, not 30s heartbeats)
_PING_PERIOD_S = 1.0
_DECAY_ALPHA = 0.2           # exponential-decay weight per observation
_FAILURE_RATIO_THRESHOLD = 0.9


@dataclasses.dataclass
class NodeInfo:
    node_id: str
    uri: str
    last_announce: float
    failure_ratio: float = 0.0
    # planned drain (cluster lifecycle): the node is ALIVE — consumers keep
    # pulling its spooled streams — but must receive no new placements.
    # Distinct from failure_ratio gating: a draining node is healthy.
    draining: bool = False


class DiscoveryNodeManager:
    """Coordinator-side registry of announced worker nodes."""

    def __init__(self):
        self._nodes: Dict[str, NodeInfo] = {}
        self._lock = threading.Lock()

    def announce(self, node_id: str, uri: str) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                self._nodes[node_id] = NodeInfo(node_id, uri, time.monotonic())
            else:
                # a re-announce refreshes liveness but never clears a drain:
                # only remove() (DRAINED teardown) resets it, so a rejoining
                # upgraded worker comes back schedulable under a fresh entry
                node.uri = uri
                node.last_announce = time.monotonic()

    def remove(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def get(self, node_id: str) -> Optional[NodeInfo]:
        with self._lock:
            return self._nodes.get(node_id)

    def set_draining(self, node_id: str, draining: bool = True) -> bool:
        """Mark a node as draining (unschedulable but alive). False = the
        node is unknown."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return False
            node.draining = bool(draining)
            return True

    def all_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return list(self._nodes.values())

    def active_nodes(self) -> List[NodeInfo]:
        """Announced recently AND not gated by the failure detector.
        DRAINING nodes are included: they are alive and still serve their
        spooled exchange streams — treating them as dead would misread a
        planned drain as a node death mid-query. Placement must use
        schedulable_nodes()."""
        now = time.monotonic()
        with self._lock:
            return [n for n in self._nodes.values()
                    if now - n.last_announce < _EXPIRE_S
                    and n.failure_ratio < _FAILURE_RATIO_THRESHOLD]

    def schedulable_nodes(self) -> List[NodeInfo]:
        """Active AND not draining: the placement view of the cluster."""
        return [n for n in self.active_nodes() if not n.draining]


class HeartbeatFailureDetector:
    """Pings every announced node's /v1/status; maintains the decayed failure
    ratio on its NodeInfo (HeartbeatFailureDetector.java:326-360)."""

    def __init__(self, nodes: DiscoveryNodeManager,
                 period_s: float = _PING_PERIOD_S):
        self.nodes = nodes
        self.period_s = period_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="failure-detector", daemon=True)

    def start(self) -> "HeartbeatFailureDetector":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            for node in self.nodes.all_nodes():
                failed = 0.0
                try:
                    req = urllib.request.Request(f"{node.uri}/v1/status",
                                                 method="HEAD")
                    urllib.request.urlopen(req, timeout=2.0).read()
                except Exception:
                    failed = 1.0
                # exponential decay toward the latest observation
                node.failure_ratio = (
                    (1 - _DECAY_ALPHA) * node.failure_ratio
                    + _DECAY_ALPHA * failed)


class Announcer:
    """Worker-side: periodically announce this node to the coordinator.

    Failure tracking rides the shared cluster/retry.Backoff (the announce
    CADENCE stays period-driven — the announce loop never sleeps extra, a
    worker must reappear the moment the coordinator does)."""

    def __init__(self, coordinator_uri: str, node_id: str, uri: str):
        from .retry import Backoff

        self.coordinator_uri = coordinator_uri.rstrip("/")
        self.node_id = node_id
        self.uri = uri
        # infinite budget: announcing retries forever, the Backoff only
        # counts the failure streak for the persistent-failure warnings
        self._backoff = Backoff(max_failure_interval_s=float("inf"),
                                min_tries=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"announcer-{node_id}",
                                        daemon=True)

    @property
    def _announce_failures(self) -> int:
        """Current failure streak — single source: the shared Backoff."""
        return self._backoff.failure_count

    def start(self) -> "Announcer":
        self._announce_once()   # synchronous first announce: the node is
        self._thread.start()    # schedulable as soon as start() returns
        return self

    def stop(self) -> None:
        self._stop.set()

    def _announce_once(self) -> None:
        import json
        body = json.dumps({"nodeId": self.node_id, "uri": self.uri}).encode()
        req = urllib.request.Request(
            f"{self.coordinator_uri}/v1/announcement", data=body,
            method="POST", headers={"Content-Type": "application/json"})
        try:
            from . import faults
            faults.fire("client.announce", node_id=self.node_id)
            urllib.request.urlopen(req, timeout=5.0).read()
            self._backoff.success()
        except Exception as e:
            # coordinator may not be up yet (retried next period) — but a
            # PERSISTENT failure must be loud: a 401 here means the
            # coordinator requires authentication the worker cannot supply
            # and the node would silently never join the cluster
            self._backoff.failure()
            n = self._backoff.failure_count
            if n in (3, 20) or n % 100 == 0:
                import sys
                print(f"presto_tpu_torch worker {self.node_id}: announcement to "
                      f"{self.coordinator_uri} failing ({n}x): {e!r}",
                      file=sys.stderr, flush=True)

    def deregister(self) -> bool:
        """Explicitly remove this node from the coordinator's registry
        (DELETE /v1/announcement/{nodeId}) — the DRAINED handoff. Without
        this, a stopped announcer leaves the node ACTIVE in discovery until
        heartbeat decay gates it out, a full detector window in which the
        scheduler keeps placing tasks at a gone worker. Best-effort: the
        coordinator may already be down, and expiry still cleans up."""
        req = urllib.request.Request(
            f"{self.coordinator_uri}/v1/announcement/{self.node_id}",
            method="DELETE")
        try:
            urllib.request.urlopen(req, timeout=5.0).read()
            return True
        except Exception:  # noqa: BLE001 - expiry is the fallback path
            return False

    def _loop(self) -> None:
        while not self._stop.wait(_ANNOUNCE_PERIOD_S):
            self._announce_once()
