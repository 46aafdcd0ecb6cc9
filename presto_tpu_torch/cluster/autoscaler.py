"""Coordinator autoscaler: grow/shrink a managed worker set under load.

The port's copy of ``presto_tpu/cluster/autoscaler.py``, whole.

The elastic-lifecycle loop on top of the drain state machine (worker.py) and
`ClusterQueryRunner.drain_worker`: scale-UP when the admission queue backs up
or the pools saturate, scale-DOWN only through a graceful drain — a shrink
must never OOM-kill a query or 410-escalate a live stream, so the victim
worker's tasks are handed to replacements (mid-stream replay splice) and the
node leaves the cluster only after reporting DRAINED.

Signals (read, not invented — the loop consumes what the engine already
journals and polls):
  - admission-queue depth: `query.queued` events (resource_groups.py emits
    them with `queue_depth`) and `pool.saturated` events since the last poll
  - memory pressure: ClusterMemoryManager.saturation() — the same
    /v1/status poll the OOM ladder runs on (the per-node feed
    GET /v1/cluster/metrics merges); without a memory manager the
    autoscaler polls worker /v1/status itself at its own cadence
  - per-worker activity: activeTasks from the same status feed

The worker factory is injected (`spawn_worker() -> handle with
.node_id/.uri/.stop()`) so tests, the churn bench and a real deployment can
each decide what "start a worker" means. Managed workers are re-announced by
the poll loop itself — a spawned worker needs no announcer of its own."""
from __future__ import annotations

import json
import threading
import urllib.request
from typing import Callable, Dict, List, Optional

from ..utils import events


class WorkerPoolAutoscaler:
    def __init__(self, runner, spawn_worker: Callable[[], object],
                 min_workers: int = 1, max_workers: int = 4,
                 poll_period_s: float = 1.0,
                 queue_depth_up: int = 1,
                 saturation_up: float = 0.8,
                 tasks_per_worker_up: float = 4.0,
                 idle_polls_down: int = 5,
                 drain_wait_s: float = 60.0):
        """`runner` is the ClusterQueryRunner (nodes + drain_worker +
        optional memory_manager). Scale-up triggers when ANY pressure signal
        fires; scale-down requires `idle_polls_down` consecutive quiet polls
        — growing is cheap and urgent, shrinking is neither."""
        self.runner = runner
        self.spawn_worker = spawn_worker
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.poll_period_s = poll_period_s
        self.queue_depth_up = queue_depth_up
        self.saturation_up = saturation_up
        self.tasks_per_worker_up = tasks_per_worker_up
        self.idle_polls_down = idle_polls_down
        self.drain_wait_s = drain_wait_s
        # all `managed` access goes through _managed_lock: adopt() runs on
        # the caller's thread, scale decisions on the poll loop's
        self._managed_lock = threading.Lock()
        self.managed: Dict[str, object] = {}
        self.scale_ups = 0
        self.scale_downs = 0
        self._idle_polls = 0
        self._last_seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler", daemon=True)

    # ------------------------------------------------------------------ api

    def adopt(self, handle) -> None:
        """Place an already-running worker under autoscaler management (the
        initial fleet; scale-down may later drain it)."""
        with self._managed_lock:
            self.managed[handle.node_id] = handle
        self.runner.nodes.announce(handle.node_id, handle.uri)

    def start(self) -> "WorkerPoolAutoscaler":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    # -------------------------------------------------------------- signals

    def read_signals(self) -> dict:
        """One pressure reading. Journal events are consumed since the last
        poll (the cursor advances even on quiet polls, so stale queueing
        never re-triggers); saturation and activity come from the status
        feed."""
        queued = events.JOURNAL.events(since=self._last_seq,
                                       kind="query.queued")
        saturated = events.JOURNAL.events(since=self._last_seq,
                                          kind="pool.saturated")
        self._last_seq = events.JOURNAL.last_seq()
        queue_depth = max((int(e.get("queue_depth") or 0) for e in queued),
                          default=0)
        mm = getattr(self.runner, "memory_manager", None)
        if mm is not None:
            saturation = mm.saturation()
            active_tasks = dict(mm.last_active_tasks)
        else:
            saturation = 0.0
            active_tasks = self._poll_active_tasks()
        n = max(len(self._schedulable_managed()), 1)
        return {
            "queue_depth": queue_depth,
            "pool_saturated_events": len(saturated),
            "memory_saturation": round(saturation, 3),
            "active_tasks": active_tasks,
            "tasks_per_worker": round(
                sum(active_tasks.values()) / n, 2) if active_tasks else 0.0,
        }

    def _poll_active_tasks(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for node in self.runner.nodes.active_nodes():
            try:
                with urllib.request.urlopen(f"{node.uri}/v1/status",
                                            timeout=2.0) as resp:
                    out[node.node_id] = int(
                        json.loads(resp.read()).get("activeTasks") or 0)
            except Exception:  # noqa: BLE001 - dead node: detector's job
                continue
        return out

    def _schedulable_managed(self) -> List[str]:
        draining = {n.node_id for n in self.runner.nodes.all_nodes()
                    if n.draining}
        with self._managed_lock:
            return [nid for nid in self.managed if nid not in draining]

    # --------------------------------------------------------------- policy

    def poll_once(self) -> Optional[str]:
        """One observe→decide→act step; returns "scale_up"/"scale_down"
        or None. Exposed for deterministic tests — the background loop just
        calls this on its period."""
        self._announce_managed()
        signal = self.read_signals()
        pressure = (signal["queue_depth"] >= self.queue_depth_up
                    or signal["pool_saturated_events"] > 0
                    or signal["memory_saturation"] >= self.saturation_up
                    or signal["tasks_per_worker"] >= self.tasks_per_worker_up)
        n = len(self._schedulable_managed())
        if pressure:
            self._idle_polls = 0
            if n < self.max_workers:
                return self._scale_up(signal)
            return None
        self._idle_polls += 1
        if self._idle_polls >= self.idle_polls_down and n > self.min_workers:
            self._idle_polls = 0
            return self._scale_down(signal)
        return None

    def _scale_up(self, signal: dict) -> Optional[str]:
        try:
            handle = self.spawn_worker()
        except Exception as e:  # noqa: BLE001 - spawn failure must not kill the loop
            events.emit("autoscaler.spawn_failed", severity=events.ERROR,
                        error=repr(e)[:200])
            return None
        with self._managed_lock:
            self.managed[handle.node_id] = handle
            workers = len(self.managed)
        self.runner.nodes.announce(handle.node_id, handle.uri)
        self.scale_ups += 1
        events.emit("autoscaler.scale_up", severity=events.INFO,
                    node=handle.node_id, workers=workers, signal=signal)
        return "scale_up"

    def _scale_down(self, signal: dict) -> Optional[str]:
        """Shrink by ONE worker, always through the drain path: pick the
        least-loaded managed node, drain it (tasks handed off via replay,
        node removed at DRAINED), then stop the process. Never a kill."""
        candidates = self._schedulable_managed()
        if not candidates:
            return None
        loads = signal.get("active_tasks") or {}
        victim = min(candidates, key=lambda nid: loads.get(nid, 0))
        with self._managed_lock:
            handle = self.managed.pop(victim)
        try:
            self.runner.drain_worker(
                victim, signal={"trigger": "autoscaler.scale_down", **signal},
                wait_s=self.drain_wait_s)
        except ValueError:
            # already gone from discovery (expired / operator-drained):
            # stopping the handle is all that is left
            pass
        handle.stop()
        self.scale_downs += 1
        with self._managed_lock:
            workers = len(self.managed)
        events.emit("autoscaler.scale_down", severity=events.INFO,
                    node=victim, workers=workers, signal=signal)
        return "scale_down"

    # ------------------------------------------------------------- internal

    def _announce_managed(self) -> None:
        """Keep managed workers fresh in discovery. announce() refreshes
        liveness without clearing a drain flag, so a node an operator is
        draining stays visible (it still serves its streams) — but a node
        already REMOVED (post-DRAINED) must not be resurrected, so only
        still-registered nodes are refreshed; new spawns are announced by
        _scale_up itself."""
        known = {n.node_id for n in self.runner.nodes.all_nodes()}
        with self._managed_lock:
            snapshot = list(self.managed.items())
        for nid, handle in snapshot:
            if nid in known:
                self.runner.nodes.announce(nid, handle.uri)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_period_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - the loop must survive one bad poll
                events.emit("autoscaler.poll_failed", severity=events.ERROR,
                            error=repr(e)[:200])
