"""Task output buffers: the producer half of the cross-host shuffle.

The port's copy of ``presto_tpu/cluster/buffers.py``, whole: host memory
only, frames are bytes. Presto's execution/buffer/ (PartitionedOutputBuffer
/ BroadcastOutputBuffer / ClientBuffer): each task owns one OutputBuffer
with a ClientBuffer per consumer; consumers pull serialized page frames with a
monotonically increasing token — requesting token T acknowledges frames below
T, re-requesting T is idempotent (ClientBuffer's token protocol,
server/TaskResource.java:245-318).

Chunk spooling (replayable mid-stream retry): an acked frame is no longer
freed — it retires into a bounded per-task SPOOL, still keyed by its sequence
token. A consumer that lost its producer (or was itself recreated) re-issues
GET from its chunk cursor and the spool replays the exact frame sequence;
a recreated consumer re-pulls from token 0 the same way. The spool is bounded
by `spool_max_bytes` (the `exchange_spool_bytes` session knob): overflow
retires the oldest-acked frames first and marks that client stream
non-replayable — a later GET below the surviving floor raises
:class:`ReplayWindowLost` (HTTP 410 on the worker), which escalates loudly to
a query-level retry instead of silently truncating the stream. Spooled bytes
are accounted in the unified memory pool via the `reserve` callback so
admission and the OOM killer see them.

Backpressure: the buffer bounds retained *unacked* bytes; enqueue blocks the
producing driver thread until a consumer drains (the reference blocks the
task's output future the same way). Spooled bytes never exert backpressure —
they are bounded by eviction, not by blocking the producer.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

PARTITIONED = "PARTITIONED"
BROADCAST = "BROADCAST"
GATHER = "GATHER"          # single consumer buffer (TaskOutputOperator case)


class ReplayWindowLost(RuntimeError):
    """GET below the spool floor: the frames needed to replay this stream
    were retired (spool overflow / nondeterministic sink / released buffer).
    Mid-stream task recovery is unsound here — the caller must escalate to a
    query-level retry, never skip ahead."""


class ClientBuffer:
    """One consumer's frame queue with token acks and an acked-frame spool.

    Frames are retained contiguously from `_floor`: the acked prefix
    (tokens < `_ack`) is the spool, the suffix is unacked. The spool trims
    oldest-first (raising `_floor`) when the owning OutputBuffer is over its
    spool bound."""

    def __init__(self, lock: threading.Condition):
        self._cv = lock
        self._frames: List[Tuple[int, bytes]] = []  # (token, frame), sorted
        self._floor = 0       # token of _frames[0]; below it = retired
        self._ack = 0         # tokens < _ack are acked (spooled)
        self._next_token = 0
        self._no_more = False
        self._aborted = False
        self.replay_lost = False   # some acked frame was retired for good

    # producer side (caller holds the cv lock via OutputBuffer)
    def enqueue_locked(self, frame: bytes) -> Tuple[int, int]:
        """-> (unacked bytes added, spool bytes added). A frame below an
        already-advanced ack boundary (a replacement task re-producing the
        prefix a rewired consumer has acked) lands directly in the spool
        account — it must never exert backpressure or the replay wedges."""
        if self._aborted:
            return 0, 0  # consumer is gone: drop, never accumulate bytes
        token = self._next_token
        self._frames.append((token, frame))
        self._next_token += 1
        if token < self._ack:
            return 0, len(frame)
        return len(frame), 0

    def set_no_more_locked(self) -> None:
        self._no_more = True

    def abort_locked(self) -> Tuple[int, int]:
        """-> (unacked bytes freed, spooled bytes freed)."""
        freed = spool_freed = 0
        for tok, f in self._frames:
            if tok < self._ack:
                spool_freed += len(f)
            else:
                freed += len(f)
        self._frames.clear()
        self._floor = self._next_token
        self._aborted = True
        self._no_more = True
        self.replay_lost = True
        return freed, spool_freed

    def final_ack_locked(self) -> Tuple[int, int]:
        """Final ack (consumer DELETE). A fully-delivered stream (`no_more`
        set and every frame acked) is NOT released: its frames are already
        in the bounded spool, and a recreated consumer may still need to
        replay them from token 0. A mid-stream final ack (early-exit
        consumer, e.g. LIMIT satisfied) releases for real — the producer
        must unblock and stop retaining. -> (unacked freed, spool freed)."""
        if self._no_more and self._ack >= self._next_token:
            return 0, 0
        return self.abort_locked()

    # consumer side
    def ack_locked(self, token: int) -> Tuple[int, int]:
        """Advance the ack boundary to `token`: newly acked frames move from
        the unacked (backpressure) account to the spool. A replaying consumer
        re-acking below the boundary is a no-op. -> (unacked bytes released,
        spool bytes gained) — equal unless frames were already retired."""
        if token <= self._ack:
            return 0, 0
        moved = 0
        for tok, f in self._frames:
            if tok >= token:
                break
            if tok >= self._ack:
                moved += len(f)
        self._ack = token
        return moved, moved

    def drop_oldest_spooled_locked(self) -> int:
        """Retire the oldest acked frame (spool overflow). -> bytes freed."""
        if not self._frames or self._frames[0][0] >= self._ack:
            return 0
        _, frame = self._frames.pop(0)
        self._floor += 1
        self.replay_lost = True
        return len(frame)

    def drop_spool_locked(self) -> int:
        """Retire the whole acked prefix (nonreplayable sink). -> bytes."""
        freed = 0
        while self._frames and self._frames[0][0] < self._ack:
            freed += len(self._frames.pop(0)[1])
            self._floor += 1
        return freed

    def spooled_bytes_locked(self) -> int:
        return sum(len(f) for tok, f in self._frames if tok < self._ack)

    def get_locked(self, token: int) -> Tuple[Optional[bytes], int, bool]:
        """-> (frame|None, next_token, complete). Caller holds lock.
        Raises ReplayWindowLost when `token` fell below the retained floor —
        the frame existed once and is gone, so waiting would be a lie."""
        if self._aborted:
            raise ReplayWindowLost(
                "replay window lost: buffer was released (final ack or task "
                "teardown) — stream cannot be replayed")
        if token < self._floor:
            raise ReplayWindowLost(
                f"replay window lost: token {token} below spool floor "
                f"{self._floor} (oldest acked frames were retired)")
        idx = token - self._floor
        if 0 <= idx < len(self._frames):
            tok, frame = self._frames[idx]
            assert tok == token, "spool tokens must be contiguous"
            return frame, token + 1, False
        return None, token, self._no_more and token >= self._next_token


class OutputBuffer:
    """Per-task output: `n_buffers` client buffers of serialized frames.

    `spool_max_bytes` bounds the acked-frame spool across all clients
    (0 disables spooling: acked frames retire immediately and every stream
    is non-replayable — the pre-spool protocol, but loud on replay).
    `reserve` is the unified-memory hook: called under the buffer lock with
    spool byte deltas (positive on retire-to-spool, negative on trim/free);
    it must be cheap and must not raise."""

    def __init__(self, kind: str, n_buffers: int,
                 max_bytes: int = 64 << 20,
                 spool_max_bytes: int = 64 << 20,
                 reserve: Optional[Callable[[int], None]] = None):
        assert kind in (PARTITIONED, BROADCAST, GATHER)
        self.kind = kind
        self.n_buffers = n_buffers if kind != GATHER else 1
        self._cv = threading.Condition()
        self._buffers = [ClientBuffer(self._cv) for _ in range(self.n_buffers)]
        self._bytes = 0          # unacked (backpressure account)
        self._spool_bytes = 0    # acked, retained for replay
        self._max_bytes = max_bytes
        self._spool_max = max(int(spool_max_bytes), 0)
        self._reserve = reserve
        self._no_more = False
        self._failed: Optional[str] = None
        self._nonreplayable: Optional[str] = None
        self._spool_pinned = False  # drain: never retire the replay window

    # ------------------------------------------------------------- producer

    def _wait_for_space_locked(self, need: int, timeout_s: float) -> None:
        """Bounded producer wait while the buffer is over its byte bound
        (backpressure; the reference's OutputBuffers block the same way).
        Caller holds the cv lock."""
        deadline = None
        while self._bytes + need > self._max_bytes and self._bytes:
            if self._failed:
                raise RuntimeError(f"output buffer failed: {self._failed}")
            if deadline is None:
                deadline = time.monotonic() + timeout_s
            if not self._cv.wait(timeout=1.0) and time.monotonic() > deadline:
                raise TimeoutError("output buffer backpressure timeout")
        if self._failed:
            raise RuntimeError(f"output buffer failed: {self._failed}")

    def enqueue(self, buffer_id: int, frame: bytes,
                timeout_s: float = 300.0) -> None:
        with self._cv:
            self._wait_for_space_locked(len(frame), timeout_s)
            unacked, spooled = self._buffers[buffer_id].enqueue_locked(frame)
            self._bytes += unacked
            self._account_spool_locked(spooled)
            self._trim_spool_locked()
            self._cv.notify_all()

    def enqueue_broadcast(self, frame: bytes, timeout_s: float = 300.0) -> None:
        """A broadcast producer retains one copy per live consumer, so
        outrunning consumers would grow memory without bound (the reference's
        BroadcastOutputBuffer blocks the producer at the memory bound too)."""
        with self._cv:
            live = sum(1 for b in self._buffers if not b._aborted)
            need = len(frame) * max(live, 1)
            self._wait_for_space_locked(need, timeout_s)
            for b in self._buffers:
                unacked, spooled = b.enqueue_locked(frame)
                self._bytes += unacked
                self._account_spool_locked(spooled)
            self._trim_spool_locked()
            self._cv.notify_all()

    def set_no_more_pages(self) -> None:
        with self._cv:
            self._no_more = True
            for b in self._buffers:
                b.set_no_more_locked()
            self._cv.notify_all()

    def fail(self, message: str) -> None:
        """Poison the buffer: producers and consumers unblock with an error."""
        with self._cv:
            self._failed = message
            self._cv.notify_all()

    def mark_nonreplayable(self, reason: str) -> None:
        """This task's frame sequence is not deterministic (e.g. multiple
        sink drivers interleave nondeterministically): spooling it would
        replay *different* data. Drop the spool and stop retaining."""
        with self._cv:
            if self._nonreplayable:
                return
            self._nonreplayable = reason
            freed = 0
            for b in self._buffers:
                freed += b.drop_spool_locked()
                b.replay_lost = True
            self._account_spool_locked(-freed)
            self._cv.notify_all()

    # --------------------------------------------------------------- spool

    def _account_spool_locked(self, delta: int) -> None:
        if not delta:
            return
        self._spool_bytes += delta
        if self._reserve is not None:
            try:
                self._reserve(delta)
            except Exception:  # noqa: BLE001 - accounting must not poison I/O
                pass

    def pin_spool(self) -> None:
        """Drain support: stop retiring acked frames even when the spool is
        over its bound, so every live stream's replay window stays COMPLETE
        while consumers are handed to a replacement task. The window is
        short (the drain re-places producers within seconds) and the bytes
        stay accounted in the shared pool, so the overshoot is observable."""
        with self._cv:
            self._spool_pinned = True

    def output_drained(self) -> bool:
        """No live consumer depends on FUTURE pulls from this buffer: every
        stream was fully delivered and acked (complete streams keep their
        spool for replay, which nobody will need) or explicitly released.
        The drain machine's per-task gate — a FINISHED task still serving
        chunks pins its node in DRAINING until consumers catch up or are
        handed to replacements."""
        with self._cv:
            return all(b._aborted or (b._no_more and b._ack >= b._next_token)
                       for b in self._buffers)

    def replayable_all(self) -> bool:
        """Every stream of this buffer can still replay from token 0 — the
        per-task drain-progress signal (a handoff is exactly-once only while
        this holds)."""
        with self._cv:
            return not self._nonreplayable and \
                all(not b.replay_lost and b._floor == 0 for b in self._buffers)

    def _trim_spool_locked(self) -> None:
        """Retire oldest-acked frames until the spool fits its bound, biggest
        spooler first (deterministic tie-break by buffer index)."""
        if self._spool_pinned:
            return
        while self._spool_bytes > self._spool_max:
            victim = max(self._buffers, key=lambda b: b.spooled_bytes_locked())
            freed = victim.drop_oldest_spooled_locked()
            if freed == 0:
                break
            self._account_spool_locked(-freed)

    # ------------------------------------------------------------- consumer

    def get(self, buffer_id: int, token: int, wait_s: float = 1.0
            ) -> Tuple[Optional[bytes], int, bool]:
        """Long-poll for frame `token` of `buffer_id`; acks frames below it
        into the spool. -> (frame|None, next_token, complete). Raises
        ReplayWindowLost when `token` was already retired."""
        import time as _t

        deadline = _t.monotonic() + wait_s
        with self._cv:
            if self._failed:
                raise RuntimeError(f"task output failed: {self._failed}")
            unacked, spooled = self._buffers[buffer_id].ack_locked(token)
            self._bytes -= unacked
            if self._nonreplayable:
                self._buffers[buffer_id].drop_spool_locked()
                spooled = 0
            self._account_spool_locked(spooled)
            self._trim_spool_locked()
            self._cv.notify_all()
            while True:
                frame, nxt, complete = \
                    self._buffers[buffer_id].get_locked(token)
                if frame is not None or complete:
                    return frame, nxt, complete
                remaining = deadline - _t.monotonic()
                if remaining <= 0:
                    return None, token, False
                self._cv.wait(timeout=remaining)
                if self._failed:
                    raise RuntimeError(f"task output failed: {self._failed}")

    def abort(self, buffer_id: int) -> None:
        """Consumer DELETE: retire a fully-delivered stream into the spool
        (still replayable by a recreated consumer) or release a mid-stream
        abort for good — see ClientBuffer.final_ack_locked."""
        with self._cv:
            unacked, spooled = self._buffers[buffer_id].final_ack_locked()
            self._bytes -= unacked
            self._account_spool_locked(-spooled)
            self._cv.notify_all()

    def destroy(self) -> None:
        with self._cv:
            for b in self._buffers:
                unacked, spooled = b.abort_locked()
                self._bytes -= unacked
                self._account_spool_locked(-spooled)
            self._no_more = True
            self._cv.notify_all()

    def retained_bytes(self) -> int:
        """Unacked bytes (the backpressure account; spool excluded — it is
        reported separately and accounted in the shared pool)."""
        with self._cv:
            return self._bytes

    def spooled_bytes(self) -> int:
        with self._cv:
            return self._spool_bytes

    def replayable(self, buffer_id: int) -> bool:
        """Can `buffer_id`'s stream still be replayed from token 0?"""
        with self._cv:
            b = self._buffers[buffer_id]
            return not (b.replay_lost or self._nonreplayable
                        or b._floor > 0)
