"""The disk rung of the memory ladder: PCOL runs under a per-query spill
directory.

Counterpart of ``presto_tpu/exec/spill.py`` (the reference's
FileSingleStreamSpiller / GenericSpiller / SpillSpaceTracker analogue).
Revocation first moves device state to host RAM; when the query has a disk
tier (``spill_to_disk``, on by default), the join build's host pages and
the grouping's host partials become PCOL runs (``formats/pcol.py``) here.

Accounting: every run's bytes are charged to the pool's spill ledger
(``MemoryPool.reserve_spill``), apart from the RAM reservations.
``spill_max_bytes`` bounds a query's bytes on disk (0 = no bound); going
over fails the query like the user-memory limit, journaling
``query.spill.failed``.

Lifecycle: the runner's ``_query_memory`` makes one manager per query and
closes it in the query's ``finally``: every run file and the query's
directory are deleted and the charged bytes released, however the query
ended. A process killed before its ``finally`` leaves its directory behind;
the first manager of a later process removes every directory of the root
whose leading pid is dead (``gc_leftover_runs``, journaling ``spill.gc``).

The root is ``<tempdir>/presto-tpu-torch-spill`` (or ``spill_dir``): the
reference's is ``presto-tpu-spill``, so the two packages in one process
never see each other's directories.

Fault injection: the ``spill.write`` and ``spill.read`` fire points
(``cluster/faults.py``) wrap the run I/O. A failed write or read journals
``query.spill.failed`` and raises into the owning query's driver, which
fails that query, with its forensic trace attached (``utils/trace.py``).

Counters ``spill.bytes_written`` and ``spill.bytes_read``, the
``spill.write_s`` histogram and the ``query.spill.disk`` event (one per
run) keep the reference's names.
"""
from __future__ import annotations

import itertools
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..block import Block, Dictionary, Page
from ..cluster import faults
from ..formats.pcol import PcolFile, write_pcol
from ..memory import ExceededMemoryLimitException, MemoryPool
from ..types import BIGINT, BOOLEAN, DOUBLE, INTEGER, REAL, SMALLINT, Type
from ..utils import events
from ..utils.metrics import METRICS

SPILL_DIR_NAME = "presto-tpu-torch-spill"

# numpy storage dtype -> engine Type for raw spill columns. Spilled state is
# written with the STORAGE type of its array (varchar codes as INTEGER, etc.);
# the consumer re-applies the original engine type/dictionary on read, so the
# round-trip is bit-exact. Arrays outside this map simply stay in host RAM —
# disk is an optimisation rung, never a correctness requirement.
_DTYPE_TO_TYPE: Dict[np.dtype, Type] = {
    np.dtype(np.int64): BIGINT,
    np.dtype(np.int32): INTEGER,
    np.dtype(np.int16): SMALLINT,
    np.dtype(np.bool_): BOOLEAN,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.float32): REAL,
}


def storage_type_for(dtype) -> Optional[Type]:
    """Engine Type that stores `dtype` losslessly in a pcol chunk, or None
    when this array shape cannot go to disk (caller keeps it in host RAM)."""
    return _DTYPE_TO_TYPE.get(np.dtype(dtype))


class SpillRun:
    """One on-disk PCOL run: the unit of spill write/read/delete."""

    __slots__ = ("path", "rows", "nbytes", "names", "meta")

    def __init__(self, path: str, rows: int, nbytes: int,
                 names: Tuple[str, ...], meta: Dict):
        self.path = path
        self.rows = rows
        self.nbytes = nbytes
        self.names = names
        self.meta = meta    # consumer payload (partition index, block specs)

    def __repr__(self):
        return f"SpillRun({os.path.basename(self.path)}, rows={self.rows})"


def spill_root(spill_dir: str = "") -> str:
    """The shared parent of every query's spill directory."""
    import tempfile
    base = spill_dir or os.path.join(tempfile.gettempdir(), SPILL_DIR_NAME)
    return base


_GC_LOCK = threading.Lock()
_GC_DONE: set = set()       # roots already swept by this process


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return True
    return True


def gc_leftover_runs(root: str) -> int:
    """Remove sibling spill directories left by DEAD processes (a SIGKILL
    never runs the query-release ``finally``). Swept once per root per
    process, at the first SpillManager construction."""
    removed = 0
    with _GC_LOCK:
        if root in _GC_DONE:
            return 0
        _GC_DONE.add(root)
        try:
            entries = os.listdir(root)
        except OSError:
            return 0
        for name in entries:
            pid_s = name.split("-", 1)[0]
            if not pid_s.isdigit():
                continue
            pid = int(pid_s)
            if pid == os.getpid() or _pid_alive(pid):
                continue
            try:
                shutil.rmtree(os.path.join(root, name))
                removed += 1
            except OSError:
                pass
    if removed:
        events.emit("spill.gc", severity=events.INFO, removed_dirs=removed,
                    root=root)
    return removed


class SpillManager:
    """Per-query writer/reader/owner of on-disk PCOL runs.

    Thread-safe: concurrent drivers of one query may spill at once. The
    manager owns exactly the bytes it charged — `close()` (idempotent,
    never raises) releases them and removes the directory, so per-task
    managers of one cluster query compose without double-releasing."""

    _SEQ = itertools.count(1)

    def __init__(self, query_id: str, pool: MemoryPool, spill_dir: str = "",
                 max_bytes: int = 0):
        self.query_id = query_id
        self.pool = pool
        self.max_bytes = int(max_bytes or 0)
        self._root = spill_root(spill_dir)
        safe = "".join(c if c.isalnum() or c in "._" else "_"
                       for c in query_id)
        self._dir = os.path.join(
            self._root, f"{os.getpid()}-{next(SpillManager._SEQ)}-{safe}")
        self._lock = threading.Lock()
        self._runs: List[SpillRun] = []
        self._file_seq = itertools.count(1)
        self._charged = 0
        self._closed = False
        gc_leftover_runs(self._root)

    # ------------------------------------------------------------ write side

    def write_pages(self, names: Sequence[str], types: Sequence[Type],
                    dicts: Sequence[Optional[Dictionary]],
                    pages: Sequence[Page], kind: str = "run",
                    meta: Optional[Dict] = None) -> SpillRun:
        """Write pages' live rows as one PCOL run; charges the pool's spill
        ledger, bumps spill metrics, journals ``query.spill.disk``. Raises
        on I/O failure or the per-query `spill_max_bytes` limit — failing
        the owning query is the contract; the shared state stays clean."""
        t0 = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("spill manager is closed")
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(self._dir,
                                f"{kind}-{next(self._file_seq)}.pcol")
        try:
            faults.fire("spill.write", query_id=self.query_id, location=path)
            rows = write_pcol(path, list(names), list(types), list(dicts),
                              list(pages))
            nbytes = os.path.getsize(path)
        except BaseException as e:
            try:
                if os.path.exists(path):
                    os.remove(path)
            except OSError:
                pass
            events.emit("query.spill.failed", severity=events.ERROR,
                        query_id=self.query_id, op="write", path=path,
                        error=str(e))
            raise
        run = SpillRun(path, rows, nbytes, tuple(names), dict(meta or {}))
        with self._lock:
            self._runs.append(run)
            self._charged += nbytes
        self.pool.reserve_spill(self.query_id, nbytes)
        disk_total = self.pool.spill_bytes(self.query_id)
        if self.max_bytes and disk_total > self.max_bytes:
            events.emit("query.spill.failed", severity=events.ERROR,
                        query_id=self.query_id, op="limit",
                        disk_bytes=disk_total, limit_bytes=self.max_bytes)
            self.release(run)
            raise ExceededMemoryLimitException("per-query disk spill",
                                               self.max_bytes)
        METRICS.count("spill.bytes_written", nbytes)
        METRICS.histogram("spill.write_s", time.perf_counter() - t0)
        events.emit("query.spill.disk", severity=events.WARN,
                    query_id=self.query_id, run_kind=kind, rows=rows,
                    run_bytes=nbytes, disk_bytes=disk_total,
                    pool_reserved_bytes=self.pool.reserved_bytes(),
                    path=path)
        return run

    def write_columns(self, names: Sequence[str],
                      cols: Sequence[np.ndarray], kind: str = "run",
                      meta: Optional[Dict] = None) -> SpillRun:
        """Write bare same-length numpy columns (no nulls) with their
        storage types — the aggregation's partial-run shape. Every dtype
        must be mappable (check :func:`storage_type_for` first)."""
        types = []
        for name, col in zip(names, cols):
            t = storage_type_for(col.dtype)
            if t is None:
                raise ValueError(
                    f"spill column {name}: dtype {col.dtype} has no pcol "
                    "storage type")
            types.append(t)
        n = len(cols[0]) if cols else 0
        blocks = tuple(Block(t, torch.from_numpy(np.ascontiguousarray(c)), None, None)
                       for t, c in zip(types, cols))
        page = Page(blocks, torch.ones(n, dtype=torch.bool))
        return self.write_pages(names, types, [None] * len(types), [page],
                                kind=kind, meta=meta)

    # ------------------------------------------------------------- read side

    def read_columns(self, run: SpillRun) -> List[Tuple[np.ndarray,
                                                        Optional[np.ndarray],
                                                        Optional[Dictionary]]]:
        """Read a run back: [(data copy, null mask or None, dict or None)]
        per column in `run.names` order. Copies — the file may be released
        immediately after."""
        try:
            faults.fire("spill.read", query_id=self.query_id,
                        location=run.path)
            f = PcolFile(run.path)
        except BaseException as e:
            events.emit("query.spill.failed", severity=events.ERROR,
                        query_id=self.query_id, op="read", path=run.path,
                        error=str(e))
            raise
        try:
            out = []
            for name in run.names:
                data, nulls, d = f.read_column(name)
                out.append((np.array(data, copy=True),
                            None if nulls is None else np.array(nulls,
                                                                copy=True),
                            d))
        finally:
            f.close()
        METRICS.count("spill.bytes_read", run.nbytes)
        return out

    # ------------------------------------------------------------- lifecycle

    def release(self, run: SpillRun) -> None:
        """Delete one run's file and release its charged bytes."""
        with self._lock:
            if run not in self._runs:
                return
            self._runs.remove(run)
            self._charged -= run.nbytes
        self.pool.reserve_spill(self.query_id, -run.nbytes)
        try:
            os.remove(run.path)
        except OSError:
            pass

    def disk_bytes(self) -> int:
        """Bytes this manager currently holds on disk."""
        with self._lock:
            return self._charged

    def close(self) -> None:
        """Query-release backstop: delete every run + the per-query dir and
        release exactly the bytes THIS manager charged. Idempotent; never
        raises (it runs in ``finally`` blocks)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            charged = self._charged
            self._charged = 0
            self._runs = []
        if charged:
            self.pool.reserve_spill(self.query_id, -charged)
        try:
            shutil.rmtree(self._dir)
        except OSError:
            pass

    def __repr__(self):
        return (f"SpillManager({self.query_id}, runs={len(self._runs)}, "
                f"bytes={self._charged})")
