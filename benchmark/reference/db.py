"""The reference's tables: columns of the frozen generator, made once.

``Database(sf)`` hands out whole columns of a TPC-H table at scale factor
``sf`` as int64 numpy arrays (string columns as their dictionary codes). A
column is generated at first use, lineitem in chunks of orders on a few
threads, and kept in memory. With a ``cache_dir`` it is also saved there as
``<table>.<column>.npy`` in the smallest integer type that holds it, under a
directory named by the scale factor and a digest of the generator's source,
so a later run at the same scale loads it instead and an edited generator
never reads stale columns.

Nothing here imports the program.
"""
from __future__ import annotations

import hashlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from . import tpch_gen as g

# orders per lineitem generation chunk, and chunks made at once
CHUNK_ORDERS = 1 << 18
THREADS = 8
_DIGEST = hashlib.sha256(Path(g.__file__).read_bytes()).hexdigest()[:12]


def _narrowest(a: np.ndarray) -> np.ndarray:
    if a.size == 0:
        return a
    lo, hi = int(a.min()), int(a.max())
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return a.astype(dt)
    return a


class Database:
    """Whole columns of the TPC-H tables at one scale factor."""

    def __init__(self, sf: float, cache_dir: Optional[str] = None):
        self.sf = float(sf)
        self._cols: Dict[tuple, np.ndarray] = {}
        self._lock = threading.Lock()
        self.cache = None
        if cache_dir:
            self.cache = Path(cache_dir) / f"sf{self.sf:g}-{_DIGEST}"

    def rows(self, table: str) -> int:
        return g.table_row_count(table, self.sf)

    def column(self, table: str, name: str) -> np.ndarray:
        return self.columns(table, [name])[name]

    def columns(self, table: str, names: Sequence[str]) -> Dict[str, np.ndarray]:
        with self._lock:
            missing = [n for n in names if (table, n) not in self._cols]
            loaded = {n: self._load(table, n) for n in missing}
            todo = [n for n, a in loaded.items() if a is None]
            made = self._generate(table, todo) if todo else {}
            for n in missing:
                a = loaded[n] if loaded[n] is not None else made[n]
                self._cols[(table, n)] = a.astype(np.int64, copy=False)
                if loaded[n] is None:
                    self._save(table, n, a)
            return {n: self._cols[(table, n)] for n in names}

    # ----------------------------------------------------------- generation

    def _generate(self, table: str, names: Sequence[str]) -> Dict[str, np.ndarray]:
        if table != "lineitem":
            return g.generate_rows(table, 0, self.rows(table), self.sf, list(names))
        orders = g.table_row_count("orders", self.sf)
        lows = list(range(0, orders, CHUNK_ORDERS))

        def make(lo):
            return g.lineitem_for_orders(lo, min(lo + CHUNK_ORDERS, orders), self.sf,
                                         list(names))

        with ThreadPoolExecutor(THREADS) as pool:
            parts = list(pool.map(make, lows))
        return {n: np.concatenate([p[n] for p in parts]) for n in names}

    # ---------------------------------------------------------------- cache

    def _path(self, table: str, name: str) -> Optional[Path]:
        return None if self.cache is None else self.cache / f"{table}.{name}.npy"

    def _load(self, table: str, name: str) -> Optional[np.ndarray]:
        path = self._path(table, name)
        if path is None or not path.exists():
            return None
        return np.load(path)

    def _save(self, table: str, name: str, a: np.ndarray) -> None:
        path = self._path(table, name)
        if path is None:
            return
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npy")
        np.save(tmp, _narrowest(a))
        os.replace(tmp, path)
