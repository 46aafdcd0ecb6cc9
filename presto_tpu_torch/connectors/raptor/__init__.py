"""Raptor connector of the PyTorch port: engine-owned shards behind a
metadata database.

Counterpart of ``presto_tpu/connectors/raptor/__init__.py``, with the same
database schema and storage layout, so each package reads the other's
store. Unlike the file and hive connectors, which read whatever lives in a
directory, this connector owns its storage: every table is a set of
immutable PCOL shards named by UUID under ``<base>/storage/``, registered in
a sqlite database (``<base>/metadata.db``) with each shard's row count and
its columns' integer min/max.

- The database is the source of truth: tables, schemas and shard lists
  come from it, so a stray file is invisible and a drop is one transaction.
- Scans prune shards in SQL, against the shards' min/max in the database.
- ``maintenance()`` compacts the shards under ``compaction_threshold_rows``
  into one (read, rewritten, swapped in one transaction) and removes the
  files of shards dropped more than ``grace_s`` ago, so a query that
  already listed its splits can finish. ``organize_interval_s`` > 0 runs it
  on an organizer thread, which ``shutdown()`` stops and joins.

The sqlite connection is shared by the writers', the drivers' and the
organizer's threads (``check_same_thread=False``), so every use of it holds
the manager's lock. Each sink writes one shard when it finishes: a CTAS
creates the table's rows, then appends; an INSERT appends.
"""
from __future__ import annotations

import os
import sqlite3
import sys
import threading
import time
import uuid as uuidlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...block import Block, Dictionary, Page
from ...formats.pcol import PcolFile, _type_from_tag, _type_tag, write_pcol
from ...spi.connector import (ColumnHandle, ColumnMetadata, Connector, ConnectorMetadata,
                              ConnectorPageSink, ConnectorPageSinkProvider,
                              ConnectorPageSource, ConnectorPageSourceProvider,
                              ConnectorSplitManager, Constraint, SchemaTableName, Split,
                              TableHandle, TableMetadata, TableStatistics)
from ..file import _materialize_dicts, iter_pcol_pages
from ..memory import host_page

_SCHEMA = """
create table if not exists tables (
    table_id integer primary key autoincrement,
    schema_name text not null,
    table_name text not null,
    unique (schema_name, table_name)
);
create table if not exists columns (
    table_id integer not null,
    ordinal integer not null,
    column_name text not null,
    type_tag text not null,
    type_scale integer not null,
    primary key (table_id, ordinal)
);
create table if not exists shards (
    shard_uuid text primary key,
    table_id integer not null,
    row_count integer not null,
    compacted integer not null default 0
);
create table if not exists shard_stats (
    shard_uuid text not null,
    column_name text not null,
    min_value integer,
    max_value integer,
    primary key (shard_uuid, column_name)
);
create table if not exists deleted_shards (
    shard_uuid text primary key,
    dropped_at real not null
);
"""


class ShardManager:
    """The metadata database: tables, columns, shards and their stats."""

    def __init__(self, base_dir: str):
        self.base = base_dir
        os.makedirs(os.path.join(base_dir, "storage"), exist_ok=True)
        self.lock = threading.RLock()
        self._conn = sqlite3.connect(os.path.join(base_dir, "metadata.db"),
                                     check_same_thread=False)
        with self.lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def close(self) -> None:
        with self.lock:
            self._conn.close()

    # ------------------------------------------------------------- tables

    def create_table(self, name: SchemaTableName, columns: Sequence[ColumnMetadata]) -> int:
        with self.lock:
            tid = self._conn.execute(
                "insert into tables (schema_name, table_name) values (?, ?)",
                (name.schema, name.table)).lastrowid
            for i, c in enumerate(columns):
                tag, scale = _type_tag(c.type)
                self._conn.execute("insert into columns values (?, ?, ?, ?, ?)",
                                   (tid, i, c.name, tag, scale))
            self._conn.commit()
            return tid

    def table_id(self, name: SchemaTableName) -> Optional[int]:
        with self.lock:
            row = self._conn.execute(
                "select table_id from tables where schema_name = ? and table_name = ?",
                (name.schema, name.table)).fetchone()
        return row[0] if row else None

    def list_tables(self, schema: Optional[str]) -> List[SchemaTableName]:
        q = "select schema_name, table_name from tables"
        args: tuple = ()
        if schema:
            q += " where schema_name = ?"
            args = (schema,)
        with self.lock:
            rows = self._conn.execute(q + " order by 1, 2", args).fetchall()
        return [SchemaTableName(s, t) for s, t in rows]

    def list_schemas(self) -> List[str]:
        with self.lock:
            rows = self._conn.execute(
                "select distinct schema_name from tables order by 1").fetchall()
        return [r[0] for r in rows] or ["default"]

    def columns(self, tid: int) -> List[Tuple[str, object]]:
        with self.lock:
            rows = self._conn.execute(
                "select column_name, type_tag, type_scale from columns "
                "where table_id = ? order by ordinal", (tid,)).fetchall()
        return [(n, _type_from_tag(tag, scale)) for n, tag, scale in rows]

    def drop_table(self, tid: int) -> None:
        """The metadata goes at once (the table vanishes); the shard files go
        through ``deleted_shards``, as compaction's leftovers do, so a query
        that already listed its splits can still finish."""
        with self.lock:
            shards = [r[0] for r in self._conn.execute(
                "select shard_uuid from shards where table_id = ?", (tid,)).fetchall()]
            for table in ("tables", "columns", "shards"):
                self._conn.execute(f"delete from {table} where table_id = ?", (tid,))
            for u in shards:
                self._conn.execute("delete from shard_stats where shard_uuid = ?", (u,))
                self._conn.execute("insert or replace into deleted_shards values (?, ?)",
                                   (u, time.time()))
            self._conn.commit()

    # ------------------------------------------------------------- shards

    def shard_path(self, shard_uuid: str) -> str:
        return os.path.join(self.base, "storage", f"{shard_uuid}.pcol")

    def _insert_shard(self, tid: int, shard_uuid: str, rows: int, stats: Dict,
                      compacted: bool) -> None:
        self._conn.execute("insert into shards values (?, ?, ?, ?)",
                           (shard_uuid, tid, rows, 1 if compacted else 0))
        for col, (mn, mx) in stats.items():
            self._conn.execute("insert into shard_stats values (?, ?, ?, ?)",
                               (shard_uuid, col, mn, mx))

    def register_shard(self, tid: int, shard_uuid: str, rows: int,
                       stats: Dict[str, Tuple[Optional[int], Optional[int]]],
                       compacted: bool = False) -> None:
        with self.lock:
            self._insert_shard(tid, shard_uuid, rows, stats, compacted)
            self._conn.commit()

    def replace_shards(self, tid: int, old: Sequence[str], new_uuid: str, rows: int,
                       stats: Dict, compacted: bool) -> None:
        """Compaction's swap, in one transaction. The old shards' files stay:
        a query that already listed its splits may still open them; they go
        to ``deleted_shards`` for a later ``purge_deleted``."""
        with self.lock:
            for u in old:
                self._conn.execute("delete from shards where shard_uuid = ?", (u,))
                self._conn.execute("delete from shard_stats where shard_uuid = ?", (u,))
                self._conn.execute("insert or replace into deleted_shards values (?, ?)",
                                   (u, time.time()))
            self._insert_shard(tid, new_uuid, rows, stats, compacted)
            self._conn.commit()

    def purge_deleted(self, grace_s: float) -> int:
        """Unlink the files of shards dropped more than ``grace_s`` ago."""
        # the wall clock: dropped_at holds epoch times that outlive a process
        cutoff = time.time() - grace_s
        with self.lock:
            rows = self._conn.execute(
                "select shard_uuid from deleted_shards where dropped_at < ?",
                (cutoff,)).fetchall()
            for (u,) in rows:
                self._conn.execute("delete from deleted_shards where shard_uuid = ?", (u,))
            self._conn.commit()
        for (u,) in rows:
            try:
                os.unlink(self.shard_path(u))
            except OSError:
                pass
        return len(rows)

    def shards(self, tid: int, constraint: Optional[Constraint] = None) -> List[Tuple[str, int]]:
        """-> [(uuid, rows)], pruned in SQL: an anti-join against the shards
        whose min/max lie outside an integer domain."""
        q = "select shard_uuid, row_count from shards where table_id = ?"
        args: list = [tid]
        if constraint and constraint.domains:
            for col, dom in constraint.domains.items():
                lo, hi = dom if isinstance(dom, tuple) else (None, None)
                if (lo is None and hi is None) or isinstance(lo, float) or \
                        isinstance(hi, float):
                    continue
                conds, cargs = [], []
                if hi is not None:
                    conds.append("min_value > ?")
                    cargs.append(int(hi))
                if lo is not None:
                    conds.append("max_value < ?")
                    cargs.append(int(lo))
                q += (" and shard_uuid not in (select shard_uuid from shard_stats "
                      "where column_name = ? and (" + " or ".join(conds) + "))")
                args.append(col)
                args.extend(cargs)
        with self.lock:
            return self._conn.execute(q, args).fetchall()

    def table_rows(self, tid: int) -> int:
        with self.lock:
            row = self._conn.execute(
                "select coalesce(sum(row_count), 0) from shards where table_id = ?",
                (tid,)).fetchone()
        return int(row[0])

    def small_shards(self, tid: int, threshold_rows: int) -> List[str]:
        """Every shard under the threshold is a merge candidate, earlier
        compaction outputs included (else small inserts would strand tiny
        shards for good)."""
        with self.lock:
            rows = self._conn.execute(
                "select shard_uuid from shards where table_id = ? and row_count < ?",
                (tid, threshold_rows)).fetchall()
        return [r[0] for r in rows]

    def all_table_ids(self) -> List[int]:
        with self.lock:
            return [r[0] for r in self._conn.execute("select table_id from tables").fetchall()]


def _shard_stats(path: str) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """Integer min/max per column, from the PCOL header's write-time stats."""
    pf = PcolFile(path)
    try:
        out = {}
        for name in pf.columns:
            mn, mx = pf.column_stats(name)
            if mn is not None and not isinstance(mn, float):
                out[name] = (int(mn), int(mx))
        return out
    finally:
        pf.close()


class RaptorMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str, shard_manager: ShardManager):
        self.connector_id = connector_id
        self.shards = shard_manager
        self._dict_cache: Dict[int, Dict[str, Dictionary]] = {}
        self._dict_versions: Dict[int, tuple] = {}
        self._lock = threading.Lock()

    def list_schemas(self) -> List[str]:
        return self.shards.list_schemas()

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        return self.shards.list_tables(schema)

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        tid = self.shards.table_id(name)
        if tid is None:
            return None
        return TableHandle(self.connector_id, name, extra=(tid,))

    def _dictionaries(self, tid: int) -> Dict[str, Dictionary]:
        """The union of the shards' varchar dictionaries, in first-seen
        order. Shards are immutable, so the cached union extends with the
        unseen shards only; a shard set that lost a shard (a compaction
        swap) rebuilds it."""
        shard_ids = tuple(u for u, _ in self.shards.shards(tid))
        with self._lock:
            cached = self._dict_versions.get(tid)
            if cached is not None and cached[0] == shard_ids:
                return self._dict_cache[tid]
            if cached is not None and set(cached[0]) <= set(shard_ids):
                old = set(cached[0])
                new_ids = [u for u in shard_ids if u not in old]
                order = {n: dict(v) for n, v in cached[1].items()}
            else:
                new_ids, order = list(shard_ids), {}
        for u in new_ids:
            pf = PcolFile(self.shards.shard_path(u))
            try:
                for name, e in pf.columns.items():
                    if "dict" in e:
                        order.setdefault(name, {}).update(dict.fromkeys(e["dict"]))
            finally:
                pf.close()
        dicts = {n: Dictionary(list(vals)) for n, vals in order.items()}
        with self._lock:
            self._dict_cache[tid] = dicts
            self._dict_versions[tid] = (shard_ids, order)
        return dicts

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        tid = table.extra[0]
        dicts = self._dictionaries(tid)
        return TableMetadata(table.schema_table, tuple(
            ColumnMetadata(n, t, dictionary=dicts.get(n)) for n, t in self.shards.columns(tid)))

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        return TableStatistics(row_count=float(self.shards.table_rows(table.extra[0])))

    # --------------------------------------------------------------- writes

    def create_table(self, metadata: TableMetadata, properties=None) -> None:
        if properties:
            raise ValueError("raptor tables take no properties")
        if self.shards.table_id(metadata.name) is not None:
            raise ValueError(f"table {metadata.name} already exists")
        self.shards.create_table(metadata.name, metadata.columns)

    def begin_insert(self, table: TableHandle):
        return table

    def finish_insert(self, handle, fragments) -> None:
        # nothing to drop: _dictionaries sees the new shard ids and extends
        # its cached union
        pass

    def drop_table(self, table: TableHandle) -> None:
        self.shards.drop_table(table.extra[0])
        with self._lock:
            self._dict_versions.pop(table.extra[0], None)


class RaptorSplitManager(ConnectorSplitManager):
    """One split per shard, pruned in the metadata database."""

    def __init__(self, connector_id: str, metadata: RaptorMetadata):
        self.connector_id = connector_id
        self._metadata = metadata

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        tid = table.extra[0]
        return [Split(self.connector_id, payload=(table.schema_table, tid, u))
                for u, rows in self._metadata.shards.shards(tid, constraint) if rows > 0]


class RaptorPageSource(ConnectorPageSource):
    """One shard's pages (``iter_pcol_pages``), its varchar codes remapped
    into the table's unioned dictionaries."""

    def __init__(self, metadata: RaptorMetadata, split: Split,
                 columns: Sequence[ColumnHandle], capacity: int):
        self._metadata = metadata
        self.split = split
        self.columns = list(columns)
        self.capacity = capacity

    def __iter__(self) -> Iterator[Page]:
        name, tid, shard_uuid = self.split.payload
        meta = self._metadata.get_table_metadata(
            TableHandle(self._metadata.connector_id, name, extra=(tid,)))
        table_dicts = {c.name: c.dictionary for c in meta.columns}
        type_of = {c.name: meta.column(c.name).type for c in self.columns}
        yield from iter_pcol_pages(self._metadata.shards.shard_path(shard_uuid),
                                   [c.name for c in self.columns], type_of, table_dicts,
                                   self.capacity)


class RaptorPageSourceProvider(ConnectorPageSourceProvider):
    def __init__(self, metadata: RaptorMetadata):
        self._metadata = metadata

    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        return RaptorPageSource(self._metadata, split, columns, page_capacity)


class RaptorPageSink(ConnectorPageSink):
    """Buffers written pages in host RAM; ``finish`` writes ONE shard and
    registers it, with its stats, in the metadata database."""

    def __init__(self, metadata: RaptorMetadata, table: TableHandle):
        self._metadata = metadata
        self._table = table
        self._pages: List[Page] = []
        self.rows_written = 0

    def append_page(self, page: Page) -> None:
        host = host_page(page)  # one device-to-host copy of the blocks and mask
        self._pages.append(host)
        self.rows_written += int(host.mask.sum())

    def finish(self):
        if not self._pages:
            return []
        tid = self._table.extra[0]
        shards = self._metadata.shards
        meta = self._metadata.get_table_metadata(self._table)
        dicts, pages = _materialize_dicts(self._pages)
        shard_uuid = str(uuidlib.uuid4())
        path = shards.shard_path(shard_uuid)
        rows = write_pcol(path, [c.name for c in meta.columns], [c.type for c in meta.columns],
                          dicts, pages)
        shards.register_shard(tid, shard_uuid, rows, _shard_stats(path))
        return [shard_uuid]


class RaptorPageSinkProvider(ConnectorPageSinkProvider):
    def __init__(self, metadata: RaptorMetadata):
        self._metadata = metadata

    def create_page_sink(self, insert_handle) -> ConnectorPageSink:
        return RaptorPageSink(self._metadata, insert_handle)


class RaptorConnector(Connector):
    def __init__(self, connector_id: str, base_dir: str,
                 compaction_threshold_rows: int = 1 << 17, organize_interval_s: float = 0.0):
        self.shard_manager = ShardManager(base_dir)
        self._metadata = RaptorMetadata(connector_id, self.shard_manager)
        self._splits = RaptorSplitManager(connector_id, self._metadata)
        self._sources = RaptorPageSourceProvider(self._metadata)
        self._sinks = RaptorPageSinkProvider(self._metadata)
        self.compaction_threshold_rows = compaction_threshold_rows
        # one compaction pass at a time: the organizer racing an on-demand
        # maintenance() would merge the same shards twice
        self._organize_lock = threading.Lock()
        self._organizer_stop = threading.Event()
        self._organizer: Optional[threading.Thread] = None
        if organize_interval_s > 0:
            self._organizer = threading.Thread(target=self._organizer_loop,
                                               args=(organize_interval_s,), daemon=True,
                                               name="raptor-organizer")
            self._organizer.start()

    # -------------------------------------------------------- organization

    def maintenance(self, grace_s: float = 300.0) -> int:
        """Compact small shards table by table and remove the files of
        shards dropped more than ``grace_s`` ago. -> the shards compaction
        removed."""
        with self._organize_lock:
            self.shard_manager.purge_deleted(grace_s)
            return sum(self._compact_table(tid) for tid in self.shard_manager.all_table_ids())

    def _compact_table(self, tid: int) -> int:
        """Read every shard under the threshold whole and rewrite them as one
        shard, each varchar column re-encoded into the union of their
        dictionaries (first-seen order); the swap is one transaction, so a
        reader never sees a gap."""
        sm = self.shard_manager
        small = sm.small_shards(tid, self.compaction_threshold_rows)
        if len(small) < 2:
            return 0
        cols = sm.columns(tid)
        names = [n for n, _ in cols]
        types = [t for _, t in cols]
        datas: Dict[str, List[np.ndarray]] = {n: [] for n in names}
        nullss: Dict[str, List[np.ndarray]] = {n: [] for n in names}
        dict_values: Dict[str, Dict[str, int]] = {}
        total = 0
        for u in small:
            pf = PcolFile(sm.shard_path(u))
            try:
                for n in names:
                    data, nulls, _ = pf.read_column(n)
                    # copies: the reads are views of a mapping that close() unmaps
                    data = np.array(data)
                    e = pf.columns[n]
                    if "dict" in e:
                        have = dict_values.setdefault(n, {})
                        remap = np.empty(max(len(e["dict"]), 1), dtype=np.int32)
                        for i, v in enumerate(e["dict"]):
                            remap[i] = have.setdefault(v, len(have))
                        data = remap[np.clip(data.astype(np.int64), 0, len(remap) - 1)]
                    datas[n].append(data)
                    nullss[n].append(np.array(nulls) if nulls is not None
                                     else np.zeros(pf.rows, dtype=bool))
                total += pf.rows
            finally:
                pf.close()
        blocks, dicts = [], []
        for t, n in zip(types, names):
            data = np.concatenate(datas[n])
            nm = np.concatenate(nullss[n])
            d = Dictionary(list(dict_values[n])) if n in dict_values else None
            dicts.append(d)
            blocks.append(Block(t, torch.from_numpy(np.ascontiguousarray(
                data.astype(t.np_dtype, copy=False))),
                torch.from_numpy(nm) if nm.any() else None, d))
        new_uuid = str(uuidlib.uuid4())
        path = sm.shard_path(new_uuid)
        write_pcol(path, names, types, dicts,
                   [Page(tuple(blocks), torch.ones(total, dtype=torch.bool))])
        # only an output that reached the threshold stops being a candidate:
        # a small one stays mergeable with later inserts
        sm.replace_shards(tid, small, new_uuid, total, _shard_stats(path),
                          compacted=total >= self.compaction_threshold_rows)
        return len(small)

    def _organizer_loop(self, interval_s: float) -> None:
        while not self._organizer_stop.wait(interval_s):
            try:
                self.maintenance()
            except Exception as e:  # noqa: BLE001 - the organizer survives a failed round
                # a silent failure would leave shards unmerged for good
                print(f"presto_tpu_torch: raptor organizer: maintenance failed: {e!r}",
                      file=sys.stderr)

    def shutdown(self) -> None:
        """Stop and join the organizer thread, then close the database."""
        self._organizer_stop.set()
        if self._organizer is not None:
            self._organizer.join()
        self.shard_manager.close()

    # ----------------------------------------------------------------- spi

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources

    def page_sink_provider(self) -> Optional[ConnectorPageSinkProvider]:
        return self._sinks
