"""Hive connector of the PyTorch port: partitioned and bucketed directory
tables.

Counterpart of ``presto_tpu/connectors/hive/__init__.py``, with the same
layout on disk, so each package reads the other's warehouse:

- **File metastore**: each table directory carries a ``.hive.json``
  descriptor (columns, partition keys, bucket spec, storage format); the
  partition list is discovered from the directory tree.
- **Partition layout**: ``<base>/<schema>/<table>/<k1>=<v1>/<k2>=<v2>/files``.
  Partition-key columns are virtual: their value is constant per partition
  and is filled in as constant blocks at scan time.
- **Partition pruning** compares the partition values with the pushed-down
  domains, exactly (a key is constant over its files).
- **Buckets**: ``bucket_count`` + ``bucketed_by`` in the descriptor; data
  files are named ``bucket_NNNNN_<uuid>.<ext>`` and every split carries its
  bucket id, so grouped execution (``exec/grouped.py``) can run the plan
  one bucket at a time. The bucket hash is the engine's own multi-column
  splitmix64 (``bucket_ids``), kept in numpy on the host: it is the
  on-disk contract both packages share.
- **Formats**: PCOL, Parquet and ORC through the file connector's readers
  (``FilePageSource``), one split per file, row group or stripe, pruned by
  its statistics. The hive source reads serially (no split readers).
- **Writes**: INSERT / CTAS with dynamic partitioning. The sink takes each
  page to host RAM (``host_page``), groups its live rows by partition
  (``partition_groups``, numpy) and bucket, and writes one immutable file
  per (partition, bucket) when it finishes.

``partition_groups`` replaces the reference's per-row Python loop (one
``Dictionary.lookup`` per row) with ``np.unique`` over the key columns,
giving the same ``{key: rows}`` map in the same first-seen key order.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple
from urllib.parse import quote, unquote

import numpy as np
import torch

from ...block import Block, Dictionary, Page
from ...formats.pcol import PcolFile, _host, _type_from_tag, _type_tag, write_pcol
from ...spi.connector import (ColumnHandle, ColumnMetadata, ColumnStatistics, Connector,
                              ConnectorMetadata, ConnectorNodePartitioningProvider,
                              ConnectorPageSink, ConnectorPageSinkProvider,
                              ConnectorPageSource, ConnectorPageSourceProvider,
                              ConnectorSplitManager, Constraint, SchemaTableName, Split,
                              TableHandle, TableMetadata, TableStatistics)
from ...types import DecimalType, Type, is_string
from ..file import FilePageSource, _ExternalFile, _materialize_dicts
from ..memory import host_page

DESCRIPTOR = ".hive.json"


# ---------------------------------------------------------------------------
# the descriptor (the metastore's table document)

class TableDescriptor:
    """Parsed ``.hive.json``: schema, partitioning, bucketing, format."""

    def __init__(self, columns: List[Tuple[str, Type]], partitioned_by: List[str],
                 bucketed_by: List[str], bucket_count: int, fmt: str,
                 dictionaries: Dict[str, List[str]]):
        if fmt not in ("pcol", "parquet", "orc"):
            raise ValueError(f"unknown hive storage format {fmt!r}")
        for p in partitioned_by:
            if p not in [c for c, _ in columns]:
                raise ValueError(f"partition column {p!r} not in schema")
        for b in bucketed_by:
            if b not in [c for c, _ in columns]:
                raise ValueError(f"bucket column {b!r} not in schema")
        if bucketed_by and bucket_count < 1:
            raise ValueError("bucketed_by requires bucket_count >= 1")
        self.columns = columns
        self.partitioned_by = partitioned_by
        self.bucketed_by = bucketed_by
        self.bucket_count = bucket_count
        self.format = fmt
        # the dictionaries of string partition columns; a data column's
        # dictionary lives in its files and is unioned at load
        self.dictionaries = dictionaries

    @property
    def data_columns(self) -> List[Tuple[str, Type]]:
        return [(n, t) for n, t in self.columns if n not in self.partitioned_by]

    def type_of(self, name: str) -> Type:
        for n, t in self.columns:
            if n == name:
                return t
        raise KeyError(name)

    def to_json(self) -> dict:
        return {
            "columns": [[n, *_type_tag(t)] for n, t in self.columns],
            "partitioned_by": self.partitioned_by,
            "bucketed_by": self.bucketed_by,
            "bucket_count": self.bucket_count,
            "format": self.format,
            "dictionaries": self.dictionaries,
        }

    @staticmethod
    def from_json(doc: dict) -> "TableDescriptor":
        return TableDescriptor(
            [(n, _type_from_tag(tag, scale)) for n, tag, scale in doc["columns"]],
            list(doc.get("partitioned_by", [])),
            list(doc.get("bucketed_by", [])),
            int(doc.get("bucket_count", 0)),
            doc.get("format", "pcol"),
            {k: list(v) for k, v in doc.get("dictionaries", {}).items()})

    def save(self, table_dir: str) -> None:
        os.makedirs(table_dir, exist_ok=True)
        tmp = os.path.join(table_dir, DESCRIPTOR + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f)
        os.replace(tmp, os.path.join(table_dir, DESCRIPTOR))

    @staticmethod
    def load(table_dir: str) -> Optional["TableDescriptor"]:
        p = os.path.join(table_dir, DESCRIPTOR)
        if not os.path.isfile(p):
            return None
        with open(p) as f:
            return TableDescriptor.from_json(json.load(f))


def _encode_partition_value(t: Type, v) -> str:
    """A typed value -> its directory-name token; ``__HIVE_NULL__`` marks a
    NULL key. Strings are percent-encoded so they round-trip."""
    if v is None:
        return "__HIVE_NULL__"
    if isinstance(t, DecimalType):
        return str(int(v))
    if is_string(t):
        return quote(str(v), safe="")
    if t.name == "boolean":
        return "true" if v else "false"
    return str(int(v)) if t.name not in ("double", "real") else repr(float(v))


def _decode_partition_value(t: Type, s: str):
    if s == "__HIVE_NULL__":
        return None
    if is_string(t):
        return unquote(s)
    if t.name == "boolean":
        return s == "true"
    if t.name in ("double", "real"):
        return float(s)
    return int(s)


class Partition:
    """One leaf directory: its typed key values and data files."""

    def __init__(self, rel_dir: str, values: Tuple, files: List[str]):
        self.rel_dir = rel_dir  # "k1=v1/k2=v2" ("" if unpartitioned)
        self.values = values    # typed, in partitioned_by order
        self.files = files      # absolute paths


_DATA_EXT = (".pcol", ".parquet", ".orc")


class _TableSnapshot:
    def __init__(self, desc: TableDescriptor, partitions: List[Partition],
                 metadata: TableMetadata, rows: int, signature):
        self.desc = desc
        self.partitions = partitions
        self.metadata = metadata
        self.rows = rows
        self.signature = signature


class HiveMetastore:
    """Directory-tree metastore: tables are directories with a
    ``.hive.json``, partitions the ``k=v`` leaf directories under them."""

    def __init__(self, base: str):
        self.base = base

    def table_dir(self, name: SchemaTableName) -> str:
        return os.path.join(self.base, name.schema, name.table)

    def list_schemas(self) -> List[str]:
        if not os.path.isdir(self.base):
            return []
        return sorted(d for d in os.listdir(self.base)
                      if os.path.isdir(os.path.join(self.base, d)))

    def list_tables(self, schema: Optional[str]) -> List[SchemaTableName]:
        out = []
        for s in ([schema] if schema else self.list_schemas()):
            sdir = os.path.join(self.base, s)
            if not os.path.isdir(sdir):
                continue
            for t in sorted(os.listdir(sdir)):
                if os.path.isfile(os.path.join(sdir, t, DESCRIPTOR)):
                    out.append(SchemaTableName(s, t))
        return out

    def create_schema(self, schema: str) -> None:
        os.makedirs(os.path.join(self.base, schema), exist_ok=True)

    def descriptor(self, name: SchemaTableName) -> Optional[TableDescriptor]:
        return TableDescriptor.load(self.table_dir(name))

    def partitions(self, name: SchemaTableName, desc: TableDescriptor) -> List[Partition]:
        """Walk the ``k=v`` tree; its depth is ``len(partitioned_by)``."""
        root = self.table_dir(name)
        pcols = [(p, desc.type_of(p)) for p in desc.partitioned_by]

        def walk(d: str, depth: int, rel: str, vals: tuple):
            if depth == len(pcols):
                files = sorted(os.path.join(d, f) for f in os.listdir(d)
                               if f.endswith(_DATA_EXT))
                if files:
                    yield Partition(rel, vals, files)
                return
            key, typ = pcols[depth]
            prefix = key + "="
            for sub in sorted(os.listdir(d)):
                full = os.path.join(d, sub)
                if not (os.path.isdir(full) and sub.startswith(prefix)):
                    continue
                v = _decode_partition_value(typ, sub[len(prefix):])
                yield from walk(full, depth + 1, os.path.join(rel, sub) if rel else sub,
                                vals + (v,))

        if not os.path.isdir(root):
            return []
        return list(walk(root, 0, "", ()))

    def signature(self, name: SchemaTableName):
        """Change detection: the modification times of the tree's entries."""
        sig = []
        for dirpath, _dirnames, filenames in os.walk(self.table_dir(name)):
            sig.append((dirpath, os.path.getmtime(dirpath)))
            for f in filenames:
                p = os.path.join(dirpath, f)
                sig.append((p, os.path.getmtime(p)))
        return tuple(sorted(sig))


# ---------------------------------------------------------------------------
# metadata

class HiveMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str, metastore: HiveMetastore):
        self.connector_id = connector_id
        self.store = metastore
        self._cache: Dict[SchemaTableName, _TableSnapshot] = {}
        self._lock = threading.Lock()

    def snapshot(self, name: SchemaTableName) -> Optional[_TableSnapshot]:
        desc = self.store.descriptor(name)
        if desc is None:
            return None
        sig = self.store.signature(name)
        with self._lock:
            cached = self._cache.get(name)
            if cached is not None and cached.signature == sig:
                return cached
        parts = self.store.partitions(name, desc)
        meta, rows = self._build_metadata(name, desc, parts)
        snap = _TableSnapshot(desc, parts, meta, rows, sig)
        with self._lock:
            self._cache[name] = snap
        return snap

    def _build_metadata(self, name: SchemaTableName, desc: TableDescriptor,
                        parts: List[Partition]) -> Tuple[TableMetadata, int]:
        """The schema from the descriptor. A varchar data column's dictionary
        is the union of its files' dictionaries, in first-seen order over the
        files (their codes remap into it at scan time); a varchar partition
        column's is the sorted union of the descriptor's values and the
        partitions' values, so plan-time string predicates resolve to
        codes."""
        rows = 0
        file_order: Dict[str, Dict[str, None]] = {}
        str_data = [n for n, t in desc.data_columns if is_string(t)]
        for part in parts:
            for f in part.files:
                if f.endswith(".pcol"):
                    pf = PcolFile(f)
                    try:
                        rows += pf.rows
                        for n in str_data:
                            e = pf.columns.get(n)
                            if e is not None and "dict" in e:
                                file_order.setdefault(n, {}).update(dict.fromkeys(e["dict"]))
                    finally:
                        pf.close()
                else:
                    xf = _ExternalFile(f)
                    try:
                        rows += xf.num_rows
                        for n in str_data:
                            distinct = xf.column_distinct_strings(n)
                            if distinct is not None:
                                file_order.setdefault(n, {}).update(dict.fromkeys(distinct))
                    finally:
                        xf.close()
        cols = []
        pidx = {p: i for i, p in enumerate(desc.partitioned_by)}
        for n, t in desc.columns:
            d = None
            if is_string(t):
                if n in pidx:
                    vals = dict.fromkeys(desc.dictionaries.get(n, []))
                    vals.update(dict.fromkeys(p.values[pidx[n]] for p in parts
                                              if p.values[pidx[n]] is not None))
                    d = Dictionary(sorted(vals))
                else:
                    d = Dictionary(list(file_order.get(n, {})))
            cols.append(ColumnMetadata(n, t, dictionary=d))
        return TableMetadata(name, tuple(cols)), rows

    # ------------------------------------------------------------------ spi

    def list_schemas(self) -> List[str]:
        return self.store.list_schemas()

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        return self.store.list_tables(schema)

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        if self.store.descriptor(name) is not None:
            return TableHandle(self.connector_id, name)
        return None

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        snap = self.snapshot(table.schema_table)
        if snap is None:
            raise ValueError(f"no such hive table {table.schema_table}")
        return snap.metadata

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        snap = self.snapshot(table.schema_table)
        if snap is None:
            return TableStatistics.empty()
        parts = prune_partitions(snap, constraint)
        if len(parts) == len(snap.partitions):
            rows = snap.rows
        else:
            rows = sum(_file_rows(f) for p in parts for f in p.files)
        cols: Dict[str, ColumnStatistics] = {}
        for n, i in {p: i for i, p in enumerate(snap.desc.partitioned_by)}.items():
            vals = {p.values[i] for p in parts}
            nn = [v for v in vals if v is not None]
            numeric = [v for v in nn if isinstance(v, (int, float))]
            cols[n] = ColumnStatistics(
                distinct_count=float(len(nn)),
                null_fraction=0.0 if None not in vals else 1.0 / max(len(vals), 1),
                min_value=float(min(numeric)) if numeric else None,
                max_value=float(max(numeric)) if numeric else None)
        return TableStatistics(row_count=float(rows), columns=cols)

    # --------------------------------------------------------------- writes

    #: the table properties a CTAS ``WITH (...)`` takes on a hive catalog
    TABLE_PROPERTIES = ("partitioned_by", "bucketed_by", "bucket_count", "format")

    def create_table(self, metadata: TableMetadata,
                     properties: Optional[Dict[str, Any]] = None) -> None:
        props = dict(properties or {})
        unknown = set(props) - set(self.TABLE_PROPERTIES)
        if unknown:
            raise ValueError(f"unknown hive table properties {sorted(unknown)} "
                             f"(supported: {list(self.TABLE_PROPERTIES)})")
        partitioned_by = list(props.get("partitioned_by", []))
        name = metadata.name
        if self.store.descriptor(name) is not None:
            raise ValueError(f"hive table {name} already exists")
        dicts = {c.name: list(c.dictionary.values) for c in metadata.columns
                 if c.dictionary is not None and hasattr(c.dictionary, "values")
                 and c.name in partitioned_by}
        TableDescriptor([(c.name, c.type) for c in metadata.columns], partitioned_by,
                        list(props.get("bucketed_by", [])),
                        int(props.get("bucket_count", 0)), props.get("format", "pcol"),
                        dicts).save(self.store.table_dir(name))

    def begin_insert(self, table: TableHandle):
        if self.snapshot(table.schema_table) is None:
            raise ValueError(f"no such hive table {table.schema_table}")
        return table

    def finish_insert(self, handle, fragments) -> None:
        with self._lock:
            self._cache.pop(handle.schema_table, None)

    def drop_table(self, table: TableHandle) -> None:
        d = self.store.table_dir(table.schema_table)
        if os.path.isdir(d):
            shutil.rmtree(d)
        with self._lock:
            self._cache.pop(table.schema_table, None)


def _file_rows(path: str) -> int:
    if path.endswith(".pcol"):
        pf = PcolFile(path)
        try:
            return pf.rows
        finally:
            pf.close()
    xf = _ExternalFile(path)
    try:
        return xf.num_rows
    finally:
        xf.close()


# ---------------------------------------------------------------------------
# partition pruning and splits

def prune_partitions(snap: _TableSnapshot, constraint: Constraint) -> List[Partition]:
    """Exact pruning of partition-key values against the pushed-down
    [lo, hi] domains. A string key's domain holds dictionary codes (string
    constants resolve to codes at plan time), so its values compare as
    codes."""
    if not constraint.domains:
        return snap.partitions
    desc = snap.desc
    pidx = {p: i for i, p in enumerate(desc.partitioned_by)}
    dmeta = {c.name: c for c in snap.metadata.columns}
    checks = []
    for col, dom in constraint.domains.items():
        i = pidx.get(col)
        if i is None:
            continue
        lo, hi = dom if isinstance(dom, tuple) else (None, None)
        if lo is None and hi is None:
            continue
        conv = None
        if is_string(desc.type_of(col)):
            d = dmeta[col].dictionary
            index = d.index() if d is not None else {}
            conv = index.get
        checks.append((i, lo, hi, conv))
    if not checks:
        return snap.partitions
    out = []
    for p in snap.partitions:
        keep = True
        for i, lo, hi, conv in checks:
            v = p.values[i]
            if v is not None and conv is not None:
                v = conv(v)
            # a range predicate never matches a NULL key
            if v is None or (lo is not None and v < lo) or (hi is not None and v > hi):
                keep = False
                break
        if keep:
            out.append(p)
    return out


_BUCKET_PREFIX = "bucket_"


def _bucket_of_file(path: str) -> Optional[int]:
    base = os.path.basename(path)
    if base.startswith(_BUCKET_PREFIX):
        try:
            return int(base[len(_BUCKET_PREFIX):].split("_", 1)[0])
        except ValueError:
            return None
    return None


def _chunk_keep(xf: _ExternalFile, g: int, constraint: Constraint) -> bool:
    for col, dom in constraint.domains.items():
        lo, hi = dom if isinstance(dom, tuple) else (None, None)
        stats = xf.chunk_stats(g, col)
        if stats is None or stats[0] is None or isinstance(stats[0], str):
            continue
        mn, mx = stats
        if (hi is not None and mn > hi) or (lo is not None and mx < lo):
            return False
    return True


class HiveSplitManager(ConnectorSplitManager):
    """Partition pruning, then one split per PCOL file and per Parquet row
    group or ORC stripe, pruned by its statistics. Each split carries its
    partition's directory (the page source fills the key columns from it)
    and, in a bucketed table, its file's bucket id."""

    def __init__(self, connector_id: str, metadata: HiveMetadata):
        self.connector_id = connector_id
        self._metadata = metadata
        # grouped execution asks once per bucket: the listing is kept by
        # (table, domains, the snapshot's signature)
        self._cache: Dict[tuple, List[Split]] = {}
        self._lock = threading.Lock()

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        snap = self._metadata.snapshot(table.schema_table)
        if snap is None:
            return []
        key = (table.schema_table, tuple(sorted(constraint.domains.items())), snap.signature)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return list(hit)
        bucketed = snap.desc.bucket_count > 0
        splits: List[Split] = []
        seq = 0
        for part in prune_partitions(snap, constraint):
            for f in part.files:
                # a file written outside the engine's bucket naming gets None,
                # so grouped execution sees the table as not groupable
                bucket = _bucket_of_file(f)
                if f.endswith(".pcol"):
                    if self._pcol_keep(f, constraint):
                        splits.append(Split(self.connector_id,
                                            payload=(table.schema_table, part.rel_dir, f, None),
                                            bucket=bucket if bucketed else seq))
                    seq += 1
                    continue
                xf = _ExternalFile(f)
                try:
                    for g in range(xf.n_chunks):
                        if xf.chunk_rows(g) > 0 and _chunk_keep(xf, g, constraint):
                            splits.append(Split(
                                self.connector_id,
                                payload=(table.schema_table, part.rel_dir, f, g),
                                bucket=bucket if bucketed else seq))
                        seq += 1
                finally:
                    xf.close()
        with self._lock:
            if len(self._cache) > 64:
                self._cache.clear()
            self._cache[key] = list(splits)
        return splits

    @staticmethod
    def _pcol_keep(path: str, constraint: Constraint) -> bool:
        if not constraint.domains:
            return True
        pf = PcolFile(path)
        try:
            if pf.rows == 0:
                return False
            for col, dom in constraint.domains.items():
                if col not in pf.columns:
                    continue
                lo, hi = dom if isinstance(dom, tuple) else (None, None)
                mn, mx = pf.column_stats(col)
                if mn is None:
                    continue
                if (hi is not None and mn > hi) or (lo is not None and mx < lo):
                    return False
            return True
        finally:
            pf.close()


# ---------------------------------------------------------------------------
# the page source: the file decode, and the partition keys filled in

class _PartitionKeySource(ConnectorPageSource):
    """The file decode's pages, with a constant block for every requested
    partition-key column."""

    def __init__(self, inner: ConnectorPageSource,
                 layout: List[Tuple[int, Optional[Tuple[Type, Any, Optional[Dictionary]]]]]):
        # layout[i] = (inner index, None) for a data column, and
        # (-1, (type, value, dictionary)) for a partition key
        self._inner = inner
        self._layout = layout

    def __iter__(self) -> Iterator[Page]:
        for page in self._inner:
            cap = page.capacity
            blocks = []
            for idx, const in self._layout:
                if const is None:
                    blocks.append(page.blocks[idx])
                    continue
                t, v, d = const
                nulls = None
                if v is None:
                    data = np.zeros(cap, dtype=t.np_dtype)
                    nulls = torch.ones(cap, dtype=torch.bool)
                elif d is not None:
                    code = d.index().get(v)
                    if code is None:
                        raise RuntimeError(f"partition value {v!r} missing from key "
                                           f"dictionary — stale metadata cache?")
                    data = np.full(cap, code, dtype=t.np_dtype)
                else:
                    data = np.full(cap, v, dtype=t.np_dtype)
                blocks.append(Block(t, torch.from_numpy(data), nulls, d))
            yield Page(tuple(blocks), page.mask)

    def close(self) -> None:
        self._inner.close()


class HivePageSourceProvider(ConnectorPageSourceProvider):
    def __init__(self, metadata: HiveMetadata):
        self._metadata = metadata

    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        name, rel_dir, path, chunk = split.payload
        snap = self._metadata.snapshot(name)
        desc = snap.desc
        pidx = {p: i for i, p in enumerate(desc.partitioned_by)}
        part_values: Dict[str, Any] = {}
        for p in snap.partitions:
            if p.rel_dir == rel_dir:
                part_values = dict(zip(desc.partitioned_by, p.values))
                break
        dmeta = {c.name: c for c in snap.metadata.columns}
        data_cols = [c for c in columns if c.name not in pidx]
        inner_index = {c.name: i for i, c in enumerate(data_cols)}
        layout = [(-1, (dmeta[c.name].type, part_values.get(c.name), dmeta[c.name].dictionary))
                  if c.name in pidx else (inner_index[c.name], None) for c in columns]
        inner = _HiveFileSource(self._metadata, snap, name, path, chunk, data_cols,
                                page_capacity, constraint)
        return _PartitionKeySource(inner, layout)


class _HiveFileSource(ConnectorPageSource):
    """One PCOL file, or one Parquet row group or ORC stripe, decoded into
    pages by the file connector's ``FilePageSource`` over a snapshot shim,
    its varchar codes remapped into the table's unioned dictionaries. It
    offers no split readers: a hive scan decodes serially, as the
    reference's does."""

    def __init__(self, metadata: HiveMetadata, snap: _TableSnapshot, name: SchemaTableName,
                 path: str, chunk: Optional[int], columns: Sequence[ColumnHandle],
                 capacity: int, constraint: Constraint):
        payload = (name, path) if chunk is None else (name, path, chunk)
        self._delegate = FilePageSource(_SnapshotShim(snap),
                                        Split(metadata.connector_id, payload=payload),
                                        list(columns), capacity, constraint)

    def __iter__(self) -> Iterator[Page]:
        return iter(self._delegate)


class _SnapshotShim:
    """Stands in for ``FileMetadata._load`` for one snapshot: the hive
    table's data columns as a file table. The serial decode of
    ``FilePageSource`` reads only the ``metadata`` of what ``_load``
    returns."""

    def __init__(self, snap: _TableSnapshot):
        part = set(snap.desc.partitioned_by)
        cols = tuple(c for c in snap.metadata.columns if c.name not in part)
        self._info = type("Info", (), {})()
        self._info.metadata = TableMetadata(snap.metadata.name, cols)

    def _load(self, name: SchemaTableName):
        return self._info


# ---------------------------------------------------------------------------
# the write path: routing rows to a partition and a bucket

def _key_value(t: Type, d: Optional[Dictionary], v):
    """A partition key's value as the reference's sink keys it: the string
    of a dictionary code (None for an absent code), else a float, bool or
    int by the column's type."""
    if d is not None:
        s = d.lookup(np.asarray([v]))[0]
        return None if s is None else str(s)
    if t.name in ("double", "real"):
        return float(v)
    if t.name == "boolean":
        return bool(v)
    return int(v)


def _distinct(vals: np.ndarray):
    """-> (the first row of each distinct value, each row's distinct
    index): ``np.unique``'s ``return_index`` and ``return_inverse``."""
    _, at, inv = np.unique(vals, return_index=True, return_inverse=True)
    return at, inv.reshape(-1)


def partition_groups(keys) -> Dict[tuple, np.ndarray]:
    """Rows grouped by partition tuple: ``keys`` is one (type, dictionary,
    data, nulls) per partition column over the live rows (``nulls`` None
    when the column has none). -> {key tuple: ascending row positions}, the
    tuples in the order their first row appears, each the key of that first
    row. Each column's distinct values are found in numpy (``_distinct``),
    and only they become Python keys; two rows share a group exactly when their keys
    are equal, so the map is the reference's per-row loop's."""
    def key_of(t, d, data, nulls, r):
        return None if nulls is not None and nulls[r] else _key_value(t, d, data[r])

    n = len(keys[0][2])
    group = np.zeros(n, dtype=np.int64)  # a mixed-radix id over the columns
    for t, d, data, nulls in keys:
        live = np.ones(n, dtype=bool) if nulls is None else ~np.asarray(nulls)
        vals = np.asarray(data)[live]
        at, inv = _distinct(vals)
        by_key: Dict[Any, int] = {None: 0}  # id 0: the NULL key
        code = np.array([by_key.setdefault(_key_value(t, d, vals[i]), len(by_key))
                         for i in at], dtype=np.int64)
        ids = np.zeros(n, dtype=np.int64)
        ids[live] = code[inv]
        group = group * len(by_key) + ids
        if len(keys) > 1:  # dense again, so the next column's radix cannot overflow
            group = _distinct(group)[1]
    order = np.argsort(group, kind="stable")
    ordered = group[order]
    starts = np.flatnonzero(np.r_[True, ordered[1:] != ordered[:-1]])
    rows = np.split(order, starts[1:])
    firsts = order[starts]  # the stable sort puts each group's first row first
    return {tuple(key_of(*k, firsts[g]) for k in keys): rows[g]
            for g in np.argsort(firsts, kind="stable")}


def bucket_ids(blocks: Sequence[Block], sel: np.ndarray, bucket_count: int) -> np.ndarray:
    """The bucket of each row ``sel`` of the host ``blocks`` (the bucket
    columns, in ``bucketed_by`` order): a splitmix64 chain over the int64
    values as uint64, a NULL hashing as the golden-ratio constant. This is
    the on-disk contract of both packages, so it stays numpy (torch has no
    full uint64 arithmetic)."""
    h = np.zeros(len(sel), dtype=np.uint64)
    for b in blocks:
        v = _host(b.data)[sel].astype(np.int64).view(np.uint64)
        if b.nulls is not None:
            v = np.where(_host(b.nulls)[sel], np.uint64(0x9E3779B97F4A7C15), v)
        z = (h ^ v) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = z ^ (z >> np.uint64(31))
    return (h % np.uint64(bucket_count)).astype(np.int64)


class HivePageSink(ConnectorPageSink):
    """Splits incoming pages by partition-key values (and bucket, in a
    bucketed table), buffers them per target, and writes one immutable file
    per (partition, bucket) when it finishes."""

    def __init__(self, metadata: HiveMetadata, table: TableHandle):
        self._metadata = metadata
        self._table = table
        self._snap = snap = metadata.snapshot(table.schema_table)
        self._desc = snap.desc
        self.rows_written = 0
        # host page buffers per (partition directory, bucket), data columns only
        self._buffers: Dict[Tuple[str, Optional[int]], List[Page]] = {}
        self._col_names = [c.name for c in snap.metadata.columns]

    def append_page(self, page: Page) -> None:
        host = host_page(page)  # one device-to-host copy of the blocks and mask
        live = np.flatnonzero(_host(host.mask))
        if len(live) == 0:
            return
        self.rows_written += int(len(live))
        desc = self._desc
        col_of = {n: i for i, n in enumerate(self._col_names)}
        dmeta = {c.name: c for c in self._snap.metadata.columns}
        if desc.partitioned_by:
            keys = []
            for p in desc.partitioned_by:
                b = host.blocks[col_of[p]]
                keys.append((dmeta[p].type, b.dictionary, _host(b.data)[live],
                             None if b.nulls is None else _host(b.nulls)[live]))
            groups = partition_groups(keys)
        else:
            groups = {(): np.arange(len(live))}
        data_cols = [n for n, _ in desc.data_columns]
        bucket_blocks = [host.blocks[col_of[c]] for c in desc.bucketed_by]
        for key, rows in groups.items():
            rel = self._rel_dir_of(key)
            rsel = live[rows]
            if bucket_blocks:
                ids = bucket_ids(bucket_blocks, rsel, desc.bucket_count)
                for bkt in np.unique(ids):
                    self._buffer(rel, int(bkt), host, col_of, data_cols, rsel[ids == bkt])
            else:
                self._buffer(rel, None, host, col_of, data_cols, rsel)

    def _rel_dir_of(self, key: tuple) -> str:
        desc = self._desc
        segs = [f"{p}={_encode_partition_value(desc.type_of(p), v)}"
                for p, v in zip(desc.partitioned_by, key)]
        return os.path.join(*segs) if segs else ""

    def _buffer(self, rel: str, bucket: Optional[int], host: Page, col_of: Dict[str, int],
                data_cols: List[str], sel: np.ndarray) -> None:
        idx = torch.from_numpy(sel)
        blocks = []
        for n in data_cols:
            b = host.blocks[col_of[n]]
            blocks.append(Block(b.type, b.data[idx],
                                None if b.nulls is None else b.nulls[idx], b.dictionary))
        self._buffers.setdefault((rel, bucket), []).append(
            Page(tuple(blocks), torch.ones(len(sel), dtype=torch.bool)))

    def finish(self):
        written = []
        desc = self._desc
        names = [n for n, _ in desc.data_columns]
        types = [t for _, t in desc.data_columns]
        root = self._metadata.store.table_dir(self._table.schema_table)
        for (rel, bucket), pages in self._buffers.items():
            d = os.path.join(root, rel) if rel else root
            os.makedirs(d, exist_ok=True)
            dicts, pages = _materialize_dicts(pages)
            stem = (f"{_BUCKET_PREFIX}{bucket:05d}_" if bucket is not None else "") + \
                uuid.uuid4().hex[:12]
            if desc.format == "parquet":
                from ...formats.parquet_writer import write_parquet
                path = os.path.join(d, stem + ".parquet")
                write_parquet(path, names, types, dicts, pages)
            elif desc.format == "orc":
                from ...formats.orc_writer import write_orc
                path = os.path.join(d, stem + ".orc")
                write_orc(path, names, types, dicts, pages)
            else:
                path = os.path.join(d, stem + ".pcol")
                write_pcol(path, names, types, dicts, pages)
            written.append(path)
        return written

class HivePageSinkProvider(ConnectorPageSinkProvider):
    def __init__(self, metadata: HiveMetadata):
        self._metadata = metadata

    def create_page_sink(self, insert_handle) -> ConnectorPageSink:
        return HivePageSink(self._metadata, insert_handle)


class HiveNodePartitioning(ConnectorNodePartitioningProvider):
    def __init__(self, metadata: HiveMetadata):
        self._metadata = metadata

    def bucket_count(self, table: TableHandle) -> Optional[int]:
        snap = self._metadata.snapshot(table.schema_table)
        if snap is not None and snap.desc.bucket_count > 0:
            return snap.desc.bucket_count
        return None

    def bucket_columns(self, table: TableHandle) -> Optional[Tuple[str, ...]]:
        snap = self._metadata.snapshot(table.schema_table)
        if snap is not None and snap.desc.bucketed_by:
            return tuple(snap.desc.bucketed_by)
        return None


# ---------------------------------------------------------------------------

class HiveConnector(Connector):
    def __init__(self, connector_id: str, base_dir: str):
        os.makedirs(base_dir, exist_ok=True)
        self.store = HiveMetastore(base_dir)
        self._metadata = HiveMetadata(connector_id, self.store)
        self._splits = HiveSplitManager(connector_id, self._metadata)
        self._sources = HivePageSourceProvider(self._metadata)
        self._sinks = HivePageSinkProvider(self._metadata)
        self._partitioning = HiveNodePartitioning(self._metadata)

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources

    def page_sink_provider(self) -> Optional[ConnectorPageSinkProvider]:
        return self._sinks

    def node_partitioning_provider(self) -> ConnectorNodePartitioningProvider:
        return self._partitioning
