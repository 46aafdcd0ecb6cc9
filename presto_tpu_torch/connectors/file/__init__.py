"""File connector of the PyTorch port: directory-backed tables in PCOL,
Parquet or ORC, and RCFile for ingest.

Counterpart of ``presto_tpu/connectors/file/__init__.py``. A catalog roots at
a directory; ``<base>/<schema>/<table>/*.pcol`` (or ``*.parquet``, ``*.orc``,
``*.rc``) are the table's files:

- PCOL reads are native-mmap scans with split pruning by the files' header
  statistics and ``libpcol``'s range pre-filters (``_native_prefilter``),
  which compact rows away on the host before the upload. A PCOL split also
  decomposes into row-range split readers (``split_readers``), which the
  staged scan reads in parallel and re-batches.
- Parquet and ORC reads go through ``formats/parquet.py`` and
  ``formats/orc.py``, one split per row group or stripe, pruned by that
  chunk's statistics; RCFile (``formats/rcfile.py``) is read-only.
- Writes (CTAS / INSERT) add one immutable file per writer sink in the
  catalog's write format: PCOL (the default), Parquet or ORC.

Each varchar column of a table has ONE dictionary: the union of its PCOL
files' dictionaries (a file's codes remap into it at scan time, so files
written before the dictionary grew stay valid), or, for external files, one
sorted dictionary of every distinct value, built at load. A virtual
dictionary (a generator's formatted or packed column) is materialized for
the codes written.

The split manager prunes with the headers the metadata load parsed and
cached (the reference parses every file's header again for each scan).
Pages hold CPU tensors built from the decoded numpy arrays
(``torch.from_numpy``); the scan uploads them. The page sink takes written
pages to host RAM with ``host_page``, as the ``memory`` sink does. Two
per-row Python loops of the reference run as numpy here, with the same
output: the virtual dictionary's code remap in ``_materialize_dicts``
(``remap_codes``) and the NULL placeholders of ``_iter_external``
(``external_strings``).
"""
from __future__ import annotations

import itertools
import os
import threading
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...block import Block, Dictionary, Page
from ...formats.parquet import ParquetFile
from ...formats.pcol import PcolFile, _host, write_pcol
from ...spi.connector import (ColumnHandle, ColumnMetadata, Connector, ConnectorMetadata,
                              ConnectorPageSink, ConnectorPageSinkProvider,
                              ConnectorPageSource, ConnectorPageSourceProvider,
                              ConnectorSplitManager, Constraint, SchemaTableName, Split,
                              TableHandle, TableMetadata, TableStatistics)
from ...types import Type, is_string
from ..memory import host_page

# plan-time bound on a varchar column's materialized distinct-value set
# (the PLAIN-encoded parquet fallback decodes whole columns to build it)
MAX_VARCHAR_DICTIONARY = 1 << 21


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``a``, copied when ``a`` is a read-only view (a
    decoded page's ``np.frombuffer``) or not contiguous."""
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return torch.from_numpy(a)


class _ExternalFile:
    """Uniform chunked view over the external formats: parquet files read
    per ROW GROUP, ORC files per STRIPE, RCFile per row group. Each chunk
    becomes one split, pruned by that chunk's column statistics."""

    def __init__(self, path: str):
        self.path = path
        if path.endswith(".rc"):
            from ...formats.rcfile import RcTableFile
            self._f = RcTableFile(path)
            self.n_chunks = self._f.n_chunks
            self.chunk_rows = self._f.chunk_rows
            self.read_chunk = self._f.read_chunk
            self.chunk_stats = self._f.chunk_stats
        elif path.endswith(".orc"):
            from ...formats.orc import OrcFile
            self._f = OrcFile(path)
            self.n_chunks = self._f.n_stripes
            self.chunk_rows = self._f.stripe_rows
            self.read_chunk = self._f.read_stripe
            self.chunk_stats = self._f.stripe_col_stats
        else:
            self._f = ParquetFile(path)
            self.n_chunks = self._f.n_row_groups
            self.chunk_rows = self._f.row_group_rows
            self.read_chunk = self._f.read_row_group
            self.chunk_stats = self._f.row_group_stats
        self.num_rows = self._f.num_rows
        self.schema = self._f.schema

    def column_distinct_strings(self, name: str):
        return self._f.column_distinct_strings(name)

    def close(self):
        self._f.close()


class _TableInfo:
    def __init__(self, metadata: TableMetadata, files: List[str],
                 rows: int, signature, pcol_headers: Optional[Dict] = None):
        self.metadata = metadata
        self.files = files
        self.rows = rows
        self.signature = signature
        # path -> parsed pcol header (the load parsed every header for the
        # schema, rows and dictionary union): split readers reuse these, so
        # setting up a scan opens no file
        self.pcol_headers = pcol_headers or {}
        # (path, column names) -> _LazyRemaps: a file's dictionary remaps,
        # computed by the first scan that reads it and kept while the
        # files' signature holds
        self.remaps: Dict = {}


class FileMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str, base_dir: str,
                 write_format: str = "pcol"):
        if write_format not in ("pcol", "parquet", "orc"):
            raise ValueError(f"unknown file write format {write_format!r}")
        self.connector_id = connector_id
        self.base = base_dir
        self.write_format = write_format
        self._cache: Dict[SchemaTableName, _TableInfo] = {}
        self._lock = threading.Lock()

    # --------------------------------------------------------------- layout

    def _table_dir(self, name: SchemaTableName) -> str:
        return os.path.join(self.base, name.schema, name.table)

    def list_schemas(self) -> List[str]:
        if not os.path.isdir(self.base):
            return []
        return sorted(d for d in os.listdir(self.base)
                      if os.path.isdir(os.path.join(self.base, d)))

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        out = []
        for s in ([schema] if schema else self.list_schemas()):
            sdir = os.path.join(self.base, s)
            if not os.path.isdir(sdir):
                continue
            for t in sorted(os.listdir(sdir)):
                if os.path.isdir(os.path.join(sdir, t)):
                    out.append(SchemaTableName(s, t))
        return out

    def _files_of(self, name: SchemaTableName) -> List[str]:
        d = self._table_dir(name)
        if not os.path.isdir(d):
            return []
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith((".pcol", ".parquet", ".orc", ".rc")))

    def _load(self, name: SchemaTableName) -> Optional[_TableInfo]:
        files = self._files_of(name)
        if not files:
            return None
        sig = tuple((f, os.path.getmtime(f)) for f in files)
        with self._lock:
            cached = self._cache.get(name)
            if cached is not None and cached.signature == sig:
                return cached
        exts = {f.rsplit(".", 1)[-1] for f in files}
        if len(exts) > 1:
            raise RuntimeError(
                f"table {name} mixes {'/'.join(sorted(exts))} files — "
                f"unsupported (write every file through one catalog "
                f"with a consistent file.format)")
        if exts in ({"parquet"}, {"orc"}, {"rc"}):
            return self._load_external(name, files, sig)
        headers = []
        by_path = {}
        rows = 0
        for f in files:
            pf = PcolFile(f)
            try:
                headers.append(pf.header)
                by_path[f] = pf.header
                rows += pf.rows
            finally:
                pf.close()
        # schema from the first file; dictionaries UNION across files so
        # every file's codes can remap into one table-wide dictionary
        from ...formats.pcol import _type_from_tag
        cols = []
        for e in headers[0]["columns"]:
            d = None
            if "dict" in e:
                # the values in first-seen order across the files
                d = Dictionary(list(dict.fromkeys(itertools.chain.from_iterable(
                    next(c for c in h["columns"] if c["name"] == e["name"]).get("dict", [])
                    for h in headers))))
            cols.append(ColumnMetadata(
                e["name"], _type_from_tag(e["type"], e["scale"]),
                dictionary=d))
        info = _TableInfo(TableMetadata(name, tuple(cols)), files, rows, sig,
                          pcol_headers=by_path)
        with self._lock:
            self._cache[name] = info
        return info

    def _load_external(self, name: SchemaTableName, files: List[str],
                       sig) -> _TableInfo:
        """Parquet/ORC/RCFile tables: the schema from the first file.
        Varchar columns get ONE table-wide SORTED Dictionary built at load
        from every file's string values (dictionary-encoded pages and
        streams make this a near-metadata read): plan-time string
        predicates need the complete code space."""
        rows = 0
        schema = None
        string_values: Dict[str, set] = {}
        for f in files:
            pf = _ExternalFile(f)
            try:
                if schema is None:
                    schema = pf.schema
                rows += pf.num_rows
                str_cols = [n for n, t in pf.schema if is_string(t)]
                for n in str_cols:
                    vals_set = string_values.setdefault(n, set())
                    # cheap path: union the files' own dictionary pages/streams
                    distinct = pf.column_distinct_strings(n)
                    if distinct is not None:
                        vals_set.update(distinct)
                        continue
                    # direct-encoded fallback: decode the column once, with a
                    # hard cardinality bound, so an unbounded column fails
                    # with a clear message instead of filling memory at plan
                    # time
                    for gi in range(pf.n_chunks):
                        if pf.chunk_rows(gi) == 0:
                            continue
                        vals, nulls = pf.read_chunk(gi, [n])[n]
                        if nulls is not None:
                            vals = vals[~nulls]
                        vals_set.update(
                            np.unique(vals.astype(str)).tolist())
                        if len(vals_set) > MAX_VARCHAR_DICTIONARY:
                            raise ValueError(
                                f"varchar column {n!r} of {name} exceeds "
                                f"{MAX_VARCHAR_DICTIONARY} distinct "
                                "values; re-encode the files with "
                                "dictionary encoding (or drop the column "
                                "from the table)")
            finally:
                pf.close()
        cols = tuple(
            ColumnMetadata(
                n, t,
                dictionary=Dictionary(sorted(string_values.get(n, ())))
                if is_string(t) else None)
            for n, t in schema)
        info = _TableInfo(TableMetadata(name, cols), files, rows, sig)
        with self._lock:
            self._cache[name] = info
        return info

    # ------------------------------------------------------------------ spi

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        if self._files_of(name):
            return TableHandle(self.connector_id, name)
        return None

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        return self._load(table.schema_table).metadata

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        info = self._load(table.schema_table)
        return TableStatistics(row_count=float(info.rows) if info else 0.0)

    def table_info(self, table: TableHandle) -> _TableInfo:
        return self._load(table.schema_table)

    def table_schema(self, table: TableHandle) -> List[Tuple[str, Type]]:
        """(name, type) per column, from the table's first file: the schema
        a load takes, without parsing every file's header and unioning
        their dictionaries. A writer reads it as it finishes."""
        first = self._files_of(table.schema_table)[0]
        if first.endswith((".parquet", ".orc", ".rc")):
            pf = _ExternalFile(first)
            try:
                return list(pf.schema)
            finally:
                pf.close()
        from ...formats.pcol import _type_from_tag
        pf = PcolFile(first)
        try:
            return [(e["name"], _type_from_tag(e["type"], e["scale"]))
                    for e in pf.header["columns"]]
        finally:
            pf.close()

    # ---------------------------------------------------------------- writes

    def create_table(self, metadata: TableMetadata, properties=None) -> None:
        if properties:
            raise ValueError(
                "file connector tables take no properties (partitioning "
                "lives in the hive connector; format is per-catalog)")
        d = self._table_dir(metadata.name)
        if self._files_of(metadata.name):
            raise ValueError(f"table {metadata.name} already exists")
        os.makedirs(d, exist_ok=True)
        # an empty seed file pins the schema on disk; virtual dictionaries
        # seed empty (data files carry their own materialized dictionaries,
        # unioned at load)
        names = [c.name for c in metadata.columns]
        types = [c.type for c in metadata.columns]
        dicts = [c.dictionary if c.dictionary is None or
                 hasattr(c.dictionary, "values") else Dictionary([])
                 for c in metadata.columns]
        if self.write_format == "parquet":
            from ...formats.parquet_writer import write_parquet
            write_parquet(os.path.join(d, "00000000.parquet"),
                          names, types, dicts, [])
        elif self.write_format == "orc":
            from ...formats.orc_writer import write_orc
            write_orc(os.path.join(d, "00000000.orc"),
                      names, types, dicts, [])
        else:
            write_pcol(os.path.join(d, "00000000.pcol"),
                       names, types, dicts, [])

    def begin_insert(self, table: TableHandle):
        files = self._files_of(table.schema_table)
        if any(f.endswith(".rc") for f in files):
            raise RuntimeError(
                f"table {table.schema_table} is RCFile-backed and "
                f"read-only (RCFile is ingest-only)")
        exts = {os.path.splitext(f)[1].lstrip(".") for f in files}
        if exts and exts != {self.write_format}:
            have = "/".join(sorted(exts))
            raise RuntimeError(
                f"table {table.schema_table} is {have}-backed and this "
                f"catalog writes {self.write_format} — formats cannot mix "
                f"(set file.format={have} in the catalog properties)")
        return table

    def finish_insert(self, handle, fragments) -> None:
        with self._lock:
            self._cache.pop(handle.schema_table, None)

    def drop_table(self, table: TableHandle) -> None:
        d = self._table_dir(table.schema_table)
        for f in self._files_of(table.schema_table):
            os.unlink(f)
            if f.endswith(".rc") and os.path.isfile(f + ".schema"):
                os.unlink(f + ".schema")  # rcfile's sidecar type descriptor
        try:
            os.rmdir(d)
        except OSError:
            pass
        with self._lock:
            self._cache.pop(table.schema_table, None)


def iter_pcol_pages(path: str, names, type_of, table_dicts, capacity: int,
                    prefilter_fn=None):
    """One pcol file -> fixed-capacity masked host pages, remapping per-file
    varchar codes into the TABLE's unioned dictionaries. The file is opened
    once; columns are read once and sliced per page.
    ``prefilter_fn(pf) -> bool mask | None`` runs on the open file and ANDs
    into the row mask (the native libpcol range scan)."""
    pf = PcolFile(path)
    try:
        if pf.rows == 0:
            return
        prefilter = prefilter_fn(pf) if prefilter_fn is not None else None
        cols = {}
        for n in names:
            data, nulls, _d = pf.read_column(n)
            cols[n] = (data, nulls)
        # one remap implementation for the serial and split-parallel paths,
        # so they stay row-identical by construction
        remap = pcol_dict_remaps(pf.columns, names, table_dicts)
        for lo in range(0, pf.rows, capacity):
            hi = min(lo + capacity, pf.rows)
            n_rows = hi - lo
            blocks = []
            for cname in names:
                data, nulls = cols[cname]
                seg = np.array(data[lo:hi])
                if cname in remap:
                    seg = remap[cname][np.clip(seg.astype(np.int32), 0,
                                               len(remap[cname]) - 1)]
                if n_rows < capacity:
                    seg = np.concatenate(
                        [seg, np.zeros(capacity - n_rows, dtype=seg.dtype)])
                nseg = None
                if nulls is not None:
                    nseg = np.zeros(capacity, dtype=bool)
                    nseg[:n_rows] = nulls[lo:hi]
                    nseg = torch.from_numpy(nseg)
                blocks.append(Block(type_of[cname], _tensor(seg), nseg,
                                    table_dicts.get(cname)))
            mask = np.arange(capacity) < n_rows
            if prefilter is not None:
                mask = mask & np.pad(prefilter[lo:hi], (0, capacity - n_rows))
            yield Page(tuple(blocks), torch.from_numpy(mask))
    finally:
        pf.close()


# CAP on rows per parallel pcol range split: binds only when the target
# page is larger (the ranges of one page then give the reader pool several
# work items); smaller targets make each range exactly one page
_RANGE_ROWS = 1 << 20


_INDEX_LOCK = threading.Lock()


def pcol_dict_remaps(columns, names, table_dicts):
    """{column: int32 remap array} for columns whose FILE dictionary differs
    from the TABLE's unioned one. O(dictionary size): computed once per file
    and shared by every range reader of that file. ``columns`` is the
    header's column-entry mapping (``PcolFile.columns`` or the metadata
    cache's parsed header), so no open file is needed. A file value the
    table's dictionary lacks (a file changed in place) raises KeyError."""
    remaps = {}
    for cname in names:
        e = columns.get(cname)
        td = table_dicts.get(cname)
        if e is None or "dict" not in e or td is None or \
                (len(e["dict"]) == len(td) and list(e["dict"]) == list(td.values)):
            continue
        with _INDEX_LOCK:  # built once per table dictionary, not per reader
            pos = td.index()
        remaps[cname] = np.asarray([pos[v] for v in e["dict"]], dtype=np.int32)
    return remaps


def read_pcol_range_chunk(path: str, names, type_of, table_dicts,
                          lo: int, hi: int, prefilter_fn=None, remaps=None,
                          header=None):
    """Decode rows [lo, hi) of one pcol file into a compacted HostChunk, the
    read step of the staged scan. Opens its own mapping, so ranges of one
    file are read concurrently; every returned array is detached from the
    mapping before it closes. ``prefilter_fn(pf, lo, hi) -> bool mask |
    None`` compacts rows that fail it away here, so they are never
    uploaded. ``remaps`` (``pcol_dict_remaps``) carries the file's
    dictionary re-encodings, computed by the caller; None = derive them
    here. ``header`` likewise shares one parsed file header across the
    ranges."""
    from ...ops.scan_pipeline import HostChunk

    pf = PcolFile(path, header=header)
    try:
        if remaps is None:
            remaps = pcol_dict_remaps(pf.columns, names, table_dicts)
        keep = None
        if prefilter_fn is not None:
            pre = prefilter_fn(pf, lo, hi)
            if pre is not None:
                keep = np.flatnonzero(pre)
        cols = []
        nulls = []
        for cname in names:
            data, nl, _d = pf.read_column_range(cname, lo, hi)
            seg = np.asarray(data)
            rm = remaps.get(cname)
            if rm is not None:
                seg = rm[np.clip(seg.astype(np.int32), 0, len(rm) - 1)]
                if keep is not None:
                    seg = seg[keep]
            elif keep is not None:
                seg = seg[keep]
            else:
                seg = np.array(seg)  # copy off the mapping
            cols.append(np.ascontiguousarray(seg))
            if nl is None:
                nulls.append(None)
            else:  # read_column_range already copied the mask off the map
                nulls.append(nl[keep] if keep is not None else nl)
        rows = int(len(keep)) if keep is not None else hi - lo
        return HostChunk.build(cols, nulls, [type_of[c] for c in names],
                               [table_dicts.get(c) for c in names], rows)
    finally:
        pf.close()


class _LazyRemaps:
    """Once-per-file dictionary remaps, computed by the first range reader
    that runs (on the scan pipeline's pool) instead of serially when the
    pipeline is set up."""

    def __init__(self, columns, names, table_dicts):
        self._columns = columns
        self._names = names
        self._table_dicts = table_dicts
        self._lock = threading.Lock()
        self._val = None
        self._done = False

    def get(self):
        with self._lock:
            if not self._done:
                self._val = pcol_dict_remaps(self._columns, self._names, self._table_dicts)
                self._done = True
            return self._val


class FileSplitManager(ConnectorSplitManager):
    """One split per PCOL file, pruned by the header's min/max against the
    pushed-down constraint; one per row group or stripe of an external
    file, pruned by its statistics."""

    def __init__(self, connector_id: str, metadata: FileMetadata):
        self.connector_id = connector_id
        self._metadata = metadata

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        info = self._metadata.table_info(table)
        if info.files and info.files[0].endswith((".parquet", ".orc", ".rc")):
            return self._external_splits(table, info, constraint)
        splits = []
        for b, f in enumerate(info.files):
            # the metadata load parsed every header under the files' current
            # signature: the row count and statistics come from it, and
            # pruning opens no file
            header = info.pcol_headers[f]
            keep = header["rows"] > 0
            if keep and constraint.domains:
                columns = {e["name"]: e for e in header["columns"]}
                for col, dom in constraint.domains.items():
                    if col not in columns:
                        continue
                    lo, hi = dom if isinstance(dom, tuple) else (None, None)
                    mn, mx = columns[col].get("min"), columns[col].get("max")
                    if mn is None:
                        continue
                    if (hi is not None and mn > hi) or \
                            (lo is not None and mx < lo):
                        keep = False
                        break
            if keep:
                splits.append(Split(self.connector_id,
                                    payload=(table.schema_table, f), bucket=b))
        return splits  # [] = every file pruned: the scan yields no pages

    def _external_splits(self, table: TableHandle, info: _TableInfo,
                         constraint: Constraint) -> List[Split]:
        """One split per row group (parquet) / stripe (ORC), pruned by that
        chunk's min/max statistics."""
        splits = []
        b = 0
        for f in info.files:
            pf = _ExternalFile(f)
            try:
                for g in range(pf.n_chunks):
                    keep = pf.chunk_rows(g) > 0
                    if keep and constraint.domains:
                        for col, dom in constraint.domains.items():
                            lo, hi = dom if isinstance(dom, tuple) else (None, None)
                            stats = pf.chunk_stats(g, col)
                            if stats is None or stats[0] is None or \
                                    isinstance(stats[0], str):
                                continue
                            mn, mx = stats
                            if (hi is not None and mn > hi) or \
                                    (lo is not None and mx < lo):
                                keep = False
                                break
                    if keep:
                        splits.append(Split(self.connector_id,
                                            payload=(table.schema_table, f, g),
                                            bucket=b))
                    b += 1
            finally:
                pf.close()
        return splits


def external_strings(vals) -> np.ndarray:
    """An external chunk's string column as a ``str`` array with None as
    "" (the placeholder under a null flag); the reference builds the same
    with a Python list per row."""
    strs = np.array(vals, dtype=object)
    if strs.size:
        strs[strs == None] = ""  # noqa: E711 - elementwise test for None
    return strs.astype(str)


class FilePageSource(ConnectorPageSource):
    def __init__(self, metadata: FileMetadata, split: Split,
                 columns: Sequence[ColumnHandle], page_capacity: int,
                 constraint: Constraint):
        self._metadata = metadata
        self.split = split
        self.columns = list(columns)
        self.capacity = page_capacity
        self.constraint = constraint

    def __iter__(self) -> Iterator[Page]:
        if len(self.split.payload) == 3:
            yield from self._iter_external()
            return
        name, path = self.split.payload
        info = self._metadata._load(name)
        table_dicts = {c.name: c.dictionary for c in info.metadata.columns}
        names = [c.name for c in self.columns]
        type_of = {c.name: info.metadata.column(c.name).type for c in self.columns}
        yield from iter_pcol_pages(path, names, type_of, table_dicts,
                                   self.capacity, self._native_prefilter)

    def split_readers(self, target_rows: int):
        """Row-range split readers (the scan pipeline's SPI): a pcol split
        decomposes into independently readable row ranges, read by the
        shared reader pool. External formats decode whole chunks and stay
        on the serial path (None), and so does a pcol split when libpcol
        does not load (the numpy reader reads the whole file per open)."""
        if len(self.split.payload) != 2:
            return None
        from ...native import native_available

        if not native_available():
            return None
        name, path = self.split.payload
        info = self._metadata._load(name)
        table_dicts = {c.name: c.dictionary for c in info.metadata.columns}
        names = [c.name for c in self.columns]
        type_of = {c.name: info.metadata.column(c.name).type for c in self.columns}
        # LAZY per-file setup: the metadata load parsed (and cached) the
        # header, so setting up the readers opens NO file; the dictionary
        # remaps are computed by the first range reader that runs
        header = info.pcol_headers.get(path)
        if header is None:  # stale cache entry (file swapped in place)
            pf = PcolFile(path)
            header = pf.header
            pf.close()
        rows = header["rows"]
        columns = {e["name"]: e for e in header["columns"]}
        lazy = info.remaps.setdefault((path, tuple(names)),
                                      _LazyRemaps(columns, names, table_dicts))
        from ...formats.pcol import row_ranges
        step = max(1, min(int(target_rows), _RANGE_ROWS))

        def reader(lo: int, hi: int):
            def read():
                yield read_pcol_range_chunk(path, names, type_of, table_dicts, lo, hi,
                                            self._native_prefilter, lazy.get(), header)
            return read

        return [reader(lo, hi) for lo, hi in row_ranges(rows, step)]

    def _iter_external(self) -> Iterator[Page]:
        name, path, group = self.split.payload
        info = self._metadata._load(name)
        table_dicts = {c.name: c.dictionary for c in info.metadata.columns}
        types = {c.name: c.type for c in info.metadata.columns}
        names = [c.name for c in self.columns]
        pf = _ExternalFile(path)
        try:
            data = pf.read_chunk(group, names)
        finally:
            pf.close()
        n = pf.chunk_rows(group)
        from ...utils.batching import clamp_capacity
        cap = clamp_capacity(n, self.capacity)
        cols = {}
        for cname in names:
            vals, nulls = data[cname]
            d = table_dicts.get(cname)
            if d is not None:
                # re-encode into the table dictionary built at load; Python
                # work is per DISTINCT value, not per row. Null slots carry a
                # placeholder under their null flag.
                uniq, inv = np.unique(external_strings(vals), return_inverse=True)
                index = d.index()
                umap = np.empty(len(uniq), dtype=np.int32)
                for ui, u in enumerate(uniq):
                    code = index.get(u)
                    if code is None:
                        if nulls is not None and u == "":
                            # null placeholder under the null flag; -1 is the
                            # dictionary's absent sentinel (lookup -> None)
                            code = -1
                        else:
                            raise RuntimeError(
                                f"{path}: value {u!r} missing from the "
                                f"table dictionary of {cname} — stale "
                                f"metadata cache? (file changed in place)")
                    umap[ui] = code
                vals = umap[inv.reshape(-1)]
            cols[cname] = (vals, nulls)
        for lo in range(0, max(n, 1), cap):
            hi = min(lo + cap, n)
            n_rows = hi - lo
            blocks = []
            for cname in names:
                vals, nulls = cols[cname]
                tt = types[cname]
                seg = np.asarray(vals[lo:hi]).astype(tt.np_dtype, copy=False)
                if n_rows < cap:
                    seg = np.concatenate([seg, np.zeros(cap - n_rows, dtype=seg.dtype)])
                nseg = None
                if nulls is not None:
                    nseg = np.zeros(cap, dtype=bool)
                    nseg[:n_rows] = nulls[lo:hi]
                    nseg = torch.from_numpy(nseg)
                blocks.append(Block(tt, _tensor(seg), nseg, table_dicts.get(cname)))
            yield Page(tuple(blocks), torch.arange(cap) < n_rows)
            if n == 0:
                break

    def _native_prefilter(self, pf: PcolFile, row_lo: int = 0,
                          row_hi: Optional[int] = None) -> Optional[np.ndarray]:
        """AND together the pushed-down ranges through libpcol's range
        filters, so rows that fail them never reach the device. ``row_lo``/
        ``row_hi`` restrict the scan to one row range, so split readers
        touch only their own slice of the mapping."""
        if not self.constraint.domains:
            return None
        try:
            from ...native import libpcol
            lib = libpcol()
        except Exception:  # noqa: BLE001 - no toolchain: the engine filter alone
            return None
        row_hi = pf.rows if row_hi is None else row_hi
        n = row_hi - row_lo
        mask: Optional[np.ndarray] = None
        for col, dom in self.constraint.domains.items():
            if col not in pf.columns:
                continue
            lo, hi = dom if isinstance(dom, tuple) else (None, None)
            if lo is None and hi is None:
                continue
            data, nulls, _ = pf.read_column_range(col, row_lo, row_hi)
            if data.dtype == np.int64:
                fn = lib.pcol_filter_range_i64
            elif data.dtype == np.int32:
                fn = lib.pcol_filter_range_i32
            else:
                continue
            if mask is None:
                mask = np.ones(n, dtype=np.uint8)
            c = np.ascontiguousarray(data)
            fn(c.ctypes.data, len(c),
               np.iinfo(np.int64).min if lo is None else int(lo),
               np.iinfo(np.int64).max if hi is None else int(hi),
               mask.ctypes.data)
        return mask.astype(bool) if mask is not None else None


class FilePageSourceProvider(ConnectorPageSourceProvider):
    def __init__(self, metadata: FileMetadata):
        self._metadata = metadata

    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        return FilePageSource(self._metadata, split, columns, page_capacity, constraint)


class FilePageSink(ConnectorPageSink):
    """Buffers written pages in host RAM; ``finish`` writes ONE immutable
    file in the catalog's write format and returns its path."""

    def __init__(self, metadata: FileMetadata, table: TableHandle):
        self._metadata = metadata
        self._table = table
        self._pages: List[Page] = []
        self.rows_written = 0

    def append_page(self, page: Page) -> None:
        host = host_page(page)
        self._pages.append(host)
        self.rows_written += int(host.mask.sum())

    def finish(self):
        if not self._pages:
            return []
        names, types = zip(*self._metadata.table_schema(self._table))
        names, types = list(names), list(types)
        dicts, pages = _materialize_dicts(self._pages)
        d = self._metadata._table_dir(self._table.schema_table)
        if self._metadata.write_format == "parquet":
            from ...formats.parquet_writer import write_parquet
            path = os.path.join(d, f"{uuid.uuid4().hex[:12]}.parquet")
            write_parquet(path, names, types, dicts, pages)
        elif self._metadata.write_format == "orc":
            from ...formats.orc_writer import write_orc
            path = os.path.join(d, f"{uuid.uuid4().hex[:12]}.orc")
            write_orc(path, names, types, dicts, pages)
        else:
            path = os.path.join(d, f"{uuid.uuid4().hex[:12]}.pcol")
            write_pcol(path, names, types, dicts, pages)
        return [path]

    def abort(self) -> None:
        self._pages = []


def remap_codes(uniq: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """int32 position of each code in the sorted ``uniq``, 0 where the code
    is absent: the reference's ``code_map.get(code, 0)``, per row in
    Python, as one ``np.searchsorted``."""
    if len(uniq) == 0:
        return np.zeros(len(codes), dtype=np.int32)
    pos = np.minimum(np.searchsorted(uniq, codes), len(uniq) - 1)
    return np.where(uniq[pos] == codes, pos, 0).astype(np.int32)


def _materialize_dicts(pages):
    """-> (per-column dictionaries, pages) ready to persist. Blocks carry
    their own dictionaries; virtual ones (formatted/packed) cannot persist,
    so the codes actually written decode to strings and re-encode through a
    real Dictionary."""
    ncols = len(pages[0].blocks)
    out_dicts: List[Optional[Dictionary]] = []
    out_pages = list(pages)
    for ci in range(ncols):
        d = pages[0].blocks[ci].dictionary
        if d is None or hasattr(d, "values"):
            out_dicts.append(d)
            continue
        codes = np.concatenate(
            [_host(p.blocks[ci].data)[_host(p.mask)] for p in pages]).astype(np.int64)
        uniq = np.unique(codes)
        strings = d.lookup(uniq)
        new_d = Dictionary([str(s) for s in strings])
        new_pages = []
        for p in out_pages:
            b = p.blocks[ci]
            mapped = remap_codes(uniq, _host(b.data).astype(np.int64))
            blocks = list(p.blocks)
            blocks[ci] = Block(b.type, torch.from_numpy(mapped), b.nulls, new_d)
            new_pages.append(Page(tuple(blocks), p.mask))
        out_pages = new_pages
        out_dicts.append(new_d)
    return out_dicts, out_pages


class FilePageSinkProvider(ConnectorPageSinkProvider):
    def __init__(self, metadata: FileMetadata):
        self._metadata = metadata

    def create_page_sink(self, insert_handle) -> ConnectorPageSink:
        return FilePageSink(self._metadata, insert_handle)


class FileConnector(Connector):
    def __init__(self, connector_id: str, base_dir: str,
                 write_format: str = "pcol"):
        os.makedirs(base_dir, exist_ok=True)
        self._metadata = FileMetadata(connector_id, base_dir, write_format)
        self._splits = FileSplitManager(connector_id, self._metadata)
        self._sources = FilePageSourceProvider(self._metadata)
        self._sinks = FilePageSinkProvider(self._metadata)

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources

    def page_sink_provider(self) -> Optional[ConnectorPageSinkProvider]:
        return self._sinks
