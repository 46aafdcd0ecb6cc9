"""Kafka-class streaming connector of the PyTorch port: decoded message logs as tables.

Counterpart of ``presto_tpu/connectors/kafka/__init__.py`` (presto-kafka's
KafkaConnector, KafkaMetadata, KafkaSplitManager and record set, with the
``etc/kafka/*.json`` table descriptions), on the port's record decoders
(``spi/decoder.py``). The transport is a directory of append-only
partition logs instead of a broker; the table contract is presto-kafka's:
JSON table descriptions map message fields to typed columns, one split per
topic partition, per-message internal columns, null-on-poison decoding.

Layout of ``log_dir``:
- ``<topic>-<partition>.log``: the newline-delimited messages of a
  partition;
- ``<schema>.<table>.json``: a table description::

    {"topic": "orders",
     "message": {"dataFormat": "json" | "csv" | "raw",
                 ["delimiter": ","],
                 "fields": [{"name": "id", "type": "bigint",
                             "mapping": "payload/id",
                             ["dateFormat": "%Y-%m-%d"]}, ...]}}

Internal columns (hidden from ``SELECT *``, still selectable):
``_partition_id`` bigint, ``_partition_offset`` bigint (the message's
index in its partition), ``_message`` varchar (the raw text).

A topic is decoded once per change of its description or logs (the
signature of their mtimes and sizes) and kept decoded; its string columns
are dictionary-encoded once for the whole topic.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...block import Block, Dictionary, Page
from ...spi.connector import (ColumnHandle, ColumnMetadata, Connector, ConnectorMetadata,
                              ConnectorPageSource, ConnectorPageSourceProvider,
                              ConnectorSplitManager, Constraint, SchemaTableName, Split,
                              TableHandle, TableMetadata, TableStatistics)
from ...spi.decoder import DecoderField, RowDecoder, create_row_decoder
from ...types import BIGINT, VARCHAR, is_string, parse_type
from ...utils.batching import clamp_capacity

INTERNAL_COLUMNS = ("_partition_id", "_partition_offset", "_message")


class TopicDescription:
    def __init__(self, name: SchemaTableName, topic: str,
                 decoder: RowDecoder, fields: List[DecoderField]):
        self.name = name
        self.topic = topic
        self.decoder = decoder
        self.fields = fields

    @staticmethod
    def load(path: str, name: SchemaTableName) -> "TopicDescription":
        """``name`` is resolved by the caller (``KafkaMetadata._descriptions``
        owns the file name -> schema.table rule)."""
        with open(path) as f:
            doc = json.load(f)
        msg = doc.get("message", {})
        fields = [DecoderField(e["name"].lower(), parse_type(e["type"]),
                               str(e.get("mapping", "")), e.get("dateFormat"))
                  for e in msg.get("fields", [])]
        if not fields:
            raise ValueError(f"{path}: table description has no fields")
        opts = {}
        if msg.get("dataFormat") == "csv" and "delimiter" in msg:
            opts["delimiter"] = msg["delimiter"]
        decoder = create_row_decoder(msg.get("dataFormat", "json"), fields, **opts)
        return TopicDescription(name, doc.get("topic", name.table), decoder, fields)


class _TopicData:
    """A decoded snapshot of one topic's logs with its description and table
    metadata, cached together under the description's and logs' signature,
    so a query parses the description and lists the directory once, not per
    split."""

    def __init__(self, signature, desc: TopicDescription,
                 partitions: List[Tuple[int, List[bytes]]],
                 columns: Dict[str, tuple], dicts: Dict[str, Dictionary],
                 metadata: TableMetadata):
        self.signature = signature
        self.desc = desc
        self.partitions = partitions      # [(partition id, raw messages)]
        self.columns = columns            # name -> (values, nulls) over ALL rows
        self.dicts = dicts                # varchar name -> Dictionary
        self.metadata = metadata


class KafkaMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str, log_dir: str, default_schema: str = "default"):
        self.connector_id = connector_id
        self.log_dir = log_dir
        self.default_schema = default_schema
        self._lock = threading.Lock()
        self._data: Dict[SchemaTableName, _TopicData] = {}

    # ------------------------------------------------------------ catalog

    def _descriptions(self) -> Dict[SchemaTableName, str]:
        out = {}
        if not os.path.isdir(self.log_dir):
            return out
        for f in sorted(os.listdir(self.log_dir)):
            if f.endswith(".json"):
                base = f[: -len(".json")]
                if "." in base:
                    schema, table = base.split(".", 1)
                else:
                    schema, table = self.default_schema, base
                out[SchemaTableName(schema, table)] = os.path.join(self.log_dir, f)
        return out

    def list_schemas(self) -> List[str]:
        return sorted({n.schema for n in self._descriptions()})

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        return [n for n in self._descriptions() if schema is None or n.schema == schema]

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        if name in self._descriptions():
            return TableHandle(self.connector_id, name)
        return None

    # -------------------------------------------------------------- decode

    def _log_files(self, topic: str) -> List[Tuple[int, str]]:
        out = []
        prefix = topic + "-"
        if os.path.isdir(self.log_dir):
            for f in sorted(os.listdir(self.log_dir)):
                if f.startswith(prefix) and f.endswith(".log"):
                    try:
                        part = int(f[len(prefix):-len(".log")])
                    except ValueError:
                        continue
                    out.append((part, os.path.join(self.log_dir, f)))
        return out

    def topic_data(self, name: SchemaTableName) -> _TopicData:
        desc_path = self._descriptions()[name]
        desc = TopicDescription.load(desc_path, name)
        files = self._log_files(desc.topic)
        sig = (os.path.getmtime(desc_path),) + tuple(
            (p, f, os.path.getmtime(f), os.path.getsize(f)) for p, f in files)
        with self._lock:
            cached = self._data.get(name)
            if cached is not None and cached.signature == sig:
                return cached
        partitions = []
        for part, path in files:
            with open(path, "rb") as fh:
                msgs = [ln for ln in fh.read().split(b"\n") if ln]
            partitions.append((part, msgs))
        all_msgs = [m for _, msgs in partitions for m in msgs]
        columns = desc.decoder.decode(all_msgs)
        # the internal columns
        sizes = [len(msgs) for _, msgs in partitions]
        columns["_partition_id"] = (
            np.repeat(np.asarray([p for p, _ in partitions], dtype=np.int64), sizes), None)
        columns["_partition_offset"] = (
            np.concatenate([np.arange(k, dtype=np.int64) for k in sizes])
            if partitions else np.zeros(0, dtype=np.int64), None)
        columns["_message"] = (
            np.array([m.decode("utf-8", "replace") for m in all_msgs], dtype=object), None)
        # string columns are dictionary-encoded once for the whole topic
        dicts: Dict[str, Dictionary] = {}
        for f in list(desc.fields) + [DecoderField("_message", VARCHAR)]:
            if not is_string(f.type):
                continue
            vals, nulls = columns[f.name]
            live = vals if nulls is None else vals[~nulls]
            d = Dictionary(sorted({str(v) for v in live}))
            index = d.index()
            columns[f.name] = (np.fromiter((index.get(str(v), 0) for v in vals),
                                           dtype=np.int32, count=len(vals)), nulls)
            dicts[f.name] = d
        cols = [ColumnMetadata(f.name, f.type, dictionary=dicts.get(f.name))
                for f in desc.fields]
        cols.append(ColumnMetadata("_partition_id", BIGINT, hidden=True))
        cols.append(ColumnMetadata("_partition_offset", BIGINT, hidden=True))
        cols.append(ColumnMetadata("_message", VARCHAR, hidden=True,
                                   dictionary=dicts.get("_message")))
        data = _TopicData(sig, desc, partitions, columns, dicts,
                          TableMetadata(name, tuple(cols)))
        with self._lock:
            self._data[name] = data
        return data

    # ----------------------------------------------------------------- spi

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        return self.topic_data(table.schema_table).metadata

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        data = self.topic_data(table.schema_table)
        return TableStatistics(row_count=float(sum(len(m) for _, m in data.partitions)))


class KafkaSplitManager(ConnectorSplitManager):
    """One split per non-empty topic partition."""

    def __init__(self, connector_id: str, metadata: KafkaMetadata):
        self.connector_id = connector_id
        self._metadata = metadata

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        data = self._metadata.topic_data(table.schema_table)
        return [Split(self.connector_id, payload=(table.schema_table, part))
                for part, msgs in data.partitions if msgs]


class KafkaPageSource(ConnectorPageSource):
    """One partition's rows of the decoded snapshot, in pages of
    ``clamp_capacity(partition rows, capacity)``."""

    def __init__(self, metadata: KafkaMetadata, split: Split,
                 columns: Sequence[ColumnHandle], capacity: int):
        self._metadata = metadata
        self.split = split
        self.columns = list(columns)
        self.capacity = capacity

    def __iter__(self) -> Iterator[Page]:
        name, part = self.split.payload
        data = self._metadata.topic_data(name)  # the signature-cached snapshot
        meta = data.metadata
        # this partition's row range in the topic-wide arrays
        lo = n = 0
        for p, msgs in data.partitions:
            if p == part:
                n = len(msgs)
                break
            lo += len(msgs)
        cap = clamp_capacity(n, self.capacity)
        for start in range(0, n, cap):
            stop = min(start + cap, n)
            rows = stop - start
            blocks = []
            for c in self.columns:
                vals, nulls = data.columns[c.name]
                cm = meta.column(c.name)
                seg = np.zeros(cap, dtype=cm.type.np_dtype)
                seg[:rows] = vals[lo + start:lo + stop]
                nseg = None
                if nulls is not None:
                    nseg = np.zeros(cap, dtype=bool)
                    nseg[:rows] = nulls[lo + start:lo + stop]
                    nseg = torch.from_numpy(nseg)
                blocks.append(Block(cm.type, torch.from_numpy(seg), nseg, cm.dictionary))
            yield Page(tuple(blocks), torch.arange(cap) < rows)


class KafkaPageSourceProvider(ConnectorPageSourceProvider):
    def __init__(self, metadata: KafkaMetadata):
        self._metadata = metadata

    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        return KafkaPageSource(self._metadata, split, columns, page_capacity)


class KafkaConnector(Connector):
    def __init__(self, connector_id: str, log_dir: str, default_schema: str = "default"):
        self._metadata = KafkaMetadata(connector_id, log_dir, default_schema)
        self._splits = KafkaSplitManager(connector_id, self._metadata)
        self._sources = KafkaPageSourceProvider(self._metadata)

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources
