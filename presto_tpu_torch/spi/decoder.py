"""Record decoder library of the PyTorch port: raw message bytes -> typed columns.

Counterpart of ``presto_tpu/spi/decoder.py`` (presto-record-decoder's
RowDecoder SPI, used by the kafka-class connector): a table description
names the message format and maps message fields to SQL columns; a decoder
turns a batch of raw messages into per-column numpy arrays and null masks.

Decoders are batch functions (messages in, columns out). A field that does
not decode is NULL, never an error: a poison message must not kill the
query.

Formats:
- ``json``: one JSON object per message; a field's ``mapping`` is a ``/``
  separated path into nested objects.
- ``csv``: delimiter-separated text; ``mapping`` is the 0-based field index.
- ``raw``: the whole message as one varchar value.

The reference coerces message by message. Here each field is coerced a
column at a time (``_column_coercer``) by the reference's ``_coerce``,
with a text date or timestamp parsed once per distinct string, so the
output is the reference's on any input
(``tests/test_torch_record_decoder.py`` holds them equal).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
from decimal import Decimal
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..types import DecimalType, Type, is_string

_EPOCH_DATE = datetime.date(1970, 1, 1)


@dataclasses.dataclass(frozen=True)
class DecoderField:
    """One column of a decoded message."""
    name: str
    type: Type
    mapping: str = ""          # json path | csv index | ignored for raw
    # strptime format of a date/timestamp text field; None = an ISO-8601
    # date ("%Y-%m-%d") or timestamp, or an integer (days / epoch millis)
    date_format: Optional[str] = None


class RowDecoder:
    """decode(messages) -> {field name: (values ndarray, nulls ndarray|None)}.

    String fields give dtype=object arrays of Python str (the connector
    dictionary-encodes them); other fields give the type's numpy dtype."""

    def __init__(self, fields: Sequence[DecoderField]):
        self.fields = list(fields)

    def decode(self, messages: Sequence[bytes]) -> Dict[str, tuple]:
        raise NotImplementedError

    def _columns(self, rows: List[List[object]]) -> Dict[str, tuple]:
        """rows[i][j] = Python value of field j in message i (None = NULL)."""
        n = len(rows)
        return {f.name: _to_typed(f, [r[j] for r in rows], n)
                for j, f in enumerate(self.fields)}

    def _typed_columns(self, cols: List[List[object]], n: int) -> Dict[str, tuple]:
        """cols[j] = the coerced values of field j, one per message."""
        return {f.name: _to_typed(f, vals, n) for f, vals in zip(self.fields, cols)}


def _to_typed(f: DecoderField, vals: List[object], n: int) -> tuple:
    """Coerced values -> (array, nulls or None). A value outside the
    column dtype's range is NULL, as an undecodable field is."""
    if is_string(f.type):
        nulls = np.fromiter((v is None for v in vals), dtype=np.bool_,
                            count=n) if any(v is None for v in vals) else None
        arr = np.array(["" if v is None else str(v) for v in vals], dtype=object)
        return arr, nulls
    arr = np.zeros(n, dtype=f.type.np_dtype)
    null_list = [v is None for v in vals]
    for i, v in enumerate(vals):
        if v is None:
            continue
        try:
            arr[i] = v
        except (OverflowError, ValueError):
            null_list[i] = True
    nulls = np.asarray(null_list, dtype=np.bool_) if any(null_list) else None
    return arr, nulls


def _coerce(f: DecoderField, v) -> object:
    """Python message value -> engine substrate value, None when undecodable
    (the null-on-poison contract)."""
    try:
        if v is None:
            return None
        t = f.type
        if is_string(t):
            return v if isinstance(v, str) else str(v)
        if t.name == "boolean":
            if isinstance(v, str):
                if v.lower() in ("true", "1"):
                    return True
                if v.lower() in ("false", "0"):
                    return False
                return None
            return bool(v)
        if t.name == "date":
            if isinstance(v, str):
                fmt = f.date_format or "%Y-%m-%d"
                d = datetime.datetime.strptime(v.strip(), fmt).date()
                return (d - _EPOCH_DATE).days
            return int(v)
        if t.name == "timestamp":
            if isinstance(v, str):
                if f.date_format:
                    dt = datetime.datetime.strptime(v.strip(), f.date_format)
                else:
                    dt = datetime.datetime.fromisoformat(v.strip())
                # an aware timestamp (RFC 3339 'Z' or an offset) needs an
                # aware epoch, a naive one a naive epoch
                if dt.tzinfo is not None:
                    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
                else:
                    epoch = datetime.datetime(1970, 1, 1)
                return int((dt - epoch).total_seconds() * 1000)
            return int(v)
        if isinstance(t, DecimalType):
            return int(round(Decimal(str(v)).scaleb(t.scale)))
        if t.name in ("double", "real"):
            return float(v)
        return int(v)
    except (ValueError, TypeError, ArithmeticError):
        return None


def _column_coercer(f: DecoderField) -> Callable[[List[object]], List[object]]:
    """-> a function mapping one field's raw values to ``_coerce``'s output,
    value for value; a text date or timestamp is parsed once per distinct
    string."""
    if f.type.name not in ("date", "timestamp"):
        return lambda vals: [_coerce(f, v) for v in vals]

    def memo(vals):
        seen: Dict[str, object] = {}
        out = []
        for v in vals:
            if type(v) is str:
                r = seen.get(v, seen)
                if r is seen:
                    r = seen[v] = _coerce(f, v)
                out.append(r)
            else:
                out.append(_coerce(f, v))
        return out
    return memo


class JsonRowDecoder(RowDecoder):
    """One JSON object per message; ``mapping`` is a /-separated path
    (reference: decoder/json/JsonRowDecoder.java)."""

    def decode(self, messages: Sequence[bytes]) -> Dict[str, tuple]:
        paths = [tuple(p for p in f.mapping.split("/") if p) or (f.name,)
                 for f in self.fields]
        # a message that is not an object (poison, a JSON array or number)
        # yields no field: every path walk of it ends in None
        empty: dict = {}
        objs = []
        for m in messages:
            try:
                o = json.loads(m.decode("utf-8") if isinstance(m, bytes) else m)
            except (ValueError, UnicodeDecodeError):
                o = None
            objs.append(o if type(o) is dict else empty)
        cols = []
        for f, path in zip(self.fields, paths):
            vals = [o.get(path[0]) for o in objs]
            for seg in path[1:]:
                vals = [v.get(seg) if isinstance(v, dict) else None for v in vals]
            cols.append(_column_coercer(f)(vals))
        return self._typed_columns(cols, len(objs))


class CsvRowDecoder(RowDecoder):
    """Delimiter-separated text; ``mapping`` is the 0-based field index
    (reference: decoder/csv/CsvRowDecoder.java)."""

    def __init__(self, fields: Sequence[DecoderField], delimiter: str = ","):
        super().__init__(fields)
        self.delimiter = delimiter
        for f in fields:
            try:
                int(f.mapping)
            except ValueError:
                raise ValueError(
                    f"csv field {f.name!r}: mapping must be a 0-based "
                    f"field index, got {f.mapping!r}")

    def decode(self, messages: Sequence[bytes]) -> Dict[str, tuple]:
        rows: List[Optional[list]] = []
        for m in messages:
            try:
                text = m.decode("utf-8") if isinstance(m, bytes) else m
            except UnicodeDecodeError:
                rows.append(None)
                continue
            rows.append(text.rstrip("\r\n").split(self.delimiter))
        cols = []
        for f in self.fields:
            i = int(f.mapping)
            vals = [None if p is None or not 0 <= i < len(p) else p[i] for p in rows]
            if not is_string(f.type):
                vals = [None if v == "" else v for v in vals]
            cols.append(_column_coercer(f)(vals))
        return self._typed_columns(cols, len(rows))


class RawRowDecoder(RowDecoder):
    """The whole message as one varchar value (reference:
    decoder/raw/RawRowDecoder narrowed to the text case)."""

    def __init__(self, fields: Sequence[DecoderField]):
        super().__init__(fields)
        if len(fields) != 1 or not is_string(fields[0].type):
            raise ValueError("raw decoder takes exactly one varchar field")

    def decode(self, messages: Sequence[bytes]) -> Dict[str, tuple]:
        rows = []
        for m in messages:
            try:
                rows.append([m.decode("utf-8") if isinstance(m, bytes) else str(m)])
            except UnicodeDecodeError:
                rows.append([None])
        return self._columns(rows)


_DECODERS = {"json": JsonRowDecoder, "csv": CsvRowDecoder, "raw": RawRowDecoder}


def create_row_decoder(data_format: str, fields: Sequence[DecoderField],
                       **options) -> RowDecoder:
    """DispatchingRowDecoderFactory analogue."""
    cls = _DECODERS.get(data_format)
    if cls is None:
        raise ValueError(f"unknown message format {data_format!r} "
                         f"(supported: {sorted(_DECODERS)})")
    return cls(fields, **options)


def register_row_decoder(name: str, factory) -> None:
    """Plugin hook for additional formats (the port's own registry)."""
    _DECODERS[name] = factory
