"""The port's record decoders (``presto_tpu_torch/spi/decoder.py``) and kafka
connector (``presto_tpu_torch/connectors/kafka``) against presto_tpu on the CPU.

The same messages, made from a seed with numpy, go through each package's
JSON, CSV and RAW decoders: equal ``(values, nulls)`` per field, with
nested paths, ``dateFormat``, decimals as ints, floats and text, booleans,
timestamps, out-of-range values, poison messages and invalid UTF-8. One
topic directory is read by a kafka catalog of each package: equal decoded
arrays (the internal columns and the dictionaries included) and equal rows
for the cases of ``tests/test_record_decoder.py``; the internal columns
are absent from ``SELECT *`` and still selectable.
"""
import json
import os

import numpy as np
import pytest

from presto_tpu.connectors.kafka import KafkaConnector as RefKafka
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.spi import decoder as ref_dec
from presto_tpu.spi.connector import SchemaTableName as RefName
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.connectors.kafka import KafkaConnector
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi import decoder as dec
from presto_tpu_torch.spi.connector import SchemaTableName
from presto_tpu_torch.types import parse_type
from test_torch_sql import assert_same_rows

SEED = 1517


def assert_same_columns(got: dict, want: dict) -> None:
    """Each field's values (dtype and contents, numbers bit for bit) and
    nulls (None or equal)."""
    assert list(got) == list(want)
    for name in want:
        (gv, gn), (wv, wn) = got[name], want[name]
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        if gv.dtype == object:
            assert gv.tolist() == wv.tolist(), name
        else:  # bit for bit (NaN included)
            assert gv.tobytes() == wv.tobytes(), name
        assert (gn is None) == (wn is None), name
        if wn is not None:
            assert gn.tolist() == wn.tolist(), name


def both_decoders(fmt, fields, **opts):
    """(reference decoder, port decoder) over ``fields`` =
    [(name, type text, mapping, dateFormat)]."""
    ref = ref_dec.create_row_decoder(
        fmt, [ref_dec.DecoderField(n, ref_type(t), m, d) for n, t, m, d in fields], **opts)
    port = dec.create_row_decoder(
        fmt, [dec.DecoderField(n, parse_type(t), m, d) for n, t, m, d in fields], **opts)
    return ref, port


JSON_FIELDS = [("id", "bigint", "id", None), ("qty", "integer", "detail/qty", None),
               ("price", "double", "detail/price", None),
               ("amount", "decimal(12,2)", "amount", None),
               ("day", "date", "detail/day", None),
               ("eu_day", "date", "eu_day", "%d.%m.%Y"),
               ("at", "timestamp", "at", None), ("flag", "boolean", "flag", None),
               ("tag", "varchar", "tag", None), ("deep", "varchar", "a/b/c", None)]


def json_messages(n: int = 600):
    """Seeded messages: most well formed, the rest every kind of odd value."""
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(n):
        day = 8000 + int(rng.integers(0, 3000))
        iso = str(np.datetime64(day, "D"))
        y, m, d = iso.split("-")
        msg = {"id": int(rng.integers(-2**40, 2**40)),
               "detail": {"qty": int(rng.integers(-1000, 1000)),
                          "price": float(rng.normal() * 1e4), "day": iso},
               "amount": [round(float(rng.uniform(-1e5, 1e5)), 2), int(rng.integers(-9999, 9999)),
                          f"{rng.uniform(0, 100):.3f}", float(rng.uniform(0, 1))][i % 4],
               "eu_day": f"{d}.{m}.{y}",
               "at": ["2024-02-29T12:34:56.789", "2024-02-29T12:34:56+02:00",
                      int(rng.integers(0, 2**41)), "2024-13-01"][i % 4],
               "flag": [True, False, "true", "FALSE", "1", "maybe", 0, None][i % 8],
               "tag": ["a", "b", None, 7, 1.5, "é"][i % 6],
               "a": {"b": {"c": f"v{i % 5}"}} if i % 3 else {"b": 3}}
        if i % 17 == 0:
            msg["detail"]["qty"] = 2**40          # out of INTEGER's range: NULL
        if i % 19 == 0:
            msg["detail"]["day"] = "1995-02-30"   # not a date: NULL
        if i % 23 == 0:
            msg["detail"] = [1, 2]                # not an object: every path NULL
        out.append(json.dumps(msg).encode())
    odd = [b"{not json", b"", b"null", b"[1, 2]", b"42", b'{"id": 1} {"id": 2}',
           b' \t{"id": 3, "amount": 1e-05} \r\n', b'{"id": "12", "amount": "9.999"}',
           b'{"id": 1.9, "amount": 1e30}', b'{"id": 99999999999999999999}',
           b'{"id": true, "amount": true}', b'{"tag": "\xff\xfe"}', b'\xef\xbb\xbf{"id": 5}',
           b'{"detail": {"price": "NaN", "qty": "7"}}', b'{"detail": {"price": 3}}']
    return out + odd


def test_json_decoder_equals_reference():
    ref, port = both_decoders("json", JSON_FIELDS)
    msgs = json_messages()
    assert_same_columns(port.decode(msgs), ref.decode(msgs))
    assert_same_columns(port.decode([m.decode("utf-8", "replace") for m in msgs]),
                        ref.decode([m.decode("utf-8", "replace") for m in msgs]))


def test_csv_decoder_equals_reference():
    fields = [("a", "bigint", "0", None), ("b", "varchar", "2", None),
              ("c", "decimal(10,2)", "1", None), ("d", "date", "3", "%Y/%m/%d"),
              ("e", "double", "4", None), ("far", "bigint", "9", None),
              ("neg", "varchar", "-1", None)]
    rng = np.random.default_rng(SEED + 1)
    msgs = [f"{int(rng.integers(-99, 99))}|{rng.uniform(-50, 50):.{int(rng.integers(0, 4))}f}|"
            f"s{i % 4}|199{i % 9}/0{1 + i % 9}/1{i % 10}|{rng.normal():.6f}".encode()
            for i in range(300)]
    msgs += [b"1||", b"||||", b"x|y|z|w|v", b"2|3.5|\xff|1999/01/01|1\r\n", b"",
             b"7|1e3|q|1999/02/29|inf", b" 8 | 2.25 |r"]
    ref, port = both_decoders("csv", fields, delimiter="|")
    assert_same_columns(port.decode(msgs), ref.decode(msgs))
    with pytest.raises(ValueError, match="0-based"):
        dec.CsvRowDecoder([dec.DecoderField("x", parse_type("bigint"), "first")])


def test_raw_decoder_and_registry_equal_reference():
    ref, port = both_decoders("raw", [("line", "varchar", "", None)])
    msgs = [b"hello", b"\xff\xfe", "text", b"", "é".encode()]
    assert_same_columns(port.decode(msgs), ref.decode(msgs))
    assert isinstance(port, dec.RawRowDecoder)
    with pytest.raises(ValueError, match="unknown message format"):
        dec.create_row_decoder("avro", [])
    with pytest.raises(ValueError, match="exactly one varchar"):
        dec.RawRowDecoder([dec.DecoderField("n", parse_type("bigint"))])
    dec.register_row_decoder("upper", lambda fields: _Upper(fields))
    try:
        got = dec.create_row_decoder("upper", [dec.DecoderField("s", parse_type("varchar"))])
        assert got.decode([b"ab", None])["s"][0].tolist() == ["AB", ""]
    finally:
        dec._DECODERS.pop("upper")
    assert "upper" not in ref_dec._DECODERS  # the port keeps a registry of its own


class _Upper(dec.RowDecoder):
    def decode(self, messages):
        return self._columns([[None if m is None else m.decode().upper()] for m in messages])


@pytest.mark.parametrize("scale", [0, 2, 4, 18])
def test_decimal_column_equals_reference(scale):
    """A JSON decimal field at ``scale`` over edge values (beyond the
    Decimal context's 28 digits and int64, -0.0, halves, inf and NaN, text,
    a bool) and seeded floats and ints: equal arrays and nulls."""
    rng = np.random.default_rng(SEED + 3)
    vals = [10**27 + 1, 10**28 - 1, 10**28, -(10**35) - 7, 0, -0.0, 2.675, 1e-05, 1e16, 1e22,
            0.1 + 0.2, float("inf"), float("nan"), 99999999999999.99, 1.005, "x", True, " 12.5 ",
            "1_0.5", "-3.14159", None]
    vals += [float(v) for v in rng.uniform(-1e6, 1e6, 2000)]
    vals += [round(float(v), 2) for v in rng.uniform(-1e6, 1e6, 2000)]
    vals += [int(v) for v in rng.integers(-2**62, 2**62, 500)]
    msgs = [json.dumps({"d": v}).encode() for v in vals]
    ref, port = both_decoders("json", [("d", f"decimal(18,{scale})", "d", None)])
    assert_same_columns(port.decode(msgs), ref.decode(msgs))


# -------------------------------------------------- tests/test_record_decoder.py

def test_reference_decoder_cases_on_the_port():
    """The four decoder cases of ``tests/test_record_decoder.py``, on both."""
    for pkg, ptype in ((ref_dec, ref_type), (dec, parse_type)):
        d = pkg.JsonRowDecoder([pkg.DecoderField("id", ptype("bigint"), "id"),
                                pkg.DecoderField("price", ptype("double"), "detail/price"),
                                pkg.DecoderField("day", ptype("date"), "detail/day"),
                                pkg.DecoderField("tag", ptype("varchar"), "tag")])
        cols = d.decode([b'{"id": 1, "detail": {"price": 2.5, "day": "1970-01-03"}, "tag": "a"}',
                         b'{"id": 2, "detail": {"price": 7}, "tag": null}'])
        assert cols["id"][0].tolist() == [1, 2] and cols["price"][0].tolist() == [2.5, 7.0]
        assert cols["day"][0][0] == 2 and cols["day"][1][1]
        assert cols["tag"][0][0] == "a" and cols["tag"][1][1]
        vals, nulls = pkg.JsonRowDecoder([pkg.DecoderField("id", ptype("bigint"), "id")]).decode(
            [b"{not json", b'{"id": "NaNope"}', b'{"id": 5}'])["id"]
        assert nulls.tolist() == [True, True, False] and vals[2] == 5
        d = pkg.CsvRowDecoder([pkg.DecoderField("a", ptype("bigint"), "0"),
                               pkg.DecoderField("b", ptype("varchar"), "2"),
                               pkg.DecoderField("c", ptype("decimal(10,2)"), "1")], delimiter="|")
        cols = d.decode([b"1|2.50|x", b"2||y", b"3|9.99"])
        assert cols["a"][0].tolist() == [1, 2, 3] and cols["c"][0].tolist() == [250, 0, 999]
        assert cols["c"][1].tolist() == [False, True, False]
        assert list(cols["b"][0][:2]) == ["x", "y"] and cols["b"][1][2]
        vals, nulls = pkg.create_row_decoder(
            "raw", [pkg.DecoderField("line", ptype("varchar"))]).decode([b"hello", b"\xff\xfe"])[
            "line"]
        assert vals[0] == "hello" and nulls.tolist() == [False, True]


def _write_topics(d: str) -> None:
    """The reference test's ``clicks`` topic (two partitions, one poison
    line), and an ``orders`` topic of seeded messages over three partitions
    with invalid UTF-8, poison lines and CSV-free JSON."""
    desc = {"topic": "clicks", "message": {"dataFormat": "json", "fields": [
        {"name": "user_id", "type": "bigint", "mapping": "user"},
        {"name": "amount", "type": "double", "mapping": "amount"},
        {"name": "page", "type": "varchar", "mapping": "meta/page"}]}}
    with open(os.path.join(d, "default.clicks.json"), "w") as f:
        json.dump(desc, f)
    p0 = [{"user": 1, "amount": 1.5, "meta": {"page": "home"}},
          {"user": 2, "amount": 2.0, "meta": {"page": "cart"}}]
    p1 = [{"user": 1, "amount": 4.0, "meta": {"page": "home"}},
          {"user": 3, "amount": 0.5, "meta": {"page": "pay"}}, "BROKEN {"]
    with open(os.path.join(d, "clicks-0.log"), "w") as f:
        f.write("\n".join(json.dumps(x) for x in p0) + "\n")
    with open(os.path.join(d, "clicks-1.log"), "w") as f:
        f.write("\n".join(json.dumps(x) if isinstance(x, dict) else x for x in p1) + "\n")
    fields = [{"name": n, "type": t, "mapping": m} for n, t, m, _f in JSON_FIELDS]
    fields[5]["dateFormat"] = "%d.%m.%Y"
    with open(os.path.join(d, "sales.orders.json"), "w") as f:
        json.dump({"topic": "orders", "message": {"dataFormat": "json", "fields": fields}}, f)
    # no NaN price: the rows' comparison takes DOUBLE to a relative tolerance
    msgs = [m for m in json_messages(300) if m.strip() and b"NaN" not in m]
    msgs[7] = b'{"tag": "caf\xc3'  # a cut multi-byte sequence at a message's end
    for p in range(3):
        with open(os.path.join(d, f"orders-{p}.log"), "wb") as f:
            f.write(b"\n".join(msgs[p::3]) + b"\n\n")
    with open(os.path.join(d, "orders-x.log"), "wb") as f:  # not a partition log
        f.write(b'{"id": 1}\n')


@pytest.fixture(scope="module")
def kafka(tmp_path_factory):
    """(reference runner, port runner, the topics' directory)."""
    d = str(tmp_path_factory.mktemp("kafka"))
    _write_topics(d)
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    ref.catalogs.register("kafka", RefKafka("kafka", d))
    port.catalogs.register("kafka", KafkaConnector("kafka", d))
    return ref, port, d


def test_topic_snapshot_equals_reference(kafka):
    """Decoded fields, internal columns, codes and dictionaries."""
    ref, port, _d = kafka
    for schema, table in (("default", "clicks"), ("sales", "orders")):
        want = ref.metadata.connector("kafka").metadata().topic_data(RefName(schema, table))
        got = port.metadata.connector("kafka").metadata().topic_data(
            SchemaTableName(schema, table))
        assert_same_columns(got.columns, want.columns)
        assert sorted(got.dicts) == sorted(want.dicts)
        for name, d in want.dicts.items():
            assert got.dicts[name].values.tolist() == d.values.tolist(), name
        assert [(p, len(m)) for p, m in got.partitions] == \
            [(p, len(m)) for p, m in want.partitions]
        assert [(c.name, c.type.display_name(), c.hidden) for c in got.metadata.columns] == \
            [(c.name, c.type.display_name(), c.hidden) for c in want.metadata.columns]


def test_topic_decoded_once_per_change_of_its_logs(kafka):
    _ref, port, d = kafka
    meta = port.metadata.connector("kafka").metadata()
    name = SchemaTableName("default", "clicks")
    first = meta.topic_data(name)
    assert meta.topic_data(name) is first
    path = os.path.join(d, "clicks-0.log")
    with open(path, "a") as f:
        f.write(json.dumps({"user": 9, "amount": 1.0, "meta": {"page": "x"}}) + "\n")
    try:
        os.utime(path, (os.path.getatime(path), os.path.getmtime(path) + 5))
        again = meta.topic_data(name)
        assert again is not first and len(again.partitions[0][1]) == 3
    finally:
        with open(path) as f:
            lines = f.read().splitlines()[:-1]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


STREAM_SQL = [
    "select user_id, sum(amount) from kafka.default.clicks where user_id is not null "
    "group by user_id order by user_id",
    "select count(*) from kafka.default.clicks where page = 'home'",
    "select _partition_id, _partition_offset from kafka.default.clicks where user_id = 3",
    "select count(*) from kafka.default.clicks where user_id is null",
    "select _message from kafka.default.clicks where user_id is null",
    "show tables from kafka.default",
    "select * from kafka.default.clicks order by _partition_id, _partition_offset",
    "select id, qty, price, amount, day, eu_day, at, flag, tag, deep from kafka.sales.orders "
    "order by _partition_id, _partition_offset",
    "select _partition_id, count(*), count(id), sum(amount), min(day), max(tag) "
    "from kafka.sales.orders group by _partition_id order by _partition_id",
    "select _message from kafka.sales.orders where id is null order by _message",
    "select c.user_id, n.n_name from kafka.default.clicks c join nation n "
    "on c.user_id = n.n_nationkey order by 1",
]


@pytest.mark.parametrize("sql", STREAM_SQL, ids=range(len(STREAM_SQL)))
def test_stream_queries_equal_reference(kafka, sql):
    """The connector cases of ``tests/test_record_decoder.py`` and more."""
    ref, port, _d = kafka
    want, got = ref.execute(sql), port.execute(sql)
    assert got.column_names == want.column_names
    assert_same_rows(got.rows, want.rows)


def test_internal_columns_hidden_but_selectable(kafka):
    _ref, port, _d = kafka
    assert port.execute("select * from kafka.default.clicks").column_names == \
        ["user_id", "amount", "page"]
    assert port.execute("select _partition_id, _partition_offset from kafka.default.clicks "
                        "where user_id = 3").rows == [[1, 1]]
    assert port.execute("select _message from kafka.default.clicks where user_id is null"
                        ).rows == [["BROKEN {"]]
    assert port.execute("select count(*) from kafka.default.clicks where user_id is null"
                        ).rows == [[1]]
