"""Frozen copy of the port's TPC-H generator, for the benchmark's reference.

Copied from ``presto_tpu_torch/connectors/tpch/generator.py`` and kept
here unchanged in its arithmetic, so that a later change to the program's
generator cannot move the yardstick: every column value is a pure function
of (table, column, row index) through a splitmix64-style hash. The port's
``Dictionary`` and SQL types are replaced by the small classes below, which
are all the reference needs (values, codes and the decoded strings); the
reference imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Dictionary:
    """Code -> string over a fixed list of values."""

    def __init__(self, values: Sequence[str]):
        self.values = np.asarray(values, dtype=object)
        self._index = {v: i for i, v in enumerate(self.values)}

    def __len__(self):
        return len(self.values)

    def code_of(self, value: str) -> int:
        return self._index.get(value, -1)

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        return self.values[np.asarray(codes, dtype=np.int64)]


# column type names (the generator's columns carry one each)
BIGINT, DATE, INTEGER, VARCHAR, WIDE_VARCHAR, Type = (
    "bigint", "date", "integer", "varchar", "varchar", str)
DEC = "decimal(12,2)"

# ---------------------------------------------------------------------------
# hashing primitives (vectorized splitmix64)
# ---------------------------------------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _stream(table_id: int, col_id: int, idx: np.ndarray) -> np.ndarray:
    """Deterministic uint64 stream for rows `idx` of column (table_id, col_id)."""
    seed = np.uint64((table_id << 32) ^ (col_id << 16) ^ 0x5DEECE66D)
    with np.errstate(over="ignore"):
        return _mix(np.asarray(idx, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15) + seed)


def _uniform(table_id: int, col_id: int, idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Uniform integers in [lo, hi] inclusive."""
    h = _stream(table_id, col_id, idx)
    span = np.uint64(hi - lo + 1)
    return (h % span).astype(np.int64) + lo


# ---------------------------------------------------------------------------
# vocabularies (TPC-H spec 4.2.2.13 lists)
# ---------------------------------------------------------------------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey)
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
COLORS = ("almond antique aquamarine azure beige bisque black blanched blue blush brown "
          "burlywood burnished chartreuse chiffon chocolate coral cornflower cornsilk cream "
          "cyan dark deep dim dodger drab firebrick floral forest frosted gainsboro ghost "
          "goldenrod green grey honeydew hot indian ivory khaki lace lavender lawn lemon "
          "light lime linen magenta maroon medium metallic midnight mint misty moccasin "
          "navajo navy olive orange orchid pale papaya peach peru pink plum powder puff "
          "purple red rose rosy royal saddle salmon sandy seashell sienna sky slate smoke "
          "snow spring steel tan thistle tomato turquoise violet wheat white yellow").split()
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_TYPES = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
CONTAINERS = [f"{a} {b}" for a in CONT_S1 for b in CONT_S2]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIP_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
NOISE_WORDS = ("the of and a in to is was he for it with as his on be at by had not are "
               "but from or have an they which one you were all her she there would their "
               "we him been has when who will no more if out so up said what its about "
               "than into them can only other time new some could these two may first then "
               "do any like my now over such our man me even most made after also "
               # the spec's query-predicate phrases (Q13 '%special%requests%',
               # Q16 '%Customer%Complaints%') so those LIKEs select real subsets
               "special requests Customer Complaints").split()

# date window: days since epoch for 1992-01-01 .. 1998-12-31
MIN_DATE = 8035   # 1992-01-01
MAX_ORDER_DATE = 10440  # 1998-08-02 (so receiptdate <= 1998-12-31)
CURRENT_DATE = 9298  # 1995-06-17, spec's ':3' anchor for Q1-style predicates


# ---------------------------------------------------------------------------
# virtual dictionaries
# ---------------------------------------------------------------------------

class FormattedDictionary(Dictionary):
    """code -> format(code); nothing materialized. For Customer#%09d-style columns.

    `substr_rules` maps (start, length) -> (output Dictionary, code transform fn):
    a synthesized-prefix rule declaring that substring(col, start, length) equals
    output_dict.lookup(transform(codes)) — e.g. the phone country code. This is how
    substr over a virtual column lowers to pure device arithmetic instead of a
    string scan (Q22's substring(c_phone, 1, 2))."""

    def __init__(self, fmt: Callable[[np.ndarray], np.ndarray], size_hint: int = 0,
                 substr_rules: Optional[dict] = None, monotonic: bool = False):
        # deliberately skip super().__init__: no values array
        self.fmt = fmt
        self.size_hint = size_hint
        self._index = None
        self.substr_rules = substr_rules or {}
        # monotonic: code order == lexicographic order of the formatted strings
        # (zero-padded fixed-width formats); lets ORDER BY sort by raw codes
        self.monotonic = monotonic

    def __len__(self):
        return self.size_hint

    def index(self):
        raise NotImplementedError("formatted dictionary has no reverse index")

    def code_of(self, value: str) -> int:
        return -1

    def codes_where(self, predicate):
        raise NotImplementedError("predicates on formatted columns not supported")

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        return self.fmt(np.asarray(codes, dtype=np.int64))

    def __repr__(self):
        return f"FormattedDictionary(~{self.size_hint})"


class PackedWordsDictionary(Dictionary):
    """Fixed-count word combination packed into the code integer, 7 bits per word.

    Used for p_name (5 words of 92 colors) and comment-like columns. Supports
    `contains_word(word) -> per-field code predicate` so LIKE '%green%' lowers to a
    vectorized device comparison over packed fields instead of a string scan — the
    TPU answer to the reference's regex-over-slices LIKE
    (presto-main/.../type/LikeFunctions.java).
    """

    BITS = 7

    def __init__(self, words: Sequence[str], n_fields: int, sep: str = " "):
        self.words = list(words)
        self.n_fields = n_fields
        self.sep = sep
        self._warr = np.asarray(self.words, dtype=object)

    def __len__(self):
        return len(self.words) ** self.n_fields

    def fields_of(self, codes: np.ndarray) -> np.ndarray:
        codes = np.asarray(codes, dtype=np.int64)
        out = np.empty((self.n_fields, len(codes)), dtype=np.int64)
        for f in range(self.n_fields):
            out[f] = (codes >> (self.BITS * f)) & ((1 << self.BITS) - 1)
        return out

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        fields = self.fields_of(codes)
        cols = [self._warr[fields[f] % len(self.words)] for f in range(self.n_fields)]
        return np.asarray([self.sep.join(t) for t in zip(*cols)], dtype=object)

    def word_id(self, word: str) -> int:
        try:
            return self.words.index(word)
        except ValueError:
            return -1

    def pack(self, field_ids: np.ndarray) -> np.ndarray:
        """field_ids shape (n_fields, n) -> packed codes."""
        out = np.zeros(field_ids.shape[1], dtype=np.int64)
        for f in range(self.n_fields):
            out |= field_ids[f].astype(np.int64) << (self.BITS * f)
        return out

    def code_of(self, value: str) -> int:
        parts = value.split(self.sep)
        if len(parts) != self.n_fields:
            return -1
        ids = []
        for p in parts:
            i = self.word_id(p)
            if i < 0:
                return -1
            ids.append(i)
        return int(self.pack(np.asarray([[i] for i in ids]))[0])

    def __repr__(self):
        return f"PackedWordsDictionary({len(self.words)}^{self.n_fields})"


# shared dictionary instances (identity-hashed; one per process)
DICT_REGION_NAME = Dictionary(REGIONS)
DICT_NATION_NAME = Dictionary([n for n, _ in NATIONS])
DICT_P_TYPE = Dictionary(P_TYPES)
DICT_CONTAINER = Dictionary(CONTAINERS)
DICT_SEGMENT = Dictionary(SEGMENTS)
DICT_PRIORITY = Dictionary(PRIORITIES)
DICT_SHIP_MODE = Dictionary(SHIP_MODES)
DICT_SHIP_INSTRUCT = Dictionary(SHIP_INSTRUCT)
DICT_MFGR = Dictionary([f"Manufacturer#{i}" for i in range(1, 6)])
DICT_BRAND = Dictionary([f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)])
DICT_RETURNFLAG = Dictionary(["A", "N", "R"])
DICT_LINESTATUS = Dictionary(["F", "O"])
DICT_ORDERSTATUS = Dictionary(["F", "O", "P"])
DICT_P_NAME = PackedWordsDictionary(COLORS, 5)
DICT_COMMENT = PackedWordsDictionary(NOISE_WORDS, 6)
DICT_CUST_NAME = FormattedDictionary(
    lambda c: np.asarray([f"Customer#{i:09d}" for i in c], dtype=object),
    monotonic=True)
DICT_SUPP_NAME = FormattedDictionary(
    lambda c: np.asarray([f"Supplier#{i:09d}" for i in c], dtype=object),
    monotonic=True)
DICT_CLERK = FormattedDictionary(
    lambda c: np.asarray([f"Clerk#{i:09d}" for i in c], dtype=object),
    monotonic=True)
DICT_ADDRESS = FormattedDictionary(
    lambda c: np.asarray([f"addr-{i:x}" for i in c], dtype=object))
DICT_PHONE_COUNTRY = Dictionary([str(11 + k) for k in range(25)])
DICT_PHONE = FormattedDictionary(
    lambda c: np.asarray(
        [f"{11 + (i % 25)}-{(i // 25) % 900 + 100}-{(i // 977) % 900 + 100}-{i % 9000 + 1000}"
         for i in c], dtype=object),
    # substring(phone, 1, 2) is the country code "11".."35" = code % 25 + 11
    substr_rules={(1, 2): (DICT_PHONE_COUNTRY, lambda c: c % 25)})


def _comment_codes(tid: int, cid: int, idx: np.ndarray) -> np.ndarray:
    fields = np.stack([_uniform(tid, cid * 16 + f, idx, 0, len(NOISE_WORDS) - 1)
                       for f in range(DICT_COMMENT.n_fields)])
    return DICT_COMMENT.pack(fields)


# ---------------------------------------------------------------------------
# table schemas + column generators
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TpchColumn:
    name: str
    type: Type
    gen: Callable[[np.ndarray, float], np.ndarray]  # (row_idx, sf) -> np array
    dictionary: Optional[Dictionary] = None


@dataclasses.dataclass
class TpchTable:
    name: str
    table_id: int
    row_count: Callable[[float], int]
    columns: List[TpchColumn]

    def column(self, name: str) -> TpchColumn:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


def _retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    pk = partkey.astype(np.int64)
    return 90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)


def _acctbal_cents(tid: int, cid: int, idx: np.ndarray) -> np.ndarray:
    return _uniform(tid, cid, idx, -99999, 999999)


def _make_region() -> TpchTable:
    return TpchTable("region", 0, lambda sf: 5, [
        TpchColumn("r_regionkey", BIGINT, lambda i, sf: i.astype(np.int64)),
        TpchColumn("r_name", VARCHAR, lambda i, sf: i.astype(np.int32), DICT_REGION_NAME),
        TpchColumn("r_comment", WIDE_VARCHAR, lambda i, sf: _comment_codes(0, 2, i), DICT_COMMENT),
    ])


def _make_nation() -> TpchTable:
    regionkeys = np.asarray([r for _, r in NATIONS], dtype=np.int64)
    return TpchTable("nation", 1, lambda sf: 25, [
        TpchColumn("n_nationkey", BIGINT, lambda i, sf: i.astype(np.int64)),
        TpchColumn("n_name", VARCHAR, lambda i, sf: i.astype(np.int32), DICT_NATION_NAME),
        TpchColumn("n_regionkey", BIGINT, lambda i, sf: regionkeys[i]),
        TpchColumn("n_comment", WIDE_VARCHAR, lambda i, sf: _comment_codes(1, 3, i), DICT_COMMENT),
    ])


def _make_supplier() -> TpchTable:
    T = 2
    return TpchTable("supplier", T, lambda sf: int(sf * 10_000), [
        TpchColumn("s_suppkey", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        TpchColumn("s_name", VARCHAR, lambda i, sf: (i + 1).astype(np.int32), DICT_SUPP_NAME),
        TpchColumn("s_address", WIDE_VARCHAR, lambda i, sf: _stream(T, 2, i).astype(np.int64) % (1 << 40),
                   DICT_ADDRESS),
        TpchColumn("s_nationkey", BIGINT, lambda i, sf: _uniform(T, 3, i, 0, 24)),
        TpchColumn("s_phone", WIDE_VARCHAR, lambda i, sf: _stream(T, 4, i).astype(np.int64) % (1 << 40),
                   DICT_PHONE),
        TpchColumn("s_acctbal", DEC, lambda i, sf: _acctbal_cents(T, 5, i)),
        TpchColumn("s_comment", WIDE_VARCHAR, lambda i, sf: _comment_codes(T, 6, i), DICT_COMMENT),
    ])


def _make_part() -> TpchTable:
    T = 3

    def name_codes(i, sf):
        fields = np.stack([_uniform(T, 16 + f, i, 0, len(COLORS) - 1) for f in range(5)])
        return DICT_P_NAME.pack(fields)

    return TpchTable("part", T, lambda sf: int(sf * 200_000), [
        TpchColumn("p_partkey", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        TpchColumn("p_name", WIDE_VARCHAR, name_codes, DICT_P_NAME),
        TpchColumn("p_mfgr", VARCHAR, lambda i, sf: _uniform(T, 2, i, 0, 4).astype(np.int32),
                   DICT_MFGR),
        TpchColumn("p_brand", VARCHAR, lambda i, sf: (
            _uniform(T, 2, i, 0, 4) * 5 + _uniform(T, 3, i, 0, 4)).astype(np.int32), DICT_BRAND),
        TpchColumn("p_type", VARCHAR, lambda i, sf: _uniform(T, 4, i, 0, 149).astype(np.int32),
                   DICT_P_TYPE),
        TpchColumn("p_size", INTEGER, lambda i, sf: _uniform(T, 5, i, 1, 50).astype(np.int32)),
        TpchColumn("p_container", VARCHAR, lambda i, sf: _uniform(T, 6, i, 0, 39).astype(np.int32),
                   DICT_CONTAINER),
        TpchColumn("p_retailprice", DEC, lambda i, sf: _retail_price_cents(i + 1)),
        TpchColumn("p_comment", WIDE_VARCHAR, lambda i, sf: _comment_codes(T, 7, i), DICT_COMMENT),
    ])


def _supplier_for(partkey: np.ndarray, supp_idx: np.ndarray, sf: float) -> np.ndarray:
    """TPC-H spec 4.2.3: ps_suppkey spread so joins are uniform."""
    s = int(sf * 10_000)
    pk = partkey.astype(np.int64)
    return ((pk + supp_idx * ((s // 4) + (pk - 1) // s)) % s) + 1


def _make_partsupp() -> TpchTable:
    T = 4
    return TpchTable("partsupp", T, lambda sf: int(sf * 200_000) * 4, [
        TpchColumn("ps_partkey", BIGINT, lambda i, sf: (i // 4).astype(np.int64) + 1),
        TpchColumn("ps_suppkey", BIGINT,
                   lambda i, sf: _supplier_for((i // 4) + 1, i % 4, sf)),
        TpchColumn("ps_availqty", INTEGER, lambda i, sf: _uniform(T, 2, i, 1, 9999).astype(np.int32)),
        TpchColumn("ps_supplycost", DEC, lambda i, sf: _uniform(T, 3, i, 100, 100000)),
        TpchColumn("ps_comment", WIDE_VARCHAR, lambda i, sf: _comment_codes(T, 4, i), DICT_COMMENT),
    ])


def _make_customer() -> TpchTable:
    T = 5
    return TpchTable("customer", T, lambda sf: int(sf * 150_000), [
        TpchColumn("c_custkey", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        TpchColumn("c_name", VARCHAR, lambda i, sf: (i + 1).astype(np.int32), DICT_CUST_NAME),
        TpchColumn("c_address", WIDE_VARCHAR, lambda i, sf: _stream(T, 2, i).astype(np.int64) % (1 << 40),
                   DICT_ADDRESS),
        TpchColumn("c_nationkey", BIGINT, lambda i, sf: _uniform(T, 3, i, 0, 24)),
        TpchColumn("c_phone", WIDE_VARCHAR, lambda i, sf: _stream(T, 4, i).astype(np.int64) % (1 << 40),
                   DICT_PHONE),
        TpchColumn("c_acctbal", DEC, lambda i, sf: _acctbal_cents(T, 5, i)),
        TpchColumn("c_mktsegment", VARCHAR, lambda i, sf: _uniform(T, 6, i, 0, 4).astype(np.int32),
                   DICT_SEGMENT),
        TpchColumn("c_comment", WIDE_VARCHAR, lambda i, sf: _comment_codes(T, 7, i), DICT_COMMENT),
    ])


def _o_orderdate(idx: np.ndarray) -> np.ndarray:
    return _uniform(6, 4, idx, MIN_DATE, MAX_ORDER_DATE).astype(np.int32)


def _make_orders() -> TpchTable:
    T = 6

    def custkey(i, sf):
        c = int(sf * 150_000)
        n = max(c - c // 3, 1)
        k = _uniform(T, 1, i, 0, n - 1)
        # map to keys not divisible by 3: 0->1, 1->2, 2->4, 3->5, 4->7 ...
        return (k // 2 * 3 + k % 2 + 1).astype(np.int64)

    return TpchTable("orders", T, lambda sf: int(sf * 1_500_000), [
        TpchColumn("o_orderkey", BIGINT, lambda i, sf: _order_key(i)),
        TpchColumn("o_custkey", BIGINT, custkey),
        TpchColumn("o_orderstatus", VARCHAR, lambda i, sf: _order_status(i).astype(np.int32),
                   DICT_ORDERSTATUS),
        TpchColumn("o_totalprice", DEC, lambda i, sf: _o_totalprice(i, sf)),
        TpchColumn("o_orderdate", DATE, lambda i, sf: _o_orderdate(i)),
        TpchColumn("o_orderpriority", VARCHAR,
                   lambda i, sf: _uniform(T, 5, i, 0, 4).astype(np.int32), DICT_PRIORITY),
        TpchColumn("o_clerk", VARCHAR,
                   lambda i, sf: _uniform(T, 6, i, 1, max(int(sf * 1000), 1)).astype(np.int32),
                   DICT_CLERK),
        TpchColumn("o_shippriority", INTEGER, lambda i, sf: np.zeros(len(i), dtype=np.int32)),
        TpchColumn("o_comment", WIDE_VARCHAR, lambda i, sf: _comment_codes(T, 8, i), DICT_COMMENT),
    ])


def _order_key(order_idx: np.ndarray) -> np.ndarray:
    """Sparse orderkeys like dbgen (8 per 32-key block)."""
    i = order_idx.astype(np.int64)
    return (i // 8) * 32 + (i % 8) + 1


def _line_count(order_idx: np.ndarray) -> np.ndarray:
    """1..7 lineitems per order, deterministic (spec: uniform)."""
    return _uniform(7, 0, order_idx, 1, 7)


def _l_shipdate(order_idx: np.ndarray, line_no: np.ndarray) -> np.ndarray:
    odate = _o_orderdate(order_idx).astype(np.int64)
    return (odate + _uniform(7, 10, order_idx * 8 + line_no, 1, 121)).astype(np.int32)


def _order_status(order_idx: np.ndarray) -> np.ndarray:
    """F if all lineitems shipped before CURRENT_DATE, O if none, else P."""
    n = _line_count(order_idx)
    shipped = np.zeros(len(order_idx), dtype=np.int64)
    for ln in range(1, 8):
        d = _l_shipdate(order_idx, np.full(len(order_idx), ln))
        shipped += ((ln <= n) & (d < CURRENT_DATE)).astype(np.int64)
    return np.where(shipped == n, 0, np.where(shipped == 0, 1, 2))


def _lineitem_price_cents(order_idx: np.ndarray, line_no: np.ndarray, sf: float):
    lkey = order_idx.astype(np.int64) * 8 + line_no
    partkey = _uniform(7, 2, lkey, 1, int(sf * 200_000))
    qty = _uniform(7, 4, lkey, 1, 50)
    extprice = qty * _retail_price_cents(partkey)
    return partkey, qty, extprice


def _o_totalprice(order_idx: np.ndarray, sf: float) -> np.ndarray:
    n = _line_count(order_idx)
    total = np.zeros(len(order_idx), dtype=np.int64)
    for ln in range(1, 8):
        lkey = order_idx.astype(np.int64) * 8 + ln
        _, _, ext = _lineitem_price_cents(order_idx, np.full(len(order_idx), ln), sf)
        disc = _uniform(7, 5, lkey, 0, 10)
        tax = _uniform(7, 6, lkey, 0, 8)
        line = ext * (100 - disc) * (100 + tax) // 10000
        total += np.where(ln <= n, line, 0)
    return total


TPCH_TABLES: Dict[str, TpchTable] = {}
for _t in (_make_region(), _make_nation(), _make_supplier(), _make_part(),
           _make_partsupp(), _make_customer(), _make_orders()):
    TPCH_TABLES[_t.name] = _t

LINEITEM_ID = 7
AVG_LINES_PER_ORDER = 4.0

LINEITEM_COLUMNS: List[Tuple[str, Type, Optional[Dictionary]]] = [
    ("l_orderkey", BIGINT, None),
    ("l_partkey", BIGINT, None),
    ("l_suppkey", BIGINT, None),
    ("l_linenumber", INTEGER, None),
    ("l_quantity", DEC, None),
    ("l_extendedprice", DEC, None),
    ("l_discount", DEC, None),
    ("l_tax", DEC, None),
    ("l_returnflag", VARCHAR, DICT_RETURNFLAG),
    ("l_linestatus", VARCHAR, DICT_LINESTATUS),
    ("l_shipdate", DATE, None),
    ("l_commitdate", DATE, None),
    ("l_receiptdate", DATE, None),
    ("l_shipinstruct", VARCHAR, DICT_SHIP_INSTRUCT),
    ("l_shipmode", VARCHAR, DICT_SHIP_MODE),
    ("l_comment", WIDE_VARCHAR, DICT_COMMENT),
]


def lineitem_for_orders(order_lo: int, order_hi: int, sf: float,
                        columns: Sequence[str]) -> Dict[str, np.ndarray]:
    """Generate lineitem rows for orders [order_lo, order_hi) — the lineitem table is
    split BY ORDER RANGE (like the reference's TpchSplitManager keyspace partitioning),
    so row counts per split vary and pages carry masks."""
    order_idx = np.arange(order_lo, order_hi, dtype=np.int64)
    counts = _line_count(order_idx)
    total = int(counts.sum())
    # expand: row r belongs to order order_idx[o], line number 1..counts[o]
    o_rep = np.repeat(order_idx, counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    line_no = (np.arange(total, dtype=np.int64) - np.repeat(starts, counts)) + 1
    lkey = o_rep * 8 + line_no

    out: Dict[str, np.ndarray] = {}
    need = set(columns)
    partkey = qty = extprice = None
    if need & {"l_partkey", "l_suppkey", "l_quantity", "l_extendedprice"}:
        partkey, qty, extprice = _lineitem_price_cents(o_rep, line_no, sf)
    for name in columns:
        if name == "l_orderkey":
            out[name] = _order_key(o_rep)
        elif name == "l_partkey":
            out[name] = partkey
        elif name == "l_suppkey":
            out[name] = _supplier_for(partkey, _uniform(7, 3, lkey, 0, 3), sf)
        elif name == "l_linenumber":
            out[name] = line_no.astype(np.int32)
        elif name == "l_quantity":
            out[name] = qty * 100  # decimal(12,2) cents
        elif name == "l_extendedprice":
            out[name] = extprice
        elif name == "l_discount":
            out[name] = _uniform(7, 5, lkey, 0, 10)
        elif name == "l_tax":
            out[name] = _uniform(7, 6, lkey, 0, 8)
        elif name == "l_returnflag":
            recv = out.get("l_receiptdate")
            if recv is None:
                recv = _receiptdate(o_rep, line_no)
            r = _uniform(7, 7, lkey, 0, 1)  # A or R for returned
            out[name] = np.where(recv <= CURRENT_DATE, np.where(r == 0, 0, 2), 1).astype(np.int32)
        elif name == "l_linestatus":
            ship = _l_shipdate(o_rep, line_no)
            out[name] = (ship > CURRENT_DATE).astype(np.int32)  # F=0 shipped, O=1
        elif name == "l_shipdate":
            out[name] = _l_shipdate(o_rep, line_no)
        elif name == "l_commitdate":
            odate = _o_orderdate(o_rep).astype(np.int64)
            out[name] = (odate + _uniform(7, 11, lkey, 30, 90)).astype(np.int32)
        elif name == "l_receiptdate":
            out[name] = _receiptdate(o_rep, line_no)
        elif name == "l_shipinstruct":
            out[name] = _uniform(7, 12, lkey, 0, 3).astype(np.int32)
        elif name == "l_shipmode":
            out[name] = _uniform(7, 13, lkey, 0, 6).astype(np.int32)
        elif name == "l_comment":
            out[name] = _comment_codes(7, 14, lkey)
        else:
            raise KeyError(name)
    return out


def _receiptdate(o_rep: np.ndarray, line_no: np.ndarray) -> np.ndarray:
    ship = _l_shipdate(o_rep, line_no).astype(np.int64)
    return (ship + _uniform(7, 9, o_rep * 8 + line_no, 1, 30)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def lineitem_row_count(sf: float) -> int:
    """Exact total lineitem rows (sum of per-order counts; cached per sf)."""
    orders = int(sf * 1_500_000)
    # counts are uniform-ish 1..7; compute exactly in chunks to stay O(1) memory
    total = 0
    step = 4_000_000
    for lo in range(0, orders, step):
        hi = min(lo + step, orders)
        total += int(_line_count(np.arange(lo, hi, dtype=np.int64)).sum())
    return total


def table_row_count(name: str, sf: float) -> int:
    if name == "lineitem":
        return lineitem_row_count(sf)
    return TPCH_TABLES[name].row_count(sf)


def generate_rows(table: str, row_lo: int, row_hi: int, sf: float,
                  columns: Sequence[str]) -> Dict[str, np.ndarray]:
    """Generate a row range of a non-lineitem table."""
    t = TPCH_TABLES[table]
    idx = np.arange(row_lo, row_hi, dtype=np.int64)
    return {name: t.column(name).gen(idx, sf) for name in columns}


def _orderkey_hi(sf: float) -> int:
    n = int(sf * 1_500_000)
    return int(_order_key(np.asarray([max(n - 1, 0)]))[0])
