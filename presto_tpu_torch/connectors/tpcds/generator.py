"""Deterministic, vectorized TPC-DS data generator (the Q64/Q72 table set).

Analogue of presto-tpcds (TpcdsConnectorFactory/TpcdsRecordSet wrapping the
teradata dsdgen port): here, as with the TPC-H connector, every column value is
a pure function of (table, column, row index) through splitmix64 streams, so
any split generates independently. Distributions follow the spec SHAPE
(uniform domains, weekly inventory, returns as a sales subset); dsdgen
bit-compatibility is NOT a goal — correctness is checked against the sqlite
oracle over this same data.

Fact/dimension correlations that the north-star queries (Q64, Q72) exercise:
- store_returns rows are a deterministic subset of store_sales rows (same
  item_sk + ticket_number), catalog_returns likewise mirror catalog_sales —
  so sales<->returns joins have real matches;
- date_dim is a contiguous day range with derived year/week; sales date FKs
  land inside it, inventory is weekly per (item, warehouse) over the Q72
  window; customer first-sale/first-ship dates precede current dates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ...block import Dictionary
from ...types import (BIGINT, DATE, DecimalType, INTEGER, Type, VARCHAR,
                      WIDE_VARCHAR)
from ..tpch.generator import (COLORS, TpchColumn as Column, TpchTable as Table,
                              _mix, _stream, _uniform, FormattedDictionary)

DEC = DecimalType(12, 2)

# date_dim window: 1998-01-01 .. 2002-12-31 (covers the Q64/Q72 1999/2000
# predicates with slack on both sides)
D_BASE = 10227            # days since epoch for 1998-01-01
N_DATES = 1826            # through 2002-12-31
_YEAR_STARTS = [10227, 10592, 10957, 11323, 11688, 12053]  # 1998..2003
WEEK0 = D_BASE // 7

# 1999 week range for inventory (Q72 joins inventory to 1999 sold dates by
# week_seq; generate weekly snapshots with slack into 2000)
INV_FIRST_WEEK = (D_BASE + 365) // 7 - 1
INV_WEEKS = 56

MARITAL = ["D", "M", "S", "U", "W"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
GENDER = ["F", "M"]
BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000", ">10000",
                 "Unknown"]
CREDIT_RATING = ["Low Risk", "Good", "High Risk", "Unknown"]
CITIES = ["Fairview", "Midway", "Pleasant Hill", "Centerville", "Oak Grove",
          "Riverside", "Five Points", "Oakland", "Springdale", "Union",
          "Salem", "Wilson", "Greenfield", "Lakeview", "Glendale"]
STREETS = ["Main", "Oak", "Park", "Elm", "College", "Washington", "Cedar",
           "Highland", "Lake", "Hill", "Railroad", "Jackson", "Mill",
           "Spring", "Ridge"]
STORE_NAMES = ["ought", "able", "pri", "ese", "anti", "cally", "ation",
               "eing", "bar", "ought2", "able2", "pri2"]
WAREHOUSES = ["Conventional childr", "Important issues liv", "Doors canno",
              "Bad cards must make", "Rooms cook "]
DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]
STATES = ["AL", "CA", "GA", "IL", "KY", "LA", "MI", "MN", "MO", "MS",
          "NC", "NM", "NY", "OH", "OK", "OR", "PA", "SC", "TN", "TX",
          "VA", "WA", "WI", "WV"]
COUNTIES = ["Williamson County", "Walker County", "Ziebach County",
            "Franklin Parish", "Luce County", "Richland County",
            "Bronx County", "Orange County", "Salem County",
            "Fairfield County"]
COUNTRIES = ["United States"]
STREET_TYPES = ["Ave", "Blvd", "Cir", "Ct", "Dr", "Ln", "Pkwy", "RD",
                "ST", "Way"]
CHANNEL_FLAGS = ["N", "Y"]
FIRST_NAMES = ["James", "Mary", "John", "Patricia", "Robert", "Jennifer",
               "Michael", "Linda", "William", "Elizabeth", "David",
               "Barbara", "Richard", "Susan", "Joseph", "Jessica"]
LAST_NAMES = ["Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
              "Miller", "Davis", "Rodriguez", "Martinez", "Hernandez",
              "Lopez", "Gonzales", "Wilson", "Anderson", "Thomas"]

DICT_MARITAL = Dictionary(MARITAL)
DICT_EDUCATION = Dictionary(sorted(EDUCATION))
DICT_GENDER = Dictionary(GENDER)
DICT_BUY_POTENTIAL = Dictionary(sorted(BUY_POTENTIAL))
DICT_CREDIT = Dictionary(sorted(CREDIT_RATING))
DICT_CITY = Dictionary(sorted(CITIES))
DICT_STREET = Dictionary(sorted(STREETS))
DICT_STORE_NAME = Dictionary(sorted(STORE_NAMES))
DICT_WAREHOUSE = Dictionary(sorted(WAREHOUSES))
DICT_DAY_NAME = Dictionary(sorted(DAY_NAMES))
DICT_COLOR = Dictionary(sorted(COLORS))
DICT_STORE_ID = FormattedDictionary(
    lambda c: np.asarray([f"AAAAAAAA{i:08d}" for i in c], dtype=object),
    monotonic=True)
# zero-padded so code order == lexicographic order (ORDER BY sorts raw codes)
DICT_SUITE = FormattedDictionary(
    lambda c: np.asarray([f"Suite {i % 100:02d}" for i in c], dtype=object),
    monotonic=True)
DICT_STATE = Dictionary(sorted(STATES))
DICT_COUNTY = Dictionary(sorted(COUNTIES))
DICT_COUNTRY = Dictionary(COUNTRIES)
DICT_STREET_TYPE = Dictionary(sorted(STREET_TYPES))
DICT_CHANNEL = Dictionary(CHANNEL_FLAGS)  # already sorted: N < Y
DICT_FIRST_NAME = Dictionary(sorted(FIRST_NAMES))
DICT_LAST_NAME = Dictionary(sorted(LAST_NAMES))
class _ZipDictionary(FormattedDictionary):
    """5-digit zips: codes ARE the numeric value, so string constants
    reverse-map by parsing (code_of) and substr(zip, 1, 5) is identity."""

    def code_of(self, value: str) -> int:
        v = str(value)
        return int(v) if len(v) == 5 and v.isdigit() else -1


DICT_ZIP = _ZipDictionary(
    lambda c: np.asarray([f"{i % 100000:05d}" for i in c], dtype=object),
    monotonic=True)
DICT_ZIP.substr_rules[(1, 5)] = (DICT_ZIP, lambda c: c)
# zero-padded, range capped at 999 so every value is exactly 3 chars and
# code order == lexicographic order (sortable virtually)
DICT_STREET_NUMBER = FormattedDictionary(
    lambda c: np.asarray([f"{i % 999 + 1:03d}" for i in c], dtype=object),
    monotonic=True)
DICT_PRODUCT_NAME = FormattedDictionary(
    lambda c: np.asarray([f"product{i:09d}" for i in c], dtype=object),
    monotonic=True)
DICT_ITEM_DESC = FormattedDictionary(
    lambda c: np.asarray([f"item description {i:07d}" for i in c],
                         dtype=object), monotonic=True)
DICT_ITEM_ID = FormattedDictionary(
    lambda c: np.asarray([f"AAAAAAAA{i:08d}" for i in c], dtype=object),
    monotonic=True)
DICT_PROMO_NAME = FormattedDictionary(
    lambda c: np.asarray([f"promo{i:06d}" for i in c], dtype=object),
    monotonic=True)

# table ids continue after tpch's 0..7
_T = {"date_dim": 16, "item": 17, "store": 18, "warehouse": 19,
      "customer": 20, "customer_address": 21, "customer_demographics": 22,
      "household_demographics": 23, "income_band": 24, "promotion": 25,
      "store_sales": 26, "store_returns": 27, "catalog_sales": 28,
      "catalog_returns": 29, "inventory": 30}


def _year_of(date_days: np.ndarray) -> np.ndarray:
    out = np.full(len(date_days), 1998, dtype=np.int32)
    for i, start in enumerate(_YEAR_STARTS[1:], start=1):
        out = np.where(date_days >= start, 1998 + i, out)
    return out.astype(np.int32)


# ------------------------------------------------------------------ sizing

def _rows(base_sf1: int, sf: float, floor: int) -> int:
    return max(int(base_sf1 * sf), floor)


def n_items(sf): return _rows(18000, sf, 1000)
def n_stores(sf): return max(int(12 * max(sf, 1) ** 0.5), 12)
def n_warehouses(sf): return 5
def n_customers(sf): return _rows(100_000, sf, 1000)
def n_addresses(sf): return _rows(50_000, sf, 500)
def n_cdemo(sf): return 7200
def n_hdemo(sf): return 720
def n_income_bands(sf): return 20
def n_promotions(sf): return _rows(300, sf, 50)
def n_store_sales(sf): return _rows(2_880_000, sf, 40_000)
def n_store_returns(sf): return n_store_sales(sf) // 5
def n_catalog_sales(sf): return _rows(1_440_000, sf, 15_000)
def n_catalog_returns(sf): return n_catalog_sales(sf) // 10
def n_inventory(sf): return n_items(sf) * n_warehouses(sf) * INV_WEEKS


# ------------------------------------------------------------- dimensions

def _make_date_dim() -> Table:
    T = _T["date_dim"]
    return Table("date_dim", T, lambda sf: N_DATES, [
        Column("d_date_sk", BIGINT, lambda i, sf: i.astype(np.int64)),
        Column("d_date", DATE, lambda i, sf: (D_BASE + i).astype(np.int32)),
        Column("d_year", INTEGER, lambda i, sf: _year_of(D_BASE + i)),
        Column("d_week_seq", INTEGER,
               lambda i, sf: ((D_BASE + i) // 7 - WEEK0 + 1).astype(np.int32)),
        Column("d_moy", INTEGER,
               lambda i, sf: (((i % 365) // 31) % 12 + 1).astype(np.int32)),
        Column("d_dom", INTEGER, lambda i, sf: ((i % 31) + 1).astype(np.int32)),
        Column("d_qoy", INTEGER,
               lambda i, sf: (((i % 365) // 92) % 4 + 1).astype(np.int32)),
        Column("d_day_name", VARCHAR, lambda i, sf: _day_name_codes(i),
               DICT_DAY_NAME),
        # dsdgen convention: 0 = Sunday .. 6 = Saturday (the spec queries
        # use d_dow in (6, 0) for weekends); 1998-01-01 was a Thursday = 4
        Column("d_dow", INTEGER,
               lambda i, sf: ((np.asarray(i, dtype=np.int64) + 4) % 7
                              ).astype(np.int32)),
    ])


def _day_name_codes(i: np.ndarray) -> np.ndarray:
    # 1998-01-01 was a Thursday; map day-of-week to the sorted dictionary
    dow = (np.asarray(i, dtype=np.int64) + 3) % 7  # 0=Monday
    sorted_idx = np.asarray([sorted(DAY_NAMES).index(n) for n in DAY_NAMES])
    return sorted_idx[dow].astype(np.int32)


def _make_item() -> Table:
    T = _T["item"]
    return Table("item", T, lambda sf: n_items(sf), [
        Column("i_item_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("i_item_id", VARCHAR, lambda i, sf: (i + 1).astype(np.int64),
               DICT_ITEM_ID),
        Column("i_item_desc", WIDE_VARCHAR,
               lambda i, sf: (i + 1).astype(np.int64), DICT_ITEM_DESC),
        Column("i_product_name", WIDE_VARCHAR,
               lambda i, sf: (i + 1).astype(np.int64), DICT_PRODUCT_NAME),
        Column("i_color", VARCHAR,
               lambda i, sf: _uniform(T, 4, i, 0, len(COLORS) - 1).astype(np.int32),
               DICT_COLOR),
        Column("i_current_price", DEC,
               lambda i, sf: _uniform(T, 5, i, 100, 9999)),
        Column("i_wholesale_cost", DEC,
               lambda i, sf: _uniform(T, 6, i, 50, 7000)),
        Column("i_brand_id", INTEGER,
               lambda i, sf: _uniform(T, 7, i, 1, 1000).astype(np.int32)),
        Column("i_class_id", INTEGER,
               lambda i, sf: _uniform(T, 8, i, 1, 16).astype(np.int32)),
        Column("i_category_id", INTEGER,
               lambda i, sf: _uniform(T, 9, i, 1, 10).astype(np.int32)),
        Column("i_manufact_id", INTEGER,
               lambda i, sf: _uniform(T, 10, i, 1, 1000).astype(np.int32)),
    ])


def _make_store() -> Table:
    T = _T["store"]
    return Table("store", T, lambda sf: n_stores(sf), [
        Column("s_store_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("s_store_name", VARCHAR,
               lambda i, sf: _sorted_codes(DICT_STORE_NAME, STORE_NAMES,
                                           i % len(STORE_NAMES)),
               DICT_STORE_NAME),
        Column("s_zip", VARCHAR,
               lambda i, sf: _uniform(T, 2, i, 0, 99999), DICT_ZIP),
        Column("s_city", VARCHAR,
               lambda i, sf: _sorted_codes(DICT_CITY, CITIES,
                                           _uniform(T, 3, i, 0, len(CITIES) - 1)),
               DICT_CITY),
        Column("s_number_employees", INTEGER,
               lambda i, sf: _uniform(T, 4, i, 200, 300).astype(np.int32)),
        Column("s_store_id", VARCHAR, lambda i, sf: (i + 1).astype(np.int64),
               DICT_STORE_ID),
        Column("s_company_id", INTEGER,
               lambda i, sf: np.ones(len(i), dtype=np.int32)),
        Column("s_gmt_offset", DEC,
               lambda i, sf: -(_uniform(T, 5, i, 5, 8) * 100)),
        Column("s_state", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_STATE, STATES,
                   _uniform(T, 6, i, 0, len(STATES) - 1)), DICT_STATE),
        Column("s_county", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_COUNTY, COUNTIES,
                   _uniform(T, 7, i, 0, len(COUNTIES) - 1)), DICT_COUNTY),
        Column("s_street_number", VARCHAR,
               lambda i, sf: _uniform(T, 8, i, 0, 998), DICT_STREET_NUMBER),
        Column("s_street_name", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_STREET, STREETS,
                   _uniform(T, 9, i, 0, len(STREETS) - 1)), DICT_STREET),
        Column("s_street_type", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_STREET_TYPE, STREET_TYPES,
                   _uniform(T, 10, i, 0, len(STREET_TYPES) - 1)),
               DICT_STREET_TYPE),
        Column("s_suite_number", VARCHAR,
               lambda i, sf: _uniform(T, 11, i, 0, 99), DICT_SUITE),
    ])


def _sorted_codes(d: Dictionary, original: List[str], idx) -> np.ndarray:
    """Map 'index into original list' -> code in the SORTED dictionary."""
    mapping = np.asarray([sorted(original).index(v) for v in original])
    return mapping[np.asarray(idx, dtype=np.int64)].astype(np.int32)


def _make_warehouse() -> Table:
    T = _T["warehouse"]
    return Table("warehouse", T, lambda sf: n_warehouses(sf), [
        Column("w_warehouse_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("w_warehouse_name", VARCHAR,
               lambda i, sf: _sorted_codes(DICT_WAREHOUSE, WAREHOUSES,
                                           i % len(WAREHOUSES)),
               DICT_WAREHOUSE),
        Column("w_warehouse_sq_ft", INTEGER,
               lambda i, sf: _uniform(T, 2, i, 50_000, 1_000_000).astype(np.int32)),
    ])


def _make_customer() -> Table:
    T = _T["customer"]

    def first_sales(i, sf):
        return _uniform(T, 4, i, 30, N_DATES // 2).astype(np.int64)

    return Table("customer", T, lambda sf: n_customers(sf), [
        Column("c_customer_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("c_current_cdemo_sk", BIGINT,
               lambda i, sf: _uniform(T, 1, i, 1, n_cdemo(sf))),
        Column("c_current_hdemo_sk", BIGINT,
               lambda i, sf: _uniform(T, 2, i, 1, n_hdemo(sf))),
        Column("c_current_addr_sk", BIGINT,
               lambda i, sf: _uniform(T, 3, i, 1, n_addresses(sf))),
        Column("c_first_sales_date_sk", BIGINT, first_sales),
        Column("c_first_shipto_date_sk", BIGINT,
               lambda i, sf: first_sales(i, sf) + 30),
        Column("c_birth_year", INTEGER,
               lambda i, sf: _uniform(T, 6, i, 1930, 1992).astype(np.int32)),
        Column("c_first_name", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_FIRST_NAME, FIRST_NAMES,
                   _uniform(T, 7, i, 0, len(FIRST_NAMES) - 1)),
               DICT_FIRST_NAME),
        Column("c_last_name", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_LAST_NAME, LAST_NAMES,
                   _uniform(T, 8, i, 0, len(LAST_NAMES) - 1)),
               DICT_LAST_NAME),
    ])


def _make_customer_address() -> Table:
    T = _T["customer_address"]
    return Table("customer_address", T, lambda sf: n_addresses(sf), [
        Column("ca_address_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("ca_street_number", VARCHAR,
               lambda i, sf: _uniform(T, 1, i, 0, 998), DICT_STREET_NUMBER),
        Column("ca_street_name", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_STREET, STREETS,
                   _uniform(T, 2, i, 0, len(STREETS) - 1)), DICT_STREET),
        Column("ca_city", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_CITY, CITIES,
                   _uniform(T, 3, i, 0, len(CITIES) - 1)), DICT_CITY),
        Column("ca_zip", VARCHAR,
               lambda i, sf: _uniform(T, 4, i, 0, 99999), DICT_ZIP),
        Column("ca_gmt_offset", DEC,
               lambda i, sf: -(_uniform(T, 5, i, 5, 8) * 100)),
        Column("ca_state", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_STATE, STATES,
                   _uniform(T, 6, i, 0, len(STATES) - 1)), DICT_STATE),
        Column("ca_county", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_COUNTY, COUNTIES,
                   _uniform(T, 7, i, 0, len(COUNTIES) - 1)), DICT_COUNTY),
        Column("ca_country", VARCHAR,
               lambda i, sf: np.zeros(len(i), dtype=np.int32), DICT_COUNTRY),
    ])


def _make_customer_demographics() -> Table:
    T = _T["customer_demographics"]
    return Table("customer_demographics", T, lambda sf: n_cdemo(sf), [
        Column("cd_demo_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("cd_gender", VARCHAR,
               lambda i, sf: (i % 2).astype(np.int32), DICT_GENDER),
        Column("cd_marital_status", VARCHAR,
               lambda i, sf: ((i // 2) % 5).astype(np.int32), DICT_MARITAL),
        Column("cd_education_status", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_EDUCATION, EDUCATION, (i // 10) % 7), DICT_EDUCATION),
        Column("cd_purchase_estimate", INTEGER,
               lambda i, sf: (((i // 70) % 20 + 1) * 500).astype(np.int32)),
        Column("cd_credit_rating", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_CREDIT, CREDIT_RATING, (i // 1400) % 4), DICT_CREDIT),
        Column("cd_dep_count", INTEGER,
               lambda i, sf: ((i // 5600) % 7).astype(np.int32)),
    ])


def _make_household_demographics() -> Table:
    T = _T["household_demographics"]
    return Table("household_demographics", T, lambda sf: n_hdemo(sf), [
        Column("hd_demo_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("hd_income_band_sk", BIGINT,
               lambda i, sf: (i % n_income_bands(sf)).astype(np.int64) + 1),
        Column("hd_buy_potential", VARCHAR,
               lambda i, sf: _sorted_codes(
                   DICT_BUY_POTENTIAL, BUY_POTENTIAL,
                   (i // 20) % 6), DICT_BUY_POTENTIAL),
        # divisors chosen so the FULL spec domains (dep 0..9, vehicle 0..5)
        # appear within the 720-row table — (i//120)%10 never wrapped past
        # 5, which made spec predicates like hd_vehicle_count > 2
        # unsatisfiable at every scale
        Column("hd_dep_count", INTEGER,
               lambda i, sf: ((i // 72) % 10).astype(np.int32)),
        Column("hd_vehicle_count", INTEGER,
               lambda i, sf: ((i // 120) % 6).astype(np.int32)),
    ])


def _make_income_band() -> Table:
    T = _T["income_band"]
    return Table("income_band", T, lambda sf: n_income_bands(sf), [
        Column("ib_income_band_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("ib_lower_bound", INTEGER,
               lambda i, sf: (i * 10000).astype(np.int32)),
        Column("ib_upper_bound", INTEGER,
               lambda i, sf: ((i + 1) * 10000).astype(np.int32)),
    ])


def _make_promotion() -> Table:
    T = _T["promotion"]
    return Table("promotion", T, lambda sf: n_promotions(sf), [
        Column("p_promo_sk", BIGINT, lambda i, sf: i.astype(np.int64) + 1),
        Column("p_promo_name", VARCHAR,
               lambda i, sf: (i + 1).astype(np.int64), DICT_PROMO_NAME),
        Column("p_response_target", INTEGER,
               lambda i, sf: np.ones(len(i), dtype=np.int32)),
        # ~1/8 promos flag each channel Y (spec: mostly N)
        Column("p_channel_email", VARCHAR,
               lambda i, sf: (_uniform(T, 2, i, 0, 7) == 0).astype(np.int32),
               DICT_CHANNEL),
        Column("p_channel_event", VARCHAR,
               lambda i, sf: (_uniform(T, 3, i, 0, 7) == 0).astype(np.int32),
               DICT_CHANNEL),
        Column("p_channel_dmail", VARCHAR,
               lambda i, sf: (_uniform(T, 4, i, 0, 7) == 0).astype(np.int32),
               DICT_CHANNEL),
    ])


# ------------------------------------------------------------------ facts

def _fk(T: int, col: int, i: np.ndarray, n: int) -> np.ndarray:
    return _uniform(T, col, i, 1, max(n, 1))


def _make_store_sales() -> Table:
    T = _T["store_sales"]

    def wholesale(i, sf):
        return _uniform(T, 10, i, 100, 10000)

    def list_price(i, sf):
        return wholesale(i, sf) + _uniform(T, 11, i, 10, 5000)

    return Table("store_sales", T, lambda sf: n_store_sales(sf), [
        # date skew toward 1999/2000 (the Q64 self-join years) so year-pair
        # groups exist at small scales
        Column("ss_sold_date_sk", BIGINT,
               lambda i, sf: _uniform(T, 0, i, 330, 1090)),
        Column("ss_item_sk", BIGINT, lambda i, sf: _fk(T, 1, i, n_items(sf))),
        Column("ss_customer_sk", BIGINT,
               lambda i, sf: _fk(T, 2, i, n_customers(sf))),
        Column("ss_cdemo_sk", BIGINT, lambda i, sf: _fk(T, 3, i, n_cdemo(sf))),
        Column("ss_hdemo_sk", BIGINT, lambda i, sf: _fk(T, 4, i, n_hdemo(sf))),
        Column("ss_addr_sk", BIGINT,
               lambda i, sf: _fk(T, 5, i, n_addresses(sf))),
        Column("ss_store_sk", BIGINT, lambda i, sf: _fk(T, 6, i, n_stores(sf))),
        Column("ss_promo_sk", BIGINT,
               lambda i, sf: _fk(T, 7, i, n_promotions(sf))),
        Column("ss_ticket_number", BIGINT,
               lambda i, sf: i.astype(np.int64) + 1),
        Column("ss_quantity", INTEGER,
               lambda i, sf: _uniform(T, 9, i, 1, 100).astype(np.int32)),
        Column("ss_wholesale_cost", DEC, wholesale),
        Column("ss_list_price", DEC, list_price),
        Column("ss_sales_price", DEC,
               lambda i, sf: list_price(i, sf) - _uniform(T, 12, i, 0, 2000)),
        Column("ss_coupon_amt", DEC, lambda i, sf: _uniform(T, 13, i, 0, 500)),
        Column("ss_net_profit", DEC,
               lambda i, sf: _uniform(T, 14, i, -5000, 5000)),
        Column("ss_ext_sales_price", DEC,
               lambda i, sf: (list_price(i, sf) - _uniform(T, 12, i, 0, 2000))
               * _uniform(T, 9, i, 1, 100)),
        Column("ss_ext_wholesale_cost", DEC,
               lambda i, sf: wholesale(i, sf) * _uniform(T, 9, i, 1, 100)),
    ])


# store_returns row j mirrors store_sales row j*5 (same item + ticket), so
# the ss<->sr join has deterministic matches (the spec links them the same way)
def _sr_sales_row(i: np.ndarray) -> np.ndarray:
    return i.astype(np.int64) * 5


def _make_store_returns() -> Table:
    T = _T["store_returns"]
    ss = _make_store_sales()

    def from_sales(col: str):
        gen = ss.column(col).gen
        return lambda i, sf: gen(_sr_sales_row(i), sf)

    return Table("store_returns", T, lambda sf: n_store_returns(sf), [
        Column("sr_returned_date_sk", BIGINT,
               lambda i, sf: np.minimum(
                   from_sales("ss_sold_date_sk")(i, sf) +
                   _uniform(T, 0, i, 1, 60), N_DATES - 1)),
        Column("sr_item_sk", BIGINT, from_sales("ss_item_sk")),
        Column("sr_customer_sk", BIGINT, from_sales("ss_customer_sk")),
        Column("sr_ticket_number", BIGINT, from_sales("ss_ticket_number")),
        Column("sr_return_quantity", INTEGER,
               lambda i, sf: _uniform(T, 2, i, 1, 40).astype(np.int32)),
        Column("sr_return_amt", DEC, lambda i, sf: _uniform(T, 3, i, 10, 5000)),
    ])


def _make_catalog_sales() -> Table:
    T = _T["catalog_sales"]

    def sold_date(i, sf):
        return _uniform(T, 0, i, 0, N_DATES - 31)

    return Table("catalog_sales", T, lambda sf: n_catalog_sales(sf), [
        Column("cs_sold_date_sk", BIGINT, sold_date),
        Column("cs_ship_date_sk", BIGINT,
               lambda i, sf: sold_date(i, sf) + _uniform(T, 1, i, 2, 30)),
        Column("cs_item_sk", BIGINT, lambda i, sf: _fk(T, 2, i, n_items(sf))),
        Column("cs_order_number", BIGINT,
               lambda i, sf: i.astype(np.int64) + 1),
        Column("cs_bill_customer_sk", BIGINT,
               lambda i, sf: _fk(T, 3, i, n_customers(sf))),
        Column("cs_bill_cdemo_sk", BIGINT,
               lambda i, sf: _fk(T, 4, i, n_cdemo(sf))),
        Column("cs_bill_hdemo_sk", BIGINT,
               lambda i, sf: _fk(T, 5, i, n_hdemo(sf))),
        Column("cs_promo_sk", BIGINT,
               lambda i, sf: _fk(T, 6, i, n_promotions(sf))),
        Column("cs_warehouse_sk", BIGINT,
               lambda i, sf: _fk(T, 7, i, n_warehouses(sf))),
        Column("cs_quantity", INTEGER,
               lambda i, sf: _uniform(T, 8, i, 1, 100).astype(np.int32)),
        Column("cs_wholesale_cost", DEC,
               lambda i, sf: _uniform(T, 9, i, 100, 10000)),
        Column("cs_list_price", DEC,
               lambda i, sf: _uniform(T, 10, i, 100, 30000)),
        Column("cs_ext_list_price", DEC,
               lambda i, sf: _uniform(T, 11, i, 1000, 2_000_000)),
        Column("cs_sales_price", DEC,
               lambda i, sf: _uniform(T, 12, i, 50, 30000)),
        Column("cs_coupon_amt", DEC,
               lambda i, sf: _uniform(T, 13, i, 0, 1000)),
    ])


def _cr_sales_row(i: np.ndarray) -> np.ndarray:
    return i.astype(np.int64) * 10


def _make_catalog_returns() -> Table:
    T = _T["catalog_returns"]
    cs = _make_catalog_sales()

    def from_sales(col: str):
        gen = cs.column(col).gen
        return lambda i, sf: gen(_cr_sales_row(i), sf)

    return Table("catalog_returns", T, lambda sf: n_catalog_returns(sf), [
        Column("cr_returned_date_sk", BIGINT,
               lambda i, sf: np.minimum(
                   from_sales("cs_sold_date_sk")(i, sf) +
                   _uniform(T, 0, i, 1, 60), N_DATES - 1)),
        Column("cr_item_sk", BIGINT, from_sales("cs_item_sk")),
        Column("cr_order_number", BIGINT, from_sales("cs_order_number")),
        # refunds sized so most items pass Q64's HAVING sale > 2*refund,
        # but not all (the predicate stays selective)
        Column("cr_refunded_cash", DEC,
               lambda i, sf: _uniform(T, 2, i, 100, 150_000)),
        Column("cr_reversed_charge", DEC,
               lambda i, sf: _uniform(T, 3, i, 0, 50_000)),
        Column("cr_store_credit", DEC,
               lambda i, sf: _uniform(T, 4, i, 0, 50_000)),
        Column("cr_return_quantity", INTEGER,
               lambda i, sf: _uniform(T, 5, i, 1, 40).astype(np.int32)),
    ])


def _make_inventory() -> Table:
    """Weekly (item, warehouse) snapshots over the Q72 window: row index =
    ((week * n_warehouses) + wh) * n_items + item."""
    T = _T["inventory"]

    def date_sk(i, sf):
        week = i // (n_items(sf) * n_warehouses(sf))
        return ((INV_FIRST_WEEK + week) * 7 - D_BASE).astype(np.int64)

    def wh(i, sf):
        return ((i // n_items(sf)) % n_warehouses(sf)).astype(np.int64) + 1

    def item(i, sf):
        return (i % n_items(sf)).astype(np.int64) + 1

    return Table("inventory", T, lambda sf: n_inventory(sf), [
        Column("inv_date_sk", BIGINT, date_sk),
        Column("inv_item_sk", BIGINT, item),
        Column("inv_warehouse_sk", BIGINT, wh),
        Column("inv_quantity_on_hand", INTEGER,
               lambda i, sf: _uniform(T, 3, i, 0, 120).astype(np.int32)),
    ])


TPCDS_TABLES: Dict[str, Table] = {
    t.name: t for t in [
        _make_date_dim(), _make_item(), _make_store(), _make_warehouse(),
        _make_customer(), _make_customer_address(),
        _make_customer_demographics(), _make_household_demographics(),
        _make_income_band(), _make_promotion(), _make_store_sales(),
        _make_store_returns(), _make_catalog_sales(), _make_catalog_returns(),
        _make_inventory(),
    ]
}


def table_row_count(name: str, sf: float) -> int:
    return TPCDS_TABLES[name].row_count(sf)


def generate_rows(table: str, lo: int, hi: int, sf: float,
                  columns: Sequence[str]) -> Dict[str, np.ndarray]:
    t = TPCDS_TABLES[table]
    idx = np.arange(lo, hi, dtype=np.int64)
    return {c: t.column(c).gen(idx, sf) for c in columns}
