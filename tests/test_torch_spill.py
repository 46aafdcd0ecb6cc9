"""The grouped aggregation's host-RAM spill: the port against presto_tpu.

A fold that finds more live groups than ``max_groups`` moves its inputs to
host RAM and ``finish`` merges them exactly on the host. At ``tiny``, Q13
(1,128 groups in its inner grouping) spills at ``max_groups`` 1,024 and
Q18 (7,500) at 1,024 and 4,096; the rows must equal the reference's under
the same ``max_groups``, fused and unfused, ``sorted`` and ``pallas``. The
merge itself (``_host_merge_parts``) is held against the reference's on
numpy parts made from a seed, bit for bit.
"""
import numpy as np
import pytest

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.ops import aggregates as ref_agg
from presto_tpu.ops.hash_agg import GroupedAggregationBuilder as RefBuilder
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.types import BIGINT as REF_BIGINT
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.ops import aggregates as agg
from presto_tpu_torch.ops.hash_agg import GroupedAggregationBuilder
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.types import BIGINT
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows

# the inner grouping's group count at tiny: Q13 1,128, Q18 7,500
SPILLS = {(13, 1024): True, (13, 4096): False, (18, 1024): True, (18, 4096): True}


@pytest.fixture(scope="module")
def ref_rows():
    """The reference's rows per (query, max_groups), made once per module."""
    cache = {}

    def get(q: int, max_groups: int):
        if (q, max_groups) not in cache:
            session = RefSession(catalog="tpch", schema="tiny",
                                 properties={"max_groups": max_groups})
            cache[q, max_groups] = RefRunner(session).execute(REF_QUERIES[q]).rows
        return cache[q, max_groups]
    return get


@pytest.mark.parametrize("hash_kernels", ["sorted", "pallas"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("q,max_groups", sorted(SPILLS))
def test_spilled_grouping_matches_reference(ref_rows, q, max_groups, fused, hash_kernels):
    props = {"max_groups": max_groups, "hash_kernels": hash_kernels,
             "segment_fusion": fused, "coalesce_pages": fused}
    before = METRICS.counter_value("agg.spilled_folds")
    got = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props),
                           device="cpu").execute(QUERIES[q]).rows
    spilled = METRICS.counter_value("agg.spilled_folds") - before
    assert got
    assert_same_rows(got, ref_rows(q, max_groups))
    assert (spilled > 0) == SPILLS[q, max_groups], spilled


def _parts(seed: int, n_parts: int = 5, rows: int = 300):
    """Spilled (keys, states, valid) numpy parts: two key columns (each
    with its null flag), SUM/MIN/MAX states, some invalid rows."""
    rng = np.random.RandomState(seed)
    parts = []
    for _ in range(n_parts):
        k1 = rng.randint(0, 20, rows).astype(np.int64)
        f1 = rng.rand(rows) < 0.1
        k2 = rng.randint(-3, 3, rows).astype(np.int64)
        f2 = np.zeros(rows, dtype=bool)
        states = (rng.randint(-1000, 1000, rows).astype(np.int64),
                  rng.randn(rows), rng.randint(-50, 50, rows).astype(np.int64))
        parts.append(((np.where(f1, 0, k1), f1, k2, f2), states, rng.rand(rows) < 0.8))
    return parts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_merge_parts_matches_reference(seed):
    port = GroupedAggregationBuilder([BIGINT, BIGINT],
                                     [agg.AggregateCall(agg.resolve_aggregate("sum", [BIGINT]),
                                                        [2])], device="cpu")
    ref = RefBuilder([REF_BIGINT, REF_BIGINT], [None, None],
                     [ref_agg.AggregateCall(ref_agg.resolve_aggregate("sum", [REF_BIGINT]),
                                            [2])], 1024)
    # the merge reads only the key signature and the reduce kinds: SUM, MIN
    # and MAX cover every kind the port's builders reduce with
    port.kinds = (agg.SUM, agg.MIN, agg.MAX)
    ref.kinds = (ref_agg.SUM, ref_agg.MIN, ref_agg.MAX)
    parts = _parts(seed)
    got_keys, got_states = port._host_merge_parts(parts)
    want_keys, want_states = ref._host_merge_parts(parts)
    assert len(got_keys) == 4 and len(got_states) == 3
    for g, w in zip(got_keys + got_states, want_keys + want_states):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # one row per distinct valid key tuple
    valid = np.concatenate([p[2] for p in parts])
    keys = np.stack([np.concatenate([p[0][i] for p in parts])[valid] for i in range(4)], 1)
    assert len(got_keys[0]) == len({tuple(r) for r in keys.tolist()})
