"""The 22 TPC-DS queries through the port's SQL runner against presto_tpu's,
unfused (``segment_fusion`` and ``coalesce_pages`` off: the reference's
differential oracle), on the CPU.

Under ``pallas`` the rows, the (absent) segments and the ``pallas.``
counter deltas equal the reference's, for all 22 queries. Under ``sorted``
the rows equal and nothing is built on the table; ``sorted`` runs all 22
fused (``test_torch_tpcds.py``) and here only the queries of the union
path (Q27, Q36), the north-star pair (Q64, Q72) and Q3, a plain
star join. This file runs in its own worker under
``--dist loadfile``. The reference runs once per query.
"""
import pytest

from test_torch_tpcds import DS_QUERIES, check_query, reference_cache


@pytest.fixture(scope="module")
def reference():
    return reference_cache()


SORTED_QUERIES = (3, 27, 36, 64, 72)


@pytest.mark.parametrize("q,hash_kernels", [(q, "pallas") for q in DS_QUERIES]
                         + [(q, "sorted") for q in SORTED_QUERIES])
def test_unfused_rows_and_counters_match_reference(reference, q, hash_kernels):
    check_query(reference, q, "unfused", hash_kernels)
