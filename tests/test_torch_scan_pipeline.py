"""The port's staged scan pipeline and resident page cache, on the CPU.

The reference's ``tests/test_scan_pipeline.py`` cases against the port:
the re-batcher (held page for page against presto_tpu's), split order under
racing readers, byte-budget backpressure, error propagation, close while
blocked or before start, and the passthrough path (held against the serial
reader of a TPC-H source). Then the resident page cache: a second run
replays every scan with no upload, its rows equal a fresh scan's, and the
cached tensors stay bit-identical across two queries that share them.

Every test that starts stage threads drains the pipeline in a helper
thread joined with a timeout, so a deadlock fails the test instead of
hanging the run.
"""
import threading
import time

import numpy as np
import pytest
import torch

from presto_tpu.ops.scan_pipeline import HostChunk as RefHostChunk
from presto_tpu.ops.scan_pipeline import Rebatcher as RefRebatcher
from presto_tpu.types import BIGINT as REF_BIGINT
from presto_tpu_torch.block import Block, Page
from presto_tpu_torch.connectors.tpch.connector import TpchConnector
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.ops.scan import RESIDENT_CACHE
from presto_tpu_torch.ops.scan_pipeline import HostChunk, Rebatcher, ScanPipeline
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi.connector import Constraint, SchemaTableName
from presto_tpu_torch.types import BIGINT
from presto_tpu_torch.utils.batching import clamp_capacity

CPU = torch.device("cpu")
DEADLOCK_S = 30.0


def _drain(pipe, timeout_s: float = DEADLOCK_S):
    """Every page of ``pipe``, drained in a helper thread: fails (instead
    of hanging) when the pipeline does not end within ``timeout_s``."""
    out = {"pages": [], "error": None}

    def run():
        try:
            while True:
                p = pipe.next()
                if p is None:
                    return
                out["pages"].append(p)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), "the scan pipeline did not end: deadlock"
    if out["error"] is not None:
        raise out["error"]
    return out["pages"]


def _live(pages):
    return np.concatenate([p.blocks[0].data[p.mask].numpy() for p in pages]).tolist()


# ------------------------------------------------------------- re-batcher

def _chunks(pkg, specs):
    """The same chunks for the port (``pkg="port"``) or presto_tpu."""
    cls, t = (HostChunk, BIGINT) if pkg == "port" else (RefHostChunk, REF_BIGINT)
    return [cls.build([np.asarray(v, dtype=np.int64)],
                      [None if n is None else np.asarray(n, dtype=bool)], [t], [None])
            for v, n in specs]


def _pages_view(batches):
    """(data, mask, nulls, nbytes, rows) per batch; None stays None."""
    return [None if b is None else
            (np.asarray(b[0].blocks[0].data).tolist(), np.asarray(b[0].mask).tolist(),
             None if b[0].blocks[0].nulls is None
             else np.asarray(b[0].blocks[0].nulls).tolist(), b[1], b[2])
            for b in batches]


REBATCH_CASES = {
    "exact_pages_then_pow2_tail": (256, [(range(0, 200), None), (range(200, 400), None),
                                         (range(400, 612), None)]),
    "null_masks_cross_chunks": (4, [([1, 2], [True, False]), ([3, 4, 5], None)]),
    "no_nulls": (4, [([1, 2, 3, 4], None)]),
}


@pytest.mark.parametrize("case", sorted(REBATCH_CASES))
def test_rebatcher_matches_reference(case):
    target, specs = REBATCH_CASES[case]
    port, ref = Rebatcher(target), RefRebatcher(target)
    got, want = [], []
    for pc, rc in zip(_chunks("port", specs), _chunks("ref", specs)):
        got += port.add(pc)
        want += ref.add(rc)
    got.append(port.flush())
    want.append(ref.flush())
    assert _pages_view(got) == _pages_view(want)
    assert port.flush() is None


def test_rebatcher_exact_target_pages_then_pow2_tail():
    rb = Rebatcher(256)
    out = []
    for c in _chunks("port", REBATCH_CASES["exact_pages_then_pow2_tail"][1]):
        out += rb.add(c)
    assert [rows for _p, _b, rows in out] == [256, 256]
    assert all(p.capacity == 256 and bool(p.mask.all()) for p, _b, _r in out)
    assert _live([p for p, _b, _r in out]) == list(range(512))
    page, _b, rows = rb.flush()
    assert rows == 100 and page.capacity == clamp_capacity(100, 256) == 128
    assert bool(page.mask[:100].all()) and not bool(page.mask[100:].any())


def test_rebatcher_null_masks_cross_chunks():
    rb = Rebatcher(4)
    a, b = _chunks("port", REBATCH_CASES["null_masks_cross_chunks"][1])
    assert rb.add(a) == []
    (page, _b, rows), = rb.add(b)  # the second chunk declares no nulls
    assert rows == 4 and page.blocks[0].nulls.tolist() == [True, False, False, False]
    tail, _b, tail_rows = rb.flush()
    assert tail_rows == 1 and not bool(tail.blocks[0].nulls.any())


# ------------------------------------------------ pipeline: fake sources

class _ChunkSource:
    """A source with split readers only: ``specs`` holds each reader's
    chunks; a per-reader delay makes readers finish out of order."""

    def __init__(self, specs, delays=None, fail_reader=None):
        self._specs = specs
        self._delays = delays or [0.0] * len(specs)
        self._fail = fail_reader

    def __iter__(self):
        raise AssertionError("the pipeline should use split_readers")

    def close(self):
        pass

    def split_readers(self, target_rows):
        def reader(i):
            def read():
                if self._delays[i]:
                    time.sleep(self._delays[i])
                if self._fail == i:
                    raise RuntimeError(f"reader {i} exploded")
                yield from self._specs[i]
            return read
        return [reader(i) for i in range(len(self._specs))]


def _ranges(*bounds):
    return [_chunks("port", [(range(lo, hi), None)]) for lo, hi in bounds]


POOL_KEYS = [None, "test-scan-pipeline"]


@pytest.mark.parametrize("pool_key", POOL_KEYS, ids=["threads", "pool"])
def test_pipeline_preserves_split_order_under_racing_readers(pool_key):
    src = _ChunkSource(_ranges((0, 6), (6, 10)), delays=[0.2, 0.0])
    pipe = ScanPipeline(src, CPU, reader_threads=2, target_rows=4,
                        prefetch_bytes=1 << 20, pool_key=pool_key)
    pages = _drain(pipe)
    assert _live(pages) == list(range(10))
    pipe.close()
    st = pipe.stats()
    assert st["rows"] == 10 and st["pages"] == len(pages) and st["chunks"] == 2


@pytest.mark.parametrize("pool_key", POOL_KEYS, ids=["threads", "pool"])
def test_pipeline_byte_budget_backpressure_still_correct(pool_key):
    src = _ChunkSource(_ranges(*[(i * 5, i * 5 + 5) for i in range(8)]))
    pipe = ScanPipeline(src, CPU, reader_threads=4, target_rows=8, prefetch_bytes=64,
                        pool_key=pool_key)
    pages = _drain(pipe)
    assert _live(pages) == list(range(40))
    assert [p.capacity for p in pages] == [8] * 5
    pipe.close()


def test_pipeline_reader_error_propagates_to_consumer():
    pipe = ScanPipeline(_ChunkSource(_ranges((0, 4), (4, 8)), fail_reader=1), CPU,
                        reader_threads=2, target_rows=4, prefetch_bytes=1 << 20)
    with pytest.raises(RuntimeError, match="reader 1 exploded"):
        _drain(pipe)
    with pytest.raises(RuntimeError, match="reader 1 exploded"):
        pipe.next()  # sticky: later calls raise instead of waiting
    pipe.close()


def test_pipeline_close_while_blocked_joins_threads():
    src = _ChunkSource(_ranges(*[(i * 8, i * 8 + 8) for i in range(6)]))
    pipe = ScanPipeline(src, CPU, reader_threads=3, target_rows=8, prefetch_bytes=64)
    assert pipe.next() is not None
    threads = list(pipe._threads)
    assert threads
    pipe.close()
    assert pipe._threads == [] and not any(t.is_alive() for t in threads)


def test_pipeline_close_before_start_is_safe():
    pipe = ScanPipeline(_ChunkSource(_ranges((0, 1))), CPU, target_rows=4)
    pipe.close()
    assert pipe.stats()["pages"] == 0


class _PageSource:
    """A plain iterable source (no split readers): the passthrough path."""

    def __init__(self, pages, fail_after=None):
        self._pages = pages
        self._fail_after = fail_after

    def __iter__(self):
        for i, p in enumerate(self._pages):
            if self._fail_after is not None and i == self._fail_after:
                raise ValueError("source died mid-stream")
            yield p

    def close(self):
        pass


def _page(vals):
    data = torch.tensor(vals, dtype=torch.int64)
    return Page((Block(BIGINT, data),), torch.ones(len(vals), dtype=torch.bool))


def test_pipeline_passthrough_preserves_pages():
    pipe = ScanPipeline(_PageSource([_page([1, 2, 3]), _page([4, 5])]), CPU,
                        reader_threads=4, target_rows=4)
    out = _drain(pipe)
    assert [p.blocks[0].data.tolist() for p in out] == [[1, 2, 3], [4, 5]]
    pipe.close()


def test_pipeline_passthrough_error_propagates():
    pipe = ScanPipeline(_PageSource([_page([1])] * 4, fail_after=2), CPU)
    with pytest.raises(ValueError, match="died mid-stream"):
        _drain(pipe)
    pipe.close()


@pytest.mark.parametrize("table", ["lineitem", "orders"])
def test_passthrough_equals_the_serial_reader_on_tpch(table):
    """A TPC-H source has no split readers: the staged scan streams the
    connector's own pages, equal page for page to iterating the source."""
    conn = TpchConnector("tpch")
    handle = conn.metadata().get_table_handle(SchemaTableName("tiny", table))
    cols = list(conn.metadata().get_column_handles(handle).values())[:4]
    splits = conn.split_manager().get_splits(handle, Constraint.all(), 8)
    make = conn.page_source_provider().create_page_source
    for split in splits[:3]:
        src = make(split, cols, 1 << 12)
        assert src.split_readers(1 << 12) is None and src.cache_token is not None
        pipe = ScanPipeline(src, CPU, target_rows=1 << 12, pool_key="test-tpch")
        staged = _drain(pipe)
        pipe.close()
        serial = list(make(split, cols, 1 << 12))
        assert len(staged) == len(serial)
        for a, b in zip(staged, serial):
            assert torch.equal(a.mask, b.mask)
            for x, y in zip(a.blocks, b.blocks):
                assert x.data.dtype == y.data.dtype and torch.equal(x.data, y.data)


# ------------------------------------------------------- resident page cache

Q6_LIKE = ("select sum(l_extendedprice * l_discount) as revenue from lineitem "
           "where l_shipdate >= date '{lo}' and l_shipdate < date '{hi}' "
           "and l_discount between 0.05 and 0.07 and l_quantity < 24")


def _run(sql, **props):
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props),
                            device="cpu").execute(sql)


def _snapshot():
    return {tok: [[(b.data.clone(), None if b.nulls is None else b.nulls.clone())
                   for b in p.blocks] + [(p.mask.clone(), None)] for p in pages]
            for tok, pages in RESIDENT_CACHE._pages.items()}


def _same_as(snap) -> bool:
    for tok, pages in snap.items():
        live = RESIDENT_CACHE._pages[tok]
        for want, page in zip(pages, live):
            got = [(b.data, b.nulls) for b in page.blocks] + [(page.mask, None)]
            for (wd, wn), (gd, gn) in zip(want, got):
                if wd.dtype != gd.dtype or not torch.equal(wd, gd):
                    return False
                if (wn is None) != (gn is None) or (wn is not None and not torch.equal(wn, gn)):
                    return False
    return True


@pytest.mark.parametrize("props", [{}, {"driver_parallelism": 4}], ids=["defaults", "drivers4"])
def test_resident_cache_replays_without_upload_and_keeps_tensors(props):
    RESIDENT_CACHE.clear()
    q6 = Q6_LIKE.format(lo="1994-01-01", hi="1995-01-01")
    cold = _run(q6, **props)
    assert cold.resident_pages == 0 and cold.stats["scan_pipeline"]["pages"] > 0
    snap = _snapshot()
    assert snap
    warm = _run(q6, **props)
    # every scan replayed resident pages: nothing staged, nothing uploaded
    assert warm.stats is None or "scan_pipeline" not in warm.stats
    assert warm.resident_pages == cold.stats["scan_pipeline"]["pages"]
    assert warm.rows == cold.rows
    # a second query over the same columns of the same table shares them
    other = _run(Q6_LIKE.format(lo="1995-01-01", hi="1996-01-01"), **props)
    assert other.resident_pages == warm.resident_pages
    assert _same_as(snap)  # neither replay wrote to the cached tensors
    RESIDENT_CACHE.clear()
    fresh = _run(Q6_LIKE.format(lo="1995-01-01", hi="1996-01-01"), **props)
    assert fresh.rows == other.rows and fresh.resident_pages == 0


def test_resident_tensors_bit_identical_after_two_queries():
    """Q3 twice on the default path, then unfused on the sorted kernels
    (the same scans, so the same cached pages): every cached tensor is
    bit-identical to its state after the first run."""
    from presto_tpu_torch.models.tpch_sql import QUERIES

    RESIDENT_CACHE.clear()
    first = _run(QUERIES[3], hash_kernels="pallas")
    snap = _snapshot()
    second = _run(QUERIES[3], hash_kernels="pallas")
    _run(QUERIES[3], hash_kernels="sorted", segment_fusion=False, coalesce_pages=False)
    assert second.rows == first.rows and second.resident_pages > 0
    assert _same_as(snap)
