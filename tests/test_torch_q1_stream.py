"""The streaming and resident Q1 scans: the PyTorch port against the JAX
reference and the int64 numpy oracle of ``tests/test_kernels.py``.

The port runs on the CPU (``device="cpu"``), where its staging is one host
slot and the step runs in place; the finish dicts must be bit-identical to
the reference's (whose lane step is exact) and to the oracle, the padded
tail included. One reference ``q1_stream`` run and one oracle serve the
whole file.
"""
import threading

import numpy as np
import pytest
import torch

from presto_tpu.models.kernels import q1_resident as ref_q1_resident
from presto_tpu.models.kernels import q1_stream as ref_q1_stream
from presto_tpu_torch.connectors.tpch import generator as tg
from presto_tpu_torch.models import kernels as tk
from test_kernels import _oracle

SF = 0.01


@pytest.fixture(scope="module")
def reference():
    rows, _wall, _stall, _compile, fin = ref_q1_stream(
        SF, seconds_budget=600.0, batch_rows=1 << 16, gen_threads=2)
    oracle, n_rows = _oracle(SF)
    assert rows == n_rows
    return rows, fin, oracle


def _producers_alive():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("q1-stream-producer") and t.is_alive()]


def _assert_finish_equal(got, want):
    assert list(got) == list(tk.Q1_SUMS)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == np.int64 and g.shape == (6,), (key, g.dtype, g.shape)
        assert np.array_equal(np.asarray(w, dtype=np.int64), g), (key, w, g)


# 1 << 16: one padded batch; 10_000: six full batches and a tail of 32 rows;
# 1 << 14: three full batches and a tail of 11,880
@pytest.mark.parametrize("batch_rows", [1 << 16, 10_000, 1 << 14])
def test_q1_stream_matches_reference_and_oracle(reference, batch_rows):
    ref_rows, ref_fin, oracle = reference
    rows, wall, stall, first_s, fin = tk.q1_stream(
        SF, seconds_budget=600.0, batch_rows=batch_rows, gen_threads=2, device="cpu")
    assert rows == ref_rows
    _assert_finish_equal(fin, ref_fin)
    _assert_finish_equal(fin, oracle)
    assert wall >= first_s > 0 and stall >= 0
    assert not _producers_alive()


@pytest.mark.parametrize("stop", ["max_rows", "seconds_budget"])
def test_q1_stream_stops_and_joins_its_producers(stop):
    kw = {"max_rows": 1} if stop == "max_rows" else {"seconds_budget": 0.0}
    rows, *_ = tk.q1_stream(0.1, **{"seconds_budget": 600.0, **kw}, batch_rows=1 << 16,
                            gen_threads=2, device="cpu")
    n_total = tg.lineitem_row_count(0.1)
    assert n_total == 600_219
    if stop == "max_rows":
        assert 1 <= rows < n_total
    else:
        assert 0 <= rows < n_total
    assert not _producers_alive()


def test_q1_stream_producer_error_is_a_runtime_error(monkeypatch):
    def broken(*args, **kw):
        raise ValueError("generator failed")

    monkeypatch.setattr(tg, "lineitem_for_orders", broken)
    with pytest.raises(RuntimeError, match="producer failed") as info:
        tk.q1_stream(SF, batch_rows=1 << 14, gen_threads=2, device="cpu")
    assert isinstance(info.value.__cause__, ValueError)
    assert not _producers_alive()


def test_q1_resident_one_batch_matches_reference():
    ref_rps, ref_rows, _ms, ref_one = ref_q1_resident(1.0, batch_rows=1 << 16, runs=2)
    rps, batch_rows, step_ms, one = tk.q1_resident(1.0, batch_rows=1 << 16, runs=2,
                                                   device="cpu")
    assert batch_rows == ref_rows == 1 << 16
    assert rps > 0 and step_ms > 0
    _assert_finish_equal(one, ref_one)


def test_q1_stream_step_sends_padded_rows_to_the_dump_segment():
    """Random narrow rows from a seed, a quarter of them padded: the step's
    sums over two calls equal twice the int64 sums of the unpadded rows."""
    rng = np.random.default_rng(20261018)
    n = 4096
    cols = (rng.integers(90_000, 10_500_000, n, dtype=np.int32),   # ep
            rng.integers(100, 5_001, n, dtype=np.int16),            # qty
            rng.integers(8_035, 10_600, n, dtype=np.int16),         # sd
            rng.integers(0, 11, n, dtype=np.int8),                  # disc
            rng.integers(0, 9, n, dtype=np.int8),                   # tax
            rng.integers(0, 3, n, dtype=np.int8),                   # rf
            rng.integers(0, 2, n, dtype=np.int8))                   # ls
    pad = rng.random(n) < 0.25
    cols[2][pad] = 32767
    acc = torch.zeros((6, 6), dtype=torch.int64)
    for _ in range(2):
        tk.q1_stream_step(*(torch.from_numpy(c) for c in cols), acc)
    got = tk.q1_stream_finish(acc)
    ep, qty, sd, disc, tax, rf, ls = (c.astype(np.int64) for c in cols)
    keep = sd <= tk.Q1_CUTOFF_DAYS
    gid = (rf * 2 + ls)[keep]
    dp = ep * (100 - disc)
    want = {}
    for key, v in zip(tk.Q1_SUMS, (qty, ep, dp, dp * (100 + tax), disc, np.ones(n, np.int64))):
        out = np.zeros(6, dtype=np.int64)
        np.add.at(out, gid, v[keep])
        want[key] = 2 * out
    _assert_finish_equal(got, want)


@pytest.mark.parametrize("entry", ["q1_stream", "q1_resident"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tk, entry)(SF, batch_rows=1 << 14)
    assert not _producers_alive()
