"""The port's page coalescing and compaction against presto_tpu's, on the CPU.

The same numpy pages, from seeds, through both packages: ``_compact`` (live
rows first, in input order, a prefix mask), ``_pack`` and the page stream of
``CoalesceOperator`` in pass-through mode, in pack mode, across a change of
capacity mid-stream, with nullable columns and with the tail flush. Every
column, null mask and row mask is compared at every row, dead rows
included: both packages fill dead slots with zeros.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import block as jblock
from presto_tpu import types as jt
from presto_tpu.ops import coalesce as jco
from presto_tpu_torch import block as tblock
from presto_tpu_torch import types as tt
from presto_tpu_torch.ops import coalesce as tco
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_join_expand import _assert_pages_equal, _pages

JTYPES = [jt.BIGINT, jt.INTEGER, jt.DOUBLE]
TTYPES = [tt.BIGINT, tt.INTEGER, tt.DOUBLE]


def _page(rng, cap: int, live: float, nulls: bool = True):
    """One page of three columns (the second nullable when ``nulls``) in
    both packages."""
    cols = [rng.randint(-10 ** 9, 10 ** 9, cap).astype(np.int64),
            rng.randint(-100, 100, cap).astype(np.int32), rng.rand(cap)]
    col_nulls = [None, (rng.rand(cap) < 0.2) if nulls else None, None]
    return _pages(JTYPES, TTYPES, cols, rng.rand(cap) < live, col_nulls)


@pytest.mark.parametrize("live", [0.0, 0.3, 1.0])
def test_compact_matches_reference(live):
    jp, tp = _page(np.random.RandomState(int(live * 10)), 64, live)
    want, got = jblock._compact(jp), tblock._compact(tp)
    _assert_pages_equal(want, got)
    n = int(tp.mask.sum())
    assert got.mask.tolist() == [i < n for i in range(64)]
    for b, src in zip(got.blocks, tp.blocks):  # live rows first, in input order
        assert torch.equal(b.data[:n], src.data[tp.mask])


@pytest.mark.parametrize("count,live", [(0, 0.5), (10, 0.3), (40, 0.6), (63, 1.0)],
                         ids=["empty_acc", "no_emit", "emit", "emit_full"])
def test_pack_matches_reference(count, live):
    rng = np.random.RandomState(count)
    ja, ta = _page(rng, 64, 1.0)
    mask = np.arange(64) < count  # the accumulator: a prefix of count live rows
    ja, ta = ja.with_mask(jnp.asarray(mask)), ta.with_mask(torch.from_numpy(mask))
    ja, ta = jblock._compact(ja), tblock._compact(ta)
    jp, tp = _page(rng, 64, live)
    jp, tp = jblock._compact(jp), tblock._compact(tp)
    want = jco._pack(ja, np.int32(count), jp)
    got = tco._pack(ta, count, tp)
    _assert_pages_equal(want[0], got[0])
    _assert_pages_equal(want[2], got[2])
    assert bool(got[1]) == bool(want[1]) == (count + int(tp.mask.sum()) >= 64)
    assert int(got[3]) == int(want[3])


def _stream(pkg, pages, types):
    """Every page the operator emits for ``pages``, then its tail."""
    op = pkg.CoalesceOperatorFactory(0, types).create_operator()
    outs = []
    for p in pages:
        assert op.needs_input()
        op.add_input(p)
        while (out := op.get_output()) is not None:
            outs.append(out)
    op.finish()
    while (out := op.get_output()) is not None:
        outs.append(out)
    assert op.is_finished()
    return outs, op._mode


STREAMS = {
    # the first page is more than half live: every page passes through
    "pass_through": [(64, 0.9), (64, 0.1), (64, 0.4)],
    # sparse pages pack into full ones and a tail
    "pack": [(64, 0.3), (64, 0.5), (64, 0.25), (64, 0.6), (64, 0.4), (64, 0.05)],
    # no page fills the accumulator: the tail alone
    "tail_only": [(64, 0.1), (64, 0.05)],
    # a capacity change mid-stream flushes the accumulator as its own page
    "capacity_change": [(64, 0.3), (64, 0.2), (32, 0.5), (32, 0.7), (32, 0.2)],
    "no_nulls": [(64, 0.4), (64, 0.4), (64, 0.4)],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_coalesce_stream_matches_reference(name):
    rng = np.random.RandomState(len(name))
    pairs = [_page(rng, cap, live, nulls=name != "no_nulls") for cap, live in STREAMS[name]]
    want, jmode = _stream(jco, [j for j, _ in pairs], JTYPES)
    before = {k: METRICS.counter_value(k) for k in ("coalesce.pages_in", "coalesce.pages_out")}
    got, tmode = _stream(tco, [t for _, t in pairs], TTYPES)
    assert tmode == jmode == ("pass" if name == "pass_through" else "pack")
    assert len(got) == len(want)
    for jp, tp in zip(want, got):
        _assert_pages_equal(jp, tp)
    live = sum(int(t.mask.sum()) for _, t in pairs)
    assert sum(int(p.mask.sum()) for p in got) == live
    assert METRICS.counter_value("coalesce.pages_in") - before["coalesce.pages_in"] == len(pairs)
    assert METRICS.counter_value("coalesce.pages_out") - before["coalesce.pages_out"] == len(got)
    if name == "pack":
        assert len(got) < len(pairs)


def test_dictionary_remap_factory_defaults_to_cuda(monkeypatch):
    """Like every entry point of the port, the remap factory's device
    defaults to CUDA and raises where there is none: never a quiet CPU."""
    from presto_tpu_torch.ops.coalesce import DictionaryRemapOperatorFactory
    from presto_tpu_torch.types import VARCHAR

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    remap = np.arange(3, dtype=np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DictionaryRemapOperatorFactory(0, [VARCHAR], [remap])
    fac = DictionaryRemapOperatorFactory(0, [VARCHAR], [remap], device="cpu")
    assert fac.remaps[0].device.type == "cpu"
