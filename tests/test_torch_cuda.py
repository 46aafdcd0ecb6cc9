"""Card-only tests of the port's CUDA kernels (skipped without a GPU).

Run on a machine with an NVIDIA GPU (where JAX need not be installed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held bit-identical to its plain PyTorch version on the same
CUDA tensors, and each wrapper counts exactly its own launches.
"""
import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import pallas_hash as ph
from presto_tpu_torch.ops.aggregates import AggregateCall, resolve_aggregate
from presto_tpu_torch.ops.hash_agg import SINGLE, HashAggregationOperatorFactory
from presto_tpu_torch.types import BIGINT

pytestmark = pytest.mark.cuda


EDGE_CASES = ("all_masked", "one_row", "ragged", "tail_crossing", "one_trip")


def insert_edge_case(name: str):
    """``(comps (ncomps, n) int64, mask (n,) bool, slots, trips)`` as numpy,
    for one edge of the insert's worklist."""
    rng = np.random.RandomState(23)
    trips = ph.INSERT_TRIPS
    if name == "all_masked":
        n = 300
        comps = (rng.permutation(8 * n)[:n].astype(np.int64) * 5)[None]
        mask = np.zeros(n, dtype=bool)
    elif name == "one_row":
        comps, mask = np.array([[42]], dtype=np.int64), np.ones(1, dtype=bool)
    elif name == "ragged":  # n not a multiple of the kernels' 256-thread blocks
        n = 1000
        comps = rng.randint(-50, 50, size=(2, n)).astype(np.int64)
        mask = rng.rand(n) < 0.8
    elif name == "tail_crossing":
        # 40 keys share one home slot, 60 rows each, beside 600 other keys:
        # one key places per round, so the worklist stays above 1,024 rows
        # for 24 rounds, then falls below it and empties after round 40
        n_same, copies, n_other = 40, 60, 600
        slots = ph.table_slots(n_same * copies + n_other)
        cands = np.arange(1, 1 << 21, dtype=np.int64) * 7
        home = ph._hash_base(torch.from_numpy(cands)[None], slots).numpy()
        keys = np.concatenate([np.repeat(cands[home == home[0]][:n_same], copies),
                               cands[home != home[0]][:n_other]])
        comps = rng.permutation(keys)[None]
        mask = np.ones(keys.shape[0], dtype=bool)
    elif name == "one_trip":
        n = 700
        comps = rng.randint(0, 300, size=(1, n)).astype(np.int64)
        mask = np.ones(n, dtype=bool)
        trips = 1
    else:
        raise AssertionError(name)
    return comps, mask, ph.table_slots(comps.shape[1]), trips


def grouping_case(n: int, groups: int, ncomps: int, live: float, seed: int = 31):
    """The aggregation's use of the insert (``GroupedAggregationBuilder.
    _page_hash_partial``): ``(comps (ncomps, n) int64, mask (n,) bool, slots)``
    as numpy, for a page whose live rows carry ``groups`` distinct keys, many
    copies of each. Three components are Q3's (orderkey, orderdate,
    shippriority); six add the builder's null flag after each. ``slots`` is
    the table the builder sizes for that group count."""
    rng = np.random.RandomState(seed)
    okey = rng.permutation(1 << 22)[:groups].astype(np.int64) * 4 + 1
    cols = [okey, 8000 + okey % 2000, np.zeros(groups, np.int64)]
    if ncomps == 6:
        cols = [x for c in cols for x in (c, np.zeros(groups, np.int64))]
    elif ncomps != 3:
        raise AssertionError(ncomps)
    comps = np.stack(cols)[:, rng.randint(0, groups, n)]
    mask = rng.rand(n) < live
    slots = max(1 << 10, 1 << max(4, (4 * groups - 1).bit_length()))
    return np.ascontiguousarray(comps), mask, slots


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("ncomps,dup", [(1, False), (2, True), (3, True)])
def test_insert_kernel_matches_plain_version(cuda, ncomps, dup):
    rng = np.random.RandomState(ncomps)
    n = 1 << 14
    if dup:
        comps = rng.randint(0, 40, size=(ncomps, n)).astype(np.int64)
    else:
        comps = (rng.permutation(8 * n)[:n].astype(np.int64) * 7 - 3)[None]
    comps = torch.from_numpy(comps).to(cuda)
    mask = torch.from_numpy(rng.rand(n) < 0.8).to(cuda)
    slots = ph.table_slots(n)
    before = ph.insert_table.launches
    got = ph.insert_table(comps, mask, slots)
    assert ph.insert_table.launches == before + 1
    want = ph.insert_table_reference(comps, mask, slots)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_insert_kernel_overflow_and_full_table(cuda):
    comps = (torch.arange(32, dtype=torch.int64, device=cuda) * 1009).unsqueeze(0)
    mask = torch.ones(32, dtype=torch.bool, device=cuda)
    got = ph.insert_table(comps.contiguous(), mask, 16, trips=4)
    want = ph.insert_table_reference(comps, mask, 16, trips=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3][0].item() == 1


def test_probe_kernel_matches_plain_version(cuda):
    rng = np.random.RandomState(9)
    n = 1 << 14
    keys = torch.from_numpy(rng.permutation(8 * n)[:n].astype(np.int64)).to(cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    slots = ph.table_slots(n)
    slot_comps, slot_rows, _gid, stats = ph.insert_table(keys.unsqueeze(0).contiguous(),
                                                         mask, slots)
    trips = ph.probe_trips_for(int(stats[1]))
    probe = torch.from_numpy(rng.randint(0, 16 * n, 2 * n).astype(np.int64)).to(cuda)
    pmask = torch.from_numpy(rng.rand(2 * n) < 0.9).to(cuda)
    before = ph.probe_table.launches
    got = ph.probe_table(slot_comps[0], slot_rows, probe, pmask, trips)
    assert ph.probe_table.launches == before + 1
    want = ph.probe_table_reference(slot_comps[0], slot_rows, probe, pmask, trips)
    assert torch.equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


@pytest.mark.parametrize("case", EDGE_CASES)
def test_insert_kernel_worklist_edges(cuda, case):
    comps, mask, slots, trips = insert_edge_case(case)
    comps = torch.from_numpy(comps).to(cuda)
    mask = torch.from_numpy(mask).to(cuda)
    got = ph.insert_table(comps, mask, slots, trips)
    want = ph.insert_table_reference(comps, mask, slots, trips)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_insert_kernel_stops_at_empty_worklist(cuda):
    """The rounds end when the worklist empties, before ``trips``: nothing
    is left pending, and the kernel's per-round counts are the ones its
    outputs imply (across the grid-to-one-block hand-over at 1,024 rows)."""
    comps, mask, slots, trips = insert_edge_case("tail_crossing")
    comps = torch.from_numpy(comps).to(cuda)
    mask = torch.from_numpy(mask).to(cuda)
    _sc, _sr, gid, stats, counts = ph._insert_cuda(comps, mask, slots, trips)
    counts = counts.tolist()
    tail = ph.insert_kernel_config(cuda)["tail_rows"]
    assert counts[0] == int(mask.sum()) > tail
    assert any(0 < c <= tail for c in counts)
    stop = counts.index(0)
    assert 0 < stop < trips and not any(counts[stop:])
    assert stats[0].item() == 0 and bool((gid[mask] >= 0).all())
    assert counts == ph.insert_round_profile(comps, mask, gid, slots, trips)


def test_insert_kernel_config(cuda):
    cfg = ph.insert_kernel_config(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert cfg["grid_blocks"] % props.multi_processor_count == 0
    assert cfg["grid_blocks"] >= props.multi_processor_count
    assert cfg["block_threads"] == 256 and cfg["tail_rows"] == 1024


def test_aggregation_of_empty_input_stays_on_the_card(cuda):
    calls = [AggregateCall(resolve_aggregate("sum", [BIGINT]), [1])]
    op = HashAggregationOperatorFactory(0, [0], [BIGINT], [None], calls, SINGLE, 64,
                                        device=cuda).create_operator()
    op.finish()
    page = op.get_output()
    assert page is not None and page.mask.device == cuda
    assert all(b.data.device == cuda for b in page.blocks)
    assert not bool(page.mask.any())


@pytest.mark.parametrize("ncomps", [3, 6])
def test_insert_kernel_matches_plain_version_at_q3_sf1_grouping_shape(cuda, ncomps):
    """A 2^20-row page with ~1,500 groups among its live rows into 8,192
    slots: Q3's grouping at SF1."""
    comps, mask, slots = grouping_case(1 << 20, 1500, ncomps, live=0.02)
    assert slots == 8192
    comps, mask = torch.from_numpy(comps).to(cuda), torch.from_numpy(mask).to(cuda)
    before = ph.insert_table.launches
    got = ph.insert_table(comps, mask, slots)
    assert ph.insert_table.launches == before + 1
    want = ph.insert_table_reference(comps, mask, slots)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3][0].item() == 0 and 1400 < got[3][2].item() <= 1500
