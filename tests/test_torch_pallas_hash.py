"""The port's open-addressing insert and probe against the JAX reference.

The reference kernels (presto_tpu/ops/pallas_hash.py) run as
tests/test_pallas_hash.py runs them on the CPU: Pallas in interpret mode.
The port's wrappers run their plain PyTorch versions on CPU tensors. Every
comparison is exact (bit-identical integer outputs): slot keys, slot rows,
group ids, stats and probe rows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.ops import pallas_hash as jph
from presto_tpu.ops.hash_join import _mix64 as jax_mix64
from presto_tpu_torch import interop
from presto_tpu_torch.ops import pallas_hash as tph
from presto_tpu_torch.ops.hash_join import (INNER, LookupJoinOperatorFactory,
                                            LookupSourceFactory, _mix64)
from presto_tpu_torch.types import BIGINT, DATE
from test_torch_cuda import EDGE_CASES, insert_edge_case

I64 = np.iinfo(np.int64)


def _keys(case: str, rng: np.random.RandomState, n: int) -> np.ndarray:
    """(ncomps, n) int64 build keys for one named distribution."""
    if case in ("unique", "masked"):
        return (rng.permutation(10 * n)[:n].astype(np.int64) * 13 - 999)[None]
    if case == "duplicates":
        return rng.randint(0, n // 8, size=(1, n)).astype(np.int64)
    if case == "ncomps3":
        return rng.randint(-3, 4, size=(3, n)).astype(np.int64)
    if case == "clustered":
        # a quarter of the keys hash into 1/16 of the table: long occupied
        # runs, rows pushed far from home, and some overflow
        slots = jph.table_slots(n)
        cands = rng.permutation(10 ** 7)[:40 * n].astype(np.int64)
        home = np.asarray(jph._hash_base([jnp.asarray(cands)], slots))
        near = cands[home < slots // 16][:n // 4]
        rest = np.setdiff1d(cands, near)[:n - len(near)]
        return rng.permutation(np.concatenate([near, rest]))[None]
    if case == "extremes":
        vals = np.array([0, -1, I64.min, I64.max, 1, I64.min + 1, I64.max - 1],
                        np.int64)
        return rng.choice(vals, size=(2, n)).astype(np.int64)
    raise AssertionError(case)


def _mask(case: str, rng: np.random.RandomState, n: int) -> np.ndarray:
    if case in ("masked", "ncomps3"):
        return rng.rand(n) < 0.7
    return np.ones(n, dtype=bool)


def _jax_insert(comps: np.ndarray, mask: np.ndarray, slots: int, trips: int = 0):
    ncomps, n = comps.shape
    out = jph.insert_table_jit(ncomps, n, slots, trips)(
        tuple(jnp.asarray(c) for c in comps), jnp.asarray(mask))
    # np.array copies: the port wraps them in (writable) tensors
    return tuple(np.array(x) for x in (jnp.stack(out[0]), *out[1:]))


def _port_insert(comps: np.ndarray, mask: np.ndarray, slots: int, trips: int = 0):
    out = tph.insert_table(torch.from_numpy(comps), torch.from_numpy(mask), slots, trips)
    return tuple(t.numpy() for t in out)


def _assert_same(a, b):
    for x, y, name in zip(a, b, ("slot_comps", "slot_rows", "gid", "stats")):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_mix64_bit_identical_on_edge_and_random_values():
    rng = np.random.RandomState(0)
    v = np.concatenate([
        np.array([0, -1, I64.min, I64.max, 1, -2, I64.min + 1, I64.max - 1], np.int64),
        rng.randint(I64.min, I64.max, 4096, dtype=np.int64)])
    want = np.asarray(jax_mix64(jnp.asarray(v))).view(np.int64)
    got = _mix64(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["unique", "duplicates", "ncomps3", "masked",
                                  "clustered", "extremes"])
def test_insert_bit_identical(case):
    rng = np.random.RandomState(7)
    n = 2048
    comps, mask = _keys(case, rng, n), _mask(case, rng, n)
    slots = jph.table_slots(n)
    want = _jax_insert(comps, mask, slots)
    got = _port_insert(comps, mask, slots)
    _assert_same(got, want)
    assert got[3][0] == (case == "clustered")  # only the clustered set overflows
    assert got[3][1] >= (64 if case == "clustered" else 1)


@pytest.mark.parametrize("n,slots,trips", [
    (32, 16, 4),     # more keys than slots: overflow, and a full table (run 2S)
    (512, 1024, 2),  # two rounds: clustered rows cannot place
])
def test_insert_forced_overflow_bit_identical(n, slots, trips):
    rng = np.random.RandomState(3)
    comps = (np.arange(n, dtype=np.int64) * 1009 + rng.randint(0, 3, n))[None]
    if trips == 2:
        comps = (np.arange(n, dtype=np.int64) * slots // 4)[None]
    mask = np.ones(n, dtype=bool)
    want = _jax_insert(comps, mask, slots, trips)
    got = _port_insert(comps, mask, slots, trips)
    _assert_same(got, want)
    assert got[3][0] == 1


@pytest.mark.parametrize("case", EDGE_CASES)
def test_insert_worklist_edges_bit_identical(case):
    """Edges of the plain version's worklist, held against the JAX insert."""
    comps, mask, slots, trips = insert_edge_case(case)
    want = _jax_insert(comps, mask, slots, trips)
    got = _port_insert(comps, mask, slots, trips)
    _assert_same(got, want)
    counts = tph.insert_round_profile(torch.from_numpy(comps), torch.from_numpy(mask),
                                      torch.from_numpy(got[2]), slots, trips)
    assert counts[0] == mask.sum()
    overflow, _run, distinct = got[3]
    if case == "all_masked":
        assert (got[3] == 0).all() and (got[2] == -1).all() and not any(counts)
    elif case == "one_row":
        assert list(got[3]) == [0, 1, 1] and got[1][got[2][0]] == 0
    elif case == "ragged":
        assert comps.shape[1] % 256 and overflow == 0 and (got[2][mask] >= 0).all()
    elif case == "tail_crossing":
        above = [d for d, c in enumerate(counts) if c > 1024]
        assert len(above) >= 5 and overflow == 0 and distinct == 640
        stop = counts.index(0)
        assert any(0 < c <= 1024 for c in counts[above[-1]:stop]) and stop < trips
    elif case == "one_trip":
        assert trips == 1 and overflow == 1 and counts[1] > 0


def _probe_inputs(rng, build_keys, n_probe):
    """Probe keys mixing hits, misses and masked-off rows."""
    hits = rng.choice(build_keys, n_probe // 2)
    misses = rng.randint(10 ** 12, 10 ** 12 + 10 ** 6, n_probe - n_probe // 2)
    keys = rng.permutation(np.concatenate([hits, misses]).astype(np.int64))
    mask = rng.rand(n_probe) < 0.85
    return keys, mask


@pytest.mark.parametrize("case", ["unique", "clustered"])
def test_probe_bit_identical(case):
    rng = np.random.RandomState(11)
    n = 2048
    comps = _keys(case, rng, n)
    mask = np.ones(n, dtype=bool)
    slots = jph.table_slots(n)
    slot_comps, slot_rows, _gid, stats = _jax_insert(comps, mask, slots)
    trips = jph.probe_trips_for(int(stats[1]))
    keys, pmask = _probe_inputs(rng, comps[0], 4096)
    want = np.asarray(jph.probe_table(jnp.asarray(slot_comps[0]), jnp.asarray(slot_rows),
                                      jnp.asarray(keys), jnp.asarray(pmask), trips))
    got = tph.probe_table(torch.from_numpy(slot_comps[0]), torch.from_numpy(slot_rows),
                          torch.from_numpy(keys), torch.from_numpy(pmask), trips).numpy()
    np.testing.assert_array_equal(got, want)
    hit = got >= 0
    assert hit.any() and (~hit & pmask).any() and (got[~pmask] == -1).all()
    np.testing.assert_array_equal(comps[0][got[hit]], keys[hit])


def test_probe_of_a_jax_built_table_through_interop():
    """One table, built by the JAX insert, probed by the port's LookupJoin
    operator (interop.lookup_source_from_table) and by the JAX probe."""
    rng = np.random.RandomState(5)
    n = 1024
    keys = (rng.permutation(8 * n)[:n].astype(np.int64) * 3 + 1)
    dates = rng.randint(8000, 10000, n).astype(np.int32)
    slots = jph.table_slots(n)
    slot_comps, slot_rows, _gid, stats = _jax_insert(keys[None], np.ones(n, bool), slots)
    trips = jph.probe_trips_for(int(stats[1]))
    probe_keys, pmask = _probe_inputs(rng, keys, 2048)
    want = np.asarray(jph.probe_table(jnp.asarray(slot_comps[0]), jnp.asarray(slot_rows),
                                      jnp.asarray(probe_keys), jnp.asarray(pmask), trips))

    src = interop.lookup_source_from_table(
        slot_comps[0], slot_rows, trips, keys, [dates], [(DATE, None)], device="cpu")
    lf = LookupSourceFactory()
    lf.set(src)
    op = LookupJoinOperatorFactory(0, lf, [0], [0], [(BIGINT, None)], [0],
                                   [(DATE, None)], INNER).create_operator()
    assert op.is_blocked() is None
    page = interop.page_from_numpy([BIGINT], [probe_keys], pmask, device="cpu")
    op.add_input(page)
    out = op.get_output()
    live = out.mask.numpy()
    np.testing.assert_array_equal(live, want >= 0)
    np.testing.assert_array_equal(out.blocks[0].data.numpy()[live], probe_keys[live])
    np.testing.assert_array_equal(out.blocks[1].data.numpy()[live], dates[want[live]])


def test_table_constants_match_the_reference():
    assert (tph.INSERT_TRIPS, tph.PROBE_TRIPS_CAP, tph.MAX_TABLE_SLOTS, tph.EMPTY) == \
        (jph.INSERT_TRIPS, jph.PROBE_TRIPS_CAP, jph.MAX_TABLE_SLOTS, jph.EMPTY)
    for n in (0, 1, 7, 8, 1000, 1 << 20, 1 << 21, (1 << 21) + 1):
        assert tph.table_slots(n) == jph.table_slots(n)
    for run in (0, 1, 7, 8, 100, 4095):
        assert tph.probe_trips_for(run) == jph.probe_trips_for(run)


def test_wrappers_reject_bad_inputs():
    comps = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        tph.insert_table(comps.to(torch.int32), torch.ones(8, dtype=torch.bool), 16)
    with pytest.raises(ValueError):
        tph.insert_table(comps, torch.ones(8, dtype=torch.bool), 12)
    with pytest.raises(ValueError):
        tph.insert_table(comps[:, ::2], torch.ones(4, dtype=torch.bool), 16)
    with pytest.raises(ValueError):
        tph.probe_table(torch.zeros(16, dtype=torch.int64), torch.zeros(16, dtype=torch.int64),
                        torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool), 8)
