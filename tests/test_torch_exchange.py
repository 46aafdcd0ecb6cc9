"""The port's collective exchanges against presto_tpu, on the CPU.

Seeded int64 keys (negative values and the int64 extremes included) go
through both packages' ``partition_ids`` and ``range_partition_ids`` for W
in {2, 8}: bit-identical. Then the repartitions, the broadcast and the
gather: the reference under ``shard_map`` on 2 of the 8 virtual devices,
the port over 2 CPU workers; every worker's arrays, masks and drop counts
are held exactly (the routed order is the reference's: a stable sort by
partition id, then source order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from presto_tpu.parallel import exchange as jex
from presto_tpu.parallel.mesh import WORKER_AXIS, MeshContext, shard_map
from presto_tpu_torch.parallel import exchange as tex

W = 2
ROWS = 64  # per worker
CAP = 24   # per peer: small enough that a worker's rows overflow it

_I64 = np.iinfo(np.int64)


def _keys(rng, n):
    k = rng.randint(_I64.min, _I64.max, size=n, dtype=np.int64)
    edge = np.asarray([0, -1, 1, _I64.min, _I64.max, -12345], dtype=np.int64)
    k[:min(n, 6)] = edge[:min(n, 6)]
    return k


@pytest.fixture(scope="module")
def mesh(eight_devices):
    return MeshContext(eight_devices[:W])


def _shard_map(mesh, fn, n_in, n_out):
    s = P(WORKER_AXIS)
    return jax.jit(shard_map(fn, mesh=mesh.mesh, in_specs=(s,) * n_in,
                             out_specs=(s,) * n_out))


def _split(x):
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in np.split(np.asarray(x), W)]


def _assert_per_worker(ref_global, port_list):
    ref = np.asarray(ref_global).reshape(W, -1)
    assert len(port_list) == W
    for w in range(W):
        np.testing.assert_array_equal(port_list[w].numpy(), ref[w])


@pytest.mark.parametrize("n_parts", [2, 8])
def test_partition_ids_bit_identical(n_parts):
    keys = _keys(np.random.RandomState(n_parts), 4096)
    want = np.asarray(jex.partition_ids(jnp.asarray(keys), n_parts))
    got = tex.partition_ids(torch.from_numpy(keys), n_parts).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_parts", [2, 8])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_range_partition_ids_bit_identical(n_parts, dtype):
    rng = np.random.RandomState(3 + n_parts)
    if dtype is np.int64:
        rk = _keys(rng, 2048)
        splitters = np.sort(rng.randint(_I64.min, _I64.max, size=n_parts - 1, dtype=np.int64))
    else:
        rk = rng.randn(2048) * 1e6
        rk[:3] = [-np.inf, np.inf, 0.0]
        splitters = np.sort(rng.randn(n_parts - 1) * 1e6)
    splitters[:1] = rk[7]  # a key equal to a splitter goes left
    mask = rng.rand(2048) < 0.85
    want = np.asarray(jex.range_partition_ids(jnp.asarray(rk), jnp.asarray(splitters),
                                              jnp.asarray(mask), n_parts))
    got = tex.range_partition_ids(torch.from_numpy(rk), torch.from_numpy(splitters),
                                  torch.from_numpy(mask), n_parts).numpy()
    np.testing.assert_array_equal(got, want)


def _columns(seed):
    rng = np.random.RandomState(seed)
    n = W * ROWS
    a = _keys(rng, n)
    b = rng.randn(n)
    mask = rng.rand(n) < 0.8
    # a skewed pid: most live rows to partition 1, so its slice overflows CAP
    pid = np.where(rng.rand(n) < 0.75, 1, rng.randint(0, W, n)).astype(np.int32)
    pid = np.where(mask, pid, W).astype(np.int32)
    return a, b, mask, pid


def test_repartition_by_pid_equals_reference(mesh):
    a, b, mask, pid = _columns(1)

    def stage(a, b, mask, pid):
        out, m, dropped = jex.repartition_by_pid([a, b], mask, pid, W, CAP)
        return out[0], out[1], m, dropped.reshape(1)
    ra, rb, rm, rd = _shard_map(mesh, stage, 4, 4)(a, b, mask, pid)
    outs, masks, dropped = tex.repartition_by_pid(
        [list(x) for x in zip(_split(a), _split(b))], _split(mask), _split(pid), W, CAP)
    _assert_per_worker(ra, [o[0] for o in outs])
    _assert_per_worker(rb, [o[1] for o in outs])
    _assert_per_worker(rm, masks)
    _assert_per_worker(rd, [d.reshape(1) for d in dropped])
    assert int(np.asarray(rd).sum()) > 0  # the skew overflowed a peer slice


def test_repartition_by_key_equals_reference(mesh):
    a, b, mask, _ = _columns(2)

    def stage(a, b, mask):
        out, m, dropped = jex.repartition([a, b], mask, a, W, ROWS)
        return out[0], out[1], m, dropped.reshape(1)
    ra, rb, rm, rd = _shard_map(mesh, stage, 3, 4)(a, b, mask)
    outs, masks, dropped = tex.repartition(
        [list(x) for x in zip(_split(a), _split(b))], _split(mask), _split(a), W, ROWS)
    _assert_per_worker(ra, [o[0] for o in outs])
    _assert_per_worker(rb, [o[1] for o in outs])
    _assert_per_worker(rm, masks)
    _assert_per_worker(rd, [d.reshape(1) for d in dropped])


def test_repartition_with_carry_equals_reference(mesh):
    a, b, mask, pid = _columns(3)

    def stage(a, b, mask, pid):
        out, m, carry, cm = jex.repartition_by_pid_with_carry([a, b], mask, pid, W, CAP)
        return out[0], out[1], m, carry[0], carry[1], cm
    ra, rb, rm, ca, cb, cm = _shard_map(mesh, stage, 4, 6)(a, b, mask, pid)
    outs, masks, carries, cmasks = tex.repartition_by_pid_with_carry(
        [list(x) for x in zip(_split(a), _split(b))], _split(mask), _split(pid), W, CAP)
    _assert_per_worker(ra, [o[0] for o in outs])
    _assert_per_worker(rb, [o[1] for o in outs])
    _assert_per_worker(rm, masks)
    _assert_per_worker(ca, [c[0] for c in carries])
    _assert_per_worker(cb, [c[1] for c in carries])
    _assert_per_worker(cm, cmasks)
    assert int(np.asarray(cm).sum()) > 0  # overflow rows came back as carry


@pytest.mark.parametrize("kind", ["broadcast", "gather"])
def test_broadcast_and_gather_equal_reference(mesh, kind):
    a, b, mask, _ = _columns(4)
    jfn = jex.broadcast_gather if kind == "broadcast" else jex.gather_to_single
    tfn = tex.broadcast_gather if kind == "broadcast" else tex.gather_to_single

    def stage(a, b, mask):
        out, m = jfn([a, b], mask)
        return out[0], out[1], m
    ra, rb, rm = _shard_map(mesh, stage, 3, 3)(a, b, mask)
    outs, masks = tfn([list(x) for x in zip(_split(a), _split(b))], _split(mask))
    _assert_per_worker(ra, [o[0] for o in outs])
    _assert_per_worker(rb, [o[1] for o in outs])
    _assert_per_worker(rm, masks)


def test_psum_equals_reference(mesh):
    x = np.random.RandomState(5).randint(-10**12, 10**12, size=W * 6).astype(np.int64)

    def stage(x):
        return (jex.psum_scalar(x),)
    (want,) = jax.jit(shard_map(stage, mesh=mesh.mesh, in_specs=(P(WORKER_AXIS),),
                                out_specs=(P(),)))(x)
    got = tex.psum_scalar(_split(x))
    for g in got:
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
