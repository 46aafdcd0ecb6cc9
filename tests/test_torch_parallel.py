"""The port's distributed stage programs against presto_tpu, on the CPU.

``tests/test_parallel.py``'s three stage programs (distributed Q1, the Q3
join-aggregate shape, the general grouped aggregation) on the same seeded
inputs: the reference over 8 virtual devices, the port over 8 CPU workers.
Every output is held exactly, the grouped aggregation's per-worker group
tables included.
"""
import numpy as np
import pytest
import torch

from presto_tpu.ops.aggregates import SUM as JSUM
from presto_tpu.parallel import distributed as jd
from presto_tpu.parallel.mesh import MeshContext as JMesh
from presto_tpu_torch.ops.aggregates import SUM as TSUM
from presto_tpu_torch.parallel import distributed as td
from presto_tpu_torch.parallel.mesh import MeshContext as TMesh

W = 8


@pytest.fixture(scope="module")
def meshes(eight_devices):
    return JMesh(eight_devices[:W]), TMesh([torch.device("cpu")] * W)


def _equal(ref, port):
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))


def test_dist_q1_equals_reference(meshes):
    cap = 512
    rng = np.random.RandomState(0)
    n = W * cap
    args = (rng.randint(0, 3, n).astype(np.int32), rng.randint(0, 2, n).astype(np.int32),
            rng.randint(100, 5000, n).astype(np.int64),
            rng.randint(1000, 100000, n).astype(np.int64),
            rng.randint(0, 11, n).astype(np.int64), rng.randint(0, 9, n).astype(np.int64),
            rng.randint(8000, 11000, n).astype(np.int32), rng.rand(n) < 0.9)
    ref = jd.dist_q1_step(meshes[0])(*args)
    port = td.dist_q1_step(meshes[1])(*args)
    _equal(ref, port)
    assert int(port[5].sum()) > 0


def test_dist_join_agg_equals_reference(meshes):
    cap = 256
    n = W * cap
    rng = np.random.RandomState(1)
    args = (rng.permutation(n).astype(np.int64), rng.randint(0, 1000, n).astype(np.int64),
            np.ones(n, dtype=bool), rng.randint(0, 2 * n, n).astype(np.int64),
            rng.randint(0, 1000, n).astype(np.int64), rng.rand(n) < 0.95)
    ref = jd.dist_join_agg_step(meshes[0], probe_cap_per_peer=cap)(*args)
    port = td.dist_join_agg_step(meshes[1], probe_cap_per_peer=cap)(*args)
    _equal(ref, port)
    assert int(port[2]) == 0 and int(port[1].sum()) > 0


def test_dist_grouped_agg_equals_reference(meshes):
    cap = 256
    n = W * cap
    rng = np.random.RandomState(2)
    args = (rng.randint(0, 100, n).astype(np.int64), rng.randint(0, 1000, n).astype(np.int64),
            rng.rand(n) < 0.9)
    ref = jd.dist_grouped_agg_step(meshes[0], n_keys=1, n_states=1, kinds=(JSUM,),
                                   identities=(0,), max_groups=64)(*args)
    port = td.dist_grouped_agg_step(meshes[1], n_keys=1, n_states=1, kinds=(TSUM,),
                                    identities=(0,), max_groups=64)(*args)
    # keys, states and the valid mask per worker's group table, then the drops
    _equal(ref, port)
    assert int(port[3]) == 0
