"""The port's DENSE join strategy against presto_tpu, on the CPU.

The reference's ``test_inner_unique_join[dense]`` inputs (and seeded wider
ones) go through both packages' JoinBuild/LookupJoin operators with
``strategy="dense"``: rows, the row table over ``[dense_min, dense_max]``,
``probe_match_dense`` and the page-local probe stage are held exactly. The
factory refuses a duplicate-key and a multi-key dense build with the
reference's messages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import block as jblock
from presto_tpu.ops import hash_join as jhj
from presto_tpu.types import BIGINT as JBIGINT
from presto_tpu.types import DOUBLE as JDOUBLE
from presto_tpu_torch import block as tblock
from presto_tpu_torch.ops import hash_join as thj
from presto_tpu_torch.types import BIGINT as TBIGINT
from presto_tpu_torch.types import DOUBLE as TDOUBLE


def _run_join(build_pages, probe_pages, build_fac, probe_fac):
    """The reference test's driver loop: build, then probe page by page."""
    b = build_fac.create_operator()
    for p in build_pages:
        b.add_input(p)
    b.finish()
    j = probe_fac.create_operator()
    rows = []
    for p in probe_pages:
        j.add_input(p)
        while (o := j.get_output()) is not None:
            rows.extend(o.to_pylists())
    j.finish()
    while (o := j.get_output()) is not None:
        rows.extend(o.to_pylists())
    return rows


def _both(bkeys, bvals, pkeys, pw, join_type, dense_min, dense_max, cap=8):
    """The same dense join through both packages -> (ref rows, port rows,
    ref build factory, port build factory)."""
    out = []
    for blk, bigint, double, hj, extra in (
            (jblock, JBIGINT, JDOUBLE, jhj, {}),
            (tblock, TBIGINT, TDOUBLE, thj, {"device": "cpu"})):
        build = blk.page_from_arrays([bigint, bigint], [bkeys, bvals], count=len(bkeys),
                                     capacity=max(cap, len(bkeys)), **extra)
        probe = blk.page_from_arrays([bigint, double], [pkeys, pw], count=len(pkeys),
                                     capacity=max(cap, len(pkeys)), **extra)
        bf = hj.JoinBuildOperatorFactory(0, [0], [1], [(bigint, None)], strategy="dense",
                                         unique=True, dense_min=dense_min,
                                         dense_max=dense_max, **extra)
        pf = hj.LookupJoinOperatorFactory(1, bf.lookup_factory, [0], [0, 1],
                                          [(bigint, None), (double, None)], [0],
                                          [(bigint, None)], join_type)
        out.append((_run_join([build], [probe], bf, pf), bf))
    (ref_rows, ref_bf), (port_rows, port_bf) = out
    return ref_rows, port_rows, ref_bf, port_bf


def test_inner_unique_join_dense_equals_reference():
    bkeys = np.asarray([1, 3, 5, 7], dtype=np.int64)
    bvals = np.asarray([10, 30, 50, 70], dtype=np.int64)
    pkeys = np.asarray([5, 1, 2, 7, 7, 9], dtype=np.int64)
    pw = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    ref, port, ref_bf, port_bf = _both(bkeys, bvals, pkeys, pw, thj.INNER, 1, 7)
    assert port == ref == [[5, 1.0, 50], [1, 2.0, 10], [7, 4.0, 70], [7, 5.0, 70]]
    rsrc, psrc = ref_bf.lookup_factory.get(), port_bf.lookup_factory.get()
    assert psrc.kind == rsrc.kind == "dense" and psrc.base == int(rsrc.base)
    np.testing.assert_array_equal(psrc.table.numpy(), np.asarray(rsrc.table))


@pytest.mark.parametrize("join_type", [thj.INNER, thj.LEFT])
def test_seeded_dense_join_equals_reference(join_type):
    """Unique keys over a sparse domain; probe keys below, inside and above
    it; both join types keep the reference's rows in its order."""
    rng = np.random.RandomState(16)
    bkeys = rng.choice(np.arange(-50, 200), size=90, replace=False).astype(np.int64)
    bvals = rng.randint(-1000, 1000, size=90).astype(np.int64)
    pkeys = rng.randint(-80, 260, size=200).astype(np.int64)
    pw = rng.rand(200)
    ref, port, ref_bf, port_bf = _both(bkeys, bvals, pkeys, pw, join_type,
                                       int(bkeys.min()), int(bkeys.max()), cap=256)
    assert port == ref and len(port) > 0
    np.testing.assert_array_equal(port_bf.lookup_factory.get().table.numpy(),
                                  np.asarray(ref_bf.lookup_factory.get().table))


def test_probe_match_dense_and_stage_bit_identical():
    """``probe_match_dense`` and the page-local stage over a dense source,
    dead and NULL-key probe rows included."""
    rng = np.random.RandomState(7)
    table = rng.randint(-1, 100, size=64).astype(np.int32)
    keys = rng.randint(-20, 100, size=128).astype(np.int64)
    mask = rng.rand(128) < 0.8
    want = np.asarray(jhj.probe_match_dense(jnp.asarray(table), np.int64(10),
                                            jnp.asarray(keys), jnp.asarray(mask)))
    got = thj.probe_match_dense(torch.from_numpy(table), 10, torch.from_numpy(keys),
                                torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)

    bkeys = np.arange(10, 74, dtype=np.int64)
    bvals = rng.randint(0, 1000, size=64).astype(np.int64)
    nulls = rng.rand(128) < 0.1
    pages = []
    for blk, bigint, hj, extra in ((jblock, JBIGINT, jhj, {}),
                                   (tblock, TBIGINT, thj, {"device": "cpu"})):
        bf = hj.JoinBuildOperatorFactory(0, [0], [1], [(bigint, None)], strategy="dense",
                                         unique=True, dense_min=10, dense_max=73, **extra)
        b = bf.create_operator()
        b.add_input(blk.page_from_arrays([bigint, bigint], [bkeys, bvals], **extra))
        b.finish()
        pf = hj.LookupJoinOperatorFactory(1, bf.lookup_factory, [0], [0], [(bigint, None)],
                                          [0], [(bigint, None)], hj.LEFT, unique_build=True)
        src = bf.lookup_factory.get()
        probe = blk.page_from_arrays([bigint], [keys], **extra)
        if blk is jblock:
            probe = jblock.Page((jblock.Block(bigint, probe.blocks[0].data,
                                              jnp.asarray(nulls)),), jnp.asarray(mask))
            out = jhj.apply_probe_stage(probe, jhj.probe_stage_aux(src),
                                        jhj.probe_stage_cfg(pf, src))
        else:
            probe = tblock.Page((tblock.Block(bigint, probe.blocks[0].data,
                                              torch.from_numpy(nulls)),),
                                torch.from_numpy(mask))
            out = thj.apply_probe_stage(probe, thj.probe_stage_aux(src),
                                        thj.probe_stage_cfg(pf, src))
        pages.append(out)
    ref, port = pages
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    for rb, pb in zip(ref.blocks, port.blocks):
        np.testing.assert_array_equal(pb.null_mask().numpy(), np.asarray(rb.null_mask()))
        live = np.asarray(ref.mask) & ~np.asarray(rb.null_mask())
        np.testing.assert_array_equal(pb.data.numpy()[live], np.asarray(rb.data)[live])


@pytest.mark.parametrize("key_channels,unique", [([0], False), ([0, 1], True)])
def test_dense_refusals_match_reference(key_channels, unique):
    """A duplicate-key or multi-key dense build is refused at construction,
    with the reference's message."""
    msgs = []
    for bigint, hj, extra in ((JBIGINT, jhj, {}), (TBIGINT, thj, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            hj.JoinBuildOperatorFactory(0, key_channels, [2], [(bigint, None)],
                                        strategy="dense", unique=unique, **extra)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "dense join strategy requires" in msgs[1]
