"""The port's multi-key packing, duplicate-key expansion and LIKE against
presto_tpu, on the CPU.

Same numpy inputs (fixed seeds) through both packages; every comparison is
exact. The join functions are held bit for bit (the reference's ``lo``,
``emit`` and ``match`` counts are int32 in both; the port keeps the running
offsets in int64, the reference in int32, so those compare by value), the
operators page for page, every column and null mask at every row, dead rows
included.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import block as jblock
from presto_tpu import types as jt
from presto_tpu.connectors.tpch import generator as jg
from presto_tpu.ops import expressions as jx
from presto_tpu.ops import hash_join as jhj
from presto_tpu.ops.filter_project import PageProcessor as JPageProcessor
from presto_tpu_torch import block as tblock
from presto_tpu_torch import types as tt
from presto_tpu_torch.connectors.tpch import generator as tg
from presto_tpu_torch.ops import expressions as tx
from presto_tpu_torch.ops import hash_join as thj
from presto_tpu_torch.ops.filter_project import PageProcessor as TPageProcessor

CAP = 64  # small pages: an expansion spans several chunks


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pages(types_j, types_t, arrays, mask, nulls=None, dicts_j=None, dicts_t=None):
    """The same page in both packages from numpy: columns, per-column null
    masks (or None), row mask and dictionaries."""
    k = len(arrays)
    nulls, dicts_j, dicts_t = nulls or [None] * k, dicts_j or [None] * k, dicts_t or [None] * k
    jp = jblock.Page(tuple(jblock.Block(t, jnp.asarray(a), None if n is None else jnp.asarray(n),
                                        d)
                           for t, a, n, d in zip(types_j, arrays, nulls, dicts_j)),
                     jnp.asarray(mask))
    tp = tblock.Page(tuple(tblock.Block(t, torch.from_numpy(np.ascontiguousarray(a)),
                                        None if n is None else torch.from_numpy(n), d)
                           for t, a, n, d in zip(types_t, arrays, nulls, dicts_t)),
                     torch.from_numpy(np.ascontiguousarray(mask)))
    return jp, tp


def _assert_pages_equal(jp, tp):
    np.testing.assert_array_equal(_np(tp.mask), _np(jp.mask))
    assert len(jp.blocks) == len(tp.blocks)
    for jb, tb in zip(jp.blocks, tp.blocks):
        assert jb.type.display_name() == tb.type.display_name()
        want, got = _np(jb.data), _np(tb.data)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert (jb.nulls is None) == (tb.nulls is None)
        if jb.nulls is not None:
            np.testing.assert_array_equal(_np(tb.nulls), _np(jb.nulls))


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _packing_case(name: str, n: int = 500):
    """(build keys, build mask, probe keys) as numpy lists, from a seed."""
    rng = np.random.RandomState(len(name))
    if name == "two_keys":
        keys = [rng.randint(1, 6_000_000, n).astype(np.int64),
                rng.randint(1, 150_000, n).astype(np.int64)]
    elif name == "narrow_and_wide":  # an int32 key beside an int64 key
        keys = [rng.randint(-50, 50, n).astype(np.int32),
                rng.randint(-(1 << 40), 1 << 40, n).astype(np.int64)]
    elif name == "three_keys":
        keys = [rng.randint(0, 25, n).astype(np.int32),
                rng.randint(100, 20_000, n).astype(np.int64),
                rng.randint(-7, 3, n).astype(np.int64)]
    elif name == "over_62_bits":  # 41 + 31 bits: no packing plan
        keys = [rng.randint(-(1 << 40), 1 << 40, n).astype(np.int64),
                rng.randint(0, 1 << 31, n).astype(np.int64)]
    elif name == "no_live_rows":
        keys = [rng.randint(0, 9, n).astype(np.int64), rng.randint(0, 9, n).astype(np.int64)]
    else:
        raise AssertionError(name)
    mask = np.zeros(n, bool) if name == "no_live_rows" else rng.rand(n) < 0.8
    # probes: live build keys, and values below and above every key's range
    probe = []
    for k in keys:
        lo, hi = (int(k[mask].min()), int(k[mask].max())) if mask.any() else (0, 0)
        top = lo + (1 << max((hi - lo).bit_length(), 1))  # first value above the width
        extra = np.array([lo - 1, top, lo, hi], dtype=np.int64)
        probe.append(np.concatenate([k[rng.permutation(n)].astype(np.int64), extra,
                                     extra[::-1]]).astype(k.dtype))
    return keys, mask, probe


@pytest.mark.parametrize("case", ["two_keys", "narrow_and_wide", "three_keys",
                                  "over_62_bits", "no_live_rows"])
def test_plan_packing_and_pack_key_match_reference(case):
    keys, mask, probe = _packing_case(case)
    want = jhj._plan_packing(tuple(jnp.asarray(k) for k in keys), jnp.asarray(mask))
    got = thj._plan_packing(tuple(torch.from_numpy(k) for k in keys), torch.from_numpy(mask))
    if case == "over_62_bits":
        assert want is None and got is None
        return
    assert [list(np.asarray(w)) for w in want] == [list(g) for g in got]
    if case == "no_live_rows":
        assert got == ((0, 0), (1, 0), (1, 1))
    for ks in (keys, probe):
        wpack = np.asarray(jhj._pack_key(tuple(jnp.asarray(k) for k in ks), *want))
        gpack = thj._pack_key(tuple(torch.from_numpy(k) for k in ks), *got).numpy()
        assert gpack.dtype == wpack.dtype == np.int64
        np.testing.assert_array_equal(gpack, wpack)
    # out-of-range probe values map to the sentinel, which no build key equals
    sentinel = np.iinfo(np.int64).min // 2
    np.testing.assert_array_equal(gpack[-8:] == sentinel, [1, 1, 0, 0, 0, 0, 1, 1])
    live = thj._pack_key(tuple(torch.from_numpy(k) for k in keys), *got).numpy()[mask]
    assert (live >= 0).all()


# ---------------------------------------------------------------------------
# range and expand kernels
# ---------------------------------------------------------------------------

def _expansion_case():
    """A duplicate-key build and one probe page of CAP rows whose matches
    span several CAP-row chunks; one probe key has more matches than a chunk
    holds, so a chunk boundary falls inside its run. Probe rows are masked
    and some probe keys are null."""
    rng = np.random.RandomState(7)
    n = 400
    bkey = rng.randint(0, 60, n).astype(np.int64)
    bkey[:150] = 5  # 150 copies of key 5 (> CAP)
    bpay = rng.randint(0, 10 ** 6, n).astype(np.int64)
    bpay_nulls = rng.rand(n) < 0.1
    bmask = rng.rand(n) < 0.9
    pkey = rng.randint(0, 80, CAP).astype(np.int64)  # some miss every build key
    pkey[[3, 40]] = 5
    pval = rng.randint(0, 1000, CAP).astype(np.int64)
    pmask = rng.rand(CAP) < 0.85
    pnulls = rng.rand(CAP) < 0.1
    return (bkey, bpay, bpay_nulls, bmask), (pkey, pval, pmask, pnulls)


def _sorted_source(pkg, keys, mask):
    if pkg is jhj:
        ks = tuple(jnp.asarray(k) for k in keys)
        return jhj._build_sorted(ks, (), jnp.asarray(mask), 0, [], False)
    return thj._build_sorted(tuple(torch.from_numpy(k) for k in keys), (),
                             torch.from_numpy(mask), [], False)


@pytest.mark.parametrize("left", [False, True], ids=["inner", "left"])
def test_range_and_expand_kernels_match_reference(left):
    (bkey, bpay, bpay_nulls, bmask), (pkey, pval, pmask, pnulls) = _expansion_case()
    jsrc, tsrc = _sorted_source(jhj, [bkey], bmask), _sorted_source(thj, [bkey], bmask)
    np.testing.assert_array_equal(tsrc.sorted_key.numpy(), np.asarray(jsrc.sorted_key))
    np.testing.assert_array_equal(tsrc.sorted_row.numpy(), np.asarray(jsrc.sorted_row))
    jp, tp = _pages([jt.BIGINT, jt.BIGINT], [tt.BIGINT, tt.BIGINT], [pkey, pval], pmask,
                    [pnulls, None])
    probe_mask = pmask & ~pnulls
    want = jhj._range_kernel(jsrc.sorted_key, jnp.asarray(pkey), jnp.asarray(probe_mask),
                             jnp.asarray(pmask), left)
    got = thj._range_kernel(tsrc.sorted_key, torch.from_numpy(pkey),
                            torch.from_numpy(probe_mask), torch.from_numpy(pmask), left)
    for w, g in zip(want[:3], got[:3]):
        assert g.dtype == torch.int32 and np.asarray(w).dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    total = int(got[3])
    assert total == int(want[3]) and total > 3 * CAP
    assert int(got[2].max()) > CAP  # one probe row's run crosses a chunk boundary
    joffsets = jnp.cumsum(want[1])
    toffsets = torch.cumsum(got[1], 0, dtype=torch.int64)
    np.testing.assert_array_equal(toffsets.numpy(), np.asarray(joffsets))
    payload_j, payload_t = (jnp.asarray(bpay),), (torch.from_numpy(bpay),)
    nulls_j, nulls_t = (jnp.asarray(bpay_nulls),), (torch.from_numpy(bpay_nulls),)
    meta_j, meta_t = ((jt.BIGINT, None),), [(tt.BIGINT, None)]
    for base in range(0, total, CAP):
        wp = jhj._expand_kernel(jp, (jnp.asarray(pkey),), want[0], joffsets, want[2],
                                jsrc.sorted_row, jsrc.key_arrays, payload_j, nulls_j,
                                (0, 1), (0,), base, int(want[3]), left, meta_j)
        gp = thj._expand_kernel(tp, (torch.from_numpy(pkey),), got[0], toffsets, got[2],
                                tsrc.sorted_row, tsrc.key_arrays, payload_t, nulls_t,
                                (0, 1), (0,), base, total, left, meta_t)
        _assert_pages_equal(wp, gp)


# ---------------------------------------------------------------------------
# build and probe operators
# ---------------------------------------------------------------------------

def _operator_case(case: str):
    """(key types, build columns + build mask, probe pages, unique), numpy."""
    rng = np.random.RandomState(sum(map(ord, case)))
    n = 300
    mixed = case.endswith("mixed")
    nkeys = 3 if case.startswith("3") else 2
    dup = "dup" in case
    # distinct key tuples, then the build rows' picks among them
    ntup = 40 if dup else n
    if mixed:  # 41 + 32 bits: above 62, so combined_key mixes them
        base = [(rng.permutation(ntup) - ntup // 2).astype(np.int64) * (1 << 32),
                rng.randint(-(1 << 31), (1 << 31) - 1, ntup)]
    else:
        base = [rng.permutation(10 ** 6)[:ntup].astype(np.int64) - 500,
                rng.randint(0, 1 << 20, ntup)]
    base.append(rng.randint(-3, 3, ntup))
    pick = rng.randint(0, ntup, n) if dup else np.arange(n)
    keys = [base[0][pick], base[1][pick].astype(np.int32),
            base[2][pick].astype(np.int64)][:nkeys]
    pay = rng.randint(0, 10 ** 9, n).astype(np.int64)
    pay_nulls = rng.rand(n) < 0.15
    bmask = rng.rand(n) < 0.9
    probes = []
    for p in range(3):
        pick = rng.randint(0, n, CAP)
        pk = [k[pick].copy() for k in keys]
        miss = rng.rand(CAP) < 0.3
        pk[1][miss] += 1  # misses, some of them out of the packed range
        pk[0][rng.rand(CAP) < 0.05] = -(1 << 50)
        pval = rng.randint(0, 100, CAP).astype(np.int64)
        pnulls = [rng.rand(CAP) < 0.05] + [None] * (nkeys - 1)
        probes.append((pk + [pval], pnulls + [None], rng.rand(CAP) < 0.9))
    ktypes = [(jt.BIGINT, tt.BIGINT), (jt.INTEGER, tt.INTEGER)] + \
        [(jt.BIGINT, tt.BIGINT)] * (nkeys - 2)
    return ktypes, (keys + [pay], [None] * nkeys + [pay_nulls], bmask), probes, not dup


def _run_join(pkg, case: str, join_type: str):
    """Build + probe in one package; returns (lookup source, output pages)."""
    ktypes, (bcols, bnulls, bmask), probes, unique = _operator_case(case)
    j = pkg is jhj
    types = [kt[0 if j else 1] for kt in ktypes] + [jt.BIGINT if j else tt.BIGINT]
    nkeys = len(ktypes)
    bj, bt = _pages(types, types, bcols, bmask, bnulls)
    kw = {} if j else {"device": "cpu"}
    build = pkg.JoinBuildOperatorFactory(0, list(range(nkeys)), [nkeys],
                                         [(types[-1], None)], strategy="sorted",
                                         unique=unique, **kw)
    op = build.create_operator()
    op.add_input(bj if j else bt)
    op.finish()
    probe = pkg.LookupJoinOperatorFactory(
        1, build.lookup_factory, list(range(nkeys)), list(range(nkeys + 1)),
        [(t, None) for t in types], [0], [(types[-1], None)], join_type).create_operator()
    assert probe.is_blocked() is None
    outs = []
    for cols, nulls, mask in probes:
        pj, pt = _pages(types, types, cols, mask, nulls)
        assert probe.needs_input()
        probe.add_input(pj if j else pt)
        while (out := probe.get_output()) is not None:
            outs.append(out)
    probe.finish()
    assert probe.get_output() is None and probe.is_finished()
    return (build.lookup_factory.get(0) if j else build.lookup_factory.get()), outs


OPERATOR_CASES = ["2key_unique_packed", "2key_dup_packed", "3key_dup_packed",
                  "2key_unique_mixed", "2key_dup_mixed", "3key_dup_mixed"]


@pytest.mark.parametrize("join_type", ["inner", "left"])
@pytest.mark.parametrize("case", OPERATOR_CASES)
def test_multi_key_join_operators_match_reference(case, join_type):
    """2- and 3-key builds, packed and mixed, unique and duplicate, INNER and
    LEFT: the same lookup source, and the same output pages in the same
    order. Multi-key LEFT on a mixed build, unique or not, refuses in both
    packages (a mixed build's keys are inexact, so it expands)."""
    mixed = case.endswith("mixed")
    if mixed and join_type == "left":
        for pkg in (jhj, thj):
            with pytest.raises(NotImplementedError, match="multi-key LEFT join"):
                _run_join(pkg, case, join_type)
        return
    jsrc, jouts = _run_join(jhj, case, join_type)
    tsrc, touts = _run_join(thj, case, join_type)
    assert (tsrc.pack_offsets is None) == mixed == (jsrc.pack_offsets is None)
    assert tsrc.exact_keys == jsrc.exact_keys == (not mixed)
    if not mixed:
        for w, g in zip((jsrc.pack_offsets, jsrc.pack_shifts, jsrc.pack_widths),
                        (tsrc.pack_offsets, tsrc.pack_shifts, tsrc.pack_widths)):
            assert list(np.asarray(w)) == list(g)
    np.testing.assert_array_equal(tsrc.sorted_key.numpy(), np.asarray(jsrc.sorted_key))
    np.testing.assert_array_equal(tsrc.sorted_row.numpy(), np.asarray(jsrc.sorted_row))
    assert len(touts) == len(jouts)
    for jp, tp in zip(jouts, touts):
        _assert_pages_equal(jp, tp)
    assert sum(int(p.mask.sum()) for p in touts) > 0
    if "dup" in case:  # the expansion path: more chunks than probe pages
        assert len(touts) > 3


def test_expansion_emits_one_chunk_per_get_output():
    """The expanding probe holds no chunk ahead of its consumer: after
    add_input nothing is materialised, each get_output makes one chunk, and
    the operator takes no input until the page's last chunk is out. The
    chunks are the reference's pages, in its order."""
    (bkey, bpay, bpay_nulls, bmask), (pkey, pval, pmask, pnulls) = _expansion_case()
    ops = {}
    for pkg, types, dev in ((jhj, jt, {}), (thj, tt, {"device": "cpu"})):
        bj, bt = _pages([jt.BIGINT, jt.BIGINT], [tt.BIGINT, tt.BIGINT], [bkey, bpay], bmask,
                        [None, bpay_nulls])
        build = pkg.JoinBuildOperatorFactory(0, [0], [1], [(types.BIGINT, None)],
                                             strategy="sorted", unique=False, **dev)
        op = build.create_operator()
        op.add_input(bj if pkg is jhj else bt)
        op.finish()
        probe = pkg.LookupJoinOperatorFactory(
            1, build.lookup_factory, [0], [0, 1], [(types.BIGINT, None)] * 2, [0],
            [(types.BIGINT, None)], "left").create_operator()
        probe.is_blocked()
        ops[pkg] = probe
    jp, tp = _pages([jt.BIGINT, jt.BIGINT], [tt.BIGINT, tt.BIGINT], [pkey, pval], pmask,
                    [pnulls, None])
    ops[jhj].add_input(jp)
    want = list(ops[jhj]._outputs)
    t = ops[thj]
    t.add_input(tp)
    assert len(want) > 3
    got = []
    for i in range(len(want)):
        assert t._outputs == [] and not t.needs_input()
        got.append(t.get_output())
    assert t._expansion is None and t.needs_input() and t.get_output() is None
    for w, g in zip(want, got):
        _assert_pages_equal(w, g)


def test_float_key_inner_join_expands_and_left_refuses():
    """A float single key is inexact (combined_key truncates): INNER takes
    the verified expansion, LEFT refuses, in both packages."""
    rng = np.random.RandomState(12)
    bkey = rng.randint(0, 30, 200) + rng.choice([0.0, 0.25, 0.5], 200)
    pkey = rng.randint(0, 30, CAP) + rng.choice([0.0, 0.25, 0.75], CAP)
    bpay = np.arange(200, dtype=np.int64)
    pmask = rng.rand(CAP) < 0.9
    outs = {}
    for pkg, types, dev in ((jhj, jt, {}), (thj, tt, {"device": "cpu"})):
        for jtype in ("inner", "left"):
            bj, bt = _pages([jt.DOUBLE, jt.BIGINT], [tt.DOUBLE, tt.BIGINT], [bkey, bpay],
                            np.ones(200, bool))
            build = pkg.JoinBuildOperatorFactory(0, [0], [1], [(types.BIGINT, None)],
                                                 strategy="sorted", unique=True, **dev)
            op = build.create_operator()
            op.add_input(bj if pkg is jhj else bt)
            op.finish()
            probe = pkg.LookupJoinOperatorFactory(
                1, build.lookup_factory, [0], [0], [(types.DOUBLE, None)], [0],
                [(types.BIGINT, None)], jtype).create_operator()
            probe.is_blocked()
            pj, pt = _pages([jt.DOUBLE], [tt.DOUBLE], [pkey], pmask)
            if jtype == "left":
                with pytest.raises(NotImplementedError, match="multi-key LEFT join"):
                    probe.add_input(pj if pkg is jhj else pt)
                continue
            probe.add_input(pj if pkg is jhj else pt)
            outs[pkg] = []
            while (out := probe.get_output()) is not None:
                outs[pkg].append(out)
    assert len(outs[thj]) == len(outs[jhj]) >= 1
    for w, g in zip(outs[jhj], outs[thj]):
        _assert_pages_equal(w, g)
    assert 0 < sum(int(p.mask.sum()) for p in outs[thj])


# ---------------------------------------------------------------------------
# LIKE
# ---------------------------------------------------------------------------

LIKE_CASES = [
    # (dictionary, pattern, escape)
    ("p_type", "%BRASS", None),
    ("p_type", "%green%", None),
    ("p_type", "forest%", None),
    ("p_type", "%special%requests%", None),
    ("p_type", "%A%", None),             # more than 64 codes: sorted membership
    ("p_type", "_____ POLISHED%", None),
    ("p_type", "%!%%", "!"),             # an escaped '%': matches nothing
    ("p_type", "PROMO!_%", None),        # '!' is no escape without ESCAPE
    ("p_name", "%green%", None),
    ("p_name", "forest%", None),
    ("p_name", "%green", None),
    ("p_name", "%BRASS", None),
    ("p_name", "%ro%se%", None),         # several tokens in one word
    ("o_comment", "%special%requests%", None),
    ("o_comment", "special%", None),
    ("p_name", "_reen%", None),          # refused by both: no packed route
    ("p_name", "%green%", "!"),          # refused by both: escape
    ("c_name", "Customer#%", None),      # refused by both: formatted dictionary
]


# (dictionary, pattern) pairs whose rows must hold matches and misses
LIKE_HITS = {("p_type", "%BRASS"), ("p_type", "%A%"), ("p_type", "_____ POLISHED%"),
             ("p_name", "%green%"), ("p_name", "forest%"), ("p_name", "%green"),
             ("p_name", "%ro%se%"), ("o_comment", "%special%requests%"),
             ("o_comment", "special%")}


def _like_page(dict_name: str, n: int = 2000):
    """Codes of one dictionary column with nulls and masked rows, and the
    column's dictionary in both packages."""
    rng = np.random.RandomState(sum(map(ord, dict_name)))
    attr = {"p_type": "DICT_P_TYPE", "p_name": "DICT_P_NAME", "o_comment": "DICT_COMMENT",
            "c_name": "DICT_CUST_NAME"}[dict_name]
    dj, dt = getattr(jg, attr), getattr(tg, attr)
    if isinstance(dt, tg.PackedWordsDictionary):
        codes = dt.pack(rng.randint(0, len(dt.words), size=(dt.n_fields, n)))
    elif isinstance(dt, tg.FormattedDictionary):
        codes = rng.randint(1, 1500, n).astype(np.int32)
    else:
        codes = rng.randint(0, len(dt), n).astype(np.int32)
    return codes, rng.rand(n) < 0.1, rng.rand(n) < 0.95, dj, dt


@pytest.mark.parametrize("dict_name,pattern,escape", LIKE_CASES,
                         ids=[f"{d}:{p}:{e}" for d, p, e in LIKE_CASES])
def test_like_matches_reference(dict_name, pattern, escape):
    """LIKE and NOT LIKE over a column with nulls: the same filter mask, and
    the same truth values and null mask when projected. Where the reference
    refuses a pattern, the port refuses it too."""
    codes, nulls, mask, dj, dt = _like_page(dict_name)
    wide = codes.dtype == np.int64
    vtypes = (jt.WIDE_VARCHAR, tt.WIDE_VARCHAR) if wide else (jt.VARCHAR, tt.VARCHAR)
    jp, tp = _pages([vtypes[0]], [vtypes[1]], [codes], mask, [nulls], [dj], [dt])
    results = []
    for x, types, page, d, proc, vt in ((jx, jt, jp, dj, JPageProcessor, vtypes[0]),
                                        (tx, tt, tp, dt, TPageProcessor, vtypes[1])):
        args = [x.input_ref(0, vt), x.constant(pattern, types.VARCHAR)]
        if escape is not None:
            args.append(x.constant(escape, types.VARCHAR))
        like = x.call("like", types.BOOLEAN, *args)
        layout = x.InputLayout([vt], [d])
        try:
            filt = proc(layout, like, [x.input_ref(0, vt)])(page)
            proj = proc(layout, None, [x.special("NOT", types.BOOLEAN, like)])(page)
        except NotImplementedError:
            results.append(None)
            continue
        results.append((filt, proj))
    want, got = results
    if want is None:
        assert got is None, "the reference refuses this LIKE, so must the port"
        return
    assert got is not None
    np.testing.assert_array_equal(_np(got[0].mask), _np(want[0].mask))
    _assert_pages_equal(want[1], got[1])
    hits = _np(got[0].mask)
    if (dict_name, pattern) in LIKE_HITS:
        assert hits.any() and not hits[mask & ~nulls].all()
