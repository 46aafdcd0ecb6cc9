#!/usr/bin/env python3
"""Drive the PyTorch port (presto_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. print the device and ``nvidia-smi --query-gpu=name,power.limit``;
2. build the CUDA source of ``presto_tpu_torch/kernels`` (one nvcc) into
   the git-ignored build directory;
3. hold each hand-written kernel against its plain PyTorch version on the
   same CUDA tensors at the shapes TPC-H Q3 at SF1 gives it (insert: 2^21
   rows into 2^22 slots, with one key component of unique keys and with
   three components with duplicates and masked rows; probe: a 2^20-row page
   of hits, misses and masked rows), bit-identical, and time both; print
   the insert's cooperative grid and its rows pending per round at the
   unique-key shape (checked against what its outputs imply);
4. run hand-built TPC-H Q3 at SF1 on the card with ``hash_kernels="auto"``:
   the launch counters are set to 0 just before the warm run and read just
   after; both kernels must have launched, the join build must have taken
   the open-addressing table (``pallas.join_builds == 1``, no fallback), and
   the rows must equal a numpy-only Q3 over the port's generator and the
   port's own ``hash_kernels="sorted"`` run, exactly (Decimals and dates);
5. one more warm Q3 under ``torch.profiler``: device idle share, top
   kernels, and the insert's device launches (at most 3 per insert call);
6. run TPC-H Q1, Q3 and Q6 as SQL at SF1 through the port's
   ``LocalQueryRunner(device="cuda")`` with ``hash_kernels="pallas"``: a cold
   and a warm run each, rows equal to a numpy-only oracle over the port's
   generator (exact for decimals, dates and strings; DOUBLE to a relative
   1e-12) and to the query under ``hash_kernels="sorted"``. For Q3 the launch
   counters and the ``pallas.`` metrics are set to 0 just before the warm run
   and read just after: both joins built on the table
   (``pallas.join_builds == 2``, no fallback), insert launches equal to
   ``join_builds + agg_pages`` and at least one probe launch per probe
   stream; then one more warm SQL Q3 under ``torch.profiler``, and one
   more warm run of each query timed layer by layer on the host clock;
7. hold the insert against its plain version, bit for bit, at the shape the
   SQL Q3 grouping gives it (its first hash-grouped page: the key
   components, the live rows, and the slots the first page's group count
   sized), and time it;
8. print the kernels line (JSON), the card line, and last the result line.

Exits non-zero, printing no result, when CUDA is absent, when the package is
not beside the script, or when any phase fails. It imports nothing of JAX.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
from decimal import Decimal

import numpy as np

SEED = 20261017
# DOUBLE columns (Q1's averages) sum float64 contributions with atomics, in
# an order that changes from run to run; every other column is exact
DOUBLE_REL_TOL = 1e-12
# device-memory rate of an H100 SXM, bytes/s (NVIDIA's data sheet)
HBM_RATE = 3.35e12
TPU_KERNELS = {"insert": "presto_tpu/ops/pallas_hash.py:197",
               "probe": "presto_tpu/ops/pallas_hash.py:261"}
KERNEL_SOURCE = "presto_tpu_torch/kernels/hash_table.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, device) -> float:
    """Median milliseconds of ``fn()`` after one warm-up call: CUDA events
    around each call on the card, the host clock on the CPU."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_ms(fn, reps: int, name: str) -> float:
    """Device time of one call of ``fn`` from ``torch.profiler``: for each
    CUDA kernel whose name holds ``name``, the median of its times over
    ``reps`` calls, summed over the kernels. Host time is not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name:
            times.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not times:
        raise AssertionError(f"the profiler saw no kernel named like {name!r}")
    return sum(float(np.median(t)) for t in times.values()) / 1e3


def build_kernels() -> None:
    from presto_tpu_torch import kernels

    t0 = time.perf_counter()
    lib = kernels.build(kernels.SOURCE)
    log(f"BUILD ok: {lib.name} in {time.perf_counter() - t0:.1f}s")
    ptxas = kernels.BUILD_DIR / f"{os.path.splitext(kernels.SOURCE)[0]}.ptxas.txt"
    entry = "?"
    for line in (ptxas.read_text().splitlines() if ptxas.exists() else []):
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill stores" in line:
            log(f"  ptxas {entry}: {line.strip()}")
    kernels.library()  # loads and binds every entry point


def _max_abs_err(pairs) -> float:
    import torch

    err = 0.0
    for a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"dtype/shape differ: {a.dtype}{tuple(a.shape)} "
                                 f"vs {b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.to(torch.float64) - b.to(torch.float64)).abs().max()))
    return err


def probe_bytes(slot_keys, slot_rows, keys, mask, trips: int) -> int:
    """Bytes the probe must move on these inputs: its keys and mask read
    and its rows written once, plus each distinct 32-byte sector of the table
    that the live rows' walks reach (``slot_rows`` at every slot a walk
    visits, ``slot_keys`` at the occupied ones), walked as the plain version
    walks them."""
    import torch

    from presto_tpu_torch.ops import pallas_hash as ph

    slots = slot_rows.shape[0]
    rows_sectors = torch.zeros(slots * 4 // 32, dtype=torch.bool, device=keys.device)
    keys_sectors = torch.zeros(slots * 8 // 32, dtype=torch.bool, device=keys.device)
    live = mask.nonzero().squeeze(1)
    home = ph._hash_base(keys.unsqueeze(0), slots)[live].long()
    want = keys[live]
    for d in range(trips):
        if live.numel() == 0:
            break
        cand = (home + d) & (slots - 1)
        rows_sectors[cand >> 3] = True
        occupied = slot_rows[cand] >= 0
        keys_sectors[cand[occupied] >> 2] = True
        walking = occupied & (slot_keys[cand] != want)
        live, home, want = live[walking], home[walking], want[walking]
    n = keys.shape[0]
    table = 32 * int(rows_sectors.sum() + keys_sectors.sum())
    return table + n * 8 + n + n * 4


def insert_rounds(device, comps, mask, slots) -> None:
    """The insert kernel's launch shape and its rows pending per round at
    this shape, which must equal what its outputs imply."""
    from presto_tpu_torch.ops import pallas_hash as ph

    cfg = ph.insert_kernel_config(device)
    trips = ph.INSERT_TRIPS
    _sc, _sr, gid, _stats, counts = ph._insert_cuda(comps, mask, slots, trips)
    counts = counts.tolist()
    if counts != ph.insert_round_profile(comps, mask, gid, slots, trips):
        raise AssertionError(f"insert round counts disagree with its outputs: {counts}")
    worked = counts.index(0) if 0 in counts else trips
    tail = 0 if comps.shape[1] <= cfg["tail_rows"] else next(
        (d for d in range(1, worked) if counts[d] <= cfg["tail_rows"]), worked)
    log(f"INSERT grid {cfg['grid_blocks']} blocks x {cfg['block_threads']} threads "
        f"(cooperative); {worked} working rounds, block 0 alone from round {tail} "
        f"(<= {cfg['tail_rows']} rows pending)")
    log(f"INSERT pending rows per round: {counts[:worked + 1]}")


def kernel_inputs(device, n: int = 1 << 21, n_probe: int = 1 << 20) -> dict:
    """The kernels' inputs at the shapes TPC-H Q3 at SF1 gives them, from
    SEED: insert keys with one unique component (the ``orders`` build) and
    with three components, duplicates and masked rows; a probe page of hits,
    misses and masked rows against the unique keys."""
    import torch

    from presto_tpu_torch.ops import pallas_hash as ph

    rng = np.random.RandomState(SEED)
    keys1 = torch.from_numpy(rng.permutation(8 * n)[:n].astype(np.int64) * 32 + 1)
    mask1 = torch.from_numpy(rng.rand(n) < 0.9)
    comps3 = torch.from_numpy(rng.randint(0, 96, size=(3, n)).astype(np.int64))
    mask3 = torch.from_numpy(rng.rand(n) < 0.75)
    hits = keys1[torch.from_numpy(rng.randint(0, n, n_probe // 2))]
    misses = torch.from_numpy(rng.randint(0, 8 * n, n_probe - n_probe // 2) * 32 + 2)
    pkeys = torch.cat([hits, misses])[torch.from_numpy(rng.permutation(n_probe))]
    pmask = torch.from_numpy(rng.rand(n_probe) < 0.9)
    on = lambda t: t.contiguous().to(device)  # noqa: E731
    return {"n": n, "slots": ph.table_slots(n), "comps1": on(keys1.unsqueeze(0)),
            "mask1": on(mask1), "comps3": on(comps3), "mask3": on(mask3),
            "pkeys": on(pkeys), "pmask": on(pmask)}


def check_kernels(device, reps: int = 20, plain_reps: int = 3):
    """Each kernel against its plain version on the same tensors; returns
    {kernel: measurements}."""
    import torch

    from presto_tpu_torch.ops import pallas_hash as ph

    inp = kernel_inputs(device)
    n, slots = inp["n"], inp["slots"]
    comps1, mask1, comps3, mask3 = (inp[k] for k in ("comps1", "mask1", "comps3", "mask3"))
    out = {}

    err = 0.0
    for comps, mask in ((comps1, mask1), (comps3, mask3)):
        got = ph.insert_table(comps, mask, slots)
        want = ph.insert_table_reference(comps, mask, slots)
        e = _max_abs_err(zip(got, want))
        if e != 0:
            raise AssertionError(f"insert kernel differs from its plain version: {e}")
        err = max(err, e)
        stats = got[3].tolist()
        log(f"KERNEL insert ncomps={comps.shape[0]} n={n} slots={slots}: bit-identical, "
            f"stats [overflow, max_run, distinct] = {stats}")
    slot_comps, slot_rows, _gid, stats = ph.insert_table(comps1, mask1, slots)
    if stats[0].item() != 0:
        raise AssertionError("unique-key insert overflowed")
    insert_rounds(device, comps1, mask1, slots)
    ms = time_ms(lambda: ph.insert_table(comps1, mask1, slots), reps, device)
    plain_ms = time_ms(lambda: ph.insert_table_reference(comps1, mask1, slots),
                       plain_reps, device)
    nbytes = n * 8 + n + slots * 8 + slots * 4 + n * 4 + 3 * 4
    out["insert"] = {"max_abs_err": err, "ms": ms,
                     "device_ms": device_ms(lambda: ph.insert_table(comps1, mask1, slots),
                                            reps, "ht_insert_"),
                     "plain_ms": plain_ms, "bound_ms": nbytes / HBM_RATE * 1e3,
                     "bytes": nbytes}

    # probe: hits, misses and masked rows against the unique-key table
    trips = ph.probe_trips_for(int(stats[1].item()))
    pkeys, pmask = inp["pkeys"], inp["pmask"]
    n_probe = pkeys.shape[0]
    got = ph.probe_table(slot_comps[0], slot_rows, pkeys, pmask, trips)
    want = ph.probe_table_reference(slot_comps[0], slot_rows, pkeys, pmask, trips)
    err = _max_abs_err([(got, want)])
    if err != 0:
        raise AssertionError(f"probe kernel differs from its plain version: {err}")
    hit = got >= 0
    if not (hit.any() and (~hit & pmask).any() and (got[~pmask] == -1).all()):
        raise AssertionError("probe inputs did not cover hits, misses and masked rows")
    if not torch.equal(comps1[0][got[hit].long()], pkeys[hit]):
        raise AssertionError("probe hit rows hold other keys")
    log(f"KERNEL probe slots={slots} n={n_probe} trips={trips}: bit-identical, "
        f"{int(hit.sum())} hits")
    ms = time_ms(lambda: ph.probe_table(slot_comps[0], slot_rows, pkeys, pmask, trips),
                 reps, device)
    plain_ms = time_ms(lambda: ph.probe_table_reference(slot_comps[0], slot_rows, pkeys,
                                                        pmask, trips), plain_reps, device)
    nbytes = probe_bytes(slot_comps[0], slot_rows, pkeys, pmask, trips)
    out["probe"] = {"max_abs_err": err, "ms": ms,
                    "device_ms": device_ms(lambda: ph.probe_table(slot_comps[0], slot_rows,
                                                                  pkeys, pmask, trips),
                                           reps, "ht_probe_rows"),
                    "plain_ms": plain_ms, "bound_ms": nbytes / HBM_RATE * 1e3,
                    "bytes": nbytes}
    for name, m in out.items():
        log(f"TIME {name}: kernel {m['ms']:.4f} ms (wrapper call, CUDA events; device "
            f"time {m['device_ms']:.4f} ms), plain {m['plain_ms']:.4f} ms, "
            f"bound {m['bound_ms']:.4f} ms ({m['bytes']} bytes at {HBM_RATE:.3g} B/s)")
    return out


def oracle_q3(schema: str):
    """TPC-H Q3 in numpy over the port's generator: rows as Python values,
    and the number of source rows it read."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.ops.expressions import days_from_civil

    sf = SCHEMAS[schema]
    cut = days_from_civil(1995, 3, 15)
    c = g.generate_rows("customer", 0, g.table_row_count("customer", sf), sf,
                        ["c_custkey", "c_mktsegment"])
    building = c["c_custkey"][c["c_mktsegment"] == g.DICT_SEGMENT.code_of("BUILDING")]
    n_orders = g.table_row_count("orders", sf)
    o = g.generate_rows("orders", 0, n_orders, sf,
                        ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])
    keep = (o["o_orderdate"] < cut) & np.isin(o["o_custkey"], building)
    order = np.argsort(o["o_orderkey"][keep], kind="stable")
    okey = o["o_orderkey"][keep][order]
    odate = o["o_orderdate"][keep][order]
    oprio = o["o_shippriority"][keep][order]
    li = g.lineitem_for_orders(0, n_orders, sf, ["l_orderkey", "l_shipdate",
                                                 "l_extendedprice", "l_discount"])
    lk = li["l_shipdate"] > cut
    lkey = li["l_orderkey"][lk]
    pos = np.clip(np.searchsorted(okey, lkey), 0, max(len(okey) - 1, 0))
    hit = okey[pos] == lkey if len(okey) else np.zeros(len(lkey), bool)
    rev = li["l_extendedprice"][lk][hit].astype(np.int64) * \
        (100 - li["l_discount"][lk][hit].astype(np.int64))
    groups, inv = np.unique(lkey[hit], return_inverse=True)
    sums = np.zeros(len(groups), dtype=np.int64)
    np.add.at(sums, inv, rev)
    gpos = np.searchsorted(okey, groups)
    gdate, gprio = odate[gpos], oprio[gpos]
    top = np.lexsort((groups, gdate, -sums))[:10]
    epoch = datetime.date(1970, 1, 1)
    rows = [[int(groups[i]), Decimal(int(sums[i])) / 10 ** 4,
             epoch + datetime.timedelta(days=int(gdate[i])), int(gprio[i])] for i in top]
    return rows, len(c["c_custkey"]) + n_orders + len(li["l_orderkey"])


def run_q3_phase(device, schema: str = "sf1"):
    """Q3 through the port's entry point; returns the launch counts of the
    warm run and its measurements."""
    import torch

    from presto_tpu_torch.models.hand_queries import run_q3
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.utils.metrics import METRICS

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    run_q3(schema, device=device, hash_kernels="auto")  # cold: generates the data
    sync()
    cold_s = time.perf_counter() - t0

    before = METRICS.snapshot("pallas.")
    ph.insert_table.launches = 0
    ph.probe_table.launches = 0
    t0 = time.perf_counter()
    rows = run_q3(schema, device=device, hash_kernels="auto")
    sync()
    warm_s = time.perf_counter() - t0
    launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
    after = METRICS.snapshot("pallas.")
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("pallas.join_builds", "pallas.join_fallbacks")}
    log(f"Q3 {schema} launches on the warm run: {launches}; counters {delta}")
    if device.type == "cuda" and (launches["insert"] < 1 or launches["probe"] < 1):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if device.type == "cuda" and delta != {"pallas.join_builds": 1,
                                           "pallas.join_fallbacks": 0}:
        raise AssertionError(f"the orders build did not take the kernel path: {delta}")

    want, source_rows = oracle_q3(schema)
    if rows != want:
        raise AssertionError(f"Q3 rows differ from the numpy oracle:\n{rows}\n{want}")
    t0 = time.perf_counter()
    sorted_rows = run_q3(schema, device=device, hash_kernels="sorted")
    sync()
    sorted_s = time.perf_counter() - t0
    if rows != want or sorted_rows != want:
        raise AssertionError("Q3 rows of the sorted strategy differ")
    log(f"Q3 {schema}: {len(rows)} rows equal to the numpy oracle and to the sorted run")
    for r in rows:
        log(f"  {r[0]} | {r[1]} | {r[2]} | {r[3]}")
    log(f"Q3 {schema} cold wall {cold_s:.3f}s; warm wall {warm_s:.4f}s = "
        f"{source_rows / warm_s:.0f} source rows/s ({source_rows} rows); "
        f"sorted-build warm wall {sorted_s:.4f}s")
    return launches


def profile_q3(device, schema: str = "sf1", top: int = 12, run=None,
               label: str = "Q3") -> None:
    """One more warm Q3 under torch.profiler (``run``, default the hand-built
    Q3): the device's busy share of the wall, the CUDA kernels that took the
    most device time, and the device launches of the insert kernel for each
    insert call (at most 3)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from presto_tpu_torch.models.hand_queries import run_q3
    from presto_tpu_torch.ops import pallas_hash as ph

    if run is None:
        def run():
            return run_q3(schema, device=device, hash_kernels="auto")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    calls = ph.insert_table.launches
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    calls = ph.insert_table.launches - calls
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    insert_kern = [e.name for e in kern if "ht_insert_" in e.name]
    log(f"PROFILE {label} {schema}: {len(insert_kern)} insert-kernel device launches for "
        f"{calls} insert call(s): {sorted(set(n[:60] for n in insert_kern))}")
    if calls < 1 or not 1 <= len(insert_kern) <= 3 * calls:
        raise AssertionError(f"insert device launches {len(insert_kern)} for {calls} calls")
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    log(f"PROFILE {label} {schema}: wall {wall_us / 1e3:.1f} ms under the profiler, device "
        f"kernels {busy_us / 1e3:.1f} ms in {len(kern)} launches, device idle share "
        f"{1 - busy_us / wall_us:.3f}")
    host = sorted((e for e in prof.key_averages() if e.cpu_time_total > 0),
                  key=lambda e: -e.cpu_time_total)
    for e in host[:6]:
        log(f"  host {e.cpu_time_total / 1e3:9.3f} ms {e.count:6d}x {e.key[:100]}")
    by_name = {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {t / 1e3:9.3f} ms {c:6d}x {name[:110]}")


def oracle_q1(schema: str):
    """TPC-H Q1 in numpy over the port's generator: rows as Python values
    (exact decimals; the averages as floats of their exact ratios), and the
    number of source rows it read."""
    from fractions import Fraction

    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.ops.expressions import days_from_civil

    sf = SCHEMAS[schema]
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                                "l_returnflag", "l_linestatus", "l_shipdate"])
    keep = li["l_shipdate"] <= days_from_civil(1998, 12, 1) - 90
    col = {k: v[keep].astype(np.int64) for k, v in li.items()}
    disc_price = col["l_extendedprice"] * (100 - col["l_discount"])  # scale 4
    charge = disc_price * (100 + col["l_tax"])                         # scale 6
    flags, stats = g.DICT_RETURNFLAG.values, g.DICT_LINESTATUS.values
    groups = sorted({(flags[f], stats[s]) for f, s in
                     zip(*np.unique(np.stack([col["l_returnflag"], col["l_linestatus"]]),
                                    axis=1))})
    rows = []
    for f, s in groups:
        sel = (col["l_returnflag"] == g.DICT_RETURNFLAG.code_of(f)) & \
              (col["l_linestatus"] == g.DICT_LINESTATUS.code_of(s))
        n = int(sel.sum())
        qty, price, disc = (int(col[c][sel].sum()) for c in
                            ("l_quantity", "l_extendedprice", "l_discount"))
        rows.append([f, s, Decimal(qty) / 100, Decimal(price) / 100,
                     Decimal(int(disc_price[sel].sum())) / 10 ** 4,
                     Decimal(int(charge[sel].sum())) / 10 ** 6,
                     float(Fraction(qty, 100 * n)), float(Fraction(price, 100 * n)),
                     float(Fraction(disc, 100 * n)), n])
    return rows, len(keep)


def oracle_q6(schema: str):
    """TPC-H Q6 in numpy over the port's generator."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.ops.expressions import days_from_civil

    sf = SCHEMAS[schema]
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"])
    col = {k: v.astype(np.int64) for k, v in li.items()}
    keep = (col["l_shipdate"] >= days_from_civil(1994, 1, 1)) & \
        (col["l_shipdate"] < days_from_civil(1995, 1, 1)) & \
        (col["l_discount"] >= 5) & (col["l_discount"] <= 7) & (col["l_quantity"] < 2400)
    rev = int((col["l_extendedprice"][keep] * col["l_discount"][keep]).sum())
    return [[Decimal(rev) / 10 ** 4 if keep.any() else None]], len(keep)


SQL_ORACLES = {1: oracle_q1, 3: oracle_q3, 6: oracle_q6}


def same_rows(got, want) -> bool:
    """Equal rows in order: exact, but for floats (DOUBLE_REL_TOL)."""
    import math

    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if not (isinstance(a, float) and isinstance(b, float)
                        and math.isclose(a, b, rel_tol=DOUBLE_REL_TOL, abs_tol=0.0)):
                    return False
            elif type(a) is not type(b) or a != b:
                return False
    return True


def sql_runner(device, hash_kernels: str, schema: str):
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    return LocalQueryRunner(Session(catalog="tpch", schema=schema,
                                    properties={"hash_kernels": hash_kernels}),
                            device=device)


class GroupingCapture:
    """Records, while on, the first page the SQL Q3 grouping sends through
    the insert (its key components, live rows and slots) and the first
    page's group count that sized the table."""

    def __enter__(self):
        from presto_tpu_torch.ops import hash_agg

        cls = hash_agg.GroupedAggregationBuilder
        self.cls, self.partial, self.decide = cls, cls._page_hash_partial, cls._decide_strategy
        self.first_ng = self.slots = self.comps = self.mask = None
        cap = self

        def decide(builder, first_ng, capacity):
            cap.first_ng = first_ng if cap.first_ng is None else cap.first_ng
            return cap.decide(builder, first_ng, capacity)

        def partial(builder, page, slots):
            if cap.comps is None:
                import torch

                keys = hash_agg._null_safe_keys(page, builder._key_channels)
                cap.comps = torch.stack([k.to(torch.int64) for k in keys]).contiguous()
                cap.mask, cap.slots = page.mask.contiguous(), slots
            return cap.partial(builder, page, slots)

        cls._page_hash_partial, cls._decide_strategy = partial, decide
        return self

    def __exit__(self, *exc):
        self.cls._page_hash_partial, self.cls._decide_strategy = self.partial, self.decide
        return False


def run_sql_phase(device, schema: str = "sf1"):
    """Q1, Q3 and Q6 as SQL through the port's LocalQueryRunner with
    ``hash_kernels="pallas"``; returns the kernel launches of the warm Q3 run
    and the captured grouping input."""
    import torch

    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.utils.metrics import METRICS

    names = ("pallas.join_builds", "pallas.join_fallbacks", "pallas.agg_pages",
             "pallas.agg_fallbacks")
    q3_launches, capture = None, None
    for q in (1, 3, 6):
        runner = sql_runner(device, "pallas", schema)
        t0 = time.perf_counter()
        if q == 3:
            with GroupingCapture() as capture:
                runner.execute(QUERIES[q])
        else:
            runner.execute(QUERIES[q])
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        before = {k: METRICS.counter_value(k) for k in names}
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        t0 = time.perf_counter()
        rows = runner.execute(QUERIES[q]).rows
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        delta = {k: METRICS.counter_value(k) - before[k] for k in names}
        if q == 3:
            log(f"SQL Q3 {schema} launches on the warm run: {launches}; counters {delta}")
            builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
            if builds != 2 or delta["pallas.join_fallbacks"] != 0:
                raise AssertionError(f"the two Q3 builds did not both take the table: {delta}")
            on_card = device.type == "cuda"
            if pages < 1 or (on_card and launches["insert"] != builds + pages):
                raise AssertionError(f"insert launches {launches['insert']} != join builds "
                                     f"{builds} + grouped pages {pages}")
            if on_card and launches["probe"] < 2:
                raise AssertionError(f"fewer than one probe per probe stream: {launches}")
            q3_launches = launches
        want, source_rows = SQL_ORACLES[q](schema)
        if not same_rows(rows, want):
            raise AssertionError(f"SQL Q{q} rows differ from the numpy oracle:\n{rows}\n{want}")
        t0 = time.perf_counter()
        sorted_rows = sql_runner(device, "sorted", schema).execute(QUERIES[q]).rows
        torch.cuda.synchronize()
        sorted_s = time.perf_counter() - t0
        if not same_rows(sorted_rows, want):
            raise AssertionError(f"SQL Q{q} rows under hash_kernels='sorted' differ")
        log(f"SQL Q{q} {schema}: {len(rows)} rows equal to the numpy oracle and to the "
            f"sorted run; cold wall {cold_s:.3f}s; warm wall {warm_s:.4f}s = "
            f"{source_rows / warm_s:.0f} source rows/s ({source_rows} rows); sorted run "
            f"{sorted_s:.4f}s")
        for r in rows[:4]:
            log("  " + " | ".join(str(v) for v in r))
    runner = sql_runner(device, "pallas", schema)
    profile_q3(device, schema, run=lambda: runner.execute(QUERIES[3]), label="SQL Q3")
    return q3_launches, capture


def sql_layers(device, schema: str = "sf1") -> None:
    """Where a warm SQL query's wall goes, on the host clock: parse, analyze,
    plan and optimize; local planning; execution (ending in a sync); result
    rows; and each operator's host time in add_input/get_output (device
    work it waits for included, finishes not)."""
    import torch

    from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
    from presto_tpu_torch.exec.task_executor import TaskExecutor
    from presto_tpu_torch.models.tpch_sql import QUERIES

    for q in (1, 3, 6):
        runner = sql_runner(device, "pallas", schema)
        runner.execute(QUERIES[q])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = runner.plan_sql(QUERIES[q])
        t1 = time.perf_counter()
        exec_plan = LocalExecutionPlanner(runner.metadata, runner.session, device).plan(plan)
        drivers = exec_plan.create_drivers()
        t2 = time.perf_counter()
        TaskExecutor().execute(drivers)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        exec_plan.sink.rows()
        t4 = time.perf_counter()
        log(f"LAYERS SQL Q{q} {schema}: parse+analyze+plan+optimize {(t1 - t0) * 1e3:.2f} ms, "
            f"local planning {(t2 - t1) * 1e3:.2f} ms, execution {(t3 - t2) * 1e3:.2f} ms, "
            f"result rows {(t4 - t3) * 1e3:.2f} ms")
        for pi, d in enumerate(drivers):
            for op in d.operators:
                st = op.context.stats
                log(f"  pipeline {pi} {st.name:<24} host "
                    f"{(st.add_input_ns + st.get_output_ns) / 1e6:9.3f} ms; pages in "
                    f"{st.input_pages}, out {st.output_pages}")


def check_grouping_insert(device, capture, reps: int = 20, plain_reps: int = 3) -> None:
    """The insert at the shape the SQL Q3 grouping gives it, against its
    plain version (bit for bit), with its times and bound."""
    from presto_tpu_torch.ops import pallas_hash as ph

    comps, mask, slots = capture.comps, capture.mask, capture.slots
    if comps is None:
        raise AssertionError("the SQL Q3 grouping sent no page through the insert")
    got = ph.insert_table(comps, mask, slots)
    want = ph.insert_table_reference(comps, mask, slots)
    err = _max_abs_err(zip(got, want))
    if err != 0:
        raise AssertionError(f"grouping-shape insert differs from its plain version: {err}")
    ncomps, n = comps.shape
    stats = got[3].tolist()
    ms = time_ms(lambda: ph.insert_table(comps, mask, slots), reps, device)
    dev_ms = device_ms(lambda: ph.insert_table(comps, mask, slots), reps, "ht_insert_")
    plain_ms = time_ms(lambda: ph.insert_table_reference(comps, mask, slots), plain_reps,
                       device)
    # what this page needs: the mask, the live rows' key components, every
    # row's group id, and the table
    live = int(mask.sum())
    nbytes = n + live * ncomps * 8 + n * 4 + ncomps * slots * 8 + slots * 4 + 3 * 4
    log(f"KERNEL insert at the SQL Q3 grouping shape: ncomps={ncomps} n={n} "
        f"live={live} slots={slots} (first page {capture.first_ng} groups): "
        f"bit-identical, stats [overflow, max_run, distinct] = {stats}")
    log(f"TIME insert (grouping shape): kernel {ms:.4f} ms (wrapper call, CUDA events; "
        f"device time {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{nbytes / HBM_RATE * 1e3:.4f} ms ({nbytes} bytes at {HBM_RATE:.3g} B/s)")
    insert_rounds(device, comps, mask, slots)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "presto_tpu_torch")):
        print("chip_smoke: presto_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"DEVICE {name} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {card}")
    try:
        build_kernels()
        measured = check_kernels(device)
        run_q3_phase(device)
        profile_q3(device)
        launches, capture = run_sql_phase(device)
        sql_layers(device)
        check_grouping_insert(device, capture)
    except Exception:  # a failed phase: report it and print no result
        import traceback

        traceback.print_exc()
        return 1
    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": TPU_KERNELS[k], "launches": launches[k],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": "bytes", "library_ms": None}
               for k, m in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
