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
   ``LocalQueryRunner(device="cuda")`` with ``hash_kernels="pallas"`` under
   the session defaults (fused segments, coalesced pages): a cold and a
   warm run each, rows equal to a numpy-only oracle over the port's
   generator (exact for decimals, dates and strings; DOUBLE to a relative
   1e-12), to the query run with ``segment_fusion`` and ``coalesce_pages``
   off, and to the query under ``hash_kernels="sorted"``. The launch
   counters and the ``pallas.`` metrics are set to 0 just before each warm
   run and read just after; for Q3: both joins built on the table
   (``pallas.join_builds == 2``, no fallback), no page grouped through the
   insert (the fused grouping takes the sort partial), insert launches
   equal to ``join_builds + agg_pages`` and at least one probe launch per
   probe stream; then one more warm SQL Q3, fused and unfused, under
   ``torch.profiler``, and one more warm run of each query timed layer by
   layer on the host clock;
7. hold the insert against its plain version, bit for bit, at the shape the
   unfused SQL Q3 grouping gives it (its first hash-grouped page: the key
   components, the live rows, and the slots the first page's group count
   sized), and time it;
8. run TPC-H Q5, Q9 and Q13 as SQL at SF1 the same way (multi-key joins,
   duplicate-key INNER and LEFT expansion, LIKE), with numpy-only oracles:
   the unique single-key builds on the table (Q5 3, Q9 4, Q13 0), no
   fallback, insert launches equal to ``join_builds + agg_pages``, and each
   table probed by the probe kernel at least once. Q5's unfused and sorted
   runs go at ``tiny`` (``Q5_REPEATS_SCHEMA``: its SF1 runs take 20-40 s
   each), beside one fused run there, and it prints the seconds that
   saves; its cold and warm runs stay at SF1 against the numpy Q5. Q5
   prints its expansion chunks, expanded rows and peak device memory; Q9
   and Q13 get a profiler
   pass; all three get the host-clock layers. Both kernels are held against
   their plain versions at the shapes the unfused Q9 gives them;
9. the default path of Q1, Q3, Q5, Q6, Q9 and Q13, from the warm runs of
   phases 6 and 8: each query's fused segments (operators, dispatches,
   compositions, probe-kernel launches inside the segment), the coalescing's
   pages in and out, and the warm walls fused and unfused. Fails unless the
   segments' operator lists are those the tier-1 tests pin at schema tiny,
   a fused segment launched the probe kernel in Q3, Q5 and Q9, insert
   launches equal ``join_builds + agg_pages``, Q3 and Q9 grouped no page
   through the insert, and nothing fell back. Each query but Q5 then runs
   three more times fused and three unfused, in turns. The probe kernel is held
   against its plain version, bit for bit, at the shape the fused probe
   stage gives it (the fused Q3's first probe page, coalesced), and timed;
10. a scan stage that fails on a pool thread must surface in the consumer
   (``ScanPipeline._fail``) and stay raised;
11. all 22 TPC-H queries as SQL at SF1 with ``hash_kernels="pallas"`` under the full
   defaults: four drivers per cut pipeline, the staged scan and the
   resident page cache. Each query runs cold (cache cleared first) and warm
   (a resident replay; launch counters and ``COUNTERS`` set to 0 just
   before it), phases 6 and 8 giving these runs for their queries; then
   under the oracle properties ``driver_parallelism=1, scan_pipeline=False``
   (cold and warm; Q5 once, at ``tiny``, against its fused run there). Fails unless the rows equal the oracle's, the
   warm run replayed resident pages and staged none, the insert launched
   once per join build and grouped page, a query that built a table probed
   it with the kernel, nothing fell back, Q18's inner grouping spilled to
   host RAM, and Q14 (CASE, decimal division) and Q22 (substr, scalar
   subquery, ANTI join) equal their numpy oracles. Prints per query the
   drivers per pipeline, the cold run's scan stage seconds, the resident
   pages replayed, the launches and the walls, Q18's host merge seconds
   and Q21's filtered semi-probe pages and chunks. Both kernels are held
   against their plain versions, bit for bit, at the shapes the cold runs
   of Q15 (its one-row ``max`` build among them), Q17 (the build of its
   grouping's result, one page of 2^22 rows) and Q21 gave them. Then
   each query runs at ``tiny`` on the card and in the port's CPU run, with
   equal rows (``CPU_ROWS_SCHEMA``; these host checks once ran at SF1);
12. all 22 TPC-DS queries of ``models/tpcds_sql.py`` (Q64 and Q72 among
   them) as SQL at ``tpcds.sf1`` with ``hash_kernels="pallas"`` under the
   full defaults: cold, warm (counters set to 0 just before it) and once
   under the oracle properties, with equal rows. A TPC-DS scan has no cache
   token, so the warm run regenerates its pages (it must replay none).
   Fails unless the insert launched once per join build and grouped page,
   a query that built a table probed it with the kernel, and nothing fell
   back. Prints per query the drivers per pipeline, the walls, the warm
   scan stage seconds, the launches and builds. Q64 and Q72 also print
   their expansion chunks, expanded rows and peak device memory, get a
   profiler pass, and hold both kernels against their plain versions, bit
   for bit, at the shapes of their cold runs' largest build and first
   probe page. Then each runs at ``tiny`` on the card and in the port's CPU
   run, with equal rows; the ``PHASE`` line after it gives the host
   checks' seconds and what running them at ``tiny`` saves against the
   SF1 runs they replace;
13. five set operations at ``tpch.sf1`` (UNION ALL of two date-disjoint
   ``lineitem`` selections grouped by ``l_returnflag``; customers EXCEPT
   order customers; an INTERSECT of early order customers with BUILDING
   customers; a ROLLUP of ``lineitem``; a UNION of ``n_name`` and
   ``r_name``, whose dictionaries differ, so one branch remaps its
   codes), cold and warm, each against a numpy oracle and the CPU run;
14. windows, FULL joins and the new aggregates at ``tpch.sf1``
   (``P14_SQL``): two window specifications over ``orders`` and the top 3
   lines of each order with ``lag`` over ``lineitem`` (one 8 x 2^20-row
   page; peak device memory printed), ``orders full join customer`` (a
   unique build: the customers without orders come from the epilogue) and
   ``customer full join orders`` (a duplicate-key build), a ``lineitem``
   dashboard of ``approx_distinct``, ``approx_percentile``, ``stddev``,
   ``var_pop``, ``corr``, ``min_by``, ``max_by``, ``bool_and``,
   ``count_if`` and ``arbitrary`` grouped by flag and status and global, a
   per-day DATE grouping (``min_by``, ``stddev``, ``count_if``) that must
   take the insert kernel, and a sketch grouping above 8,192 groups that
   must spill. Each runs cold and warm (counters set to 0 just before it)
   and on the CPU; the rows must equal a numpy oracle (``check_p14_rows``:
   exact where the result is, the sketches within their error bounds,
   ``min_by``/``max_by`` a row holding the extreme, the statistics to
   ``STAT_REL_TOL``) and the CPU run's; nothing may fall back. The insert
   is held against its plain version at the per-day grouping's shape.
   Prints one ``WINDOW``/``FULLJOIN``/``AGG`` line per query;
15. writes at ``tpch.sf1`` (``run_write_phase``), in one runner: CTAS of
   ``lineitem`` (6,001,215 rows on 4 scaled writer drivers), ``orders`` and
   ``customer`` into ``memory`` (cold, then dropped and written warm),
   their host pages, bytes and pinning, and a warm scan of the stored
   ``lineitem`` against unpinned copies of its pages; Q3 over the written
   tables (sorted builds) and mixed (the stored ``lineitem`` probing
   ``tpch``'s tables: join builds, probe launches, no fallback), both
   equal to the numpy Q3, with the probe held bit-identical to its plain
   version at the first stored page's shape; a CTAS of Q3 read back in
   order; INSERT SELECT of the 1998 lines (count against numpy); INSERT
   VALUES of a NULL and a new shipping mode into a narrow table (the
   dictionary grows out of order; min/max and the new value's count before
   and after; the full ``lineitem`` refuses a VALUES row as the reference
   does); a blackhole CTAS; ``array_agg`` with ``cardinality`` per
   customer, ``histogram`` per flag and status, ``map_agg`` per region
   (multisets against numpy); one query of every new scalar function over
   ``lineitem`` (numpy: DECIMAL exact, DOUBLE sums to 1e-9); DROP of
   every table. Prints ``WRITE`` lines (walls, rows per second, writer
   drivers, pages, host bytes);
16. the plugin libraries, EXPLAIN ANALYZE and memory revocation at
   ``tpch.sf1`` (``run_memory_phase``), with ``hash_kernels="pallas"``:
   EXPLAIN ANALYZE of Q3, Q9 and Q18 under the defaults, whose header's
   driver count must equal the drivers the plan makes and whose every
   operator's input and output rows must equal a plain run's (the table
   printed on ``EXPLAIN`` lines); Q3, Q18 and the ``window orders`` query
   of phase 14 under ``memory_pool_bytes=1``, cold and warm, against the
   numpy Q3, phase 11's card rows of Q18 and ``check_p14_rows``: something
   must be revoked (``memory.spill`` events, bytes moved to host), nothing
   may fall back, and Q3's warm launches must equal its unpressured run's
   with both builds on the table (revoked build pages come back to the
   card before the insert); Q1 under a ``query_max_memory_bytes`` of a
   quarter of its accounted peak must raise ``ExceededMemoryLimitException``,
   journal ``query.memory_exceeded`` and leave the pool without the query;
   the accounted peak (the query's pool ledger at its most, ``PoolPeak``)
   beside ``torch.cuda.max_memory_allocated`` for Q3, Q9 and TPC-DS Q64;
   and the plugin functions over ``lineitem`` (``P16_SQL``: ``st_contains``
   of a constant polygon over ``st_point``, ``st_distance``, ``st_y``,
   ``great_circle_distance``, ``index``/``char2hexint``/``reverse`` over
   ``l_shipmode``, ``regr_*``, ``learn_linear_regressor`` then
   ``regress``) against numpy (``oracle_plugins``: counts and strings
   exact, DOUBLE to ``PLUGIN_REL_TOL``). Prints ``EXPLAIN``, ``MEMORY`` and
   ``PLUGIN`` lines. With the disk rung on by default, Q3's and Q18's
   revoked bytes must reach disk (PCOL bytes written and read back) and the
   window's must stay in host RAM; each ``MEMORY`` line names the rung;
17. the flight recorder, the metrics histograms and the disk rung at
   ``tpch.sf1`` (``run_flight_phase``), with ``hash_kernels="pallas"``: Q3
   and Q9 with ``query_trace`` from cold scans (rows equal to plain runs;
   the Chrome trace loads, the ``lifecycle`` spans ``query`` enclose
   ``parse``, ``plan``, ``local_plan`` and ``execute``, and ``driver``,
   ``operator``, ``segment``, ``scan`` and ``pool`` spans are there);
   ``TRACE`` lines give the spans per category, the drops,
   ``overlap_ratio(scan, driver)`` and each category's merged busy seconds
   as a share of ``execute``; the warm walls of 7 turns of Q3 and Q9 under
   the black box, with it off and with a full trace (the modes in turns;
   printed, not gated); Q1
   over a quarter of its accounted peak must fail with a forensic trace on
   the exception and ``query.forensic_dumped`` journaled, and a successful
   Q6 must write nothing; Q3 and Q18 under ``memory_pool_bytes=1``, cold
   and warm with the disk rung, and warm with ``spill_to_disk=False``:
   rows equal to the numpy Q3 and phase 11's Q18, ``query.spill.disk``
   runs and every PCOL byte written read back, launches equal to the
   unpressured run's (the runs came back to the card before the insert),
   the native ``libpcol`` opened every run, no spill directory or ledger
   byte left; an injected ``spill.write`` fault fails only its query, with
   ``query.spill.failed`` and a forensic trace, and the next Q3 runs clean;
   ``query.wall_s`` must count every statement of the phase that
   completed. Prints ``TRACE``, ``FORENSIC``, ``SPILL``, ``FAULT`` and
   ``HIST`` lines;
18. print the kernels line (JSON, with each kernel's warm-run launches per
   SQL query under ``launches_by_query``: TPC-H as ``SQL Q3``, TPC-DS as
   ``SQL DS Q64``, the set operations as ``SQL SETOP rollup``, phase 14 as
   ``SQL P14 agg per day``, phase 15 as ``SQL WRITE q3 mixed``, phase 16 as
   ``SQL EXPLAIN q3``, ``SQL MEM q3 pressured`` and ``SQL PLUGIN geo``,
   phase 17 as ``SQL TRACE q3``, counted on the cold traced run, and ``SQL
   SPILL q18 disk``), the card line, and last the result line.

The phases of 6-9 run under the session defaults too, so on the card each
cut pipeline runs as four drivers (``driver_parallelism`` AUTO) and every
warm run replays the resident page cache.

A ``PHASE`` line after each group of phases gives its seconds. Exits
non-zero, printing no result, when CUDA is absent, when the package is not
beside the script, or when any phase fails. It imports nothing of JAX.
"""
from __future__ import annotations

import datetime
import gc
import json
import os
import subprocess
import sys
import time
from decimal import Decimal
from typing import Optional

import numpy as np

SEED = 20261017
# DOUBLE columns (Q1's averages) sum float64 contributions with atomics, in
# an order that changes from run to run; every other column is exact
DOUBLE_REL_TOL = 1e-12
# device-memory rate of an H100 SXM, bytes/s (NVIDIA's data sheet)
HBM_RATE = 3.35e12
# device_ms: clock cycles of the spin kernel that holds the stream while a
# bracketed call is queued (about 10 ms on an H100)
SPIN_CYCLES = 20_000_000
TPU_KERNELS = {"insert": "presto_tpu/ops/pallas_hash.py:197",
               "probe": "presto_tpu/ops/pallas_hash.py:261"}
KERNEL_SOURCE = "presto_tpu_torch/kernels/hash_table.cu"
# the unfused, uncoalesced pipeline: the differential oracle of the default one
UNFUSED = {"segment_fusion": False, "coalesce_pages": False}
_LJ, _FP, _HA = "LookupJoin(inner)", "FilterProject", "HashAggregation(single)"
# each query's fused segments under the card's defaults (four drivers per cut
# pipeline: the probes run in the producers, the grouping after the
# exchange), as the plan at schema tiny with driver_parallelism=4 gives them
# (the plan does not depend on the scale)
SEGMENT_OPERATORS = {1: [], 6: [], 3: [[_LJ, _LJ, _FP, _HA]], 5: [[_LJ] * 3],
                     9: [[_LJ] * 3, [_LJ, _FP]], 13: [[_FP, _HA]]}
# every TPC-H query the port runs as SQL: all 22
PORTED_QUERIES = tuple(range(1, 23))
# Q5's repeats (unfused, sorted, the oracle properties) run at this schema;
# its cold and warm runs under the defaults stay at SF1 against oracle_q5
Q5_REPEATS_SCHEMA = "tiny"
# phase 11 holds both kernels at the shapes these queries' cold runs give them
PATH_KERNEL_QUERIES = (15, 17, 21)
# the oracle of the default path: one driver per pipeline, the serial scan
ORACLE_PROPS = {"driver_parallelism": 1, "scan_pipeline": False}
# the queries whose fused segments probe an open-addressing table
FUSED_PROBE_QUERIES = (3, 5, 9)
COUNTERS = ("pallas.join_builds", "pallas.join_fallbacks", "pallas.agg_pages",
            "pallas.agg_fallbacks", "join.expansion_chunks", "join.expanded_rows",
            "coalesce.pages_in", "coalesce.pages_out", "join.semi_pages", "join.semi_chunks")


def civil_day(year: int, month: int, day: int) -> int:
    """Days since 1970-01-01, for the numpy oracles (the port's own date
    helper stays out of them)."""
    return (datetime.date(year, month, day) - datetime.date(1970, 1, 1)).days


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


def device_ms(wrapper, args, reps: int) -> float:
    """Device time of one call of ``wrapper(*args)``: the median over
    ``reps`` calls of the time between two CUDA events recorded around the
    call while a spin kernel (``torch.cuda._sleep``) holds the stream, so
    that the events bracket the call's kernels and not the host's launch
    cost, less the median of the same bracket around nothing. A bracket
    whose spin ran out before it was queued (the host thread stalled, for
    instance waiting for the interpreter lock) is not device time and is
    taken again, up to ``reps`` times in all; then it raises. It also fails
    unless the wrapper counts one launch per call. (``torch.profiler`` lost
    kernel records in short windows, more of them the longer the process
    had profiled; PERF.md section 6.)"""
    import torch

    retakes = 0

    def span(call) -> float:
        nonlocal retakes
        while True:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            call()
            end.record()
            late = start.query()
            torch.cuda.synchronize()
            if not late:
                return start.elapsed_time(end)
            retakes += 1
            if retakes > reps:
                raise AssertionError(f"{wrapper.__name__}: the spin kernel ran out before "
                                     f"the bracket was queued {retakes} times")

    wrapper(*args)
    torch.cuda.synchronize()
    launches = wrapper.launches
    gc.disable()  # as timeit does: a collection would stall the host thread
    try:
        busy = [span(lambda: wrapper(*args)) for _ in range(reps)]
        calls = wrapper.launches - launches
        if calls != reps + retakes:  # a retaken bracket calls the wrapper again
            raise AssertionError(f"{wrapper.__name__}: {calls} launches for {reps} calls "
                                 f"and {retakes} retaken")
        idle = [span(lambda: None) for _ in range(reps)]
    finally:
        gc.enable()
    if retakes:
        log(f"DEVICE_MS {wrapper.__name__}: {retakes} bracket(s) retaken")
    return float(np.median(busy) - np.median(idle))


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
    """Bytes the probe must move on these inputs: its mask read and its rows
    written once, each distinct 32-byte sector of ``keys`` that holds a live
    row's key (the kernel reads a key only where the mask is set), plus each
    distinct 32-byte sector of the table that the live rows' walks reach (``slot_rows`` at every slot a walk
    visits, ``slot_keys`` at the occupied ones), walked as the plain version
    walks them."""
    import torch

    from presto_tpu_torch.ops import pallas_hash as ph

    slots = slot_rows.shape[0]
    rows_sectors = torch.zeros(slots * 4 // 32, dtype=torch.bool, device=keys.device)
    keys_sectors = torch.zeros(slots * 8 // 32, dtype=torch.bool, device=keys.device)
    live = mask.nonzero().squeeze(1)
    key_sectors = int(torch.unique(live >> 2).numel())
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
    return table + 32 * key_sectors + n + n * 4


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
                     "device_ms": device_ms(ph.insert_table, (comps1, mask1, slots), reps),
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
                    "device_ms": device_ms(ph.probe_table,
                                           (slot_comps[0], slot_rows, pkeys, pmask, trips),
                                           reps),
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

    sf = SCHEMAS[schema]
    cut = civil_day(1995, 3, 15)
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

    sf = SCHEMAS[schema]
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                                "l_returnflag", "l_linestatus", "l_shipdate"])
    keep = li["l_shipdate"] <= civil_day(1998, 12, 1) - 90
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

    sf = SCHEMAS[schema]
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"])
    col = {k: v.astype(np.int64) for k, v in li.items()}
    keep = (col["l_shipdate"] >= civil_day(1994, 1, 1)) & \
        (col["l_shipdate"] < civil_day(1995, 1, 1)) & \
        (col["l_discount"] >= 5) & (col["l_discount"] <= 7) & (col["l_quantity"] < 2400)
    rev = int((col["l_extendedprice"][keep] * col["l_discount"][keep]).sum())
    return [[Decimal(rev) / 10 ** 4 if keep.any() else None]], len(keep)


SQL_ORACLES = {1: oracle_q1, 3: oracle_q3, 6: oracle_q6}


def _table(name: str, sf: float, cols):
    from presto_tpu_torch.connectors.tpch import generator as g

    return g.generate_rows(name, 0, g.table_row_count(name, sf), sf, cols)


def _find(keys, probe):
    """Positions of ``probe`` in the unique ``keys`` and whether each is
    there (numpy)."""
    order = np.argsort(keys, kind="stable")
    pos = np.clip(np.searchsorted(keys[order], probe), 0, max(len(keys) - 1, 0))
    hit = keys[order][pos] == probe if len(keys) else np.zeros(len(probe), bool)
    return order[pos], hit


def oracle_q5(schema: str):
    """TPC-H Q5 in numpy over the port's generator. Each lineitem row is
    joined by key to its order (in the year), the order's customer and its
    supplier; a row counts where the customer's nation is the supplier's and
    lies in ASIA. No (lineitem, customer) pair is made."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    r = _table("region", sf, ["r_regionkey", "r_name"])
    asia = r["r_regionkey"][r["r_name"] == g.DICT_REGION_NAME.code_of("ASIA")]
    n = _table("nation", sf, ["n_nationkey", "n_name", "n_regionkey"])
    s = _table("supplier", sf, ["s_suppkey", "s_nationkey"])
    c = _table("customer", sf, ["c_custkey", "c_nationkey"])
    o = _table("orders", sf, ["o_orderkey", "o_custkey", "o_orderdate"])
    li = g.lineitem_for_orders(0, len(o["o_orderkey"]), sf,
                               ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"])
    in_year = (o["o_orderdate"] >= civil_day(1994, 1, 1)) & \
        (o["o_orderdate"] < civil_day(1995, 1, 1))
    opos, ohit = _find(o["o_orderkey"], li["l_orderkey"])
    ohit &= in_year[opos]
    cpos, chit = _find(c["c_custkey"], o["o_custkey"][opos])
    spos, shit = _find(s["s_suppkey"], li["l_suppkey"])
    snation = s["s_nationkey"][spos]
    npos, nhit = _find(n["n_nationkey"], snation)
    keep = ohit & chit & shit & nhit & (c["c_nationkey"][cpos] == snation) & \
        np.isin(n["n_regionkey"][npos], asia)
    rev = li["l_extendedprice"][keep].astype(np.int64) * \
        (100 - li["l_discount"][keep].astype(np.int64))
    names, inv = np.unique(n["n_name"][npos][keep], return_inverse=True)
    sums = np.zeros(len(names), dtype=np.int64)
    np.add.at(sums, inv, rev)
    rows = sorted(([g.DICT_NATION_NAME.values[k], Decimal(int(v)) / 10 ** 4]
                   for k, v in zip(names, sums)), key=lambda row: -row[1])
    source = sum(len(t[next(iter(t))]) for t in (r, n, s, c, o)) + len(li["l_orderkey"])
    return rows, source


def oracle_q9(schema: str):
    """TPC-H Q9 in numpy over the port's generator; ``p_name like
    '%green%'`` is tested on the decoded strings."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    p = _table("part", sf, ["p_partkey", "p_name"])
    green = p["p_partkey"][np.asarray(["green" in x for x in
                                       g.DICT_P_NAME.lookup(p["p_name"])], dtype=bool)]
    s = _table("supplier", sf, ["s_suppkey", "s_nationkey"])
    n = _table("nation", sf, ["n_nationkey", "n_name"])
    ps = _table("partsupp", sf, ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    o = _table("orders", sf, ["o_orderkey", "o_orderdate"])
    li = g.lineitem_for_orders(0, len(o["o_orderkey"]), sf,
                               ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                                "l_extendedprice", "l_discount"])
    keep = np.isin(li["l_partkey"], green)
    li = {k: v[keep] for k, v in li.items()}
    # (partkey, suppkey) as one exact int64
    width = int(max(ps["ps_suppkey"].max(), li["l_suppkey"].max(initial=0))) + 1
    pspos, pshit = _find(ps["ps_partkey"] * width + ps["ps_suppkey"],
                         li["l_partkey"] * width + li["l_suppkey"])
    opos, ohit = _find(o["o_orderkey"], li["l_orderkey"])
    spos, shit = _find(s["s_suppkey"], li["l_suppkey"])
    npos, nhit = _find(n["n_nationkey"], s["s_nationkey"][spos])
    keep = pshit & ohit & shit & nhit
    amount = li["l_extendedprice"][keep].astype(np.int64) * \
        (100 - li["l_discount"][keep].astype(np.int64)) - \
        ps["ps_supplycost"][pspos][keep].astype(np.int64) * \
        li["l_quantity"][keep].astype(np.int64)
    years = o["o_orderdate"][opos][keep].astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970
    groups, inv = np.unique(np.stack([n["n_name"][npos][keep].astype(np.int64), years]),
                            axis=1, return_inverse=True)
    sums = np.zeros(groups.shape[1], dtype=np.int64)
    np.add.at(sums, inv.reshape(-1), amount)
    rows = [[g.DICT_NATION_NAME.values[int(k)], int(y), Decimal(int(v)) / 10 ** 4]
            for (k, y), v in zip(groups.T, sums)]
    rows.sort(key=lambda row: (row[0], -row[1]))
    source = sum(len(t[next(iter(t))]) for t in (p, s, n, ps, o)) + \
        g.table_row_count("lineitem", sf)
    return rows, source


def oracle_q13(schema: str):
    """TPC-H Q13 in numpy over the port's generator; ``o_comment not like
    '%special%requests%'`` is tested on the decoded strings."""
    import re

    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    c = _table("customer", sf, ["c_custkey"])
    o = _table("orders", sf, ["o_custkey", "o_comment"])
    rx = re.compile("special.*requests", re.DOTALL)
    keep = np.asarray([rx.search(x) is None for x in g.DICT_COMMENT.lookup(o["o_comment"])],
                      dtype=bool)
    cpos, chit = _find(c["c_custkey"], o["o_custkey"][keep])
    per_customer = np.bincount(cpos[chit], minlength=len(c["c_custkey"]))
    counts, dist = np.unique(per_customer, return_counts=True)
    rows = sorted(([int(k), int(d)] for k, d in zip(counts, dist)),
                  key=lambda row: (-row[1], -row[0]))
    return rows, len(c["c_custkey"]) + len(o["o_custkey"])


JOIN_ORACLES = {5: oracle_q5, 9: oracle_q9, 13: oracle_q13}


def oracle_q14(schema: str):
    """TPC-H Q14 in numpy over the port's generator: the promotion share of
    one month's revenue, with ``p_type like 'PROMO%'`` tested on the decoded
    strings and the ratio taken exactly (``Fraction``) before the one
    rounding to a float."""
    from fractions import Fraction

    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    p = _table("part", sf, ["p_partkey", "p_type"])
    n_orders = g.table_row_count("orders", sf)
    li = g.lineitem_for_orders(0, n_orders, sf, ["l_partkey", "l_extendedprice",
                                                 "l_discount", "l_shipdate"])
    keep = (li["l_shipdate"] >= civil_day(1995, 9, 1)) & \
        (li["l_shipdate"] < civil_day(1995, 10, 1))
    ppos, phit = _find(p["p_partkey"], li["l_partkey"][keep])
    promo = np.asarray([t.startswith("PROMO") for t in g.DICT_P_TYPE.lookup(p["p_type"])],
                       dtype=bool)[ppos] & phit
    rev = li["l_extendedprice"][keep].astype(np.int64) * \
        (100 - li["l_discount"][keep].astype(np.int64))
    share = Fraction(100 * int(rev[promo].sum()), int(rev[phit].sum()))
    return [[float(share)]], len(p["p_partkey"]) + len(li["l_partkey"])


def oracle_q22(schema: str):
    """TPC-H Q22 in numpy over the port's generator: the country code is the
    first two characters of the decoded ``c_phone`` string, the scalar
    subquery's average is compared exactly (``Fraction``), and NOT EXISTS
    is a membership test on the orders' customer keys."""
    from fractions import Fraction

    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    c = _table("customer", sf, ["c_custkey", "c_phone", "c_acctbal"])
    o = _table("orders", sf, ["o_custkey"])
    codes = np.asarray([ph[:2] for ph in g.DICT_PHONE.lookup(c["c_phone"])], dtype=object)
    in_set = np.isin(codes, ["13", "31", "23", "29", "30", "18", "17"])
    bal = c["c_acctbal"].astype(np.int64)
    pos = in_set & (bal > 0)
    avg = Fraction(int(bal[pos].sum()), int(pos.sum()))  # in cents
    above = np.asarray([Fraction(int(b)) > avg for b in bal], dtype=bool)
    keep = in_set & above & ~np.isin(c["c_custkey"], o["o_custkey"])
    rows = []
    for code in sorted(set(codes[keep])):
        sel = keep & (codes == code)
        rows.append([code, int(sel.sum()), Decimal(int(bal[sel].sum())) / 100])
    return rows, len(c["c_custkey"]) + len(o["o_custkey"])


# numpy oracles of queries first run in phase 11
DEFAULT_PATH_ORACLES = {14: oracle_q14, 22: oracle_q22}


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


def sql_runner(device, hash_kernels: str, schema: str, **props):
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    return LocalQueryRunner(Session(catalog="tpch", schema=schema,
                                    properties={"hash_kernels": hash_kernels, **props}),
                            device=device)


def run_sql_query(device, q: int, schema: str, cold_capture=None, unfused_capture=None,
                  repeats_schema: Optional[str] = None):
    """SQL query ``q`` with ``hash_kernels="pallas"`` under the session
    defaults (fused segments, coalesced pages): a cold run (under
    ``cold_capture``), then a warm run with the launch counters and
    ``COUNTERS`` set to 0 just before it and read just after; then the
    query unfused (under ``unfused_capture``) and under
    ``hash_kernels="sorted"``. With ``repeats_schema`` those two repeats run
    at that smaller schema, beside one fused run there (``repeat_rows``):
    Q5's do, its SF1 runs taking 20-40 s each. Fails unless the unfused rows
    equal the fused ones. Returns what the phases check and print."""
    import contextlib

    import torch

    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.utils.metrics import METRICS

    from presto_tpu_torch.ops.scan import RESIDENT_CACHE

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    runner = sql_runner(device, "pallas", schema)
    RESIDENT_CACHE.clear()  # the cold run generates, uploads and caches its pages
    t0 = time.perf_counter()
    with cold_capture or contextlib.nullcontext():
        cold = runner.execute(QUERIES[q])
    sync()
    cold_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = {k: METRICS.counter_value(k) for k in COUNTERS}
    ph.insert_table.launches = 0
    ph.probe_table.launches = 0
    with ProbeStreams() as streams:
        t0 = time.perf_counter()
        res = runner.execute(QUERIES[q])
        sync()
        warm_s = time.perf_counter() - t0
    launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
    delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rschema = repeats_schema or schema
    repeat_rows = res.rows if rschema == schema else \
        sql_runner(device, "pallas", rschema).execute(QUERIES[q]).rows
    t0 = time.perf_counter()
    with unfused_capture or contextlib.nullcontext():
        unfused = sql_runner(device, "pallas", rschema, **UNFUSED).execute(QUERIES[q])
    sync()
    unfused_s = time.perf_counter() - t0
    if not same_rows(unfused.rows, repeat_rows):
        raise AssertionError(f"SQL Q{q} rows fused and unfused differ:\n{repeat_rows}\n"
                             f"{unfused.rows}")
    t0 = time.perf_counter()
    sorted_rows = sql_runner(device, "sorted", rschema).execute(QUERIES[q]).rows
    sync()
    sorted_s = time.perf_counter() - t0
    return {"q": q, "rows": res.rows, "segments": (res.stats or {}).get("segments"),
            "repeats_schema": rschema, "repeat_rows": repeat_rows,
            "launches": launches, "delta": delta, "streams": dict(streams.calls),
            "peak": peak, "cold_s": cold_s, "warm_s": warm_s, "unfused_s": unfused_s,
            "sorted_rows": sorted_rows, "sorted_s": sorted_s, "drivers": res.drivers,
            "scan": (cold.stats or {}).get("scan_pipeline"),
            "warm_scan": (res.stats or {}).get("scan_pipeline"),
            "resident_pages": res.resident_pages}


def check_rows(rec: dict, oracle, schema: str) -> None:
    """The warm rows and the sorted run's against the numpy oracle; logs
    the walls and the first rows."""
    q = rec["q"]
    want, source_rows = oracle(schema)
    if not same_rows(rec["rows"], want):
        raise AssertionError(f"SQL Q{q} rows differ from the numpy oracle:\n{rec['rows']}\n"
                             f"{want}")
    rschema = rec["repeats_schema"]
    if not same_rows(rec["sorted_rows"], want if rschema == schema else oracle(rschema)[0]):
        raise AssertionError(f"SQL Q{q} rows under hash_kernels='sorted' differ")
    warm_s = rec["warm_s"]
    log(f"SQL Q{q} {schema}: {len(rec['rows'])} rows equal to the numpy oracle, to the "
        f"unfused run and to the sorted run (those two at {rschema}); cold wall "
        f"{rec['cold_s']:.3f}s; warm wall {warm_s:.4f}s = {source_rows / warm_s:.0f} source "
        f"rows/s ({source_rows} rows); unfused {rec['unfused_s']:.4f}s; sorted run "
        f"{rec['sorted_s']:.4f}s")
    for r in rec["rows"][:4]:
        log("  " + " | ".join(str(v) for v in r))


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
    ``hash_kernels="pallas"`` under the defaults (``run_sql_query``); returns
    the records, the kernel inputs of the fused Q3's cold run and the
    grouping input of the unfused Q3 (the fused grouping takes the sort
    partial and sends no page through the insert)."""
    from presto_tpu_torch.models.tpch_sql import QUERIES

    on_card = device.type == "cuda"
    records, fused_capture, grouping = {}, KernelCapture(), GroupingCapture()
    for q in (1, 3, 6):
        rec = run_sql_query(device, q, schema,
                            cold_capture=fused_capture if q == 3 else None,
                            unfused_capture=grouping if q == 3 else None)
        records[q] = rec
        if q == 3:
            launches, delta = rec["launches"], rec["delta"]
            log(f"SQL Q3 {schema} launches on the warm run: {launches}; counters {delta}")
            builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
            if builds != 2 or delta["pallas.join_fallbacks"] != 0:
                raise AssertionError(f"the two Q3 builds did not both take the table: {delta}")
            if pages != 0 or (on_card and launches["insert"] != builds + pages):
                raise AssertionError(f"insert launches {launches['insert']} != join builds "
                                     f"{builds} + grouped pages {pages} (want 0 pages)")
            if on_card and launches["probe"] < 2:
                raise AssertionError(f"fewer than one probe per probe stream: {launches}")
        check_rows(rec, SQL_ORACLES[q], schema)
    for props, label in (({}, "SQL Q3"), (UNFUSED, "SQL Q3 unfused")):
        runner = sql_runner(device, "pallas", schema, **props)
        profile_q3(device, schema, run=lambda: runner.execute(QUERIES[3]), label=label)
    return records, fused_capture, grouping


def sql_layers(device, schema: str = "sf1", queries=(1, 3, 6), warm_up: bool = True) -> None:
    """Where a warm SQL query's wall goes, on the host clock: parse, analyze,
    plan and optimize; local planning; execution (ending in a sync); result
    rows; and each operator's host time in add_input/get_output (device
    work it waits for included, finishes not)."""
    import torch

    from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
    from presto_tpu_torch.exec.task_executor import TaskExecutor
    from presto_tpu_torch.models.tpch_sql import QUERIES

    for q in queries:
        runner = sql_runner(device, "pallas", schema)
        if warm_up:
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


class ProbeStreams:
    """Counts, while on, the probe-kernel calls against each open-addressing
    table (one table per probe stream)."""

    def __enter__(self):
        from presto_tpu_torch.ops import hash_join

        self.module, self.original = hash_join, hash_join.probe_match_pallas
        self.calls = {}
        streams = self

        def probe(ph_keys, ph_rows, probe_keys, probe_mask, trips):
            key = id(ph_rows)
            streams.calls[key] = streams.calls.get(key, 0) + 1
            return streams.original(ph_keys, ph_rows, probe_keys, probe_mask, trips)

        hash_join.probe_match_pallas = probe
        return self

    def __exit__(self, *exc):
        self.module.probe_match_pallas = self.original
        return False


class KernelCapture:
    """Records, while on, the inputs of the largest join-build insert (one
    key component), of the first grouping insert (more components) and of
    the first probe of a page with rows, as the query path gives them to
    the wrappers, and the first probe of each table (``by_table``)."""

    def __enter__(self):
        from presto_tpu_torch.ops import pallas_hash as ph

        self.ph, self.insert, self.probe = ph, ph.insert_table, ph.probe_table
        self.build = self.grouping = self.probe_args = None
        self.by_table = {}  # the first probe of each table, by its rows tensor
        cap = self

        def insert(comps, mask, slots, *rest, **kw):
            if comps.shape[0] == 1:
                if cap.build is None or comps.shape[1] > cap.build[0].shape[1]:
                    cap.build = (comps, mask, slots)
            elif cap.grouping is None:
                cap.grouping = (comps, mask, slots)
            return cap.insert(comps, mask, slots, *rest, **kw)

        def probe(slot_keys, slot_rows, keys, mask, trips):
            if keys.shape[0]:
                args = (slot_keys, slot_rows, keys, mask, trips)
                if cap.probe_args is None:
                    cap.probe_args = args
                cap.by_table.setdefault(id(slot_rows), args)
            return cap.probe(slot_keys, slot_rows, keys, mask, trips)

        # the wrappers count their launches in the module-level function's
        # attribute, which is this stand-in while the capture is on
        insert.launches, probe.launches = self.insert.launches, self.probe.launches
        ph.insert_table, ph.probe_table = insert, probe
        return self

    def __exit__(self, *exc):
        self.insert.launches = self.ph.insert_table.launches
        self.probe.launches = self.ph.probe_table.launches
        self.ph.insert_table, self.ph.probe_table = self.insert, self.probe
        return False


def run_join_phase(device, schema: str = "sf1"):
    """Q5, Q9 and Q13 as SQL with ``hash_kernels="pallas"`` under the
    defaults (``run_sql_query``), rows against numpy oracles. Returns the
    records and the kernel inputs captured on Q9's unfused run (its
    grouping sends pages through the insert only unfused)."""
    from presto_tpu_torch.models.tpch_sql import QUERIES

    # join builds on the table, as the reference counts them at tiny
    want_builds = {5: 3, 9: 4, 13: 0}
    on_card = device.type == "cuda"
    records, capture = {}, KernelCapture()
    for q in (5, 9, 13):
        # Q5's repeats (unfused, sorted) run at tiny: its SF1 runs take 20-40 s
        rec = run_sql_query(device, q, schema, unfused_capture=capture if q == 9 else None,
                            repeats_schema=Q5_REPEATS_SCHEMA if q == 5 else None)
        records[q] = rec
        got, delta, calls = rec["launches"], rec["delta"], rec["streams"]
        log(f"SQL Q{q} {schema} launches on the warm run: {got}; probe calls per stream "
            f"{sorted(calls.values())}; counters {delta}")
        builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
        if builds != want_builds[q] or delta["pallas.join_fallbacks"] != 0 or \
                delta["pallas.agg_fallbacks"] != 0:
            raise AssertionError(f"Q{q}: join builds {builds} (want {want_builds[q]}) or a "
                                 f"fallback: {delta}")
        if on_card and got["insert"] != builds + pages:
            raise AssertionError(f"Q{q}: insert launches {got['insert']} != join builds "
                                 f"{builds} + grouped pages {pages}")
        if len(calls) != builds or (on_card and got["probe"] != sum(calls.values())):
            raise AssertionError(f"Q{q}: {builds} tables but probe calls per stream "
                                 f"{calls}, probe launches {got['probe']}")
        if q in (5, 13) and not delta["join.expanded_rows"]:
            raise AssertionError(f"Q{q}: the duplicate-key join did not expand: {delta}")
        check_rows(rec, JOIN_ORACLES[q], schema)
        if q == 5:
            log(f"SQL Q5 {schema} expansion: {int(delta['join.expansion_chunks'])} chunks, "
                f"{int(delta['join.expanded_rows'])} expanded rows; peak device memory "
                f"{rec['peak']} bytes (torch.cuda.max_memory_allocated)")
            # the three dropped SF1 runs (unfused, sorted, the oracle
            # properties) each take at most the 4-driver warm wall
            log(f"SQL Q5: unfused and sorted repeats at {rec['repeats_schema']} took "
                f"{rec['unfused_s'] + rec['sorted_s']:.3f}s; the SF1 repeats they replace "
                f"would take at most 3 x {rec['warm_s']:.3f}s = {3 * rec['warm_s']:.3f}s")
    for q in (9, 13):
        runner = sql_runner(device, "pallas", schema)
        if on_card:
            profile_q3(device, schema, run=lambda: runner.execute(QUERIES[q]),
                       label=f"SQL Q{q}")
    return records, capture


def check_default_path(device, records: dict, schema: str = "sf1") -> None:
    """The default path of SQL Q1, Q3, Q5, Q6, Q9 and Q13, from their warm
    runs: the fused segments, the coalesced pages, the walls fused and
    unfused. Fails unless the segments' operators are the pinned ones, a
    fused segment launched the probe kernel in Q3, Q5 and Q9, the insert
    launched once per join build and grouped page, Q3 grouped no page
    through the insert (its grouping is fused; Q9's runs after the
    exchange, unfused), and nothing fell back."""
    on_card = device.type == "cuda"
    for q in sorted(records):
        rec = records[q]
        stats, delta, launches = rec["segments"], rec["delta"], rec["launches"]
        segs = stats["segments"] if stats else []
        log(f"SEGMENTS SQL Q{q} {schema}: {len(segs)} fused segment(s), "
            f"{stats['dispatches'] if stats else 0} dispatches; coalesce pages in "
            f"{int(delta['coalesce.pages_in'])}, out {int(delta['coalesce.pages_out'])}; "
            f"warm wall fused {rec['warm_s']:.4f}s, unfused {rec['unfused_s']:.4f}s")
        for seg in segs:
            log(f"  pipeline {seg['pipeline']}: {seg['operators']} dispatches "
                f"{seg['dispatches']}, compositions {seg['compiles']}, probe-kernel launches "
                f"{seg['probe_launches']}")
        if [seg["operators"] for seg in segs] != SEGMENT_OPERATORS[q]:
            raise AssertionError(f"Q{q} segments {[seg['operators'] for seg in segs]} != "
                                 f"{SEGMENT_OPERATORS[q]}")
        if on_card and q in FUSED_PROBE_QUERIES and \
                sum(seg["probe_launches"] for seg in segs) < 1:
            raise AssertionError(f"Q{q}: no probe-kernel launch inside a fused segment")
        builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
        if on_card and launches["insert"] != builds + pages:
            raise AssertionError(f"Q{q}: insert launches {launches['insert']} != join builds "
                                 f"{builds} + grouped pages {pages}")
        if q == 3 and pages != 0:
            raise AssertionError(f"Q{q}: the fused grouping sent {pages} pages to the insert")
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"Q{q}: a fallback: {delta}")


def compare_walls(device, schema: str = "sf1", queries=(1, 3, 6, 9, 13), rounds: int = 3):
    """Warm walls of each query fused and unfused, in turns (fused,
    unfused, unfused, fused, ...), ``rounds`` of each: every wall and the
    medians."""
    import torch

    from presto_tpu_torch.models.tpch_sql import QUERIES

    for q in queries:
        walls = {"fused": [], "unfused": []}
        order = [("fused", "unfused"), ("unfused", "fused")]
        for r in range(rounds):
            for mode in order[r % 2]:
                runner = sql_runner(device, "pallas", schema,
                                    **(UNFUSED if mode == "unfused" else {}))
                t0 = time.perf_counter()
                runner.execute(QUERIES[q])
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
        log(f"WALLS SQL Q{q} {schema} in turns: fused median "
            f"{np.median(walls['fused']):.4f}s {[round(w, 4) for w in walls['fused']]}, "
            f"unfused median {np.median(walls['unfused']):.4f}s "
            f"{[round(w, 4) for w in walls['unfused']]}")


def check_fused_probe(device, capture, reps: int = 20, plain_reps: int = 3) -> None:
    """The probe kernel against its plain version, bit for bit, at the shape
    the fused probe stage gives it: SQL Q3's first coalesced probe page."""
    from presto_tpu_torch.ops import pallas_hash as ph

    if capture.probe_args is None:
        raise AssertionError("the fused SQL Q3 made no probe-kernel call")
    slot_keys, slot_rows, keys, mask, trips = capture.probe_args
    got = ph.probe_table(slot_keys, slot_rows, keys, mask, trips)
    err = _max_abs_err([(got, ph.probe_table_reference(slot_keys, slot_rows, keys, mask,
                                                       trips))])
    if err != 0:
        raise AssertionError(f"fused-stage probe differs from its plain version: {err}")
    nbytes = probe_bytes(slot_keys, slot_rows, keys, mask, trips)
    ms = time_ms(lambda: ph.probe_table(slot_keys, slot_rows, keys, mask, trips), reps, device)
    dev_ms = device_ms(ph.probe_table, (slot_keys, slot_rows, keys, mask, trips), reps)
    plain_ms = time_ms(lambda: ph.probe_table_reference(slot_keys, slot_rows, keys, mask,
                                                        trips), plain_reps, device)
    log(f"KERNEL probe at the SQL Q3 fused-stage shape (first coalesced probe page): "
        f"slots={slot_rows.shape[0]} n={keys.shape[0]} live={int(mask.sum())} trips={trips}: "
        f"bit-identical, {int((got >= 0).sum())} hits; kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {nbytes / HBM_RATE * 1e3:.4f} ms "
        f"({nbytes} bytes)")


def check_path_kernels(device, capture, reps: int = 20, plain_reps: int = 3,
                       run: str = "unfused SQL Q9", need_grouping: bool = True) -> None:
    """Both kernels against their plain versions, bit for bit, at the shapes
    ``run`` gave them (its largest join build, its first grouped page where
    it grouped one through the insert, and its first probe), with their
    times and bounds."""
    from presto_tpu_torch.ops import pallas_hash as ph

    if capture is None or None in (capture.build, capture.probe_args) or \
            (need_grouping and capture.grouping is None):
        raise AssertionError(f"the {run} did not give both kernels their inputs")
    inserts = [("join build", capture.build)]
    if capture.grouping is not None:
        inserts.append(("grouping", capture.grouping))
    for label, (comps, mask, slots) in inserts:
        got = ph.insert_table(comps, mask, slots)
        err = _max_abs_err(zip(got, ph.insert_table_reference(comps, mask, slots)))
        if err != 0:
            raise AssertionError(f"{run} {label} insert differs from its plain version: {err}")
        ncomps, n = comps.shape
        live = int(mask.sum())
        nbytes = n + live * ncomps * 8 + n * 4 + ncomps * slots * 8 + slots * 4 + 3 * 4
        ms = time_ms(lambda: ph.insert_table(comps, mask, slots), reps, device)
        dev_ms = device_ms(ph.insert_table, (comps, mask, slots), reps)
        plain_ms = time_ms(lambda: ph.insert_table_reference(comps, mask, slots),
                           plain_reps, device)
        log(f"KERNEL insert at the {run} {label} shape: ncomps={ncomps} n={n} live={live} "
            f"slots={slots}: bit-identical, stats {got[3].tolist()}; kernel {ms:.4f} ms "
            f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{nbytes / HBM_RATE * 1e3:.4f} ms ({nbytes} bytes)")
    slot_keys, slot_rows, keys, mask, trips = capture.probe_args
    got = ph.probe_table(slot_keys, slot_rows, keys, mask, trips)
    err = _max_abs_err([(got, ph.probe_table_reference(slot_keys, slot_rows, keys, mask,
                                                       trips))])
    if err != 0:
        raise AssertionError(f"{run} probe differs from its plain version: {err}")
    nbytes = probe_bytes(slot_keys, slot_rows, keys, mask, trips)
    ms = time_ms(lambda: ph.probe_table(slot_keys, slot_rows, keys, mask, trips), reps, device)
    dev_ms = device_ms(ph.probe_table, (slot_keys, slot_rows, keys, mask, trips), reps)
    plain_ms = time_ms(lambda: ph.probe_table_reference(slot_keys, slot_rows, keys, mask,
                                                        trips), plain_reps, device)
    log(f"KERNEL probe at the {run} shape: slots={slot_rows.shape[0]} n={keys.shape[0]} "
        f"live={int(mask.sum())} trips={trips}: bit-identical, {int((got >= 0).sum())} hits; "
        f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{nbytes / HBM_RATE * 1e3:.4f} ms ({nbytes} bytes)")


def check_grouping_insert(device, capture, reps: int = 20, plain_reps: int = 3) -> None:
    """The insert at the shape the unfused SQL Q3 grouping gives it (the
    fused grouping sends no page through the insert), against its plain
    version (bit for bit), with its times and bound."""
    from presto_tpu_torch.ops import pallas_hash as ph

    comps, mask, slots = capture.comps, capture.mask, capture.slots
    if comps is None:
        raise AssertionError("the unfused SQL Q3 grouping sent no page through the insert")
    got = ph.insert_table(comps, mask, slots)
    want = ph.insert_table_reference(comps, mask, slots)
    err = _max_abs_err(zip(got, want))
    if err != 0:
        raise AssertionError(f"grouping-shape insert differs from its plain version: {err}")
    ncomps, n = comps.shape
    stats = got[3].tolist()
    ms = time_ms(lambda: ph.insert_table(comps, mask, slots), reps, device)
    dev_ms = device_ms(ph.insert_table, (comps, mask, slots), reps)
    plain_ms = time_ms(lambda: ph.insert_table_reference(comps, mask, slots), plain_reps,
                       device)
    # what this page needs: the mask, the live rows' key components, every
    # row's group id, and the table
    live = int(mask.sum())
    nbytes = n + live * ncomps * 8 + n * 4 + ncomps * slots * 8 + slots * 4 + 3 * 4
    log(f"KERNEL insert at the unfused SQL Q3 grouping shape: ncomps={ncomps} n={n} "
        f"live={live} slots={slots} (first page {capture.first_ng} groups): "
        f"bit-identical, stats [overflow, max_run, distinct] = {stats}")
    log(f"TIME insert (grouping shape): kernel {ms:.4f} ms (wrapper call, CUDA events; "
        f"device time {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{nbytes / HBM_RATE * 1e3:.4f} ms ({nbytes} bytes at {HBM_RATE:.3g} B/s)")
    insert_rounds(device, comps, mask, slots)


class MergeTimer:
    """Records, while on, the seconds each spilled grouping spends in its
    exact host merge (``GroupedAggregationBuilder._merge_spilled``)."""

    def __enter__(self):
        from presto_tpu_torch.ops import hash_agg

        self.cls = hash_agg.GroupedAggregationBuilder
        self.original = self.cls._merge_spilled
        self.seconds = []
        timer = self

        def merge(builder):
            t0 = time.perf_counter()
            try:
                return timer.original(builder)
            finally:
                timer.seconds.append(time.perf_counter() - t0)

        self.cls._merge_spilled = merge
        return self

    def __exit__(self, *exc):
        self.cls._merge_spilled = self.original
        return False


def _fmt_scan(st) -> str:
    if not st:
        return "none (every scan replayed resident pages)"
    return (f"read busy {st['read_busy_s']:.4f}s stall {st['read_stall_s']:.4f}s, upload "
            f"busy {st['upload_busy_s']:.4f}s stall {st['upload_stall_s']:.4f}s, compute "
            f"stall {st['compute_stall_s']:.4f}s; {st['pages']} pages, {st['bytes']} bytes")


def run_default_path_phase(device, records: dict, schema: str = "sf1",
                           captures: Optional[dict] = None) -> dict:
    """Every ported query at SF1 with ``hash_kernels="pallas"`` under the full
    defaults (four drivers per cut pipeline, the staged scan, the resident
    cache): a cold run (cache cleared first) and a warm run, which replays
    resident pages, with the launch counters and ``COUNTERS`` set to 0
    just before it and read just after (the queries of phases 6 and 8 reuse
    those phases' runs); then the oracle properties, cold and warm (Q5
    once). Fails unless the rows equal the oracle's, the warm run replayed
    pages and staged none, the insert launched once per join build and
    grouped page, a query that built on the table probed it with the
    kernel, nothing fell back, Q18's inner grouping spilled, and Q14's
    and Q22's rows equal their numpy oracles. ``captures`` maps a query to the
    ``KernelCapture`` its cold run is made under. Returns the records of
    every query."""
    import contextlib

    import torch

    from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    probe = sql_runner(device, "pallas", schema)
    want_drivers = LocalExecutionPlanner(probe.metadata, probe.session, device).driver_count()
    out = {}
    for q in PORTED_QUERIES:
        rec = dict(records.get(q) or {})
        merges = MergeTimer()
        with merges:
            if not rec:
                runner = sql_runner(device, "pallas", schema)
                RESIDENT_CACHE.clear()
                spilled = METRICS.counter_value("agg.spilled_folds")
                t0 = time.perf_counter()
                with (captures or {}).get(q) or contextlib.nullcontext():
                    cold = runner.execute(QUERIES[q])
                sync()
                rec["cold_s"] = time.perf_counter() - t0
                rec["cold_spills"] = METRICS.counter_value("agg.spilled_folds") - spilled
                before = {k: METRICS.counter_value(k) for k in COUNTERS + ("agg.spilled_folds",)}
                ph.insert_table.launches = 0
                ph.probe_table.launches = 0
                t0 = time.perf_counter()
                res = runner.execute(QUERIES[q])
                sync()
                rec["warm_s"] = time.perf_counter() - t0
                rec["launches"] = {"insert": ph.insert_table.launches,
                                   "probe": ph.probe_table.launches}
                rec["delta"] = {k: METRICS.counter_value(k) - v for k, v in before.items()}
                rec.update(q=q, rows=res.rows, drivers=res.drivers,
                           scan=(cold.stats or {}).get("scan_pipeline"),
                           warm_scan=(res.stats or {}).get("scan_pipeline"),
                           resident_pages=res.resident_pages,
                           segments=(res.stats or {}).get("segments"))
            walls = []
            # Q5 takes the oracle properties at its repeats' schema, once
            oschema = rec.get("repeats_schema", schema)
            oracle_runner = sql_runner(device, "pallas", oschema, **ORACLE_PROPS)
            for _ in range(1 if q == 5 else 2):
                t0 = time.perf_counter()
                oracle = oracle_runner.execute(QUERIES[q])
                sync()
                walls.append(time.perf_counter() - t0)
        rec["oracle_s"] = walls
        defaults_rows = rec["rows"] if oschema == schema else rec["repeat_rows"]
        if not same_rows(defaults_rows, oracle.rows):
            raise AssertionError(f"SQL Q{q}: rows under the defaults differ from the oracle "
                                 f"properties' ({ORACLE_PROPS}) at {oschema}:\n"
                                 f"{defaults_rows}\n{oracle.rows}")
        if max(rec["drivers"]) != want_drivers or max(oracle.drivers) != 1:
            raise AssertionError(f"SQL Q{q}: drivers {rec['drivers']} / oracle {oracle.drivers}")
        if rec["warm_scan"] or not rec["resident_pages"]:
            raise AssertionError(f"SQL Q{q}: the warm run staged pages ({rec['warm_scan']}) or "
                                 f"replayed none ({rec['resident_pages']})")
        delta, launches = rec["delta"], rec["launches"]
        builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
        if on_card and launches["insert"] != builds + pages:
            raise AssertionError(f"SQL Q{q}: insert launches {launches['insert']} != join "
                                 f"builds {builds} + grouped pages {pages}")
        if on_card and builds and not launches["probe"]:
            raise AssertionError(f"SQL Q{q}: {builds} tables built, none probed by the kernel")
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"SQL Q{q}: a fallback: {delta}")
        if q in DEFAULT_PATH_ORACLES:
            want, _ = DEFAULT_PATH_ORACLES[q](schema)
            if not same_rows(rec["rows"], want):
                raise AssertionError(f"SQL Q{q} rows differ from the numpy oracle:\n"
                                     f"{rec['rows']}\n{want}")
            log(f"SQL Q{q} {schema}: {len(want)} rows equal to the numpy oracle")
        if q == 18:
            spills = delta.get("agg.spilled_folds", 0)
            if not (rec.get("cold_spills") and spills):
                raise AssertionError(f"SQL Q18: the inner grouping did not spill ({spills})")
            rec["merge_s"] = merges.seconds
        out[q] = rec
        log(f"DEFAULTPATH SQL Q{q} {schema}: {len(rec['rows'])} rows equal to the oracle "
            f"properties' run; drivers per pipeline {rec['drivers']}; cold wall "
            f"{rec['cold_s']:.4f}s, warm (resident) wall {rec['warm_s']:.4f}s, oracle at {oschema} "
            f"{' / '.join(f'{w:.4f}s' for w in walls)}; warm run replayed "
            f"{rec['resident_pages']} resident pages; launches {launches}; "
            f"join builds {int(builds)}, fallbacks {int(delta['pallas.join_fallbacks'])}, "
            f"grouped pages {int(pages)}")
        log(f"  cold scan stages: {_fmt_scan(rec['scan'])}")
        if delta.get("join.semi_pages"):
            log(f"  filtered semi probes on the warm run: {int(delta['join.semi_pages'])} "
                f"pages, {int(delta['join.semi_chunks'])} chunks of candidate pairs")
        if q == 18:
            log(f"  Q18 spilled folds: cold {int(rec['cold_spills'])}, warm "
                f"{int(delta['agg.spilled_folds'])}; host merge seconds "
                f"{[round(x, 4) for x in merges.seconds]}")
    return out


# the card-against-host checks of phases 11 and 12 run at this schema: at SF1
# their host runs took 90.2 s and 107.9 s on an NVIDIA H100 80GB HBM3 host
# (PERF.md section 6); the card's SF1 rows stay held by the numpy oracles and
# the oracle-property runs
CPU_ROWS_SCHEMA = "tiny"
SF1_HOST_SECONDS = 90.2 + 107.9


def check_cpu_rows(device, schema: str = CPU_ROWS_SCHEMA) -> None:
    """Every ported query under the defaults, on the card and in the port's
    own CPU run, both at ``schema``: equal rows."""
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE

    for q in PORTED_QUERIES:
        card = sql_runner(device, "pallas", schema).execute(QUERIES[q]).rows
        t0 = time.perf_counter()
        rows = sql_runner("cpu", "pallas", schema).execute(QUERIES[q]).rows
        if not same_rows(card, rows):
            raise AssertionError(f"SQL Q{q}: the card's rows differ from the CPU run's "
                                 f"at {schema}:\n{card}\n{rows}")
        log(f"CPU SQL Q{q} {schema}: {len(rows)} rows equal to the card's "
            f"({time.perf_counter() - t0:.2f}s on the host)")
    RESIDENT_CACHE.clear()  # the host pages are no use to the card


# phase 12: TPC-DS at SF1 (no cache token: every run regenerates its pages)
DS_DEEP = (64, 72)   # the north-star pair: profiler, expansion, kernel shapes
DS_NO_ROWS = (50,)   # returns no rows at tiny and SF1, in both packages


def ds_runner(device, schema: str, **props):
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    return LocalQueryRunner(Session(catalog="tpcds", schema=schema,
                                    properties={"hash_kernels": "pallas", **props}),
                            device=device)


def run_tpcds_phase(device, schema: str = "sf1") -> dict:
    """Every TPC-DS query of ``models/tpcds_sql.py`` with
    ``hash_kernels="pallas"`` under the full defaults: a cold run, a warm
    run with the launch counters and ``COUNTERS`` set to 0 just before it
    and read just after, and one run under the oracle properties. A TPC-DS
    scan has no cache token, so warm regenerates its pages too. Fails
    unless the three runs give the same rows, the warm run replayed no
    resident page, the insert launched once per join build and grouped
    page, a query that built on the table probed it with the kernel, and
    nothing fell back. Q64 and Q72 also print their expansion and peak
    device memory, get a profiler pass, and hold both kernels against their
    plain versions at the shapes their cold runs gave them. Returns the
    records."""
    import contextlib

    import torch

    from presto_tpu_torch.models.tpcds_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    for q in sorted(QUERIES):
        capture = KernelCapture() if q in DS_DEEP else None
        runner = ds_runner(device, schema)
        RESIDENT_CACHE.clear()
        t0 = time.perf_counter()
        with capture or contextlib.nullcontext():
            cold = runner.execute(QUERIES[q])
        sync()
        cold_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        before = {k: METRICS.counter_value(k) for k in COUNTERS}
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        t0 = time.perf_counter()
        res = runner.execute(QUERIES[q])
        sync()
        warm_s = time.perf_counter() - t0
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        t0 = time.perf_counter()
        oracle = ds_runner(device, schema, **ORACLE_PROPS).execute(QUERIES[q])
        sync()
        oracle_s = time.perf_counter() - t0
        rec = {"q": q, "rows": res.rows, "launches": launches, "delta": delta,
               "drivers": res.drivers, "cold_s": cold_s, "warm_s": warm_s,
               "oracle_s": oracle_s, "peak": peak, "scan": (cold.stats or {}).get("scan_pipeline"),
               "warm_scan": (res.stats or {}).get("scan_pipeline")}
        if not (same_rows(cold.rows, res.rows) and same_rows(oracle.rows, res.rows)):
            raise AssertionError(f"SQL DS Q{q}: cold, warm and oracle-property rows differ:\n"
                                 f"{cold.rows}\n{res.rows}\n{oracle.rows}")
        if not res.rows and q not in DS_NO_ROWS:
            raise AssertionError(f"SQL DS Q{q} returned no rows")
        if max(oracle.drivers) != 1 or res.resident_pages or not rec["warm_scan"]:
            raise AssertionError(f"SQL DS Q{q}: oracle drivers {oracle.drivers}, warm run "
                                 f"replayed {res.resident_pages} pages, staged "
                                 f"{rec['warm_scan']}")
        builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
        if on_card and launches["insert"] != builds + pages:
            raise AssertionError(f"SQL DS Q{q}: insert launches {launches['insert']} != join "
                                 f"builds {builds} + grouped pages {pages}")
        if on_card and builds and not launches["probe"]:
            raise AssertionError(f"SQL DS Q{q}: {builds} tables built, none probed by the "
                                 f"kernel")
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"SQL DS Q{q}: a fallback: {delta}")
        out[q] = rec
        log(f"DSPATH SQL DS Q{q} {schema}: {len(res.rows)} rows equal cold, warm and under the "
            f"oracle properties; drivers per pipeline {res.drivers}; cold wall {cold_s:.4f}s, "
            f"warm wall {warm_s:.4f}s (regenerated, {res.resident_pages} resident pages), "
            f"oracle {oracle_s:.4f}s; launches {launches}; join builds {int(builds)}, "
            f"fallbacks {int(delta['pallas.join_fallbacks'])}, grouped pages {int(pages)}")
        log(f"  warm scan stages: {_fmt_scan(rec['warm_scan'])}")
        if q in DS_DEEP:
            log(f"  SQL DS Q{q} expansion on the warm run: "
                f"{int(delta['join.expansion_chunks'])} chunks, "
                f"{int(delta['join.expanded_rows'])} expanded rows; peak device memory "
                f"{peak} bytes")
            profile_q3(device, schema, run=lambda: runner.execute(QUERIES[q]),
                       label=f"SQL DS Q{q}")
            check_path_kernels(device, capture, run=f"SQL DS Q{q} cold run",
                               need_grouping=False)
    return out


def check_ds_cpu_rows(device, schema: str = CPU_ROWS_SCHEMA) -> None:
    """Every TPC-DS query under the defaults, on the card and in the port's
    own CPU run, both at ``schema``: equal rows."""
    from presto_tpu_torch.models.tpcds_sql import QUERIES

    for q in sorted(QUERIES):
        card = ds_runner(device, schema).execute(QUERIES[q]).rows
        t0 = time.perf_counter()
        rows = ds_runner("cpu", schema).execute(QUERIES[q]).rows
        if not same_rows(card, rows):
            raise AssertionError(f"SQL DS Q{q}: the card's rows differ from the CPU run's "
                                 f"at {schema}:\n{card}\n{rows}")
        log(f"CPU SQL DS Q{q} {schema}: {len(rows)} rows equal to the card's "
            f"({time.perf_counter() - t0:.2f}s on the host)")


# phase 13: set operations at TPC-H SF1, each against a numpy oracle
SETOP_SQL = {
    "union all": "select l_returnflag, count(*), sum(l_quantity) from "
                 "(select l_returnflag, l_quantity from lineitem "
                 "where l_shipdate < date '1994-01-01' union all "
                 "select l_returnflag, l_quantity from lineitem "
                 "where l_shipdate >= date '1997-01-01') t group by l_returnflag order by 1",
    "except": "select c_custkey from customer except select o_custkey from orders order by 1",
    "intersect": "select o_custkey from orders where o_orderdate < date '1993-01-01' "
                 "intersect select c_custkey from customer where c_mktsegment = 'BUILDING' "
                 "order by 1",
    "rollup": "select l_returnflag, l_linestatus, count(*), sum(l_extendedprice) "
              "from lineitem group by rollup(l_returnflag, l_linestatus) order by 1, 2",
    "union dictionaries": "select n_name from nation union select r_name from region "
                          "order by 1",
}


def _nulls_last(rows, ncols: int):
    return sorted(rows, key=lambda r: [(v is None, v if v is not None else 0)
                                       for v in r[:ncols]])


def oracle_setop(label: str, schema: str):
    """The set-operation query ``label`` in numpy over the port's TPC-H
    generator: rows as Python values, ORDER BY with NULLS LAST."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    n_orders = g.table_row_count("orders", sf)
    if label in ("union all", "rollup"):
        li = g.lineitem_for_orders(0, n_orders, sf, ["l_returnflag", "l_linestatus",
                                                     "l_quantity", "l_extendedprice",
                                                     "l_shipdate"])
        flag = g.DICT_RETURNFLAG.lookup(li["l_returnflag"].astype(np.int64))
        if label == "union all":
            sel = (li["l_shipdate"] < civil_day(1994, 1, 1)) | \
                (li["l_shipdate"] >= civil_day(1997, 1, 1))
            qty = li["l_quantity"].astype(np.int64)
            return [[f, int((sel & (flag == f)).sum()),
                     Decimal(int(qty[sel & (flag == f)].sum())) / 100]
                    for f in sorted(set(flag[sel]))]
        status = g.DICT_LINESTATUS.lookup(li["l_linestatus"].astype(np.int64))
        price = li["l_extendedprice"].astype(np.int64)
        rows = []
        for f in sorted(set(flag)):
            for st in sorted(set(status[flag == f])):
                sel = (flag == f) & (status == st)
                rows.append([f, st, int(sel.sum()), Decimal(int(price[sel].sum())) / 100])
            sel = flag == f
            rows.append([f, None, int(sel.sum()), Decimal(int(price[sel].sum())) / 100])
        rows.append([None, None, len(flag), Decimal(int(price.sum())) / 100])
        return _nulls_last(rows, 2)
    if label == "union dictionaries":
        return [[v] for v in sorted(set(g.REGIONS) | {n for n, _ in g.NATIONS})]
    c = _table("customer", sf, ["c_custkey", "c_mktsegment"])
    o = _table("orders", sf, ["o_custkey", "o_orderdate"])
    if label == "except":
        keys = np.setdiff1d(c["c_custkey"], o["o_custkey"])
    else:
        building = c["c_custkey"][c["c_mktsegment"] == g.DICT_SEGMENT.code_of("BUILDING")]
        keys = np.intersect1d(o["o_custkey"][o["o_orderdate"] < civil_day(1993, 1, 1)],
                              building)
    return [[int(k)] for k in keys]


def run_setops_phase(device, schema: str = "sf1") -> dict:
    """The five set-operation queries at TPC-H SF1 with ``hash_kernels=
    "pallas"`` under the defaults: a cold run, a warm run with the counters
    set to 0 just before it, and the port's CPU run. Fails unless the rows
    equal the numpy oracle and the CPU run's, the insert launched once per
    join build and grouped page, nothing fell back, and the VARCHAR union
    planned a code remap. Returns the records."""
    import torch

    from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.coalesce import DictionaryRemapOperatorFactory
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    for label, sql in SETOP_SQL.items():
        runner = sql_runner(device, "pallas", schema)
        RESIDENT_CACHE.clear()
        t0 = time.perf_counter()
        runner.execute(sql)
        sync()
        cold_s = time.perf_counter() - t0
        before = {k: METRICS.counter_value(k) for k in COUNTERS}
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        t0 = time.perf_counter()
        res = runner.execute(sql)
        sync()
        warm_s = time.perf_counter() - t0
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
        want = oracle_setop(label, schema)
        if not same_rows(res.rows, want):
            raise AssertionError(f"SETOP {label}: rows differ from the numpy oracle:\n"
                                 f"{res.rows[:20]}\n{want[:20]}")
        t0 = time.perf_counter()
        cpu_rows = sql_runner("cpu", "pallas", schema).execute(sql).rows
        cpu_s = time.perf_counter() - t0
        if not same_rows(cpu_rows, res.rows):
            raise AssertionError(f"SETOP {label}: the card's rows differ from the CPU run's")
        builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
        if on_card and launches["insert"] != builds + pages:
            raise AssertionError(f"SETOP {label}: insert launches {launches['insert']} != "
                                 f"join builds {builds} + grouped pages {pages}")
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"SETOP {label}: a fallback: {delta}")
        if label == "union dictionaries":
            plan = LocalExecutionPlanner(runner.metadata, runner.session, device).plan(
                runner.plan_sql(sql))
            remapped = [f for chain in plan.pipelines for f in chain
                        if isinstance(f, DictionaryRemapOperatorFactory)
                        and any(r is not None for r in f.remaps)]
            if not remapped:
                raise AssertionError("SETOP union dictionaries: no branch remaps its codes")
        out[label] = {"rows": res.rows, "launches": launches, "delta": delta}
        log(f"SETOP {label} {schema}: {len(res.rows)} rows equal to the numpy oracle and to "
            f"the CPU run ({cpu_s:.2f}s on the host); drivers per pipeline {res.drivers}; "
            f"cold wall {cold_s:.4f}s, warm wall {warm_s:.4f}s ({res.resident_pages} resident "
            f"pages); launches {launches}; join builds {int(builds)}, grouped pages "
            f"{int(pages)}")
    return out


# phase 14: windows, FULL joins and the rest of the aggregates at TPC-H SF1
P14_SQL = {
    # two window specifications over orders, checked through order-free sums
    # (row_number among equal prices depends on page order under 4 drivers)
    "window orders": (
        "select o_orderpriority, count(*), sum(rs), sum(rn), sum(rn * rn), sum(rk), "
        "sum(rk * o_orderkey), max(rk) from (select o_orderkey, o_orderpriority, "
        "sum(o_totalprice) over (partition by o_custkey order by o_orderkey) rs, "
        "row_number() over (partition by o_orderpriority order by o_totalprice desc) rn, "
        "rank() over (partition by o_orderpriority order by o_totalprice desc) rk "
        "from orders) t group by 1 order by 1"),
    # the top 3 lines of each order, with the previous line's price
    "window lineitem": (
        "select count(*), sum(l_extendedprice), count(prev), sum(prev), sum(rk) from "
        "(select l_extendedprice, rank() over (partition by l_orderkey order by "
        "l_extendedprice desc) rk, lag(l_extendedprice) over (partition by l_orderkey "
        "order by l_linenumber) prev from lineitem) t where rk <= 3"),
    # a unique build (customer); the customers without orders come from the epilogue
    "full orders customer": (
        "select count(*), count(o_orderkey), count(c_custkey), sum(o_totalprice), "
        "sum(c_acctbal) from orders full join customer on o_custkey = c_custkey"),
    # a duplicate-key build (orders by o_custkey): expansion and visited marks
    "full customer orders": (
        "select count(*), count(o_orderkey), count(c_custkey), sum(o_totalprice), "
        "sum(c_acctbal) from customer full join orders on c_custkey = o_custkey"),
    "agg dashboard": (
        "select l_returnflag, l_linestatus, approx_distinct(l_orderkey), "
        "approx_percentile(l_extendedprice, 0.5), stddev(l_quantity), "
        "var_pop(l_extendedprice), corr(l_quantity, l_extendedprice), "
        "min_by(l_orderkey, l_extendedprice), max_by(l_orderkey, l_shipdate), "
        "bool_and(l_quantity > 0), count_if(l_discount > 0.05), arbitrary(l_shipmode), "
        "min(l_extendedprice), max(l_shipdate), count(*) from lineitem group by 1, 2 "
        "order by 1, 2"),
    "agg dashboard global": (
        "select approx_distinct(l_orderkey), approx_percentile(l_extendedprice, 0.5), "
        "stddev(l_quantity), var_pop(l_extendedprice), corr(l_quantity, l_extendedprice), "
        "min_by(l_orderkey, l_extendedprice), max_by(l_orderkey, l_shipdate), "
        "bool_and(l_quantity > 0), count_if(l_discount > 0.05), arbitrary(l_shipmode), "
        "min(l_extendedprice), max(l_shipdate), count(*) from lineitem"),
    # a per-day dashboard: ~2,400 DATE groups through the insert kernel
    "agg per day": (
        "select o_orderdate, min_by(o_orderkey, o_totalprice), min(o_totalprice), "
        "stddev(o_totalprice), count_if(o_orderstatus = 'F'), count(*) from orders "
        "group by 1 order by 1"),
    # a sketch grouping above WIDE_STATE_MAX_GROUPS (~30,000 groups, each page
    # under 8,192 of them): its wide partials spill to host RAM
    "agg sketch spill": (
        "select o_orderkey / 200, approx_distinct(o_custkey), count(*) from orders "
        "group by 1 order by 1"),
}
# the sums-of-powers statistics (stddev, var_pop, corr) against their exact
# values: float64 sums taken by atomics in a changing order, then the
# reference's E[x^2] - E[x]^2 formula
STAT_REL_TOL = 1e-9
# HyperLogLog with m = 2048: three standard errors (1.04 / sqrt(m) each)
HLL_REL_TOL = 3 * 1.04 / 2048 ** 0.5
# the bound of the reference's own test of approx_percentile
PCT_REL_TOL = 0.10
# a small group's HyperLogLog estimate (linear counting, ~50 distinct
# values in 2,048 registers) is off by about its register collisions,
# Poisson with mean n^2 / 2m ~ 0.6: over 30,000 groups the largest is ~6
HLL_SMALL_ABS_TOL = 8
# ... and the groups' estimates together (linear counting rounds up)
HLL_SUM_REL_TOL = 0.02
# the columns that depend on page order among equal ordering values (the
# winning row of min_by/max_by): held to the oracle's set of rows, not to
# the CPU run
P14_ORDER_DEPENDENT = {"agg dashboard": (7, 8), "agg dashboard global": (5, 6),
                       "agg per day": (1,)}


def _stats(x, y=None):
    """Exact stddev_samp(x), var_pop(x) and corr(x, y) of integer columns
    (Fractions), as floats."""
    from fractions import Fraction

    n = len(x)
    sx, sxx = int(x.sum()), int((x.astype(object) ** 2).sum())
    var_pop = Fraction(sxx * n - sx * sx, n * n)
    out = {"var_pop": float(var_pop),
           "stddev": float(var_pop * n / max(n - 1, 1)) ** 0.5}
    if y is not None:
        sy, syy = int(y.sum()), int((y.astype(object) ** 2).sum())
        sxy = int((x.astype(object) * y.astype(object)).sum())
        cov = Fraction(sxy * n - sx * sy, 1)
        vx, vy = Fraction(sxx * n - sx * sx, 1), Fraction(syy * n - sy * sy, 1)
        out["corr"] = float(cov) / (float(vx) * float(vy)) ** 0.5
    return out


def _close(a, b, rel: float) -> bool:
    import math

    return isinstance(a, float) and math.isclose(a, b, rel_tol=rel, abs_tol=0.0)


def _check_dashboard(row, li, sel, base: int, label: str) -> None:
    """One dashboard row against the lineitem rows ``sel``: the sketches
    within their bounds, the statistics to STAT_REL_TOL, min_by/max_by's
    payload a row holding the extreme, and the rest exact."""
    from presto_tpu_torch.connectors.tpch import generator as g

    price = li["l_extendedprice"][sel].astype(np.int64)
    qty = li["l_quantity"][sel].astype(np.int64)
    okey = li["l_orderkey"][sel]
    ship = li["l_shipdate"][sel].astype(np.int64)
    exact_distinct = len(np.unique(okey))
    if abs(row[base] - exact_distinct) > HLL_REL_TOL * exact_distinct:
        raise AssertionError(f"P14 {label}: approx_distinct {row[base]} vs {exact_distinct}")
    median = int(np.sort(price)[len(price) // 2])
    if abs(float(row[base + 1]) * 100 - median) > PCT_REL_TOL * median:
        raise AssertionError(f"P14 {label}: approx_percentile {row[base + 1]} vs {median / 100}")
    st = _stats(qty, price)
    for i, name, scale in ((base + 2, "stddev", 100.0), (base + 3, "var_pop", 1e4),
                           (base + 4, "corr", 1.0)):
        want = (_stats(qty)["stddev"] / scale if name == "stddev" else
                _stats(price)["var_pop"] / scale if name == "var_pop" else st["corr"])
        if not _close(row[i], want, STAT_REL_TOL):
            raise AssertionError(f"P14 {label}: {name} {row[i]} vs {want}")
    if row[base + 5] not in set(okey[price == price.min()].tolist()):
        raise AssertionError(f"P14 {label}: min_by's order {row[base + 5]} has no minimal price")
    if row[base + 6] not in set(okey[ship == ship.max()].tolist()):
        raise AssertionError(f"P14 {label}: max_by's order {row[base + 6]} has no latest date")
    modes = li["l_shipmode"][sel].astype(np.int64)
    want = [bool((qty > 0).all()), int((li["l_discount"][sel] > 5).sum()),
            g.DICT_SHIP_MODE.values[int(modes.max())], Decimal(int(price.min())) / 100,
            datetime.date(1970, 1, 1) + datetime.timedelta(days=int(ship.max())), len(price)]
    if row[base + 7:] != want:
        raise AssertionError(f"P14 {label}: {row[base + 7:]} vs {want}")


def check_p14_rows(label: str, rows, schema: str) -> None:
    """Phase 14's query ``label`` against a numpy oracle over the port's
    generator; raises on a mismatch."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    n_orders = g.table_row_count("orders", sf)
    if label == "window orders":
        o = _table("orders", sf, ["o_orderkey", "o_custkey", "o_totalprice", "o_orderpriority"])
        key, cust = o["o_orderkey"].astype(np.int64), o["o_custkey"].astype(np.int64)
        price, pri = o["o_totalprice"].astype(np.int64), o["o_orderpriority"].astype(np.int64)
        order = np.lexsort((key, cust))
        cs = np.cumsum(price[order])
        new = np.ones(len(order), dtype=bool)
        new[1:] = cust[order][1:] != cust[order][:-1]
        start = np.maximum.accumulate(np.where(new, np.arange(len(order)), 0))
        rs = np.empty_like(cs)
        rs[order] = cs - np.where(start > 0, cs[np.maximum(start - 1, 0)], 0)
        order = np.lexsort((-price, pri))
        sp, spr = pri[order], price[order]
        newp = np.ones(len(order), dtype=bool)
        newp[1:] = sp[1:] != sp[:-1]
        newk = newp.copy()
        newk[1:] |= spr[1:] != spr[:-1]
        idx = np.arange(len(order))
        pstart = np.maximum.accumulate(np.where(newp, idx, 0))
        kstart = np.maximum.accumulate(np.where(newk, idx, 0))
        rk = np.empty(len(order), dtype=np.int64)
        rk[order] = kstart - pstart + 1
        want = []
        for code in np.unique(pri):
            sel = pri == code
            n = int(sel.sum())
            want.append([g.DICT_PRIORITY.values[int(code)], n, Decimal(int(rs[sel].sum())) / 100,
                         n * (n + 1) // 2, n * (n + 1) * (2 * n + 1) // 6, int(rk[sel].sum()),
                         int((rk[sel] * key[sel]).sum()), int(rk[sel].max())])
        want.sort(key=lambda r: r[0])
    elif label == "window lineitem":
        li = g.lineitem_for_orders(0, n_orders, sf, ["l_orderkey", "l_linenumber",
                                                     "l_extendedprice"])
        okey, line = li["l_orderkey"].astype(np.int64), li["l_linenumber"].astype(np.int64)
        price = li["l_extendedprice"].astype(np.int64)
        idx = np.arange(len(okey))
        order = np.lexsort((-price, okey))
        so, sp = okey[order], price[order]
        newp = np.ones(len(order), dtype=bool)
        newp[1:] = so[1:] != so[:-1]
        newk = newp.copy()
        newk[1:] |= sp[1:] != sp[:-1]
        rk = np.empty(len(order), dtype=np.int64)
        rk[order] = np.maximum.accumulate(np.where(newk, idx, 0)) - \
            np.maximum.accumulate(np.where(newp, idx, 0)) + 1
        order = np.lexsort((line, okey))
        so = okey[order]
        has_prev = np.zeros(len(order), dtype=bool)
        has_prev[1:] = so[1:] == so[:-1]
        prev_sorted = np.concatenate([[0], price[order][:-1]])
        prev, prev_ok = np.empty_like(price), np.empty(len(order), dtype=bool)
        prev[order], prev_ok[order] = prev_sorted, has_prev
        keep = rk <= 3
        want = [[int(keep.sum()), Decimal(int(price[keep].sum())) / 100,
                 int((keep & prev_ok).sum()), Decimal(int(prev[keep & prev_ok].sum())) / 100,
                 int(rk[keep].sum())]]
    elif label.startswith("full"):
        c = _table("customer", sf, ["c_custkey", "c_acctbal"])
        o = _table("orders", sf, ["o_custkey", "o_totalprice"])
        pos, hit = _find(c["c_custkey"], o["o_custkey"])
        if not hit.all():
            raise AssertionError("an order without its customer in the generator")
        per = np.bincount(pos, minlength=len(c["c_custkey"]))
        bal = c["c_acctbal"].astype(np.int64)
        total = len(o["o_custkey"]) + int((per == 0).sum())
        want = [[total, len(o["o_custkey"]), total,
                 Decimal(int(o["o_totalprice"].astype(np.int64).sum())) / 100,
                 Decimal(int((bal * np.maximum(per, 1)).sum())) / 100]]
    elif label.startswith("agg dashboard"):
        li = g.lineitem_for_orders(0, n_orders, sf, [
            "l_orderkey", "l_extendedprice", "l_quantity", "l_discount", "l_shipdate",
            "l_returnflag", "l_linestatus", "l_shipmode"])
        if label == "agg dashboard global":
            if len(rows) != 1:
                raise AssertionError(f"P14 {label}: {len(rows)} rows")
            _check_dashboard(rows[0], li, np.ones(len(li["l_orderkey"]), dtype=bool), 0, label)
            return
        groups = sorted({(g.DICT_RETURNFLAG.values[f], g.DICT_LINESTATUS.values[s])
                         for f, s in zip(li["l_returnflag"].tolist(), li["l_linestatus"].tolist())})
        if [tuple(r[:2]) for r in rows] != groups:
            raise AssertionError(f"P14 {label}: groups {[r[:2] for r in rows]} vs {groups}")
        for row in rows:
            sel = (li["l_returnflag"] == g.DICT_RETURNFLAG.code_of(row[0])) & \
                  (li["l_linestatus"] == g.DICT_LINESTATUS.code_of(row[1]))
            _check_dashboard(row, li, sel, 2, label)
        return
    elif label == "agg per day":
        o = _table("orders", sf, ["o_orderkey", "o_orderdate", "o_totalprice", "o_orderstatus"])
        day, price = o["o_orderdate"].astype(np.int64), o["o_totalprice"].astype(np.int64)
        days = np.unique(day)
        if [r[0] for r in rows] != [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
                                    for d in days]:
            raise AssertionError(f"P14 {label}: the days differ")
        order = np.argsort(day, kind="stable")
        bounds = np.searchsorted(day[order], days, side="left").tolist() + [len(day)]
        f_code = g.DICT_ORDERSTATUS.code_of("F")
        for r, lo, hi in zip(rows, bounds[:-1], bounds[1:]):
            sel = order[lo:hi]
            p = price[sel]
            if r[1] not in set(o["o_orderkey"][sel][p == p.min()].tolist()):
                raise AssertionError(f"P14 {label}: min_by's order {r[1]} on {r[0]}")
            want_sd = _stats(p)["stddev"] / 100
            if r[2] != Decimal(int(p.min())) / 100 or not _close(r[3], want_sd, STAT_REL_TOL) \
                    or r[4] != int((o["o_orderstatus"][sel] == f_code).sum()) or r[5] != len(p):
                raise AssertionError(f"P14 {label}: {r} on {r[0]}")
        return
    elif label == "agg sketch spill":
        o = _table("orders", sf, ["o_orderkey", "o_custkey"])
        bucket = o["o_orderkey"].astype(np.int64) // 200
        pairs = np.unique(np.stack([bucket, o["o_custkey"].astype(np.int64)]), axis=1)
        keys, exact = np.unique(pairs[0], return_counts=True)
        counts = np.bincount(np.searchsorted(keys, bucket), minlength=len(keys))
        if [r[0] for r in rows] != keys.tolist() or [r[2] for r in rows] != counts.tolist():
            raise AssertionError(f"P14 {label}: groups or counts differ")
        got = np.asarray([r[1] for r in rows])
        err = np.abs(got - exact)
        if (err > np.maximum(HLL_REL_TOL * exact, HLL_SMALL_ABS_TOL)).any():
            raise AssertionError(f"P14 {label}: approx_distinct off by up to {int(err.max())}")
        if abs(int(got.sum()) - int(exact.sum())) > HLL_SUM_REL_TOL * exact.sum():
            raise AssertionError(f"P14 {label}: the estimates sum to {int(got.sum())} against "
                                 f"{int(exact.sum())}")
        return
    else:
        raise KeyError(label)
    if not same_rows(rows, want):
        raise AssertionError(f"P14 {label}: rows differ from the numpy oracle:\n"
                             f"{rows[:5]}\n{want[:5]}")


def same_p14_rows(label: str, got, want) -> bool:
    """The card's rows against the CPU run's: exact (DOUBLE statistics to
    STAT_REL_TOL), but for the order-dependent min_by/max_by payloads,
    which the oracle holds instead."""
    skip = P14_ORDER_DEPENDENT.get(label, ())
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if i in skip:
                continue
            if isinstance(a, float) or isinstance(b, float):
                if not _close(a, b, STAT_REL_TOL):
                    return False
            elif type(a) is not type(b) or a != b:
                return False
    return True


def check_insert_at(device, label: str, comps, mask, slots, reps: int = 20,
                    plain_reps: int = 3) -> dict:
    """The insert against its plain version, bit for bit, at one captured
    shape, with its times and its bound; returns them."""
    from presto_tpu_torch.ops import pallas_hash as ph

    got = ph.insert_table(comps, mask, slots)
    err = _max_abs_err(zip(got, ph.insert_table_reference(comps, mask, slots)))
    if err != 0:
        raise AssertionError(f"{label} insert differs from its plain version: {err}")
    ncomps, n = comps.shape
    live = int(mask.sum())
    nbytes = n + live * ncomps * 8 + n * 4 + ncomps * slots * 8 + slots * 4 + 3 * 4
    out = {"ms": time_ms(lambda: ph.insert_table(comps, mask, slots), reps, device),
           "device_ms": device_ms(ph.insert_table, (comps, mask, slots), reps),
           "plain_ms": time_ms(lambda: ph.insert_table_reference(comps, mask, slots),
                               plain_reps, device),
           "bound_ms": nbytes / HBM_RATE * 1e3}
    log(f"KERNEL insert at the {label} shape: ncomps={ncomps} n={n} live={live} slots={slots}: "
        f"bit-identical, stats {got[3].tolist()}; kernel {out['ms']:.4f} ms (device "
        f"{out['device_ms']:.4f} ms), plain {out['plain_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({nbytes} bytes)")
    return out


def run_p14_phase(device, schema: str = "sf1") -> dict:
    """Phase 14: windows, FULL joins and the new aggregates at TPC-H
    ``schema`` with ``hash_kernels="pallas"`` under the full defaults: each
    query cold (cache cleared; its kernel inputs captured), warm (launch
    counters and ``COUNTERS`` set to 0 just before it, the peak device
    memory reset) and on the CPU. Fails unless the rows equal the numpy
    oracle's and the CPU run's, the insert launched once per join build and
    grouped page, nothing fell back, the per-day grouping took the insert
    (and the insert equals its plain version at that shape) and the sketch
    grouping spilled. Returns the records."""
    import torch

    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    extra = ("join.unmatched_build_rows", "agg.spilled_folds")
    out = {}
    for label, sql in P14_SQL.items():
        runner = sql_runner(device, "pallas", schema)
        RESIDENT_CACHE.clear()
        capture = KernelCapture()
        t0 = time.perf_counter()
        with capture:
            runner.execute(sql)
            sync()
        cold_s = time.perf_counter() - t0
        before = {k: METRICS.counter_value(k) for k in COUNTERS + extra}
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        base_mem = torch.cuda.memory_allocated(device) if on_card else 0
        t0 = time.perf_counter()
        res = runner.execute(sql)
        sync()
        warm_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS + extra}
        check_p14_rows(label, res.rows, schema)
        t0 = time.perf_counter()
        cpu_rows = sql_runner("cpu", "pallas", schema).execute(sql).rows
        cpu_s = time.perf_counter() - t0
        check_p14_rows(label, cpu_rows, schema)
        if not same_p14_rows(label, res.rows, cpu_rows):
            raise AssertionError(f"P14 {label}: the card's rows differ from the CPU run's:\n"
                                 f"{res.rows[:3]}\n{cpu_rows[:3]}")
        builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
        if on_card and launches["insert"] != builds + pages:
            raise AssertionError(f"P14 {label}: insert launches {launches['insert']} != "
                                 f"join builds {builds} + grouped pages {pages}")
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"P14 {label}: a fallback: {delta}")
        rec = {"rows": res.rows, "launches": launches, "delta": delta}
        kind = label.split()[0].upper().replace("FULL", "FULLJOIN")
        if label == "agg per day":
            if pages <= 0:
                raise AssertionError(f"P14 {label}: no page was grouped through the insert")
            if capture.grouping is None:
                raise AssertionError(f"P14 {label}: the cold run captured no grouping insert")
            comps, mask, slots = capture.grouping
            if on_card:
                rec["insert"] = check_insert_at(device, "phase 14 per-day DATE grouping",
                                                comps, mask, slots)
        if label == "agg sketch spill" and delta["agg.spilled_folds"] <= 0:
            raise AssertionError(f"P14 {label}: the wide partials did not spill")
        out[label] = rec
        log(f"{kind} {label} {schema}: {len(res.rows)} rows equal to the numpy oracle and to "
            f"the CPU run ({cpu_s:.2f}s on the host); drivers per pipeline {res.drivers}; "
            f"cold wall {cold_s:.4f}s, warm wall {warm_s:.4f}s; launches {launches}; join "
            f"builds {int(builds)}, grouped pages {int(pages)}; epilogue rows "
            f"{int(delta['join.unmatched_build_rows'])}, spilled folds "
            f"{int(delta['agg.spilled_folds'])}, expansion chunks "
            f"{int(delta['join.expansion_chunks'])}; device memory {base_mem / 2**30:.3f} GiB "
            f"before, peak {peak / 2**30:.3f} GiB")
    return out


WRITE_TABLES = ("lineitem", "orders", "customer")
# a shipping mode no generated row has: it sorts inside the dictionary, so
# the table's dictionary grows out of order
NEW_SHIPMODE = "BOAT"
# the new built-ins over lineitem (phase 15), with their numpy oracles in
# oracle_functions: DECIMAL results exact, DOUBLE sums to FUNC_REL_TOL
FUNCTIONS_SQL = (
    "select count(*), sum(floor(l_extendedprice)), sum(ceil(l_tax)), "
    "sum(ceiling(l_extendedprice / 7)), sum(round(l_extendedprice)), "
    "sum(round(l_extendedprice, 1)), sum(truncate(l_extendedprice)), "
    "sum(abs(l_extendedprice - 50000)), sum(sign(l_discount - 0.05)), "
    "sum(greatest(l_quantity, 25)), sum(least(l_tax, l_discount)), "
    "sum(sqrt(l_quantity)), sum(ln(l_extendedprice)), sum(log10(l_extendedprice)), "
    "sum(exp(l_discount)), sum(log2(l_quantity)), sum(cbrt(l_extendedprice)), "
    "sum(power(l_discount, 2)), sum(quarter(l_shipdate)), sum(week(l_shipdate)), "
    "sum(day_of_week(l_shipdate)), sum(dow(l_commitdate)), sum(day_of_year(l_shipdate)), "
    "sum(doy(l_receiptdate)), sum(length(l_shipmode)), "
    "count_if(upper(l_shipmode) = 'MAIL'), count_if(lower(l_shipinstruct) = 'none') "
    "from lineitem")
# a DOUBLE sum over 6 M rows adds in an order that changes with the drivers
FUNC_REL_TOL = 1e-9


def _host_bytes(pages) -> int:
    """Bytes the stored pages hold in host RAM (data, NULL flags, masks)."""
    total = 0
    for p in pages:
        total += p.mask.numel() * p.mask.element_size()
        for b in p.blocks:
            total += b.data.numel() * b.data.element_size()
            if b.nulls is not None:
                total += b.nulls.numel() * b.nulls.element_size()
    return total


def _table_pages(runner, table: str):
    """The host pages ``memory.default.<table>`` holds."""
    from presto_tpu_torch.spi.connector import SchemaTableName

    mem = runner.catalogs.get("memory").metadata()
    return mem.table_data(mem.get_table_handle(SchemaTableName("default", table))).pages


def _table_dictionary(runner, table: str, column: str):
    """The dictionary of ``memory.default.<table>``'s ``column``."""
    from presto_tpu_torch.spi.connector import SchemaTableName

    mem = runner.catalogs.get("memory").metadata()
    handle = mem.get_table_handle(SchemaTableName("default", table))
    return mem.get_table_metadata(handle).column(column).dictionary


def oracle_functions(schema: str):
    """FUNCTIONS_SQL in numpy over the port's generator: DECIMAL columns are
    scaled int64 (scale 2), so floor/ceil/round/truncate are integer
    arithmetic, exact; date parts through the distinct dates' Python
    ``datetime`` values."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                                "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipmode",
                                "l_shipinstruct"])
    q, e, d, t = (li[c].astype(np.int64) for c in ("l_quantity", "l_extendedprice",
                                                    "l_discount", "l_tax"))

    def dec(units):  # a DECIMAL(.., 2) sum of scaled integers
        return Decimal(int(units.sum())) / 100

    def floor_div(a, m):
        return np.where(a >= 0, a // m, -((-a + m - 1) // m))

    def ceil_div(a, m):
        return np.where(a >= 0, (a + m - 1) // m, -((-a) // m))

    def round_half_away(a, m):
        return np.sign(a) * ((np.abs(a) + m // 2) // m)

    # ceiling(l_extendedprice / 7): DECIMAL / BIGINT divides as DOUBLE
    ext7 = np.ceil((e / 100.0) / 7.0)
    epoch = datetime.date(1970, 1, 1)

    def parts(days):
        uniq, inv = np.unique(days, return_inverse=True)
        ds = [epoch + datetime.timedelta(days=int(x)) for x in uniq]
        quarter = np.asarray([(x.month - 1) // 3 + 1 for x in ds])[inv]
        week = np.asarray([x.isocalendar()[1] for x in ds])[inv]
        dow = np.asarray([x.isoweekday() for x in ds])[inv]
        doy = np.asarray([x.timetuple().tm_yday for x in ds])[inv]
        return quarter, week, dow, doy

    sq, sw, sdow, sdoy = parts(li["l_shipdate"])
    _, _, cdow, _ = parts(li["l_commitdate"])
    _, _, _, rdoy = parts(li["l_receiptdate"])
    modes = np.asarray(g.DICT_SHIP_MODE.values, dtype=object)[li["l_shipmode"]]
    instr = np.asarray(g.DICT_SHIP_INSTRUCT.values, dtype=object)[li["l_shipinstruct"]]
    lengths = np.asarray([len(m) for m in g.DICT_SHIP_MODE.values])[li["l_shipmode"]]
    return [
        len(q),
        dec(floor_div(e, 100) * 100), dec(ceil_div(t, 100) * 100), float(ext7.sum()),
        dec(round_half_away(e, 100) * 100), dec(round_half_away(e, 10) * 10),
        dec(np.sign(e) * (np.abs(e) // 100) * 100), dec(np.abs(e - 5000000)),
        int(np.sign(d - 5).sum()), dec(np.maximum(q, 2500)), dec(np.minimum(t, d)),
        float(np.sqrt(q / 100.0).sum()), float(np.log(e / 100.0).sum()),
        float(np.log10(e / 100.0).sum()), float(np.exp(d / 100.0).sum()),
        float(np.log2(q / 100.0).sum()), float(np.cbrt(e / 100.0).sum()),
        float(((d / 100.0) ** 2).sum()), int(sq.sum()), int(sw.sum()), int(sdow.sum()),
        int(cdow.sum()), int(sdoy.sum()), int(rdoy.sum()), int(lengths.sum()),
        int((modes == "MAIL").sum()), int((instr == "NONE").sum()),
    ]


def _check_function_row(got, want) -> None:
    import math

    if len(got) != len(want):
        raise AssertionError(f"FUNCTIONS: {len(got)} columns, want {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, float):
            ok = isinstance(a, float) and math.isclose(a, b, rel_tol=FUNC_REL_TOL, abs_tol=0.0)
        else:
            ok = type(a) is type(b) and a == b
        if not ok:
            raise AssertionError(f"FUNCTIONS column {i}: {a!r} != {b!r}")


def oracle_collect(schema: str) -> dict:
    """Phase 15's collect groupings in numpy: each customer's order keys,
    the shipping-mode counts per (returnflag, linestatus), and each
    region's {nation name: key}."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    o = _table("orders", sf, ["o_orderkey", "o_custkey"])
    order = np.lexsort((o["o_orderkey"], o["o_custkey"]))
    ck, ok = o["o_custkey"][order], o["o_orderkey"][order]
    starts = np.flatnonzero(np.r_[True, ck[1:] != ck[:-1]])
    bounds = np.r_[starts, len(ck)]
    arrays = {int(ck[a]): ok[a:b].tolist() for a, b in zip(bounds[:-1], bounds[1:])}
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_returnflag", "l_linestatus", "l_shipmode"])
    hist = {}
    keys = np.stack([li["l_returnflag"], li["l_linestatus"], li["l_shipmode"]], 1)
    uniq, counts = np.unique(keys, axis=0, return_counts=True)
    for (f, st, m), c in zip(uniq.tolist(), counts.tolist()):
        k = (g.DICT_RETURNFLAG.values[f], g.DICT_LINESTATUS.values[st])
        hist.setdefault(k, {})[g.DICT_SHIP_MODE.values[m]] = c
    n = _table("nation", sf, ["n_nationkey", "n_name", "n_regionkey"])
    maps = {}
    for k, nm, r in zip(n["n_nationkey"].tolist(), n["n_name"].tolist(),
                        n["n_regionkey"].tolist()):
        maps.setdefault(r, {})[g.DICT_NATION_NAME.values[nm]] = k
    return {"arrays": arrays, "hist": hist, "maps": maps}


def run_write_phase(device, schema: str = "sf1") -> dict:
    """Phase 15: writes at TPC-H ``schema`` with ``hash_kernels="pallas"``
    under the session defaults, in one runner (its ``memory`` catalog):
    CTAS of ``lineitem``, ``orders`` and ``customer`` on the scaled writers,
    Q3 over the written tables and mixed with ``tpch`` (the kernels' path:
    the probe held bit-identical at the first shape a stored page gave it),
    a CTAS of Q3, INSERT SELECT, INSERT VALUES that grows a table's
    dictionary out of order, a blackhole CTAS, the collecting aggregates,
    the new built-ins, and DROP. Each step runs cold and warm (the warm
    step's launch counters set to 0 just before it); every result against
    a numpy count or oracle. Returns the records."""
    import torch

    from presto_tpu_torch.block import Block, Page
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    runner = sql_runner(device, "pallas", schema)
    out = {}

    def timed_run(sql):
        t0 = time.perf_counter()
        res = runner.execute(sql)
        sync()
        return res, time.perf_counter() - t0

    def warm(label, sql, setup=None):
        """A cold run, then ``setup`` and the warm run, counters zeroed."""
        res, cold_s = timed_run(sql)
        if setup is not None:
            setup()
        before = {k: METRICS.counter_value(k) for k in COUNTERS}
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        res, warm_s = timed_run(sql)
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"WRITE {label}: a fallback: {delta}")
        out[label] = {"rows": res.rows, "launches": launches, "delta": delta,
                      "cold_s": cold_s, "warm_s": warm_s}
        return res

    # 1. CTAS of three tables on the scaled writers (warm: drop, write again)
    sf = SCHEMAS[schema]
    ship = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                                 ["l_shipdate", "l_shipmode"])
    n_li = len(ship["l_shipdate"])
    RESIDENT_CACHE.clear()
    for t in WRITE_TABLES:
        src = f"select * from tpch.{schema}.{t}"
        n_want = n_li if t == "lineitem" else g.table_row_count(t, sf)
        writers = runner._scaled_writer_count(runner.plan_sql(src))
        res = warm(f"ctas {t}", f"create table memory.default.{t} as {src}",
                   setup=lambda t=t: runner.execute(f"drop table memory.default.{t}"))
        if res.rows != [[n_want]]:
            raise AssertionError(f"WRITE ctas {t}: {res.rows} rows, want {n_want}")
        pages = _table_pages(runner, t)
        pinned = all(p.mask.is_pinned() for p in pages) if on_card else None
        rec = out[f"ctas {t}"]
        log(f"WRITE ctas {t} {schema}: {n_want} rows; writer drivers {writers}; memory "
            f"pages {len(pages)}, host bytes {_host_bytes(pages)} (pinned {pinned}); cold wall "
            f"{rec['cold_s']:.4f}s ({n_want / rec['cold_s']:.0f} rows/s), warm wall "
            f"{rec['warm_s']:.4f}s ({n_want / rec['warm_s']:.0f} rows/s)")
    if schema == "sf1" and runner._scaled_writer_count(
            runner.plan_sql(f"select * from tpch.{schema}.lineitem")) != 4:
        raise AssertionError("WRITE: lineitem did not take 4 scaled writers")

    # the upload of the stored pages: pinned (as stored) against unpinned copies
    scan_sql = "select count(*), sum(l_quantity) from memory.default.lineitem"
    pinned_res, pinned_s = timed_run(scan_sql)
    pinned_res, pinned_s = timed_run(scan_sql)
    li_pages = _table_pages(runner, "lineitem")
    stored = list(li_pages)
    li_pages[:] = [Page(tuple(Block(b.type, b.data.clone(), None if b.nulls is None
                                    else b.nulls.clone(), b.dictionary) for b in p.blocks),
                        p.mask.clone()) for p in stored]
    unpinned_res, unpinned_s = timed_run(scan_sql)
    unpinned_res, unpinned_s = timed_run(scan_sql)
    li_pages[:] = stored
    if unpinned_res.rows != pinned_res.rows:
        raise AssertionError("WRITE: unpinned pages read differently")
    log(f"WRITE scan of memory lineitem {schema}: stored pinned {pinned_s:.4f}s, "
        f"unpinned copies {unpinned_s:.4f}s (warm walls of {scan_sql!r})")

    # 2. Q3 over the written tables (sorted builds: no unique column sets)
    want_q3 = oracle_q3(schema)[0]
    mem_q3 = QUERIES[3].replace("from customer, orders, lineitem",
                                "from memory.default.customer, memory.default.orders, "
                                "memory.default.lineitem")
    res = warm("q3 memory", mem_q3)
    if not same_rows(res.rows, want_q3):
        raise AssertionError(f"WRITE q3 memory: rows differ from the oracle:\n{res.rows[:3]}")
    # 3. the mixed query: the stored lineitem probes tpch's orders table
    mixed = QUERIES[3].replace("from customer, orders, lineitem",
                               f"from tpch.{schema}.customer, tpch.{schema}.orders, "
                               "memory.default.lineitem")
    capture = KernelCapture()
    with capture:
        timed_run(mixed)
    res = warm("q3 mixed", mixed)
    if not same_rows(res.rows, want_q3):
        raise AssertionError(f"WRITE q3 mixed: rows differ from the oracle:\n{res.rows[:3]}")
    rec = out["q3 mixed"]
    if rec["delta"]["pallas.join_builds"] <= 0 or (on_card and rec["launches"]["probe"] <= 0):
        raise AssertionError(f"WRITE q3 mixed: the kernels' path was not taken: {rec}")
    if on_card and rec["launches"]["insert"] != rec["delta"]["pallas.join_builds"] + \
            rec["delta"]["pallas.agg_pages"]:
        raise AssertionError(f"WRITE q3 mixed: insert launches {rec['launches']}")
    if not capture.by_table:
        raise AssertionError("WRITE q3 mixed: no probe of a stored page was captured")
    # the stored lineitem probes the larger (orders) table
    args = max(capture.by_table.values(), key=lambda a: a[1].shape[0])
    rec["probe"] = check_probe_at(device, "phase 15 mixed Q3 (a stored lineitem page)", *args)

    # 4. CTAS of Q3 over tpch, read back in its order
    res = warm("ctas q3", f"create table memory.default.q3 as {QUERIES[3]}",
               setup=lambda: runner.execute("drop table memory.default.q3"))
    back = runner.execute("select * from memory.default.q3 order by revenue desc, o_orderdate")
    if res.rows != [[len(want_q3)]] or not same_rows(back.rows, want_q3):
        raise AssertionError(f"WRITE ctas q3: {res.rows}, read back {back.rows[:3]}")

    # 5. INSERT SELECT: the count returned and the table's new count(*)
    n_ins = int((ship["l_shipdate"] >= civil_day(1998, 1, 1)).sum())
    res, ins_s = timed_run(f"insert into memory.default.lineitem select * from "
                           f"tpch.{schema}.lineitem where l_shipdate >= date '1998-01-01'")
    count = runner.execute("select count(*) from memory.default.lineitem").rows
    if res.rows != [[n_ins]] or count != [[n_li + n_ins]]:
        raise AssertionError(f"WRITE insert: {res.rows} and {count}, want {n_ins}, "
                             f"{n_li + n_ins}")
    log(f"WRITE insert select {schema}: {n_ins} rows in {ins_s:.4f}s "
        f"({n_ins / ins_s:.0f} rows/s); memory lineitem {len(_table_pages(runner, 'lineitem'))} "
        f"pages, {n_li + n_ins} rows")

    # 6. INSERT VALUES with a NULL and a new shipping mode into a narrow
    # table (VALUES literals are BIGINT and DECIMAL(p, s): the full
    # lineitem's INTEGER and DECIMAL(12,2) columns refuse them, as in the
    # reference)
    try:
        runner.execute("insert into memory.default.lineitem values (1, 2, 3, 4, 5.00, 6.00, "
                       "0.05, 0.01, 'R', 'F', date '1998-12-01', date '1998-12-02', "
                       "date '1998-12-03', 'NONE', 'BOAT', null)")
        raise AssertionError("WRITE: a VALUES row of lineitem was not refused")
    except ValueError as e:
        if str(e) != "INSERT type mismatch on l_linenumber: bigint vs integer":
            raise
    runner.execute("create table memory.default.modes as "
                   "select l_orderkey, l_shipmode, l_comment from memory.default.lineitem")
    probe_sql = (f"select min(l_shipmode), max(l_shipmode), count(l_shipmode), count(*), "
                 f"count_if(l_shipmode = '{NEW_SHIPMODE}') from memory.default.modes")
    n_modes = n_li + n_ins
    mode_names = np.asarray(g.DICT_SHIP_MODE.values, dtype=object)
    lo_mode, hi_mode = min(mode_names[np.unique(ship["l_shipmode"])]), \
        max(mode_names[np.unique(ship["l_shipmode"])])
    before_rows = runner.execute(probe_sql).rows
    if before_rows != [[lo_mode, hi_mode, n_modes, n_modes, 0]]:
        raise AssertionError(f"WRITE values before: {before_rows}")
    res, val_s = timed_run(f"insert into memory.default.modes values "
                           f"(0, '{NEW_SHIPMODE}', null), (0, null, null)")
    after_rows = runner.execute(probe_sql).rows
    hit = runner.execute(f"select l_orderkey, l_comment from memory.default.modes "
                         f"where l_shipmode = '{NEW_SHIPMODE}'").rows
    d = _table_dictionary(runner, "modes", "l_shipmode")
    if res.rows != [[2]] or after_rows != [[lo_mode, hi_mode, n_modes + 1, n_modes + 2, 1]] \
            or hit != [[0, None]] or d.is_sorted():
        raise AssertionError(f"WRITE values after: {res.rows} {after_rows} {hit} "
                             f"sorted={d.is_sorted()}")
    log(f"WRITE insert values {schema}: 2 rows in {val_s:.4f}s; l_shipmode dictionary "
        f"{len(d)} entries, sorted {d.is_sorted()}; min/max {after_rows[0][:2]}, "
        f"'{NEW_SHIPMODE}' rows {after_rows[0][4]}")

    # 7. blackhole
    res, bh_s = timed_run(f"create table blackhole.default.lineitem as "
                          f"select * from tpch.{schema}.lineitem")
    if res.rows != [[n_li]]:
        raise AssertionError(f"WRITE blackhole: {res.rows}, want {n_li}")
    log(f"WRITE blackhole ctas lineitem {schema}: {n_li} rows in {bh_s:.4f}s "
        f"({n_li / bh_s:.0f} rows/s)")

    # 8. the collecting aggregates, as multisets against numpy
    oc = oracle_collect(schema)
    res = warm("collect array_agg", "select o_custkey, array_agg(o_orderkey), "
               "cardinality(array_agg(o_orderkey)) from orders group by 1")
    got = {r[0]: r for r in res.rows}
    if len(got) != len(oc["arrays"]) or any(
            sorted(got[k][1]) != v or got[k][2] != len(v) for k, v in oc["arrays"].items()):
        raise AssertionError("WRITE collect array_agg: groups differ from numpy")
    res = warm("collect histogram", "select l_returnflag, l_linestatus, histogram(l_shipmode), "
               "count(*) from lineitem group by 1, 2")
    got = {(r[0], r[1]): (r[2], r[3]) for r in res.rows}
    if got != {k: (v, sum(v.values())) for k, v in oc["hist"].items()}:
        raise AssertionError(f"WRITE collect histogram: {got} != {oc['hist']}")
    res = warm("collect map_agg", "select n_regionkey, map_agg(n_name, n_nationkey) "
               "from nation group by 1")
    if {r[0]: r[1] for r in res.rows} != oc["maps"]:
        raise AssertionError(f"WRITE collect map_agg: {res.rows}")

    # 9. the new built-ins
    res = warm("functions", FUNCTIONS_SQL)
    _check_function_row(res.rows[0], oracle_functions(schema))

    # 10. DROP every table
    for t in WRITE_TABLES + ("q3", "modes"):
        runner.execute(f"drop table memory.default.{t}")
    runner.execute("drop table blackhole.default.lineitem")
    left = runner.execute("show tables from memory.default").rows
    if left:
        raise AssertionError(f"WRITE: tables left after DROP: {left}")
    for label in ("q3 memory", "q3 mixed", "ctas q3", "collect array_agg",
                  "collect histogram", "collect map_agg", "functions"):
        rec = out[label]
        log(f"WRITE {label} {schema}: {len(rec['rows'])} rows equal to the numpy oracle; "
            f"cold wall {rec['cold_s']:.4f}s, warm wall {rec['warm_s']:.4f}s; launches "
            f"{rec['launches']}; join builds {int(rec['delta']['pallas.join_builds'])}, "
            f"grouped pages {int(rec['delta']['pallas.agg_pages'])}")
    return out


# phase 16: the plugin libraries, EXPLAIN ANALYZE and memory revocation at
# TPC-H SF1
EXPLAIN_QUERIES = (3, 9, 18)
# the plugin functions over lineitem, each against a numpy oracle
P16_POLYGON = "POLYGON((0 0, 30 0, 40 6, 20 10, 0 4))"
P16_SQL = {
    "geo": ("select count(*), count_if(st_contains(st_geometryfromtext('" + P16_POLYGON +
            "'), st_point(l_quantity, l_discount * 100))), sum(st_distance(st_point("
            "l_quantity, l_discount * 100), st_point(25, 5))), sum(st_y(st_point("
            "l_quantity, l_tax * 100))) from lineitem"),
    "great circle": ("select sum(great_circle_distance(l_quantity - 25, l_discount * 1000, "
                     "l_tax * 1000 - 40, l_linenumber * 20)) from lineitem"),
    "teradata": ("select l_shipmode, index(l_shipmode, 'AI'), char2hexint(l_shipmode), "
                 "reverse(l_shipmode), count(*) from lineitem group by 1, 2, 3, 4 order by 1"),
    "regr": ("select regr_slope(l_extendedprice, l_quantity), regr_intercept(l_extendedprice, "
             "l_quantity), regr_r2(l_extendedprice, l_quantity), count(*) from lineitem"),
    "learn": "select learn_linear_regressor(l_extendedprice, l_quantity) from lineitem",
    "regress": ("select avg(abs(regress(m, l_quantity) - l_extendedprice)), count(*) from "
                "lineitem, (select learn_linear_regressor(l_extendedprice, l_quantity) m "
                "from lineitem)"),
}
PLUGIN_REL_TOL = 1e-9
# the queries held under a one-byte pool, and the TPC-DS query whose
# accounted peak is printed beside the allocator's
PRESSURE = {"memory_pool_bytes": 1}
PEAK_DS_QUERY = 64


def _crossing(px, py, ring):
    """The crossing-number test of ``functions/geospatial.py`` in numpy,
    with the same float64 operations in the same order."""
    inside = np.zeros(px.shape, dtype=bool)
    m = len(ring)
    for i in range(m):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % m]
        straddles = (y1 > py) != (y2 > py)
        dy = y2 - y1 if y2 != y1 else 1e-300
        xcross = x1 + (py - y1) * (x2 - x1) / dy
        inside ^= straddles & (px < xcross)
    return inside


def oracle_plugins(schema: str) -> dict:
    """The plugin queries of ``P16_SQL`` in numpy over the port's generator."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_quantity", "l_discount", "l_tax", "l_linenumber",
                                "l_extendedprice", "l_shipmode"])
    qty = li["l_quantity"].astype(np.int64) / 100.0          # DECIMAL(12, 2)
    disc = li["l_discount"].astype(np.int64) * 100 / 100.0   # l_discount * 100
    tax = li["l_tax"].astype(np.int64) * 100 / 100.0
    price = li["l_extendedprice"].astype(np.int64) / 100.0
    ring = [tuple(float(v) for v in p.split()) for p in P16_POLYGON[9:-2].split(",")]
    out = {"geo": [len(qty), int(_crossing(qty, disc, ring).sum()),
                   float(np.abs((qty + 1j * disc) - (25 + 5j)).sum()), float(tax.sum())]}
    lat1 = np.deg2rad((li["l_quantity"].astype(np.int64) - 2500) / 100.0)
    lon1 = np.deg2rad(li["l_discount"].astype(np.int64) * 1000 / 100.0)
    lat2 = np.deg2rad((li["l_tax"].astype(np.int64) * 1000 - 4000) / 100.0)
    lon2 = np.deg2rad(li["l_linenumber"].astype(np.float64) * 20)
    h = np.sin((lat2 - lat1) / 2) ** 2 + \
        np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2
    out["great circle"] = [float((2 * 6371.01 * np.arcsin(np.sqrt(h))).sum())]
    modes, counts = np.unique(li["l_shipmode"].astype(np.int64), return_counts=True)
    names = [str(g.DICT_SHIP_MODE.values[int(c)]) for c in modes]
    out["teradata"] = sorted([n, n.find("AI") + 1, n.encode("utf-16-be").hex().upper(),
                              n[::-1], int(k)] for n, k in zip(names, counts))
    n = float(len(qty))
    sx, sy, sxy, sxx, syy = qty.sum(), price.sum(), (qty * price).sum(), (qty * qty).sum(), \
        (price * price).sum()
    cov, varx, vary = sxy - sx * sy / n, sxx - sx * sx / n, syy - sy * sy / n
    slope = cov / varx
    out["regr"] = [slope, (sy - slope * sx) / n, cov * cov / (varx * vary), len(qty)]
    xtx = np.array([[n, sx], [sx, sxx]])
    coef = np.linalg.solve(xtx + 1e-9 * np.eye(2), np.array([sy, sxy]))
    out["learn"] = [float(coef[0]), float(coef[1])]
    out["regress"] = [float(np.abs(coef[0] + coef[1] * qty - price).mean()), len(qty)]
    return out


def check_plugin_rows(label: str, rows, want) -> None:
    """Exact where the result is exact (counts, strings, the polygon test);
    DOUBLE sums and the regression to ``PLUGIN_REL_TOL``."""
    if label == "teradata":
        if rows != want:
            raise AssertionError(f"P16 {label}: {rows} vs {want}")
        return
    got = rows[0]
    if label == "learn":
        m = json.loads(got[0])
        got = [m["intercept"]] + m["coefficients"]
    if len(got) != len(want):
        raise AssertionError(f"P16 {label}: {got} vs {want}")
    for a, b in zip(got, want):
        if isinstance(b, int) and not isinstance(b, bool):
            if a != b:
                raise AssertionError(f"P16 {label}: {got} vs {want}")
        elif not _close(float(a), float(b), PLUGIN_REL_TOL):
            raise AssertionError(f"P16 {label}: {got} vs {want} (relative {PLUGIN_REL_TOL})")


class PoolPeak:
    """Records, while on, the most bytes any query held in the shared pool
    (its reserved and revocable ledgers together): the accounted peak."""

    def __enter__(self):
        from presto_tpu_torch.memory import shared_general_pool

        self.pool = pool = shared_general_pool()
        self.reserve = pool.reserve
        self.peak = 0
        cap = self

        def reserve(query_id, delta, revocable=False):
            cap.reserve(query_id, delta, revocable)
            cap.peak = max(cap.peak, pool.query_bytes(query_id))

        pool.reserve = reserve
        return self

    def __exit__(self, *exc):
        del self.pool.reserve  # the bound method again
        return False


def _explain_table(rows):
    """EXPLAIN ANALYZE text -> (drivers in the header, {(pipeline, operator
    index, name): (in rows, out rows)})."""
    lines = [r[0] for r in rows]
    drivers = int(lines[0].split("wall, ")[1].split(" drivers")[0])
    ops, pipe, i = {}, None, 0
    for line in lines[4:]:
        if not line.strip():
            break
        if line.startswith("pipeline "):
            pipe, i = int(line.split()[1].rstrip(":")), 0
            continue
        parts = line.split()
        ops[(pipe, i, " ".join(parts[:-5]))] = (int(parts[-5]), int(parts[-4]))
        i += 1
    return drivers, ops


SPILL_COUNTERS = ("memory.revoked_bytes", "spill.bytes_written", "spill.bytes_read",
                  "pcol.native_opens", "pcol.numpy_opens")


def _warm(runner, sql, sync, spills_of=None):
    """One run with the launch counters and ``COUNTERS`` set to 0 just
    before it: (result, wall, launches, counter deltas (with the bytes moved
    to host and to disk), memory.spill events per operator)."""
    import collections

    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.utils import events
    from presto_tpu_torch.utils.metrics import METRICS

    keys = COUNTERS + SPILL_COUNTERS
    before = {k: METRICS.counter_value(k) for k in keys}
    seq = events.JOURNAL.last_seq()
    ph.insert_table.launches = 0
    ph.probe_table.launches = 0
    t0 = time.perf_counter()
    res = runner.execute(sql)
    sync()
    wall = time.perf_counter() - t0
    launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
    delta = {k: METRICS.counter_value(k) - before[k] for k in keys}
    spills = collections.Counter(e["operator"] for e in
                                 events.JOURNAL.events(since=seq, kind="memory.spill",
                                                       limit=1 << 20))
    return res, wall, launches, delta, dict(spills)


def run_memory_phase(device, records: dict, schema: str = "sf1") -> dict:
    """Phase 16 at TPC-H ``schema`` with ``hash_kernels="pallas"``:
    EXPLAIN ANALYZE of Q3, Q9 and Q18 under the defaults against a plain
    run's operator rows and drivers; Q3, Q18 and a window under a one-byte
    pool with the disk rung on (rows against the oracles and phase 11's card
    rows, Q3's kernel launches against its unpressured run; Q3's and Q18's
    revoked bytes go on to disk, the window's stay in host RAM); a query
    over its memory limit;
    the accounted peak beside the allocator's for Q3, Q9 and TPC-DS Q64;
    the plugin functions over ``lineitem`` against numpy. Returns the
    records whose launches the kernels line reports."""
    import torch

    from presto_tpu_torch.exec.explain import driver_stats
    from presto_tpu_torch.memory import ExceededMemoryLimitException, shared_general_pool
    from presto_tpu_torch.models.tpcds_sql import QUERIES as DS_QUERIES
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.utils import events

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    # spills under the defaults in the phases before this one
    earlier = events.JOURNAL.events(kind="memory.spill", limit=1 << 20)
    log(f"MEMORY before phase 16: {len(earlier)} memory.spill events under the session "
        f"defaults ({sorted(set(e['operator'] for e in earlier))})")

    # 1. EXPLAIN ANALYZE against a plain run of the same query
    for q in EXPLAIN_QUERIES:
        runner = sql_runner(device, "pallas", schema)
        exec_plan, drivers, _ = runner._run_plan(runner.plan_sql(QUERIES[q]))  # execute's recipe
        planned = sum(getattr(chain[0], "parallel_drivers", 1) for chain in exec_plan.pipelines)
        plain = {}
        for di, d in enumerate(drivers):
            for i, op in enumerate(d.operators):
                s = op.context.stats
                plain[(di, i, s.name[:26])] = (s.input_rows, s.output_rows)
        res, wall, launches, delta, _ = _warm(runner, "explain analyze " + QUERIES[q], sync)
        n, ops = _explain_table(res.rows)
        if n != len(drivers) or n != planned:
            raise AssertionError(f"EXPLAIN Q{q}: {n} drivers in the header, the plan makes "
                                 f"{planned}, the plain run had {len(drivers)}")
        if ops != plain:
            diff = [(k, ops.get(k), plain.get(k)) for k in sorted(set(ops) | set(plain))
                    if ops.get(k) != plain.get(k)]
            raise AssertionError(f"EXPLAIN Q{q}: operator rows differ from the plain run: "
                                 f"{diff[:8]}")
        for (line,) in res.rows:
            if line.startswith("- Output"):
                break  # the plan text follows the table
            log(f"EXPLAIN Q{q} | {line}")
        out[f"SQL EXPLAIN q{q}"] = {"launches": launches}
        log(f"EXPLAIN Q{q} {schema}: {n} drivers, {len(ops)} operators, rows equal to a plain "
            f"run's; wall {wall:.4f}s; launches {launches}; peak per operator "
            f"{max(s['peak_memory_bytes'] for s in driver_stats(drivers))} bytes")

    # 2. pressure: a one-byte pool, against the unpressured runs
    pressured = {"q3": QUERIES[3], "q18": QUERIES[18], "window orders": P14_SQL["window orders"]}
    for label, sql in pressured.items():
        walls = {}
        for mode, props in (("unpressured", {}), ("pressured", PRESSURE)):
            runner = sql_runner(device, "pallas", schema, **props)
            RESIDENT_CACHE.clear()
            t0 = time.perf_counter()
            runner.execute(sql)
            sync()
            cold_s = time.perf_counter() - t0
            res, warm_s, launches, delta, spills = _warm(runner, sql, sync)
            walls[mode] = (cold_s, warm_s, res, launches, delta, spills)
        _, _, base, base_launches, base_delta, base_spills = walls["unpressured"]
        cold_s, warm_s, res, launches, delta, spills = walls["pressured"]
        if label == "q3":
            if not same_rows(res.rows, oracle_q3(schema)[0]):
                raise AssertionError(f"MEM {label}: rows differ from the numpy oracle")
            if delta["pallas.join_builds"] != 2 or (on_card and (
                    launches != base_launches or launches["insert"] != 2)):
                raise AssertionError(f"MEM {label}: launches {launches} (unpressured "
                                     f"{base_launches}), counters {delta}")
        elif label == "q18":
            if not same_rows(res.rows, records[18]["rows"]):
                raise AssertionError(f"MEM {label}: rows differ from phase 11's card rows")
        else:
            check_p14_rows(label, res.rows, schema)
        if not same_rows(res.rows, base.rows) and label != "window orders":
            raise AssertionError(f"MEM {label}: rows differ from the unpressured run's")
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"MEM {label}: a fallback: {delta}")
        if not spills or not delta["memory.revoked_bytes"]:
            raise AssertionError(f"MEM {label}: nothing revoked under a one-byte pool "
                                 f"({spills}, {delta['memory.revoked_bytes']} bytes)")
        to_disk = label != "window orders"  # a window keeps host RAM only
        if bool(delta["spill.bytes_written"]) != to_disk or \
                delta["spill.bytes_read"] != delta["spill.bytes_written"]:
            raise AssertionError(f"MEM {label}: disk bytes written "
                                 f"{delta['spill.bytes_written']}, read "
                                 f"{delta['spill.bytes_read']}")
        if on_card and launches["insert"] != delta["pallas.join_builds"] + \
                delta["pallas.agg_pages"]:
            raise AssertionError(f"MEM {label}: insert launches {launches} != builds + pages "
                                 f"{delta}")
        out[f"SQL MEM {label} pressured"] = {"launches": launches}
        u = walls["unpressured"]
        log(f"MEMORY {label} {schema} under memory_pool_bytes=1: {len(res.rows)} rows equal "
            f"to the oracle; walls cold {cold_s:.4f}s, warm {warm_s:.4f}s against unpressured "
            f"cold {u[0]:.4f}s, warm {u[1]:.4f}s; bytes moved to host on the warm run "
            f"{int(delta['memory.revoked_bytes'])}, PCOL bytes written to disk "
            f"{int(delta['spill.bytes_written'])} (last rung reached: "
            f"{'disk' if delta['spill.bytes_written'] else 'host RAM'}); memory.spill events "
            f"{spills} (unpressured "
            f"{base_spills}); launches {launches} (unpressured {base_launches}); join builds "
            f"{int(delta['pallas.join_builds'])}, grouped pages {int(delta['pallas.agg_pages'])}")

    # 3. a query over its user-memory limit: Q1's user memory is its scans'
    # prefetched pages (at least one whole page), so a quarter of its
    # accounted peak trips the limit (the cache cleared: replayed pages
    # stage nothing)
    RESIDENT_CACHE.clear()
    with PoolPeak() as peak:
        sql_runner(device, "pallas", schema).execute(QUERIES[1])
    limit = peak.peak // 4
    RESIDENT_CACHE.clear()
    seq = events.JOURNAL.last_seq()
    try:
        sql_runner(device, "pallas", schema, query_max_memory_bytes=limit).execute(QUERIES[1])
        raise AssertionError(f"MEM limit: Q1 ran under query_max_memory_bytes={limit}")
    except ExceededMemoryLimitException as e:
        message = str(e)
    evts = events.JOURNAL.events(since=seq, kind="query.memory_exceeded")
    if not evts or evts[0]["limit_bytes"] != limit:
        raise AssertionError(f"MEM limit: no query.memory_exceeded event ({evts})")
    left = shared_general_pool().by_query()
    if evts[0]["query_id"] in left:
        raise AssertionError(f"MEM limit: the pool kept {left} after the failed query")
    log(f"MEMORY limit {schema}: Q1 (accounted peak {peak.peak} bytes) under "
        f"query_max_memory_bytes={limit} raised "
        f"'{message}'; journaled query.memory_exceeded with {evts[0]['reserved_bytes']} "
        f"reserved bytes; the pool holds {left} afterwards")

    # 4. the accounted peak beside the allocator's
    for label, runner, sql in (("q3", sql_runner(device, "pallas", schema), QUERIES[3]),
                               ("q9", sql_runner(device, "pallas", schema), QUERIES[9]),
                               (f"ds q{PEAK_DS_QUERY}", ds_runner(device, schema),
                                DS_QUERIES[PEAK_DS_QUERY])):
        runner.execute(sql)  # cold: caches and pages
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        base_mem = torch.cuda.memory_allocated(device) if on_card else 0
        with PoolPeak() as peak:
            runner.execute(sql)
            sync()
        alloc = torch.cuda.max_memory_allocated(device) if on_card else 0
        log(f"MEMORY peak {label} {schema}: accounted {peak.peak} bytes (the query's pool "
            f"ledger at its most); allocator {alloc} bytes peak, {base_mem} before the run "
            f"(torch.cuda.max_memory_allocated)")

    # 5. the plugin functions over lineitem
    want = oracle_plugins(schema)
    runner = sql_runner(device, "pallas", schema)
    for label, sql in P16_SQL.items():
        res, wall, launches, delta, _ = _warm(runner, sql, sync)
        check_plugin_rows(label, res.rows, want[label])
        out[f"SQL PLUGIN {label}"] = {"launches": launches}
        log(f"PLUGIN {label} {schema}: rows equal to the numpy oracle; wall {wall:.4f}s; "
            f"launches {launches}; first row {res.rows[0]}")
    return out


# phase 17: the flight recorder, the metrics histograms and the disk rung
TRACE_QUERIES = (3, 9)
TRACE_CATEGORIES = ("driver", "operator", "segment", "scan", "pool")
LIFECYCLE_CHILDREN = ("parse", "plan", "local_plan", "execute")
RECORDING_MODES = {"black box (default)": {}, "off": {"query_blackbox": False},
                   "full trace": {"query_trace": True}}
RECORDING_REPS = 7
SPILL_QUERIES = (3, 18)


def _lifecycle_nesting(doc) -> list:
    """The lifecycle spans in start order, each with its innermost
    enclosing lifecycle span's name."""
    spans = sorted((e for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e.get("cat") == "lifecycle"),
                   key=lambda e: (e["ts"], -e["dur"]))
    out = []
    for e in spans:
        parents = [p for p in spans if p is not e and p["ts"] <= e["ts"]
                   and p["ts"] + p["dur"] >= e["ts"] + e["dur"]]
        parent = min(parents, key=lambda p: p["dur"]) if parents else None
        out.append((e["name"], parent["name"] if parent else None))
    return out


def _check_lifecycle(label: str, doc, children=LIFECYCLE_CHILDREN) -> None:
    nest = _lifecycle_nesting(doc)
    want = [("query", None)] + [(c, "query") for c in children]
    if [x for x in nest if x[0] in ("query",) + tuple(children)] != want:
        raise AssertionError(f"{label}: lifecycle spans {nest}, want {want}")


def _own_spill_dirs() -> list:
    """Spill directories this process holds under the port's root."""
    import glob

    from presto_tpu_torch.exec.spill import spill_root

    return [d for d in glob.glob(os.path.join(spill_root(""), "*"))
            if os.path.basename(d).startswith(f"{os.getpid()}-")]


def _hist_since(name: str, before: dict) -> dict:
    """{count, p50, p95, p99} of the observations histogram ``name`` got
    since the raw snapshot ``before``."""
    from presto_tpu_torch.utils.metrics import METRICS, Histogram

    now = METRICS.raw_snapshot(name)["histograms"].get(name)
    if now is None:
        return {}
    prev = (before.get("histograms") or {}).get(name) or {"counts": [0] * 64, "n": 0,
                                                          "total": 0.0}
    diff = {"counts": [a - b for a, b in zip(now["counts"], prev["counts"])],
            "n": now["n"] - prev["n"], "total": now["total"] - prev["total"]}
    return Histogram.from_raw(diff).summary()


def run_flight_phase(device, records: dict, schema: str = "sf1") -> dict:
    """Phase 17 at TPC-H ``schema`` with ``hash_kernels="pallas"`` under the
    defaults: Q3 and Q9 traced (``query_trace``) from cold scans, their
    rows against plain runs and their Chrome traces checked and summed up;
    the warm walls under the three recording modes; a forensic dump of a
    query over its memory limit; Q3 and Q18 under a one-byte pool through
    the disk rung (cold and warm) and once held at host RAM; an injected
    ``spill.write`` fault; and the ``query.wall_s`` histogram over the
    phase's statements. Returns the records whose launches the kernels line
    reports."""
    import collections
    import shutil
    import tempfile

    import torch

    from presto_tpu_torch.cluster import faults
    from presto_tpu_torch.memory import ExceededMemoryLimitException, shared_general_pool
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.utils import events, trace
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-trace-")
    walls_before = METRICS.raw_snapshot("query.wall_s")
    completed = [0]  # statements of this phase that completed

    def run(runner, sql):
        res = runner.execute(sql)
        sync()
        completed[0] += 1
        return res

    try:
        # 1. the full trace, from cold scans
        for q in TRACE_QUERIES:
            plain = run(sql_runner(device, "pallas", schema), QUERIES[q])
            traced = sql_runner(device, "pallas", schema, query_trace=True, query_trace_dir=tmp)
            RESIDENT_CACHE.clear()
            ph.insert_table.launches = 0
            ph.probe_table.launches = 0
            t0 = time.perf_counter()
            res = run(traced, QUERIES[q])
            wall = time.perf_counter() - t0
            launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
            if not same_rows(res.rows, plain.rows):
                raise AssertionError(f"TRACE Q{q}: traced rows differ from the plain run's")
            if not res.trace_path or not res.trace_path.startswith(tmp):
                raise AssertionError(f"TRACE Q{q}: trace_path {res.trace_path}")
            with open(res.trace_path) as f:
                doc = json.load(f)
            _check_lifecycle(f"TRACE Q{q}", doc)
            cats = trace.span_categories(doc)
            missing = [c for c in TRACE_CATEGORIES if not cats.get(c)]
            if missing:
                raise AssertionError(f"TRACE Q{q}: no {missing} spans ({cats})")
            execute = [e for e in doc["traceEvents"]
                       if e.get("ph") == "X" and e["cat"] == "lifecycle"
                       and e["name"] == "execute"][0]
            busy = {c: sum(hi - lo for lo, hi in trace._merged_intervals(doc, c)) / 1e6
                    for c in sorted(cats) if c != "lifecycle"}
            out[f"SQL TRACE q{q}"] = {"launches": launches}
            log(f"TRACE Q{q} {schema} cold: {len(res.rows)} rows equal to the plain run's; "
                f"wall {wall:.4f}s; {os.path.getsize(res.trace_path)} bytes of Chrome JSON; "
                f"lifecycle {_lifecycle_nesting(doc)}; launches {launches}")
            log(f"TRACE Q{q} spans by category {dict(sorted(cats.items()))}; dropped "
                f"{doc['otherData']['dropped_events']}; overlap_ratio(scan, driver) "
                f"{trace.overlap_ratio(doc, 'scan', 'driver'):.4f}")
            log(f"TRACE Q{q} merged busy seconds as a share of execute "
                f"({execute['dur'] / 1e6:.4f}s): " + ", ".join(
                    f"{c} {busy[c]:.4f}s ({busy[c] / (execute['dur'] / 1e6):.3f})"
                    for c in busy))

        # 2. the cost of recording: warm walls under each mode, the modes
        # taking turns so drift falls on all of them alike; no gate
        for q in TRACE_QUERIES:
            runners = {mode: sql_runner(device, "pallas", schema, query_trace_dir=tmp,
                                        **props)
                       for mode, props in RECORDING_MODES.items()}
            for runner in runners.values():
                run(runner, QUERIES[q])  # warm-up
            walls = {mode: [] for mode in runners}
            for _ in range(RECORDING_REPS):
                for mode, runner in runners.items():
                    t0 = time.perf_counter()
                    run(runner, QUERIES[q])
                    walls[mode].append(time.perf_counter() - t0)
            log(f"TRACE cost Q{q} {schema}: warm walls over {RECORDING_REPS} turns, median "
                f"[min, max]: " + ", ".join(
                    f"{m} {np.median(w):.4f}s [{min(w):.4f}, {max(w):.4f}]"
                    for m, w in walls.items()))

        # 3. the forensic dump of a failed query, and none for a success
        ok_dir = os.path.join(tmp, "success")
        res = run(sql_runner(device, "pallas", schema, query_trace_dir=ok_dir), QUERIES[6])
        if res.trace_path or (os.path.isdir(ok_dir) and os.listdir(ok_dir)):
            raise AssertionError("FORENSIC: a successful query exported a trace")
        RESIDENT_CACHE.clear()
        with PoolPeak() as peak:
            run(sql_runner(device, "pallas", schema), QUERIES[1])
        limit = peak.peak // 4
        RESIDENT_CACHE.clear()
        seq = events.JOURNAL.last_seq()
        try:
            sql_runner(device, "pallas", schema, query_max_memory_bytes=limit,
                       query_trace_dir=tmp).execute(QUERIES[1])
            raise AssertionError(f"FORENSIC: Q1 ran under query_max_memory_bytes={limit}")
        except ExceededMemoryLimitException as e:
            path = getattr(e, "failure_trace_path", None)
        if not path or not path.startswith(tmp):
            raise AssertionError(f"FORENSIC: the exception carries {path}")
        with open(path) as f:
            doc = json.load(f)
        _check_lifecycle("FORENSIC Q1", doc)
        dumped = events.JOURNAL.events(since=seq, kind="query.forensic_dumped")
        if not dumped or dumped[-1]["path"] != path or not doc["otherData"]["coarse"]:
            raise AssertionError(f"FORENSIC: journal {dumped}, coarse "
                                 f"{doc['otherData']['coarse']}")
        log(f"FORENSIC Q1 {schema} under query_max_memory_bytes={limit}: "
            f"{os.path.basename(path)} ({os.path.getsize(path)} bytes, coarse ring, "
            f"spans {trace.span_categories(doc)}, dropped "
            f"{doc['otherData']['dropped_events']}); query.forensic_dumped journaled; "
            f"a successful Q6 wrote nothing")

        # 4. the disk rung: a one-byte pool, disk on and off, against the
        # unpressured run
        rows_of = {3: oracle_q3(schema)[0], 18: records[18]["rows"]}
        w_before = METRICS.raw_snapshot("spill.write_s")
        for q in SPILL_QUERIES:
            walls = {}
            for mode, props in (("unpressured", {}), ("disk", PRESSURE),
                                ("host", {**PRESSURE, "spill_to_disk": False})):
                runner = sql_runner(device, "pallas", schema, **props)
                cold_s = None
                if mode != "host":  # host RAM only: one warm run
                    RESIDENT_CACHE.clear()
                    t0 = time.perf_counter()
                    run(runner, QUERIES[q])
                    cold_s = time.perf_counter() - t0
                seq = events.JOURNAL.last_seq()
                res, warm_s, launches, delta, spills = _warm(runner, QUERIES[q], sync)
                completed[0] += 1
                runs = collections.Counter(
                    e["run_kind"] for e in events.JOURNAL.events(
                        since=seq, kind="query.spill.disk", limit=1 << 20))
                walls[mode] = (cold_s, warm_s, launches, delta, dict(runs))
                if not same_rows(res.rows, rows_of[q]):
                    raise AssertionError(f"SPILL Q{q} {mode}: rows differ from "
                                         f"{'the numpy Q3' if q == 3 else 'phase 11'}")
                if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
                    raise AssertionError(f"SPILL Q{q} {mode}: a fallback: {delta}")
                if mode != "unpressured":
                    out[f"SQL SPILL q{q} {mode}"] = {"launches": launches}
            base = walls["unpressured"]
            for mode in ("disk", "host"):
                cold_s, warm_s, launches, delta, runs = walls[mode]
                if on_card and launches != base[2]:
                    raise AssertionError(f"SPILL Q{q} {mode}: launches {launches}, unpressured "
                                         f"{base[2]}")
                if not delta["memory.revoked_bytes"]:
                    raise AssertionError(f"SPILL Q{q} {mode}: nothing revoked")
            _, _, _, disk, runs = walls["disk"]
            if not runs or not disk["spill.bytes_written"] or \
                    disk["spill.bytes_read"] != disk["spill.bytes_written"]:
                raise AssertionError(f"SPILL Q{q}: runs {runs}, written "
                                     f"{disk['spill.bytes_written']}, read "
                                     f"{disk['spill.bytes_read']}")
            if on_card and (not disk["pcol.native_opens"] or disk["pcol.numpy_opens"]):
                raise AssertionError(f"SPILL Q{q}: PCOL opens native "
                                     f"{disk['pcol.native_opens']}, numpy "
                                     f"{disk['pcol.numpy_opens']}")
            if walls["host"][3]["spill.bytes_written"] or walls["host"][4]:
                raise AssertionError(f"SPILL Q{q}: spill_to_disk=False wrote to disk")
            left = _own_spill_dirs()
            ledger = shared_general_pool().spill_by_query()
            if left or ledger:
                raise AssertionError(f"SPILL Q{q}: left {left}, spill ledger {ledger}")
            log(f"SPILL Q{q} {schema} under memory_pool_bytes=1: rows equal; warm walls disk "
                f"{walls['disk'][1]:.4f}s (cold {walls['disk'][0]:.4f}s), host RAM only "
                f"{walls['host'][1]:.4f}s, unpressured {base[1]:.4f}s (cold {base[0]:.4f}s); "
                f"warm disk run: {dict(runs)} PCOL runs, {int(disk['spill.bytes_written'])} "
                f"bytes written and read back, {int(disk['memory.revoked_bytes'])} bytes "
                f"moved to host, {int(disk['pcol.native_opens'])} native PCOL opens; "
                f"launches {walls['disk'][2]} (host RAM only {walls['host'][2]}, unpressured "
                f"{base[2]}); no spill directory or ledger byte left")
        w = _hist_since("spill.write_s", w_before)
        log(f"SPILL spill.write_s over the phase's runs: count {w.get('count')}, p50 "
            f"{w.get('p50')}s, p95 {w.get('p95')}s, p99 {w.get('p99')}s")

        # 5. an injected spill.write fault fails only its query
        faults.install(faults.FaultInjector.from_spec("spill.write:error:times=1", seed=7))
        seq = events.JOURNAL.last_seq()
        try:
            try:
                sql_runner(device, "pallas", schema, query_trace_dir=tmp,
                           **PRESSURE).execute(QUERIES[3])
                raise AssertionError("FAULT: the injected spill.write fault did not fire")
            except faults.InjectedFault as e:
                path = getattr(e, "failure_trace_path", None)
        finally:
            faults.clear()
        failed = events.JOURNAL.events(since=seq, kind="query.spill.failed")
        if not path or not failed or failed[-1]["op"] != "write":
            raise AssertionError(f"FAULT: forensic {path}, journal {failed}")
        if _own_spill_dirs() or shared_general_pool().spill_by_query():
            raise AssertionError("FAULT: the failed query left spill state behind")
        res = run(sql_runner(device, "pallas", schema, **PRESSURE), QUERIES[3])
        if not same_rows(res.rows, rows_of[3]):
            raise AssertionError("FAULT: the next query's rows differ from the numpy Q3")
        log(f"FAULT spill.write {schema}: Q3 under a one-byte pool failed with "
            f"InjectedFault, query.spill.failed (op write) journaled, forensic "
            f"{os.path.basename(path)} attached; the next Q3 ran clean")

        # 6. the query-wall histogram over this phase's statements
        h = _hist_since("query.wall_s", walls_before)
        if h.get("count") != completed[0]:
            raise AssertionError(f"HIST query.wall_s counted {h.get('count')} statements, the "
                                 f"phase completed {completed[0]}")
        log(f"HIST query.wall_s over phase 17: count {h['count']} (= the statements that "
            f"completed), p50 {h['p50']}s, p95 {h['p95']}s, p99 {h['p99']}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def check_probe_at(device, label: str, slot_keys, slot_rows, keys, mask, trips,
                   reps: int = 20, plain_reps: int = 3) -> dict:
    """The probe against its plain version, bit for bit, at one captured
    shape, with its times and its bound; returns them."""
    from presto_tpu_torch.ops import pallas_hash as ph

    args = (slot_keys, slot_rows, keys, mask, trips)
    got = ph.probe_table(*args)
    err = _max_abs_err([(got, ph.probe_table_reference(*args))])
    if err != 0:
        raise AssertionError(f"{label} probe differs from its plain version: {err}")
    nbytes = probe_bytes(*args)
    out = {"ms": time_ms(lambda: ph.probe_table(*args), reps, device),
           "device_ms": device_ms(ph.probe_table, args, reps),
           "plain_ms": time_ms(lambda: ph.probe_table_reference(*args), plain_reps, device),
           "bound_ms": nbytes / HBM_RATE * 1e3, "max_abs_err": err}
    log(f"KERNEL probe at the {label} shape: slots={slot_rows.shape[0]} n={keys.shape[0]} "
        f"live={int(mask.sum())} trips={trips}: bit-identical, {int((got >= 0).sum())} hits; "
        f"kernel {out['ms']:.4f} ms (device {out['device_ms']:.4f} ms), plain "
        f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms ({nbytes} bytes)")
    return out


def check_stage_failure(device) -> None:
    """A scan stage that raises on a pool thread surfaces in the consumer
    (``ScanPipeline._fail`` puts the error on the output queue) and stays
    raised."""
    import torch

    from presto_tpu_torch.block import Block, Page
    from presto_tpu_torch.ops.scan_pipeline import ScanPipeline
    from presto_tpu_torch.types import BIGINT

    class Failing:
        def __iter__(self):
            yield Page((Block(BIGINT, torch.arange(8)),), torch.ones(8, dtype=torch.bool))
            raise ValueError("stage failure on purpose")

        def close(self):
            pass

    pipe = ScanPipeline(Failing(), device, target_rows=8, pool_key="chip-smoke-failure")
    raised, pages = 0, 0
    try:
        # the page read before the failure may or may not be uploaded first
        for _ in range(4):
            try:
                page = pipe.next()
            except ValueError as e:
                if "on purpose" not in str(e):
                    raise
                raised += 1
                continue
            if page is None:
                raise AssertionError("a failing scan stage ended its stream quietly")
            if page.mask.device.type != "cuda":
                raise AssertionError("the page did not reach the card")
            pages += 1
    finally:
        pipe.close()
    if raised < 3 or pages > 1:
        raise AssertionError(f"a failing scan stage: {raised} raises, {pages} pages")
    log(f"STAGE failure: the failing reader's error reached the consumer and stayed "
        f"raised ({raised} calls; {pages} page before it)")


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
    clock = [time.perf_counter()]

    def phase_done(name: str) -> float:
        now = time.perf_counter()
        spent = now - clock[0]
        log(f"PHASE {name}: {spent:.1f}s")
        clock[0] = now
        return spent

    try:
        build_kernels()
        measured = check_kernels(device)
        phase_done("1-3 build and kernels")
        run_q3_phase(device)
        profile_q3(device)
        phase_done("4-5 hand-built Q3")
        records, fused_capture, grouping = run_sql_phase(device)
        sql_layers(device)
        check_grouping_insert(device, grouping)
        phase_done("6-7 SQL Q1, Q3, Q6")
        join_records, join_capture = run_join_phase(device)
        sql_layers(device, queries=(9, 13), warm_up=False)  # the phase warmed them
        check_path_kernels(device, join_capture)
        records.update(join_records)
        phase_done("8 SQL Q5, Q9, Q13")
        check_default_path(device, records)
        compare_walls(device)
        check_fused_probe(device, fused_capture)
        check_stage_failure(device)
        phase_done("9-10 fused segments, stage failure")
        captures = {q: KernelCapture() for q in PATH_KERNEL_QUERIES}
        records = run_default_path_phase(device, records, captures=captures)
        for q, capture in captures.items():
            check_path_kernels(device, capture, run=f"SQL Q{q} cold run",
                               need_grouping=False)
        phase_done("11 TPC-H on the card")
        check_cpu_rows(device)
        host_s = phase_done("11 TPC-H on the host")
        ds_records = run_tpcds_phase(device)
        phase_done("12 TPC-DS on the card")
        check_ds_cpu_rows(device)
        host_s += time.perf_counter() - clock[0]
        phase_done(f"12 TPC-DS on the host (11-12 on the host at {CPU_ROWS_SCHEMA}: "
                   f"{host_s:.1f}s, {SF1_HOST_SECONDS - host_s:.1f}s saved against "
                   f"{SF1_HOST_SECONDS:.1f}s at SF1)")
        setop_records = run_setops_phase(device)
        phase_done("13 set operations")
        p14_records = run_p14_phase(device)
        phase_done("14 windows, FULL joins, aggregates")
        write_records = run_write_phase(device)
        phase_done("15 writes")
        memory_records = run_memory_phase(device, records)
        phase_done("16 plugins, EXPLAIN ANALYZE, memory")
        flight_records = run_flight_phase(device, records)
        phase_done("17 flight recorder, histograms, disk spill")
    except Exception:  # a failed phase: report it and print no result
        import traceback

        traceback.print_exc()
        return 1
    launches = records[3]["launches"]
    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": TPU_KERNELS[k], "launches": launches[k],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "launches_by_query": {
                    **{f"SQL Q{q}": records[q]["launches"][k] for q in sorted(records)},
                    **{f"SQL DS Q{q}": ds_records[q]["launches"][k] for q in sorted(ds_records)},
                    **{f"SQL SETOP {label}": rec["launches"][k]
                       for label, rec in setop_records.items()},
                    **{f"SQL P14 {label}": rec["launches"][k]
                       for label, rec in p14_records.items()},
                    **{f"SQL WRITE {label}": rec["launches"][k]
                       for label, rec in write_records.items()},
                    **{label: rec["launches"][k] for label, rec in memory_records.items()},
                    **{label: rec["launches"][k] for label, rec in flight_records.items()}}}
               for k, m in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
