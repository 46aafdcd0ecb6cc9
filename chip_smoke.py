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
8. run TPC-H Q5, Q9 and Q13 as SQL the same way (multi-key joins,
   duplicate-key INNER and LEFT expansion, LIKE), with numpy-only oracles:
   the unique single-key builds on the table (Q5 3, Q9 4, Q13 0), no
   fallback, insert launches equal to ``join_builds + agg_pages``, and each
   table probed by the probe kernel at least once. Q9 and Q13 run at SF1,
   Q5 at ``Q5_SCHEMA`` (``tiny``: its SF1 runs take 40-64 s each; its SF1
   walls are ``port_walls.py --queries 5``'s). Q5
   prints its expansion chunks, expanded rows and peak device memory; Q9
   and Q13 get a profiler pass and the host-clock layers. Both kernels are held against
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
   (cold and warm; Q5 once, at ``Q5_SCHEMA`` as its phase 8 runs). Fails
   unless the rows equal the oracle's, the
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
   full defaults: warm (counters set to 0 just before it; a cold run
   before it for Q64 and Q72 only) and once under the oracle properties,
   with equal rows. A TPC-DS scan has no cache token, so the warm run
   regenerates its pages (it must replay none).
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
   must spill. The per-day grouping runs cold and warm (counters set to 0
   just before the warm run), the others once (``P14_ONE_RUN``; their
   cold SF1 walls: ``port_walls.py --p14``);
   the rows at ``P14_ORACLE_SCHEMA`` (``tiny``) must equal a numpy oracle
   (``check_p14_rows``: exact where the result is, the sketches within
   their error bounds, ``min_by``/``max_by`` a row holding the extreme,
   the statistics to ``STAT_REL_TOL``) on the card and in the CPU run,
   and the card's rows there the CPU run's (these host runs and the
   oracles once ran at SF1; ``port_walls.py --p14 all`` holds the
   SF1 rows to the oracles); nothing may fall back. The insert is held
   against its plain version at the per-day grouping's shape.
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
18. the file catalog at ``tpch.sf1`` (``run_file_phase``), with
   ``hash_kernels="pallas"``, three ``FileConnector`` catalogs in a
   temporary directory that the phase removes: PCOL CTAS of ``lineitem``'s
   Q1/Q3/Q6 columns, ``orders`` and ``customer`` on the scaled writers
   (row counts against the generator), Q1, Q3 and Q6 over them against the
   numpy oracles, Q6 through the split readers and ``libpcol``'s range
   pre-filter (the rows uploaded must be exactly the rows inside its
   pushed-down domains; native opens only), the per-day grouping of the
   file ``lineitem`` (the insert held at its shape); Q6 over a table
   written one ``l_shipdate`` year per INSERT must keep exactly the 1994
   insert's files; the mixed Q3 over the file ``lineitem`` (insert = the
   two ``tpch`` builds, a probe per re-batched page, no fallback; the
   probe held bit-identical at the split readers' page shape); Parquet and
   ORC (``ORC_SCHEMA``) CTAS of ``lineitem``'s eight columns, Q1 and Q6
   against the oracles with the row groups or stripes kept, the mixed Q3
   over the Parquet ``lineitem``; an RCFile table at ``RC_SCHEMA`` against
   numpy, which refuses an INSERT. Prints ``FILE`` lines;
19. the warehouse connectors at ``tpch.sf1`` (``run_warehouse_phase``), with
   ``hash_kernels="pallas"``, a ``HiveConnector`` and a ``RaptorConnector``
   in a temporary directory that the phase removes: hive CTAS of
   ``lineitem`` and ``orders`` bucketed 4 ways on their order keys; the
   grouped query (Q3 without ``customer``) grouped (``last_grouped == 4``)
   and ungrouped against numpy, with each warm run's allocator peak beside
   its accounted peak, then grouped unfused, where the grouping takes the
   insert (at least one launch; the insert held bit-identical at the first
   bucket's grouped-page shape); CTAS partitioned by ``l_shipmode`` (the
   routing's share of its wall) and by ``l_linenumber``, and a sum over
   one partition of each (the ``l_linenumber`` sum keeps exactly its
   partition's files; a string key gives no domain); the mixed Q3 over the hive ``lineitem`` (insert = the
   two builds, the probe held bit-identical at a hive page's shape);
   Parquet and ORC hive tables at ``HIVE_FORMAT_SCHEMA``; raptor: CTAS and
   Q6, seven yearly INSERTs whose Q6 keeps exactly the 1994 shard, then
   ``maintenance()`` compacting them into one. Prints ``WAREHOUSE`` lines;
20. the federated catalogs at ``tpch.sf1`` (``run_federation_phase``), with
   ``hash_kernels="pallas"``: a sqlite file behind ``sqlite_connector``
   (CTAS of ``orders`` and ``customer``, Q3 over them beside ``tpch``'s
   ``lineitem`` with the rows sqlite returned after the pushed-down
   ``o_orderdate``, the per-day grouping; the steps of ``FED_ONE_RUN``
   run once), the ``orders`` topic at
   ``KAFKA_SCHEMA`` (``tiny``; SF1's decode is ``federation_walls.py``'s)
   as JSON partition logs behind a ``KafkaConnector`` (the stream join with
   ``tpch``'s ``customer`` at that scale, the decode's seconds, messages per
   ``_partition_id``; the insert held bit-identical at the ``customer``
   build, the probe at the first topic page), a ``RemoteTestingService``
   behind a ``RemoteConnector`` whose first endpoint is closed (Q3 with the
   service's ``customer``, its requests by method), and a
   ``FileBasedAccessControl`` (the analyst's Q3, a denied CTAS that
   launches nothing and creates nothing, a CTE shadowing a denied name).
   Every query's rows equal its ``tpch`` counterpart's, and both Q3s
   phase 11's. Prints ``FEDERATION`` lines;
21. distributed TPC-H (``run_distributed_phase``): SQL Q1, Q3, Q5 and Q9
   through ``DistributedQueryRunner`` on ``MeshContext([cuda:0] * 4)``,
   four logical workers on the one card, under the session defaults
   (streaming exchange, skew-aware) with ``hash_kernels="pallas"``: a cold
   and a warm run each, rows equal to phase 11's for the same query (Q5 at
   ``Q5_SCHEMA``; Q9 at ``tiny``, against the single-node run and the
   numpy oracle there; ``DIST_SCHEMA``), no page reaching an exchange from host
   memory (``host_uploads`` 0), insert launches equal to the workers' join
   builds plus grouped pages, and a probe launch wherever a worker built a
   table; then Q3 under ``streaming_exchange=False`` with equal rows.
   Prints ``DIST`` lines: walls, exchanges, chunks, pages, per-exchange
   ``partition_rows`` and the warm run's launches;
22. the cluster (``run_cluster_phase``): a ``ClusterQueryRunner`` and
   ``CLUSTER_WORKERS`` in-process ``WorkerServer``s on the one card, real
   HTTP over loopback, the workers announcing every second as the
   reference's test fixture does. TPC-H Q1 and Q3 at SF1, Q5 at
   ``Q5_SCHEMA`` and Q9 at ``tiny`` (``CLUSTER_SCHEMA``) with
   ``hash_kernels="pallas"``, a cold and a warm run each but Q3, run once
   (``CLUSTER_ONE_RUN``; its cold SF1 wall: ``cluster_walls.py --queries
   3``), rows equal to
   phase 11's (Q9's to the single-node run and the numpy oracle at its
   scale); the warm run's launches
   per worker (a kernel call is the worker's whose task runs the calling
   driver) and, for Q3, insert launches equal to the join builds plus
   grouped pages, a probe per worker that built, and the probe held
   bit-identical at the shape of a page received over the wire. The merge
   path (``CLUSTER_MERGE_SQL``, ORDER BY without LIMIT) at
   ``CLUSTER_MERGE_SCHEMA`` (``tiny``; SF1's runs are ``cluster_walls.py
   --queries merge``) through ``MergingRemoteSource`` against a numpy
   oracle and the single-node run.
   Then a fault run at ``CLUSTER_FAULT_SCHEMA`` on two workers: one is
   stopped mid-Q3 (after its leaf task served a chunk) under
   ``retry_policy="TASK"``; the rows equal the single-node run's, the
   recovery is journaled, and ``torch.cuda.memory_allocated()`` after the
   run, every task ended, is no more than before it. Prints ``CLUSTER``
   lines: walls, tasks per fragment, ``exchange.frames``/``bytes``/
   ``rows``, launches per worker, the card;
23. the server (``run_server_phase``): a ``PrestoTpuServer`` over a
   ``LocalQueryRunner`` on the card with ``hash_kernels="pallas"``, behind
   a ``ResourceGroupManager`` of hard concurrency
   ``SERVER_HARD_CONCURRENCY``, ``page_rows`` ``SERVER_PAGE_ROWS``: (a)
   TPC-H Q1, Q3, Q6 at SF1 through ``StatementClient``, cold (resident
   cache cleared) and warm, rows equal to phase 11's after the JSON round
   trip, warm Q3's launches phase 11's with two join builds and no
   fallback; (b) ``SERVER_CONCURRENT`` dbapi connections submitting Q3 at
   once, each with Q3's rows, at least two ``query.queued`` admissions in
   ``GET /v1/events``, two inserts a query; (c) ``SERVER_FETCH_SQL``
   (over ``SERVER_FETCH_MIN_ROWS`` rows) paged through ``nextUri``, the
   ``Verifier`` with the in-process rows as control and the server as
   test reporting MATCH; (d) a failing statement's payload with the
   engine's ``errorType`` and its black box at ``GET
   /v1/query/{id}/trace``; (f) Q6 through a ``ProxyServer``, every
   ``nextUri`` on the proxy; then (e) a ``PrestoTpuServer`` over a
   ``ClusterQueryRunner`` with ``SERVER_CLUSTER_WORKERS``
   ``WorkerServer``s announcing over ``POST /v1/announcement``: Q1 at SF1
   and Q3 at ``tiny`` through the client with the single-node rows, ``GET
   /v1/cluster`` and ``/v1/cluster/metrics`` over both workers, ``PUT
   /v1/cluster/drain/{node}`` (DRAINED and out of discovery), Q1 on the
   other worker; (g) ``torch.cuda.memory_allocated()`` equal before the
   phase's servers and after they all stopped. Prints ``SERVER`` lines;
24. the sanitizers (``run_sanitizer_phase``): a child process
   (``--sanitizers``) started with ``PRESTO_TPU_TORCH_LOCKSAN``,
   ``_LEAKSAN`` and ``_COMPILESAN`` set, so that the port's import arms
   all three before its first lock exists (the shared pools' conditions
   must be the lock sanitizer's wrappers). At ``SAN_SMALL_SCHEMA`` it
   first takes the in-process rows of Q1, Q3 and Q6 and the device
   memory; then TPC-H Q1 and Q3 at SF1 twice each on one runner with
   ``hash_kernels="pallas"`` (rows equal to phase 11's on both passes,
   Q3's second-pass launches phase 11's, no composition on the second
   pass, fused-segment builds equal to ``segments.compiles``); at
   ``SAN_SMALL_SCHEMA`` the distributed Q3 on four logical workers, a
   served query cancelled at once, a ``spill.write`` fault under a
   one-byte pool, and ``SAN_SERVE_CLIENTS`` ``StatementClient``s at once
   on Q1, Q3 and Q6 through a ``PrestoTpuServer``. Fails on any finding
   of the three, ``leaksan.live_bytes`` other than 0, an empty
   ``locksan.hold_s``, or ``torch.cuda.memory_allocated()`` (resident
   pages and compositions cleared) other than before; each dump is read
   back by ``python -m tools.prestocheck --lock-graph-diff``,
   ``--leak-diff`` and ``--compile-diff`` with exit 0. Prints
   ``SANITIZERS`` lines: counts, percentiles, walls;
25. the hand-built Q1/Q6 and the Q1 stream (``run_hand_stream_phase``):
   ``models/hand_queries.run_query`` over ``build_q1`` (DIRECT grouping)
   and ``build_q6`` (GLOBAL sum) at SF1, cold and warm, rows equal to the
   numpy oracles and to phase 11's SQL rows; ``models/kernels.q1_stream``
   over all of SF1's lineitem (three producers, pinned staging, a copy
   stream), its finish dict equal to the numpy oracle's int64 sums; one
   producer over the first ``STREAM_PREFIX_ROWS`` rows of SF10, against
   numpy over the same prefix; the step's device ms on a 2^21-row batch
   (``device_ms``) beside its bytes bound; ``q1_resident`` at 2^22 rows,
   its one batch against numpy. Prints ``HAND`` and ``STREAM`` lines:
   walls, rows/s, the producers' stall, the first dispatch, with the
   card's name and power limit (``q1_walls.py`` keeps SF10 to its end);
26. the operator's lifecycle (``run_lifecycle_phase``), the port's drives
   of the reference's cluster dry runs at ``LIFECYCLE_SCHEMA`` (``tiny``),
   every worker and the single-node run on the card, ``hash_kernels=
   "pallas"``: churn (``CHURN_SQL`` on two HTTP workers, clean and with a
   third worker joining and the victim drained once a consumer asks for
   token >= 1 of its leaf stream: equal rows, ``query_attempts == 1``,
   ``task_retries >= 1``, DRAINED with a handoff, spooled-bytes peaks from
   ``/v1/status``); the rolling upgrade (three tenants cycling Q1, Q3, Q6 on
   three workers while each is drained, stopped and replaced: no query
   failed or mismatched, every drain DRAINED); chaos (``CHAOS_SQL`` clean,
   with a mid-stream kill and under speculation: equal rows, the kill
   recovered in place with a spool, the straggler speculated); forensics
   (a statement through the server that exhausts its retries into FAILED:
   the forensic trace, the journal's ids, ``/v1/cluster/metrics`` equal to
   a hand-merged oracle, the Prometheus text). Each drive fails if device
   memory is higher after every worker stopped than before it, and prints
   each worker's insert and probe launches in ``LIFECYCLE`` lines;
   ``lifecycle_walls.py`` runs churn and the rolling upgrade at SF1 and
   boots the server distribution;
27. print the kernels line (JSON, with each kernel's warm-run launches per
   SQL query under ``launches_by_query``: TPC-H as ``SQL Q3``, TPC-DS as
   ``SQL DS Q64``, the set operations as ``SQL SETOP rollup``, phase 14 as
   ``SQL P14 agg per day``, phase 15 as ``SQL WRITE q3 mixed``, phase 16 as
   ``SQL EXPLAIN q3``, ``SQL MEM q3 pressured`` and ``SQL PLUGIN geo``,
   phase 17 as ``SQL TRACE q3``, counted on the cold traced run, and ``SQL
   SPILL q18 disk``, phase 18 as ``SQL FILE pcol q3 mixed``, phase 19 as
   ``SQL HIVE q3 grouped unfused`` and ``SQL RAPTOR q6``, phase 20 as
   ``SQL FED kafka stream join``, phase 21 as ``SQL DIST Q3``, phase 22
   as ``SQL CLUSTER Q3``, phase 23 as ``SERVER Q3`` and ``SERVER
   concurrent Q3``, phase 24 as ``SANITIZED Q3``, phase 25 as ``HAND
   Q1``, phase 26 as ``LIFECYCLE rolling upgrade``), the card line, and last
   the result line.

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
import pickle
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
# Q5 runs at this schema in phases 8-11, every run and check of it: at SF1
# its cold run took 39-64 s and its warm run 51-58 s on an H100 machine.
# Its SF1 walls are port_walls.py's: python3 port_walls.py --queries 5
Q5_SCHEMA = "tiny"
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


def device_ms(wrapper, args, reps: int, counted: bool = True) -> float:
    """Device time of one call of ``wrapper(*args)``: the median over
    ``reps`` calls of the time between two CUDA events recorded around the
    call while a spin kernel (``torch.cuda._sleep``) holds the stream, so
    that the events bracket the call's kernels and not the host's launch
    cost, less the median of the same bracket around nothing. A bracket
    whose spin ran out before it was queued (the host thread stalled, for
    instance waiting for the interpreter lock) is not device time and is
    taken again, up to ``reps`` times in all; then it raises. It also fails
    unless the wrapper counts one launch per call; ``counted=False`` times a
    function that is no kernel's wrapper (the Q1 step), which has no count.
    (``torch.profiler`` lost
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
    launches = wrapper.launches if counted else 0
    gc.disable()  # as timeit does: a collection would stall the host thread
    try:
        busy = [span(lambda: wrapper(*args)) for _ in range(reps)]
        calls = wrapper.launches - launches if counted else reps + retakes
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


def oracle_q3(schema: str, customers: bool = True):
    """TPC-H Q3 in numpy over the port's generator: rows as Python values,
    and the number of source rows it read. ``customers=False`` drops the
    ``customer`` join and its BUILDING filter (phase 19's grouped query)."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    cut = civil_day(1995, 3, 15)
    c = g.generate_rows("customer", 0, g.table_row_count("customer", sf) if customers else 0,
                        sf, ["c_custkey", "c_mktsegment"])
    building = c["c_custkey"][c["c_mktsegment"] == g.DICT_SEGMENT.code_of("BUILDING")]
    n_orders = g.table_row_count("orders", sf)
    o = g.generate_rows("orders", 0, n_orders, sf,
                        ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])
    keep = o["o_orderdate"] < cut
    if customers:
        keep &= np.isin(o["o_custkey"], building)
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


Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
              "l_discount", "l_tax", "l_shipdate")
# the six sums of Q1 per group code (returnflag * 2 + linestatus), the
# port's q1_stream_finish keys in its order
Q1_SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "sum_disc", "count")


def q1_sums_np(li) -> dict:
    """Q1's int64 sums in numpy over lineitem columns: one (6,) array per
    ``Q1_SUMS`` key, indexed by group code."""
    keep = np.asarray(li["l_shipdate"]) <= civil_day(1998, 12, 1) - 90
    col = {k: np.asarray(li[k])[keep].astype(np.int64) for k in Q1_COLUMNS}
    gid = col["l_returnflag"] * 2 + col["l_linestatus"]
    disc_price = col["l_extendedprice"] * (100 - col["l_discount"])  # scale 4
    vals = (col["l_quantity"], col["l_extendedprice"], disc_price,
            disc_price * (100 + col["l_tax"]), col["l_discount"], np.ones_like(gid))
    out = {k: np.zeros(6, dtype=np.int64) for k in Q1_SUMS}
    for code in range(6):
        sel = gid == code
        for k, v in zip(Q1_SUMS, vals):
            out[k][code] = v[sel].sum()
    return out


def add_sums(total: dict, part: dict) -> None:
    for k in Q1_SUMS:
        total[k] += part[k]


def q1_rows_from_sums(sums: dict) -> list:
    """TPC-H Q1's rows from its sums: exact decimals, the averages as floats
    of their exact ratios, groups in code order (the dictionaries' sorted
    order)."""
    from fractions import Fraction

    from presto_tpu_torch.connectors.tpch import generator as g

    rows = []
    for code in range(6):
        n = int(sums["count"][code])
        if n == 0:
            continue
        qty, price, disc = (int(sums[k][code]) for k in ("sum_qty", "sum_base_price",
                                                          "sum_disc"))
        rows.append([g.DICT_RETURNFLAG.values[code // 2], g.DICT_LINESTATUS.values[code % 2],
                     Decimal(qty) / 100, Decimal(price) / 100,
                     Decimal(int(sums["sum_disc_price"][code])) / 10 ** 4,
                     Decimal(int(sums["sum_charge"][code])) / 10 ** 6,
                     float(Fraction(qty, 100 * n)), float(Fraction(price, 100 * n)),
                     float(Fraction(disc, 100 * n)), n])
    return rows


def lineitem_chunks(sf: float, columns, threads: int = 4, chunk_orders: int = 1 << 17):
    """The port's lineitem in chunks of ``chunk_orders`` orders, in the
    generator's order, made ``threads`` chunks at a time."""
    from concurrent.futures import ThreadPoolExecutor

    from presto_tpu_torch.connectors.tpch import generator as g

    orders = g.table_row_count("orders", sf)
    lows = list(range(0, orders, chunk_orders))

    def make(lo):
        return g.lineitem_for_orders(lo, min(lo + chunk_orders, orders), sf, list(columns))

    with ThreadPoolExecutor(threads) as pool:
        for i in range(0, len(lows), threads):
            yield from pool.map(make, lows[i:i + threads])


def q1_prefix_sums(sf: float, rows: Optional[int] = None):
    """Q1's sums over the first ``rows`` lineitem rows in the generator's
    order (all of them when None) -> (sums, rows summed)."""
    total = {k: np.zeros(6, dtype=np.int64) for k in Q1_SUMS}
    seen = 0
    for li in lineitem_chunks(sf, Q1_COLUMNS):
        n = len(li["l_shipdate"])
        take = n if rows is None else min(n, rows - seen)
        add_sums(total, q1_sums_np({k: v[:take] for k, v in li.items()}))
        seen += take
        if rows is not None and seen == rows:
            break
    return total, seen


def oracle_q1(schema: str):
    """TPC-H Q1 in numpy over the port's generator: rows as Python values
    (exact decimals; the averages as floats of their exact ratios), and the
    number of source rows it read."""
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sums, n = q1_prefix_sums(SCHEMAS[schema])
    return q1_rows_from_sums(sums), n


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


def run_sql_query(device, q: int, schema: str, cold_capture=None, unfused_capture=None):
    """SQL query ``q`` with ``hash_kernels="pallas"`` under the session
    defaults (fused segments, coalesced pages): a cold run (under
    ``cold_capture``), then a warm run with the launch counters and
    ``COUNTERS`` set to 0 just before it and read just after; then the
    query unfused (under ``unfused_capture``) and under
    ``hash_kernels="sorted"``. Fails unless the unfused rows equal the fused
    ones. Returns what the phases check and print."""
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
    t0 = time.perf_counter()
    with unfused_capture or contextlib.nullcontext():
        unfused = sql_runner(device, "pallas", schema, **UNFUSED).execute(QUERIES[q])
    sync()
    unfused_s = time.perf_counter() - t0
    if not same_rows(unfused.rows, res.rows):
        raise AssertionError(f"SQL Q{q} rows fused and unfused differ:\n{res.rows}\n"
                             f"{unfused.rows}")
    t0 = time.perf_counter()
    sorted_rows = sql_runner(device, "sorted", schema).execute(QUERIES[q]).rows
    sync()
    sorted_s = time.perf_counter() - t0
    return {"q": q, "schema": schema, "rows": res.rows,
            "segments": (res.stats or {}).get("segments"),
            "launches": launches, "delta": delta, "streams": dict(streams.calls),
            "peak": peak, "cold_s": cold_s, "warm_s": warm_s, "unfused_s": unfused_s,
            "sorted_rows": sorted_rows, "sorted_s": sorted_s, "drivers": res.drivers,
            "scan": (cold.stats or {}).get("scan_pipeline"),
            "warm_scan": (res.stats or {}).get("scan_pipeline"),
            "resident_pages": res.resident_pages}


def check_rows(rec: dict, oracle) -> None:
    """The warm rows and the sorted run's against the numpy oracle at the
    run's schema; logs the walls and the first rows."""
    q, schema = rec["q"], rec["schema"]
    want, source_rows = oracle(schema)
    if not same_rows(rec["rows"], want):
        raise AssertionError(f"SQL Q{q} rows differ from the numpy oracle:\n{rec['rows']}\n"
                             f"{want}")
    if not same_rows(rec["sorted_rows"], want):
        raise AssertionError(f"SQL Q{q} rows under hash_kernels='sorted' differ")
    warm_s = rec["warm_s"]
    log(f"SQL Q{q} {schema}: {len(rec['rows'])} rows equal to the numpy oracle, to the "
        f"unfused run and to the sorted run; cold wall "
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
        check_rows(rec, SQL_ORACLES[q])
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
        rec = run_sql_query(device, q, Q5_SCHEMA if q == 5 else schema,
                            unfused_capture=capture if q == 9 else None)
        records[q] = rec
        got, delta, calls = rec["launches"], rec["delta"], rec["streams"]
        log(f"SQL Q{q} {rec['schema']} launches on the warm run: {got}; probe calls per stream "
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
        check_rows(rec, JOIN_ORACLES[q])
        if q == 5:
            log(f"SQL Q5 {rec['schema']} expansion: {int(delta['join.expansion_chunks'])} "
                f"chunks, {int(delta['join.expanded_rows'])} expanded rows; peak device memory "
                f"{rec['peak']} bytes (torch.cuda.max_memory_allocated)")
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
        log(f"SEGMENTS SQL Q{q} {rec.get('schema', schema)}: {len(segs)} fused segment(s), "
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
            # Q5's runs are phase 8's at Q5_SCHEMA; it takes the oracle
            # properties there, once
            oschema = rec.setdefault("schema", schema)
            oracle_runner = sql_runner(device, "pallas", oschema, **ORACLE_PROPS)
            for _ in range(1 if q == 5 else 2):
                t0 = time.perf_counter()
                oracle = oracle_runner.execute(QUERIES[q])
                sync()
                walls.append(time.perf_counter() - t0)
        rec["oracle_s"] = walls
        if not same_rows(rec["rows"], oracle.rows):
            raise AssertionError(f"SQL Q{q}: rows under the defaults differ from the oracle "
                                 f"properties' ({ORACLE_PROPS}) at {oschema}:\n"
                                 f"{rec['rows']}\n{oracle.rows}")
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
            want, _ = DEFAULT_PATH_ORACLES[q](oschema)
            if not same_rows(rec["rows"], want):
                raise AssertionError(f"SQL Q{q} rows differ from the numpy oracle:\n"
                                     f"{rec['rows']}\n{want}")
            log(f"SQL Q{q} {oschema}: {len(want)} rows equal to the numpy oracle")
        if q == 18:
            spills = delta.get("agg.spilled_folds", 0)
            if not (rec.get("cold_spills") and spills):
                raise AssertionError(f"SQL Q18: the inner grouping did not spill ({spills})")
            rec["merge_s"] = merges.seconds
        out[q] = rec
        log(f"DEFAULTPATH SQL Q{q} {oschema}: {len(rec['rows'])} rows equal to the oracle "
            f"properties' run; drivers per pipeline {rec['drivers']}; cold wall "
            f"{rec['cold_s']:.4f}s, warm (resident) wall {rec['warm_s']:.4f}s, oracle "
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


def host_rows_main(out_dir: str) -> int:
    """``--host-rows DIR``: the port's CPU rows of every ported TPC-H query,
    then of every TPC-DS query, at ``CPU_ROWS_SCHEMA``, pickled as
    ``DIR/tpch.pkl`` and ``DIR/tpcds.pkl`` ({query: (rows, host seconds)}),
    each file renamed into place when complete."""
    import torch

    from presto_tpu_torch.models import tpcds_sql, tpch_sql

    torch.set_num_threads(2)  # the card's phases run beside it on the host
    for catalog, queries, run in (
            ("tpch", PORTED_QUERIES, lambda q: sql_runner(
                "cpu", "pallas", CPU_ROWS_SCHEMA).execute(tpch_sql.QUERIES[q])),
            ("tpcds", sorted(tpcds_sql.QUERIES), lambda q: ds_runner(
                "cpu", CPU_ROWS_SCHEMA).execute(tpcds_sql.QUERIES[q]))):
        out = {}
        for q in queries:
            t0 = time.perf_counter()
            out[q] = (run(q).rows, time.perf_counter() - t0)
        path = os.path.join(out_dir, f"{catalog}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    return 0


class HostRows:
    """The card-against-host checks' host half, run beside the card's
    phases: a child process (``--host-rows``, with no card visible)
    computes the port's CPU rows at ``CPU_ROWS_SCHEMA``; ``rows`` waits for
    a catalog's file, ``close`` stops the child and removes its files."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip-smoke-host-rows-")
        self.err = open(os.path.join(self.dir, "child.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--host-rows", self.dir],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), stdout=self.err,
            stderr=subprocess.STDOUT)
        self.waited_s = 0.0

    def rows(self, catalog: str, timeout: float = 900.0) -> dict:
        """{query: (rows, host seconds)} of ``catalog`` ("tpch" or "tpcds")."""
        path = os.path.join(self.dir, f"{catalog}.pkl")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                self.err.seek(0)
                raise AssertionError(f"the host-rows process exited {self.proc.returncode}:\n"
                                     f"{self.err.read()[-4000:]}")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"no host rows of {catalog} after {timeout:.0f}s")
            time.sleep(0.2)
        self.waited_s += time.perf_counter() - t0
        with open(path, "rb") as f:
            return pickle.load(f)

    def close(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def check_cpu_rows(device, schema: str = CPU_ROWS_SCHEMA,
                   host: Optional[HostRows] = None) -> float:
    """Every ported query under the defaults, on the card and in the port's
    own CPU run (``host``'s child process, else here), both at ``schema``:
    equal rows. -> the host runs' seconds."""
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE

    host_rows = host.rows("tpch") if host is not None else {}
    total = 0.0
    for q in PORTED_QUERIES:
        card = sql_runner(device, "pallas", schema).execute(QUERIES[q]).rows
        if q in host_rows:
            rows, host_s = host_rows[q]
        else:
            t0 = time.perf_counter()
            rows = sql_runner("cpu", "pallas", schema).execute(QUERIES[q]).rows
            host_s = time.perf_counter() - t0
        total += host_s
        if not same_rows(card, rows):
            raise AssertionError(f"SQL Q{q}: the card's rows differ from the CPU run's "
                                 f"at {schema}:\n{card}\n{rows}")
        log(f"CPU SQL Q{q} {schema}: {len(rows)} rows equal to the card's "
            f"({host_s:.2f}s on the host)")
    RESIDENT_CACHE.clear()  # the host pages are no use to the card
    return total


# phase 12: TPC-DS at SF1 (no cache token: every run regenerates its pages)
DS_DEEP = (64, 72)   # the north-star pair: profiler, expansion, kernel shapes
DS_NO_ROWS = (50,)   # returns no rows at tiny and SF1, in both packages
# the oracle-property runs of phase 12 go at this schema, against a run under
# the defaults there (at SF1 they took 19-30 s of the phase)
DS_ORACLE_SCHEMA = "tiny"


def ds_runner(device, schema: str, **props):
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    return LocalQueryRunner(Session(catalog="tpcds", schema=schema,
                                    properties={"hash_kernels": "pallas", **props}),
                            device=device)


def run_tpcds_phase(device, schema: str = "sf1", oracle_schema: str = DS_ORACLE_SCHEMA) -> dict:
    """Every TPC-DS query of ``models/tpcds_sql.py`` with
    ``hash_kernels="pallas"`` under the full defaults: a warm run with the
    launch counters and ``COUNTERS`` set to 0 just before it and read just
    after, after a cold run for ``DS_DEEP`` only (whose kernel shapes the
    cold run captures; the others' cold SF1 runs were cut for the script's
    budget); then, at ``oracle_schema``, one run under the oracle
    properties and one under the defaults. A TPC-DS scan has no cache
    token, so every run regenerates its pages. Fails unless cold and warm
    give the same rows, and so do the two runs at ``oracle_schema``,
    the warm run replayed no
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
        cold, cold_s = None, None
        if q in DS_DEEP:
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
        oracle = ds_runner(device, oracle_schema, **ORACLE_PROPS).execute(QUERIES[q])
        sync()
        oracle_s = time.perf_counter() - t0
        base = res if oracle_schema == schema else \
            ds_runner(device, oracle_schema).execute(QUERIES[q])
        rec = {"q": q, "rows": res.rows, "launches": launches, "delta": delta,
               "drivers": res.drivers, "cold_s": cold_s, "warm_s": warm_s,
               "oracle_s": oracle_s, "peak": peak,
               "scan": ((cold or res).stats or {}).get("scan_pipeline"),
               "warm_scan": (res.stats or {}).get("scan_pipeline"),
               "oracle_schema": oracle_schema, "oracle_schema_rows": base.rows}
        if cold is not None and not same_rows(cold.rows, res.rows):
            raise AssertionError(f"SQL DS Q{q}: cold and warm rows differ:\n"
                                 f"{cold.rows}\n{res.rows}")
        if not same_rows(oracle.rows, base.rows):
            raise AssertionError(f"SQL DS Q{q}: the oracle properties' rows differ from the "
                                 f"defaults' at {oracle_schema}:\n{base.rows}\n{oracle.rows}")
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
        cold_wall = f"{cold_s:.4f}s" if cold is not None else "not run"
        log(f"DSPATH SQL DS Q{q} {schema}: {len(res.rows)} rows"
            f"{' equal cold and warm,' if cold is not None else ''} equal under the oracle "
            f"properties at {oracle_schema}; drivers per pipeline "
            f"{res.drivers}; cold wall {cold_wall}, warm wall {warm_s:.4f}s (regenerated, "
            f"{res.resident_pages} resident pages), oracle at {oracle_schema} {oracle_s:.4f}s; "
            f"launches {launches}; join builds {int(builds)}, "
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


def check_ds_cpu_rows(device, schema: str = CPU_ROWS_SCHEMA,
                      host: Optional[HostRows] = None, card_rows: Optional[dict] = None) -> float:
    """Every TPC-DS query under the defaults, on the card (``card_rows``,
    {query: rows} at ``schema``, else run here) and in the port's own CPU run
    (``host``'s child process, else here), both at ``schema``: equal rows.
    -> the host runs' seconds."""
    from presto_tpu_torch.models.tpcds_sql import QUERIES

    host_rows = host.rows("tpcds") if host is not None else {}
    total = 0.0
    for q in sorted(QUERIES):
        card = card_rows[q] if card_rows else ds_runner(device, schema).execute(QUERIES[q]).rows
        if q in host_rows:
            rows, host_s = host_rows[q]
        else:
            t0 = time.perf_counter()
            rows = ds_runner("cpu", schema).execute(QUERIES[q]).rows
            host_s = time.perf_counter() - t0
        total += host_s
        if not same_rows(card, rows):
            raise AssertionError(f"SQL DS Q{q}: the card's rows differ from the CPU run's "
                                 f"at {schema}:\n{card}\n{rows}")
        log(f"CPU SQL DS Q{q} {schema}: {len(rows)} rows equal to the card's "
            f"({host_s:.2f}s on the host)")
    return total


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


# the phase 14 queries that run once (no separate cold run)
# run once each (their cold SF1 runs were cut for the script's budget:
# ``port_walls.py --p14`` keeps them); the per-day grouping's cold run
# captures its insert's shape
P14_ONE_RUN = tuple(label for label in P14_SQL if label != "agg per day")
# the numpy oracles hold phase 14's rows at this schema, on the card and in
# the CPU run (their SF1 checks took most of the phase and were cut for the
# script's budget: ``port_walls.py --p14 all`` keeps them)
P14_ORACLE_SCHEMA = CPU_ROWS_SCHEMA


def run_p14_phase(device, schema: str = "sf1") -> dict:
    """Phase 14: windows, FULL joins and the new aggregates at TPC-H
    ``schema`` with ``hash_kernels="pallas"`` under the full defaults: each
    query cold (cache cleared; its kernel inputs captured), warm (launch
    counters and ``COUNTERS`` set to 0 just before it, the peak device
    memory reset); then on the card and the CPU at ``CPU_ROWS_SCHEMA``.
    Every query but the per-day grouping (``P14_ONE_RUN``) runs once, with
    the counters set to 0 before it: its cold SF1 run was cut for the
    script's budget.
    Fails unless the rows at ``P14_ORACLE_SCHEMA`` (``schema`` too, when it
    is that schema) equal the numpy oracle's, on the card and in the CPU
    run, the card's rows there the CPU run's, the insert launched once per
    join build and grouped page, nothing fell back, the per-day grouping took the insert
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
        cold_s = None
        if label not in P14_ONE_RUN:
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
        if schema == P14_ORACLE_SCHEMA:
            check_p14_rows(label, res.rows, schema)
        small = sql_runner(device, "pallas", CPU_ROWS_SCHEMA).execute(sql).rows
        t0 = time.perf_counter()
        cpu_rows = sql_runner("cpu", "pallas", CPU_ROWS_SCHEMA).execute(sql).rows
        cpu_s = time.perf_counter() - t0
        check_p14_rows(label, small, CPU_ROWS_SCHEMA)
        check_p14_rows(label, cpu_rows, CPU_ROWS_SCHEMA)
        if not same_p14_rows(label, small, cpu_rows):
            raise AssertionError(f"P14 {label}: the card's rows at {CPU_ROWS_SCHEMA} differ "
                                 f"from the CPU run's:\n{small[:3]}\n{cpu_rows[:3]}")
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
        log(f"{kind} {label} {schema}: {len(res.rows)} rows; at {CPU_ROWS_SCHEMA} the card's "
            f"rows equal the numpy oracle's and the CPU run's ({cpu_s:.2f}s on the host); "
            f"drivers per pipeline {res.drivers}; "
            f"cold wall {'not run' if cold_s is None else f'{cold_s:.4f}s'}, warm wall "
            f"{warm_s:.4f}s; launches {launches}; join "
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


class OperatorPeaks:
    """Records, while on, each operator's accounted peak (the most bytes one
    of its memory contexts held, over its drivers and a grouped query's
    buckets), keyed by the context's tag (the operator's name), and what
    each tag held, summed over its contexts, when the sum over every
    context peaked (``at_peak``, ``total``)."""

    def __enter__(self):
        import threading

        from presto_tpu_torch.memory import LocalMemoryContext

        self.cls, self.set_bytes = LocalMemoryContext, LocalMemoryContext.set_bytes
        self.peaks, self.at_peak, self.total = {}, {}, 0
        live, lock, rec = {}, threading.Lock(), self

        def set_bytes(ctx, new_bytes):
            rec.set_bytes(ctx, new_bytes)
            with lock:
                rec.peaks[ctx.tag] = max(rec.peaks.get(ctx.tag, 0), new_bytes)
                live[id(ctx)] = (ctx.tag, new_bytes)
                total = sum(b for _t, b in live.values())
                if total > rec.total:
                    rec.total, rec.at_peak = total, {}
                    for tag, b in live.values():
                        if b:
                            rec.at_peak[tag] = rec.at_peak.get(tag, 0) + b

        LocalMemoryContext.set_bytes = set_bytes
        return self

    def __exit__(self, *exc):
        self.cls.set_bytes = self.set_bytes
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


# phase 18: the file catalog at TPC-H SF1
# lineitem's Q1/Q3/Q6 columns: the lineitem of every file format; orders and
# customer whole: o_clerk, o_comment, c_name and the rest are generated
# (virtual) dictionaries that the sinks materialize. Writing and scanning
# l_comment's ~6M strings takes longer than the phase's budget:
# file_walls.py measures them
FILE_LI_COLUMNS = ("l_orderkey, l_quantity, l_extendedprice, l_discount, l_tax, "
                   "l_returnflag, l_linestatus, l_shipdate")
FILE_TABLES = {"lineitem": FILE_LI_COLUMNS, "orders": "*", "customer": "*"}
FILE_Q6_COLUMNS = "l_orderkey, l_quantity, l_extendedprice, l_discount, l_shipdate"
FILE_YEARS = tuple(range(1992, 1999))
# the ORC and RCFile steps' schema: ORC at SF1 took 67 s of the phase on an
# H100 machine (CTAS 8.5-9.4 s, Q1 15.6-15.7 s, Q6 9.7-10.1 s of host
# decoding), so it runs at tiny, against the port's CPU run too; RCFile
# decodes its text cells one at a time in Python, in both packages
ORC_SCHEMA = "tiny"
# steps run once, still at SF1, their one wall logged as cold and warm:
# the orders CTAS (3.4 s a run) and Parquet Q1 (2.8-3.0 s)
FILE_ONE_RUN = ("ctas orders", "parquet q1")
RC_SCHEMA = "tiny"


def _table_files(base: str, table: str) -> dict:
    """name -> bytes of a file table's data files (the empty seed file that
    pins the schema left out)."""
    d = os.path.join(base, "default", table)
    return {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))
            if not f.startswith("00000000.")}


class SplitLog:
    """Records the splits a file catalog's split manager keeps for each
    scan while on, and (after the query) the splits of the whole table."""

    def __init__(self, connector):
        self.manager = connector.split_manager()
        self.calls = []

    def __enter__(self):
        real = self.real = self.manager.get_splits
        log_ = self

        def get_splits(table, constraint, desired):
            kept = real(table, constraint, desired)
            log_.calls.append((table, dict(constraint.domains), kept))
            return kept

        self.manager.get_splits = get_splits
        return self

    def __exit__(self, *exc):
        del self.manager.get_splits  # the class's method again
        return False

    def last(self, table: str) -> tuple:
        """(handle, domains, splits kept) of the last scan of ``table``."""
        return [c for c in self.calls if c[0].schema_table.table == table][-1]

    def kept(self, table: str) -> tuple:
        """(splits kept, splits of the table) of the last scan of ``table``."""
        from presto_tpu_torch.spi.connector import Constraint

        handle, _domains, kept = self.last(table)
        return len(kept), len(self.real(handle, Constraint.all(), 8))


def oracle_file_days(schema: str):
    """Per ``l_shipdate``: count(*), sum(l_quantity), min(l_extendedprice),
    in numpy over the port's generator."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_quantity", "l_extendedprice", "l_shipdate"])
    order = np.argsort(li["l_shipdate"], kind="stable")
    days, starts, counts = np.unique(li["l_shipdate"][order], return_index=True,
                                     return_counts=True)
    qty = np.add.reduceat(li["l_quantity"][order].astype(np.int64), starts)
    price = np.minimum.reduceat(li["l_extendedprice"][order].astype(np.int64), starts)
    epoch = datetime.date(1970, 1, 1)
    return [[epoch + datetime.timedelta(days=int(d)), int(c), Decimal(int(q)) / 100,
             Decimal(int(p)) / 100] for d, c, q, p in zip(days, counts, qty, price)]


FILE_DAYS_SQL = ("select l_shipdate, count(*), sum(l_quantity), min(l_extendedprice) "
                 "from {} group by 1 order by 1")


def run_file_phase(device, schema: str = "sf1") -> dict:
    """Phase 18: the file catalog at TPC-H ``schema`` with
    ``hash_kernels="pallas"`` under the defaults, in one runner with three
    ``FileConnector`` catalogs in a temporary directory: ``wh`` (PCOL),
    ``pq`` (Parquet) and ``oc`` (ORC).

    - PCOL: CTAS of ``lineitem`` (``FILE_LI_COLUMNS``), ``orders`` and
      ``customer`` on the scaled writers; Q1, Q3 and Q6 over them against
      the numpy oracles, Q6 through the split readers and the native
      prefilter (the rows uploaded must be exactly the rows inside Q6's
      pushed-down domains); the per-day grouping of the file ``lineitem``
      against numpy, with the insert held at its shape.
    - Split pruning: Q6's columns inserted one ``l_shipdate`` year at a
      time; Q6 must keep exactly the 1994 insert's files.
    - The mixed Q3 (file ``lineitem``, ``tpch`` ``orders`` and
      ``customer``): insert = the two builds, a probe per re-batched page,
      no fallback, the probe held bit-identical at the split readers' page
      shape.
    - Parquet and ORC: CTAS of lineitem's eight Q1/Q3/Q6 columns, Q1 and Q6
      against the oracles, the row groups or stripes Q6 keeps, and the
      mixed Q3 over the Parquet ``lineitem``. ORC runs at ``ORC_SCHEMA``,
      and, where that differs from ``schema``, against the port's CPU run
      too.
    - RCFile at ``RC_SCHEMA``: a table written with ``write_rcfile_table``,
      scanned against numpy; an INSERT is refused.

    Each step runs cold and warm (the warm launch counters set to 0 just
    before it), but the steps of ``FILE_ONE_RUN`` run once, and prints a
    ``FILE`` line. Returns the records whose launches the kernels line
    reports."""
    import functools
    import shutil
    import tempfile

    import torch

    from presto_tpu_torch.connectors.file import FileConnector
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.formats.rcfile import write_rcfile_table
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.types import BIGINT, DATE, VARCHAR, DecimalType
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-file-")
    oracle = functools.lru_cache(maxsize=None)(lambda q, sch: SQL_ORACLES[q](sch)[0])

    @functools.lru_cache(maxsize=None)
    def n_lineitem(sch):
        sf_ = SCHEMAS[sch]
        return len(g.lineitem_for_orders(0, g.table_row_count("orders", sf_), sf_,
                                         ["l_shipdate"])["l_shipdate"])
    out = {}
    runner = sql_runner(device, "pallas", schema)
    bases = {c: os.path.join(tmp, c) for c in ("wh", "pq", "oc", "rc")}
    formats = {"wh": "pcol", "pq": "parquet", "oc": "orc"}
    for cat, fmt in formats.items():
        runner.catalogs.register(cat, FileConnector(cat, bases[cat], write_format=fmt))
    q3_tables = "from customer, orders, lineitem"

    def timed_run(r, sql):
        t0 = time.perf_counter()
        res = r.execute(sql)
        sync()
        return res, time.perf_counter() - t0

    def step(label, sql, r=None, setup=None, splits=None, once=False):
        """A cold run, then ``setup`` and the warm run, counters zeroed;
        ``splits``: (catalog, table) whose kept splits the warm run logs.
        ``once``: one run only (``FILE_ONE_RUN``), counted as both."""
        r = r or runner
        if not once:
            res, cold_s = timed_run(r, sql)
            if setup is not None:
                setup()
        before = {k: METRICS.counter_value(k) for k in COUNTERS + (
            "pcol.native_opens", "pcol.numpy_opens")}
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        if splits is not None:
            with SplitLog(r.metadata.connector(splits[0])) as slog:
                res, warm_s = timed_run(r, sql)
        else:
            res, warm_s = timed_run(r, sql)
        if once:
            cold_s = warm_s
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        delta = {k: METRICS.counter_value(k) - v for k, v in before.items()}
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"FILE {label}: a fallback: {delta}")
        rec = out[label] = {"rows": res.rows, "launches": launches, "delta": delta,
                            "cold_s": cold_s, "warm_s": warm_s, "res": res,
                            "splits": slog.kept(splits[1]) if splits else None,
                            "kept": slog.last(splits[1]) if splits else None}
        return rec

    def file_line(label, extra="", sch=schema):
        rec = out[label]
        kept = "" if rec["splits"] is None else \
            f"; splits kept {rec['splits'][0]} of {rec['splits'][1]}"
        log(f"FILE {label} {sch}: cold wall "
            f"{rec['cold_s']:.4f}s, warm wall {rec['warm_s']:.4f}s; launches "
            f"{rec['launches']}; join builds {int(rec['delta']['pallas.join_builds'])}, "
            f"grouped pages {int(rec['delta']['pallas.agg_pages'])}{kept}{extra}")

    def check_mixed(label):
        rec = out[label]
        if rec["delta"]["pallas.join_builds"] != 2 or \
                (on_card and rec["launches"]["probe"] <= 0):
            raise AssertionError(f"FILE {label}: the kernels' path was not taken: {rec}")
        if on_card and rec["launches"]["insert"] != 2 + rec["delta"]["pallas.agg_pages"]:
            raise AssertionError(f"FILE {label}: insert launches {rec['launches']}")

    try:
        sf = SCHEMAS[schema]
        n_li = n_lineitem(schema)
        RESIDENT_CACHE.clear()
        # 1. PCOL CTAS of three tables on the scaled writers
        for t, cols in FILE_TABLES.items():
            src = f"select {cols} from tpch.{schema}.{t}"
            n_want = n_li if t == "lineitem" else g.table_row_count(t, sf)
            writers = runner._scaled_writer_count(runner.plan_sql(src))
            step(f"ctas {t}", f"create table wh.default.{t} as {src}",
                 setup=lambda t=t: runner.execute(f"drop table wh.default.{t}"),
                 once=f"ctas {t}" in FILE_ONE_RUN)
            rec = out[f"ctas {t}"]
            if rec["rows"] != [[n_want]]:
                raise AssertionError(f"FILE ctas {t}: {rec['rows']} rows, want {n_want}")
            files = _table_files(bases["wh"], t)
            rec["bytes"] = sum(files.values())
            file_line(f"ctas {t}", f"; {n_want} rows, writer drivers {writers}, {len(files)} "
                      f"files, {rec['bytes']} bytes ({n_want / rec['warm_s']:.0f} rows/s warm)")
        # 2. Q1, Q3, Q6 over the PCOL tables
        for q in (1, 6, 3):
            sql = QUERIES[q].replace(q3_tables, "from wh.default.customer, wh.default.orders, "
                                                "wh.default.lineitem") \
                if q == 3 else QUERIES[q].replace("from lineitem", "from wh.default.lineitem")
            rec = step(f"pcol q{q}", sql, splits=("wh", "lineitem"))
            if not same_rows(rec["rows"], oracle(q, schema)):
                raise AssertionError(f"FILE pcol q{q}: rows differ from the oracle:\n"
                                     f"{rec['rows'][:3]}")
            file_line(f"pcol q{q}", f"; scan {_fmt_scan(rec['res'].stats.get('scan_pipeline'))}")
        # Q6 took the split readers and the native prefilter: the rows it
        # uploaded are exactly the rows inside its pushed-down domains (the
        # constant comparisons on l_shipdate and l_quantity; the BETWEEN of
        # l_discount gives none, in the reference too)
        rec = out["pcol q6"]
        st = rec["res"].stats.get("scan_pipeline") or {}
        domains = rec["kept"][1]
        li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf, list(domains))
        inside = np.ones(n_li, dtype=bool)
        for col, (lo, hi) in domains.items():
            if lo is not None:
                inside &= li[col] >= lo
            if hi is not None:
                inside &= li[col] <= hi
        inside = int(inside.sum())
        if "l_shipdate" not in domains or not st.get("chunks") or st.get("rows") != inside:
            raise AssertionError(f"FILE pcol q6: not re-batched from the prefiltered split "
                                 f"readers: {st}, domains {domains}, {inside} rows inside")
        if rec["delta"]["pcol.native_opens"] <= 0 or rec["delta"]["pcol.numpy_opens"] != 0:
            raise AssertionError(f"FILE pcol q6: opens {rec['delta']}")
        log(f"FILE pcol q6 {schema}: domains {domains}; rows read {n_li}, rows uploaded "
            f"{st['rows']} (= the rows inside the domains) in {st['pages']} re-batched pages "
            f"from {st['chunks']} split-reader chunks; native opens "
            f"{int(rec['delta']['pcol.native_opens'])}, numpy opens 0")
        # the per-day grouping of the file lineitem takes the insert
        capture = KernelCapture()
        with capture:
            timed_run(runner, FILE_DAYS_SQL.format("wh.default.lineitem"))
        rec = step("pcol agg per day", FILE_DAYS_SQL.format("wh.default.lineitem"))
        if not same_rows(rec["rows"], oracle_file_days(schema)):
            raise AssertionError(f"FILE pcol agg per day: rows differ:\n{rec['rows'][:3]}")
        grouping = capture.grouping or capture.build
        if on_card and (rec["delta"]["pallas.agg_pages"] <= 0 or grouping is None):
            raise AssertionError(f"FILE pcol agg per day: the insert was not taken: {rec}")
        if grouping is not None:
            rec["insert"] = check_insert_at(device, "phase 18 file-table grouping", *grouping)
        file_line("pcol agg per day")

        # 3. split pruning: Q6's columns, one l_shipdate year per INSERT
        runner.execute(f"create table wh.default.years as select {FILE_Q6_COLUMNS} "
                       f"from tpch.{schema}.lineitem where l_orderkey < 0")
        by_year = {}
        for y in FILE_YEARS:
            before = set(_table_files(bases["wh"], "years"))
            timed_run(runner, f"insert into wh.default.years select "
                                           f"{FILE_Q6_COLUMNS} from tpch.{schema}.lineitem "
                                           f"where l_shipdate >= date '{y}-01-01' and "
                                           f"l_shipdate < date '{y + 1}-01-01'")
            by_year[y] = sorted(set(_table_files(bases["wh"], "years")) - before)
        rec = step("pcol years q6", QUERIES[6].replace("from lineitem", "from wh.default.years"),
                   splits=("wh", "years"))
        if not same_rows(rec["rows"], oracle(6, schema)):
            raise AssertionError(f"FILE pcol years q6: rows differ: {rec['rows']}")
        _handle, domains, kept = rec["kept"]
        kept_files = sorted(os.path.basename(s.payload[1]) for s in kept)
        if kept_files != by_year[1994]:
            raise AssertionError(f"FILE pcol years q6: kept {kept_files}, the 1994 insert "
                                 f"wrote {by_year[1994]}")
        file_line("pcol years q6", f"; files per insert "
                  f"{[len(by_year[y]) for y in FILE_YEARS]}, kept exactly the 1994 insert's "
                  f"{len(kept_files)} (domains {domains})")

        # 4. the mixed Q3: the file lineitem probes tpch's tables
        want_q3 = oracle(3, schema)
        mixed = QUERIES[3].replace(q3_tables, f"from tpch.{schema}.customer, "
                                              f"tpch.{schema}.orders, wh.default.lineitem")
        capture = KernelCapture()
        with capture:
            timed_run(runner, mixed)
        rec = step("pcol q3 mixed", mixed, splits=("wh", "lineitem"))
        if not same_rows(rec["rows"], want_q3):
            raise AssertionError(f"FILE pcol q3 mixed: rows differ:\n{rec['rows'][:3]}")
        check_mixed("pcol q3 mixed")
        if not capture.by_table:
            raise AssertionError("FILE pcol q3 mixed: no probe of a file page was captured")
        args = max(capture.by_table.values(), key=lambda a: a[1].shape[0])
        rec["probe"] = check_probe_at(device, "phase 18 mixed Q3 (a split-reader page)", *args)
        st = rec["res"].stats.get("scan_pipeline") or {}
        file_line("pcol q3 mixed", f"; the file lineitem gave {st.get('pages')} re-batched "
                  f"pages of {st.get('rows')} rows in all, probes {rec['launches']['probe']}")

        # 5. Parquet and ORC: lineitem's Q1/Q3/Q6 columns
        fmt_runners = {"pq": (runner, schema)}
        if ORC_SCHEMA == schema:
            fmt_runners["oc"] = (runner, schema)
        else:
            orc_runner = sql_runner(device, "pallas", ORC_SCHEMA)
            orc_runner.catalogs.register("oc", FileConnector("oc", bases["oc"],
                                                             write_format="orc"))
            fmt_runners["oc"] = (orc_runner, ORC_SCHEMA)
        for cat, (r, sch) in fmt_runners.items():
            name = formats[cat]
            src = f"select {FILE_LI_COLUMNS} from tpch.{sch}.lineitem"
            step(f"{name} ctas lineitem", f"create table {cat}.default.lineitem as {src}", r=r,
                 setup=lambda cat=cat, r=r: r.execute(f"drop table {cat}.default.lineitem"))
            rec = out[f"{name} ctas lineitem"]
            n_want = n_lineitem(sch)
            if rec["rows"] != [[n_want]]:
                raise AssertionError(f"FILE {name} ctas: {rec['rows']}, want {n_want}")
            files = _table_files(bases[cat], "lineitem")
            rec["bytes"] = sum(files.values())
            file_line(f"{name} ctas lineitem", f"; {n_want} rows, {len(files)} files, "
                      f"{rec['bytes']} bytes ({n_want / rec['warm_s']:.0f} rows/s warm)", sch)
            for q in (1, 6):
                sql = QUERIES[q].replace("from lineitem", f"from {cat}.default.lineitem")
                rec = step(f"{name} q{q}", sql, r=r, splits=(cat, "lineitem"),
                           once=f"{name} q{q}" in FILE_ONE_RUN)
                if not same_rows(rec["rows"], oracle(q, sch)):
                    raise AssertionError(f"FILE {name} q{q}: rows differ:\n{rec['rows'][:3]}")
                if sch != schema:
                    cpu = sql_runner(torch.device("cpu"), "pallas", sch)
                    cpu.catalogs.register(cat, FileConnector(cat, bases[cat], write_format=name))
                    if not same_rows(cpu.execute(sql).rows, rec["rows"]):
                        raise AssertionError(f"FILE {name} q{q}: the card's rows differ from "
                                             f"the CPU run's")
                unit = "row groups" if cat == "pq" else "stripes"
                file_line(f"{name} q{q}", f" ({unit})", sch)
        rec = step("parquet q3 mixed", QUERIES[3].replace(
            q3_tables, f"from tpch.{schema}.customer, tpch.{schema}.orders, pq.default.lineitem"),
            splits=("pq", "lineitem"))
        if not same_rows(rec["rows"], want_q3):
            raise AssertionError(f"FILE parquet q3 mixed: rows differ:\n{rec['rows'][:3]}")
        check_mixed("parquet q3 mixed")
        file_line("parquet q3 mixed", " (row groups)")

        # 6. RCFile, ingest-only, at RC_SCHEMA
        rsf = SCHEMAS[RC_SCHEMA]
        li = g.lineitem_for_orders(0, g.table_row_count("orders", rsf), rsf,
                                   ["l_orderkey", "l_quantity", "l_returnflag", "l_shipdate"])
        epoch = datetime.date(1970, 1, 1)
        flags = g.DICT_RETURNFLAG.values
        cells = [[str(int(v)) for v in li["l_orderkey"]],
                 [f"{int(v) // 100}.{int(v) % 100:02d}" for v in li["l_quantity"]],
                 [str(flags[int(v)]) for v in li["l_returnflag"]],
                 [(epoch + datetime.timedelta(days=int(v))).isoformat()
                  for v in li["l_shipdate"]]]
        rc_dir = os.path.join(bases["rc"], "default", "lineitem")
        os.makedirs(rc_dir)
        t0 = time.perf_counter()
        write_rcfile_table(os.path.join(rc_dir, "part0.rc"),
                           ["l_orderkey", "l_quantity", "l_returnflag", "l_shipdate"],
                           [BIGINT, DecimalType(12, 2), VARCHAR, DATE], cells,
                           rows_per_group=16384)
        write_s = time.perf_counter() - t0
        rc_runner = sql_runner(device, "pallas", RC_SCHEMA)
        rc_runner.catalogs.register("rc", FileConnector("rc", bases["rc"]))
        rec = step("rcfile scan", "select l_returnflag, count(*), sum(l_quantity), "
                   "min(l_shipdate), max(l_orderkey) from rc.default.lineitem "
                   "group by 1 order by 1", r=rc_runner)
        want = []
        for code in sorted(np.unique(li["l_returnflag"]), key=lambda c: flags[int(c)]):
            sel = li["l_returnflag"] == code
            want.append([str(flags[int(code)]), int(sel.sum()),
                         Decimal(int(li["l_quantity"][sel].astype(np.int64).sum())) / 100,
                         epoch + datetime.timedelta(days=int(li["l_shipdate"][sel].min())),
                         int(li["l_orderkey"][sel].max())])
        if not same_rows(rec["rows"], want):
            raise AssertionError(f"FILE rcfile scan: {rec['rows']} != {want}")
        try:
            rc_runner.execute("insert into rc.default.lineitem select 1, 2.00, 'A', "
                              "date '1995-01-01'")
            raise AssertionError("FILE rcfile: an INSERT was not refused")
        except RuntimeError as e:
            if "read-only" not in str(e):
                raise
        file_line("rcfile scan", f": {len(cells[0])} rows written in "
                  f"{write_s:.4f}s ({os.path.getsize(os.path.join(rc_dir, 'part0.rc'))} bytes); "
                  f"an INSERT is refused (read-only)", RC_SCHEMA)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for rec in out.values():
        rec.pop("res", None)
        rec.pop("kept", None)
    return out


HIVE_LI_COLUMNS = ("l_orderkey, l_extendedprice, l_discount, l_shipdate, l_quantity, "
                   "l_returnflag, l_linestatus, l_tax")
HIVE_TABLES = {"lineitem": (HIVE_LI_COLUMNS, "l_orderkey"),
               "orders": ("o_orderkey, o_custkey, o_orderdate, o_shippriority, o_totalprice",
                          "o_orderkey")}
HIVE_BUCKETS = 4
HIVE_PART_COLUMNS = ("l_orderkey, l_quantity, l_extendedprice, l_discount, l_shipdate, "
                     "l_shipmode")
# Q3 without customer, as users join two tables bucketed on the join key
HIVE_GROUPED_SQL = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue, "
                    "o_orderdate, o_shippriority from hive.default.lineitem "
                    "join hive.default.orders on l_orderkey = o_orderkey "
                    "where o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15' "
                    "group by l_orderkey, o_orderdate, o_shippriority "
                    "order by revenue desc, o_orderdate limit 10")
# a sum over one partition in 1994: {table: (partition column, the value's SQL)}
HIVE_PARTITION_SQL = ("select sum(l_extendedprice * l_discount), count(*) from "
                      "hive.default.{} where {} = {} and l_shipdate >= date '1994-01-01' "
                      "and l_shipdate < date '1995-01-01'")
HIVE_PARTITIONED = {"shipmodes": ("l_shipmode", "'MAIL'"), "linenumbers": ("l_linenumber", "3")}
# the Parquet and ORC hive tables' schema (ORC at SF1 took 67 s of phase 18)
HIVE_FORMAT_SCHEMA = "tiny"
# a year of lineitem at SF1 (0.85-0.92 M rows) is a small shard under this
RAPTOR_THRESHOLD = 1 << 20


def oracle_partition_sum(schema: str, table: str):
    """``HIVE_PARTITION_SQL`` over ``table`` in numpy over the port's
    generator."""
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    col, value = HIVE_PARTITIONED[table]
    li = g.lineitem_for_orders(0, g.table_row_count("orders", sf), sf,
                               ["l_extendedprice", "l_discount", "l_shipdate", col])
    want = g.DICT_SHIP_MODE.code_of(value.strip("'")) if col == "l_shipmode" else int(value)
    keep = (li[col] == want) & \
        (li["l_shipdate"] >= civil_day(1994, 1, 1)) & (li["l_shipdate"] < civil_day(1995, 1, 1))
    rev = int((li["l_extendedprice"][keep].astype(np.int64) *
               li["l_discount"][keep].astype(np.int64)).sum())
    return [[Decimal(rev) / 10 ** 4, int(keep.sum())]]


class RoutingClock:
    """Sums, while on, the seconds the hive sinks spend in ``append_page``
    (the host copy, the routing and the buffering) and in its numpy
    partition grouping, over every writer thread."""

    def __enter__(self):
        from presto_tpu_torch.connectors import hive

        self.hive, self.append, self.groups = hive, hive.HivePageSink.append_page, \
            hive.partition_groups
        self.append_s = self.groups_s = 0.0
        clock = self

        def timed(fn, attr):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    setattr(clock, attr, getattr(clock, attr) + time.perf_counter() - t0)
            return run

        hive.HivePageSink.append_page = timed(self.append, "append_s")
        hive.partition_groups = timed(self.groups, "groups_s")
        return self

    def __exit__(self, *exc):
        self.hive.HivePageSink.append_page = self.append
        self.hive.partition_groups = self.groups
        return False


def _hive_files(base: str, table: str) -> dict:
    """(partition directory, bucket) -> [bytes of each data file]."""
    from presto_tpu_torch.connectors.hive import _bucket_of_file

    root = os.path.join(base, "default", table)
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.startswith("."):
                out.setdefault((os.path.relpath(dirpath, root), _bucket_of_file(f)), []).append(
                    os.path.getsize(os.path.join(dirpath, f)))
    return out


def run_warehouse_phase(device, schema: str = "sf1") -> dict:
    """Phase 19: the warehouse connectors at TPC-H ``schema`` with
    ``hash_kernels="pallas"`` under the defaults, in one runner with a
    ``hive`` and a ``raptor`` catalog in a temporary directory.

    - Hive CTAS of ``lineitem`` and ``orders`` bucketed 4 ways on their
      order keys (files per bucket, bytes, rows/s).
    - The grouped query (``HIVE_GROUPED_SQL``) against numpy: grouped (4
      buckets, one at a time) and ungrouped, cold and warm, each warm run's
      peak device memory (``torch.cuda.max_memory_allocated`` less what was
      allocated before the run) beside its accounted peak; then grouped under the unfused properties, where the
      grouping takes the insert (a fused grouping computes the sort
      partial, and a hive build is not provably unique, so it builds
      sorted): at least one insert launch, the insert held bit-identical
      at the first bucket's grouped-page shape.
    - Hive CTAS partitioned by ``l_shipmode`` (7 partitions) with the
      routing's share of its wall, and by ``l_linenumber``; a sum over one
      partition of each in 1994 (``HIVE_PARTITIONED``): the
      ``l_linenumber`` sum keeps exactly its partition's splits, the
      ``l_shipmode`` sum every split (a string constant gives no domain,
      in the reference too).
    - The mixed Q3: the bucketed hive ``lineitem`` probes ``tpch``'s
      ``orders`` and ``customer`` (ungrouped): insert = the two builds, a
      probe per page, the probe held bit-identical at a hive page's shape.
    - Parquet and ORC hive tables at ``HIVE_FORMAT_SCHEMA``: a CTAS and Q1.
    - Raptor: CTAS of ``lineitem``'s eight columns and Q6; Q6's columns
      inserted one year at a time (shards under ``RAPTOR_THRESHOLD``), Q6
      keeping exactly the 1994 shard, pruned in the metadata database;
      ``maintenance()`` compacting the seven into one, and Q6 again.

    Each step runs cold and warm (the warm launch counters set to 0 just
    before it) and prints a ``WAREHOUSE`` line. Returns the records whose
    launches the kernels line reports, keyed ``HIVE ...`` and ``RAPTOR
    ...``."""
    import contextlib
    import shutil
    import tempfile

    import torch

    from presto_tpu_torch.connectors.hive import HiveConnector
    from presto_tpu_torch.connectors.raptor import RaptorConnector
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.spi.connector import SchemaTableName
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-warehouse-")
    sf = SCHEMAS[schema]
    out = {}
    hive_conn = HiveConnector("hive", os.path.join(tmp, "hive"))
    raptor_conn = RaptorConnector("raptor", os.path.join(tmp, "raptor"),
                                  compaction_threshold_rows=RAPTOR_THRESHOLD)

    def runner_of(sch=schema, **props):
        r = sql_runner(device, "pallas", sch, **props)
        r.catalogs.register("hive", hive_conn)
        r.catalogs.register("raptor", raptor_conn)
        return r
    runner = runner_of()

    def timed_run(r, sql):
        t0 = time.perf_counter()
        res = r.execute(sql)
        sync()
        return res, time.perf_counter() - t0

    def step(label, sql, r=None, setup=None, splits=None, capture=None, clock=None):
        """A cold run, then ``setup`` and the warm run: launch counters set
        to 0 just before it, the allocator's peak reset, the accounted peak
        recorded, ``capture`` and ``clock`` on; ``splits``: the (catalog,
        table) whose kept splits the warm run logs."""
        r = r or runner
        _res, cold_s = timed_run(r, sql)
        if setup is not None:
            setup()
        before = {k: METRICS.counter_value(k) for k in COUNTERS}
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        # what earlier steps and phases hold (resident pages, the allocator's
        # cache): the run's own peak is the allocated peak less this
        base = torch.cuda.memory_allocated(device) if on_card else 0
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        with contextlib.ExitStack() as stack:
            peak = stack.enter_context(PoolPeak())
            ops = stack.enter_context(OperatorPeaks())
            for ctx in (capture, clock):
                if ctx is not None:
                    stack.enter_context(ctx)
            slog = stack.enter_context(SplitLog(r.metadata.connector(splits[0]))) \
                if splits else None
            res, warm_s = timed_run(r, sql)
        delta = {k: METRICS.counter_value(k) - v for k, v in before.items()}
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"WAREHOUSE {label}: a fallback: {delta}")
        out[label] = rec = {
            "rows": res.rows, "res": res, "cold_s": cold_s, "warm_s": warm_s, "delta": delta,
            "launches": {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches},
            "grouped": r.last_grouped, "accounted": peak.peak, "ops": ops, "base": base,
            "allocated": (torch.cuda.max_memory_allocated(device) if on_card else 0) - base,
            "splits": slog.kept(splits[1]) if splits else None,
            "kept": slog.last(splits[1])[2] if splits else None}
        return rec

    def line(label, extra="", sch=schema):
        rec = out[label]
        kept = "" if rec["splits"] is None else \
            f"; splits kept {rec['splits'][0]} of {rec['splits'][1]}"
        log(f"WAREHOUSE {label} {sch}: cold wall {rec['cold_s']:.4f}s, warm wall "
            f"{rec['warm_s']:.4f}s; launches {rec['launches']}; join builds "
            f"{int(rec['delta']['pallas.join_builds'])}, grouped pages "
            f"{int(rec['delta']['pallas.agg_pages'])}; last_grouped {rec['grouped']}; peak "
            f"accounted {rec['accounted']} bytes, allocated {rec['allocated']} bytes over the "
            f"{rec['base']} held before the run{kept}{extra}")

    def expect(label, rows, grouped=None):
        rec = out[label]
        if not same_rows(rec["rows"], rows):
            raise AssertionError(f"WAREHOUSE {label}: rows differ:\n{rec['rows'][:3]}\n"
                                 f"want {rows[:3]}")
        if rec["grouped"] != grouped:
            raise AssertionError(f"WAREHOUSE {label}: last_grouped {rec['grouped']}, "
                                 f"want {grouped}")

    def n_lineitem(sch):
        sf_ = SCHEMAS[sch]
        return len(g.lineitem_for_orders(0, g.table_row_count("orders", sf_), sf_,
                                         ["l_shipdate"])["l_shipdate"])

    try:
        n_li = n_lineitem(schema)
        # 1. hive CTAS, bucketed on the order keys
        for t, (cols, key) in HIVE_TABLES.items():
            n_want = n_li if t == "lineitem" else g.table_row_count(t, sf)
            step(f"HIVE ctas {t}", f"create table hive.default.{t} with (bucketed_by = "
                 f"array['{key}'], bucket_count = {HIVE_BUCKETS}) as select {cols} "
                 f"from tpch.{schema}.{t}",
                 setup=lambda t=t: runner.execute(f"drop table hive.default.{t}"))
            expect(f"HIVE ctas {t}", [[n_want]])
            files = _hive_files(hive_conn.store.base, t)
            per_bucket = {b: len(v) for (_d, b), v in sorted(files.items())}
            if sorted(per_bucket) != list(range(HIVE_BUCKETS)):
                raise AssertionError(f"WAREHOUSE ctas {t}: buckets {per_bucket}")
            nbytes = sum(sum(v) for v in files.values())
            line(f"HIVE ctas {t}", f"; {n_want} rows; files per bucket {per_bucket}, "
                 f"{nbytes} bytes ({n_want / out[f'HIVE ctas {t}']['warm_s']:.0f} rows/s warm)")

        # 2. the grouped query, grouped and ungrouped; the kernels' path unfused
        want = oracle_q3(schema, customers=False)[0]
        for label, r, grouped in (("HIVE q3 grouped", runner, HIVE_BUCKETS),
                                  ("HIVE q3 ungrouped", runner_of(grouped_execution=False),
                                   None)):
            rec = step(label, HIVE_GROUPED_SQL, r=r)
            expect(label, want, grouped)
            line(label, f"; scan {_fmt_scan(rec['res'].stats.get('scan_pipeline'))}")
        capture = KernelCapture()
        rec = step("HIVE q3 grouped unfused", HIVE_GROUPED_SQL, r=runner_of(**UNFUSED),
                   capture=capture)
        expect("HIVE q3 grouped unfused", want, HIVE_BUCKETS)
        if on_card and (rec["launches"]["insert"] <= 0 or capture.grouping is None):
            raise AssertionError(f"WAREHOUSE q3 grouped unfused: no insert launch, the "
                                 f"kernels' path was not taken: {rec['launches']}")
        if capture.grouping is not None:
            rec["insert"] = check_insert_at(device, "phase 19 grouped first-bucket page",
                                            *capture.grouping)
        line("HIVE q3 grouped unfused")
        g_rec, u_rec = out["HIVE q3 grouped"], out["HIVE q3 ungrouped"]
        log(f"WAREHOUSE grouped against ungrouped {schema}: warm wall ratio "
            f"{g_rec['warm_s'] / u_rec['warm_s']:.3f}, allocated peak ratio "
            f"{g_rec['allocated'] / max(u_rec['allocated'], 1):.3f}, accounted peak ratio "
            f"{g_rec['accounted'] / max(u_rec['accounted'], 1):.3f}")
        for label, rec in (("grouped", g_rec), ("ungrouped", u_rec)):
            log(f"WAREHOUSE q3 {label} {schema}: accounted peak per operator "
                f"{dict(sorted(rec['ops'].peaks.items()))}; at the query's peak "
                f"({rec['ops'].total} bytes) {dict(sorted(rec['ops'].at_peak.items()))}")
        # a bucket's run holds no operator's state above the whole table's
        # (tests/test_torch_grouped_execution.py holds the same at tiny)
        over = {tag: (b, u_rec["ops"].peaks.get(tag, 0))
                for tag, b in g_rec["ops"].peaks.items() if b > u_rec["ops"].peaks.get(tag, 0)}
        if over:
            raise AssertionError(f"WAREHOUSE q3 grouped: operators whose accounted peak is "
                                 f"above the ungrouped run's (grouped, ungrouped): {over}")

        # 3. hive CTAS partitioned by l_shipmode, then by l_linenumber; a sum
        # over one partition of each. A string constant gives no domain, in
        # the reference too, so the l_shipmode sum keeps every partition; the
        # l_linenumber sum must keep exactly its partition's files.
        clock = RoutingClock()
        rec = step("HIVE ctas partitioned", "create table hive.default.shipmodes with "
                   "(partitioned_by = array['l_shipmode']) as select "
                   f"{HIVE_PART_COLUMNS} from tpch.{schema}.lineitem",
                   setup=lambda: runner.execute("drop table hive.default.shipmodes"),
                   clock=clock)
        expect("HIVE ctas partitioned", [[n_li]])
        files = {"shipmodes": _hive_files(hive_conn.store.base, "shipmodes")}
        parts = sorted({d for d, _b in files["shipmodes"]})
        if len(parts) != 7:
            raise AssertionError(f"WAREHOUSE ctas partitioned: partitions {parts}")
        line("HIVE ctas partitioned", f"; {len(parts)} partitions, "
             f"{sum(len(v) for v in files['shipmodes'].values())} files; the sinks' "
             f"append_page {clock.append_s:.4f}s summed over the writers "
             f"({clock.append_s / rec['warm_s']:.3f} of the warm wall), of which the partition "
             f"grouping {clock.groups_s:.4f}s ({clock.groups_s / rec['warm_s']:.3f})")
        _res, ctas_s = timed_run(runner, "create table hive.default.linenumbers with "
                                 "(partitioned_by = array['l_linenumber']) as select l_orderkey, "
                                 "l_extendedprice, l_discount, l_shipdate, l_linenumber from "
                                 f"tpch.{schema}.lineitem")
        files["linenumbers"] = _hive_files(hive_conn.store.base, "linenumbers")
        for table, (col, value) in HIVE_PARTITIONED.items():
            label = f"HIVE partition sum {col}"
            rec = step(label, HIVE_PARTITION_SQL.format(table, col, value),
                       splits=("hive", table))
            expect(label, oracle_partition_sum(schema, table))
            part = f"{col}={value.strip(chr(39))}"
            mine = len(files[table][(part, None)])
            every = sum(len(v) for v in files[table].values())
            kept_dirs = {s.payload[1] for s in rec["kept"]}
            if col == "l_shipmode":  # no domain: every file is kept
                ok, what = rec["splits"] == (every, every), "every partition's"
            else:
                ok, what = rec["splits"] == (mine, every) and kept_dirs == {part}, \
                    f"exactly the {part} partition's"
            if not ok:
                raise AssertionError(f"WAREHOUSE {label}: kept {kept_dirs}, {rec['splits']}")
            line(label, f"; kept {what} files" + (
                f"; the table's CTAS {ctas_s:.4f}s" if col == "l_linenumber" else ""))

        # 4. the mixed Q3: the bucketed hive lineitem probes tpch's tables
        mixed = QUERIES[3].replace("from customer, orders, lineitem",
                                   f"from tpch.{schema}.customer, tpch.{schema}.orders, "
                                   f"hive.default.lineitem")
        capture = KernelCapture()
        with capture:
            timed_run(runner, mixed)
        rec = step("HIVE q3 mixed", mixed, splits=("hive", "lineitem"))
        expect("HIVE q3 mixed", oracle_q3(schema)[0])
        if rec["delta"]["pallas.join_builds"] != 2 or (on_card and (
                rec["launches"]["probe"] <= 0 or
                rec["launches"]["insert"] != 2 + rec["delta"]["pallas.agg_pages"])):
            raise AssertionError(f"WAREHOUSE q3 mixed: the kernels' path was not taken: "
                                 f"{rec['launches']}, {rec['delta']}")
        if not capture.by_table:
            raise AssertionError("WAREHOUSE q3 mixed: no probe of a hive page was captured")
        args = max(capture.by_table.values(), key=lambda a: a[1].shape[0])
        rec["probe"] = check_probe_at(device, "phase 19 mixed Q3 (a hive page)", *args)
        st = rec["res"].stats.get("scan_pipeline") or {}
        line("HIVE q3 mixed", f"; the hive lineitem gave {st.get('pages')} pages of "
             f"{st.get('rows')} rows ({(st.get('rows') or 0) / max(st.get('pages') or 1, 1):.0f} "
             f"rows per page), coalesced after the exchange (drivers per pipeline "
             f"{rec['res'].drivers}): probes {rec['launches']['probe']}")

        # 5. Parquet and ORC hive tables at HIVE_FORMAT_SCHEMA
        fr = runner_of(HIVE_FORMAT_SCHEMA)
        for fmt in ("parquet", "orc"):
            label = f"HIVE {fmt} ctas"
            step(label, f"create table hive.default.li_{fmt} with (bucketed_by = "
                 f"array['l_orderkey'], bucket_count = {HIVE_BUCKETS}, format = '{fmt}') as "
                 f"select {HIVE_LI_COLUMNS} from tpch.{HIVE_FORMAT_SCHEMA}.lineitem", r=fr,
                 setup=lambda fmt=fmt: fr.execute(f"drop table hive.default.li_{fmt}"))
            expect(label, [[n_lineitem(HIVE_FORMAT_SCHEMA)]])
            line(label, f"; {sum(len(v) for v in _hive_files(hive_conn.store.base, f'li_{fmt}').values())} "
                 f"files", HIVE_FORMAT_SCHEMA)
            label = f"HIVE {fmt} q1"
            step(label, QUERIES[1].replace("from lineitem", f"from hive.default.li_{fmt}"), r=fr)
            expect(label, oracle_q1(HIVE_FORMAT_SCHEMA)[0])
            line(label, "", HIVE_FORMAT_SCHEMA)

        # 6. raptor: a CTAS and Q6; one shard a year, pruned, then compacted
        shards = raptor_conn.shard_manager

        def shards_of(table):
            return shards.shards(shards.table_id(SchemaTableName("default", table)))
        step("RAPTOR ctas lineitem", f"create table raptor.default.lineitem as select "
             f"{HIVE_LI_COLUMNS} from tpch.{schema}.lineitem",
             setup=lambda: runner.execute("drop table raptor.default.lineitem"))
        expect("RAPTOR ctas lineitem", [[n_li]])
        line("RAPTOR ctas lineitem", f"; {len(shards_of('lineitem'))} shards of "
             f"{sorted(n for _u, n in shards_of('lineitem'))} rows")
        q6_want = oracle_q6(schema)[0]
        step("RAPTOR q6", QUERIES[6].replace("from lineitem", "from raptor.default.lineitem"),
             splits=("raptor", "lineitem"))
        expect("RAPTOR q6", q6_want)
        line("RAPTOR q6")
        runner.execute(f"create table raptor.default.years as select {FILE_Q6_COLUMNS} "
                       f"from tpch.{schema}.lineitem where l_orderkey < 0")
        by_year, t0 = {}, time.perf_counter()
        for y in FILE_YEARS:
            have = set(shards_of("years"))
            runner.execute(f"insert into raptor.default.years select {FILE_Q6_COLUMNS} from "
                           f"tpch.{schema}.lineitem where l_shipdate >= date '{y}-01-01' and "
                           f"l_shipdate < date '{y + 1}-01-01'")
            by_year[y] = sorted(set(shards_of("years")) - have)
        inserts_s = time.perf_counter() - t0
        # the empty CTAS wrote an empty shard, as the reference's sink does
        small = sorted(n for _u, n in shards_of("years"))
        if len(small) != len(FILE_YEARS) + 1 or small[0] != 0 or small[-1] >= RAPTOR_THRESHOLD:
            raise AssertionError(f"RAPTOR years: shards of {small} rows")
        years_q6 = QUERIES[6].replace("from lineitem", "from raptor.default.years")
        rec = step("RAPTOR years q6", years_q6, splits=("raptor", "years"))
        expect("RAPTOR years q6", q6_want)
        if sorted(s.payload[2] for s in rec["kept"]) != [u for u, _n in by_year[1994]]:
            raise AssertionError(f"RAPTOR years q6: kept {rec['kept']}, the 1994 insert "
                                 f"wrote {by_year[1994]}")
        line("RAPTOR years q6", f"; seven yearly INSERTs in {inserts_s:.4f}s, one shard each; "
             f"shards of {small} rows (the first the empty CTAS's); kept exactly the 1994 "
             f"shard (pruned in the metadata database)")
        t0 = time.perf_counter()
        removed = raptor_conn.maintenance()
        maint_s = time.perf_counter() - t0
        after = shards_of("years")
        if removed != len(small) or len(after) != 1 or after[0][1] != sum(small):
            raise AssertionError(f"RAPTOR maintenance: removed {removed}, after {after}")
        step("RAPTOR years q6 compacted", years_q6, splits=("raptor", "years"))
        expect("RAPTOR years q6 compacted", q6_want)
        line("RAPTOR years q6 compacted", f"; maintenance() {maint_s:.4f}s compacted "
             f"{len(small)} shards into {len(after)} of {after[0][1]} rows")
    finally:
        raptor_conn.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    for rec in out.values():
        rec.pop("res", None)
        rec.pop("kept", None)
    return out


FED_ORDERS = ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority", "o_orderpriority",
              "o_totalprice")
FED_CUSTOMER = ("c_custkey", "c_mktsegment", "c_nationkey", "c_acctbal")
FED_TYPES = {"o_orderkey": "bigint", "o_custkey": "bigint", "o_orderdate": "date",
             "o_shippriority": "integer", "o_orderpriority": "varchar",
             "o_totalprice": "decimal(12,2)", "c_custkey": "bigint", "c_mktsegment": "varchar",
             "c_nationkey": "bigint", "c_acctbal": "decimal(12,2)", "n_nationkey": "bigint",
             "n_name": "varchar", "n_regionkey": "bigint"}
KAFKA_PARTITIONS = 8  # tpch's split ranges of orders, one log each
# the topic's scale: the decode of SF1's 1.5 M messages (~20 s) lives in
# ``federation_walls.py --steps kafka``
KAFKA_SCHEMA = "tiny"
FED_DAYS_SQL = ("select o_orderdate, count(*), sum(o_totalprice) from {} "
                "group by o_orderdate order by o_orderdate")
FED_STREAM_SQL = ("select c_mktsegment, count(*), sum(o_totalprice) from {} join "
                  "tpch.{}.customer on o_custkey = c_custkey group by c_mktsegment "
                  "order by c_mktsegment")
# host-bound steps run once, still at SF1, their one wall logged as cold
# and warm (``federation_walls.py --steps ctas,q3,perday`` times them in
# rounds): 25.1 s of the phase in two runs each
FED_ONE_RUN = ("FED dbapi ctas orders", "FED dbapi q3", "FED dbapi per-day",
               "FED acl analyst q3", "FED acl cte shadow")
REMOTE_ROWS_PER_BATCH = 4096
REMOTE_SPLITS = 3


class SourceLog:
    """Records the page sources a catalog creates while on (the dbapi
    sources count the rows they fetch)."""

    def __init__(self, connector):
        self.provider = connector.page_source_provider()
        self.sources = []

    def __enter__(self):
        real = self.provider.create_page_source
        log_ = self

        def create(split, columns, *a, **kw):
            src = real(split, columns, *a, **kw)
            log_.sources.append(src)
            return src

        self.provider.create_page_source = create
        return self

    def __exit__(self, *exc):
        del self.provider.create_page_source  # the class's method again
        return False

    def fetched(self, table: str) -> int:
        return sum(s.rows_fetched for s in self.sources
                   if s.split.payload[0].table == table)


def _write_topic(log_dir: str, sf: float):
    """The ``orders`` topic: the table description and one JSON log per tpch
    split range of ``orders`` (``KAFKA_PARTITIONS`` of them), each with one
    poison line in its middle. Returns (messages written, bytes)."""
    from presto_tpu_torch.connectors.tpch import generator as g

    desc = {"topic": "orders", "message": {"dataFormat": "json", "fields": [
        {"name": c, "type": FED_TYPES[c], "mapping": c} for c in FED_ORDERS]}}
    with open(os.path.join(log_dir, "default.orders.json"), "w") as f:
        json.dump(desc, f)
    n = g.table_row_count("orders", sf)
    step = -(-n // KAFKA_PARTITIONS)
    written = nbytes = 0
    for p in range(KAFKA_PARTITIONS):
        lo, hi = p * step, min((p + 1) * step, n)
        o = g.generate_rows("orders", lo, hi, sf, list(FED_ORDERS))
        prio = g.DICT_PRIORITY.values[o["o_orderpriority"]].tolist()
        lines = [f'{{"o_orderkey": {k}, "o_custkey": {c}, "o_orderdate": "{d}", '
                 f'"o_shippriority": {s}, "o_orderpriority": "{r}", '
                 f'"o_totalprice": {t // 100}.{t % 100:02d}}}'
                 for k, c, d, s, r, t in zip(
                     o["o_orderkey"].tolist(), o["o_custkey"].tolist(),
                     o["o_orderdate"].astype("datetime64[D]").astype(str).tolist(),
                     o["o_shippriority"].tolist(), prio,
                     o["o_totalprice"].astype(np.int64).tolist())]
        lines.insert(len(lines) // 2, "{poison")
        body = ("\n".join(lines) + "\n").encode()
        with open(os.path.join(log_dir, f"orders-{p}.log"), "wb") as f:
            f.write(body)
        written += len(lines)
        nbytes += len(body)
    return written, nbytes


def _remote_service(sf: float):
    """A started ``RemoteTestingService`` serving ``sales.customer`` (the
    four ``FED_CUSTOMER`` columns; decimals as unscaled ints) and
    ``sales.nation`` from the port's generator; -> (service, endpoint)."""
    from presto_tpu_torch.connectors.remote import RemoteTestingService
    from presto_tpu_torch.connectors.tpch import generator as g

    svc = RemoteTestingService(rows_per_batch=REMOTE_ROWS_PER_BATCH, n_splits=REMOTE_SPLITS)
    c = _table("customer", sf, list(FED_CUSTOMER))
    data = {k: c[k].astype(np.int64).tolist() for k in FED_CUSTOMER if k != "c_mktsegment"}
    data["c_mktsegment"] = g.DICT_SEGMENT.values[c["c_mktsegment"]].tolist()
    svc.add_table("sales", "customer", [(k, FED_TYPES[k]) for k in FED_CUSTOMER], data)
    nat = _table("nation", sf, ["n_nationkey", "n_name", "n_regionkey"])
    svc.add_table("sales", "nation", [(k, FED_TYPES[k]) for k in nat],
                  {"n_nationkey": nat["n_nationkey"].astype(np.int64).tolist(),
                   "n_name": g.DICT_NATION_NAME.values[nat["n_name"]].tolist(),
                   "n_regionkey": nat["n_regionkey"].astype(np.int64).tolist()})
    return svc, svc.start()


def _closed_endpoint():
    """-> (an endpoint on 127.0.0.1 that refuses connections, its socket):
    the port is bound and never listened on, so no other process can take
    it while the caller holds the socket open."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    return f"http://127.0.0.1:{sock.getsockname()[1]}", sock


def run_federation_phase(device, q3_rows=None, schema: str = "sf1") -> dict:
    """Phase 20: the federated catalogs at TPC-H ``schema`` with
    ``hash_kernels="pallas"`` under the defaults, in one runner with an
    ``ext`` (sqlite), a ``kafka`` and an ``svc`` (remote service) catalog
    beside ``tpch``; the external systems hold ``tpch``'s own rows, so every
    federated query has its answer in a ``tpch`` query.

    - dbapi: CTAS of ``orders`` (``FED_ORDERS``) and ``customer``
      (``FED_CUSTOMER``) into the sqlite file (walls, rows/s, bytes); Q3
      over ``ext``'s ``customer`` and ``orders`` and ``tpch``'s
      ``lineitem`` (rows equal to ``q3_rows``, phase 11's Q3, and to the
      numpy Q3; the rows sqlite returned after the pushed-down
      ``o_orderdate``); the per-day grouping over ``ext.main.orders`` (rows
      equal to the same over ``tpch``).
    - kafka: the ``orders`` topic at ``KAFKA_SCHEMA`` (``tiny`` when the
      phase runs at SF1) as ``KAFKA_PARTITIONS`` JSON logs (tpch's split
      ranges, one poison line each); the stream join with ``tpch``'s
      ``customer`` at the same scale (rows equal to the same over ``tpch``, the
      poison rows' NULL keys joining nothing), the decode's seconds, the
      messages per ``_partition_id`` and the NULL keys. The insert is held
      bit-identical at the ``customer`` build, the probe at the first
      topic page.
    - remote: ``RemoteTestingService(REMOTE_ROWS_PER_BATCH,
      REMOTE_SPLITS)`` on 127.0.0.1 serving ``sales.customer`` and
      ``sales.nation``, behind a catalog whose first endpoint is closed
      (the first call fails over); Q3 with ``svc``'s ``customer`` (rows
      equal to phase 11's), the requests it took by method.
    - access control: a runner whose session resolves one-part names in
      ``memory`` and a ``FileBasedAccessControl`` (``analyst`` may select
      from ``tpch`` and ``ext``; ``etl`` may write ``memory`` too): the
      analyst's Q3 over ``ext`` (step 1's rows), a denied CTAS into
      ``ext`` (``AccessDeniedException``, no launch, no table), a CTE
      named ``orders`` shadowing the denied ``memory.default.orders``
      (allowed; the bare name alone is denied), the etl's CTAS into
      ``memory``.

    Each query runs cold and warm (launch counters set to 0 just before the
    warm run) and prints a ``FEDERATION`` line. Returns the records whose
    launches the kernels line reports, keyed ``FED ...``."""
    import contextlib
    import shutil
    import tempfile

    import torch

    from presto_tpu_torch.connectors.dbapi import sqlite_connector
    from presto_tpu_torch.connectors.kafka import KafkaConnector
    from presto_tpu_torch.connectors.remote import RemoteConnector
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.security import (AccessDeniedException, AccessRule,
                                           FileBasedAccessControl)
    from presto_tpu_torch.spi.connector import SchemaTableName
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sf = SCHEMAS[schema]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-federation-")
    out = {}
    svc = dead_sock = None
    n_orders = g.table_row_count("orders", sf)
    n_customers = g.table_row_count("customer", sf)
    q3_want = oracle_q3(schema)[0]
    if q3_rows is not None and not same_rows(q3_rows, q3_want):
        raise AssertionError("FEDERATION: phase 11's Q3 rows differ from the numpy Q3")

    def timed_run(r, sql, user=None):
        t0 = time.perf_counter()
        res = r.execute(sql, user=user)
        sync()
        return res, time.perf_counter() - t0

    def step(label, sql, r, setup=None, capture=None, user=None, log_sources=None):
        """A cold run, then ``setup`` and the warm run, the launch counters
        set to 0 just before it, ``capture`` and the page-source log on; a
        step of ``FED_ONE_RUN`` runs once, counted as both."""
        once = label in FED_ONE_RUN
        if not once:
            _res, cold_s = timed_run(r, sql, user)
            if setup is not None:
                setup()
        before = {k: METRICS.counter_value(k) for k in COUNTERS}
        requests = (svc.request_count, dict(svc.calls)) if svc is not None else None
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        slog = SourceLog(log_sources) if log_sources is not None else None
        with capture or contextlib.nullcontext(), slog or contextlib.nullcontext():
            res, warm_s = timed_run(r, sql, user)
        if once:
            cold_s = warm_s
        delta = {k: METRICS.counter_value(k) - v for k, v in before.items()}
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"FEDERATION {label}: a fallback: {delta}")
        rec = out[label] = {
            "rows": res.rows, "cold_s": cold_s, "warm_s": warm_s, "delta": delta,
            "launches": {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches},
            "sources": slog}
        if requests is not None:
            rec["requests"] = svc.request_count - requests[0]
            rec["calls"] = {k: v - requests[1].get(k, 0) for k, v in svc.calls.items()
                            if v != requests[1].get(k, 0)}
        return rec

    def line(label, extra=""):
        rec = out[label]
        log(f"FEDERATION {label} {schema}: cold wall {rec['cold_s']:.4f}s, warm wall "
            f"{rec['warm_s']:.4f}s; launches {rec['launches']}; join builds "
            f"{int(rec['delta']['pallas.join_builds'])}, grouped pages "
            f"{int(rec['delta']['pallas.agg_pages'])}{extra}")

    def expect(label, rows):
        if not same_rows(out[label]["rows"], rows):
            raise AssertionError(f"FEDERATION {label}: rows differ:\n{out[label]['rows'][:3]}\n"
                                 f"want {rows[:3]}")

    ext_path = os.path.join(tmp, "ext.db")
    ext = sqlite_connector("ext", ext_path)
    log_dir = os.path.join(tmp, "logs")
    os.makedirs(log_dir)
    kafka = KafkaConnector("kafka", log_dir)
    runner = sql_runner(device, "pallas", schema)
    runner.catalogs.register("ext", ext)
    runner.catalogs.register("kafka", kafka)
    try:
        # 1. dbapi: CTAS into sqlite, Q3 and the per-day grouping over it
        for table, cols, n_want in (("orders", FED_ORDERS, n_orders),
                                    ("customer", FED_CUSTOMER, n_customers)):
            label = f"FED dbapi ctas {table}"
            step(label, f"create table ext.main.{table} as select {', '.join(cols)} "
                 f"from tpch.{schema}.{table}", runner,
                 setup=lambda t=table: runner.execute(f"drop table ext.main.{t}"))
            expect(label, [[n_want]])
            line(label, f"; {n_want} rows ({n_want / out[label]['warm_s']:.0f} rows/s warm); "
                 f"the sqlite file {os.path.getsize(ext_path)} bytes")
        q3_ext = QUERIES[3].replace("from customer, orders, lineitem",
                                    f"from ext.main.customer, ext.main.orders, "
                                    f"tpch.{schema}.lineitem")
        rec = step("FED dbapi q3", q3_ext, runner, log_sources=ext)
        expect("FED dbapi q3", q3_want)
        fetched = {t: rec["sources"].fetched(t) for t in ("orders", "customer")}
        want_fetched = int((g.generate_rows("orders", 0, n_orders, sf, ["o_orderdate"])[
            "o_orderdate"] < civil_day(1995, 3, 15)).sum())
        if fetched["orders"] != want_fetched or fetched["customer"] != n_customers:
            raise AssertionError(f"FEDERATION dbapi q3: fetched {fetched}, want orders "
                                 f"{want_fetched} (the pushed-down o_orderdate) and customer "
                                 f"{n_customers}")
        rec["fetched"] = fetched
        line("FED dbapi q3", f"; rows sqlite returned: orders {fetched['orders']} of "
             f"{n_orders} (o_orderdate < 1995-03-15 pushed down), customer "
             f"{fetched['customer']} of {n_customers} (a varchar domain stays in the engine)")
        want_days = runner.execute(FED_DAYS_SQL.format(f"tpch.{schema}.orders")).rows
        step("FED dbapi per-day", FED_DAYS_SQL.format("ext.main.orders"), runner)
        expect("FED dbapi per-day", want_days)
        line("FED dbapi per-day", f"; {len(want_days)} groups")

        # 2. kafka: the orders topic at KAFKA_SCHEMA, decoded, joined with
        # tpch's customer at the same scale
        kschema = KAFKA_SCHEMA if schema == "sf1" else schema
        t0 = time.perf_counter()
        n_msgs, n_bytes = _write_topic(log_dir, SCHEMAS[kschema])
        write_s = time.perf_counter() - t0
        k_orders = g.table_row_count("orders", SCHEMAS[kschema])
        step_rows = -(-k_orders // KAFKA_PARTITIONS)
        topic_key = SchemaTableName("default", "orders")
        meta = kafka.metadata()
        decode_s = []
        real_topic_data = meta.topic_data

        def timed_topic_data(name):
            t = time.perf_counter()
            try:
                return real_topic_data(name)
            finally:
                decode_s.append(time.perf_counter() - t)
        meta.topic_data = timed_topic_data
        stream_sql = FED_STREAM_SQL.format("kafka.default.orders", kschema)
        want_stream = runner.execute(FED_STREAM_SQL.format(f"tpch.{kschema}.orders",
                                                           kschema)).rows
        capture = KernelCapture()
        try:
            rec = step("FED kafka stream join", stream_sql, runner, capture=capture)
        finally:
            del meta.topic_data
        expect("FED kafka stream join", want_stream)
        rec["decode_s"] = max(decode_s)
        if on_card and (capture.build is None or capture.probe_args is None):
            raise AssertionError(f"FEDERATION kafka stream join: the kernels' path was not "
                                 f"taken: {rec['launches']}, {rec['delta']}")
        if capture.build is not None:
            rec["insert"] = check_insert_at(device, "phase 20 customer build", *capture.build)
        if capture.probe_args is not None:
            rec["probe"] = check_probe_at(device, "phase 20 first topic page",
                                          *capture.probe_args)
        parts = runner.execute("select _partition_id, count(*), count(o_orderkey) from "
                               "kafka.default.orders group by _partition_id order by 1").rows
        nulls = runner.execute("select count(*) from kafka.default.orders "
                               "where o_orderkey is null").rows
        want_parts = [[p, min(step_rows, k_orders - p * step_rows) + 1,
                       min(step_rows, k_orders - p * step_rows)]
                      for p in range(KAFKA_PARTITIONS)]
        if parts != want_parts or nulls != [[KAFKA_PARTITIONS]]:
            raise AssertionError(f"FEDERATION kafka: per partition {parts}, NULL keys {nulls}")
        line("FED kafka stream join", f"; the topic at {kschema}: {n_msgs} messages "
             f"({n_bytes} bytes in "
             f"{KAFKA_PARTITIONS} logs, written in {write_s:.4f}s); the cold run's decode "
             f"{rec['decode_s']:.4f}s ({n_msgs / rec['decode_s']:.0f} messages/s); per partition "
             f"{[r[1] for r in parts]} messages, {nulls[0][0]} NULL keys (the poison lines)")

        # 3. remote: customer from the service, orders and lineitem from tpch
        svc, endpoint = _remote_service(sf)
        dead, dead_sock = _closed_endpoint()
        runner.catalogs.register("svc", RemoteConnector("svc", [dead, endpoint], timeout_s=60.0))
        q3_svc = QUERIES[3].replace("from customer, orders, lineitem",
                                    f"from svc.sales.customer, tpch.{schema}.orders, "
                                    f"tpch.{schema}.lineitem")
        rec = step("FED remote q3", q3_svc, runner)
        expect("FED remote q3", q3_want)
        line("FED remote q3", f"; {rec['requests']} requests on the warm run {rec['calls']} "
             f"(rows_per_batch {REMOTE_ROWS_PER_BATCH}, {REMOTE_SPLITS} splits; the first call "
             f"failed over past {dead}); {svc.request_count} requests in all")

        # 4. access control
        acl = LocalQueryRunner(Session(catalog="memory", schema="default",
                                       properties={"hash_kernels": "pallas"}), device=device)
        acl.catalogs.register("ext", ext)
        acl.access_control = FileBasedAccessControl([
            AccessRule(user_regex="analyst|etl", catalog_regex="tpch|ext",
                       privileges=("select",)),
            AccessRule(user_regex="etl", catalog_regex="memory")])
        step("FED acl analyst q3", q3_ext, acl, user="analyst")
        expect("FED acl analyst q3", out["FED dbapi q3"]["rows"])
        line("FED acl analyst q3", "; allowed")
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        denied = []
        for sql in (f"create table ext.main.x as select o_orderkey from tpch.{schema}.orders",
                    "select count(*) from orders"):
            try:
                acl.execute(sql, user="analyst")
            except AccessDeniedException as e:
                denied.append(str(e))
        launched = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        tables = [t.table for t in ext.metadata().list_tables("main")]
        if len(denied) != 2 or launched != {"insert": 0, "probe": 0} or "x" in tables:
            raise AssertionError(f"FEDERATION acl: denied {denied}, launches {launched}, "
                                 f"ext tables {tables}")
        out["FED acl denied ctas"] = {"launches": launched}
        log(f"FEDERATION acl denied {schema}: {denied}; launches {launched}; ext tables "
            f"{tables}")
        shadow = ("with orders as (select o_orderkey, o_totalprice from ext.main.orders) "
                  "select count(*), sum(o_totalprice) from orders")
        step("FED acl cte shadow", shadow, acl, user="analyst")
        expect("FED acl cte shadow", runner.execute(
            f"select count(*), sum(o_totalprice) from tpch.{schema}.orders").rows)
        line("FED acl cte shadow", "; allowed: the CTE named orders is not "
             "memory.default.orders")
        res, _s = timed_run(acl, f"create table memory.default.nations as select n_nationkey "
                            f"from tpch.{schema}.nation", user="etl")
        if res.rows != [[25]]:
            raise AssertionError(f"FEDERATION acl etl ctas: {res.rows}")
        log(f"FEDERATION acl etl {schema}: CTAS into memory allowed, {res.rows[0][0]} rows")
    finally:
        if svc is not None:
            svc.stop()
        if dead_sock is not None:
            dead_sock.close()
        shutil.rmtree(tmp, ignore_errors=True)
    for rec in out.values():
        rec.pop("sources", None)
    return out


# phase 21: the mesh of logical workers on the one card, and the queries'
# schemas. Q5 runs at Q5_SCHEMA, as in phases 8-11: at SF1 its
# customer-supplier join expands to ~6.9e9 rows, which the distributed plan
# repartitions on (l_orderkey, c_custkey) before the orders join
DIST_WORKERS = 4
DIST_QUERIES = (1, 3, 5, 9)
# Q9 at SF1 (cold 11.7 s, warm 9.9 s) is ``dist_walls.py --query 9``
DIST_SCHEMA = {5: Q5_SCHEMA, 9: "tiny"}


def run_distributed_phase(device, records: dict, card: str = "", schema: str = "sf1") -> dict:
    """SQL Q1, Q3, Q5 and Q9 through ``DistributedQueryRunner`` on
    ``DIST_WORKERS`` logical workers of ``device`` under the session
    defaults with ``hash_kernels="pallas"``: a cold run (resident cache
    cleared first), then a warm run with the launch counters and
    ``COUNTERS`` set to 0 just before it and read just after. Fails unless
    the rows equal phase 11's (``records``) at the same schema, no exchange
    took a page from host memory, the insert launched once per worker's
    join build and grouped page, a worker that built a table probed it
    with the kernel, and nothing fell back; then Q3 under the barrier
    exchange must give equal rows. Returns the records, keyed ``DIST Q3``."""
    import torch

    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.parallel.mesh import MeshContext
    from presto_tpu_torch.parallel.runner import EXCHANGE_STATS, DistributedQueryRunner
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh = MeshContext([device] * DIST_WORKERS)

    def runner(s, **props):
        return DistributedQueryRunner(
            mesh, Session(catalog="tpch", schema=s,
                          properties={"hash_kernels": "pallas", **props}), device=device)

    def timed(r, sql):
        t0 = time.perf_counter()
        res = r.execute(sql)
        sync()
        return res, time.perf_counter() - t0

    out = {}
    uploads0 = EXCHANGE_STATS["host_uploads"]
    for q in DIST_QUERIES:
        qschema = DIST_SCHEMA.get(q, schema)
        want = records[q]
        if want.get("schema", schema) != qschema:
            # phase 11 ran it at another scale: the single-node run and the
            # numpy oracle at this one
            want = {"rows": sql_runner(device, "pallas", qschema).execute(QUERIES[q]).rows}
            oracle = (JOIN_ORACLES.get(q) or SQL_ORACLES.get(q))(qschema)[0]
            if not same_rows(want["rows"], oracle):
                raise AssertionError(f"DIST Q{q} {qschema}: the single-node rows differ from "
                                     f"the numpy oracle's")
        r = runner(qschema)
        RESIDENT_CACHE.clear()
        cold, cold_s = timed(r, QUERIES[q])
        before = {k: METRICS.counter_value(k) for k in COUNTERS}
        uploads = EXCHANGE_STATS["host_uploads"]
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        res, warm_s = timed(r, QUERIES[q])
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
        uploads = EXCHANGE_STATS["host_uploads"] - uploads
        for label, rows in (("cold", cold.rows), ("warm", res.rows)):
            if not same_rows(rows, want["rows"]):
                raise AssertionError(f"DIST Q{q} {qschema}: the {label} run's rows differ from "
                                     f"phase 11's:\n{rows}\n{want['rows']}")
        builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
        if uploads:
            raise AssertionError(f"DIST Q{q}: {uploads} pages reached an exchange from host "
                                 "memory")
        if on_card and launches["insert"] != builds + pages:
            raise AssertionError(f"DIST Q{q}: insert launches {launches['insert']} != join "
                                 f"builds {builds} + grouped pages {pages}")
        if on_card and builds and not launches["probe"]:
            raise AssertionError(f"DIST Q{q}: {builds} tables built, none probed by the kernel")
        if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
            raise AssertionError(f"DIST Q{q}: a fallback: {delta}")
        ex = res.stats["exchange"]
        out[f"DIST Q{q}"] = {"rows": res.rows, "launches": launches, "cold_s": cold_s,
                             "warm_s": warm_s, "exchange": ex}
        log(f"DIST Q{q} {qschema} on {DIST_WORKERS} workers ({card}): {len(res.rows)} rows "
            f"equal to the single-node run's; cold wall {cold_s:.4f}s, warm wall {warm_s:.4f}s; "
            f"{ex['exchanges']} exchanges, {ex.get('chunks', 0)} chunks, "
            f"{ex.get('pages', 0)} pages, {ex.get('rows', 0)} rows delivered, carry "
            f"{ex.get('carry_rows', 0)}; host_uploads {uploads}; warm launches {launches}; "
            f"join builds {int(builds)}, grouped pages {int(pages)}")
        for e in ex.get("per_exchange", []):
            role = f" {e['skew_role']}" if "skew_role" in e else ""
            log(f"  exchange f{e['fragment']} {e['kind']}{role}: chunks {e['chunks']}, rows "
                f"{e['rows_out']}, partition_rows {e['partition_rows']}, hot keys "
                f"{e['hot_keys']}, replicated {e['replicated_rows']}, dispatch "
                f"{e['dispatch_s']}s, stall {e['stall_s']}s")
    barrier, barrier_s = timed(runner(DIST_SCHEMA.get(3, schema), streaming_exchange=False),
                               QUERIES[3])
    if not same_rows(barrier.rows, out["DIST Q3"]["rows"]):
        raise AssertionError(f"DIST Q3: barrier rows differ from streaming:\n{barrier.rows}\n"
                             f"{out['DIST Q3']['rows']}")
    if EXCHANGE_STATS["host_uploads"] != uploads0:
        raise AssertionError(f"DIST: {EXCHANGE_STATS['host_uploads'] - uploads0} host uploads")
    launched = {k: r["launches"] for k, r in out.items()}
    if on_card and not (sum(v["insert"] for v in launched.values())
                        and sum(v["probe"] for v in launched.values())):
        raise AssertionError(f"DIST: a kernel never launched: {launched}")
    bex = barrier.stats["exchange"]
    log(f"DIST Q3 barrier exchange ({card}): rows equal to the streaming run's; wall "
        f"{barrier_s:.4f}s; {bex['exchanges']} exchanges; host_uploads "
        f"{EXCHANGE_STATS['host_uploads'] - uploads0} over the phase")
    for rec in out.values():
        rec.pop("rows")
    return out


# phase 22: the cluster on the one card. Q5 runs at Q5_SCHEMA, as in phase
# 21; Q9 at tiny: at SF1 it took 28.3-30.3 s a run on four HTTP workers,
# which put the phase past its 90 s (PERF.md section 6); the fault run
# at CLUSTER_FAULT_SCHEMA on two workers
CLUSTER_WORKERS = 4
CLUSTER_QUERIES = (1, 3, 9, 5)
CLUSTER_SCHEMA = {5: Q5_SCHEMA, 9: "tiny"}
# run once (the cold SF1 run was cut for the script's budget:
# ``cluster_walls.py --queries 3`` keeps it)
CLUSTER_ONE_RUN = (3,)
CLUSTER_MERGE_SQL = ("select o_orderkey, o_totalprice from orders where o_totalprice > "
                     "150000.0 order by o_totalprice desc, o_orderkey")
# the merge query's scale (SF1's runs: ``cluster_walls.py --queries merge``)
CLUSTER_MERGE_SCHEMA = "tiny"
CLUSTER_FAULT_SCHEMA = "tiny"
CLUSTER_FAULT_WORKERS = 2
CLUSTER_EXCHANGE = ("exchange.frames", "exchange.bytes", "exchange.rows")


class CardCluster:
    """A ClusterQueryRunner and ``n`` in-process WorkerServers on
    ``device``, the workers announced every ``announce_s`` seconds (the
    reference's test fixture) while ACTIVE or DRAINING: a DRAINED worker
    left discovery with its drain and is never announced again.
    ``close()`` stops every thread and server it started and waits for
    every task it ran, the retired workers' too."""

    def __init__(self, device, n: int, schema: str, announce_s: float = 1.0, **props):
        import threading

        from presto_tpu_torch.cluster import ClusterQueryRunner

        self.device = device
        self.runner = ClusterQueryRunner(
            self.session(schema, **props), min_workers=n, worker_wait_s=30.0, device=device)
        self.workers = []
        self.retired = []  # workers replaced by add_worker(replacing=...)
        self.stopped = set()
        for _ in range(n):
            self.add_worker()
        self.announce_s = announce_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._keep_alive, name="cluster-announce",
                                        daemon=True)
        self._thread.start()

    def add_worker(self, replacing=None):
        """Start a WorkerServer on the cluster's device and announce it; with
        ``replacing``, it takes that (stopped) worker's place in ``workers``."""
        from presto_tpu_torch.cluster import WorkerServer

        w = WorkerServer(port=0, device=self.device).start()
        if replacing is None:
            self.workers.append(w)
        else:
            self.workers[self.workers.index(replacing)] = w
            self.retired.append(replacing)
        self.runner.nodes.announce(w.node_id, w.uri)
        return w

    def _keep_alive(self):
        while not self._stop.wait(self.announce_s):
            for w in list(self.workers):
                if w.node_id not in self.stopped and w.state in ("ACTIVE", "DRAINING"):
                    self.runner.nodes.announce(w.node_id, w.uri)
            for node_id in list(self.stopped):
                self.runner.nodes.remove(node_id)

    def stop_worker(self, w) -> None:
        self.stopped.add(w.node_id)
        w.stop()
        self.runner.nodes.remove(w.node_id)

    def session(self, schema: str, **props):
        from presto_tpu_torch.metadata import Session

        return Session(catalog="tpch", schema=schema,
                       properties={"hash_kernels": "pallas", **props})

    def every_worker(self) -> list:
        """The workers, the retired ones too."""
        return self.workers + self.retired

    def join_tasks(self, timeout_s: float = 120.0) -> None:
        for w in self.every_worker():
            if not w.join_tasks(timeout_s):
                raise AssertionError(f"CLUSTER: a task of {w.node_id} did not end in "
                                     f"{timeout_s}s")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(10.0)
        self.runner.detector.stop()
        if self.runner.memory_manager is not None:
            self.runner.memory_manager.stop()
        for w in self.workers:
            if w.node_id not in self.stopped:
                w.stop()
        self.join_tasks()


class WorkerLaunches:
    """While on, counts each kernel's launches per worker: a launch is the
    worker's whose task runs the driver that makes it (the task executor's
    drivers are tagged with their task's thread, the caller's stack names
    its driver). ``workers`` is a function giving the workers at each
    launch (a cluster's workers change). The wrappers' own counters keep
    counting."""

    def __init__(self, workers):
        self.workers = workers
        self.counts = {}

    def __enter__(self):
        import threading

        from presto_tpu_torch.cluster import task as ctask
        from presto_tpu_torch.exec.driver import Driver
        from presto_tpu_torch.ops import pallas_hash as ph

        self.ph, self.ctask = ph, ctask
        self.insert, self.probe, self.executor = ph.insert_table, ph.probe_table, ctask.TaskExecutor
        owner = {}  # id(driver) -> task id

        class Tagged(self.executor):
            def execute(self, drivers, external=None):
                name = threading.current_thread().name
                for d in drivers:
                    owner[id(d)] = name[len("task-"):]
                return super().execute(drivers, external)

        def worker_of() -> str:
            f = sys._getframe(2)
            while f is not None:
                d = f.f_locals.get("self")
                if isinstance(d, Driver) and id(d) in owner:
                    tid = owner[id(d)]
                    for w in self.workers():
                        if tid in w.tasks.tasks:
                            return w.node_id
                    return "?"
                f = f.f_back
            return "coordinator"

        def counted(kernel, fn):
            def wrapper(*args, **kw):
                if kernel == "insert" or args[2].shape[0]:  # an empty probe launches nothing
                    key = (worker_of(), kernel)
                    self.counts[key] = self.counts.get(key, 0) + 1
                return fn(*args, **kw)
            wrapper.launches = fn.launches
            return wrapper

        ctask.TaskExecutor = Tagged
        ph.insert_table = counted("insert", self.insert)
        ph.probe_table = counted("probe", self.probe)
        return self

    def per_worker(self) -> dict:
        out = {}
        for (w, kernel), n in sorted(self.counts.items()):
            out.setdefault(w, {"insert": 0, "probe": 0})[kernel] = n
        return out

    def __exit__(self, *exc):
        self.insert.launches = self.ph.insert_table.launches
        self.probe.launches = self.ph.probe_table.launches
        self.ph.insert_table, self.ph.probe_table = self.insert, self.probe
        self.ctask.TaskExecutor = self.executor
        return False


def oracle_merge(schema: str):
    """``CLUSTER_MERGE_SQL`` in numpy over the port's generator."""
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS

    o = _table("orders", SCHEMAS[schema], ["o_orderkey", "o_totalprice"])
    key, price = o["o_orderkey"].astype(np.int64), o["o_totalprice"].astype(np.int64)
    keep = price > 150000_00
    order = np.lexsort((key[keep], -price[keep]))
    return [[int(k), Decimal(int(p)) / 100]
            for k, p in zip(key[keep][order], price[keep][order])]


def _tasks_per_fragment(cluster, sql: str) -> dict:
    from presto_tpu_torch.sql.planner.fragmenter import SINGLE_PART

    n = len(cluster.workers) - len(cluster.stopped)
    return {f.id: 1 if f.partitioning == SINGLE_PART else n
            for f in cluster.runner.plan_sql(sql).fragments}


def run_cluster_phase(device, records: dict, card: str = "", schema: str = "sf1") -> dict:
    """Phase 22 (see the module docstring); returns the records, keyed
    ``CLUSTER Q3``."""
    import torch

    from presto_tpu_torch.cluster import exchange_client, faults
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.utils.events import JOURNAL
    from presto_tpu_torch.utils.metrics import METRICS

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timed(r, sql):
        t0 = time.perf_counter()
        res = r.execute(sql)
        sync()
        return res, time.perf_counter() - t0

    def exchange_counts():
        return {k: METRICS.counter_value(k) for k in CLUSTER_EXCHANGE}

    out = {}
    cluster = CardCluster(device, CLUSTER_WORKERS, schema)
    try:
        r = cluster.runner
        for q in CLUSTER_QUERIES:
            qschema = CLUSTER_SCHEMA.get(q, schema)
            want = records[q]
            if want.get("schema", schema) != qschema:
                # phase 11 ran it at another scale: the single-node run and
                # the numpy oracle at this one
                want = {"rows": sql_runner(device, "pallas", qschema).execute(QUERIES[q]).rows}
                oracle = (JOIN_ORACLES.get(q) or SQL_ORACLES.get(q))(qschema)[0]
                if not same_rows(want["rows"], oracle):
                    raise AssertionError(f"CLUSTER Q{q} {qschema}: the single-node rows differ "
                                         f"from the numpy oracle's")
            r.local.session = cluster.session(qschema)
            RESIDENT_CACHE.clear()
            cold = cold_s = None
            if q not in CLUSTER_ONE_RUN:
                cold, cold_s = timed(r, QUERIES[q])
            before = {k: METRICS.counter_value(k) for k in COUNTERS}
            ex0 = exchange_counts()
            ph.insert_table.launches = 0
            ph.probe_table.launches = 0
            with WorkerLaunches(cluster.every_worker) as per, KernelCapture() as capture:
                res, warm_s = timed(r, QUERIES[q])
            launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
            delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
            ex = {k: int(v - ex0[k]) for k, v in exchange_counts().items()}
            for label, run_res in (("cold", cold), ("warm", res)):
                if run_res is not None and not same_rows(run_res.rows, want["rows"]):
                    raise AssertionError(f"CLUSTER Q{q} {qschema}: the {label} run's rows "
                                         f"differ from phase 11's:\n{run_res.rows}\n"
                                         f"{want['rows']}")
            builds, pages = delta["pallas.join_builds"], delta["pallas.agg_pages"]
            by_worker = per.per_worker()
            if on_card and launches["insert"] != builds + pages:
                raise AssertionError(f"CLUSTER Q{q}: insert launches {launches['insert']} != "
                                     f"join builds {builds} + grouped pages {pages}")
            if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
                raise AssertionError(f"CLUSTER Q{q}: a fallback: {delta}")
            if on_card and sum(v["insert"] for v in by_worker.values()) != launches["insert"]:
                raise AssertionError(f"CLUSTER Q{q}: per-worker inserts {by_worker} do not add "
                                     f"up to {launches}")
            if on_card and any(v["insert"] and not v["probe"] for v in by_worker.values()):
                raise AssertionError(f"CLUSTER Q{q}: a worker built a table and never probed "
                                     f"it: {by_worker}")
            rec = {"rows": res.rows, "launches": launches, "per_worker": by_worker,
                   "cold_s": cold_s, "warm_s": warm_s, "exchange": ex,
                   "tasks": _tasks_per_fragment(cluster, QUERIES[q])}
            if q == 3:
                if on_card and not (launches["insert"] and launches["probe"]):
                    raise AssertionError(f"CLUSTER Q3: a kernel never launched: {launches}")
                if capture.probe_args is None:
                    raise AssertionError("CLUSTER Q3: no probe of a received page captured")
                rec["probe"] = check_probe_at(device, "phase 22 Q3 (a page received over "
                                              "HTTP)", *capture.probe_args)
            out[f"CLUSTER Q{q}"] = rec
            log(f"CLUSTER Q{q} {qschema} on {CLUSTER_WORKERS} workers ({card}): "
                f"{len(res.rows)} rows equal to phase 11's; cold wall "
                f"{'not run' if cold_s is None else f'{cold_s:.4f}s'}, warm wall "
                f"{warm_s:.4f}s; tasks per fragment {rec['tasks']}; warm exchange.frames "
                f"{ex['exchange.frames']}, exchange.bytes {ex['exchange.bytes']}, "
                f"exchange.rows {ex['exchange.rows']}; warm launches {launches}, per worker "
                f"{by_worker}; join builds {int(builds)}, grouped pages {int(pages)}")

        # the merge path: ORDER BY without LIMIT, each worker sorts its rows
        # and the root task merges their streams (at CLUSTER_MERGE_SCHEMA)
        mschema = CLUSTER_MERGE_SCHEMA if schema == "sf1" else schema
        r.local.session = cluster.session(mschema)
        merges = []
        merge_iter = exchange_client.MergingRemoteSource.__iter__

        def counting_iter(src):
            merges.append(len(src.locations))
            return merge_iter(src)
        exchange_client.MergingRemoteSource.__iter__ = counting_iter
        try:
            cold, cold_s = timed(r, CLUSTER_MERGE_SQL)
            ex0 = exchange_counts()
            ph.insert_table.launches = 0
            ph.probe_table.launches = 0
            res, warm_s = timed(r, CLUSTER_MERGE_SQL)
            launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
            ex = {k: int(v - ex0[k]) for k, v in exchange_counts().items()}
        finally:
            exchange_client.MergingRemoteSource.__iter__ = merge_iter
        if not merges:
            raise AssertionError("CLUSTER merge: no MergingRemoteSource ran")
        oracle = oracle_merge(mschema)
        single = sql_runner(device, "pallas", mschema).execute(CLUSTER_MERGE_SQL).rows
        for label, rows in (("cold", cold.rows), ("warm", res.rows)):
            if not same_rows(rows, oracle) or not same_rows(rows, single):
                raise AssertionError(f"CLUSTER merge {mschema}: the {label} run's rows differ "
                                     f"from the oracle's or the single-node run's")
        out["CLUSTER merge"] = {"launches": launches, "cold_s": cold_s,
                                "warm_s": warm_s, "exchange": ex,
                                "tasks": _tasks_per_fragment(cluster, CLUSTER_MERGE_SQL)}
        log(f"CLUSTER merge {mschema} on {CLUSTER_WORKERS} workers ({card}): {len(res.rows)} rows "
            f"equal to the numpy oracle's and the single-node run's, in order; "
            f"MergingRemoteSource over {merges[0]} streams ({len(merges)} merges in 2 runs); "
            f"cold wall {cold_s:.4f}s, warm wall {warm_s:.4f}s; warm launches {launches}; tasks "
            f"per fragment {out['CLUSTER merge']['tasks']}; warm exchange.frames "
            f"{ex['exchange.frames']}, exchange.bytes {ex['exchange.bytes']}, exchange.rows "
            f"{ex['exchange.rows']}")
    finally:
        cluster.close()

    # the fault run: a worker stopped mid-Q3 under the TASK policy
    fschema = CLUSTER_FAULT_SCHEMA
    want = sql_runner(device, "pallas", fschema).execute(QUERIES[3]).rows
    fault_props = {"retry_policy": "TASK", "exchange_flush_rows": 256,
                   "remote_task_error_budget_s": 1.0,
                   "retry_initial_delay_s": 0.01, "retry_max_delay_s": 0.05}
    cluster = CardCluster(device, CLUSTER_FAULT_WORKERS, fschema, **fault_props)
    try:
        r = cluster.runner
        warm = r.execute(QUERIES[3])  # every lazily made device table exists after it
        if not same_rows(warm.rows, want):
            raise AssertionError("CLUSTER fault: the clean run's rows differ")
        cluster.join_tasks()
        gc.collect()
        sync()
        mem0 = torch.cuda.memory_allocated(device) if on_card else 0
        sub = r.plan_sql(QUERIES[3])
        from presto_tpu_torch.cluster.scheduler import _remote_source_ids

        leaf = next(f.id for f in sub.fragments
                    if not _remote_source_ids(f.root) and f.id != sub.root_fragment.id)
        victim = min(cluster.workers, key=lambda w: w.node_id)
        stopped = []

        def scheduled() -> bool:
            scheds = list(r._schedulers.values())
            return bool(scheds) and all(len(s.stages) == len(s.subplan.fragments)
                                        for s in scheds)

        def stop(ctx):
            # mid-stream (a chunk served and acked) and after every task
            # exists, so the recovery is the in-place one
            token = int(ctx["path"].partition("?")[0].rstrip("/").rsplit("/", 1)[-1])
            if token < 1 or stopped or not scheduled():
                return
            stopped.append(token)
            cluster.stop_worker(victim)
            raise faults.InjectedDisconnect("worker killed")

        inj = faults.FaultInjector(seed=22)
        inj.add("worker.results", faults.CALLBACK, node_id=victim.node_id,
                task_re=rf"\.{leaf}\.0$", times=None, callback=stop)
        faults.install(inj)
        seq0 = JOURNAL.last_seq()
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        try:
            res, wall = timed(r, QUERIES[3])
        finally:
            faults.clear()
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        if not stopped:
            raise AssertionError("CLUSTER fault: the worker was never stopped")
        if not same_rows(res.rows, want):
            raise AssertionError(f"CLUSTER fault: rows differ:\n{res.rows}\n{want}")
        retries = JOURNAL.events(since=seq0, kind="task.retry")
        qretries = JOURNAL.events(since=seq0, kind="query.retry")
        if not (retries or qretries):
            raise AssertionError("CLUSTER fault: no recovery journaled")
        cluster.join_tasks()
        gc.collect()
        sync()
        mem1 = torch.cuda.memory_allocated(device) if on_card else 0
        if mem1 > mem0:
            raise AssertionError(f"CLUSTER fault: {mem1 - mem0} bytes of device memory left "
                                 f"behind ({mem0} before, {mem1} after)")
        out["CLUSTER fault"] = {"launches": launches, "wall_s": wall,
                                "memory_before": mem0, "memory_after": mem1,
                                "stats": res.stats}
        log(f"CLUSTER fault {fschema} on {CLUSTER_FAULT_WORKERS} workers ({card}): "
            f"{victim.node_id} stopped at its leaf task's chunk {stopped[0]} under "
            f"retry_policy TASK; {len(res.rows)} rows equal to the single-node run's; wall "
            f"{wall:.4f}s; query_attempts {res.stats['query_attempts']}, task_retries "
            f"{res.stats['task_retries']}; journaled {len(retries)} task.retry "
            f"({sorted({e.get('retry_kind') for e in retries})}), {len(qretries)} query.retry; "
            f"torch.cuda.memory_allocated {mem0} before, {mem1} after, every task ended; "
            f"launches {launches} (the stopped worker's and its replacements')")
    finally:
        cluster.close()
    for rec in out.values():
        rec.pop("rows", None)
    return out


SERVER_QUERIES = (1, 3, 6)
SERVER_CONCURRENT = 4       # dbapi connections submitting Q3 at once
SERVER_HARD_CONCURRENCY = 2  # the resource group's running limit
SERVER_PAGE_ROWS = 1000
SERVER_FETCH_SQL = ("select o_orderkey, o_custkey, o_orderdate, o_totalprice from orders "
                    "where o_orderdate < date '1993-01-01'")
SERVER_FETCH_MIN_ROWS = 100_000
SERVER_FAIL_SQL = "select no_such_column from nation"
SERVER_CLUSTER_WORKERS = 2
SERVER_CLUSTER_Q3_SCHEMA = "tiny"


def same_json_rows(got, want_rows) -> bool:
    """``got`` (rows after the JSON round trip) equal the in-process rows
    ``want_rows`` as the protocol renders them (``_to_json_row``)."""
    from presto_tpu_torch.server.protocol import QueryManager

    return same_rows(got, [QueryManager._to_json_row(r) for r in want_rows])


class CountingClient:
    """A ``StatementClient`` that counts its requests and the pages that
    carried rows, and checks every ``nextUri`` against ``base``."""

    def __init__(self, server: str, sql: str, base: Optional[str] = None, **kw):
        from presto_tpu_torch.client import StatementClient

        outer = self
        self.requests = self.pages = 0
        self.next_uris = []
        self.base = base

        class _Client(StatementClient):
            def _request(self, method, url, body=None):
                payload = super()._request(method, url, body)
                outer.requests += 1
                outer.pages += bool(payload.get("data"))
                if payload.get("nextUri"):
                    outer.next_uris.append(payload["nextUri"])
                return payload
        self.client = _Client(server, sql, poll_interval_s=0.01, **kw)

    def rows(self) -> list:
        rows = list(self.client.rows())
        if self.base is not None:
            bad = [u for u in self.next_uris if not u.startswith(self.base)]
            if bad or not self.next_uris:
                raise AssertionError(f"SERVER: nextUri not on {self.base}: {bad[:3]} "
                                     f"({len(self.next_uris)} in all)")
        return rows


def _http_json(url: str, method: str = "GET", data: Optional[bytes] = None):
    import urllib.request

    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"X-Presto-User": "chip-smoke"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read() or b"null")


def run_server_phase(device, records: dict, card: str = "", schema: str = "sf1") -> dict:
    """Phase 23: the server (see the module docstring). Returns the records
    whose launches the kernels line reports, keyed ``SERVER ...``."""
    import threading

    import torch

    from presto_tpu_torch.client import dbapi
    from presto_tpu_torch.cluster import ClusterQueryRunner, WorkerServer
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.server.proxy import ProxyServer
    from presto_tpu_torch.server.resource_groups import GroupSpec, ResourceGroupManager
    from presto_tpu_torch.utils.events import JOURNAL
    from presto_tpu_torch.utils.metrics import METRICS
    from presto_tpu_torch.verifier import MATCH, Verifier

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}

    def zero():
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        return {k: METRICS.counter_value(k) for k in COUNTERS}

    def read(before):
        sync()
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        return launches, {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}

    def want_rows(q: int, qschema: str):
        rec = records.get(q)
        if rec is not None and rec.get("schema", "sf1") == qschema:
            return rec["rows"]
        return sql_runner(device, "pallas", qschema).execute(QUERIES[q]).rows

    # want rows first: the in-process runs must not count in (g)
    wants = {q: want_rows(q, schema) for q in SERVER_QUERIES}
    want_q3_tiny = want_rows(3, SERVER_CLUSTER_Q3_SCHEMA)
    control = sql_runner(device, "pallas", schema)
    want_fetch = control.execute(SERVER_FETCH_SQL).rows
    try:
        control.execute(SERVER_FAIL_SQL)
        raise AssertionError("SERVER: the failing statement ran in-process")
    except AssertionError:
        raise
    except Exception as e:  # noqa: BLE001 - the engine's own error type
        want_error = type(e).__name__
    del control
    mem0 = device_memory(device)
    seq0 = JOURNAL.last_seq()
    revoked0 = METRICS.counter_value("memory.revoked_bytes")

    rg = ResourceGroupManager(GroupSpec("root", hard_concurrency_limit=SERVER_HARD_CONCURRENCY,
                                        max_queued=100))
    runner = LocalQueryRunner(Session(catalog="tpch", schema=schema,
                                      properties={"hash_kernels": "pallas"}), device=device)
    server = PrestoTpuServer(runner, port=0, page_rows=SERVER_PAGE_ROWS, resource_groups=rg)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    proxy = cluster_server = None
    workers = []
    try:
        # (a) Q1, Q3, Q6 through the client, cold then warm
        for q in SERVER_QUERIES:
            RESIDENT_CACHE.clear()
            t0 = time.perf_counter()
            cold = CountingClient(base, QUERIES[q]).rows()
            cold_s = time.perf_counter() - t0
            before = zero()
            t0 = time.perf_counter()
            warm = CountingClient(base, QUERIES[q]).rows()
            warm_s = time.perf_counter() - t0
            launches, delta = read(before)
            for label, rows in (("cold", cold), ("warm", warm)):
                if not same_json_rows(rows, wants[q]):
                    raise AssertionError(f"SERVER Q{q}: the {label} rows differ from phase "
                                         f"11's:\n{rows}\n{wants[q]}")
            if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
                raise AssertionError(f"SERVER Q{q}: a fallback: {delta}")
            if q == 3:
                phase11 = records[3]["launches"]
                if on_card and (launches != phase11 or delta["pallas.join_builds"] != 2):
                    raise AssertionError(f"SERVER Q3: warm launches {launches} (phase 11's "
                                         f"{phase11}), join builds {delta['pallas.join_builds']}")
            out[f"SERVER Q{q}"] = {"launches": launches, "cold_s": cold_s, "warm_s": warm_s}
            log(f"SERVER Q{q} {schema} ({card}): {len(warm)} rows equal to phase 11's after the "
                f"JSON round trip; cold wall {cold_s:.4f}s, warm wall {warm_s:.4f}s (in-process "
                f"phase 11: cold {records[q].get('cold_s', float('nan')):.4f}s, warm "
                f"{records[q].get('warm_s', float('nan')):.4f}s); warm launches {launches}; join "
                f"builds {int(delta['pallas.join_builds'])}, grouped pages "
                f"{int(delta['pallas.agg_pages'])}")

        # (b) four dbapi connections submit Q3 at once through the resource group
        seq_b = JOURNAL.last_seq()
        results, errors = {}, []
        barrier = threading.Barrier(SERVER_CONCURRENT)

        def submit(i):
            try:
                conn = dbapi.connect(host="127.0.0.1", port=server.port, user=f"tenant{i}",
                                     catalog="tpch", schema=schema)
                cur = conn.cursor()
                barrier.wait(timeout=60)
                results[i] = cur.execute(QUERIES[3]).fetchall()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
        before = zero()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(SERVER_CONCURRENT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        conc_s = time.perf_counter() - t0
        launches, delta = read(before)
        if errors or len(results) != SERVER_CONCURRENT:
            raise AssertionError(f"SERVER concurrent Q3: {errors or results.keys()}")
        for i, rows in results.items():
            if not same_json_rows([list(r) for r in rows], wants[3]):
                raise AssertionError(f"SERVER concurrent Q3: connection {i}'s rows differ")
        _st, evts = _http_json(f"{base}/v1/events?since={seq_b}&kind=query.")
        queued = [e for e in evts["events"] if e["kind"] == "query.queued"]
        promoted = [e for e in evts["events"] if e["kind"] == "query.admitted"
                    and e.get("promoted")]
        if len(queued) < 2:
            raise AssertionError(f"SERVER concurrent Q3: {len(queued)} queued admissions")
        if on_card and launches["insert"] != 2 * SERVER_CONCURRENT:
            raise AssertionError(f"SERVER concurrent Q3: insert launches {launches}")
        out["SERVER concurrent Q3"] = {"launches": launches, "wall_s": conc_s}
        log(f"SERVER concurrent Q3 {schema} ({card}): {SERVER_CONCURRENT} dbapi connections at "
            f"once, hard concurrency {SERVER_HARD_CONCURRENCY}; every connection got Q3's rows; "
            f"wall {conc_s:.4f}s; GET /v1/events: {len(queued)} query.queued, {len(promoted)} "
            f"promoted admissions (queued for "
            f"{[e.get('queued_s') for e in promoted]}s); launches {launches}")

        # (c) one statement of >= 100,000 rows through nextUri paging, and
        # the verifier: the in-process runner as control, the server as test
        fetch = {}

        def served(sql):
            c = CountingClient(base, sql)
            t0 = time.perf_counter()
            rows = c.rows()
            fetch.update(wall_s=time.perf_counter() - t0, requests=c.requests,
                         pages=c.pages, rows=len(rows))
            return rows
        # the control's rows as the protocol renders them: DECIMAL and DATE
        # travel as text
        from presto_tpu_torch.server.protocol import QueryManager

        control_rows = [QueryManager._to_json_row(r) for r in want_fetch]
        before = zero()
        verdict = Verifier(control=lambda sql: control_rows, test=served).verify(
            "fetch", SERVER_FETCH_SQL)
        launches, _delta = read(before)
        if verdict.status != MATCH or fetch["rows"] != len(want_fetch) \
                or (schema == "sf1" and fetch["rows"] < SERVER_FETCH_MIN_ROWS):
            raise AssertionError(f"SERVER fetch: {verdict}, {fetch}, {len(want_fetch)} in-process")
        out["SERVER fetch"] = {"launches": launches, **fetch}
        log(f"SERVER fetch {schema} ({card}): {fetch['rows']} rows in {fetch['pages']} pages of "
            f"{SERVER_PAGE_ROWS} through {fetch['requests']} requests, wall "
            f"{fetch['wall_s']:.4f}s ({fetch['rows'] / fetch['wall_s']:.0f} rows/s); the "
            f"verifier (in-process control, server as test): {verdict.status}")

        # (d) a failing statement: the engine's errorType, and its forensic
        _st, payload = _http_json(f"{base}/v1/statement", "POST", SERVER_FAIL_SQL.encode())
        qid = payload["id"]
        while payload.get("nextUri"):
            time.sleep(0.01)
            _st, payload = _http_json(payload["nextUri"])
        err = payload.get("error") or {}
        if payload["stats"]["state"] != "FAILED" or err.get("errorType") != want_error:
            raise AssertionError(f"SERVER failure: {payload}, want errorType {want_error}")
        _st, forensic = _http_json(f"{base}/v1/query/{qid}/trace")
        if not (isinstance(forensic.get("traceEvents"), list)
                and forensic.get("otherData", {}).get("coarse") is True):
            raise AssertionError("SERVER failure: /v1/query/{id}/trace served no forensic")
        log(f"SERVER failure ({card}): errorType {err['errorType']} (the engine's), "
            f"GET /v1/query/{qid}/trace served the black box: "
            f"{len(forensic['traceEvents'])} events")

        # (f) Q6 through the proxy in front of (a)
        proxy = ProxyServer(base, port=0).start()
        pbase = f"http://127.0.0.1:{proxy.port}"
        before = zero()
        c = CountingClient(pbase, QUERIES[6], base=pbase)
        rows = c.rows()
        launches, _delta = read(before)
        if not same_json_rows(rows, wants[6]):
            raise AssertionError("SERVER proxy Q6: rows differ from phase 11's")
        out["SERVER proxy Q6"] = {"launches": launches}
        log(f"SERVER proxy Q6 ({card}): rows equal to phase 11's; {len(c.next_uris)} nextUri, "
            f"every one on the proxy; {c.requests} requests")
        proxy.stop()
        proxy = None
    finally:
        if proxy is not None:
            proxy.stop()
        server.stop()
    revoked = METRICS.counter_value("memory.revoked_bytes") - revoked0
    spills = JOURNAL.events(since=seq0, kind="memory.spill")
    log(f"SERVER memory: revoked {int(revoked)} bytes, {len(spills)} memory.spill events over "
        f"(a)-(d) and (f)")
    del runner, server, rg

    # (e) cluster mode through the server
    crunner = ClusterQueryRunner(Session(catalog="tpch", schema=schema,
                                         properties={"hash_kernels": "pallas"}),
                                 min_workers=SERVER_CLUSTER_WORKERS, worker_wait_s=30.0,
                                 device=device)
    cluster_server = PrestoTpuServer(crunner, port=0, page_rows=SERVER_PAGE_ROWS)
    cluster_server.start()
    cbase = f"http://127.0.0.1:{cluster_server.port}"
    try:
        workers = [WorkerServer(port=0, coordinator_uri=cbase, device=device).start()
                   for _ in range(SERVER_CLUSTER_WORKERS)]
        deadline = time.monotonic() + 30
        while len(crunner.nodes.active_nodes()) < SERVER_CLUSTER_WORKERS:
            if time.monotonic() > deadline:
                raise AssertionError("SERVER cluster: the workers never announced")
            time.sleep(0.05)

        def cluster_run(label, q, qschema, want):
            # the coordinator's own session names the scale (a header-scoped
            # copy of a cluster runner cannot replace its session)
            crunner.local.session = Session(catalog="tpch", schema=qschema,
                                            properties={"hash_kernels": "pallas"})
            client = CountingClient(cbase, QUERIES[q])
            RESIDENT_CACHE.clear()
            before = zero()
            t0 = time.perf_counter()
            rows = client.rows()
            wall = time.perf_counter() - t0
            launches, delta = read(before)
            if not same_json_rows(rows, want):
                raise AssertionError(f"SERVER {label}: rows differ from the single-node run's")
            if delta["pallas.join_fallbacks"] or delta["pallas.agg_fallbacks"]:
                raise AssertionError(f"SERVER {label}: a fallback: {delta}")
            out[f"SERVER {label}"] = {"launches": launches, "wall_s": wall}
            return wall, launches

        q1_s, q1_l = cluster_run("cluster Q1", 1, schema, wants[1])
        q3_s, q3_l = cluster_run("cluster Q3", 3, SERVER_CLUSTER_Q3_SCHEMA, want_q3_tiny)
        if on_card and not (q3_l["insert"] and q3_l["probe"]):
            raise AssertionError(f"SERVER cluster Q3: a kernel never launched: {q3_l}")
        _st, stats = _http_json(f"{cbase}/v1/cluster")
        if stats["activeWorkers"] != SERVER_CLUSTER_WORKERS or \
                sorted(n["nodeId"] for n in stats["nodes"]) != sorted(w.node_id for w in workers):
            raise AssertionError(f"SERVER cluster: GET /v1/cluster gave {stats}")
        _st, merged = _http_json(f"{cbase}/v1/cluster/metrics")
        if merged.get("cluster.workers_merged") != SERVER_CLUSTER_WORKERS:
            raise AssertionError(f"SERVER cluster: /v1/cluster/metrics merged "
                                 f"{merged.get('cluster.workers_merged')} workers")
        victim, survivor = workers
        seq_d = JOURNAL.last_seq()
        t0 = time.perf_counter()
        status, body = _http_json(f"{cbase}/v1/cluster/drain/{victim.node_id}", "PUT")
        if status != 202:
            raise AssertionError(f"SERVER cluster drain: {status} {body}")
        deadline = time.monotonic() + 60
        while crunner.nodes.get(victim.node_id) is not None or victim.state != "DRAINED":
            if time.monotonic() > deadline:
                raise AssertionError(f"SERVER cluster drain: {victim.node_id} is "
                                     f"{victim.state} and still in discovery")
            time.sleep(0.05)
        drain_s = time.perf_counter() - t0
        crunner.min_workers = 1  # the operator lowered the floor with the drain
        q1b_s, _l = cluster_run("cluster Q1 after drain", 1, schema, wants[1])
        on = [n.node_id for n in crunner.nodes.active_nodes()]
        if on != [survivor.node_id]:
            raise AssertionError(f"SERVER cluster: after the drain the active nodes are {on}")
        drained = JOURNAL.events(since=seq_d, kind="node.drained")
        log(f"SERVER cluster ({card}): {SERVER_CLUSTER_WORKERS} WorkerServers announced over POST "
            f"/v1/announcement; Q1 {schema} wall {q1_s:.4f}s launches {q1_l}, Q3 "
            f"{SERVER_CLUSTER_Q3_SCHEMA} wall {q3_s:.4f}s launches {q3_l}, rows equal to the "
            f"single-node runs; GET /v1/cluster: {stats['activeWorkers']} active workers; GET "
            f"/v1/cluster/metrics merged {merged['cluster.workers_merged']} workers; PUT "
            f"/v1/cluster/drain/{victim.node_id}: 202, DRAINED and out of discovery in "
            f"{drain_s:.4f}s (node.drained journaled: {bool(drained)}); Q1 on "
            f"{survivor.node_id} alone wall {q1b_s:.4f}s")
    finally:
        for w in workers:
            w.stop()
        crunner.detector.stop()
        cluster_server.stop()
        for w in workers:
            if not w.join_tasks(120.0):
                raise AssertionError(f"SERVER cluster: a task of {w.node_id} did not end")
    del crunner, cluster_server, workers

    # (g) device memory: every server stopped, every runner gone
    mem1 = device_memory(device)
    if on_card and mem1 != mem0:
        raise AssertionError(f"SERVER memory: torch.cuda.memory_allocated {mem0} before the "
                             f"phase's servers, {mem1} after")
    log(f"SERVER memory ({card}): torch.cuda.memory_allocated {mem0} before the phase's servers "
        f"were made, {mem1} after all of them stopped (resident page cache cleared both times)")
    return out


# phase 24: the sanitizers on the card
SAN_ENV = ("PRESTO_TPU_TORCH_LOCKSAN", "PRESTO_TPU_TORCH_LEAKSAN", "PRESTO_TPU_TORCH_COMPILESAN")
SAN_QUERIES = (1, 3)               # at SF1, twice each, against phase 11's rows
SAN_SMALL_SCHEMA = "tiny"          # the distributed Q3, the leak shapes, the serving mix
SAN_SERVE_QUERIES = (1, 3, 6)
SAN_SERVE_CLIENTS = 4
# each sanitizer's dump (DIR/<name>.json) and the tools.prestocheck mode that reads it
SAN_DIFFS = {"locksan": "--lock-graph-diff", "leaksan": "--leak-diff",
             "compilesan": "--compile-diff"}
SAN_CHILD_TIMEOUT_S = 300


def sanitizers_main(out_dir: str, device_name: str, schema: str) -> int:
    """``--sanitizers DIR DEVICE SCHEMA``: phase 24's child, started with
    the three ``PRESTO_TPU_TORCH_*SAN=1`` variables, so that the port's
    import arms its sanitizers before any of its locks exists. Runs the
    phase's steps, raises on any finding, and writes ``DIR/result.pkl``
    and the three dumps."""
    import threading

    import torch

    from presto_tpu_torch.exec import shared_pools
    from presto_tpu_torch.utils import compilesan, kernel_cache, leaksan, locksan

    sanitizers = {"locksan": locksan, "leaksan": leaksan, "compilesan": compilesan}
    if not all(m.enabled() for m in sanitizers.values()):
        raise AssertionError("SANITIZERS: the environment did not arm all three")
    pools = {name: type(cv).__name__ for name, cv in shared_pools.pool_locks().items()}
    if set(pools.values()) != {"_SanCondition"}:
        raise AssertionError(f"SANITIZERS: a shared pool's condition is raw: {pools} (the "
                             "lock sanitizer installed after the pools allocated)")

    from presto_tpu_torch.cluster import faults
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.memory import shared_general_pool
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.parallel.mesh import MeshContext
    from presto_tpu_torch.parallel.runner import DistributedQueryRunner
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.utils.metrics import METRICS

    device = torch.device(device_name)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    small = SAN_SMALL_SCHEMA

    def memory() -> int:
        # what the caches keep on purpose goes first: the resident pages
        # and the compositions
        RESIDENT_CACHE.clear()
        kernel_cache.clear()
        gc.collect()
        sync()
        return torch.cuda.memory_allocated(device) if on_card else 0

    walls = {}
    clock = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        walls[name] = now - clock[0]
        clock[0] = now

    # the in-process rows of the small steps, and every lazy device state
    # made once, before the first reading
    wants = {q: sql_runner(device, "pallas", small).execute(QUERIES[q]).rows
             for q in SAN_SERVE_QUERIES}
    mem0 = memory()
    step("warm-up at " + small)

    # (a) Q1 and Q3 twice each on one runner: the second pass composes nothing
    runner = sql_runner(device, "pallas", schema)
    seg0 = METRICS.counter_value("segments.compiles")
    builds0 = compilesan.SANITIZER.total_builds()
    fused0 = compilesan.SANITIZER.family_totals()["fused-segment"]
    rows, launches, seg_stats = {q: [] for q in SAN_QUERIES}, {}, {}
    for q in SAN_QUERIES:
        res = runner.execute(QUERIES[q])
        sync()
        step(f"Q{q} first")
        rows[q].append(res.rows)
        seg_stats[q] = (res.stats or {}).get("segments") or {"compiles": 0}
    cold_builds = compilesan.SANITIZER.total_builds() - builds0
    for q in SAN_QUERIES:
        ph.insert_table.launches = ph.probe_table.launches = 0
        rows[q].append(runner.execute(QUERIES[q]).rows)
        sync()
        step(f"Q{q} second")
        launches[q] = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
    warm_builds = compilesan.SANITIZER.total_builds() - builds0 - cold_builds
    fused = compilesan.SANITIZER.family_totals()["fused-segment"] - fused0
    seg_compiles = int(METRICS.counter_value("segments.compiles") - seg0)
    if warm_builds or fused != seg_compiles or fused != sum(s["compiles"] for s in
                                                             seg_stats.values()):
        raise AssertionError(f"SANITIZERS: the second pass built {warm_builds}; fused-segment "
                             f"builds {fused}, segments.compiles {seg_compiles}, per query "
                             f"{seg_stats}")
    del runner

    # (b) the distributed Q3 on four logical workers of the device
    dist = DistributedQueryRunner(
        MeshContext([device] * 4), device=device,
        session=Session(catalog="tpch", schema=small, properties={"hash_kernels": "pallas"}))
    if not same_rows(dist.execute(QUERIES[3]).rows, wants[3]):
        raise AssertionError("SANITIZERS: the distributed Q3 differs from the local run")
    del dist
    step("distributed Q3")

    # (c) the leak shapes beside the happy ones above: a cancelled served
    # query, and a spill.write fault under a one-byte pool
    server = PrestoTpuServer(sql_runner(device, "pallas", small), port=0)
    server.start()
    try:
        info = server.manager.submit("select count(*) from lineitem")
        if not server.manager.cancel(info.query_id):
            raise AssertionError("SANITIZERS: the cancel was refused")
        deadline = time.monotonic() + 30
        while not info.done() and time.monotonic() < deadline:
            time.sleep(0.01)
        if info.state != "CANCELED":
            raise AssertionError(f"SANITIZERS: the cancelled query ended {info.state}")
    finally:
        server.stop()
    faults.install(faults.FaultInjector.from_spec("spill.write:error:times=1", seed=7))
    try:
        sql_runner(device, "pallas", small, **PRESSURE).execute(QUERIES[3])
        raise AssertionError("SANITIZERS: the injected spill.write fault did not fire")
    except faults.InjectedFault:
        pass  # the owning query fails: the contract
    finally:
        faults.clear()
    step("cancel and fault")

    # (d) four StatementClients at once on Q1, Q3 and Q6 through the server
    server = PrestoTpuServer(sql_runner(device, "pallas", small), port=0)
    server.start()
    errors, served = [], [0]
    try:
        base = f"http://127.0.0.1:{server.port}"

        def client(i):
            try:
                for j in range(len(SAN_SERVE_QUERIES)):
                    q = SAN_SERVE_QUERIES[(i + j) % len(SAN_SERVE_QUERIES)]
                    got = list(StatementClient(base, QUERIES[q], poll_interval_s=0.01).rows())
                    if not same_json_rows(got, wants[q]):
                        errors.append(f"client {i} Q{q}: rows differ")
                    served[0] += 1
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"client {i}: {e!r}")
        threads = [threading.Thread(target=client, args=(i,), name=f"san-client-{i}")
                   for i in range(SAN_SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"SANITIZERS: serving failed: {errors[:3]}")
    finally:
        server.stop()
    step("serving")

    # the gate
    leaksan.SANITIZER.check_exit()
    reports = {name: m.SANITIZER.report() for name, m in sanitizers.items()}
    findings = {name: len(m.SANITIZER.findings()) for name, m in sanitizers.items()}
    if any(findings.values()):
        raise AssertionError("SANITIZERS: findings:\n" + "\n".join(reports.values()))
    live_bytes = METRICS.snapshot("leaksan")["leaksan.live_bytes"]
    hold = METRICS.histogram_summary("locksan.hold_s")
    if live_bytes != 0 or hold.get("count", 0) == 0:
        raise AssertionError(f"SANITIZERS: leaksan.live_bytes {live_bytes}, locksan.hold_s {hold}")
    if shared_general_pool().spill_by_query():
        raise AssertionError("SANITIZERS: spill bytes left in the pool's ledger")
    mem1 = memory()
    if mem1 != mem0:
        raise AssertionError(f"SANITIZERS: device memory {mem0} before the steps, {mem1} after")
    for name, m in sanitizers.items():
        m.SANITIZER.dump(os.path.join(out_dir, f"{name}.json"))
    result = {
        "rows": rows, "launches": launches, "walls": walls, "pools": pools,
        "findings": findings, "cold_builds": cold_builds, "warm_builds": warm_builds,
        "fused_builds": fused, "segments_compiles": seg_compiles, "served": served[0],
        "locks": locksan.SANITIZER.n_locks, "edges": len(locksan.SANITIZER.edges()),
        "hold": hold, "wait": METRICS.histogram_summary("locksan.wait_s"),
        "live": leaksan.SANITIZER.live_counts(), "live_bytes": live_bytes,
        "compile_sites": len(compilesan.SANITIZER.site_stats()), "memory": (mem0, mem1)}
    with open(os.path.join(out_dir, "result.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(out_dir, "result.pkl.tmp"), os.path.join(out_dir, "result.pkl"))
    return 0


def run_sanitizer_phase(device, records: dict, card: str = "", schema: str = "sf1") -> dict:
    """Phase 24: the port's main path under its lock, leak and compile
    sanitizers, in a child process (see the module docstring); each dump
    read back by ``tools.prestocheck``, also in a child. Returns the
    records whose launches the kernels line reports, keyed ``SANITIZED
    Q...``."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-sanitizers-")
    try:
        env = dict(os.environ, **{name: "1" for name in SAN_ENV})
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sanitizers", out_dir,
             str(device), schema], env=env, cwd=here, capture_output=True, text=True,
            timeout=SAN_CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"SANITIZERS: the child exited {child.returncode}:\n"
                                 f"{(child.stdout + child.stderr)[-6000:]}")
        with open(os.path.join(out_dir, "result.pkl"), "rb") as f:
            res = pickle.load(f)
        out = {}
        for q in SAN_QUERIES:
            want = records[q]
            if want.get("schema", "sf1") != schema:
                raise AssertionError(f"SANITIZERS: phase 11 holds Q{q} at {want.get('schema')}")
            for i, got in enumerate(res["rows"][q]):
                if not same_rows(got, want["rows"]):
                    raise AssertionError(f"SANITIZERS Q{q}: run {i + 1}'s rows differ from "
                                         f"phase 11's")
            out[f"SANITIZED Q{q}"] = {"launches": res["launches"][q]}
        if device.type == "cuda" and res["launches"][3] != records[3]["launches"]:
            raise AssertionError(f"SANITIZERS Q3: warm launches {res['launches'][3]}, phase "
                                 f"11's {records[3]['launches']}")
        t0 = time.perf_counter()
        diffs = {flag: subprocess.Popen(
            [sys.executable, "-m", "tools.prestocheck", flag,
             os.path.join(out_dir, f"{name}.json"), "presto_tpu_torch"], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, flag in SAN_DIFFS.items()}
        summaries = []
        for flag, proc in diffs.items():
            text, _ = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"SANITIZERS: {flag} exited {proc.returncode}:\n{text[-3000:]}")
            summaries.append(text.strip().splitlines()[-1] if text.strip() else "")
        diff_s = time.perf_counter() - t0
        hold, wait = res["hold"], res["wait"] or {}
        log(f"SANITIZERS {schema} ({card}): locksan {res['locks']} locks, {res['edges']} order "
            f"edges, hold_s count {hold['count']} p50 {hold['p50']} p95 {hold['p95']} p99 "
            f"{hold['p99']}, wait_s count {wait.get('count', 0)} p50 {wait.get('p50')} p95 "
            f"{wait.get('p95')} p99 {wait.get('p99')}; leaksan live {res['live']}, live_bytes "
            f"{res['live_bytes']}; compilesan {res['cold_builds']} builds in the first pass "
            f"(fused-segment {res['fused_builds']} = segments.compiles "
            f"{res['segments_compiles']}), {res['warm_builds']} in the second, "
            f"{res['compile_sites']} sites; findings {res['findings']}; pools {res['pools']}; "
            f"Q1 and Q3 rows equal phase 11's on both passes, Q3 warm launches "
            f"{res['launches'][3]}; {res['served']} served statements; device memory "
            f"{res['memory'][0]} before and after; walls "
            + ", ".join(f"{k} {v:.4f}s" for k, v in res["walls"].items())
            + f"; child {child_s:.1f}s, the three diffs {diff_s:.1f}s")
        for line in summaries:
            log(f"SANITIZERS {line}")
        return out
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# phase 25: the hand-built Q1 and Q6, and Q1 streamed through the card
HAND_QUERIES = (1, 6)
STREAM_BUDGET_S = 600.0         # above the script's own limit: the SF1 scan runs to its end
STREAM_PREFIX_SF = 10.0         # the reference bench's --sf default
STREAM_PREFIX_ROWS = 1 << 24    # eight of q1_stream's default 2^21-row batches
STREAM_BATCH_ROWS = 1 << 21     # q1_stream's default batch; the step timed at it
RESIDENT_BATCH_ROWS = 1 << 22   # q1_resident's default batch
WIRE_BYTES_PER_ROW = 12         # the narrow wire format the step reads


def oracle_resident_sums(sf: float, batch_rows: int) -> dict:
    """Q1's sums in numpy over q1_resident's batch: the first orders'
    lineitem at ``max(sf, 1)``, tiled to ``batch_rows`` rows."""
    from presto_tpu_torch.connectors.tpch import generator as g

    sf = max(sf, 1.0)
    orders = min(int(batch_rows / g.AVG_LINES_PER_ORDER) + 1,
                 g.table_row_count("orders", sf))
    li = g.lineitem_for_orders(0, orders, sf, list(Q1_COLUMNS))
    reps = batch_rows // len(li["l_shipdate"]) + 1
    return q1_sums_np({k: np.tile(v, reps)[:batch_rows] for k, v in li.items()})


def check_sums(label: str, got: dict, want: dict) -> None:
    if list(got) != list(Q1_SUMS):
        raise AssertionError(f"{label}: finish keys {list(got)}")
    for k in Q1_SUMS:
        if got[k].dtype != np.int64 or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{label}: {k} {got[k]} ({got[k].dtype}) != {want[k]}")


def run_hand_stream_phase(device, records: dict, card: str = "", schema: str = "sf1",
                          prefix_sf: float = STREAM_PREFIX_SF,
                          prefix_rows: int = STREAM_PREFIX_ROWS,
                          batch_rows: int = STREAM_BATCH_ROWS,
                          resident_rows: int = RESIDENT_BATCH_ROWS) -> dict:
    """Phase 25: the hand-built Q1 and Q6 (``models/hand_queries.run_query``)
    cold (the connector's generation cache cleared) and warm (replaying it),
    rows equal to the numpy oracles and to phase 11's SQL rows;
    ``q1_stream`` over all of ``schema``'s lineitem, its finish dict equal
    to the oracle's sums; ``q1_stream`` with one producer over the
    first ``prefix_rows`` rows at ``prefix_sf``, against numpy over the
    same prefix; the step's device ms at ``batch_rows``; ``q1_resident`` at
    ``resident_rows``, its one batch against numpy. Prints ``HAND`` and
    ``STREAM`` lines; returns the records whose launches the kernels line
    reports, keyed ``HAND Q...``."""
    import torch

    from presto_tpu_torch.connectors.tpch.connector import GEN_CACHE, SCHEMAS
    from presto_tpu_torch.models import hand_queries as hq
    from presto_tpu_torch.models import kernels as mk
    from presto_tpu_torch.ops import pallas_hash as ph

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sf = SCHEMAS[schema]
    t0 = time.perf_counter()
    sums, n_rows = q1_prefix_sums(sf)
    want = {1: q1_rows_from_sums(sums), 6: oracle_q6(schema)[0]}
    oracle_s = time.perf_counter() - t0
    out = {}
    for q in HAND_QUERIES:
        builder = getattr(hq, f"build_q{q}")
        GEN_CACHE.clear()  # the cold run generates lineitem anew
        t0 = time.perf_counter()
        hq.run_query(builder, schema, device=device)
        sync()
        cold_s = time.perf_counter() - t0
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        t0 = time.perf_counter()
        rows = hq.run_query(builder, schema, device=device)
        sync()
        warm_s = time.perf_counter() - t0
        launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
        if not same_rows(rows, want[q]):
            raise AssertionError(f"HAND Q{q} {schema}: rows differ from the numpy oracle:\n"
                                 f"{rows}\n{want[q]}")
        sql = records[q]
        if sql.get("schema", "sf1") != schema or not same_rows(rows, sql["rows"]):
            raise AssertionError(f"HAND Q{q} {schema}: rows differ from phase 11's SQL rows "
                                 f"({sql.get('schema', 'sf1')}):\n{rows}\n{sql['rows']}")
        src = hq.source_rows(f"q{q}", schema)
        log(f"HAND Q{q} {schema} ({card}): {len(rows)} rows equal to the numpy oracle and to "
            f"phase 11's SQL rows; cold wall {cold_s:.4f}s, warm wall {warm_s:.4f}s = "
            f"{src / warm_s:.0f} source rows/s ({src} rows); warm launches {launches}")
        out[f"HAND Q{q}"] = {"launches": launches}

    rows, wall, stall, first_s, fin = mk.q1_stream(sf, seconds_budget=STREAM_BUDGET_S,
                                                   batch_rows=batch_rows, device=device)
    if rows != n_rows:
        raise AssertionError(f"STREAM Q1 {schema}: {rows} rows of {n_rows}")
    check_sums(f"STREAM Q1 {schema}", fin, sums)
    log(f"STREAM Q1 {schema} ({card}): {rows} rows to the end, 3 producers, {batch_rows}-row "
        f"batches; wall {wall:.4f}s = {rows / wall:.0f} rows/s; gen stall {stall:.4f}s; "
        f"first dispatch {first_s:.4f}s; finish exact against the numpy oracle's sums "
        f"(oracle {oracle_s:.1f}s, with Q6's)")

    from presto_tpu_torch.connectors.tpch import generator as g

    total = g.lineitem_row_count(prefix_sf)
    rows, wall, stall, first_s, fin = mk.q1_stream(
        prefix_sf, seconds_budget=STREAM_BUDGET_S, batch_rows=batch_rows, gen_threads=1,
        max_rows=prefix_rows, device=device)
    if not prefix_rows <= rows < total:
        raise AssertionError(f"STREAM Q1 sf{prefix_sf:g} prefix: {rows} rows (max_rows "
                             f"{prefix_rows}, table {total})")
    t0 = time.perf_counter()
    prefix_sums, seen = q1_prefix_sums(prefix_sf, rows)
    if seen != rows:
        raise AssertionError(f"STREAM Q1 sf{prefix_sf:g} prefix: oracle saw {seen} of {rows}")
    check_sums(f"STREAM Q1 sf{prefix_sf:g} prefix", fin, prefix_sums)
    oracle_s = time.perf_counter() - t0

    step_args = tuple(torch.from_numpy(a).to(device) for a in mk.resident_batch(batch_rows,
                                                                                prefix_sf))
    acc = torch.zeros((len(Q1_SUMS), 6), dtype=torch.int64, device=device)
    step_ms = (device_ms(mk.q1_stream_step, (*step_args, acc), 20, counted=False) if on_card
               else time_ms(lambda: mk.q1_stream_step(*step_args, acc), 3, device))
    bound_ms = batch_rows * WIRE_BYTES_PER_ROW / HBM_RATE * 1e3
    del step_args, acc
    log(f"STREAM Q1 sf{prefix_sf:g} prefix ({card}): {rows} of {total} rows, 1 producer; wall "
        f"{wall:.4f}s = {rows / wall:.0f} rows/s; gen stall {stall:.4f}s; first dispatch "
        f"{first_s:.4f}s; finish exact against numpy over the same prefix (oracle "
        f"{oracle_s:.1f}s); the step on a {batch_rows}-row batch: "
        f"{'device (bracket)' if on_card else 'host'} {step_ms:.4f} ms against a "
        f"{bound_ms:.4f} ms bound ({batch_rows * WIRE_BYTES_PER_ROW} bytes read)")

    rps, got_rows, resident_ms, one = mk.q1_resident(prefix_sf, batch_rows=resident_rows,
                                                     device=device)
    check_sums(f"RESIDENT Q1 sf{prefix_sf:g}", one,
               oracle_resident_sums(prefix_sf, resident_rows))
    log(f"STREAM Q1 resident sf{prefix_sf:g} ({card}): {got_rows}-row batch, 10 chained "
        f"steps: {rps:.0f} rows/s, {resident_ms:.4f} ms a step (host clock); one batch exact "
        f"against numpy")
    return out


# phase 26: the operator's lifecycle, the port's drives of the reference's
# cluster dry runs (``__graft_entry__.dryrun_churn``, ``dryrun_rolling_upgrade``,
# ``dryrun_chaos``, ``dryrun_forensics``), with their queries and settings
LIFECYCLE_SCHEMA = "tiny"
CHURN_SQL = "select l_suppkey, count(*), sum(l_quantity) from lineitem group by l_suppkey"
CHAOS_SQL = "select l_orderkey, count(*), sum(l_quantity) from lineitem group by l_orderkey"
FORENSICS_SQL = "select l_returnflag, count(*) from lineitem group by l_returnflag"
# the churn and chaos runs' session (bench.bench_churn, bench.bench_chaos)
STREAM_RETRY = {"retry_policy": "TASK", "exchange_flush_rows": 512,
                "retry_initial_delay_s": 0.01, "retry_max_delay_s": 0.05}
SPECULATION = {"speculative_execution": True, "speculation_min_wall_s": 0.4,
               "speculation_multiplier": 2.0}
ROLLING_QUERIES = (1, 3, 6)
ROLLING_WORKERS = 3
ROLLING_TENANTS = 3
# seconds the load runs before the first drain, between cycles and after
# the last (the reference's dry run's)
ROLLING_SETTLE_S = 1.0
# dryrun_forensics: one retry, then FAILED; attempts fail fast under 500s
FORENSICS_PROPS = {"retry_policy": "QUERY", "query_retry_attempts": 1,
                   "retry_initial_delay_s": 0.02, "retry_max_delay_s": 0.1,
                   "exchange_error_budget_s": 1.0, "remote_task_error_budget_s": 1.0}


def device_memory(device) -> int:
    """``torch.cuda.memory_allocated`` with the resident page cache cleared
    and the collector run; 0 off the card."""
    import torch

    from presto_tpu_torch.ops.scan import RESIDENT_CACHE

    RESIDENT_CACHE.clear()
    gc.collect()
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(device)


def _results_token(ctx) -> int:
    """The token a results pull asks for (``.../results/{buffer}/{token}``)."""
    return int(ctx["path"].partition("?")[0].rstrip("/").rsplit("/", 1)[-1])


def _leaf_fragment(runner, sql: str):
    from presto_tpu_torch.cluster.scheduler import _remote_source_ids

    sub = runner.plan_sql(sql)
    return next(f.id for f in sub.fragments
                if not _remote_source_ids(f.root) and f.id != sub.root_fragment.id)


def _sorted_rows_match(got, want) -> bool:
    return same_rows(sorted(got, key=repr), sorted(want, key=repr))


class SpoolMonitor:
    """Reads every running worker's spool from ``GET /v1/status`` every 50
    ms while on, and once more at the end: ``peak`` is the highest
    ``spooledBytesPeak`` (the worker's own high-water mark of its replay
    spool, done tasks' too, so no poll has to land on it) or live
    ``spooledBytes`` read; ``window_peak`` the highest read inside
    ``window`` ([start, end] wall times, end 0 while open), where a
    high-water mark counts only if it rose since the worker's poll before
    (so it was reached within one poll of the window)."""

    def __init__(self, workers, window=None):
        self.workers, self.window = workers, window
        self.peak = self.window_peak = 0
        self._high = {}  # node id -> the high-water mark it read last

    def _poll(self):
        import urllib.request

        now = time.time()
        inside = bool(self.window and self.window[0] and now >= self.window[0]
                      and not self.window[1])
        for w in list(self.workers):
            if w.state == "SHUT_DOWN":
                continue
            try:
                with urllib.request.urlopen(f"{w.uri}/v1/status", timeout=1.0) as r:
                    st = json.loads(r.read())
            except OSError:  # a worker stopping under the poll
                continue
            live, high = int(st.get("spooledBytes") or 0), int(st.get("spooledBytesPeak") or 0)
            rose = high > self._high.get(w.node_id, 0)
            self._high[w.node_id] = high
            self.peak = max(self.peak, live, high)
            if inside:
                self.window_peak = max(self.window_peak, live, high if rose else 0)

    def _sample(self):
        while not self._stop.wait(0.05):
            self._poll()

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, name="spool-monitor", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10.0)
        self._poll()
        return False


def _lifecycle_run(cluster, sql: str, window=None):
    """One query on ``cluster`` with the launch counters set to 0 just
    before it; returns (result, wall, launches, per-worker launches, spool
    monitor)."""
    from presto_tpu_torch.ops import pallas_hash as ph

    with WorkerLaunches(cluster.every_worker) as per, \
            SpoolMonitor(cluster.workers, window) as spool:
        ph.insert_table.launches = 0
        ph.probe_table.launches = 0
        t0 = time.perf_counter()
        res = cluster.runner.execute(sql)
        wall = time.perf_counter() - t0
    launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
    return res, wall, launches, per.per_worker(), spool


def _check_memory(label: str, mem0: int, mem1: int) -> None:
    if mem1 > mem0:
        raise AssertionError(f"LIFECYCLE {label}: {mem1 - mem0} bytes of device memory left "
                             f"behind ({mem0} before, {mem1} after every worker stopped)")


def lifecycle_churn(device, schema: str = LIFECYCLE_SCHEMA, want=None, card: str = "") -> dict:
    """``dryrun_churn`` over ``bench_churn``: ``CHURN_SQL`` on two HTTP
    workers of ``device``, clean, then with a churn once a consumer asks
    for token >= 1 of the victim's leaf stream: a third worker joins and
    the victim is drained. Fails unless both runs' rows equal ``want``
    (the port's single-node rows by default), the churn run kept
    ``query_attempts == 1`` with ``task_retries >= 1``, the victim reached
    DRAINED having handed off a task, and device memory is no higher after
    the drive. Returns the record, keyed ``LIFECYCLE churn``."""
    import threading

    from presto_tpu_torch.cluster import faults

    if want is None:
        want = sql_runner(device, "pallas", schema).execute(CHURN_SQL).rows
    mem0 = device_memory(device)
    runs = {}
    for mode in ("clean", "churn"):
        cluster = CardCluster(device, 2, schema, announce_s=0.5, **STREAM_RETRY)
        drain, window, churned = {}, [0.0, 0.0], threading.Event()
        churner = []
        try:
            if mode == "churn":
                victim = min(cluster.workers, key=lambda w: w.node_id)

                def churn():
                    # off the handler thread: a worker joins, the victim drains
                    window[0] = time.time()
                    joiner = cluster.add_worker()
                    drain.update(cluster.runner.drain_worker(
                        victim.node_id, signal={"trigger": "churn"}), joiner=joiner.node_id)
                    window[1] = time.time()

                def trigger(ctx):
                    if _results_token(ctx) < 1 or churned.is_set():
                        return
                    churned.set()
                    churner.append(threading.Thread(target=churn, name="churn", daemon=True))
                    churner[0].start()
                inj = faults.FaultInjector(seed=29)
                inj.add("worker.results", faults.CALLBACK, node_id=victim.node_id,
                        task_re=rf"\.{_leaf_fragment(cluster.runner, CHURN_SQL)}\.0$",
                        times=None, callback=trigger)
                faults.install(inj)
            try:
                res, wall, launches, per, spool = _lifecycle_run(cluster, CHURN_SQL, window)
            finally:
                faults.clear()
            for t in churner:
                t.join(120.0)
        finally:
            cluster.close()
        runs[mode] = {"wall_s": wall, "rows_match": _sorted_rows_match(res.rows, want),
                      "query_attempts": res.stats.get("query_attempts"),
                      "task_retries": res.stats.get("task_retries"),
                      "spooled_bytes_peak": spool.peak, "launches": launches,
                      "per_worker": per}
        if mode == "churn":
            runs[mode].update(churn_fired=churned.is_set(), drain=drain,
                              spooled_bytes_peak_drain_window=spool.window_peak,
                              drain_s=window[1] - window[0])
    mem1 = device_memory(device)
    churn = runs["churn"]
    for mode, run in runs.items():
        if not run["rows_match"]:
            raise AssertionError(f"LIFECYCLE churn: the {mode} run's rows differ: {run}")
    if not churn["churn_fired"] or churn["query_attempts"] != 1 or churn["task_retries"] < 1:
        raise AssertionError(f"LIFECYCLE churn: the drain was not a mid-stream handoff: {churn}")
    if not churn["drain"].get("drained") or churn["drain"].get("tasks_handed_off", 0) < 1:
        raise AssertionError(f"LIFECYCLE churn: the victim never drained with a handoff: {churn}")
    _check_memory("churn", mem0, mem1)
    rec = {"schema": schema, **runs, "overhead_x": churn["wall_s"] / runs["clean"]["wall_s"],
           "memory_before": mem0, "memory_after": mem1, "launches": churn["launches"]}
    log(f"LIFECYCLE churn {schema} ({card}): rows equal to the single-node run's, clean and "
        f"churn; clean wall {runs['clean']['wall_s']:.4f}s, churn wall {churn['wall_s']:.4f}s "
        f"({rec['overhead_x']:.3f}x); {churn['drain']['joiner']} joined and "
        f"{churn['drain']['node']} drained in {churn['drain_s']:.4f}s: state "
        f"{churn['drain']['state']}, {churn['drain']['tasks_handed_off']} tasks handed off; "
        f"query_attempts {churn['query_attempts']}, task_retries {churn['task_retries']}; "
        f"spooled bytes peak {churn['spooled_bytes_peak']} (clean "
        f"{runs['clean']['spooled_bytes_peak']}), in the drain window "
        f"{churn['spooled_bytes_peak_drain_window']}; launches per worker clean "
        f"{runs['clean']['per_worker']}, churn {churn['per_worker']}; "
        f"torch.cuda.memory_allocated {mem0} before, {mem1} after")
    return {"LIFECYCLE churn": rec}


def lifecycle_rolling_upgrade(device, schema: str = LIFECYCLE_SCHEMA, want=None,
                              card: str = "") -> dict:
    """``dryrun_rolling_upgrade``: ``ROLLING_TENANTS`` tenants cycle TPC-H
    Q1, Q3 and Q6 on ``ROLLING_WORKERS`` HTTP workers under
    ``retry_policy=TASK`` while each worker in turn is drained, stopped,
    replaced by a fresh WorkerServer and announced in (``ROLLING_SETTLE_S``
    between cycles). Fails unless no query failed or mismatched ``want``
    (qid -> rows; the port's single-node rows by default; unordered, DOUBLE
    to 1e-6 as the reference's ``assert_rows_equal``), every query ran in
    one attempt (``query_attempts == 1``, as churn), every drain ended
    DRAINED, at least 3 queries completed, and device memory is no higher
    after the drive. Returns the record, keyed ``LIFECYCLE rolling
    upgrade``."""
    import threading

    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.utils.events import JOURNAL
    from presto_tpu_torch.utils.testing import assert_rows_equal

    if want is None:
        single = sql_runner(device, "pallas", schema)
        want = {q: single.execute(QUERIES[q]).rows for q in ROLLING_QUERIES}
        del single
    mem0 = device_memory(device)
    cluster = CardCluster(device, ROLLING_WORKERS, schema, announce_s=0.3,
                          retry_policy="TASK", retry_initial_delay_s=0.01,
                          retry_max_delay_s=0.05)
    done, lock = threading.Event(), threading.Lock()
    results = {"ok": 0, "failed": 0, "mismatched": 0, "errors": [], "walls": []}

    def tenant(tid: int):
        i = tid  # tenants stay out of phase
        while not done.is_set():
            q = ROLLING_QUERIES[i % len(ROLLING_QUERIES)]
            i += 1
            t0 = time.perf_counter()
            try:
                got = cluster.runner.execute(QUERIES[q])
            except Exception as e:  # noqa: BLE001 - a failure is the signal
                with lock:
                    results["failed"] += 1
                    results["errors"].append(f"q{q}: {e!r}"[:200])
                continue
            wall = time.perf_counter() - t0
            attempts = (got.stats.get("query_attempts"), got.stats.get("task_retries"))
            try:
                assert_rows_equal(got.rows, want[q], ordered=False)
            except AssertionError as e:
                with lock:
                    results["mismatched"] += 1
                    results["errors"].append(f"q{q}: {e}"[:200])
                continue
            with lock:
                results["ok"] += 1
                results["walls"].append((wall, q, *attempts))

    drains, tenants = [], []
    seq0 = JOURNAL.last_seq()
    try:
        with WorkerLaunches(cluster.every_worker) as per:
            ph.insert_table.launches = 0
            ph.probe_table.launches = 0
            t_start = time.perf_counter()
            tenants = [threading.Thread(target=tenant, args=(i,), name=f"tenant-{i}",
                                        daemon=True) for i in range(ROLLING_TENANTS)]
            for t in tenants:
                t.start()
            time.sleep(ROLLING_SETTLE_S)  # the load establishes before the first drain
            try:
                for idx, old in enumerate(list(cluster.workers)):
                    t0 = time.perf_counter()
                    d = cluster.runner.drain_worker(
                        old.node_id, signal={"trigger": "rolling-upgrade", "cycle": idx})
                    d["drain_s"] = time.perf_counter() - t0
                    drains.append(d)
                    old.stop()
                    cluster.add_worker(replacing=old)
                    time.sleep(ROLLING_SETTLE_S)  # the replacement takes load first
                time.sleep(ROLLING_SETTLE_S)
            finally:
                done.set()
                for t in tenants:
                    t.join(120.0)
            wall = time.perf_counter() - t_start
            launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
            by_worker = per.per_worker()
    finally:
        done.set()
        cluster.close()
    mem1 = device_memory(device)
    if any(t.is_alive() for t in tenants):
        raise AssertionError("LIFECYCLE rolling upgrade: a tenant did not end")
    if len(drains) != ROLLING_WORKERS or not all(d["drained"] for d in drains):
        raise AssertionError(f"LIFECYCLE rolling upgrade: drains {drains}")
    if results["failed"] or results["mismatched"] or results["ok"] < 3:
        raise AssertionError(f"LIFECYCLE rolling upgrade: {results}")
    # every query's (Q, wall, query_attempts, task_retries), in completion
    # order, and what lost each query attempt that was retried
    queries = [(q, round(w, 4), a, r) for w, q, a, r in results["walls"]]
    retry_causes = [e["message"][:240] for e in JOURNAL.events(
        since=seq0, kind="query.attempt_failed", limit=100)]
    if any(a != 1 for _q, _w, a, _r in queries):
        # a planned drain hands tasks off; it never costs a query attempt
        raise AssertionError(f"LIFECYCLE rolling upgrade: a query retried: {queries}; "
                             f"lost attempts {retry_causes}")
    _check_memory("rolling upgrade", mem0, mem1)
    rec = {"schema": schema, "workers_cycled": len(drains), "queries_ok": results["ok"],
           "queries_failed": results["failed"], "queries_mismatched": results["mismatched"],
           "tasks_handed_off": sum(d["tasks_handed_off"] for d in drains),
           "drain_s": [d["drain_s"] for d in drains], "wall_s": wall,
           "slowest_query": max(results["walls"]), "queries": queries,
           "retry_causes": retry_causes, "launches": launches,
           "per_worker": by_worker, "memory_before": mem0, "memory_after": mem1}
    log(f"LIFECYCLE rolling upgrade {schema} ({card}): {ROLLING_TENANTS} tenants cycling Q1, Q3, "
        f"Q6 on {ROLLING_WORKERS} workers, every worker drained, stopped and replaced; "
        f"{rec['queries_ok']} queries ok, {rec['queries_failed']} failed, "
        f"{rec['queries_mismatched']} mismatched; drains "
        f"{[(d['state'], d['tasks_handed_off'], round(d['drain_s'], 4)) for d in drains]} "
        f"(state, tasks handed off, seconds); slowest query Q{rec['slowest_query'][1]} "
        f"{rec['slowest_query'][0]:.4f}s (query_attempts {rec['slowest_query'][2]}, "
        f"task_retries {rec['slowest_query'][3]}); every query (Q, wall s, query_attempts, "
        f"task_retries) {queries}; query attempts lost to {retry_causes}; "
        f"wall {wall:.4f}s; launches {launches}, per worker {by_worker}; "
        f"torch.cuda.memory_allocated {mem0} before, {mem1} after")
    return {"LIFECYCLE rolling upgrade": rec}


def lifecycle_chaos(device, schema: str = LIFECYCLE_SCHEMA, want=None, card: str = "") -> dict:
    """``dryrun_chaos`` over ``bench_chaos``: ``CHAOS_SQL`` on two HTTP
    workers of ``device``, clean, with the victim killed once a consumer
    asks for token >= 1 of its leaf stream, and with that leaf task
    delayed 5 s under speculation. Fails unless every mode's rows equal
    ``want`` (the port's single-node rows by default), the kill run kept
    ``query_attempts == 1`` with ``task_retries >= 1`` and a spooled-bytes
    peak above 0, the speculation run speculated, and device memory is no
    higher after the drive. Returns the records, keyed ``LIFECYCLE chaos
    <mode>``."""
    from presto_tpu_torch.cluster import faults

    if want is None:
        want = sql_runner(device, "pallas", schema).execute(CHAOS_SQL).rows
    mem0 = device_memory(device)
    runs = {}
    for mode in ("clean", "mid_stream_kill", "speculation"):
        props = {**STREAM_RETRY, **(SPECULATION if mode == "speculation" else {})}
        cluster = CardCluster(device, 2, schema, announce_s=0.5, **props)
        try:
            leaf = _leaf_fragment(cluster.runner, CHAOS_SQL)
            inj = faults.FaultInjector(seed=23)
            if mode == "mid_stream_kill":
                victim = min(cluster.workers, key=lambda w: w.node_id)

                def kill(ctx):
                    # chunk 0 was delivered and acked: the recovery replays
                    # mid-stream from the spool
                    if _results_token(ctx) < 1 or victim.node_id in cluster.stopped:
                        return
                    cluster.stop_worker(victim)
                    raise faults.InjectedDisconnect("worker killed")
                inj.add("worker.results", faults.CALLBACK, node_id=victim.node_id,
                        task_re=rf"\.{leaf}\.0$", times=None, callback=kill)
            elif mode == "speculation":
                inj.add("worker.task_run", faults.DELAY, delay_s=5.0, times=1,
                        task_re=rf"\.{leaf}\.0$")
            faults.install(inj)
            try:
                res, wall, launches, per, spool = _lifecycle_run(cluster, CHAOS_SQL)
            finally:
                faults.clear()
        finally:
            cluster.close()
        runs[mode] = {"wall_s": wall, "rows_match": _sorted_rows_match(res.rows, want),
                      "query_attempts": res.stats.get("query_attempts"),
                      "task_retries": res.stats.get("task_retries"),
                      "task_speculations": res.stats.get("task_speculations"),
                      "faults_injected": res.stats.get("faults_injected"),
                      "spooled_bytes_peak": spool.peak, "launches": launches,
                      "per_worker": per}
    mem1 = device_memory(device)
    kill, spec = runs["mid_stream_kill"], runs["speculation"]
    for mode, run in runs.items():
        if not run["rows_match"]:
            raise AssertionError(f"LIFECYCLE chaos: the {mode} run's rows differ: {run}")
    if kill["query_attempts"] != 1 or kill["task_retries"] < 1 \
            or (kill["faults_injected"] or 0) < 1 or kill["spooled_bytes_peak"] <= 0:
        raise AssertionError(f"LIFECYCLE chaos: the kill was not a mid-stream replay: {kill}")
    if (spec["task_speculations"] or 0) < 1:
        raise AssertionError(f"LIFECYCLE chaos: the straggler never speculated: {spec}")
    _check_memory("chaos", mem0, mem1)
    for mode, run in runs.items():
        log(f"LIFECYCLE chaos {mode} {schema} ({card}): rows equal to the single-node run's; "
            f"wall {run['wall_s']:.4f}s ({run['wall_s'] / runs['clean']['wall_s']:.3f}x clean); "
            f"query_attempts {run['query_attempts']}, task_retries {run['task_retries']}, "
            f"task_speculations {run['task_speculations']}, faults_injected "
            f"{run['faults_injected']}; spooled bytes peak {run['spooled_bytes_peak']}; "
            f"launches {run['launches']}, per worker {run['per_worker']}")
    log(f"LIFECYCLE chaos memory ({card}): torch.cuda.memory_allocated {mem0} before, {mem1} "
        f"after every worker stopped")
    return {f"LIFECYCLE chaos {mode}": {"schema": schema, **run}
            for mode, run in runs.items()}


def lifecycle_forensics(device, schema: str = LIFECYCLE_SCHEMA, card: str = "") -> dict:
    """``dryrun_forensics``: ``FORENSICS_SQL`` through a PrestoTpuServer
    over a ClusterQueryRunner of two HTTP workers of ``device`` under
    ``retry_policy=QUERY`` and ``query_retry_attempts=1``; the victim is
    killed on its first results pull and the survivor answers 500. Fails
    unless the statement ends FAILED with ``hasFailureTrace``, ``GET
    /v1/query/{id}/trace`` is a valid coarse trace with ``http`` spans,
    ``GET /v1/events`` holds ``query.retry``, two or more
    ``query.attempt_failed`` with ``cq`` ids and ``task.created`` events
    whose task ids start with their query id, ``GET /v1/cluster/metrics``
    equals the live workers' raw snapshots merged by hand on every
    ``.p50/.p95/.p99/.count`` key, the Prometheus text carries the
    ``task_wall_s`` count, and device memory is no higher after the drive.
    Returns the record, keyed ``LIFECYCLE forensics``."""
    import urllib.request

    from presto_tpu_torch.cluster import faults
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.utils import trace
    from presto_tpu_torch.utils.events import JOURNAL
    from presto_tpu_torch.utils.metrics import flatten_raw, merge_raw_snapshots

    # the single-node run makes the query's lazily built device tables
    sql_runner(device, "pallas", schema).execute(FORENSICS_SQL)
    mem0 = device_memory(device)
    cluster = CardCluster(device, 2, schema, announce_s=0.5, **FORENSICS_PROPS)
    victim, survivor = cluster.workers

    def kill(ctx):
        cluster.stop_worker(victim)
        raise faults.InjectedDisconnect("worker killed")

    inj = faults.FaultInjector(seed=17)
    inj.add("worker.results", faults.CALLBACK, node_id=victim.node_id, times=1, callback=kill)
    inj.add("worker.results", faults.HTTP_ERROR, code=500, node_id=survivor.node_id,
            times=None)
    faults.install(inj)
    server = PrestoTpuServer(cluster.runner, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        seq0 = JOURNAL.last_seq()
        with WorkerLaunches(cluster.every_worker) as per:
            ph.insert_table.launches = 0
            ph.probe_table.launches = 0
            t0 = time.perf_counter()
            _st, payload = _http_json(f"{base}/v1/statement", "POST", FORENSICS_SQL.encode())
            qid = payload["id"]
            deadline = time.monotonic() + 120.0
            while True:
                _st, q = _http_json(f"{base}/v1/query/{qid}")
                if q["state"] in ("FAILED", "FINISHED"):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"LIFECYCLE forensics: {qid} never finished")
                time.sleep(0.1)
            wall = time.perf_counter() - t0
            # every attempt's tasks have ended, so no launch of the query comes later
            cluster.join_tasks()
            launches = {"insert": ph.insert_table.launches, "probe": ph.probe_table.launches}
            by_worker = per.per_worker()
        faults.clear()
        if q["state"] != "FAILED" or not q["hasFailureTrace"] or inj.rules[0].fired != 1:
            raise AssertionError(f"LIFECYCLE forensics: want FAILED with a failure trace after "
                                 f"one kill, got {q} (kills {inj.rules[0].fired})")
        _st, doc = _http_json(f"{base}/v1/query/{qid}/trace")
        events = doc.get("traceEvents")
        if not (isinstance(events, list) and events and doc["otherData"]["coarse"] is True
                and all({"name", "ph", "pid", "tid"} <= set(e) for e in events)):
            raise AssertionError("LIFECYCLE forensics: the forensic trace is malformed")
        cats = trace.span_categories(doc)
        if cats.get("http", 0) <= 0:
            raise AssertionError(f"LIFECYCLE forensics: no cluster HTTP spans: {cats}")

        _st, journal = _http_json(f"{base}/v1/events?since={seq0}&limit=4000")
        kinds = {}
        for e in journal["events"]:
            kinds.setdefault(e["kind"], []).append(e)
        attempts = kinds.get("query.attempt_failed", [])
        cluster_qids = {e["query_id"] for e in attempts}
        created = kinds.get("task.created", [])
        if not any(e["query_id"] == qid for e in kinds.get("query.failed", [])) \
                or not kinds.get("query.retry") or len(attempts) < 2 \
                or not all(c.startswith("cq") for c in cluster_qids) or not created \
                or not all(e["task_id"].startswith(e["query_id"] + ".") for e in created) \
                or not cluster_qids <= {e["query_id"] for e in created}:
            raise AssertionError(f"LIFECYCLE forensics: the journal lacks the failure's "
                                 f"events: { {k: len(v) for k, v in kinds.items()} }")

        raws = []
        for w in cluster.workers:
            if w.node_id not in cluster.stopped:
                with urllib.request.urlopen(f"{w.uri}/v1/metrics?raw=1", timeout=10) as r:
                    raws.append(json.loads(r.read()))
        oracle = flatten_raw(merge_raw_snapshots(raws))
        _st, merged = _http_json(f"{base}/v1/cluster/metrics")
        keys = [k for k in oracle if k.endswith((".p50", ".p95", ".p99", ".count"))]
        if not raws or merged["cluster.workers_merged"] != len(raws) \
                or not any(k.startswith("task.wall_s") for k in keys) \
                or any(merged.get(k) != oracle[k] for k in keys):
            raise AssertionError(f"LIFECYCLE forensics: /v1/cluster/metrics differs from the "
                                 f"hand-merged oracle of {len(raws)} workers")
        with urllib.request.urlopen(f"{base}/v1/cluster/metrics?format=prometheus",
                                    timeout=10) as r:
            prom = r.read().decode()
        if "presto_tpu_task_wall_s_seconds_count" not in prom:
            raise AssertionError("LIFECYCLE forensics: no task_wall_s count in the Prometheus "
                                 "text")
    finally:
        faults.clear()
        server.stop()
        cluster.close()
    mem1 = device_memory(device)
    _check_memory("forensics", mem0, mem1)
    rec = {"schema": schema, "state": q["state"], "wall_s": wall, "forensic_spans": cats,
           "retry_events": len(kinds["query.retry"]), "attempt_failures": len(attempts),
           "task_events": len(created), "merged_hist_keys": len(keys),
           "workers_merged": merged["cluster.workers_merged"], "memory_before": mem0,
           "memory_after": mem1, "launches": launches, "per_worker": by_worker}
    log(f"LIFECYCLE forensics {schema} ({card}): {qid} FAILED in {wall:.4f}s after "
        f"{len(attempts)} failed attempts ({sorted(cluster_qids)}); the forensic trace's spans "
        f"{cats}; {rec['retry_events']} query.retry, {len(created)} task.created events; "
        f"/v1/cluster/metrics equal to the hand-merged oracle on {len(keys)} keys of "
        f"{rec['workers_merged']} live workers; launches {launches}, per worker {by_worker}; "
        f"torch.cuda.memory_allocated {mem0} before, {mem1} after")
    return {"LIFECYCLE forensics": rec}


def run_lifecycle_phase(device, card: str = "", schema: str = LIFECYCLE_SCHEMA) -> dict:
    """Phase 26: the churn, rolling-upgrade, chaos and forensics drives at
    ``schema``; fails unless, on the card, both kernels launched over the
    phase (the rolling upgrade's Q3 builds and probes on every worker).
    Returns the records, keyed ``LIFECYCLE ...``."""
    out = {}
    out.update(lifecycle_churn(device, schema, card=card))
    out.update(lifecycle_rolling_upgrade(device, schema, card=card))
    out.update(lifecycle_chaos(device, schema, card=card))
    out.update(lifecycle_forensics(device, schema, card=card))
    total = {k: sum(rec["launches"][k] for rec in out.values()) for k in ("insert", "probe")}
    if device.type == "cuda" and not (total["insert"] and total["probe"]):
        raise AssertionError(f"LIFECYCLE: a kernel never launched over the phase: {total}")
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
    here = os.path.dirname(os.path.abspath(__file__))
    if sys.argv[1:2] == ["--host-rows"] and len(sys.argv) == 3:  # HostRows' child
        sys.path.insert(0, here)
        return host_rows_main(sys.argv[2])
    if sys.argv[1:2] == ["--sanitizers"] and len(sys.argv) == 5:  # phase 24's child
        sys.path.insert(0, here)
        return sanitizers_main(*sys.argv[2:])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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

    host = HostRows()  # the host halves of phases 11 and 12, beside the card's phases
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
        host_s = check_cpu_rows(device, host=host)
        phase_done("11 TPC-H on the host")
        ds_records = run_tpcds_phase(device)
        phase_done("12 TPC-DS on the card")
        host_s += check_ds_cpu_rows(device, host=host, card_rows={
            q: rec["oracle_schema_rows"] for q, rec in ds_records.items()
            if rec["oracle_schema"] == CPU_ROWS_SCHEMA})
        phase_done(f"12 TPC-DS on the host (11-12's host runs at {CPU_ROWS_SCHEMA}: "
                   f"{host_s:.1f}s in a child process beside the card's phases, "
                   f"{host.waited_s:.1f}s waited for)")
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
        file_records = run_file_phase(device)
        phase_done(f"18 file catalog (ORC at {ORC_SCHEMA}, RCFile at {RC_SCHEMA})")
        warehouse_records = run_warehouse_phase(device)
        phase_done(f"19 warehouse connectors (Parquet and ORC at {HIVE_FORMAT_SCHEMA})")
        federation_records = run_federation_phase(device, records[3]["rows"])
        phase_done(f"20 federated catalogs, access control (the kafka topic at {KAFKA_SCHEMA})")
        dist_records = run_distributed_phase(device, records, card)
        phase_done(f"21 distributed TPC-H on {DIST_WORKERS} workers (Q5 at {Q5_SCHEMA}, Q9 at "
                   f"{DIST_SCHEMA[9]})")
        cluster_records = run_cluster_phase(device, records, card)
        phase_done(f"22 the cluster: {CLUSTER_WORKERS} HTTP workers (Q5 at {Q5_SCHEMA}, Q9 at "
                   f"{CLUSTER_SCHEMA[9]}, the merge at {CLUSTER_MERGE_SCHEMA}, the fault run at "
                   f"{CLUSTER_FAULT_SCHEMA})")
        server_records = run_server_phase(device, records, card)
        phase_done(f"23 the server: /v1/statement, resource groups, dbapi, the verifier, the "
                   f"proxy, {SERVER_CLUSTER_WORKERS} announced workers")
        sanitizer_records = run_sanitizer_phase(device, records, card)
        phase_done(f"24 the sanitizers (Q1 and Q3 at SF1; the rest at {SAN_SMALL_SCHEMA})")
        hand_records = run_hand_stream_phase(device, records, card)
        phase_done(f"25 hand-built Q1/Q6 and the Q1 stream (SF1; a {STREAM_PREFIX_ROWS}-row "
                   f"prefix of SF{STREAM_PREFIX_SF:g})")
        lifecycle_records = run_lifecycle_phase(device, card)
        phase_done(f"26 the operator's lifecycle: churn, rolling upgrade, chaos, forensics (at "
                   f"{LIFECYCLE_SCHEMA})")
    except Exception:  # a failed phase: report it and print no result
        import traceback

        traceback.print_exc()
        return 1
    finally:
        host.close()
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
                    **{label: rec["launches"][k] for label, rec in flight_records.items()},
                    **{f"SQL FILE {label}": rec["launches"][k]
                       for label, rec in file_records.items()},
                    **{f"SQL {label}": rec["launches"][k]
                       for label, rec in warehouse_records.items()},
                    **{f"SQL {label}": rec["launches"][k]
                       for label, rec in federation_records.items()},
                    **{f"SQL {label}": rec["launches"][k]
                       for label, rec in dist_records.items()},
                    **{f"SQL {label}": rec["launches"][k]
                       for label, rec in cluster_records.items()},
                    **{label: rec["launches"][k] for label, rec in server_records.items()},
                    **{label: rec["launches"][k] for label, rec in sanitizer_records.items()},
                    **{label: rec["launches"][k] for label, rec in hand_records.items()},
                    **{label: rec["launches"][k]
                       for label, rec in lifecycle_records.items()}}}
               for k, m in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
