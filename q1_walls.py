#!/usr/bin/env python3
"""TPC-H Q1 and Q6 at SF10 through the PyTorch port on one NVIDIA GPU: the
figures that ``chip_smoke.py`` phase 25 takes at SF1 or over a prefix.

    python3 q1_walls.py [--schema sf10] [--steps stream,hand,step]
    python3 q1_walls.py --schema tiny --device cpu    # a rehearsal on the CPU

- ``stream``: ``models/kernels.q1_stream`` over all of ``lineitem`` (three
  producers, 2^21-row batches) to its end; the rows must be the table's
  (60,012,192 at SF10) and the finish dict equal to numpy's int64 sums
  over the same generator.
- ``hand``: the hand-built Q1 and Q6 (``models/hand_queries.run_query``)
  through the operator path, twice each (the first cold, the second
  replaying the connector's generation cache), rows equal to numpy oracles
  over the same generator.
- ``step``: the device ms (``chip_smoke.device_ms``) of
  ``models/kernels.q1_stream_step`` on a 2^21-row batch, against the same
  widening reduced as ``q1_partials`` reduced it before its adds were
  spread over lanes (``segments_step``: six ``index_add_`` into 7
  segments), in turns (segments, step, step, segments); both sums equal.

One numpy pass over the generator, in 2^17-order chunks on four threads,
serves as the oracle of the first two steps. Prints a ``Q1WALLS`` JSON line per
step, each with the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them. Exits 2
without CUDA unless ``--device cpu``. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from decimal import Decimal

import numpy as np


def oracle(sf: float):
    """Q1's sums and Q6's rows in numpy over all of lineitem, and its rows."""
    import chip_smoke as cs

    sums = {k: np.zeros(6, dtype=np.int64) for k in cs.Q1_SUMS}
    revenue, q6_rows, n = 0, 0, 0
    for li in cs.lineitem_chunks(sf, cs.Q1_COLUMNS):
        cs.add_sums(sums, cs.q1_sums_np(li))
        sd, disc = li["l_shipdate"], li["l_discount"].astype(np.int64)
        keep = (sd >= cs.civil_day(1994, 1, 1)) & (sd < cs.civil_day(1995, 1, 1)) & \
            (disc >= 5) & (disc <= 7) & (li["l_quantity"] < 2400)
        revenue += int((li["l_extendedprice"][keep].astype(np.int64) * disc[keep]).sum())
        q6_rows += int(keep.sum())
        n += len(sd)
    q6 = [[Decimal(revenue) / 10 ** 4 if q6_rows else None]]
    return sums, {1: cs.q1_rows_from_sums(sums), 6: q6}, n


def segments_step(ep, qty, sd, disc, tax, rf, ls, acc):
    """The A/B baseline of ``q1_stream_step``: the same widening and
    columns, each reduced by an int64 ``index_add_`` of its own into 7
    segments, every add of a segment on one address."""
    import torch

    from presto_tpu_torch.models import kernels as mk

    i64 = torch.int64
    keep = sd.to(torch.int32) <= mk.Q1_CUTOFF_DAYS
    gid = torch.where(keep, rf.to(i64) * mk.Q1_N_STATUS + ls.to(i64), 6)
    zero = torch.zeros((), dtype=i64, device=ep.device)
    e, d = ep.to(i64), disc.to(i64)
    disc_price = e * (100 - d)
    charge = disc_price * (100 + tax.to(i64))
    for i, c in enumerate((qty.to(i64), e, disc_price, charge, d, keep.to(i64))):
        seg = torch.zeros(7, dtype=i64, device=ep.device)
        acc[i] += seg.index_add_(0, gid, torch.where(keep, c, zero))[:6]
    return acc


def step_ms(device, sf: float, batch_rows: int, reps: int = 20) -> dict:
    """Device ms of the step and of its seven-segment baseline on one
    batch, in turns; fails unless one call of each gives the same sums."""
    import torch

    import chip_smoke as cs
    from presto_tpu_torch.models import kernels as mk

    args = tuple(torch.from_numpy(a).to(device) for a in mk.resident_batch(batch_rows, sf))
    forms = (segments_step, mk.q1_stream_step)
    one = []
    for f in forms:
        acc = torch.zeros((6, 6), dtype=torch.int64, device=device)
        one.append(mk.q1_stream_finish(f(*args, acc)))
    if any(not np.array_equal(one[0][k], one[1][k]) for k in one[0]):
        raise AssertionError(f"the two reductions differ: {one}")
    times: dict = {}
    for f in (segments_step, mk.q1_stream_step, mk.q1_stream_step, segments_step):
        acc = torch.zeros((6, 6), dtype=torch.int64, device=device)
        ms = cs.device_ms(f, (*args, acc), reps, counted=False) if device.type == "cuda" else \
            cs.time_ms(lambda: f(*args, acc), 2, device)
        times.setdefault(f.__name__, []).append(ms)
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schema", default="sf10")
    ap.add_argument("--steps", default="stream,hand,step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("q1_walls: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from presto_tpu_torch.connectors.tpch import generator as g
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.models import hand_queries as hq
    from presto_tpu_torch.models import kernels as mk

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        card = smi.splitlines()[0] if smi else "nvidia-smi gave nothing"
    else:
        card = "cpu"
    sf = SCHEMAS[args.schema]
    steps = args.steps.split(",")
    if "step" in steps:
        batch_rows = 1 << 21
        times = step_ms(device, sf, batch_rows)
        print("Q1WALLS " + json.dumps({
            "step": "step", "batch_rows": batch_rows, "sums_equal": True,
            "device_ms" if on_card else "host_ms": times,
            "bound_ms": batch_rows * cs.WIRE_BYTES_PER_ROW / cs.HBM_RATE * 1e3,
            "card": card}), flush=True)
    if "stream" in steps or "hand" in steps:
        t0 = time.perf_counter()
        sums, want, n_rows = oracle(sf)
        oracle_s = time.perf_counter() - t0
        if n_rows != g.lineitem_row_count(sf):
            raise AssertionError(f"the oracle read {n_rows} rows of "
                                 f"{g.lineitem_row_count(sf)}")
        print(f"ORACLE {args.schema}: {n_rows} rows in {oracle_s:.1f}s", flush=True)
    if "stream" in steps:
        rows, wall, stall, first_s, fin = mk.q1_stream(sf, seconds_budget=3600.0,
                                                       device=device)
        if rows != n_rows:
            raise AssertionError(f"q1_stream dispatched {rows} rows of {n_rows}")
        cs.check_sums(f"q1_stream {args.schema}", fin, sums)
        print("Q1WALLS " + json.dumps({
            "step": "stream", "schema": args.schema, "rows": rows, "wall_s": wall,
            "rows_per_s": rows / wall, "gen_stall_s": stall, "first_dispatch_s": first_s,
            "producers": 3, "batch_rows": 1 << 21, "finish_exact": True, "card": card}),
            flush=True)
    if "hand" in steps:
        for q in (1, 6):
            builder = getattr(hq, f"build_q{q}")
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                rows = hq.run_query(builder, args.schema, device=device)
                if on_card:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if not cs.same_rows(rows, want[q]):
                    raise AssertionError(f"hand-built Q{q} {args.schema}: rows differ from the "
                                         f"numpy oracle:\n{rows}\n{want[q]}")
            src = hq.source_rows(f"q{q}", args.schema)
            print("Q1WALLS " + json.dumps({
                "step": f"hand q{q}", "schema": args.schema, "rows_equal_oracle": True,
                "walls_s": walls, "source_rows": src,
                "source_rows_per_s": [src / w for w in walls], "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
