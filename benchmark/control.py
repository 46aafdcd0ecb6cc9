"""The control of the comparison: the reference in float32 in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the statements a run of the cell sends (every
stream's statement of every query), answers each with the plain reference
computed in float32 (``reference/common.py``'s ``FLOAT32``), and judges
those answers against the exact reference as a run's answers are judged.
It prints each seed's numbers beside their limits; a sound comparison
reads every seed as not correct. It needs no card and loads nothing of the
program.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, scale=None) -> dict:
    """The control's readings for one seed; ``scale`` = (schema, scale
    factor) in place of the configuration's, as ``harness.run_cell``."""
    from benchmark.core import compare, harness, spec, traffic
    from benchmark.reference.common import FLOAT32
    from benchmark.reference.db import Database

    c = spec.cell(cell)
    _, sf = scale or harness.scale_of(c["config"])
    queries = spec.queries_of(c["traffic"])
    statements = [s for st in traffic.streams(c["traffic"], queries, seed) for s in st]
    answers = [{"query": s.query, "params": s.params} for s in statements]
    wanted = harness.reference_rows(answers, queries, sf)
    db = Database(sf, cache_dir=str(harness.REFERENCE_CACHE))
    for a in answers:
        a["rows"] = json.loads(json.dumps(
            spec.reference(a["query"]).run(db, dict(a["params"]), FLOAT32), default=str))
    return compare.judge(answers, queries, wanted)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        v = readings(args.workload, seed)
        failed_all &= not v["correct"]
        print(f"CONTROL {args.workload} seed {seed}: correct {v['correct']}, " + ", ".join(
            f"{k} {c['value']!r} (limit {c['limit']!r})" for k, c in v["checks"].items()),
            flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
