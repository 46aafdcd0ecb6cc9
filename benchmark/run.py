"""The benchmark of presto_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card. It serves the
cell's TPC-H configuration through the program's server on CUDA device 0,
drives the cell's query streams from a client process for ``--seconds``,
compares every answer with the plain numpy reference, and prints the
numbers compared (standard error) and one JSON result line (standard
output, last). ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, the device's busy time and a
breakdown. It exits non-zero, printing no result, without CUDA, without
enough cards, without the program beside it, or if JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the package's modules by their full names; the benchmark's own
    # directory off the path, so nothing of it imports under a bare name
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    from benchmark.core import harness, spec

    try:
        cell = spec.cell(args.workload)
    except spec.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not (ROOT / "presto_tpu_torch" / "__init__.py").exists():
        print("benchmark: presto_tpu_torch is not beside the benchmark", file=sys.stderr)
        return 3
    import torch

    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        return 4
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 4
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda:0", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
