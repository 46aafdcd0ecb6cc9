"""The benchmark's own tests: run with ``python -m pytest benchmark/tests``.

Tests that need the card carry the ``cuda`` marker and decide inside the
test whether there is one."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# one intra-op thread a test process, and in the processes it starts: with
# several pytest workers on the CPU, each sizing its pool to every core, a
# query at ``tiny`` slowed from a fifth of a second to tens of seconds and
# the short windows of these tests answered nothing
os.environ["OMP_NUM_THREADS"] = "1"


def pytest_sessionstart(session):
    import torch

    torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")
