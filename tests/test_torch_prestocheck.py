"""The static gate over the port: every pass of ``tools/prestocheck`` over
``presto_tpu_torch/``, with no baseline file, must report no finding.

A finding is fixed in the port, or carries the inline suppression the
reference carries at the same site with the reference's justification
(``test_every_port_suppression_mirrors_the_reference``). The reference's
own gate (tests/test_prestocheck.py) and its baseline are separate and
untouched.

Also here: the driver's poll loop, which the gate's ``sleep-poll`` pass
flagged and which now waits as the reference's does (through
``cluster/retry.Backoff``, only while BLOCKED): a driver blocked on a
future wakes, finishes, and gives the reference's rows.
"""
import os
import re
import threading
from concurrent.futures import Future

import numpy as np
import pytest

from presto_tpu import block as ref_block
from presto_tpu.ops.operator import Operator as RefOperator
from presto_tpu.ops.operator import OperatorContext as RefContext
from presto_tpu.types import BIGINT as REF_BIGINT
from presto_tpu.utils import testing as ref_testing
from presto_tpu_torch import block
from presto_tpu_torch.ops.operator import Operator, OperatorContext
from presto_tpu_torch.types import BIGINT
from presto_tpu_torch.utils import testing
from tools.prestocheck import all_pass_ids, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "presto_tpu_torch")
REF = os.path.join(REPO, "presto_tpu")
_SUPPRESSION = re.compile(r"#\s*prestocheck:\s*ignore\[([^\]]+)\](.*)$")


@pytest.fixture(scope="module")
def gate():
    """One run of every pass over the port, with no baseline."""
    return run([PORT], baseline_path=None)


def test_gate_scans_the_whole_port(gate):
    n_py = sum(len([f for f in files if f.endswith(".py")])
               for _, _, files in os.walk(PORT))
    assert gate.n_files == n_py
    assert set(gate.pass_wall_s) >= set(all_pass_ids())


@pytest.mark.parametrize("pass_id", all_pass_ids())
def test_port_has_no_new_findings(gate, pass_id):
    found = [f"{f.relpath()}:{f.line}: {f.message}" for f in gate.new_findings
             if f.pass_id == pass_id]
    assert found == [], "\n".join(found)


def _suppressions(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(base, name)
            with open(path, encoding="utf-8") as f:
                for line in f:
                    m = _SUPPRESSION.search(line)
                    if m:
                        out.setdefault(os.path.relpath(path, root), []).append(
                            (m.group(1), m.group(2).strip()))
    return out


def test_every_port_suppression_mirrors_the_reference():
    port, ref = _suppressions(PORT), _suppressions(REF)
    assert port, "the port carries no suppression at all"
    strays = [(path, s) for path, items in sorted(port.items()) for s in items
              if s not in ref.get(path, [])]
    assert strays == [], strays


def test_sleep_poll_is_fixed_not_suppressed():
    path = os.path.join(PORT, "exec", "driver.py")
    assert run([path], select=["sleep-poll"], baseline_path=None).findings == []
    with open(path, encoding="utf-8") as f:
        assert "ignore[sleep-poll]" not in f.read()


# ------------------------------------------------- the driver's blocked wait

ROWS = [np.arange(i * 8, i * 8 + 8, dtype=np.int64) for i in range(3)]


def _gated_source(base, make_page, gate_future):
    """A source operator of either package that is BLOCKED until the
    future is done, then emits its pages."""

    class GatedSource(base):
        def __init__(self, context):
            super().__init__(context)
            self.pages = [make_page(a) for a in ROWS]
            self.blocked_polls = 0

        @property
        def output_types(self):
            return []

        def needs_input(self):
            return False

        def add_input(self, page):
            raise AssertionError("a source takes no input")

        def is_blocked(self):
            if gate_future.done():
                return None

            def ready():
                self.blocked_polls += 1
                return gate_future.done()
            return ready

        def get_output(self):
            if not self.pages:
                self.finish()
                return None
            return self.pages.pop(0)

    return GatedSource


def _drive(base, context, make_page, sink, drive):
    fut = Future()
    source = _gated_source(base, make_page, fut)(context)
    timer = threading.Timer(0.05, fut.set_result, args=(None,))
    timer.start()
    try:
        drive([source, sink])
    finally:
        timer.cancel()
        timer.join(5.0)
    assert not timer.is_alive() and fut.done()
    return source, sink.rows()


def test_blocked_driver_wakes_and_matches_reference():
    port_src, port_rows = _drive(
        Operator, OperatorContext(1, "GatedSource"),
        lambda a: block.page_from_arrays([BIGINT], [a], device="cpu"),
        testing.PageConsumerOperator(OperatorContext(2, "Sink"), [BIGINT]),
        testing.drive_operators)
    ref_src, ref_rows = _drive(
        RefOperator, RefContext(1, "GatedSource"),
        lambda a: ref_block.page_from_arrays([REF_BIGINT], [a]),
        ref_testing.PageConsumerOperator(RefContext(2, "Sink"), [REF_BIGINT]),
        ref_testing.drive_operators)
    assert port_rows == ref_rows == [[int(v)] for a in ROWS for v in a]
    # the driver parked on the future: it polled, and not at a fixed spin
    assert 1 <= port_src.blocked_polls < 1000
    assert port_src.context.stats.blocked_ns > 0
