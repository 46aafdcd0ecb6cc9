"""The comparison must refuse the control and the faults a run can have.

- the control: the reference in float32 in the program's place;
- an answer altered where it is produced (the server's row encoding);
- half of each answer's rows left out.
A cell of this benchmark has no training step, no state carried across
steps and no exchange between chips, so those faults do not apply."""
import json
from pathlib import Path

import pytest

from benchmark import control
from benchmark.core import harness, spec

SF1_MIX = json.loads((Path(__file__).parent / "sf1_mix_entries.json").read_text())


@pytest.mark.parametrize("cell", ["sf1_mix", "sf10_join"])
def test_the_float32_control_is_not_correct(cell, monkeypatch):
    # the SF1 cell's entries, kept out of BENCHMARK.json (PERF.md), put back
    bench = spec.benchmark()
    bench["configs"].append(SF1_MIX["config"])
    bench["workloads"].append(SF1_MIX["workload"])
    monkeypatch.setattr(spec, "benchmark", lambda root=spec.ROOT: bench)
    for seed in (1, 2, 3):
        v = control.readings(cell, seed, scale=harness.TINY)
        assert v["correct"] is False
        assert v["checks"]["wrong_results"]["value"] > 0


def _alter_one_value(server):
    from presto_tpu_torch.server.protocol import QueryManager

    encode = QueryManager._to_json_row

    def altered(row):
        out = encode(row)
        if out and isinstance(out[-1], int) and not isinstance(out[-1], bool):
            out[-1] += 1
        elif out and isinstance(out[-1], str):
            out[-1] = out[-1] + "1"
        return out

    server.manager._to_json_row = altered


def _drop_half_the_rows(server):
    from presto_tpu_torch.server.protocol import QueryManager

    manager = server.manager
    payload = QueryManager.results_payload

    def half(info, token, base_uri):
        out = payload(manager, info, token, base_uri)
        if out.get("data"):
            out["data"] = out["data"][: (len(out["data"]) + 1) // 2]
        return out

    manager.results_payload = half


@pytest.mark.parametrize("fault", [_alter_one_value, _drop_half_the_rows])
def test_a_fault_in_the_served_path_is_not_correct(fault):
    r = harness.run_cell("sf10_join", 9, 1.0, False, device="cpu", scale=harness.TINY, fault=fault)
    assert r["correct"] is False
    assert r["checks"]["wrong_results"]["value"] > 0


def test_the_same_run_without_a_fault_is_correct():
    r = harness.run_cell("sf10_join", 9, 1.0, False, device="cpu", scale=harness.TINY)
    assert r["correct"] is True
