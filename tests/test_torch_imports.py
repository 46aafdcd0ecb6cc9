"""presto_tpu_torch and chip_smoke.py import neither jax nor presto_tpu."""
import os
import pkgutil
import subprocess
import sys

import presto_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import presto_tpu_torch
names = ['presto_tpu_torch'] + [m.name for m in pkgutil.walk_packages(
    presto_tpu_torch.__path__, 'presto_tpu_torch.')]
for n in names:
    importlib.import_module(n)
import importlib.util
spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'presto_tpu'))
print(json.dumps({'modules': names, 'bad': bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    expected = {m.name for m in pkgutil.walk_packages(presto_tpu_torch.__path__,
                                                      "presto_tpu_torch.")}
    assert expected <= set(res["modules"])
    assert "presto_tpu_torch.ops.pallas_hash" in res["modules"]
    # the flight recorder, the disk rung and their helpers
    assert {"presto_tpu_torch.utils.trace", "presto_tpu_torch.utils.metrics",
            "presto_tpu_torch.exec.spill", "presto_tpu_torch.formats.pcol",
            "presto_tpu_torch.native", "presto_tpu_torch.cluster.faults"} <= set(res["modules"])


def test_native_library_is_the_ports_own():
    """``libpcol`` builds from the port's own source into the port's own
    ignored build directory, never the reference's."""
    from presto_tpu_torch import native

    here = os.path.dirname(native.__file__)
    assert native._SRC == os.path.join(here, "pcol.cpp") and os.path.exists(native._SRC)
    assert native._SO == os.path.join(here, "build", "libpcol.so")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "presto_tpu_torch/native/build/" in f.read().split()
