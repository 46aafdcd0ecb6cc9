"""presto_tpu_torch, chip_smoke.py and the measurement scripts
port_walls.py, file_walls.py, dist_walls.py and cluster_walls.py import neither jax
nor presto_tpu, nor the repo's ``tools`` (which imports presto_tpu), nor
pyarrow or zstandard (the card's machine has neither: the file
formats import ``zstandard`` only where a zstd page is met).

The server's entry points refuse CUDA where there is none unless asked for
the CPU: ``PrestoTpuServer()``, ``python -m presto_tpu_torch.server`` and
the worker's ``main``."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

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
for script in ('chip_smoke', 'port_walls', 'file_walls', 'dist_walls', 'cluster_walls'):
    spec = importlib.util.spec_from_file_location(script, script + '.py')
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'presto_tpu', 'tools', 'pyarrow',
                                     'zstandard'))
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
    # the file catalog and its formats
    assert {"presto_tpu_torch.connectors.file", "presto_tpu_torch.formats.parquet",
            "presto_tpu_torch.formats.parquet_writer", "presto_tpu_torch.formats.orc",
            "presto_tpu_torch.formats.orc_writer",
            "presto_tpu_torch.formats.rcfile"} <= set(res["modules"])
    # the warehouse connectors and grouped execution
    assert {"presto_tpu_torch.connectors.hive", "presto_tpu_torch.exec.grouped",
            "presto_tpu_torch.connectors.raptor"} <= set(res["modules"])
    # the federated catalogs, access control, transactions and event listeners
    assert {"presto_tpu_torch.spi.decoder", "presto_tpu_torch.connectors.kafka",
            "presto_tpu_torch.connectors.dbapi", "presto_tpu_torch.connectors.remote",
            "presto_tpu_torch.security", "presto_tpu_torch.transaction",
            "presto_tpu_torch.spi.eventlistener"} <= set(res["modules"])
    # the multi-worker engine: the mesh, the exchanges, the stage programs,
    # the distributed planning and the runner
    assert {"presto_tpu_torch.parallel", "presto_tpu_torch.parallel.mesh",
            "presto_tpu_torch.parallel.exchange", "presto_tpu_torch.parallel.distributed",
            "presto_tpu_torch.parallel.streaming_exchange", "presto_tpu_torch.parallel.runner",
            "presto_tpu_torch.sql.planner.add_exchanges",
            "presto_tpu_torch.sql.planner.fragmenter",
            "presto_tpu_torch.models.kernels"} <= set(res["modules"])
    # the cluster: every module of presto_tpu/cluster/
    assert {f"presto_tpu_torch.cluster.{m}" for m in (
        "retry", "codec", "serde", "buffers", "discovery", "exchange_client", "task",
        "worker", "scheduler", "coordinator", "memory_manager", "autoscaler",
        "faults")} <= set(res["modules"])
    # the server, its clients and the verifier
    assert {"presto_tpu_torch.server", "presto_tpu_torch.server.config",
            "presto_tpu_torch.server.http_server", "presto_tpu_torch.server.protocol",
            "presto_tpu_torch.server.proxy", "presto_tpu_torch.server.resource_groups",
            "presto_tpu_torch.server.__main__", "presto_tpu_torch.client",
            "presto_tpu_torch.client.dbapi", "presto_tpu_torch.cli",
            "presto_tpu_torch.cli.__main__", "presto_tpu_torch.verifier"} <= set(res["modules"])
    # the runtime sanitizers
    assert {"presto_tpu_torch.utils.locksan", "presto_tpu_torch.utils.leaksan",
            "presto_tpu_torch.utils.compilesan"} <= set(res["modules"])


_ARMED = """
import json
import presto_tpu_torch
from presto_tpu_torch.exec import shared_pools
from presto_tpu_torch.utils import compilesan, leaksan, locksan
print(json.dumps({"armed": [locksan.enabled(), leaksan.enabled(), compilesan.enabled()],
                  "pools": sorted(type(c).__name__ for c in shared_pools.pool_locks().values())}))
"""


@pytest.mark.parametrize("prefix", ["PRESTO_TPU_TORCH_", "PRESTO_TPU_"])
def test_sanitizers_arm_from_the_ports_own_variables(prefix):
    """``PRESTO_TPU_TORCH_{LOCK,LEAK,COMPILE}SAN=1`` arm the port's three
    sanitizers at import, the lock sanitizer before the shared pools
    allocate their conditions; the reference's variables arm none."""
    env = {k: v for k, v in os.environ.items() if "SAN" not in k}
    env.update({f"{prefix}{s}SAN": "1" for s in ("LOCK", "LEAK", "COMPILE")},
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _ARMED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    ours = prefix == "PRESTO_TPU_TORCH_"
    assert res["armed"] == [ours] * 3
    assert res["pools"] == ["_SanCondition" if ours else "Condition"] * 2


def test_native_library_is_the_ports_own():
    """``libpcol`` builds from the port's own source into the port's own
    ignored build directory, never the reference's."""
    from presto_tpu_torch import native

    here = os.path.dirname(native.__file__)
    assert native._SRC == os.path.join(here, "pcol.cpp") and os.path.exists(native._SRC)
    assert native._SO == os.path.join(here, "build", "libpcol.so")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "presto_tpu_torch/native/build/" in f.read().split()


def test_server_package_files_present():
    here = os.path.join(ROOT, "presto_tpu_torch", "server")
    for name in ("config.py", "http_server.py", "protocol.py", "proxy.py",
                 "resource_groups.py", "webui.html", "__init__.py", "__main__.py"):
        assert os.path.isfile(os.path.join(here, name)), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has CUDA")
def test_server_entry_points_refuse_cuda_without_it():
    from presto_tpu_torch.cluster import worker
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.server import main as server_main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrestoTpuServer(port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server_main(["--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.main(["--port", "0"])
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "presto_tpu_torch.server", "--port", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert "listening" not in out.stdout
