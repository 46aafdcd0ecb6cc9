"""The port's server distribution (``presto_tpu_torch/dist.py``), the
counterpart of ``tests/test_dist.py``: the tarball builds and unpacks, its
launcher is executable, the package in ``lib/`` carries its sources and
nothing built, and the unpacked server boots on the CPU, answers a
statement and stops."""
import os
import socket
import subprocess
import sys
import tarfile
import time
import urllib.request

from presto_tpu_torch.client import StatementClient
from presto_tpu_torch.dist import NAME

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_and_unpack(tmp_path) -> str:
    out = subprocess.run([sys.executable, "-m", "presto_tpu_torch.dist", "--out",
                          str(tmp_path / "out")], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    tar_path = out.stderr.split()[0]
    assert os.path.isfile(tar_path)
    with tarfile.open(tar_path) as tar:
        names = tar.getnames()
        tar.extractall(tmp_path / "unpacked", filter="data")
    assert f"{NAME}/bin/launcher" in names
    return str(tmp_path / "unpacked" / NAME)


def _launcher(base: str, *args, env=None):
    return subprocess.run([os.path.join(base, "bin", "launcher"), *args], capture_output=True,
                          text=True, timeout=60, env=env, cwd=base)


def _ended(pid: int) -> bool:
    """Gone, or ended and not yet reaped."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] == "Z"
    except FileNotFoundError:
        return True


def test_dist_builds_with_sources_and_nothing_built(tmp_path):
    base = _build_and_unpack(tmp_path)
    assert os.access(os.path.join(base, "bin", "launcher"), os.X_OK)
    lib = os.path.join(base, "lib", "presto_tpu_torch")
    for rel in ("runner.py", "kernels/hash_table.cu", "native/pcol.cpp",
                "server/webui.html"):
        assert os.path.isfile(os.path.join(lib, rel)), rel
    for d in ("etc/catalog", "plugin"):
        assert os.path.isdir(os.path.join(base, d)), d
    assert os.listdir(os.path.join(base, "plugin")) == []
    with open(os.path.join(base, "etc", "catalog", "tpch.properties")) as f:
        assert f.read().strip() == "connector.name=tpch"
    built = [os.path.join(dirpath, n) for dirpath, dirs, files in os.walk(base)
             for n in dirs + files
             if n.endswith((".so", ".pyc")) or n in ("build", "__pycache__")]
    assert built == []
    st = _launcher(base, "status")
    assert st.returncode == 3 and "not running" in st.stdout


def test_unpacked_server_boots_answers_and_stops(tmp_path):
    """``bin/launcher start --device cpu`` on a free port of the unpacked
    ``etc/config.properties`` serves ``select count(*) from nation`` through
    the port's StatementClient; ``stop`` ends the process and ``status``
    exits 3 again. The server imports the package from ``lib/`` alone: no
    PYTHONPATH and a working directory outside the repo."""
    base = _build_and_unpack(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = os.path.join(base, "etc", "config.properties")
    with open(conf) as f:
        text = f.read().replace("http-server.http.port=8080", f"http-server.http.port={port}")
    with open(conf, "w") as f:
        f.write(text)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    started = _launcher(base, "start", "--device", "cpu", env=env)
    assert started.returncode == 0 and "started" in started.stdout, started
    try:
        with open(os.path.join(base, "var", "run", "server.pid")) as f:
            pid = int(f.read())
        uri = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 90.0
        while True:
            try:
                with urllib.request.urlopen(f"{uri}/v1/info", timeout=2.0) as r:
                    assert r.status == 200
                break
            except OSError:
                assert time.monotonic() < deadline, open(
                    os.path.join(base, "var", "log", "server.log")).read()[-2000:]
                time.sleep(0.2)
        assert _launcher(base, "status", env=env).returncode == 0
        assert list(StatementClient(uri, "select count(*) from nation").rows()) == [[25]]
    finally:
        stopped = _launcher(base, "stop", env=env)
    assert stopped.returncode == 0 and "stopped" in stopped.stdout
    assert _ended(pid)
    st = _launcher(base, "status", env=env)
    assert st.returncode == 3 and "not running" in st.stdout
    with open(os.path.join(base, "var", "log", "server.log")) as f:
        assert "Traceback" not in f.read()
