"""Import checks by whole top-level names: nothing the benchmark runs on the
chip loads JAX or the JAX package, and the reference loads nothing of the
program either."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "presto_tpu"}
PROGRAM = {"presto_tpu_torch"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts]


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        bad = set(_top_level_imports(path)) & JAX
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        bad = set(_top_level_imports(path)) & (JAX | PROGRAM)
        assert not bad, (path, bad)


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    loaded = _loaded_after(
        "from benchmark.reference import db, common\n"
        "from benchmark.core import spec\n"
        "for q in ('q01', 'q03', 'q06', 'q09', 'q13', 'q14', 'q22'): spec.reference(q)")
    assert not loaded & (JAX | PROGRAM), loaded & (JAX | PROGRAM)


def test_a_served_run_loads_no_jax():
    """A whole run of a cell at tiny on the CPU, in a fresh process, then
    the harness's own check (``forbidden_modules``) by whole names."""
    loaded = _loaded_after(
        "from benchmark.core import harness\n"
        "r = harness.run_cell('sf10_join', 5, 1.0, True, device='cpu', scale=harness.TINY)\n"
        "assert harness.forbidden_modules() == [], harness.forbidden_modules()")
    assert "presto_tpu_torch" in loaded
    assert not loaded & JAX, loaded & JAX


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark.core import harness

    monkeypatch.setitem(sys.modules, "presto_tpu_torch_lookalike", sys)
    assert "presto_tpu_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "presto_tpu.ops", sys)
    assert "presto_tpu.ops" in harness.forbidden_modules()
