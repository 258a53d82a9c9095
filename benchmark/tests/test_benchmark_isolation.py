"""Nothing the harness loads is JAX, flax or the JAX package (top-level
names compared whole: ``ssd_tpu_torch`` is not ``ssd_tpu``), and the plain
reference imports nothing of the measured program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ssd_tpu"}

PROBE = r"""
import importlib, importlib.util, json, sys
from pathlib import Path
bench = Path(sys.argv[1])
sys.path.insert(0, str(bench.parent))
for sub in ("harness", "drivers", "reference", "tools"):
    for f in sorted((bench / sub).glob("*.py")):
        if f.stem != "__init__":
            importlib.import_module(f"benchmark.{sub}.{f.stem}")
for f in sorted((bench / "metrics").glob("*.py")):
    spec = importlib.util.spec_from_file_location("m_" + f.stem.replace(".", "_"), f)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
importlib.import_module("benchmark.run")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE, str(BENCH)], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "ssd_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        assert not imports(f) & (FORBIDDEN | {"ssd_tpu_torch"}), f


def test_no_benchmark_file_imports_jax():
    files = [f for f in sorted(BENCH.rglob("*.py"))
             if not {"_out", "_cache"} & set(f.relative_to(BENCH).parts)]  # run outputs, not sources
    assert len(files) > 20
    for f in files:
        assert not imports(f) & FORBIDDEN, f


def test_run_refuses_when_jax_is_loaded(monkeypatch):
    from benchmark import run as br

    monkeypatch.setitem(sys.modules, "jax", sys)
    assert br.forbidden_loaded() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    assert br.forbidden_loaded() == []
