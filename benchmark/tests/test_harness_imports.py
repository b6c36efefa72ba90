"""What the harness loads: no JAX, no JAX package, and a reference that
takes nothing from the program."""

import ast
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

from benchmark import harness

BENCH = ROOT / "benchmark"


def _imports(path: Path) -> set:
    """Top-level names of the modules ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _imports(path)
        assert "geograypher_tpu_torch" not in names, path
        source = path.read_text()
        assert "benchmark.system" not in source and "import system" not in source, path


def test_names_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("geograypher_tpu", None)
        sys.modules["geograypher_tpu_torch_probe"] = sys
        assert "geograypher_tpu" not in harness.forbidden_modules()
        sys.modules["geograypher_tpu.probe"] = sys
        assert harness.forbidden_modules() == ["geograypher_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """Everything ``run.py`` imports, and every entry, label source, mesh
    kind and metric reader, in a fresh process: none of the forbidden
    top-level names is loaded."""
    code = (
        "import sys; from pathlib import Path; sys.path.insert(0, %r)\n"
        "from benchmark import harness, system, control, cells\n"
        "for kind in ('entries', 'labels', 'meshes', 'metrics'):\n"
        "    for p in (Path(%r) / kind).glob('*.py'): cells.plugin(kind, p.stem)\n"
        "print(harness.forbidden_modules())\n" % (str(ROOT), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
