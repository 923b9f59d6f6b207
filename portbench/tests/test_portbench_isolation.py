"""What the benchmark may load: never jax, jaxlib, flax or the JAX package
(whose name the port's begins with, so top-level names are compared
whole), never the old JAX benchmark's files, and in the reference nothing
of the program at all."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "orbslam_birdview_tpu"}
PROGRAM = "orbslam_birdview_tpu_torch"
# the JAX package's benchmark and its records, which nothing here reads
OLD_BENCH = ("BENCH" + "_r", "bench" + "_pipeline", "/bench" + ".py")


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and node.value.startswith(PROGRAM)):
            names.add(node.value)   # a module named to importlib
    return {n.split(".")[0] for n in names if n}


def _sources():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    assert not _imports(path) & FORBIDDEN
    text = path.read_text()
    assert not any(name in text for name in OLD_BENCH)


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert PROGRAM not in _imports(path), path


def test_top_level_names_compared_whole():
    assert PROGRAM.startswith("orbslam_birdview_tpu")
    assert harness.forbidden_modules() == []
    sys.modules["orbslam_birdview_tpu_torchish"] = sys.modules[__name__]
    try:
        assert harness.forbidden_modules() == []
    finally:
        del sys.modules["orbslam_birdview_tpu_torchish"]


def test_a_process_of_the_harness_loads_none():
    """Every module a run imports, and the program's System, in a fresh
    process: no forbidden top-level name in sys.modules."""
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import run, control\n"
        "from portbench import cells, harness, capture, trace, arith\n"
        "from portbench.reference import compare\n"
        "bench = cells.benchmark()\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    cells.module('metrics', m['name'])\n"
        "cells.module('traffic', 'street')\n"
        "from orbslam_birdview_tpu_torch.api.system import System\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(ROOT), str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in top
    assert not top & FORBIDDEN


def test_no_card_no_result(tmp_path):
    """Without a CUDA device a run exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "bird_street",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
