"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names are
compared whole (the port ``repro_torch`` begins with the JAX package's
name ``repro``)."""
from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from bench.run import BANNED, ROOT, banned_modules


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*parts):
    return sorted(glob.glob(os.path.join(ROOT, "bench", *parts, "*.py")))


ALL_SOURCES = sorted(glob.glob(os.path.join(ROOT, "bench", "**", "*.py"),
                               recursive=True))


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.kernels", "torch"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.engine"], ["repro"]),
    (["jaxlib.xla_client", "jaxtyping"], ["jaxlib"]),
    (["flax.linen", "jax"], ["flax", "jax"]),
])
def test_banned_names_compared_whole(monkeypatch, names, found):
    clean = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] not in BANNED}
    monkeypatch.setattr(sys, "modules", clean)
    for n in names:
        monkeypatch.setitem(sys.modules, n, object())
    assert banned_modules() == found


@pytest.mark.parametrize("path", ALL_SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax(path):
    assert not set(_imports(path)) & set(BANNED)


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert "repro_torch" not in names
    assert names <= {"__future__", "contextlib", "math", "torch", "bench"}
    assert all(n.startswith("bench.reference")
               for n in _from_bench(path))


def _from_bench(path):
    tree = ast.parse(open(path).read(), path)
    return [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 0
            and n.module.split(".")[0] == "bench"]


def test_a_run_loads_no_jax():
    """A whole small run on the CPU, in a process of its own, leaves no
    module of JAX or of the JAX package loaded."""
    code = (
        "import json, sys, time\n"
        "from bench.tests.small import small_cell\n"
        "from bench.run import run_cell, banned_modules\n"
        "out = run_cell(small_cell('mamba2-780m.fl4.b2s2048'), 5, 0.1,"
        " False, device='cpu', t_start=time.perf_counter())\n"
        "print(json.dumps([out['correct'], banned_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules})]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "src")]), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, found, loaded = json.loads(res.stdout.splitlines()[-1])
    assert correct and found == []
    assert "repro_torch" in loaded
