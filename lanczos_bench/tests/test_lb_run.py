"""run.py refuses to run without a card, and in a checkout that holds
only the benchmark; nothing under lanczos_bench/ imports JAX or the JAX
package, and the reference imports nothing of the program."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from lanczos_bench.harness import cell, spec

ROOT = spec.ROOT_DIR
BENCH_DIR = spec.BENCH_DIR
ARGS = ["--workload", "ba1M.topk20.f32", "--seed", str(2**31 + 1),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "lanczos_bench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ,
                                                CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_it_fails_and_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "lanczos_bench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def _sources(top):
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


@pytest.mark.parametrize("path", sorted(_sources(BENCH_DIR)),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax_and_a_plain_reference(path):
    tops = set(_imports(path))
    assert not tops & set(cell.FORBIDDEN), tops
    if os.sep + "reference" + os.sep in path:
        assert tops <= {"__future__", "numpy", "scipy"}, tops


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    assert cell.PROGRAM == "tpu_lanczos_torch"
    monkeypatch.setitem(sys.modules, "tpu_lanczos_torch_like", sys)
    assert "tpu_lanczos" not in cell.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "tpu_lanczos.core", sys)
    assert "tpu_lanczos" in cell.loaded_forbidden()
