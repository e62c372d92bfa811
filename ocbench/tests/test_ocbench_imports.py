"""What the benchmark loads: neither JAX nor the JAX package, by whole
top-level names; the reference nothing of the program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0][
    "name"]
ARCHS = sorted((HERE / "archs").glob("*.py"))


def test_importing_the_harness_loads_no_jax():
    code = ("import json, sys; import ocbench.run, ocbench.harness, "
            "ocbench.control, ocbench.knee; from ocbench.reference import "
            "qwen3; from ocbench import archs; files = sorted(m.__file__ "
            "for ms in archs.modules(archs.DIR).values() for m in ms); "
            "print(json.dumps([files, sorted(sys.modules)]))")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    files, mods = json.loads(out.stdout)
    assert set(files) == {str(p) for p in ARCHS if p.name != "__init__.py"}
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops and "ocbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    from ocbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in run.loaded_forbidden()


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")))
def test_the_reference_imports_nothing_of_the_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] in {"torch", "numpy", "math",
                                       "__future__"}, (path.name, n)


def _imports(nodes, in_function=False):
    """(top-level name imported, whether inside a function) of every
    import under ``nodes``."""
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from ((a.name.split(".")[0], in_function)
                        for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], in_function
        yield from _imports(ast.iter_child_nodes(node), in_function or
                            isinstance(node, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)))


@pytest.mark.parametrize("path", ARCHS, ids=lambda p: p.name)
def test_an_architecture_module_imports_the_program_only_when_called(path):
    """Nothing of JAX or the JAX package anywhere, and nothing of the
    program at module level: the harness loads every architecture module
    to find one."""
    for top, in_function in _imports([ast.parse(path.read_text())]):
        assert top not in {"jax", "jaxlib", "flax", "repro"}, top
        assert in_function or top != "repro_torch", top


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    no result, a non-zero exit."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "ocbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "ocbench/run.py", "--workload",
         CELL, "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "ocbench/run.py", "--workload",
         CELL, "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
