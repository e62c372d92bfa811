"""The port's examples (`examples/torch_*.py`) run on the CPU, each in a
subprocess through a wrapper that reports, at exit, whether `jax` or the
reference package `repro` was imported.

* Each prints the strings `tests/test_examples.py` asserts for its
  reference example; the three model examples get ``--device cpu``.
* The four simulator examples print exactly what their reference examples
  print (the same numbers, the 24.81G Table A9 cell among them).
* Without ``--device``, a model example runs on the card; without one it
  exits non-zero with `build_model`'s message (nothing falls back to the
  CPU).
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs the example as __main__, then names every module of jax or repro
# that the process holds
_WRAP = r"""
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
try:
    runpy.run_path(path, run_name="__main__")
finally:
    held = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print("REFERENCE MODULES:", ",".join(held) or "none")
"""

MODEL = ("torch_quickstart.py", "torch_hybrid_prefill.py",
         "torch_train_ft.py")
EXPECT = {
    "torch_quickstart.py": [
        "OK: cached-prefix logits == from-scratch logits"],
    "torch_multi_tenant_scheduling.py": ["Workload A", "cal-stall-opt",
                                         "24.81G"],
    "torch_layerwise_overlap.py": ["B_req"],
    "torch_cluster_trace.py": [
        "OK: JSON replay reproduces bit-identical metrics", "cal-stall-opt"],
    "torch_trace_waterfall.py": [
        "OK: attribution telescopes exactly", "OK: exported",
        "Chrome trace events",
        "OK: tracer attached changed no simulated timestamp", "track r",
        "wire", "compute"],
    "torch_hybrid_prefill.py": [
        "OK: hybrid <= min(pure-fetch, pure-recompute)",
        "OK: hybrid-prefill logits == no-cache logits"],
    "torch_train_ft.py": ["OK: training survived failure and converged"],
}


def _run(name, *args, timeout=540):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-c", _WRAP, os.path.join(REPO, "examples", name),
         *args], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=timeout)


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n == "torch_train_ft.py"
    else n for n in EXPECT])
def test_example_runs_on_the_cpu(name):
    out = _run(name, *(("--device", "cpu") if name in MODEL else ()))
    assert out.returncode == 0, out.stderr[-3000:]
    for s in EXPECT[name]:
        assert s in out.stdout, s
    assert "REFERENCE MODULES: none" in out.stdout


@pytest.mark.parametrize("name", ["torch_cluster_trace.py",
                                  "torch_layerwise_overlap.py",
                                  "torch_multi_tenant_scheduling.py",
                                  "torch_trace_waterfall.py"])
def test_simulator_example_prints_the_reference_output(name):
    ref = name[len("torch_"):]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    want = subprocess.run([sys.executable, os.path.join(REPO, "examples",
                                                        ref)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert want.returncode == 0, want.stderr[-3000:]
    got = _run(name)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout == want.stdout + "REFERENCE MODULES: none\n"


def test_model_example_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the example runs on it")
    out = _run("torch_quickstart.py")
    assert out.returncode != 0
    assert "requested but CUDA is not available" in out.stderr
    assert "OK:" not in out.stdout
