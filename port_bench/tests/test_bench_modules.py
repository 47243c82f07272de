"""What the benchmark loads: no JAX and no JAX package anywhere in a run,
and nothing of the program in the reference; no result without a card."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "port_bench")


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_forbidden_names_are_compared_whole():
    from port_bench import harness

    assert harness.forbidden_modules(
        ["wgpu_physics_engine_torch.ops", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "wgpu_physics_engine_tpu.ops.x", "flax"]) == \
        ["flax", "jax", "wgpu_physics_engine_tpu"]


def test_a_run_loads_no_forbidden_module():
    code = """
import sys, time
sys.path.insert(0, "port_bench/tests")
from conftest import small_spec, WORKLOADS
from port_bench import harness
for w in WORKLOADS:
    harness.run_cell(small_spec(w), 5, 0.2, False, "cpu", time.perf_counter())
    for m in harness.cell_spec(w)["per_layer"]:
        harness.load_metric(m["name"])
print(harness.forbidden_modules())
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_program():
    code = """
import sys
import port_bench.reference.cloth, port_bench.reference.render
import port_bench.reference.codec
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("wgpu_physics_engine_torch", "wgpu_physics_engine_tpu", "jax")))
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(BENCH, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert not m.startswith(("wgpu_physics_engine", "jax")), \
                    (name, m)
                assert node.__class__ is ast.Import or node.level == 0 \
                    or m == "", (name, m)


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "cloth256-sim", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout == ""
