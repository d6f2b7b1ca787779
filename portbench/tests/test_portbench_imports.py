"""What the benchmark loads, and how it fails without a card or without
the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "persia_tpu"}
ALL = ["portbench.run", "portbench.harness", "portbench.control",
       "portbench.program", "portbench.trace"]
PLAIN = ["portbench.reference.dlrm", "portbench.check", "portbench.weights",
         "portbench.generator", "portbench.counts", "portbench.arch",
         "portbench.registry"]


def _loaded(modules, extra=""):
    code = (f"import sys\nimport {', '.join(modules)}\n{extra}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    readers = "\n".join(
        f"registry.reader({e['name']!r})" for e in
        registry.manifest()["per_layer"])
    loaded = _loaded(ALL + ["portbench.registry"],
                     "from portbench import registry\n" + readers)
    assert not loaded & FORBIDDEN
    assert "persia_tpu_torch" in loaded  # program.py, the system under test


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(PLAIN)
    assert not loaded & (FORBIDDEN | {"persia_tpu_torch"})


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         registry.manifest()["workloads"][0]["name"], "--seed", "12345678901",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(registry.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: no result, card or not (the program is missing)."""
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    for p in registry.manifest()["paths"]:
        shutil.copytree(registry.ROOT / p, tmp_path / p)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("from portbench import harness, registry\n"
            "cell = registry.load_cell(registry.manifest()['workloads'][0]"
            "['name'])\nharness.setup(cell, 1, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "persia_tpu_torch" in out.stderr


def test_result_line_is_json_with_checks_last():
    from portbench import harness
    from portbench_cpu import tiny_cell

    name = registry.manifest()["workloads"][0]["name"]
    result, lines = harness.run_cell(tiny_cell(name), 5, 0.1, False, "cpu")
    text = json.dumps(result)
    assert list(json.loads(text)) == ["correct", "attempted", "failed",
                                      "metrics", "device", "checks"]
    assert all(line.startswith("check ") for line in lines)
