"""Every cell on the card, as the benchmark's command runs it (a short
window). Run on the card: ``python -m pytest portbench/tests -m gpu``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import registry

from portbench_cpu import CELLS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name, "--seed",
         str(2**31 + 17), "--seconds", "2", "--trace", str(trace)],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=1200,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    cell = registry.load_cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert {m.name for m in want} <= set(result["metrics"])
