"""``tools/persialint`` over the port: no finding.

The lint's passes (lock discipline, knob registry use, and the rest) run
on ``persia_tpu_torch/`` as they run on the JAX package; a justified
exception carries an inline ``persialint: ok[<rule>]`` with its reason.
``--check-knob-docs`` is left out: ``docs/KNOBS.md`` documents the JAX
package's registry.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_persialint_reports_nothing_on_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "tools.persialint", "persia_tpu_torch/"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new finding(s)" in proc.stdout + proc.stderr
