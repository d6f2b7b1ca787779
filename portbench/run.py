"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
check compared beside its limit); the check's lines end standard error.
Without a CUDA card, with fewer cards than the cell asks for, without
the program, or with jax, jaxlib, flax, optax or the JAX package
``persia_tpu`` loaded once the window has closed, it exits non-zero and
prints no result. ``--seconds`` is the measured window; ``setup_s``
counts from the start of this process.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# compared by whole top-level name: the port's name begins with the JAX
# package's
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "persia_tpu")
# CUDA's own cache of just-in-time code, kept inside the checkout at a
# fixed path so that a later run finds it
CACHE_DIR = ROOT / ".portbench_cache"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE_DIR / "nv"))

    from portbench import registry

    cell = registry.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is "
              "False); the benchmark never runs on the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from portbench import harness

    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda", STARTED)
    found = forbidden_modules()
    if found:
        print(f"portbench: {found} loaded in the benchmark's process",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
