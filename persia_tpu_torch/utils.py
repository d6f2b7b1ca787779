"""Small helpers (``persia_tpu/utils.py``).

``load_yaml`` / ``dump_yaml`` read and write through the port's own YAML
subset (:mod:`persia_tpu_torch._yaml`), not PyYAML.
"""

import os
import subprocess
import time
from typing import Any, Optional

import numpy as np

from persia_tpu_torch import _yaml


def load_yaml(path: str) -> Any:
    if not os.path.exists(path):
        raise FileNotFoundError(f"yaml file not found: {path}")
    with open(path, "r") as f:
        return _yaml.load(f.read())


def dump_yaml(content: Any, path: str):
    with open(path, "w") as f:
        f.write(_yaml.dump(content))


def write_addr_file(addr: str, path: str) -> None:
    """Atomically publish a bound server address for a waiting parent
    (the race-free alternative to probing a free port before spawn)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(addr)
    os.replace(tmp, path)


def wait_addr_file(path: str, timeout: float = 60.0,
                   proc: Optional[subprocess.Popen] = None) -> str:
    """Poll for an addr-file written by :func:`write_addr_file`; if
    ``proc`` is given, fail fast when the child exits first."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc is not None and proc.poll() is not None:
            raise TimeoutError(
                f"server exited (rc={proc.returncode}) before "
                f"publishing {path}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no addr-file at {path} after {timeout}s")
        time.sleep(0.05)
    with open(path) as f:
        return f.read().strip()


def roc_auc(labels, preds) -> float:
    """Rank-based ROC AUC (Mann-Whitney U) with average ranks for ties."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    n_pos = int((labels == 1).sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(preds, kind="mergesort")
    ranks = np.empty(len(preds), dtype=np.float64)
    ranks[order] = np.arange(1, len(preds) + 1)
    sorted_preds = preds[order]
    i = 0
    while i < len(sorted_preds):
        j = i
        while j + 1 < len(sorted_preds) and \
                sorted_preds[j + 1] == sorted_preds[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    rank_sum_pos = ranks[labels == 1].sum()
    return float((rank_sum_pos - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))
