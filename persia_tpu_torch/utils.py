"""Small helpers (``persia_tpu/utils.py``)."""

import os

import numpy as np


def write_addr_file(addr: str, path: str) -> None:
    """Atomically publish a bound server address for a waiting parent
    (the race-free alternative to probing a free port before spawn)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(addr)
    os.replace(tmp, path)


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
