"""The numbers that decide ``correct``, each against its limit.

Training, from three steps that the program ran in set-up through the
window's own call and feed, against the reference's three steps from the
same weights and batches:

- ``loss_gap``: the largest relative gap between a step's losses;
- ``grad_gap``: by the worst leaf, the gap between the norms of the
  first step's gradients as the optimizer got them, over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same of the norms of each leaf's change after the
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by rounding alone);
- ``change1_gap``: the same of each leaf's change after the first step,
  for a cell where the later steps' noise makes ``change_gap`` swing from
  seed to seed (a seed whose tower gradients nearly cancel).

Scoring: ``pred_gap``, the largest absolute gap between a prediction the
window produced and the reference's, over every sample of the last
scoring of each pool batch.

A cell's limits file names the numbers it holds.

A number that is not finite is never within its limit.
"""

import math
import statistics
from typing import Dict, Sequence

# a leaf whose reference gradient is below this share of the median
# leaf's is left out of change_gap
MOVED_SHARE = 1e-3


def _worst(values) -> float:
    """The largest value, or NaN when any is not finite."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.nan
    return max(values)


def _gaps(prog: Sequence[float], ref: Sequence[float],
          counted: Sequence[bool]) -> Dict[int, float]:
    """Each counted leaf's gap."""
    floor = statistics.median(r for r, c in zip(ref, counted) if c)
    return {i: abs(p - r) / max(r, floor)
            for i, (p, r, c) in enumerate(zip(prog, ref, counted)) if c}


def _by_worst(gaps: Dict[int, float]):
    return _worst(gaps.values()), max(gaps, key=gaps.__getitem__)


def train_numbers(prog, ref) -> Dict[str, float]:
    """``prog`` and ``ref`` are (losses, grad norms, change norms after
    the first step, change norms after the last)."""
    return {k: v for k, (v, _) in _train(prog, ref).items()}


def worst_leaves(prog, ref) -> Dict[str, int]:
    """The leaf index behind each number taken by the worst leaf."""
    return {k: leaf for k, (_, leaf) in _train(prog, ref).items()
            if leaf is not None}


def _train(prog, ref):
    """Each number with the leaf behind it (None for the loss)."""
    (pl, pg, p1, pc), (rl, rg, r1, rc) = prog, ref
    if [len(x) for x in prog] != [len(x) for x in ref]:
        raise ValueError("the program's and the reference's readings differ "
                         "in length")
    g_med = statistics.median(rg)
    moved = [g >= MOVED_SHARE * g_med for g in rg]
    return {
        "loss_gap": (_worst(abs(p - r) / abs(r) for p, r in zip(pl, rl)),
                     None),
        "grad_gap": _by_worst(_gaps(pg, rg, [True] * len(rg))),
        "change1_gap": _by_worst(_gaps(p1, r1, moved)),
        "change_gap": _by_worst(_gaps(pc, rc, moved)),
    }


def eval_numbers(prog_preds, ref_preds) -> Dict[str, float]:
    """Predictions as lists of host tensors, one a pool batch scored."""
    if len(prog_preds) != len(ref_preds) or not prog_preds:
        raise ValueError("no predictions to compare")
    return {"pred_gap": _worst(
        float((p.reshape(-1).double() - r.reshape(-1).double()).abs().max())
        for p, r in zip(prog_preds, ref_preds))}


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


def lines(numbers: Dict[str, float], limits: Dict[str, float]):
    """Each number beside its limit, one line each."""
    return [f"check {k}: {numbers[k]!r} (limit {limits[k]!r}) "
            + ("ok" if within({k: numbers[k]}, {k: limits[k]}) else "OVER")
            for k in limits]
