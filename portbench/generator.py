"""The one traffic generator: a pool of batches drawn from a traffic file.

A traffic file (``portbench/traffic/<name>.json``) gives:

- ``mode``: ``train`` (the window runs training steps) or ``eval`` (it
  scores batches);
- ``batch``: samples a batch; ``pool``: distinct batches drawn in set-up,
  which the window cycles through;
- ``ids``: the law of a table's raw ids, ``{"law": "zipf", "alpha": a}``
  (an exact truncated Zipf(a) over the table's rows, ranks scattered over
  the ids 1..V by a seeded permutation) or ``{"law": "uniform"}`` (ids
  uniform over 1..V);
- ``bag``: ``{"min": m, "max": S}``: a sample's ids in a table number
  uniformly m..S, padded to S with the padding id 0;
- ``dense``: ``{"law": "uniform"}`` ([0, 1)) or ``{"law": "log1p_count",
  "max": M}``: log(1 + c) of a count c in 0..M whose log is spread evenly,
  c = floor((M + 1) ** u) - 1 for u uniform in [0, 1) (nonnegative, as
  facebookresearch/dlrm's Criteo processing gives its count features);
- ``labels``: ``{"positive": p}``, Bernoulli(p) labels;
- ``warm_steps``: steps (or scored batches) of set-up after the first
  three, ``trace_steps``: steps of a traced run's profiled window,
  ``sync_steps``: training steps timed stage by stage in a traced run.

Batches are drawn on the device from the run's seed in a few large calls
and kept in pinned host memory: the program moves each batch to the card
as a trainer fed by a loader does. The Zipf arithmetic is
``persia_tpu_torch/workloads/generator.py``'s ``zipf_cdf`` /
``zipf_ranks``, copied here onto the device.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from portbench import weights
from portbench.arch import Arch

TRAFFIC_STREAM = 2  # weights.generator's stream for the batches


def zipf_cdf(vocab: int, alpha: float, device) -> torch.Tensor:
    """The CDF of the truncated Zipf(alpha) law over ranks 1..vocab."""
    p = torch.arange(1, vocab + 1, dtype=torch.float64,
                     device=device).pow_(-float(alpha))
    return torch.cumsum(p / p.sum(), 0)


def zipf_ranks(gen: torch.Generator, cdf: torch.Tensor, size) -> torch.Tensor:
    """0-based ranks by inverse-CDF sampling, clipped because the float
    cumsum can leave the last entry below 1."""
    u = torch.rand(size, generator=gen, dtype=torch.float64,
                   device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def field_names(a: Arch) -> List[str]:
    return [f"C{i + 1}" for i in range(a.fields)]


@dataclass
class Pool:
    """``pool`` batches: dense (N, B, num_dense) float32, ids (N, fields,
    B, S) int32 (field-major, so each field's ids are contiguous), labels
    (N, B, 1) float32."""

    dense: torch.Tensor
    ids: torch.Tensor
    labels: torch.Tensor
    names: List[str]

    def __len__(self) -> int:
        return self.dense.shape[0]

    @property
    def batch_size(self) -> int:
        return self.dense.shape[1]

    def batch(self, j: int) -> Tuple[List[torch.Tensor],
                                     Dict[str, torch.Tensor], torch.Tensor]:
        """Batch ``j`` (mod the pool) as the program takes it: ([dense],
        {field: ids}, label)."""
        j %= len(self)
        ids = self.ids[j]
        return ([self.dense[j]],
                {n: ids[k] for k, n in enumerate(self.names)},
                self.labels[j])

    def half(self) -> "Pool":
        """The same batches with their second half left out."""
        b = self.batch_size // 2
        return Pool(self.dense[:, :b], self.ids[:, :, :b],
                    self.labels[:, :b], self.names)


def draw_dense(law: dict, size, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(size, generator=gen, device=device)
    if law["law"] == "uniform":
        return u
    if law["law"] == "log1p_count":
        counts = torch.exp_(u.mul_(math.log(int(law["max"]) + 1))).floor_()
        return counts.log_()  # log(1 + c) with c = counts - 1
    raise ValueError(f"unknown dense law {law['law']!r}")


def make_pool(a: Arch, traffic: dict, seed: int, device) -> Pool:
    device = torch.device(device)
    gen = weights.generator(device, seed, TRAFFIC_STREAM)
    n, b = int(traffic["pool"]), int(traffic["batch"])
    smin, s = int(traffic["bag"]["min"]), int(traffic["bag"]["max"])
    if not 1 <= smin <= s:
        raise ValueError(f"bag sizes {smin}..{s}")
    dense = draw_dense(traffic["dense"], (n, b, a.num_dense), gen, device)
    labels = (torch.rand((n, b, 1), generator=gen, device=device)
              < float(traffic["labels"]["positive"])).float()
    ids = torch.empty((n, a.fields, b, s), dtype=torch.int32, device=device)
    id_law = traffic["ids"]["law"]
    slots = torch.arange(s, device=device)
    for k, vocab in enumerate(a.rows):
        if id_law == "zipf":
            ranks = zipf_ranks(gen, zipf_cdf(vocab, traffic["ids"]["alpha"],
                                             device), (n, b, s))
            raw = torch.randperm(vocab, generator=gen, device=device)[
                ranks] + 1
        elif id_law == "uniform":
            raw = torch.randint(1, vocab + 1, (n, b, s), generator=gen,
                                device=device)
        else:
            raise ValueError(f"unknown id law {id_law!r}")
        if smin < s:
            sizes = torch.randint(smin, s + 1, (n, b, 1), generator=gen,
                                  device=device)
            raw = torch.where(slots < sizes, raw, 0)
        ids[:, k] = raw
    if device.type == "cuda":  # pinned, so that each move is asynchronous
        dense, ids, labels = (
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            for t in (dense, ids, labels))
    return Pool(dense, ids, labels, field_names(a))
