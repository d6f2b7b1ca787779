"""Session / sequence traffic: a copy of the ``seqrec`` generator of
``persia_tpu/workloads/generator.py``.

The stream is a pure function of its arguments: the same ``seed`` yields
a batch stream byte-identical to the JAX package's (the parity tests pin
it), so the port can make real traffic without the JAX package.
"""

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from persia_tpu_torch.data.batch import (
    IDTypeFeature,
    IDTypeFeatureWithSingleID,
    Label,
    NonIDTypeFeature,
    PersiaBatch,
)


def zipf_cdf(vocab: int, alpha: float) -> np.ndarray:
    """CDF of the truncated zipf(alpha) law over ranks 1..vocab (exact
    inverse-CDF sampling: ``rng.zipf`` would fold its unbounded tail back
    through ``%`` and distort the head)."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(alpha)
    return np.cumsum(p / p.sum())


def zipf_ranks(rng: np.random.Generator, cdf: np.ndarray,
               size) -> np.ndarray:
    """0-based zipf ranks drawn through a precomputed :func:`zipf_cdf`;
    clipped because the float cumsum can leave cdf[-1] below 1."""
    return np.searchsorted(cdf, rng.random(size)).clip(
        max=len(cdf) - 1).astype(np.int64)


@dataclass(frozen=True)
class SeqRecSpec:
    """Session-traffic shape: an item sign space shared by the ragged
    history slots and the target slot, small profile vocabs, hidden
    cluster structure."""

    item_vocab: int = 20_000
    profile_vocabs: Tuple[int, ...] = (500, 64)
    n_clusters: int = 16
    t_hist: int = 20
    last_n: int = 4
    alpha: float = 1.05
    num_dense: int = 4
    dim: int = 16

    def all_signs(self) -> np.ndarray:
        """Every sign the stream can emit: items 1..item_vocab, then the
        profile ranges (the rows a serving PS must hold)."""
        return np.arange(
            1, self.item_vocab + 1 + sum(self.profile_vocabs),
            dtype=np.uint64)


SEQ_PROFILE_SLOTS = ("user_geo", "user_device")
SEQ_HISTORY_SLOT = "recent_items"
SEQ_CLICKS_SLOT = "recent_clicks"
SEQ_TARGET_SLOT = "target_item"


def seqrec_batches(
    num_samples: int,
    batch_size: int = 512,
    seed: int = 0,
    spec: Optional[SeqRecSpec] = None,
    requires_grad: bool = True,
) -> Iterator[PersiaBatch]:
    """Sessions whose label hides in the history: every item belongs to a
    hidden cluster (``id % n_clusters``); "engaged" sessions draw their
    history from the target item's cluster and click with p=0.85,
    "browsing" sessions draw zipf-at-large and click with p=0.15."""
    spec = spec or SeqRecSpec()
    rng = np.random.default_rng([seed, 0x5E9])
    cdf = zipf_cdf(spec.item_vocab, spec.alpha)
    nc = spec.n_clusters
    for batch_id, start in enumerate(range(0, num_samples, batch_size)):
        n = min(batch_size, num_samples - start)
        target = zipf_ranks(rng, cdf, n) + 1  # 1-based item ids
        engaged = rng.random(n) < 0.5
        hist = zipf_ranks(rng, cdf, (n, spec.t_hist)) + 1
        # snap engaged histories onto the target's cluster
        same = (hist // nc) * nc + (target % nc)[:, None]
        hist = np.where(engaged[:, None], same, hist)
        np.clip(hist, 1, spec.item_vocab - 1, out=hist)
        lengths = rng.integers(max(2, spec.t_hist // 4),
                               spec.t_hist + 1, size=n)
        label = np.where(engaged, rng.random(n) < 0.85,
                         rng.random(n) < 0.15).astype(np.float32)
        hist_rows = [np.ascontiguousarray(hist[i, :lengths[i]], np.uint64)
                     for i in range(n)]
        # the clicked sub-history: every other item, at least one
        click_rows = [r[::2] if len(r) > 1 else r for r in hist_rows]
        dense = rng.normal(size=(n, spec.num_dense)).astype(np.float32)
        profiles = [
            IDTypeFeatureWithSingleID(
                name,
                (rng.integers(0, pv, size=n)
                 + spec.item_vocab + 1
                 + sum(spec.profile_vocabs[:i])).astype(np.uint64))
            for i, (name, pv) in enumerate(
                zip(SEQ_PROFILE_SLOTS, spec.profile_vocabs))
        ]
        yield PersiaBatch(
            profiles
            + [IDTypeFeature(SEQ_HISTORY_SLOT, hist_rows),
               IDTypeFeature(SEQ_CLICKS_SLOT, click_rows),
               IDTypeFeatureWithSingleID(
                   SEQ_TARGET_SLOT,
                   np.ascontiguousarray(target, np.uint64))],
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(label.reshape(n, 1))],
            requires_grad=requires_grad,
            batch_id=batch_id,
        )
