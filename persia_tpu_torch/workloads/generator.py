"""The workload zoo's data layer: copies of the generators of
``persia_tpu/workloads/generator.py``, and of the streams the examples
and the bench make.

- :func:`dlrm_batches`: Criteo-schema DLRM traffic, 13 dense floats and
  26 categorical tables with a log-spread vocab mix, each drawing signs
  from an exact truncated zipf;
- :func:`criteo_uniform_batches`, :func:`criteo_learnable_batches`: the
  criteo example's streams, uniform signs with noise labels or a
  recoverable signal;
- :func:`seqrec_batches`: sessions with ragged histories, the label
  planted in the history;
- :func:`multitask_batches`: two objectives (click, convert) over one
  set of tables, labels as one (batch, 2) array;
- :func:`adult_income_batches`: ``examples/adult_income/data_generator.py``'s
  8 categorical slots and 5 dense features;
- :func:`hybrid_bench_batches`: ``bench.py``'s ``make_batches``, 26 slots
  of fresh uniform signs in [0, 2^40) and random labels;
- :func:`zipf_bench_batches`: ``bench.py``'s ``make_zipf_batches`` (the
  traffic of ``bench_cached``), 26 slots of Zipf-skewed ids, one sign
  range a slot;
- :func:`make_infer_requests`: ``bench.py``'s serving traffic (the
  requests of ``bench_infer``), label-less PTB2 blobs of Zipf-skewed
  signs.

Every stream is a pure function of its arguments: the same ``seed``
yields a batch stream byte-identical (``to_bytes``) to the JAX
package's (the parity tests pin it), so the port makes real traffic
without the JAX package. The hidden label structure does not depend on
the seed: train on one seed, evaluate on another.
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

NUM_DENSE = 13
NUM_TABLES = 26
CRITEO_SLOT_NAMES = [f"C{i + 1}" for i in range(NUM_TABLES)]

_U64 = np.uint64


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


def hidden_weight(stream: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Deterministic ~N(0, 1) hidden weight per (stream, id), hashed on
    the fly (splitmix64 mixing, then Box-Muller). The weights define the
    task and do not depend on the generator's seed."""
    x = (ids.astype(np.uint64) * _U64(0x9E3779B97F4A7C15)
         + (np.asarray(stream, np.uint64) + _U64(1))
         * _U64(0xBF58476D1CE4E5B9))

    def mix(v):
        v = v ^ (v >> _U64(30))
        v = v * _U64(0xBF58476D1CE4E5B9)
        v = v ^ (v >> _U64(27))
        v = v * _U64(0x94D049BB133111EB)
        return v ^ (v >> _U64(31))

    h1 = mix(x)
    h2 = mix(x ^ _U64(0xD6E8FEB86659FD93))
    u1 = ((h1 >> _U64(11)).astype(np.float64) + 1.0) / (2.0**53 + 2)
    u2 = (h2 >> _U64(11)).astype(np.float64) / 2.0**53
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def _labels_from_logits(rng: np.random.Generator, logits: np.ndarray,
                        noise: float) -> np.ndarray:
    """Std-normalized logistic draw: recoverable (a model must learn the
    hidden weights to beat AUC 0.5) but never separable (``noise`` of the
    logit scale is irreducible)."""
    std = float(logits.std()) or 1.0
    noisy = logits + rng.normal(0.0, noise * std, size=logits.shape)
    prob = 1.0 / (1.0 + np.exp(-2.5 * noisy / std))
    return (rng.random(logits.shape) < prob).astype(np.float32)


@dataclass(frozen=True)
class CriteoSpec:
    """Shape of the Criteo-schema stream: per-table vocab sizes
    (log-spread), per-table dims (laddered by vocab rank) and the zipf
    skew."""

    vocabs: Tuple[int, ...]
    dims: Tuple[int, ...]
    alpha: float = 1.05
    num_dense: int = NUM_DENSE
    label_noise: float = 0.25

    @property
    def num_tables(self) -> int:
        return len(self.vocabs)

    @property
    def sign_offsets(self) -> np.ndarray:
        """Per-table base offsets keeping the sign ranges disjoint (+1
        everywhere keeps sign 0 for "missing")."""
        return np.concatenate(
            [[0], np.cumsum(np.asarray(self.vocabs, np.int64))])[:-1]

    @classmethod
    def build(cls, scale: float = 1.0, alpha: float = 1.05,
              num_tables: int = NUM_TABLES,
              num_dense: int = NUM_DENSE) -> "CriteoSpec":
        """Vocabs log-spaced from ~100*scale to ~200k*scale, shuffled by a
        fixed stride; dims 8 / 16 / 32 by vocab rank."""
        lo, hi = max(50, int(100 * scale)), max(200, int(200_000 * scale))
        v = np.logspace(np.log10(lo), np.log10(hi), num_tables)
        stride = 11 if num_tables % 11 else 7
        perm = (np.arange(num_tables) * stride) % num_tables
        vocabs = tuple(int(x) for x in v[perm])
        order = np.argsort(np.argsort(vocabs))  # rank of each table
        third = max(1, num_tables // 3)
        dims = tuple(
            32 if r >= num_tables - third else (16 if r >= third else 8)
            for r in order)
        return cls(vocabs=vocabs, dims=dims, alpha=float(alpha),
                   num_dense=num_dense)


def dlrm_batches(
    num_samples: int,
    batch_size: int = 4096,
    seed: int = 0,
    spec: Optional[CriteoSpec] = None,
    requires_grad: bool = True,
) -> Iterator[PersiaBatch]:
    """Criteo-schema DLRM stream: per-table zipf signs, 13 dense floats
    (log1p of positive draws) and a label from fixed hidden per-(table,
    id) weights plus a dense linear term."""
    spec = spec or CriteoSpec.build()
    rng = np.random.default_rng([seed, 0xD12])
    cdfs = [zipf_cdf(v, spec.alpha) for v in spec.vocabs]
    offsets = spec.sign_offsets
    dense_w = hidden_weight(
        np.arange(spec.num_dense, dtype=np.uint64) + _U64(1 << 20),
        np.full(spec.num_dense, 7, np.uint64)) * 0.5
    for batch_id, start in enumerate(range(0, num_samples, batch_size)):
        n = min(batch_size, num_samples - start)
        ids = np.empty((n, spec.num_tables), dtype=np.int64)
        for t in range(spec.num_tables):
            ids[:, t] = zipf_ranks(rng, cdfs[t], n)
        dense = np.log1p(np.abs(rng.normal(
            size=(n, spec.num_dense)))).astype(np.float32)
        logits = np.zeros(n, np.float64)
        for t in range(spec.num_tables):
            logits += hidden_weight(np.full(n, t, np.uint64),
                                    ids[:, t].astype(np.uint64))
        logits /= np.sqrt(spec.num_tables)
        logits += dense.astype(np.float64) @ dense_w
        label = _labels_from_logits(rng, logits, spec.label_noise)
        signs = (ids + offsets[None, :] + 1).astype(np.uint64)
        yield PersiaBatch(
            [IDTypeFeatureWithSingleID(
                CRITEO_SLOT_NAMES[t], np.ascontiguousarray(signs[:, t]))
             for t in range(spec.num_tables)],
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(label.reshape(n, 1))],
            requires_grad=requires_grad,
            batch_id=batch_id,
        )


def criteo_uniform_batches(
    num_samples: int,
    batch_size: int = 4096,
    seed: int = 0,
    vocab_per_slot: int = 1 << 20,
    requires_grad: bool = True,
) -> Iterator[PersiaBatch]:
    """Criteo-shaped stream with uniform signs and noise labels (the
    criteo example's ``synthetic_batches``)."""
    rng = np.random.default_rng(seed)
    for batch_id, start in enumerate(range(0, num_samples, batch_size)):
        n = min(batch_size, num_samples - start)
        signs = rng.integers(1, vocab_per_slot, size=(n, NUM_TABLES),
                             dtype=np.uint64)
        dense = rng.normal(size=(n, NUM_DENSE)).astype(np.float32)
        label = (rng.random((n, 1)) < 0.25).astype(np.float32)
        yield PersiaBatch(
            [IDTypeFeatureWithSingleID(
                CRITEO_SLOT_NAMES[i], np.ascontiguousarray(signs[:, i]))
             for i in range(NUM_TABLES)],
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(label)],
            requires_grad=requires_grad,
            batch_id=batch_id,
        )


def criteo_learnable_batches(
    num_samples: int,
    batch_size: int = 4096,
    seed: int = 0,
    vocab_per_slot: int = 1000,
    noise: float = 0.25,
    requires_grad: bool = True,
) -> Iterator[PersiaBatch]:
    """Criteo-shaped stream with a recoverable signal: labels from fixed
    hidden per-id weights (:func:`hidden_weight`) and a dense linear
    term."""
    rng = np.random.default_rng(seed)
    hidden = np.random.default_rng(424242)
    dense_w = hidden.normal(0.0, 0.5, size=NUM_DENSE)
    slot_idx = np.arange(NUM_TABLES, dtype=np.uint64)[None, :]
    for batch_id, start in enumerate(range(0, num_samples, batch_size)):
        n = min(batch_size, num_samples - start)
        ids = rng.integers(0, vocab_per_slot, size=(n, NUM_TABLES))
        dense = rng.normal(size=(n, NUM_DENSE)).astype(np.float32)
        logits = hidden_weight(slot_idx, ids).sum(axis=1)
        logits += dense @ dense_w
        std = float(logits.std()) or 1.0  # a batch of 1: std is 0
        logits += rng.normal(0.0, noise * std, size=n)
        prob = 1.0 / (1.0 + np.exp(-2.5 * logits / std))
        label = (rng.random(n) < prob).astype(np.float32)[:, None]
        # distinct sign ranges per slot; +1 keeps sign 0 for "missing"
        signs = (ids + np.arange(NUM_TABLES)[None, :] * vocab_per_slot
                 + 1).astype(np.uint64)
        yield PersiaBatch(
            [IDTypeFeatureWithSingleID(
                CRITEO_SLOT_NAMES[i], np.ascontiguousarray(signs[:, i]))
             for i in range(NUM_TABLES)],
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(label)],
            requires_grad=requires_grad,
            batch_id=batch_id,
        )


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


@dataclass(frozen=True)
class MultiTaskSpec:
    """Two objectives (click, convert) over one set of tables; the convert
    logits reuse ``convert_carryover`` of the click logits plus their own
    hidden weights."""

    user_vocab: int = 20_000
    item_vocab: int = 50_000
    ctx_vocabs: Tuple[int, ...] = (100, 30)
    alpha: float = 1.05
    num_dense: int = 6
    dim: int = 16
    label_noise: float = 0.25
    convert_carryover: float = 0.6


MT_TASKS = ("click", "convert")
MT_SLOTS = ("user", "item", "ctx_0", "ctx_1")


def multitask_batches(
    num_samples: int,
    batch_size: int = 1024,
    seed: int = 0,
    spec: Optional[MultiTaskSpec] = None,
    requires_grad: bool = True,
) -> Iterator[PersiaBatch]:
    """Zipf user and item draws; the labels land as one (batch, 2) array
    (click, convert)."""
    spec = spec or MultiTaskSpec()
    rng = np.random.default_rng([seed, 0x307])
    u_cdf = zipf_cdf(spec.user_vocab, spec.alpha)
    i_cdf = zipf_cdf(spec.item_vocab, spec.alpha)
    base_item = spec.user_vocab + 1
    base_ctx = base_item + spec.item_vocab
    for batch_id, start in enumerate(range(0, num_samples, batch_size)):
        n = min(batch_size, num_samples - start)
        user = zipf_ranks(rng, u_cdf, n).astype(np.uint64)
        item = zipf_ranks(rng, i_cdf, n).astype(np.uint64)
        ctx = [rng.integers(0, cv, size=n).astype(np.uint64)
               for cv in spec.ctx_vocabs]
        dense = rng.normal(size=(n, spec.num_dense)).astype(np.float32)
        shared = (hidden_weight(np.full(n, 0, np.uint64), user)
                  + hidden_weight(np.full(n, 1, np.uint64), item))
        # a small pairwise term a shared bottom cannot memorize: structured
        # label noise bounding the click AUC
        click_logits = shared + 0.5 * hidden_weight(
            np.full(n, 2, np.uint64), user * _U64(3) + item)
        conv_logits = (spec.convert_carryover * click_logits
                       + hidden_weight(np.full(n, 3, np.uint64), item)
                       + hidden_weight(np.full(n, 4, np.uint64), user))
        label = np.stack(
            [_labels_from_logits(rng, click_logits, spec.label_noise),
             _labels_from_logits(rng, conv_logits, spec.label_noise)],
            axis=1)
        feats = [
            IDTypeFeatureWithSingleID("user", user + _U64(1)),
            IDTypeFeatureWithSingleID("item", item + _U64(base_item)),
        ]
        off = base_ctx
        for i, c in enumerate(ctx):
            feats.append(IDTypeFeatureWithSingleID(
                MT_SLOTS[2 + i], c + _U64(off)))
            off += spec.ctx_vocabs[i]
        yield PersiaBatch(
            feats,
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(label)],
            requires_grad=requires_grad,
            batch_id=batch_id,
        )


# --- examples/adult_income/data_generator.py -----------------------------

ADULT_NUM_SLOTS = 8
ADULT_NUM_DENSE = 5
ADULT_VOCAB_PER_SLOT = 64


def adult_income_batches(
    num_samples: int, batch_size: int, seed: int = 0,
    requires_grad: bool = True,
) -> Iterator[PersiaBatch]:
    """The adult-income example's synthetic task: 8 categorical slots
    (``slot_0..7``, 64 ids each in distinct sign ranges) and 5 dense
    features; the label is a noisy logistic function of hidden
    per-category weights (fixed, seed 7) and a dense linear term. All
    ``num_samples`` are drawn at once, then cut into batches."""
    rng = np.random.default_rng(seed)
    hidden = np.random.default_rng(7)
    cat_w = hidden.normal(0.0, 1.0, size=(ADULT_NUM_SLOTS,
                                          ADULT_VOCAB_PER_SLOT))
    dense_w = hidden.normal(0.0, 0.5, size=ADULT_NUM_DENSE)
    ids = rng.integers(0, ADULT_VOCAB_PER_SLOT,
                       size=(num_samples, ADULT_NUM_SLOTS))
    dense = rng.normal(size=(num_samples, ADULT_NUM_DENSE)).astype(
        np.float32)
    logits = cat_w[np.arange(ADULT_NUM_SLOTS)[None, :], ids].sum(axis=1)
    logits += dense @ dense_w
    logits += rng.normal(0.0, 0.25 * logits.std(), size=num_samples)
    prob = 1.0 / (1.0 + np.exp(-2.5 * logits / logits.std()))
    labels = (rng.random(num_samples) < prob).astype(np.float32)[:, None]
    signs = (ids + np.arange(ADULT_NUM_SLOTS)[None, :]
             * ADULT_VOCAB_PER_SLOT).astype(np.uint64)
    for start in range(0, num_samples, batch_size):
        end = min(start + batch_size, num_samples)
        yield PersiaBatch(
            [IDTypeFeatureWithSingleID(
                f"slot_{s}", np.ascontiguousarray(signs[start:end, s]))
             for s in range(ADULT_NUM_SLOTS)],
            non_id_type_features=[NonIDTypeFeature(dense[start:end])],
            labels=[Label(labels[start:end])],
            requires_grad=requires_grad,
            batch_id=start // batch_size,
        )


# --- bench.py make_batches -------------------------------------------------


def hybrid_bench_batches(num_batches: int, batch_size: int,
                         seed: int = 0) -> Iterator[PersiaBatch]:
    """``bench.py``'s ``make_batches`` (the traffic of ``bench_hybrid``):
    ``num_batches`` batches, each with 26 slots ``slot_0..25`` of one sign
    a sample drawn uniformly from [0, 2^40), so nearly every sign is a new
    PS row, 13 normal dense floats and random 0/1 labels."""
    rng = np.random.default_rng(seed)
    for i in range(num_batches):
        id_feats = [
            IDTypeFeatureWithSingleID(
                f"slot_{s}",
                rng.integers(0, 1 << 40, size=batch_size, dtype=np.uint64))
            for s in range(NUM_TABLES)
        ]
        yield PersiaBatch(
            id_feats,
            non_id_type_features=[NonIDTypeFeature(
                rng.normal(size=(batch_size, NUM_DENSE)).astype(np.float32))],
            labels=[Label(
                rng.integers(0, 2, size=(batch_size, 1)).astype(np.float32))],
            batch_id=i,
        )


def zipf_bench_batches(num_batches: int, batch_size: int,
                       vocab: int = 1 << 20, a: float = 1.2,
                       seed: int = 0) -> Iterator[PersiaBatch]:
    """``bench.py``'s ``make_zipf_batches``: ``num_batches`` batches of 26
    slots ``slot_0..25`` of one sign a sample, ``zipf(a) % vocab`` shifted
    into slot ``s``'s range ``s * vocab + 1 ..`` (sign 0 never drawn), 13
    normal dense floats and random 0/1 labels; the skewed traffic the
    device cache is for."""
    rng = np.random.default_rng(seed)
    for i in range(num_batches):
        ids = rng.zipf(a, size=(batch_size, NUM_TABLES)) % vocab
        signs = (ids + np.arange(NUM_TABLES, dtype=np.uint64) * vocab
                 + 1).astype(np.uint64)
        yield PersiaBatch(
            [IDTypeFeatureWithSingleID(
                f"slot_{s}", np.ascontiguousarray(signs[:, s]))
             for s in range(NUM_TABLES)],
            non_id_type_features=[NonIDTypeFeature(
                rng.normal(size=(batch_size, NUM_DENSE)).astype(np.float32))],
            labels=[Label(
                rng.integers(0, 2, size=(batch_size, 1)).astype(np.float32))],
            batch_id=i,
        )


def make_infer_requests(num: int, rows: int, n_slots: int, num_dense: int,
                        vocab: int = 1 << 18, a: float = 1.2,
                        seed: int = 0) -> list:
    """``bench.py``'s ``make_infer_requests``: ``num`` pre-serialized,
    label-less PersiaBatch blobs of ``rows`` rows, ``n_slots`` single-id
    slots ``slot_0..`` of Zipf(``a``) ids (serving traffic is hot-row
    heavy), one sign range of ``vocab`` a slot, and ``num_dense`` normal
    floats."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        ids = rng.zipf(a, size=(rows, n_slots)) % vocab
        signs = (ids + np.arange(n_slots, dtype=np.uint64) * vocab
                 + 1).astype(np.uint64)
        out.append(PersiaBatch(
            [IDTypeFeatureWithSingleID(
                f"slot_{s}", np.ascontiguousarray(signs[:, s]))
             for s in range(n_slots)],
            non_id_type_features=[NonIDTypeFeature(
                rng.normal(size=(rows, num_dense)).astype(np.float32))],
            requires_grad=False,
        ).to_bytes())
    return out
