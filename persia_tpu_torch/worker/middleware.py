"""Embedding-worker middleware: the lookup and gradient transforms.

A copy of the numpy twin of ``persia_tpu/worker/middleware.py``. Forward
(lookup) direction:

- per-feature **dedup** of signs with (sample, col) back-pointers;
- **hashstack** multi-round vocab compression;
- **index-prefix** namespacing;
- **shard split** by ``farmhash64(sign) % replica_size``, grouped by
  embedding dim so each PS call is one rectangular batch;
- **postprocess** into static-shape tensors: summed slots -> (batch, dim)
  f32 with sum / mean / last-k pooling and optional 1/sqrt(n) scaling; raw
  slots -> a fixed-capacity distinct tensor (batch*sample_fixed_size + 1,
  dim) whose row 0 is zeros, plus a (batch, sample_fixed_size) int32 index
  tensor where 0 means padding.

Backward (gradient) direction, the transpose of postprocess:

- **aggregate** a feature's model gradient into per-distinct-sign rows
  (sum / mean / sqrt pooling and last-k pooling; raw slots read row
  ``+1`` of the distinct tensor's gradient), with non-finite values
  zeroed and the loss scale divided out;
- **gather** them per (shard, dim) group for the PS update calls.

:class:`GradErrorFeedback` keeps the int8 gradient wire's residuals for
the PS client.

Every sum accumulates with ``np.add.at``, which adds strictly in element
order: that order is what makes the results bit-identical to the JAX
package (and to the C++ kernels), which the parity tests rely on.

Dedup, the shard split, the row scatter, the summed and raw postprocess
and the gradient aggregation run the C++ kernels of
:mod:`persia_tpu_torch.worker.mw_native` where the JAX middleware runs
them (last-k pooling has no kernel and stays on numpy); the numpy path
beside each is their twin, reached by patching ``_mw_native``.
"""

import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass
from itertools import repeat
from typing import Dict, List, Optional, Tuple

import numpy as np

from persia_tpu_torch import knobs
from persia_tpu_torch.config import EmbeddingSchema, SlotConfig
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.hashing import farmhash64_np, sign_to_shard
from persia_tpu_torch.worker import mw_native

_U64 = np.uint64


class GradErrorFeedback:
    """Client-held fp32 residuals for the int8 gradient wire.

    When the update wire ships int8-quantized gradients
    (:mod:`persia_tpu_torch.wire_codec`), the per-shipment rounding
    error must not be lost — error-feedback SGD re-injects each sign's residual
    into that sign's NEXT shipped gradient, so the quantization bias
    cancels across steps and convergence tracks the fp32 trajectory
    (the same discipline as the dense allreduce's ``_ef_int8_mean``).
    The store is one bounded insertion-ordered map per dim, keyed by
    sign; overflowing it silently drops the oldest residuals, which
    degrades those signs to plain deterministic rounding — safe, just
    slightly noisier.

    Duplicate signs inside one shipment (the same sign reached via two
    features of one shard group): :meth:`apply` compensates only the
    FIRST occurrence (adding the residual to both would double-inject
    it) and :meth:`store` keeps the LAST occurrence's residual (the
    final quantization the server saw). Thread-safe — the worker's
    fan-out ships groups concurrently through one client.
    """

    def __init__(self, capacity_rows: int = 1 << 20):
        # one LRU per dim, bounded at capacity_rows EACH (schemas have a
        # handful of distinct dims): plain-int keys hash ~2x faster than
        # (dim, sign) tuples, and this path runs per shipped sign
        self.capacity_rows = int(capacity_rows)
        self._by_dim: Dict[int, "OrderedDict[int, np.ndarray]"] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return sum(len(od) for od in self._by_dim.values())

    def apply(self, signs: np.ndarray, grads: np.ndarray, dim: int):
        """Add (and consume) stored residuals into ``grads`` in place.
        ``pop`` consumes each key, so a duplicate sign's second
        occurrence naturally gets nothing (first-occurrence-only)."""
        od = self._by_dim.get(dim)
        if od is None or not len(signs):
            return
        # bulk numpy->int conversion + a C-level map(pop, ...) sweep:
        # per-element int()/loop bytecode is the hot-loop killer at
        # 100k signs/cycle
        keys = signs.tolist()
        with self._lock:
            before = len(od)
            rows = list(map(od.pop, keys, repeat(None)))
            popped = before - len(od)
        # all-hit fast path (the converged steady state): detected via
        # the pop count — `None in rows` would route through ndarray
        # __eq__ and cannot be used
        if popped == len(rows):
            grads += np.stack(rows)
            return
        if not popped:
            return
        idx = [i for i, r in enumerate(rows) if r is not None]
        # indices are unique — pop consumed each key once
        grads[np.asarray(idx)] += np.stack([rows[i] for i in idx])

    def store(self, signs: np.ndarray, residual: np.ndarray, dim: int):
        """Save this shipment's quantization residuals for the signs'
        next shipment (last occurrence of a duplicate wins)."""
        keys = signs.tolist()
        # per-row COPIES, not views of the shipment matrix: under
        # skewed traffic a few tail rows linger in the LRU long after
        # their shipment's hot rows were refreshed, and a single
        # surviving view would pin the whole (n, dim) matrix — an
        # unbounded amplification of the nominal store size. The copy
        # loop costs ~0.5us/row, noise against the quantize pass.
        rows = [r.copy()
                for r in np.ascontiguousarray(residual, np.float32)]
        with self._lock:
            od = self._by_dim.get(dim)
            if od is None:
                od = self._by_dim[dim] = OrderedDict()
            # C-level bulk upsert. Existing keys keep their position
            # (values refresh in place): the LRU degrades to
            # insertion-order aging, which only biases EVICTION choice
            # once the per-dim store overflows — acceptable for a
            # residual cache, where eviction just means plain rounding
            # for that sign's next shipment.
            od.update(zip(keys, rows))
            while len(od) > self.capacity_rows:
                od.popitem(last=False)


def _mw_native():
    """The C++ kernels, whose library is built at first use (a failed
    build raises), or None for the numpy twins: when
    ``PERSIA_FORCE_PYTHON_MW`` is set (read at each call), or where the
    tests patch this to ``lambda: None``."""
    if knobs.get("PERSIA_FORCE_PYTHON_MW"):
        return None
    return mw_native


@dataclass
class DedupedFeature:
    """One ID feature after dedup (+ hashstack + prefix) transforms."""

    name: str
    batch_size: int
    distinct_signs: np.ndarray  # (d,) uint64 — signs to look up on the PS
    elem_sample: np.ndarray  # (nnz,) int32 — sample index per CSR element
    elem_col: np.ndarray  # (nnz,) int32 — position within the sample
    elem_distinct: np.ndarray  # (nnz,) int32 — index into distinct_signs
    sample_num_signs: np.ndarray  # (bs,) int32 — per-sample sign count
    # raw mode: which output row each distinct sign contributes to
    # (identity unless hashstack merged rounds back onto original signs)
    raw_row_of_distinct: Optional[np.ndarray] = None
    hash_stack_rounds: int = 0

    @property
    def num_distinct(self) -> int:
        return len(self.distinct_signs)

    @property
    def num_raw_rows(self) -> int:
        """Output rows of a raw slot: the distinct signs, or the original
        signs that hashstack's rounds merge back onto."""
        if self.raw_row_of_distinct is None:
            return self.num_distinct
        if not len(self.raw_row_of_distinct):
            return 0
        return int(self.raw_row_of_distinct.max()) + 1


def _segment_sum(values: np.ndarray, segment_ids: np.ndarray,
                 num_segments: int) -> np.ndarray:
    """Sum rows of ``values`` by segment id, in element order."""
    out = np.zeros((num_segments, values.shape[1]), dtype=values.dtype)
    np.add.at(out, segment_ids, values)
    return out


def dedup_feature(feature: IDTypeFeature) -> DedupedFeature:
    """CSR feature -> sorted distinct signs + element back-pointers."""
    offsets = feature.offsets.astype(np.int64, copy=False)
    counts = np.diff(offsets)
    bs = feature.batch_size
    nnz = int(offsets[-1])
    elem_sample = np.repeat(np.arange(bs, dtype=np.int32), counts)
    elem_col = (np.arange(nnz, dtype=np.int32)
                - np.repeat(offsets[:-1], counts).astype(np.int32))
    native = _mw_native()
    if native is not None:
        distinct, inverse = native.dedup(feature.signs)
    else:
        distinct, inverse = np.unique(feature.signs, return_inverse=True)
    return DedupedFeature(
        name=feature.name,
        batch_size=bs,
        distinct_signs=distinct.astype(np.uint64, copy=False),
        elem_sample=elem_sample,
        elem_col=elem_col,
        elem_distinct=inverse.astype(np.int32, copy=False),
        sample_num_signs=counts.astype(np.int32),
    )


def apply_hashstack(feat: DedupedFeature, rounds: int,
                    table_size: int) -> DedupedFeature:
    """Multi-round hash compression: each sign becomes ``rounds`` bucket
    signs in a table of ``rounds * table_size`` rows."""
    if rounds <= 0:
        return feat
    d = feat.num_distinct
    h = feat.distinct_signs
    buckets = np.empty((d, rounds), dtype=np.uint64)
    for r in range(rounds):
        h = farmhash64_np(h)
        buckets[:, r] = h % _U64(table_size) + _U64(r * table_size)
    new_distinct, new_inverse = np.unique(buckets.ravel(),
                                          return_inverse=True)
    bucket_of = new_inverse.reshape(d, rounds).astype(np.int32)
    # raw mode: every bucket contributes to its original sign's row
    raw_row = np.zeros(len(new_distinct), dtype=np.int32)
    raw_row[bucket_of.ravel()] = np.repeat(np.arange(d, dtype=np.int32),
                                           rounds)
    return DedupedFeature(
        name=feat.name,
        batch_size=feat.batch_size,
        distinct_signs=new_distinct,
        elem_sample=np.repeat(feat.elem_sample, rounds),
        elem_col=np.repeat(feat.elem_col, rounds),
        elem_distinct=bucket_of[feat.elem_distinct].ravel(),
        sample_num_signs=feat.sample_num_signs * rounds,
        raw_row_of_distinct=raw_row,
        hash_stack_rounds=rounds,
    )


def apply_index_prefix(feat: DedupedFeature, slot: SlotConfig,
                       feature_spacing: int) -> DedupedFeature:
    """Namespace signs under the slot's feature-group prefix."""
    if slot.index_prefix <= 0:
        return feat
    with np.errstate(over="ignore"):
        feat.distinct_signs = (feat.distinct_signs % _U64(feature_spacing)
                               + _U64(slot.index_prefix))
    return feat


def truncate_to_sample_fixed_size(feature: IDTypeFeature,
                                  sfs: int) -> IDTypeFeature:
    """Keep only the first ``sfs`` ids of each sample, so a raw slot's
    distinct count can never exceed its static capacity."""
    offsets = feature.offsets.astype(np.int64, copy=False)
    counts = np.diff(offsets)
    if len(counts) == 0 or int(counts.max()) <= sfs:
        return feature
    nnz = int(offsets[-1])
    elem_col = (np.arange(nnz, dtype=np.int64)
                - np.repeat(offsets[:-1], counts))
    new_offsets = np.zeros(len(counts) + 1, dtype=np.uint32)
    np.cumsum(np.minimum(counts, sfs), out=new_offsets[1:])
    return IDTypeFeature.from_csr(feature.name, new_offsets,
                                  feature.signs[elem_col < sfs])


def preprocess_batch(id_type_features: List[IDTypeFeature],
                     schema: EmbeddingSchema) -> List[DedupedFeature]:
    """dedup -> hashstack -> prefix for every feature of a batch."""
    feats = []
    for f in id_type_features:
        slot = schema.get_slot(f.name)
        if not slot.embedding_summation:
            f = truncate_to_sample_fixed_size(f, slot.sample_fixed_size)
        df = dedup_feature(f)
        hs = slot.hash_stack_config
        df = apply_hashstack(df, hs.hash_stack_rounds, hs.embedding_size)
        df = apply_index_prefix(df, slot, schema.feature_spacing)
        feats.append(df)
    return feats


@dataclass
class ShardGroup:
    """All signs for one (shard, dim) pair, with scatter-back pointers."""

    shard: int
    dim: int
    signs: np.ndarray  # (m,) uint64
    feature_idx: np.ndarray  # (m,) int32 — which DedupedFeature
    distinct_idx: np.ndarray  # (m,) int32 — index into its distinct signs


_NONUNIFORM_WARNED = [False]


def _routing_replicas(signs: np.ndarray, routing) -> np.ndarray:
    """The table's replica a sign, leaving the native ``shard_order``
    (which hard-codes ``hash % R``) with one warning a process: a
    non-uniform epoch is an operator-visible event."""
    if not _NONUNIFORM_WARNED[0]:
        _NONUNIFORM_WARNED[0] = True
        logging.getLogger(__name__).warning(
            "routing epoch %d is non-uniform: negotiating down from "
            "native shard_order (modulo-only kernel) to the Python "
            "slot-table split", routing.epoch)
    return routing.replica_of(signs)


def shard_split(feats: List[DedupedFeature], schema: EmbeddingSchema,
                replica_size: int, routing=None) -> List[ShardGroup]:
    """Group every feature's distinct signs by (PS shard, dim), in
    ascending (shard, dim) order with features in batch order.
    ``routing`` (a :class:`persia_tpu_torch.routing.RoutingTable`)
    replaces ``farmhash % replica_size`` when it is not uniform; a
    uniform table routes exactly like the modulo and keeps the native
    split."""
    if routing is not None and routing.is_uniform_modulo:
        routing = None
    native = _mw_native() if routing is None else None
    by_key: Dict[Tuple[int, int], List[Tuple[np.ndarray, int]]] = {}
    for fi, feat in enumerate(feats):
        dim = schema.get_slot(feat.name).dim
        if routing is not None:
            shards = _routing_replicas(feat.distinct_signs, routing)
            for shard in np.unique(shards):
                sel = np.nonzero(shards == shard)[0].astype(np.int32)
                by_key.setdefault((int(shard), dim), []).append((sel, fi))
            continue
        if native is not None:
            # fused farmhash and counting sort; ascending within a shard,
            # as the nonzero split below
            order, starts = native.shard_order(feat.distinct_signs,
                                               replica_size)
            for shard in range(replica_size):
                a, b = int(starts[shard]), int(starts[shard + 1])
                if a < b:
                    by_key.setdefault((shard, dim), []).append(
                        (order[a:b], fi))
            continue
        shards = sign_to_shard(feat.distinct_signs, replica_size)
        for shard in np.unique(shards):
            sel = np.nonzero(shards == shard)[0].astype(np.int32)
            by_key.setdefault((int(shard), dim), []).append((sel, fi))
    groups = []
    for (shard, dim), parts in sorted(by_key.items()):
        signs = np.concatenate(
            [feats[fi].distinct_signs[sel] for sel, fi in parts])
        fidx = np.concatenate(
            [np.full(len(sel), fi, np.int32) for sel, fi in parts])
        didx = np.concatenate([sel for sel, _ in parts])
        groups.append(ShardGroup(shard, dim, signs, fidx, didx))
    return groups


def _feature_runs(feature_idx: np.ndarray):
    """Contiguous (start, end, fi) runs of a group's nondecreasing
    feature_idx array."""
    if len(feature_idx) == 0:
        return
    starts = np.nonzero(np.diff(feature_idx, prepend=feature_idx[0] - 1))[0]
    ends = np.append(starts[1:], len(feature_idx))
    for a, b in zip(starts, ends):
        yield int(a), int(b), int(feature_idx[a])


def alloc_lookup_mats(feats: List[DedupedFeature],
                      schema: EmbeddingSchema) -> List[np.ndarray]:
    """Per-feature (num_distinct, dim) result matrices for the scatter."""
    return [np.zeros((f.num_distinct, schema.get_slot(f.name).dim),
                     dtype=np.float32) for f in feats]


def scatter_group(mats: List[np.ndarray], group: ShardGroup,
                  res: np.ndarray):
    """Scatter one shard group's lookup result into the per-feature
    matrices. Groups partition the distinct signs, so scatters of
    different groups write disjoint rows."""
    res = np.ascontiguousarray(res, dtype=np.float32)
    native = _mw_native()
    for a, b, fi in _feature_runs(group.feature_idx):
        if native is not None:
            native.scatter_rows(mats[fi], group.distinct_idx[a:b], res[a:b],
                                group.dim)
        else:
            mats[fi][group.distinct_idx[a:b]] = res[a:b]


def scatter_lookup_results(
    feats: List[DedupedFeature], schema: EmbeddingSchema,
    groups: List[ShardGroup], results: List[np.ndarray],
) -> List[np.ndarray]:
    """Per-feature (num_distinct, dim) embedding matrices assembled from
    the per-shard lookup results."""
    mats = alloc_lookup_mats(feats, schema)
    for group, res in zip(groups, results):
        scatter_group(mats, group, res)
    return mats


@dataclass
class SumEmbedding:
    name: str
    embeddings: np.ndarray  # (batch, dim)


@dataclass
class RawEmbedding:
    """Static-shape raw (sequence) slot output: ``embeddings[0]`` is
    all-zeros padding; ``index[s, c]`` selects the row for sample s
    position c, with 0 meaning padding. Gather and mask happen on the
    device in the dense model."""

    name: str
    embeddings: np.ndarray  # (capacity, dim), row 0 zeros
    index: np.ndarray  # (batch, sample_fixed_size) int32
    sample_id_num: np.ndarray  # (batch,) int32


def postprocess_feature(feat: DedupedFeature, slot: SlotConfig,
                        emb: np.ndarray):
    """One feature's distinct embeddings -> model-ready tensors."""
    bs = feat.batch_size
    dim = slot.dim
    native = _mw_native()
    if slot.embedding_summation:
        last_n = slot.pooling_last_n
        if last_n:
            # recency pooling: sum of each sample's LAST k signs (CSR
            # order is arrival order); sum_post has no element mask
            keep = feat.elem_col >= (
                feat.sample_num_signs - last_n)[feat.elem_sample]
            out = _segment_sum(emb[feat.elem_distinct[keep]],
                               feat.elem_sample[keep], bs)
            return SumEmbedding(feat.name, out)
        scale = _pool_scale(feat, slot)
        if native is not None:
            return SumEmbedding(feat.name, native.sum_post(
                emb, feat.elem_distinct, feat.sample_num_signs, bs, dim,
                scale))
        out = _segment_sum(emb[feat.elem_distinct], feat.elem_sample, bs)
        if scale is not None:
            out *= scale[:, None]
        return SumEmbedding(feat.name, out)

    sfs = slot.sample_fixed_size
    capacity = bs * sfs + 1
    rows = (feat.raw_row_of_distinct
            if feat.raw_row_of_distinct is not None
            else np.arange(feat.num_distinct, dtype=np.int32))
    emb_out = np.zeros((capacity, dim), dtype=np.float32)
    if native is not None:
        native.scatter_add_rows(emb_out, rows + 1, emb, dim)
    else:
        np.add.at(emb_out, rows + 1, emb)
    if slot.sqrt_scaling and feat.hash_stack_rounds > 1:
        emb_out *= 1.0 / np.sqrt(float(feat.hash_stack_rounds))
    index = np.zeros((bs, sfs), dtype=np.int32)
    valid = feat.elem_col < sfs
    index[feat.elem_sample[valid], feat.elem_col[valid]] = (
        rows[feat.elem_distinct[valid]] + 1)
    sample_id_num = np.minimum(feat.sample_num_signs, sfs).astype(np.int32)
    return RawEmbedding(feat.name, emb_out, index, sample_id_num)


def aggregate_gradients(feat: DedupedFeature, slot: SlotConfig,
                        grad: np.ndarray, loss_scale: float = 1.0
                        ) -> np.ndarray:
    """Model gradients -> per-distinct-sign gradients.

    For summed slots ``grad`` is (batch, dim); for raw slots it is the
    gradient w.r.t. the padded distinct tensor, (capacity, dim).
    Non-finite values are zeroed and the trainer's loss scale is divided
    out."""
    grad = np.ascontiguousarray(grad, dtype=np.float32)
    last_n = slot.pooling_last_n
    # last-k pooling has no kernel (no element mask in sum_grad)
    native = _mw_native() if not last_n else None
    if native is not None:
        return _aggregate_native(native, feat, slot, grad, loss_scale)
    if not np.isfinite(grad).all():
        grad = np.nan_to_num(grad, nan=0.0, posinf=0.0, neginf=0.0)
    if loss_scale != 1.0:
        grad = grad * (1.0 / loss_scale)
    if slot.embedding_summation:
        if last_n:
            # transpose of the masked forward sum: only the kept (last k
            # per sample) elements receive gradient
            keep = feat.elem_col >= (
                feat.sample_num_signs - last_n)[feat.elem_sample]
            return _segment_sum(grad[feat.elem_sample[keep]],
                                feat.elem_distinct[keep], feat.num_distinct)
        scale = _pool_scale(feat, slot)
        if scale is not None:
            grad = grad * scale[:, None]
        return _segment_sum(grad[feat.elem_sample], feat.elem_distinct,
                            feat.num_distinct)
    rows = (feat.raw_row_of_distinct
            if feat.raw_row_of_distinct is not None
            else np.arange(feat.num_distinct, dtype=np.int32))
    out = grad[rows + 1].copy()
    if slot.sqrt_scaling and feat.hash_stack_rounds > 1:
        out *= 1.0 / np.sqrt(float(feat.hash_stack_rounds))
    return out


def _pool_scale(feat: DedupedFeature, slot: SlotConfig
                ) -> Optional[np.ndarray]:
    n = np.maximum(feat.sample_num_signs, 1).astype(np.float32)
    if slot.pooling == "mean":
        return 1.0 / n
    if slot.sqrt_scaling:
        return 1.0 / np.sqrt(n)
    return None


def _aggregate_native(native, feat: DedupedFeature, slot: SlotConfig,
                      grad: np.ndarray, loss_scale: float) -> np.ndarray:
    """:func:`aggregate_gradients` on the C++ kernels, which zero the
    non-finite values and divide the loss scale out themselves."""
    inv_ls = float(np.float32(1.0 / loss_scale)) if loss_scale != 1.0 \
        else 1.0
    if slot.embedding_summation:
        return native.sum_grad(grad, feat.elem_sample, feat.elem_distinct,
                               feat.num_distinct, slot.dim, inv_ls,
                               _pool_scale(feat, slot))
    rows = (feat.raw_row_of_distinct
            if feat.raw_row_of_distinct is not None
            else np.arange(feat.num_distinct, dtype=np.int32))
    out = native.gather_rows(grad, rows + 1, slot.dim, filter_scale=inv_ls,
                             filter_nonfinite=True)
    if slot.sqrt_scaling and feat.hash_stack_rounds > 1:
        out *= 1.0 / np.sqrt(float(feat.hash_stack_rounds))
    return out


def gather_group_grads(group: ShardGroup,
                       per_feature_grads: List[np.ndarray]) -> np.ndarray:
    """One shard group's (m, dim) gradient matrix from the per-feature
    aggregates."""
    grads = np.empty((len(group.signs), group.dim), dtype=np.float32)
    for a, b, fi in _feature_runs(group.feature_idx):
        grads[a:b] = per_feature_grads[fi][group.distinct_idx[a:b]]
    return grads


def shard_gradients(feats: List[DedupedFeature], schema: EmbeddingSchema,
                    per_feature_grads: List[np.ndarray], replica_size: int,
                    groups: Optional[List[ShardGroup]] = None, routing=None
                    ) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
    """Group per-sign gradients by (shard, dim) for the PS update calls:
    a list of (shard, dim, signs, grads). Pass the forward's ``groups``
    to skip re-hashing and re-grouping every sign."""
    if groups is None:
        groups = shard_split(feats, schema, replica_size, routing=routing)
    return [(g.shard, g.dim, g.signs, gather_group_grads(g, per_feature_grads))
            for g in groups]
