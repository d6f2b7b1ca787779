"""Scenario registry (``persia_tpu/workloads/registry.py``): the workload
zoo's scenarios as runnable units.

A :class:`Scenario` bundles the embedding schema (dims, pooling), the
dense tower, the seeded batch stream, the loss and the convergence gate.
``model_fn`` builds the port's torch tower; flax infers input widths and
torch cannot, so it reads them from the scenario: ``num_dense`` and each
slot's dim in the schema's order, which is the order of the batches'
features.

``PERSIA_WORKLOAD_ALPHA`` (zipf skew, default 1.05) and
``PERSIA_WORKLOAD_SEED`` (base seed, default 0) in the environment set
the defaults, as the JAX package's knobs do; ``get_scenario``'s arguments
override them.
"""

import functools
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from persia_tpu_torch.config import EmbeddingSchema, SlotConfig, uniform_slots
from persia_tpu_torch.workloads import generator as gen

DEFAULT_ALPHA = 1.05
DEFAULT_SEED = 0


@dataclass(frozen=True)
class Scenario:
    """One runnable zoo workload (schema, model, stream, gates)."""

    name: str
    description: str
    schema: EmbeddingSchema
    # (num_dense, slot_dims, device=, compute_dtype=) -> torch tower
    model_fn: Callable[..., object]
    # (num_samples, batch_size, seed=, requires_grad=) -> batches
    batches: Callable[..., Iterator]
    num_dense: int
    tasks: Tuple[str, ...] = ("ctr",)
    loss_fn: Optional[Callable] = None   # None: the context's bce_loss
    # held-out AUC floor (the least over tasks): catches "not learning"
    auc_gate: float = 0.55
    # the ragged (worker-pooled or raw) features
    ragged_features: Tuple[str, ...] = ()
    bench_batch_size: int = 1024
    seed: int = 0

    @property
    def slot_dims(self) -> Tuple[int, ...]:
        return tuple(s.dim for s in self.schema.slots_config.values())

    def model(self, device=None, **kw):
        """The scenario's tower on ``device`` (default CUDA), weights not
        yet drawn (``TrainCtx(seed=)`` or ``weights.init_params`` draws
        them)."""
        return self.model_fn(self.num_dense, self.slot_dims, device=device,
                             **kw)


_FACTORIES: Dict[str, Callable[..., Scenario]] = {}


def register_scenario(name: str):
    def deco(fn):
        _FACTORIES[name] = fn
        return fn
    return deco


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(_FACTORIES))


def get_scenario(name: str, smoke: bool = False,
                 alpha: Optional[float] = None,
                 seed: Optional[int] = None, **kw) -> Scenario:
    """Resolve a scenario by name. ``smoke`` shrinks vocabs and batches;
    ``alpha`` and ``seed`` default to ``PERSIA_WORKLOAD_ALPHA`` and
    ``PERSIA_WORKLOAD_SEED``."""
    if name not in _FACTORIES:
        raise KeyError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(scenario_names())}")
    if alpha is None:
        alpha = float(os.environ.get("PERSIA_WORKLOAD_ALPHA", DEFAULT_ALPHA))
    if seed is None:
        seed = int(os.environ.get("PERSIA_WORKLOAD_SEED", DEFAULT_SEED))
    return _FACTORIES[name](smoke=smoke, alpha=alpha, seed=seed, **kw)


def _bind_seed(fn, default_seed):
    """A generator (its spec bound) with the scenario's seed as default;
    eval streams pass ``seed + 1000``, a disjoint draw of the same task."""
    def batches(num_samples, batch_size, seed=default_seed,
                requires_grad=True):
        return fn(num_samples, batch_size, seed=seed,
                  requires_grad=requires_grad)
    return batches


@register_scenario("dlrm")
def _dlrm(smoke: bool = False, alpha: float = DEFAULT_ALPHA, seed: int = 0,
          scale: Optional[float] = None) -> Scenario:
    """Criteo-schema DLRM: 26 zipf tables with a log-spread vocab and dim
    mix, 13 dense floats, the mixed-dim interaction tower; single-id
    features only."""
    from persia_tpu_torch.workloads.models import ZooDLRM

    if scale is None:
        scale = 0.02 if smoke else 0.2
    spec = gen.CriteoSpec.build(scale=scale, alpha=alpha)
    slots = {
        name: SlotConfig(name=name, dim=spec.dims[t])
        for t, name in enumerate(gen.CRITEO_SLOT_NAMES)
    }
    return Scenario(
        name="dlrm",
        description=("Criteo-schema DLRM: 26 zipf tables (mixed "
                     "vocab/dim), 13 dense, pairwise interaction"),
        schema=EmbeddingSchema(slots_config=slots),
        model_fn=functools.partial(ZooDLRM, proj_dim=16),
        batches=_bind_seed(functools.partial(gen.dlrm_batches, spec=spec),
                           seed),
        num_dense=spec.num_dense, auc_gate=0.60,
        bench_batch_size=2048 if not smoke else 256, seed=seed)


@register_scenario("seqrec")
def _seqrec(smoke: bool = False, alpha: float = DEFAULT_ALPHA,
            seed: int = 0) -> Scenario:
    """Session recommendation over worker-pooled ragged history: a
    mean-pooled recent-items slot and a last-N-pooled clicks slot sharing
    the target's item sign space."""
    from persia_tpu_torch.workloads.models import PooledSessionNet

    spec = gen.SeqRecSpec(
        item_vocab=2_000 if smoke else 20_000,
        t_hist=12 if smoke else 20,
        alpha=alpha)
    dim = spec.dim
    slots = {
        **uniform_slots(list(gen.SEQ_PROFILE_SLOTS), dim=dim),
        gen.SEQ_HISTORY_SLOT: SlotConfig(
            name=gen.SEQ_HISTORY_SLOT, dim=dim, pooling="mean"),
        gen.SEQ_CLICKS_SLOT: SlotConfig(
            name=gen.SEQ_CLICKS_SLOT, dim=dim,
            pooling=f"last{spec.last_n}"),
        gen.SEQ_TARGET_SLOT: SlotConfig(
            name=gen.SEQ_TARGET_SLOT, dim=dim),
    }
    return Scenario(
        name="seqrec",
        description=("session/sequence features: ragged histories "
                     "pooled mean + last-N on the worker tier"),
        schema=EmbeddingSchema(slots_config=slots),
        model_fn=PooledSessionNet,
        batches=_bind_seed(functools.partial(gen.seqrec_batches, spec=spec),
                           seed),
        num_dense=spec.num_dense, auc_gate=0.60,
        ragged_features=(gen.SEQ_HISTORY_SLOT, gen.SEQ_CLICKS_SLOT),
        bench_batch_size=512 if not smoke else 128, seed=seed)


@register_scenario("multitask")
def _multitask(smoke: bool = False, alpha: float = DEFAULT_ALPHA,
               seed: int = 0) -> Scenario:
    """Two objectives (click, convert) over one set of embedding tables;
    the labels ride as one (batch, 2) array."""
    from persia_tpu_torch.workloads.models import MultiTaskDNN, multitask_bce

    spec = gen.MultiTaskSpec(
        user_vocab=2_000 if smoke else 20_000,
        item_vocab=5_000 if smoke else 50_000,
        alpha=alpha)
    dim = spec.dim
    slots = {
        "user": SlotConfig(name="user", dim=dim),
        "item": SlotConfig(name="item", dim=dim),
        "ctx_0": SlotConfig(name="ctx_0", dim=8),
        "ctx_1": SlotConfig(name="ctx_1", dim=8),
    }
    return Scenario(
        name="multitask",
        description=("multi-task head (click + convert) sharing "
                     "embedding tables across two objectives"),
        schema=EmbeddingSchema(slots_config=slots),
        model_fn=functools.partial(MultiTaskDNN, num_tasks=2),
        batches=_bind_seed(
            functools.partial(gen.multitask_batches, spec=spec), seed),
        num_dense=spec.num_dense, tasks=gen.MT_TASKS,
        loss_fn=multitask_bce, auc_gate=0.55,
        bench_batch_size=1024 if not smoke else 256, seed=seed)


def evaluate_auc(ctx, scenario: Scenario, num_samples: int = 4096,
                 batch_size: int = 512,
                 seed_offset: int = 1000) -> Dict[str, float]:
    """Held-out AUC of each task through ``eval_ctx(ctx)``, on the stream
    of ``scenario.seed + seed_offset``: a disjoint draw of the same
    task."""
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.utils import roc_auc

    preds, labels = [], []
    with eval_ctx(ctx) as ectx:
        for batch in scenario.batches(num_samples, batch_size,
                                      seed=scenario.seed + seed_offset,
                                      requires_grad=False):
            pred, lab = ectx.forward(batch)
            preds.append(pred.float().cpu().numpy())
            labels.append(np.asarray(lab[0]))
    pred = np.concatenate(preds)
    pred = pred.reshape(pred.shape[0], -1)
    label = np.concatenate(labels).reshape(pred.shape[0], -1)
    return {
        task: float(roc_auc(label[:, t], pred[:, t]))
        for t, task in enumerate(scenario.tasks)
    }
