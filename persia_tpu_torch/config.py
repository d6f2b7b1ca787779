"""Embedding schema and job configuration (``persia_tpu/config.py``).

Two YAML documents configure a job: :class:`GlobalConfig` (job type,
checkpointing, embedding-worker and parameter-server settings) and
:class:`EmbeddingSchema` (the slots and feature groups). Both load
through the port's own YAML reader (:mod:`persia_tpu_torch._yaml`) and
read the same keys, with the same defaults, as the JAX package.

Raw (non-summed) slots always produce a dense ``(batch,
sample_fixed_size)`` index tensor into a fixed-capacity embedding tensor
whose row 0 is zeros; index 0 means padding.
"""

import copy
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List

from persia_tpu_torch.utils import load_yaml


class JobType(Enum):
    TRAIN = "Train"
    EVAL = "Eval"
    INFER = "Infer"


class InitializationMethod(Enum):
    BOUNDED_UNIFORM = "bounded_uniform"
    BOUNDED_GAMMA = "bounded_gamma"
    BOUNDED_POISSON = "bounded_poisson"
    NORMAL = "normal"
    TRUNCATED_NORMAL = "truncated_normal"
    ZERO = "zero"


@dataclass
class InitializationConfig:
    method: InitializationMethod = InitializationMethod.BOUNDED_UNIFORM
    lower: float = -0.01
    upper: float = 0.01
    mean: float = 0.0
    standard_deviation: float = 0.01
    shape: float = 1.0
    scale: float = 1.0
    lam: float = 1.0

    def to_params(self) -> dict:
        return {
            "lower": self.lower,
            "upper": self.upper,
            "mean": self.mean,
            "standard_deviation": self.standard_deviation,
            "shape": self.shape,
            "scale": self.scale,
            "lambda": self.lam,
        }


@dataclass
class HashStackConfig:
    """Multi-round hashing that compresses a huge vocab into
    ``hash_stack_rounds`` lookups in a table of ``embedding_size`` rows."""

    hash_stack_rounds: int = 0
    embedding_size: int = 0


@dataclass
class SlotConfig:
    """Schema of one sparse feature slot.

    ``pooling`` selects how a summed slot's per-sample sign list collapses
    to one (batch, dim) vector on the worker tier: ``"sum"``, ``"mean"``
    (sum scaled by 1/n) or ``"last<k>"`` (sum of the last k signs). Non-sum
    pooling composes with neither ``sqrt_scaling``, hashstack nor raw slots.
    """

    name: str
    dim: int
    sample_fixed_size: int = 10
    embedding_summation: bool = True
    sqrt_scaling: bool = False
    hash_stack_config: HashStackConfig = field(default_factory=HashStackConfig)
    index_prefix: int = 0  # assigned automatically from feature groups
    pooling: str = "sum"

    def __post_init__(self):
        if self.pooling_last_n is None:
            raise ValueError(
                f"slot {self.name!r}: pooling must be 'sum', 'mean' or "
                f"'last<k>' (k >= 1), got {self.pooling!r}")
        if self.pooling == "sum":
            return
        if not self.embedding_summation:
            raise ValueError(
                f"slot {self.name!r}: pooling={self.pooling!r} applies to "
                f"summed slots only; raw slots keep their sequences")
        if self.sqrt_scaling:
            raise ValueError(
                f"slot {self.name!r}: sqrt_scaling composes only with "
                f"pooling='sum'")
        if self.hash_stack_config.hash_stack_rounds:
            raise ValueError(
                f"slot {self.name!r}: hashstack repeats every element per "
                f"round, which would corrupt {self.pooling!r} pooling's "
                f"per-sample counts; use pooling='sum'")

    @property
    def pooling_last_n(self):
        """k for ``last<k>`` pooling; 0 for sum/mean; None when malformed."""
        p = self.pooling
        if p in ("sum", "mean"):
            return 0
        if p.startswith("last") and p[4:].isdigit() and int(p[4:]) > 0:
            return int(p[4:])
        return None


@dataclass
class EmbeddingSchema:
    """All slots plus the feature-group prefix layout.

    ``feature_index_prefix_bit`` reserves the top N bits of the u64 sign
    space per feature group so different groups never collide in the
    shared parameter-server keyspace; 0 disables prefixing.
    """

    slots_config: Dict[str, SlotConfig]
    feature_index_prefix_bit: int = 0
    feature_groups: Dict[str, List[str]] = field(default_factory=dict)
    initialization: InitializationConfig = field(
        default_factory=InitializationConfig)

    def __post_init__(self):
        self._assign_index_prefixes()

    def _assign_index_prefixes(self):
        if self.feature_index_prefix_bit <= 0:
            return
        if self.feature_index_prefix_bit >= 64:
            raise ValueError("feature_index_prefix_bit must be < 64")
        seen: Dict[str, str] = {}
        for group, slots in self.feature_groups.items():
            for s in slots:
                if s in seen:
                    raise ValueError(
                        f"slot {s!r} listed in feature groups {seen[s]!r} "
                        f"and {group!r}; a slot may belong to only one "
                        f"feature group")
                seen[s] = group
        for name in self.slots_config:
            if name not in seen:
                if name in self.feature_groups:
                    raise ValueError(
                        f"ungrouped slot {name!r} has the same name as a "
                        f"feature group")
                self.feature_groups[name] = [name]
        shift = 64 - self.feature_index_prefix_bit
        for group_index, (_group, slot_names) in enumerate(
                sorted(self.feature_groups.items()), start=1):
            if group_index >= (1 << self.feature_index_prefix_bit):
                raise ValueError(
                    f"too many feature groups for feature_index_prefix_bit="
                    f"{self.feature_index_prefix_bit}")
            prefix = group_index << shift
            for slot_name in slot_names:
                if slot_name not in self.slots_config:
                    raise ValueError(
                        f"feature group references unknown slot {slot_name}")
                if self.slots_config[slot_name].index_prefix != 0:
                    raise ValueError(
                        f"slot {slot_name!r} already has index_prefix set; "
                        f"do not set index_prefix manually")
                self.slots_config[slot_name].index_prefix = prefix

    @property
    def feature_spacing(self) -> int:
        """Usable sign space under each prefix."""
        if self.feature_index_prefix_bit > 0:
            return (1 << (64 - self.feature_index_prefix_bit)) - 1
        return (1 << 64) - 1

    def get_slot(self, feature_name: str) -> SlotConfig:
        try:
            return self.slots_config[feature_name]
        except KeyError:
            raise KeyError(
                f"feature {feature_name!r} not in embedding schema "
                f"(slots: {list(self.slots_config)})") from None

    @property
    def feature_names(self) -> List[str]:
        return list(self.slots_config.keys())

    @classmethod
    def load(cls, path: str) -> "EmbeddingSchema":
        return cls.from_dict(load_yaml(path))

    @classmethod
    def from_dict(cls, raw: dict) -> "EmbeddingSchema":
        raw = copy.deepcopy(raw)
        slots = {}
        for name, sc in raw.get("slots_config", {}).items():
            hs = sc.get("hash_stack_config", {}) or {}
            slots[name] = SlotConfig(
                name=name,
                dim=int(sc["dim"]),
                sample_fixed_size=int(sc.get("sample_fixed_size", 10)),
                embedding_summation=bool(sc.get("embedding_summation",
                                                True)),
                sqrt_scaling=bool(sc.get("sqrt_scaling", False)),
                hash_stack_config=HashStackConfig(
                    hash_stack_rounds=int(hs.get("hash_stack_rounds", 0)),
                    embedding_size=int(hs.get("embedding_size", 0))),
                pooling=str(sc.get("pooling", "sum")),
            )
        init_raw = raw.get("initialization", {}) or {}
        init = InitializationConfig(
            method=InitializationMethod(
                init_raw.get("method", "bounded_uniform")),
            lower=float(init_raw.get("lower", -0.01)),
            upper=float(init_raw.get("upper", 0.01)),
            mean=float(init_raw.get("mean", 0.0)),
            standard_deviation=float(init_raw.get("standard_deviation",
                                                  0.01)),
            shape=float(init_raw.get("shape", 1.0)),
            scale=float(init_raw.get("scale", 1.0)),
            lam=float(init_raw.get("lambda", 1.0)),
        )
        return cls(
            slots_config=slots,
            feature_index_prefix_bit=int(
                raw.get("feature_index_prefix_bit", 0)),
            feature_groups={k: list(v) for k, v in
                            (raw.get("feature_groups", {}) or {}).items()},
            initialization=init,
        )


def uniform_slots(
    names: List[str],
    dim: int,
    embedding_summation: bool = True,
    sample_fixed_size: int = 10,
    pooling: str = "sum",
) -> Dict[str, SlotConfig]:
    """Identical slots for a list of feature names."""
    return {
        n: SlotConfig(name=n, dim=dim,
                      embedding_summation=embedding_summation,
                      sample_fixed_size=sample_fixed_size, pooling=pooling)
        for n in names
    }


@dataclass
class CheckpointingConfig:
    num_workers: int = 4


@dataclass
class EmbeddingWorkerConfig:
    forward_buffer_size: int = 1000
    buffered_data_expired_sec: int = 1800


@dataclass
class EmbeddingParameterServerConfig:
    capacity: int = 1_000_000_000
    num_hashmap_internal_shards: int = 100
    # storage precision of the embedding slice of every row ("fp32" |
    # "fp16" | "bf16"); optimizer state stays fp32
    row_dtype: str = "fp32"
    # byte budget for eviction (0 = row-count capacity only)
    capacity_bytes: int = 0
    # a directory arms the disk spill tier (evicted rows demoted, faulted
    # back in on lookup); spill_bytes 0 = unbounded disk budget
    spill_dir: str = ""
    spill_bytes: int = 0
    # read for config-file compatibility; full dumps go through
    # checkpoint.dump_sharded
    full_amount_manager_buffer_size: int = 1000
    # the incremental-update tier (refused by the PS service until it is
    # ported)
    enable_incremental_update: bool = False
    incremental_buffer_size: int = 5_000_000
    incremental_dir: str = "/tmp/persia_inc_dump"


@dataclass
class CommonConfig:
    # dtype of the embedding values and gradients on the host <-> device
    # wire: "bf16" (the default) or "f32"; the first field, so
    # ``CommonConfig("f32")`` keeps its meaning
    embedding_wire_dtype: str = "bf16"
    job_type: JobType = JobType.TRAIN
    metrics_enabled: bool = False
    metrics_push_interval_sec: int = 10
    checkpointing: CheckpointingConfig = field(
        default_factory=CheckpointingConfig)
    # Infer-mode fixed addresses and the initial sparse checkpoint
    infer_servers: List[str] = field(default_factory=list)
    infer_initial_sparse_checkpoint: str = ""

    def __post_init__(self):
        if self.embedding_wire_dtype not in ("bf16", "f32"):
            raise ValueError(
                f"embedding_wire_dtype must be 'bf16' or 'f32', got "
                f"{self.embedding_wire_dtype!r}")


@dataclass
class GlobalConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
    embedding_worker: EmbeddingWorkerConfig = field(
        default_factory=EmbeddingWorkerConfig)
    parameter_server: EmbeddingParameterServerConfig = field(
        default_factory=EmbeddingParameterServerConfig)

    @classmethod
    def load(cls, path: str) -> "GlobalConfig":
        return cls.from_dict(load_yaml(path))

    @classmethod
    def from_dict(cls, raw: dict) -> "GlobalConfig":
        raw = raw or {}
        common_raw = raw.get("common_config", raw.get("common", {})) or {}
        ckpt_raw = common_raw.get("checkpointing_config", {}) or {}
        infer_raw = common_raw.get("infer_config", {}) or {}
        metrics_raw = common_raw.get("metrics_config", {}) or {}
        worker_raw = raw.get("embedding_worker_config",
                             raw.get("embedding_worker", {})) or {}
        ps_raw = raw.get("embedding_parameter_server_config",
                         raw.get("parameter_server", {})) or {}
        return cls(
            common=CommonConfig(
                job_type=JobType(common_raw.get("job_type", "Train")),
                metrics_enabled=bool(metrics_raw.get("enable_metrics",
                                                     False)),
                metrics_push_interval_sec=int(
                    metrics_raw.get("push_interval_sec", 10)),
                checkpointing=CheckpointingConfig(
                    num_workers=int(ckpt_raw.get("num_workers", 4))),
                infer_servers=list(infer_raw.get("servers", []) or []),
                infer_initial_sparse_checkpoint=str(
                    infer_raw.get("initial_sparse_checkpoint", "")),
                embedding_wire_dtype=str(
                    common_raw.get("embedding_wire_dtype", "bf16")),
            ),
            embedding_worker=EmbeddingWorkerConfig(
                forward_buffer_size=int(
                    worker_raw.get("forward_buffer_size", 1000)),
                buffered_data_expired_sec=int(
                    worker_raw.get("buffered_data_expired_sec", 1800)),
            ),
            parameter_server=EmbeddingParameterServerConfig(
                capacity=int(ps_raw.get("capacity", 1_000_000_000)),
                num_hashmap_internal_shards=int(
                    ps_raw.get("num_hashmap_internal_shards", 100)),
                row_dtype=str(ps_raw.get("row_dtype", "fp32")),
                capacity_bytes=int(ps_raw.get("capacity_bytes", 0)),
                spill_dir=str(ps_raw.get("spill_dir", "") or ""),
                spill_bytes=int(ps_raw.get("spill_bytes", 0)),
                full_amount_manager_buffer_size=int(
                    ps_raw.get("full_amount_manager_buffer_size", 1000)),
                enable_incremental_update=bool(
                    ps_raw.get("enable_incremental_update", False)),
                incremental_buffer_size=int(
                    ps_raw.get("incremental_buffer_size", 5_000_000)),
                incremental_dir=str(
                    ps_raw.get("incremental_dir", "/tmp/persia_inc_dump")),
            ),
        )
