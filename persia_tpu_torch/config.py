"""Embedding schema and the job configuration the port needs so far.

A trimmed copy of ``persia_tpu/config.py`` (``InitializationConfig``,
``HashStackConfig``, ``SlotConfig``, ``EmbeddingSchema``,
``uniform_slots``, and of ``GlobalConfig.common`` only
``embedding_wire_dtype``). YAML loading and the rest of the job
configuration are not ported yet.

Raw (non-summed) slots always produce a dense ``(batch,
sample_fixed_size)`` index tensor into a fixed-capacity embedding tensor
whose row 0 is zeros; index 0 means padding.
"""

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List


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
class CommonConfig:
    # dtype of the embedding values and gradients on the host <-> device
    # wire: "bf16" (the default) or "f32"
    embedding_wire_dtype: str = "bf16"

    def __post_init__(self):
        if self.embedding_wire_dtype not in ("bf16", "f32"):
            raise ValueError(
                f"embedding_wire_dtype must be 'bf16' or 'f32', got "
                f"{self.embedding_wire_dtype!r}")


@dataclass
class GlobalConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
