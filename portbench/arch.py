"""A DLRM configuration file's widths, and the leaves its weights fill.

The keys are facebookresearch/dlrm's own (``dlrm_s_pytorch.py``'s
arguments): ``arch_mlp_bot`` "13-512-256-64-16" is the dense input, the
bottom MLP's hidden widths and the embedding dim; ``arch_mlp_top``
"512-256-1" the top MLP's widths, its input (the embedding dim plus one
dot product a pair of fields, without self pairs) prepended by the model;
``arch_embedding_size`` the rows of each table, dash-separated.
"""

from dataclasses import dataclass
from typing import List, Tuple


def _widths(text: str) -> Tuple[int, ...]:
    return tuple(int(w) for w in str(text).split("-"))


@dataclass(frozen=True)
class Arch:
    num_dense: int
    bottom: Tuple[int, ...]  # hidden widths; the embedding dim follows
    top: Tuple[int, ...]  # hidden widths; the output width 1 follows
    dim: int
    rows: Tuple[int, ...]  # one table a field
    compute_dtype: str
    lr: float
    initial_accumulator: float
    eps: float

    @property
    def fields(self) -> int:
        return len(self.rows)

    @property
    def top_in(self) -> int:
        f = self.fields + 1  # the bottom MLP's output joins the fields
        return self.dim + f * (f - 1) // 2

    def bottom_layers(self) -> List[Tuple[int, int]]:
        """(in, out) of each bottom MLP layer."""
        w = (self.num_dense, *self.bottom, self.dim)
        return list(zip(w[:-1], w[1:]))

    def top_layers(self) -> List[Tuple[int, int]]:
        w = (self.top_in, *self.top, 1)
        return list(zip(w[:-1], w[1:]))


def arch(config: dict) -> Arch:
    """The widths of a configuration file, checked against what device
    mode's DLRM computes (a dot interaction without self pairs, float32
    parameters, an Adagrad optimizer)."""
    bot = _widths(config["arch_mlp_bot"])
    top = _widths(config["arch_mlp_top"])
    dim = int(config["arch_sparse_feature_size"])
    if bot[-1] != dim:
        raise ValueError(f"the bottom MLP ends at {bot[-1]}, the embedding "
                         f"dim is {dim}")
    if top[-1] != 1:
        raise ValueError(f"the top MLP must end in 1, got {top}")
    if config.get("arch_interaction_op") != "dot" or config.get(
            "arch_interaction_itself"):
        raise ValueError("device mode's DLRM takes a dot interaction "
                         "without self pairs")
    if config.get("param_dtype") != "float32":
        raise ValueError("device mode keeps float32 parameters")
    opt = config["optimizer"]
    if opt["name"] != "adagrad":
        raise ValueError(f"device mode trains with adagrad, got "
                         f"{opt['name']}")
    return Arch(num_dense=bot[0], bottom=bot[1:-1], top=top[:-1], dim=dim,
                rows=_widths(config["arch_embedding_size"]),
                compute_dtype=config["compute_dtype"],
                lr=float(opt["learning_rate"]),
                initial_accumulator=float(opt["initial_accumulator_value"]),
                eps=float(opt["eps"]))


@dataclass(frozen=True)
class Leaf:
    """One parameter tensor and the law of its initial values:
    ``uniform`` in [-scale, scale) or ``normal`` with std ``scale``."""

    name: str
    shape: Tuple[int, ...]
    law: str
    scale: float

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def leaves(a: Arch) -> List[Leaf]:
    """Every table in field order, then each bottom and each top MLP
    layer's weight (out, in) and bias, with dlrm_s_pytorch.py's laws."""
    out = [Leaf(f"table{i}", (rows, a.dim), "uniform", (1.0 / rows) ** 0.5)
           for i, rows in enumerate(a.rows)]
    for part, layers in (("bottom", a.bottom_layers()),
                         ("top", a.top_layers())):
        for i, (n_in, n_out) in enumerate(layers):
            out.append(Leaf(f"{part}{i}.weight", (n_out, n_in), "normal",
                            (2.0 / (n_in + n_out)) ** 0.5))
            out.append(Leaf(f"{part}{i}.bias", (n_out,), "normal",
                            (1.0 / n_out) ** 0.5))
    return out
