"""The yardstick: the card's peaks and the work a step needs.

Counts follow the configuration and the inputs, not the program: they
count the same work whatever implements it, so a fused kernel or a
row-wise optimizer raises a share and does not stale its count.
"""

from portbench.arch import Arch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def tower_macs(a: Arch) -> int:
    """Forward multiply-adds a sample of the DLRM tower: every layer's
    product and the interaction's (F+1) x (F+1) x dim batched product, as
    the published model computes it."""
    dense = sum(i * o for i, o in a.bottom_layers() + a.top_layers())
    f = a.fields + 1
    return dense + f * f * a.dim


def tower_flops(a: Arch, train: bool) -> int:
    """FLOPs a sample (2 a multiply-add). A training step adds the
    backward: both gradients of every product (operand and weight),
    except the gradient of the dense input, which nothing needs."""
    fwd = tower_macs(a)
    if not train:
        return 2 * fwd
    n_in, n_out = a.bottom_layers()[0]
    return 2 * (3 * fwd - n_in * n_out)


def tower_params(a: Arch) -> int:
    return sum(i * o + o for i, o in a.bottom_layers() + a.top_layers())


def k1_bytes(ids: int, distinct_rows: int, batch: int, a: Arch,
             id_bytes: int = 4, out_bytes: int = 2) -> int:
    """The bytes one pooled lookup of a batch needs: each non-padding id
    read once, each distinct row the batch touches read once (float32),
    and the (batch, fields, dim) pooled output written once (bfloat16)."""
    return (ids * id_bytes + distinct_rows * a.dim * 4
            + batch * a.fields * a.dim * out_bytes)


def adagrad_bytes(distinct_rows: int, a: Arch) -> int:
    """The bytes one Adagrad update needs: parameter, accumulator and
    gradient read once, parameter and accumulator written once (float32),
    for each distinct table row the batch touched (rows with no gradient
    do not move) and each tower parameter."""
    return 5 * 4 * (distinct_rows * a.dim + tower_params(a))


def bound_s(nbytes: float) -> float:
    """The least time on an H100 to move ``nbytes`` through HBM."""
    return nbytes / PEAK_BYTES_PER_S
