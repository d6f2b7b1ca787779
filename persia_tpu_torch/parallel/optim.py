"""Optimizers with optax's exact update rules.

``torch.optim.Adagrad`` is not ``optax.adagrad``: it starts the
accumulator at 0, adds eps outside the square root and has a learning-rate
decay. :class:`OptaxAdagrad` is ``optax.adagrad`` = ``scale_by_rss``
followed by ``scale(-lr)``, which device-mode training uses on the tables
and the tower alike: a dense gradient through foreach passes, a table's
row gradient (sparse, device mode's tables) through the row-wise kernel
of :mod:`persia_tpu_torch.ops.rowwise_adagrad`, which updates only the
rows it holds; its densified form is the JAX package's dense scatter-add,
and both paths apply the same update to it.
"""

import torch

from persia_tpu_torch import tracing
from persia_tpu_torch.ops.rowwise_adagrad import rowwise_adagrad


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``. Per
    parameter, with accumulator ``s`` starting at
    ``initial_accumulator_value``::

        s <- s + g^2
        p <- p - lr * g * rsqrt(s + eps)

    optax zeroes the update where ``s`` is not positive; with a
    non-negative start ``s >= g^2``, so ``s`` is 0 only where ``g`` is 0
    and the update is 0 there anyway. A parameter without a gradient is
    left alone, as is its accumulator. The step runs as a handful of
    ``torch._foreach_*`` passes over the parameters of a group whose
    gradient is dense; a parameter whose gradient is sparse (a table's
    row gradient) goes to :func:`~persia_tpu_torch.ops.rowwise_adagrad.
    rowwise_adagrad`, one call for the group under the span
    ``optim/rowwise`` (tagged with its tables and ids), which touches only
    the rows the gradient holds. The accumulator is dense either way.
    """

    # takes row (sparse) gradients: device mode leaves them unconverted
    takes_row_grads = True

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        if lr < 0:
            raise ValueError(f"lr must be >= 0, got {lr}")
        if initial_accumulator_value < 0:
            raise ValueError(f"initial_accumulator_value must be >= 0, got "
                             f"{initial_accumulator_value}")
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            dense, rows = ([], [], []), ([], [], [])
            for p in group["params"]:
                g = p.grad
                if g is None:
                    continue
                state = self.state[p]
                if "sum_of_squares" not in state:
                    state["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"],
                        memory_format=torch.preserve_format)
                part = rows if g.is_sparse else dense
                part[0].append(p)
                part[1].append(g)
                part[2].append(state["sum_of_squares"])
            params, grads, sums = dense
            if params:
                torch._foreach_addcmul_(sums, grads, grads)
                upd = torch._foreach_add(sums, group["eps"])
                torch._foreach_rsqrt_(upd)
                torch._foreach_mul_(upd, grads)
                torch._foreach_add_(params, upd, alpha=-group["lr"])
            if rows[0]:
                with tracing.span("optim/rowwise") as sp:
                    n = rowwise_adagrad(*rows, group["lr"], group["eps"])
                    sp.tag(tables=len(rows[0]), ids=n)
        return loss
