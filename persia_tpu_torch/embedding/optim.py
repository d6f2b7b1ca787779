"""Client-side sparse-optimizer configuration (``persia_tpu/embedding/optim.py``).

These classes only describe the optimizer; the numerics run on the
parameter servers (:mod:`persia_tpu_torch.ps.optim`). ``apply()`` registers
the config on every parameter server through the current context.
"""

from typing import Tuple


class Optimizer:
    """Holds a serializable server-side optimizer config."""

    def __init__(self):
        self.config: dict = {}

    def apply(self):
        """Register this optimizer on all parameter servers through the
        innermost entered context."""
        from persia_tpu_torch.ctx import current_ctx

        ctx = current_ctx()
        if ctx is None:
            raise RuntimeError(
                "Optimizer.apply() requires an active EmbeddingCtx/TrainCtx")
        ctx.register_optimizer(self)


class SGD(Optimizer):
    def __init__(self, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__()
        if momentum != 0.0:
            raise NotImplementedError(
                "momentum is not supported by the server-side SGD")
        self.lr = lr
        self.weight_decay = weight_decay
        self.config = {"type": "sgd", "lr": lr, "wd": weight_decay}


class Adam(Optimizer):
    def __init__(self, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 weight_decay: float = 0.0, eps: float = 1e-8):
        super().__init__()
        self.lr = lr
        self.betas = betas
        self.weight_decay = weight_decay
        self.eps = eps
        self.config = {"type": "adam", "lr": lr, "beta1": betas[0],
                       "beta2": betas[1], "eps": eps}


class Adagrad(Optimizer):
    def __init__(self, lr: float = 1e-2,
                 initial_accumulator_value: float = 1e-2,
                 weight_decay: float = 0.0, g_square_momentum: float = 1.0,
                 eps: float = 1e-10, vectorwise_shared: bool = False):
        super().__init__()
        self.lr = lr
        self.initial_accumulator_value = initial_accumulator_value
        self.weight_decay = weight_decay
        self.g_square_momentum = g_square_momentum
        self.eps = eps
        self.vectorwise_shared = vectorwise_shared
        self.config = {"type": "adagrad", "lr": lr, "wd": weight_decay,
                       "g_square_momentum": g_square_momentum,
                       "initialization": initial_accumulator_value,
                       "eps": eps, "vectorwise_shared": vectorwise_shared}
