"""Client-side embedding hyperparameters (``persia_tpu/embedding/__init__.py``).

``EmbeddingConfig`` travels with the embedding context to the parameter
servers, where it gates admission of new signs and bounds the weights
after every update.
"""

from typing import Tuple


class EmbeddingConfig:
    """Embedding hyperparameters.

    Args:
        emb_initialization: lower and upper bound of the per-sign uniform
            initialization of new embedding entries.
        admit_probability: probability (in [0, 1]) of admitting a new sign
            on first lookup; non-admitted signs read as zeros.
        weight_bound: each embedding element is clamped to
            ``[-weight_bound, weight_bound]`` after updates.
    """

    def __init__(self, emb_initialization: Tuple[float, float] = (-0.01, 0.01),
                 admit_probability: float = 1.0, weight_bound: float = 10.0):
        if not 0.0 <= admit_probability <= 1.0:
            raise ValueError("admit_probability must be within [0, 1]")
        self.emb_initialization = emb_initialization
        self.admit_probability = admit_probability
        self.weight_bound = weight_bound


def get_default_embedding_config() -> EmbeddingConfig:
    return EmbeddingConfig()
