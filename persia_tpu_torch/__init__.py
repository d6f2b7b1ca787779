"""persia_tpu_torch — the PyTorch / CUDA port of persia_tpu for NVIDIA Hopper.

The JAX package ``persia_tpu`` stays the reference; this package sits
beside it and imports nothing of it (nor of jax, flax or optax). Where it
needs one of the JAX package's numpy-only modules it keeps its own
trimmed copy under the same relative path.

The slice ported so far is the serving path of the sequence-tower model:

    InferenceServer -> EmbeddingWorker lookup -> InferCtx.forward_prepared
    -> SequenceTower -> flash-attention forward (hand-written CUDA kernel)

Entry points take an explicit ``device`` that defaults to CUDA and raise
when no CUDA device is present, unless the caller asks for ``"cpu"``.
"""

from persia_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
