"""persia_tpu_torch — the PyTorch / CUDA port of persia_tpu for NVIDIA Hopper.

The JAX package ``persia_tpu`` stays the reference; this package sits
beside it and imports nothing of it (nor of jax, flax or optax). Where it
needs one of the JAX package's numpy-only modules it keeps its own
trimmed copy under the same relative path.

The slices ported so far are the serving and training paths of the
sequence-tower model, and device-mode training of DLRM:

    InferenceServer -> EmbeddingWorker lookup -> InferCtx.forward_prepared
    -> SequenceTower -> flash-attention forward (hand-written CUDA kernel)

    TrainCtx.train_step -> EmbeddingWorker training lookup (the native
    C++ PS, its spill tier and hotness sketches) -> packed bf16 wire ->
    SequenceTower forward (K2 with logsumexp) -> backward (CUDA kernels
    K3, K4) -> dense Adam -> bf16
    gradient wire -> EmbeddingWorker.update_gradients -> sparse optimizer
    on the PS; pipelined, a DataLoader's ForwardEngine runs the lookup and
    the device staging in prefetch threads and a BackwardEngine the
    gradient download and the PS update in background threads

    make_device_mode_trainer step -> DeviceModeModel: hashed tables on
    the card -> pooled lookups (CUDA kernel K1) -> DLRM -> backward
    (table gradients as the rows read; densified, the JAX package's dense
    scatter-add) -> OptaxAdagrad over tables (the row-wise CUDA kernel,
    touched rows only) and tower

The sparse tier also runs as processes of its own
(:mod:`persia_tpu_torch.service`): a coordinator, PS and worker services
over the RPC wire, and ``ServiceCtx`` to start them; a ``TrainCtx`` or an
``InferenceServer`` takes their ``RemoteEmbeddingWorker`` as it takes an
in-process worker.

A job survives a trainer restart: ``TrainCtx.snapshot`` writes the PS
shards (resident and spilled rows), the dense state and the data cursor
as one manifest-stamped unit, and ``TrainCtx(resume_from=)`` rolls a
fresh stack back to it.

The copy-shape probe (CUDA kernel K5) is ``python -m
persia_tpu_torch.ops.probe_copy``.

Entry points take an explicit ``device`` that defaults to CUDA and raise
when no CUDA device is present, unless the caller asks for ``"cpu"``.
"""

# the distribution's version (pyproject.toml); the sidecar's /healthz
# reports it so a fleet view can spot replica skew
__version__ = "0.4.0"

__all__ = ["resolve_device", "__version__"]


def __getattr__(name):
    # torch loads with the first entry point that needs it: the service
    # processes that never touch a tensor (the coordinator, the PS and
    # the worker) start without it
    if name == "resolve_device":
        from persia_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
