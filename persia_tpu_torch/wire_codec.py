"""Payload precision codec for the embedding-tier wire
(``persia_tpu/wire_codec.py``).

Encoders and decoders for the negotiated RPC payload codec (rpc.py's
``__codec__`` probe): lookup responses ship **fp16** rows, gradient
pushes ship **int8** rows with one f32 scale per row. The quantization
residual is fed back into the next shipment of the same sign by the
client (:class:`persia_tpu_torch.worker.middleware.GradErrorFeedback`).

Error bounds: fp16 rows within 2^-11 relative per element; int8 rows
within ``max(|row|) / 254`` absolute per element and shipment.

Pure numpy and symmetric: the client encodes what the server decodes and
back; the ``codec`` key of the pack_arrays meta names the payload's
encoding, so a legacy fp32 payload is one without the key.
"""

from typing import Tuple

import numpy as np

# int8 symmetric range: +-127 (never -128, so dequant is symmetric)
_Q = 127.0


def encode_fp16_rows(rows: np.ndarray) -> np.ndarray:
    """f32 (n, d) -> fp16 (n, d); values are weight-bounded, no overflow."""
    return np.ascontiguousarray(rows, dtype=np.float16)


def decode_fp16_rows(rows: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(rows).astype(np.float32)


def quantize_int8_rows(
    rows: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """f32 (n, d) -> (q int8 (n, d), scales f32 (n,), residual f32 (n, d)).

    Per-row symmetric quantization: ``scale = max(|row|)/127``,
    ``q = round(row/scale)``. The residual ``row - q*scale`` is what the
    caller feeds back into the next shipment of the same sign (error
    feedback); shipping it is optional — dropping it degrades to plain
    deterministic rounding."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    scales = np.maximum(np.max(np.abs(rows), axis=1) / _Q, 1e-30).astype(
        np.float32)
    q = np.clip(np.rint(rows / scales[:, None]), -_Q, _Q).astype(np.int8)
    residual = rows - q.astype(np.float32) * scales[:, None]
    return q, scales, residual


def dequantize_int8_rows(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(q)
    scales = np.ascontiguousarray(scales, dtype=np.float32)
    return q.astype(np.float32) * scales[:, None]
