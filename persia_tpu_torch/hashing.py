"""64-bit hashing for sign→shard routing and hashstack compression.

A copy of ``persia_tpu/hashing.py``: FarmHash64 of the 8-byte
little-endian encoding of a sign (FarmHash's HashLen0to16 for len == 8),
scalar and vectorized, bit-exact with the JAX package and the native C++
runtime.
"""

import numpy as np

_MASK = 0xFFFFFFFFFFFFFFFF
_K2 = 0x9AE16A3B2F90404F
_MUL8 = (_K2 + 16) & _MASK  # HashLen0to16's `mul` for len == 8


def farmhash64(sign: int) -> int:
    """FarmHash64 of one sign, a Python int (all arithmetic modulo
    2**64)."""
    a = (sign + _K2) & _MASK
    b = sign & _MASK
    c = ((((b >> 37) | (b << 27)) & _MASK) * _MUL8 + a) & _MASK
    d = ((((a >> 25) | (a << 39)) & _MASK) + b) * _MUL8 & _MASK
    h = ((c ^ d) * _MUL8) & _MASK
    h ^= h >> 47
    h = ((d ^ h) * _MUL8) & _MASK
    h ^= h >> 47
    return (h * _MUL8) & _MASK


def farmhash64_np(signs: np.ndarray) -> np.ndarray:
    """FarmHash64 over a uint64 array (all arithmetic modulo 2**64)."""
    s = signs.astype(np.uint64, copy=False)
    k2 = np.uint64(_K2)
    mul = np.uint64(_MUL8)
    with np.errstate(over="ignore"):
        a = s + k2
        b = s
        c = (((b >> np.uint64(37)) | (b << np.uint64(27))) * mul) + a
        d = (((a >> np.uint64(25)) | (a << np.uint64(39))) + b) * mul
        h = (c ^ d) * mul
        h ^= h >> np.uint64(47)
        h = (d ^ h) * mul
        h ^= h >> np.uint64(47)
        h *= mul
    return h


def sign_to_shard(signs: np.ndarray, replica_size: int) -> np.ndarray:
    """Shard index for each sign: farmhash64(sign) % replica_size."""
    return (farmhash64_np(signs) % np.uint64(replica_size)).astype(np.int64)
