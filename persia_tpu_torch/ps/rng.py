"""Deterministic, seeded-by-sign entry initialization.

A copy of ``persia_tpu/ps/rng.py``: the same portable RNG spec, so the
rows this package initializes are bit-identical to the JAX package's
(and the native C++ backend's):

- state stream: ``state_k = sign + k * 0x9E3779B97F4A7C15`` (k >= 1)
- output: splitmix64 finalizer of ``state_k``
- u01: ``(output >> 11) * 2**-53`` (uniform in [0, 1), 53-bit)
- bounded_uniform(l, u): ``l + (u - l) * u01``
- normal: Box-Muller on consecutive (u1, u2) pairs, u1 clamped to 2**-53
- gamma: Marsaglia-Tsang (shape >= 1; boost by u**(1/shape) otherwise)
- poisson: Knuth product-of-uniforms
- admission: ``u01(mix(sign ^ ADMIT_SALT)) < p``, one decision per sign

All integer math is modulo 2**64.
"""

import math

import numpy as np

GOLDEN = 0x9E3779B97F4A7C15
ADMIT_SALT = 0x5851F42D4C957F2D
_U64 = np.uint64


def _mix_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized on uint64."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64, copy=True)
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        z ^= z >> _U64(31)
    return z


def _u01(bits: np.ndarray) -> np.ndarray:
    return (bits >> _U64(11)).astype(np.float64) * (2.0**-53)


def raw_stream(signs: np.ndarray, count: int) -> np.ndarray:
    """(n, count) matrix of u01 draws; row i is sign i's stream."""
    signs = signs.astype(np.uint64, copy=False)
    with np.errstate(over="ignore"):
        ks = (np.arange(1, count + 1, dtype=np.uint64)) * _U64(GOLDEN)
        states = signs[:, None] + ks[None, :]
    return _u01(_mix_np(states))


def admit_mask(signs: np.ndarray, admit_probability: float) -> np.ndarray:
    """Deterministic per-sign admission decision."""
    if admit_probability >= 1.0:
        return np.ones(len(signs), dtype=bool)
    with np.errstate(over="ignore"):
        salted = signs.astype(np.uint64) ^ _U64(ADMIT_SALT)
    return _u01(_mix_np(salted)) < admit_probability


def init_bounded_uniform(signs, dim, lower, upper) -> np.ndarray:
    u = raw_stream(signs, dim)
    return (lower + (upper - lower) * u).astype(np.float32)


def init_normal(signs, dim, mean, std) -> np.ndarray:
    pairs = (dim + 1) // 2
    u = raw_stream(signs, pairs * 2)
    u1 = np.maximum(u[:, 0::2], 2.0**-53)
    u2 = u[:, 1::2]
    r = np.sqrt(-2.0 * np.log(u1))
    z0 = r * np.cos(2.0 * math.pi * u2)
    z1 = r * np.sin(2.0 * math.pi * u2)
    z = np.empty((len(signs), pairs * 2))
    z[:, 0::2] = z0
    z[:, 1::2] = z1
    return (mean + std * z[:, :dim]).astype(np.float32)


class _ScalarStream:
    """Scalar view of the same stream, for the rejection-sampling inits."""

    def __init__(self, sign: int):
        self.sign = sign & 0xFFFFFFFFFFFFFFFF
        self.k = 0

    def next_u01(self) -> float:
        self.k += 1
        state = (self.sign + self.k * GOLDEN) & 0xFFFFFFFFFFFFFFFF
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
        return (z >> 11) * (2.0**-53)

    def next_normal(self) -> float:
        u1 = max(self.next_u01(), 2.0**-53)
        u2 = self.next_u01()
        return math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)

    def next_gamma(self, shape: float) -> float:
        if shape < 1.0:
            u = max(self.next_u01(), 2.0**-53)
            return self.next_gamma(shape + 1.0) * u ** (1.0 / shape)
        d = shape - 1.0 / 3.0
        c = 1.0 / math.sqrt(9.0 * d)
        while True:
            x = self.next_normal()
            v = (1.0 + c * x) ** 3
            if v <= 0.0:
                continue
            u = max(self.next_u01(), 2.0**-53)
            if u < 1.0 - 0.0331 * x**4:
                return d * v
            if math.log(u) < 0.5 * x * x + d * (1.0 - v + math.log(v)):
                return d * v

    def next_poisson(self, lam: float) -> int:
        limit = math.exp(-lam)
        k = 0
        p = 1.0
        while True:
            k += 1
            p *= self.next_u01()
            if p <= limit:
                return k - 1


def init_gamma(signs, dim, shape, scale) -> np.ndarray:
    out = np.empty((len(signs), dim), dtype=np.float32)
    for i, s in enumerate(np.asarray(signs, dtype=np.uint64)):
        st = _ScalarStream(int(s))
        out[i] = [st.next_gamma(shape) * scale for _ in range(dim)]
    return out


def init_poisson(signs, dim, lam) -> np.ndarray:
    out = np.empty((len(signs), dim), dtype=np.float32)
    for i, s in enumerate(np.asarray(signs, dtype=np.uint64)):
        st = _ScalarStream(int(s))
        out[i] = [float(st.next_poisson(lam)) for _ in range(dim)]
    return out


def initialize_entries(signs: np.ndarray, dim: int, method: str,
                       params: dict) -> np.ndarray:
    """Dispatch on the initialization method name
    (``config.InitializationMethod``)."""
    if method == "bounded_uniform":
        return init_bounded_uniform(signs, dim, params["lower"],
                                    params["upper"])
    if method == "normal" or method == "truncated_normal":
        # truncated_normal falls back to normal, as in the JAX package
        return init_normal(signs, dim, params["mean"],
                           params["standard_deviation"])
    if method == "bounded_gamma":
        return init_gamma(signs, dim, params["shape"], params["scale"])
    if method == "bounded_poisson":
        return init_poisson(signs, dim, params["lambda"])
    if method == "zero":
        return np.zeros((len(signs), dim), dtype=np.float32)
    raise ValueError(f"unknown initialization method {method!r}")


def internal_shard_of(signs: np.ndarray, num_shards: int) -> np.ndarray:
    """In-process shard pick, independent of the FarmHash process-level
    sharding."""
    return (_mix_np(signs.astype(np.uint64)) % _U64(num_shards)).astype(
        np.int64)
