"""Distinct-id estimation (``persia_tpu/worker/monitor.py``): the
HyperLogLog only, which the hotness sketches count distinct rows with.
The per-feature ``DistinctIdMonitor`` gauge is not ported.
"""

import math

import numpy as np

from persia_tpu_torch.hashing import farmhash64_np


class HyperLogLog:
    """Standard HLL with 2^p registers and small/large range corrections."""

    def __init__(self, p: int = 14):
        if not 4 <= p <= 18:
            raise ValueError("p must be in [4, 18]")
        self.p = p
        self.m = 1 << p
        self.registers = np.zeros(self.m, dtype=np.uint8)
        if self.m >= 128:
            self.alpha = 0.7213 / (1.0 + 1.079 / self.m)
        elif self.m == 64:
            self.alpha = 0.709
        elif self.m == 32:
            self.alpha = 0.697
        else:
            self.alpha = 0.673

    def add_hashed(self, hashes: np.ndarray):
        """Vectorized insert of pre-hashed uint64 values."""
        if len(hashes) == 0:
            # reduceat on an empty segment raises; the old
            # np.maximum.at path was a no-op here (an all-empty sparse
            # slot reaches this via dedup_feature's distinct_signs)
            return
        h = hashes.astype(np.uint64, copy=False)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        rest = h << np.uint64(self.p)  # top p bits consumed
        # rank = leading zeros of `rest` + 1, capped at 64-p+1
        ranks = np.full(len(h), 64 - self.p + 1, dtype=np.uint8)
        nz = rest != 0
        if nz.any():
            # float64 log2 is exact for the leading-bit position here
            bitpos = np.floor(np.log2(rest[nz].astype(np.float64))).astype(np.int64)
            ranks_nz = (63 - bitpos + 1).astype(np.uint8)
            ranks[nz] = ranks_nz
        # segment-max via sort + reduceat instead of np.maximum.at:
        # ufunc.at runs a per-element interpreter loop (it dominated
        # the hotness tracker's lookup-path cost); the sort pass is one
        # C loop and the registers see one gather/scatter
        order = np.argsort(idx, kind="stable")
        si = idx[order]
        sr = ranks[order]
        starts = np.nonzero(np.r_[True, si[1:] != si[:-1]])[0]
        seg_max = np.maximum.reduceat(sr, starts)
        u = si[starts]
        self.registers[u] = np.maximum(self.registers[u], seg_max)

    def add_signs(self, signs: np.ndarray):
        self.add_hashed(farmhash64_np(signs))

    def estimate(self) -> float:
        regs = self.registers.astype(np.float64)
        raw = self.alpha * self.m * self.m / np.sum(2.0 ** (-regs))
        zeros = int((self.registers == 0).sum())
        if raw <= 2.5 * self.m and zeros > 0:
            return self.m * math.log(self.m / zeros)  # small-range correction
        if raw > (1 << 32) / 30.0:
            return -(1 << 32) * math.log(1.0 - raw / (1 << 32))
        return raw
