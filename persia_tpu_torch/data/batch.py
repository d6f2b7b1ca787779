"""Batch construction + the PTB2 wire format.

A copy of ``persia_tpu/data/batch.py``: the PTB2 bytes written here are
byte-identical to the JAX package's, both ways, so clients of either
package can talk to a server of the other.

- ID features are stored **CSR** (offsets + flat signs): one contiguous
  uint64 buffer per feature serializes with zero copies.
- Serialization is a simple length-prefixed little-endian binary layout
  (`PTB2`).
"""

import struct
from typing import List, Optional, Sequence

import numpy as np

from persia_tpu_torch import knobs


def skip_check_data() -> bool:
    """Whether PersiaBatch input validation is disabled
    (``PERSIA_SKIP_CHECK_DATA``, read at call time)."""
    return knobs.get("PERSIA_SKIP_CHECK_DATA")


# Maximum supported batch size: sample indices travel as u16 pairs in the
# worker's dedup maps (reference: persia/embedding/data.py:14).
MAX_BATCH_SIZE = 65535

MAGIC = b"PTB2"

# Header flag bits (PTB2): presence flags instead of in-band sentinels so
# batch_id=-1 and meta=b"" round-trip losslessly.
_FLAG_REQUIRES_GRAD = 1
_FLAG_HAS_BATCH_ID = 2
_FLAG_HAS_META = 4

_ND_SUPPORTED_DTYPES = (
    np.bool_,
    np.int8,
    np.int16,
    np.int32,
    np.int64,
    np.float32,
    np.float64,
    np.uint8,
)

# Stable dtype codes for the wire format.
_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int8): 2,
    np.dtype(np.int16): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.int64): 5,
    np.dtype(np.uint8): 6,
    np.dtype(np.bool_): 7,
    np.dtype(np.uint64): 8,
    np.dtype(np.uint16): 9,  # bf16 raw bits travel as uint16
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


class IDTypeFeature:
    """One sparse categorical feature for a batch, as a list of per-sample
    uint64 ID arrays (LIL). Stored internally as CSR."""

    def __init__(self, name: str, data: List[np.ndarray]):
        if not skip_check_data():
            for x in data:
                if not isinstance(x, np.ndarray) or x.ndim != 1 or x.dtype != np.uint64:
                    raise TypeError(
                        f"id_type_feature {name!r}: every sample must be a 1-D "
                        f"np.uint64 ndarray, got {type(x)} "
                        f"{getattr(x, 'dtype', None)} ndim={getattr(x, 'ndim', None)}"
                    )
        self.name = name
        self.offsets = np.zeros(len(data) + 1, dtype=np.uint32)
        if data:
            np.cumsum([len(x) for x in data], out=self.offsets[1:])
            self.signs = (
                np.concatenate(data) if self.offsets[-1] > 0
                else np.empty(0, dtype=np.uint64)
            ).astype(np.uint64, copy=False)
        else:
            self.signs = np.empty(0, dtype=np.uint64)

    @classmethod
    def from_csr(cls, name: str, offsets: np.ndarray, signs: np.ndarray):
        obj = cls.__new__(cls)
        obj.name = name
        obj.offsets = offsets.astype(np.uint32, copy=False)
        obj.signs = signs.astype(np.uint64, copy=False)
        return obj

    @property
    def batch_size(self) -> int:
        return len(self.offsets) - 1

    @property
    def data(self) -> List[np.ndarray]:
        """LIL view (reference-compatible accessor)."""
        return [
            self.signs[self.offsets[i] : self.offsets[i + 1]]
            for i in range(self.batch_size)
        ]


class IDTypeFeatureWithSingleID(IDTypeFeature):
    """Exactly one ID per sample; single vectorized type check
    (reference: embedding/data.py:116-157)."""

    def __init__(self, name: str, data: np.ndarray):
        if not skip_check_data():
            if (
                not isinstance(data, np.ndarray)
                or data.ndim != 1
                or data.dtype != np.uint64
            ):
                raise TypeError(
                    f"id_type_feature {name!r} must be a 1-D np.uint64 ndarray"
                )
        self.name = name
        self.offsets = np.arange(len(data) + 1, dtype=np.uint32)
        self.signs = data


class NdarrayBase:
    DEFAULT_NAME = "ndarray_base"

    def __init__(self, data: np.ndarray, name: Optional[str] = None):
        if not skip_check_data():
            if not isinstance(data, np.ndarray):
                raise TypeError(f"{name or self.DEFAULT_NAME} must be np.ndarray")
            if data.dtype.type not in _ND_SUPPORTED_DTYPES:
                raise TypeError(
                    f"{name or self.DEFAULT_NAME} unsupported dtype {data.dtype}; "
                    f"supported: {_ND_SUPPORTED_DTYPES}"
                )
            if data.ndim < 1:
                raise ValueError(f"{name or self.DEFAULT_NAME} must have ndim >= 1")
        self.data = np.ascontiguousarray(data)
        self._name = name

    @property
    def name(self) -> str:
        return self._name if self._name is not None else self.DEFAULT_NAME

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


class NonIDTypeFeature(NdarrayBase):
    DEFAULT_NAME = "non_id_type_feature"


class Label(NdarrayBase):
    DEFAULT_NAME = "label"


def _check_batch_size(batch_size: int, target: Optional[int], kind: str, name: str):
    if target is not None and batch_size != target:
        raise ValueError(
            f"{kind} {name!r}: batch_size {batch_size} != expected {target}"
        )
    if batch_size > MAX_BATCH_SIZE:
        raise ValueError(
            f"{kind} {name!r}: batch_size {batch_size} > MAX_BATCH_SIZE {MAX_BATCH_SIZE}"
        )


class PersiaBatch:
    """One training/inference batch: ID features + dense features + labels.

    Reference surface: persia/embedding/data.py:279-411. ``to_bytes`` /
    ``from_bytes`` implement the PTB2 wire layout consumed by the
    dataflow message queue between data-loader and trainer processes.
    """

    def __init__(
        self,
        id_type_features: Sequence[IDTypeFeature],
        non_id_type_features: Optional[Sequence[NonIDTypeFeature]] = None,
        labels: Optional[Sequence[Label]] = None,
        batch_id: Optional[int] = None,
        requires_grad: bool = True,
        meta: Optional[bytes] = None,
    ):
        if len(id_type_features) == 0:
            raise ValueError("id_type_features must be non-empty")
        batch_size = id_type_features[0].batch_size
        for f in id_type_features:
            _check_batch_size(f.batch_size, batch_size, "id_type_feature", f.name)
        for group in (non_id_type_features or []), (labels or []):
            for x in group:
                _check_batch_size(x.batch_size, batch_size, type(x).__name__, x.name)

        self.id_type_features = list(id_type_features)
        self.non_id_type_features = list(non_id_type_features or [])
        self.labels = list(labels or [])
        self.batch_id = batch_id
        self.requires_grad = requires_grad
        self.meta = meta
        self.batch_size = batch_size
        # (worker_addr, ref_id) when a data loader already put this
        # batch's ID features into a remote embedding worker's forward
        # buffer (service.dataflow)
        self.remote_ref = None

    # --- wire format -----------------------------------------------------

    def to_bytes(self) -> bytes:
        out = [MAGIC]
        flags = 0
        if self.requires_grad:
            flags |= _FLAG_REQUIRES_GRAD
        if self.batch_id is not None:
            flags |= _FLAG_HAS_BATCH_ID
        if self.meta is not None:
            flags |= _FLAG_HAS_META
        out.append(
            struct.pack(
                "<qBH",
                self.batch_id if self.batch_id is not None else 0,
                flags,
                self.batch_size,
            )
        )
        meta = self.meta if self.meta is not None else b""
        out.append(struct.pack("<I", len(meta)))
        out.append(meta)

        out.append(struct.pack("<H", len(self.id_type_features)))
        for f in self.id_type_features:
            name_b = f.name.encode()
            out.append(struct.pack("<H", len(name_b)))
            out.append(name_b)
            out.append(struct.pack("<IQ", f.batch_size, len(f.signs)))
            out.append(np.ascontiguousarray(f.offsets).tobytes())
            out.append(np.ascontiguousarray(f.signs).tobytes())

        for group in (self.non_id_type_features, self.labels):
            out.append(struct.pack("<H", len(group)))
            for x in group:
                name_b = x.name.encode()
                out.append(struct.pack("<H", len(name_b)))
                out.append(name_b)
                arr = x.data
                out.append(struct.pack("<BB", _DTYPE_CODES[arr.dtype], arr.ndim))
                out.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
                out.append(arr.tobytes())
        return b"".join(out)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "PersiaBatch":
        view = memoryview(buf)
        if bytes(view[:4]) != MAGIC:
            raise ValueError("bad PersiaBatch magic")
        pos = 4
        batch_id, flags, batch_size = struct.unpack_from("<qBH", view, pos)
        pos += struct.calcsize("<qBH")
        (meta_len,) = struct.unpack_from("<I", view, pos)
        pos += 4
        meta = (
            bytes(view[pos : pos + meta_len]) if flags & _FLAG_HAS_META else None
        )
        pos += meta_len

        (n_id,) = struct.unpack_from("<H", view, pos)
        pos += 2
        id_feats = []
        for _ in range(n_id):
            (name_len,) = struct.unpack_from("<H", view, pos)
            pos += 2
            name = bytes(view[pos : pos + name_len]).decode()
            pos += name_len
            bs, nnz = struct.unpack_from("<IQ", view, pos)
            pos += struct.calcsize("<IQ")
            offsets = np.frombuffer(view, dtype=np.uint32, count=bs + 1, offset=pos)
            pos += 4 * (bs + 1)
            signs = np.frombuffer(view, dtype=np.uint64, count=nnz, offset=pos)
            pos += 8 * nnz
            id_feats.append(IDTypeFeature.from_csr(name, offsets.copy(), signs.copy()))

        groups = []
        for klass in (NonIDTypeFeature, Label):
            (n,) = struct.unpack_from("<H", view, pos)
            pos += 2
            items = []
            for _ in range(n):
                (name_len,) = struct.unpack_from("<H", view, pos)
                pos += 2
                name = bytes(view[pos : pos + name_len]).decode()
                pos += name_len
                dtype_code, ndim = struct.unpack_from("<BB", view, pos)
                pos += 2
                shape = struct.unpack_from(f"<{ndim}I", view, pos)
                pos += 4 * ndim
                dtype = _CODE_DTYPES[dtype_code]
                count = int(np.prod(shape)) if ndim else 0
                arr = np.frombuffer(view, dtype=dtype, count=count, offset=pos).reshape(
                    shape
                )
                pos += arr.nbytes
                items.append(klass(arr.copy(), name=name))
            groups.append(items)

        return cls(
            id_type_features=id_feats,
            non_id_type_features=groups[0],
            labels=groups[1],
            batch_id=batch_id if flags & _FLAG_HAS_BATCH_ID else None,
            requires_grad=bool(flags & _FLAG_REQUIRES_GRAD),
            meta=meta,
        )
