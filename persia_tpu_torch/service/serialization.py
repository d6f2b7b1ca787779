"""Array-level wire helpers shared by the worker service and its client
(``persia_tpu/service/serialization.py``); the bytes are the JAX
package's."""

from typing import Dict, List

import numpy as np

from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.rpc import pack_arrays, unpack_arrays
from persia_tpu_torch.worker.middleware import RawEmbedding, SumEmbedding


def pack_id_features(features: List[IDTypeFeature],
                     meta: dict = None) -> bytes:
    names = [f.name for f in features]
    arrays = []
    for f in features:
        arrays.append(f.offsets)
        arrays.append(f.signs)
    return pack_arrays({"names": names, **(meta or {})}, arrays)


def unpack_id_features(payload: bytes):
    meta, arrays = unpack_arrays(payload)
    feats = []
    for i, name in enumerate(meta["names"]):
        feats.append(IDTypeFeature.from_csr(name, arrays[2 * i].copy(),
                                            arrays[2 * i + 1].copy()))
    return meta, feats


def pack_lookup_result(result: Dict[str, object]) -> bytes:
    names, kinds, arrays = [], [], []
    for name, r in result.items():
        names.append(name)
        if isinstance(r, SumEmbedding):
            kinds.append("sum")
            arrays.append(r.embeddings)
        elif isinstance(r, RawEmbedding):
            kinds.append("raw")
            arrays.extend([r.embeddings, r.index, r.sample_id_num])
        else:
            raise TypeError(f"unexpected result type {type(r)}")
    return pack_arrays({"names": names, "kinds": kinds}, arrays)


def unpack_lookup_result(payload: bytes) -> Dict[str, object]:
    meta, arrays = unpack_arrays(payload)
    out = {}
    pos = 0
    for name, kind in zip(meta["names"], meta["kinds"]):
        if kind == "sum":
            out[name] = SumEmbedding(name, arrays[pos])
            pos += 1
        else:
            out[name] = RawEmbedding(name, arrays[pos], arrays[pos + 1],
                                     arrays[pos + 2])
            pos += 3
    return out


def pack_gradients(grads: Dict[str, np.ndarray], meta: dict = None) -> bytes:
    names = list(grads.keys())
    return pack_arrays(
        {"names": names, **(meta or {})},
        [np.ascontiguousarray(grads[n], np.float32) for n in names])


def unpack_gradients(payload: bytes):
    meta, arrays = unpack_arrays(payload)
    return meta, dict(zip(meta["names"], arrays))
