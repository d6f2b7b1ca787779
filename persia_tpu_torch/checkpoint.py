"""Checkpoints: sharded sparse dump/load and the dense state
(``persia_tpu/checkpoint.py``).

- **Layout**: ``<dst>/replica_<i>.psd`` (one PSD file per PS replica)
  plus an ``embedding_dump_done`` marker holding ``{"num_shards",
  "datetime"}``, and ``"routing"`` when the table that sharded the rows is
  not the uniform one.
- **Resharding on load**: when the dump's shard count or routing differs
  from the live one, every row is re-routed by the live table (the uniform
  default is ``farmhash64(sign) % len(ps_clients)``) and installed with
  ``set_entry``, keeping from each file only the rows its replica owned
  under the dump's table.
- **Dense side**: ``dense.pt``, the ``torch.save`` bytes of
  ``{"model": state_dict, "optimizer": state_dict}``, read back with
  ``torch.load(weights_only=True)``. The JAX package writes flax msgpack
  as ``dense.msgpack`` instead; a directory that holds only that file is
  refused when dense state is asked for.
"""

import io
import json
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from persia_tpu_torch.hashing import farmhash64_np
from persia_tpu_torch.ps.store import iter_psd_records, read_psd_header
from persia_tpu_torch.routing import RoutingTable
from persia_tpu_torch.storage import PersiaPath

DONE_MARKER = "embedding_dump_done"
DENSE_FILE = "dense.pt"
# the JAX package's dense file (flax msgpack), which the port cannot read
JAX_DENSE_FILE = "dense.msgpack"


def _replica_path(dirpath: str, i: int) -> str:
    return os.path.join(dirpath, f"replica_{i}.psd")


class _StagedDir:
    """Local staging for ``hdfs://`` checkpoint directories; local paths
    pass through untouched."""

    def __init__(self, dirpath: str):
        self.remote = dirpath if dirpath.startswith("hdfs://") else None
        if self.remote:
            self._tmp = tempfile.TemporaryDirectory(prefix="persia_ckpt_")
            self.local = self._tmp.name
        else:
            self.local = dirpath

    def upload(self):
        if not self.remote:
            return
        PersiaPath(self.remote).makedirs()
        for name in os.listdir(self.local):
            with open(os.path.join(self.local, name), "rb") as f:
                PersiaPath(f"{self.remote}/{name}").write_bytes(f.read())

    def download(self):
        if not self.remote:
            return
        for remote_file in PersiaPath(self.remote).listdir():
            name = remote_file.rsplit("/", 1)[-1]
            data = PersiaPath(remote_file).read_bytes()
            with open(os.path.join(self.local, name), "wb") as f:
                f.write(data)


def dump_sharded(ps_clients: Sequence, dirpath: str,
                 routing: Optional[RoutingTable] = None):
    """Dump every PS replica, then write the done marker. A non-uniform
    ``routing`` table is recorded in the marker so the load side routes
    rows by the table that sharded them; under the uniform table the
    marker keeps the pre-routing keys."""
    staged = _StagedDir(dirpath)
    os.makedirs(staged.local, exist_ok=True)
    marker = os.path.join(staged.local, DONE_MARKER)
    if os.path.exists(marker):
        os.remove(marker)
    for i, client in enumerate(ps_clients):
        client.dump_file(_replica_path(staged.local, i))
    wait_for_idle(ps_clients)
    doc = {"num_shards": len(ps_clients),
           "datetime": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if routing is not None and not routing.is_uniform_modulo:
        doc["routing"] = routing.to_doc()
    with open(marker, "w") as f:
        json.dump(doc, f)
    staged.upload()


def read_done_marker(dirpath: str) -> dict:
    marker = PersiaPath(os.path.join(dirpath, DONE_MARKER))
    if not marker.exists():
        raise FileNotFoundError(
            f"{dirpath} has no {DONE_MARKER}; incomplete or missing dump")
    return json.loads(marker.read_bytes())


def wait_for_idle(ps_clients: Sequence, timeout: float = 600.0):
    """Poll every PS that reports a model-manager status until it is
    ``Idle``; in-process holders dump and load synchronously."""
    deadline = time.monotonic() + timeout
    for client in ps_clients:
        status_fn = getattr(client, "model_manager_status", None)
        if status_fn is None:
            continue
        while True:
            status = status_fn()
            if status == "Idle":
                break
            if status.startswith("Failed"):
                raise RuntimeError(f"PS checkpoint failed: {status}")
            if time.monotonic() > deadline:
                raise TimeoutError("checkpoint status polling timed out")
            time.sleep(0.2)


def iter_psd_entries(path: str):
    """Stream ``(sign, dim, f32 vec)`` records out of one PSD v1/v2 file;
    v2 embedding slices widen from their tagged dtype."""
    with open(path, "rb") as f:
        version, count = read_psd_header(f, path)
        yield from iter_psd_records(f.read, version, count)


def _same_assignment(routing: Optional[RoutingTable], doc: Optional[dict],
                     num_replicas: int) -> bool:
    """Does the live table shard rows exactly like the dump's (the epoch
    aside)?"""
    dumped = (RoutingTable.from_doc(doc) if doc
              else RoutingTable.uniform(num_replicas))
    live = routing if routing is not None else RoutingTable.uniform(
        num_replicas)
    return (live.num_replicas == dumped.num_replicas
            and live.num_slots == dumped.num_slots
            and np.array_equal(live.replica_of_slot,
                               dumped.replica_of_slot))


def load_sharded(ps_clients: Sequence, dirpath: str,
                 routing: Optional[RoutingTable] = None):
    """Load a dump, resharding when the layout changed; rows are routed by
    the live ``routing`` table (the uniform default reproduces
    ``farmhash64(sign) % len(ps_clients)``)."""
    info = read_done_marker(dirpath)
    staged = _StagedDir(dirpath)
    staged.download()
    dirpath = staged.local
    num_shards = info["num_shards"]
    if (num_shards == len(ps_clients)
            and _same_assignment(routing, info.get("routing"), num_shards)):
        for i, client in enumerate(ps_clients):
            client.load_file(_replica_path(dirpath, i))
        wait_for_idle(ps_clients)
        return
    # after a live reshard a donor keeps stale copies of moved rows, and
    # its dump holds them too: only the rows a file's replica owned under
    # the dump's table are authoritative
    dumped = (RoutingTable.from_doc(info["routing"])
              if info.get("routing")
              else RoutingTable.uniform(num_shards))
    for client in ps_clients:
        client.clear()

    def install_owned(i, batch_signs, batch_entries):
        owned = dumped.replica_of(np.array(batch_signs, np.uint64)) == i
        signs = [s for s, k in zip(batch_signs, owned) if k]
        entries = [e for e, k in zip(batch_entries, owned) if k]
        if signs:
            _install(ps_clients, signs, entries, routing)

    for i in range(num_shards):
        batch_signs: List[int] = []
        batch_entries: List = []
        for sign, dim, vec in iter_psd_entries(_replica_path(dirpath, i)):
            batch_signs.append(sign)
            batch_entries.append((dim, vec))
            if len(batch_signs) >= 65536:
                install_owned(i, batch_signs, batch_entries)
                batch_signs, batch_entries = [], []
        if batch_signs:
            install_owned(i, batch_signs, batch_entries)


def _install(ps_clients, signs, entries,
             routing: Optional[RoutingTable] = None):
    sarr = np.array(signs, dtype=np.uint64)
    if routing is not None:
        shards = routing.replica_of(sarr)
    else:
        shards = (farmhash64_np(sarr)
                  % np.uint64(len(ps_clients))).astype(np.int64)
    for sign, shard, (dim, vec) in zip(signs, shards, entries):
        ps_clients[shard].set_entry(int(sign), dim, vec)


# --- dense state ------------------------------------------------------------


def dense_state_bytes(state) -> bytes:
    """``state`` is a ``(model, optimizer)`` pair (the optimizer may be
    None): the ``torch.save`` bytes of their state dicts."""
    model, optimizer = state
    buf = io.BytesIO()
    torch.save({"model": model.state_dict(),
                "optimizer": (optimizer.state_dict()
                              if optimizer is not None else None)}, buf)
    return buf.getvalue()


def apply_dense_bytes(state, data: bytes):
    """Install :func:`dense_state_bytes` into the ``(model, optimizer)``
    pair in place (same model and optimizer construction as the dump's);
    returns ``state``."""
    model, optimizer = state
    doc = torch.load(io.BytesIO(data), map_location="cpu",
                     weights_only=True)
    model.load_state_dict(doc["model"])
    if optimizer is not None and doc["optimizer"] is not None:
        optimizer.load_state_dict(doc["optimizer"])
    return state


def dense_file(dirpath: str) -> Optional[str]:
    """The path of ``dirpath``'s dense file, None when it has none.
    Raises when it holds only the JAX package's ``dense.msgpack``."""
    path = os.path.join(dirpath, DENSE_FILE)
    if os.path.exists(path):
        return path
    if os.path.exists(os.path.join(dirpath, JAX_DENSE_FILE)):
        raise ValueError(
            f"{dirpath} holds {JAX_DENSE_FILE} (flax msgpack, written by the "
            f"JAX package) and no {DENSE_FILE}: the port reads only torch "
            f"dense state; load the sparse side with with_dense=False")
    return None


def dump_checkpoint(ctx, dst_dir: str, with_dense: bool = True):
    """The sparse state through ``ctx.worker.dump`` (which drains the
    backward engines first) and, with ``with_dense``, ``dense.pt``."""
    os.makedirs(dst_dir, exist_ok=True)
    ctx.worker.dump(dst_dir)
    if with_dense and ctx.model is not None:
        with open(os.path.join(dst_dir, DENSE_FILE), "wb") as f:
            f.write(dense_state_bytes(
                (ctx.model, getattr(ctx, "dense_optimizer", None))))


def load_checkpoint(ctx, src_dir: str, with_dense: bool = True):
    ctx.worker.load(src_dir)
    if with_dense:
        path = dense_file(src_dir)
        if path is not None:
            if ctx.model is None:
                raise RuntimeError(
                    f"{src_dir} holds dense state but the context has no "
                    f"model to load it into")
            with open(path, "rb") as f:
                apply_dense_bytes(
                    (ctx.model, getattr(ctx, "dense_optimizer", None)),
                    f.read())
