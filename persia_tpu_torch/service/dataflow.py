"""The dataflow: batches from data loaders to workers and trainers
(``persia_tpu/service/dataflow.py``).

The reference pushes a batch's ID features to an embedding worker and
the rest of it to a trainer, routed by ``batch_id % world_size``. Here,
over :mod:`persia_tpu_torch.rpc` and the PTB2 wire:

- :class:`DataflowClient` (data-loader side) puts the batch's ID features
  into a worker replica's forward buffer (retrying with backoff while it
  answers ``ForwardBufferFull``), then sends the batch and its
  ``(worker_addr, ref_id)`` handle to the trainer that owns it;
- :class:`DataflowReceiver` (trainer side) is an RPC endpoint feeding a
  bounded queue that
  :class:`~persia_tpu_torch.data.dataloader.StreamingDataset` drains.

The request bytes are the JAX package's, so a data loader of either
package feeds a trainer of either package.
"""

import logging
import queue
import threading
import time
from typing import Optional, Sequence

from persia_tpu_torch import _msgpack
from persia_tpu_torch.data.batch import PersiaBatch
from persia_tpu_torch.rpc import RpcClient, RpcError, RpcServer

_logger = logging.getLogger(__name__)

_EOS = object()


class DataflowReceiver:
    """Trainer-side ingestion endpoint.

    ``num_senders`` data-loader replicas feed this trainer: the stream
    ends once every one of them has reported end-of-stream, so the
    fastest loader's end does not cut the slower ones off."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 buffer_size: int = 128, num_senders: int = 1):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self.num_senders = max(1, num_senders)
        self._eos_seen = 0
        self._eos_ids: set = set()  # identified senders already counted
        self._eos_lock = threading.Lock()
        self.server = RpcServer(host, port)
        self.server.register("enqueue_batch", self._enqueue)
        self.server.register("end_of_stream", self._eos)
        self.server.serve_background()

    @property
    def addr(self) -> str:
        return self.server.addr

    def _enqueue(self, payload: bytes) -> bytes:
        head_len = int.from_bytes(payload[:4], "little")
        head = _msgpack.unpackb(payload[4:4 + head_len])
        batch = PersiaBatch.from_bytes(payload[4 + head_len:])
        if head.get("worker_addr") is not None:
            batch.remote_ref = (head["worker_addr"], head["ref_id"])
        self._q.put(batch)
        return b""

    def _eos(self, payload: bytes) -> bytes:
        # an identified end-of-stream (msgpack {"sender": id}) counts once
        # a sender, so a monitor aborting a replica that already sent its
        # own cannot end the stream early; an empty payload counts
        # anonymously
        sender = None
        if payload:
            sender = _msgpack.unpackb(payload).get("sender")
        with self._eos_lock:
            if sender is not None:
                if sender in self._eos_ids:
                    return b""
                self._eos_ids.add(sender)
            self._eos_seen += 1
            done = self._eos_seen >= self.num_senders
        if done:
            self._q.put(_EOS)
        return b""

    def get(self, timeout: Optional[float] = None) -> Optional[PersiaBatch]:
        """The next batch; None once the stream has ended."""
        item = self._q.get(timeout=timeout)
        return None if item is _EOS else item

    def abort_sender(self, sender_id=None):
        """Count a dead sender as its end-of-stream, so the trainer drains
        what arrived and ends instead of waiting forever. With the
        ``sender_id`` the replica passes to ``send_eos``, an abort racing
        the replica's own end counts once."""
        self._eos(_msgpack.packb({"sender": sender_id})
                  if sender_id is not None else b"")

    def close(self):
        self.server.stop()


class DataflowClient:
    """Data-loader side: worker ingestion and trainer routing.

    ``worker=None`` sends the raw batch, ID features included, straight
    to the trainer: the wiring for trainers that look their rows up
    themselves (a device cache, device mode)."""

    def __init__(self, worker, trainer_addrs: Sequence[str],
                 max_retries: int = 60):
        self.worker = worker
        self.trainer_addrs = list(trainer_addrs)
        self._trainers = [RpcClient(a) for a in self.trainer_addrs]
        self.max_retries = max_retries

    def send(self, batch: PersiaBatch):
        ref = None
        if batch.requires_grad and self.worker is not None:
            delay = 0.05
            for _ in range(self.max_retries):
                try:
                    ref = self.worker.put_batch(batch.id_type_features)
                    break
                except RpcError as e:
                    if "ForwardBufferFull" not in str(e):
                        raise
                    time.sleep(delay)
                    delay = min(delay * 2, 2.0)
            else:
                raise TimeoutError("embedding workers stayed full")
        head = _msgpack.packb({
            "worker_addr": ref[0] if ref else None,
            "ref_id": ref[1] if ref else None,
        })
        payload = len(head).to_bytes(4, "little") + head + batch.to_bytes()
        trainer = self._trainers[(batch.batch_id or 0) % len(self._trainers)]
        # deduplicated: a blind retry after an ambiguous connection death
        # would deliver the batch twice and take its forward-buffer entry
        # twice
        trainer.call("enqueue_batch", payload, dedup=True)

    def send_eos(self, sender_id=None):
        """End this sender's stream at every trainer (deduplicated, so a
        retry does not count twice; ``sender_id`` also dedupes it against
        the receiver's ``abort_sender``)."""
        payload = (_msgpack.packb({"sender": sender_id})
                   if sender_id is not None else b"")
        for t in self._trainers:
            t.call("end_of_stream", payload, dedup=True)

    def close(self):
        for t in self._trainers:
            t.close()
