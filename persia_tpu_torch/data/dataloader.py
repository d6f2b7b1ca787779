"""Datasets and the DataLoader (``persia_tpu/data/dataloader.py``).

``DataLoader`` drives a :class:`~persia_tpu_torch.pipeline.ForwardEngine`
over a dataset: the engine prefetches embedding lookups and stages each
batch's inputs on the device, bounded by the embedding-staleness
semaphore, and yields :class:`TrainingBatch` objects that
``TrainCtx.train_step`` takes. Over a context with a device cache it
starts no engine and yields the dataset's raw batches in order. Over a
``TrainCtx`` on a mesh the sparse leader alone reads the dataset and runs
the engine; each batch it yields is sent to the other ranks, which yield
the same batches in the same order (``LookedUpBatch`` objects without a
lookup: the leader shares its lookup in the step).
"""

import itertools
import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional

from persia_tpu_torch.ctx import (
    BCAST_END,
    BCAST_FAILED,
    BCAST_OK,
    current_ctx,
)
from persia_tpu_torch.data.batch import PersiaBatch
from persia_tpu_torch.pipeline import ForwardEngine
# the batch type DataLoader yields: embeddings fetched, gradient handle
# attached
from persia_tpu_torch.pipeline import LookedUpBatch as TrainingBatch


class IterableDatasetBase(Iterable[PersiaBatch]):
    """Anything that yields :class:`PersiaBatch`."""

    def __init__(self, buffer_size: int = 128):
        self.buffer_size = buffer_size

    def __iter__(self) -> Iterator[PersiaBatch]:
        raise NotImplementedError


class IterableDataset(IterableDatasetBase):
    """Wraps a local iterable of PersiaBatch, decoupled through a
    background thread and a bounded queue; a producer's error is raised
    to the consumer."""

    def __init__(self, source: Iterable[PersiaBatch], buffer_size: int = 128):
        super().__init__(buffer_size)
        self.source = source

    def __iter__(self) -> Iterator[PersiaBatch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()
        error: List[BaseException] = []

        def _producer():
            try:
                for item in self.source:
                    q.put(item)
            except BaseException as e:  # raised to the consumer below
                error.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=_producer, daemon=True,
                         name="dataset-producer").start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item


class ResumableDataset(IterableDatasetBase):
    """Deterministic, cursor-tracked dataset.

    ``factory(seed)`` returns a FRESH batch iterator that is a pure
    function of the seed. The dataset skips the first ``start`` batches (a
    previous incarnation trained them) and counts every batch it hands
    out, so :meth:`cursor` names an exact stream position that a
    restarted process reproduces from ``{seed, consumed}``. The cursor is
    keyed to TRAINED batches: the prefetch pipeline runs ahead of the
    optimizer, so a snapshot passes ``cursor(trained=...)``.

    ``process_index`` / ``process_count`` round-robin-partition the one
    global stream across a trainer group: process ``p`` of ``N`` yields the
    global batches at positions ``i % N == p``, so the shards' union is the
    one-process stream. ``start`` and the cursor count per-process trained
    batches; a sharded cursor also records its shard coordinates.
    """

    def __init__(self, factory, seed: int = 0, start: int = 0,
                 buffer_size: int = 128, process_index: int = 0,
                 process_count: int = 1):
        super().__init__(buffer_size)
        self.factory = factory
        self.seed = int(seed)
        self.start = int(start)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(
                f"process_index {self.process_index} outside group of "
                f"{self.process_count}")
        self.produced = 0  # batches handed out by THIS incarnation

    def cursor(self, trained: Optional[int] = None) -> Dict[str, int]:
        """Snapshot cursor. ``trained`` = batches fully stepped this
        incarnation; defaults to every batch handed out."""
        n = self.produced if trained is None else int(trained)
        cur = {"seed": self.seed, "consumed": self.start + n}
        if self.process_count != 1:
            cur["process_index"] = self.process_index
            cur["process_count"] = self.process_count
        return cur

    @classmethod
    def from_cursor(cls, factory, cursor: Dict[str, int],
                    buffer_size: int = 128, process_index: int = 0,
                    process_count: int = 1) -> "ResumableDataset":
        cur_count = int(cursor.get("process_count", 1))
        cur_index = int(cursor.get("process_index", 0))
        if process_count == 1 and cur_count != 1:
            # a sharded cursor restored without coordinates resumes ITS
            # shard
            process_index, process_count = cur_index, cur_count
        elif (cur_count, cur_index) != (1, 0) and (
                (process_index, process_count) != (cur_index, cur_count)):
            raise ValueError(
                f"cursor names shard {cur_index}/{cur_count} but resume "
                f"asked for {process_index}/{process_count}: a per-process "
                f"cursor only positions its own shard")
        return cls(factory, seed=cursor["seed"], start=cursor["consumed"],
                   buffer_size=buffer_size, process_index=process_index,
                   process_count=process_count)

    def __iter__(self) -> Iterator[PersiaBatch]:
        # this shard's batches sit at global positions p, p+N, p+2N, ...;
        # ``start`` per-process batches are start*N global batches
        for batch in itertools.islice(
                iter(self.factory(self.seed)),
                self.process_index + self.start * self.process_count,
                None, self.process_count):
            self.produced += 1
            yield batch


class StreamingDataset(IterableDatasetBase):
    """Batches pushed by remote data-loader processes, read from any
    receiver with a blocking ``.get()`` that returns None at the end of
    the stream."""

    def __init__(self, receiver=None, buffer_size: int = 128):
        super().__init__(buffer_size)
        self._receiver = receiver

    def bind_receiver(self, receiver):
        self._receiver = receiver

    def __iter__(self) -> Iterator[PersiaBatch]:
        if self._receiver is None:
            raise RuntimeError(
                "StreamingDataset not bound to a receiver; construct it "
                "with one (an object with .get()) or call bind_receiver")
        while True:
            batch = self._receiver.get()
            if batch is None:
                return
            yield batch


class DataLoader:
    """Drives the forward engine of the current context over a dataset.

    ``forward_buffer_size`` bounds the prefetch pipeline,
    ``embedding_staleness`` bounds how many batches may have unreturned
    embedding gradients, ``num_workers`` lookup threads run at once and
    ``reproducible`` runs one of them, so that with staleness 1 the run
    equals the synchronous one. A finished iteration waits for every
    in-flight gradient update.
    """

    def __init__(self, dataset: IterableDatasetBase,
                 forward_buffer_size: int = 10,
                 timeout_ms: int = 1000 * 60 * 10, num_workers: int = 8,
                 reproducible: bool = False,
                 embedding_staleness: Optional[int] = None):
        self.dataset = dataset
        self.timeout_ms = timeout_ms
        self.forward_buffer_size = forward_buffer_size
        self.num_workers = num_workers
        self.reproducible = reproducible
        self.embedding_staleness = embedding_staleness
        self._engine = None

    def _ensure_engine(self):
        if self._engine is None:
            ctx = current_ctx()
            if ctx is None:
                raise RuntimeError(
                    "DataLoader requires an active EmbeddingCtx/TrainCtx")
            self._engine = ForwardEngine(
                ctx=ctx, num_workers=self.num_workers,
                buffer_size=self.forward_buffer_size,
                reproducible=self.reproducible,
                embedding_staleness=self.embedding_staleness)
        return self._engine

    def __iter__(self) -> Iterator[TrainingBatch]:
        ctx = current_ctx()
        if getattr(ctx, "device_cache_capacity", 0):
            # a cached context imports its own misses: no prefetch
            # lookups, the dataset's raw batches in order (batch order is
            # the cache's LRU order)
            yield from iter(self.dataset)
            return
        if getattr(ctx, "mesh", None) is not None:
            yield from self._iter_mesh(ctx)
            return
        engine = self._ensure_engine()
        try:
            yield from engine.run(iter(self.dataset),
                                  timeout_ms=self.timeout_ms)
        finally:
            # a finished epoch leaves no pending PS writes
            engine.flush(timeout=self.timeout_ms / 1000.0)

    def _iter_mesh(self, ctx) -> Iterator[TrainingBatch]:
        """The pipeline over a mesh (module docstring). The end of the
        leader's stream ends every rank's, and an error in its pipeline
        raises on every rank."""
        if not ctx._leader:
            while True:
                status, data = ctx._bcast_bytes()
                if status == BCAST_END:
                    return
                if status == BCAST_FAILED:
                    raise RuntimeError(f"the sparse leader's pipeline "
                                       f"failed: {data.decode()}")
                yield TrainingBatch(PersiaBatch.from_bytes(data), None, None)
        engine = self._ensure_engine()
        try:
            for lb in engine.run(iter(self.dataset),
                                 timeout_ms=self.timeout_ms):
                ctx._bcast_bytes(lb.batch.to_bytes(), BCAST_OK)
                yield lb
        except Exception as e:
            # a loop left early (GeneratorExit) is every rank's: only a
            # failure is sent
            ctx._bcast_bytes(f"{type(e).__name__}: {e}".encode(),
                             BCAST_FAILED)
            raise
        else:
            ctx._bcast_bytes(b"", BCAST_END)
        finally:
            engine.flush(timeout=self.timeout_ms / 1000.0)
