"""The port's dataflow (``service/dataflow.py``) and ``DataCtx`` against
the JAX package's, on the CPU (``tests/test_rpc.py:228``,
``tests/test_service_e2e.py:93-110``).

- ``DataCtx.send_data`` through a ``DataflowClient`` to a
  ``DataflowReceiver``: every batch arrives byte-equal to what was sent,
  numbered on from the last id, routed by ``batch_id % trainers``.
- End-of-stream from several senders, an identified sender counted once,
  ``abort_sender``.
- Across the packages: a JAX sender against the port's receiver and the
  port's sender against the JAX receiver, the batches byte-equal.
- The four roles: a data loader puts each batch's ID features into a
  worker process's forward buffer and ships the batch with its ref; the
  trainer's ``DataLoader`` over a ``StreamingDataset`` looks it up by
  that ref. The run equals, bit for bit, the same batches fed to the
  trainer's ``DataLoader`` directly (reproducible, staleness 1, with
  deterministic algorithms on).

Tolerance: equality.
"""

import queue

import numpy as np
import pytest
import torch

from persia_tpu_torch.ctx import DataCtx
from persia_tpu_torch.data.batch import (
    IDTypeFeatureWithSingleID,
    Label,
    NonIDTypeFeature,
    PersiaBatch,
)
from persia_tpu_torch.service.dataflow import DataflowClient, \
    DataflowReceiver


def _batch(seed, rows=6, batch_id=None, requires_grad=True, mod=None):
    cls = (IDTypeFeatureWithSingleID, NonIDTypeFeature, Label, PersiaBatch) \
        if mod is None else (mod.IDTypeFeatureWithSingleID,
                             mod.NonIDTypeFeature, mod.Label,
                             mod.PersiaBatch)
    rng = np.random.default_rng(seed)
    return cls[3](
        [cls[0](f"s{i}", rng.integers(1, 500, rows).astype(np.uint64))
         for i in range(2)],
        non_id_type_features=[cls[1](
            rng.normal(size=(rows, 3)).astype(np.float32))],
        labels=[cls[2](rng.integers(0, 2, (rows, 1)).astype(np.float32))],
        batch_id=batch_id, requires_grad=requires_grad)


def _drain(receiver, timeout=10):
    out = []
    while True:
        b = receiver.get(timeout=timeout)
        if b is None:
            return out
        out.append(b)


def test_send_data_arrives_byte_equal_and_routed():
    receivers = [DataflowReceiver(), DataflowReceiver()]
    client = DataflowClient(None, [r.addr for r in receivers])
    try:
        sent = [_batch(i) for i in range(5)] + [_batch(9, batch_id=20)] \
            + [_batch(10)]
        with DataCtx(dataflow=client) as dctx:
            for b in sent:
                dctx.send_data(b)
            dctx.dataflow.send_eos()
        assert [b.batch_id for b in sent] == [0, 1, 2, 3, 4, 20, 21]
        got = [_drain(r) for r in receivers]
        for k, batches in enumerate(got):
            want = [b for b in sent if b.batch_id % 2 == k]
            assert [b.to_bytes() for b in batches] == \
                [b.to_bytes() for b in want]
            assert all(b.remote_ref is None for b in batches)
        with pytest.raises(RuntimeError, match="dataflow client"):
            DataCtx().send_data(_batch(0))
    finally:
        client.close()
        for r in receivers:
            r.close()


def test_receiver_waits_for_every_senders_eos():
    """``tests/test_rpc.py:228``, and an identified sender's EOS, then its
    abort, counted once."""
    r = DataflowReceiver(num_senders=2)
    try:
        r._eos(b"")
        with pytest.raises(queue.Empty):
            r._q.get(timeout=0.2)  # one EOS of two: the stream goes on
        r._eos(b"")
        assert r.get(timeout=2) is None
    finally:
        r.close()
    r = DataflowReceiver(num_senders=2)
    senders = [DataflowClient(None, [r.addr]) for _ in range(2)]
    try:
        senders[0].send(_batch(1, batch_id=0))
        senders[0].send_eos(sender_id="loader-0")
        r.abort_sender("loader-0")  # raced its own EOS: counted once
        senders[1].send(_batch(2, batch_id=1))
        assert sorted(r.get(timeout=2).batch_id for _ in range(2)) == [0, 1]
        with pytest.raises(queue.Empty):
            r.get(timeout=0.2)  # one sender of two ended
        r.abort_sender("loader-1")  # a dead sender
        assert r.get(timeout=2) is None
    finally:
        for s in senders:
            s.close()
        r.close()


def test_senders_and_receivers_across_the_packages():
    from persia_tpu.data import batch as jbatch
    from persia_tpu.service.dataflow import DataflowClient as JClient
    from persia_tpu.service.dataflow import DataflowReceiver as JReceiver

    mine, ref = DataflowReceiver(), JReceiver()
    jclient, client = JClient(None, [mine.addr]), DataflowClient(
        None, [ref.addr])
    try:
        for i in range(4):
            jclient.send(_batch(i, batch_id=i, mod=jbatch))
            client.send(_batch(i, batch_id=i))
        jclient.send_eos(sender_id=7)
        client.send_eos(sender_id=7)
        got = [b.to_bytes() for b in _drain(mine)]
        jgot = [b.to_bytes() for b in _drain(ref)]
        want = [_batch(i, batch_id=i).to_bytes() for i in range(4)]
        assert got == jgot == want
    finally:
        client.close()
        mine.close()
        ref.close()


def test_four_role_dataflow_equals_the_direct_loader(tmp_path):
    """``tests/test_service_e2e.py:93-110`` in process: the loader side
    puts each batch into a worker service and the trainer's loader looks
    it up by its ref."""
    from test_torch_pipeline import HEADS, NUM_DENSE, SLOTS, _batches, \
        _seq_schema

    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.data.dataloader import (
        DataLoader,
        IterableDataset,
        StreamingDataset,
    )
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import SequenceTower
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.service.ps_service import PsClient, PsService
    from persia_tpu_torch.service.worker_service import (
        RemoteEmbeddingWorker,
        WorkerService,
    )
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    schema = _seq_schema(tcfg)
    batches = list(_batches(6, seed=31))
    runs = {}
    try:
        for path in ("direct", "dataflow"):
            services = [PsService(make_holder(100_000, 4, backend="arena"))
                        for _ in range(2)]
            for s in services:
                s.server.serve_background()
            ws = WorkerService(EmbeddingWorker(
                schema, [PsClient(s.addr) for s in services]))
            ws.server.serve_background()
            torch.manual_seed(0)
            model = SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                                  attn_impl="flash", device="cpu",
                                  compute_dtype=torch.float32)
            ctx = TrainCtx(model, torch.optim.Adam(model.parameters(),
                                                   lr=1e-3),
                           Adagrad(lr=1e-2), schema,
                           RemoteEmbeddingWorker([ws.addr]), seed=3,
                           embedding_config=EmbeddingConfig(
                               emb_initialization=(-0.05, 0.05)),
                           global_config=tcfg.GlobalConfig(
                               tcfg.CommonConfig("f32")),
                           device="cpu")
            receiver = DataflowReceiver()
            loader_worker = RemoteEmbeddingWorker([ws.addr])
            try:
                with ctx:
                    if path == "dataflow":
                        with DataCtx(dataflow=DataflowClient(
                                loader_worker, [receiver.addr])) as dctx:
                            for b in batches:
                                dctx.send_data(PersiaBatch.from_bytes(
                                    b.to_bytes()))
                            dctx.dataflow.send_eos()
                        dataset = StreamingDataset(receiver)
                    else:
                        dataset = IterableDataset(batches)
                    loader = DataLoader(dataset, num_workers=2,
                                        reproducible=True,
                                        embedding_staleness=1)
                    losses, refs = [], []
                    for lb in loader:
                        refs.append(lb.ref_id)
                        losses.append(float(ctx.train_step(lb)[0]))
                    loader._engine.shutdown()
                assert len(losses) == len(batches)
                if path == "dataflow":
                    # looked up by the data loader's refs
                    assert all(r[0] == ws.addr for r in refs)
                signs = np.unique(np.concatenate(
                    [f.signs for b in batches for f in b.id_type_features]))
                rows = [s.holder.get_entries(signs, 2 * 16)[1]
                        for s in services]
                runs[path] = (losses, [r.tobytes() for r in rows])
            finally:
                loader_worker.close()
                receiver.close()
                ws.stop()
                for s in services:
                    s.stop()
    finally:
        torch.use_deterministic_algorithms(was)
    assert runs["dataflow"] == runs["direct"]
