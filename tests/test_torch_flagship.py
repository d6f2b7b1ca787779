"""The flagship service-mode job on the port, on the CPU
(``tests/test_flagship_e2e.py``'s topology, BASELINE's config 3).

A ``ServiceCtx`` cluster (2 embedding workers and 2 C++
``persia-embedding-ps`` binaries), two of the port's Criteo data loaders
streaming learnable batches over the dataflow, and the launcher's
nn-worker group of two ranks (``PERSIA_TRAINER_PROCESSES=2``) running the
port's ``examples/criteo/train.py --mesh 2,1 --device cpu``: one gloo
world met through the coordinator's KV store, the leader holding the
remote worker and handing every batch to the other rank. It must learn:
held-out AUC above 0.60, the JAX test's bar, on the JAX test's 49,152
samples. The ranks' dense parameters agree by digest, and together they
trained at least the samples the loaders sent.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
EX = REPO / "persia_tpu_torch" / "examples" / "criteo"
SCHEMA = REPO / "examples" / "criteo" / "config" / "embedding_config.yml"

VOCAB = 500            # per slot; small so ids repeat and embeddings train
N_LOADERS = 2
SAMPLES = 49152        # across the loader replicas
BS = 256
AUC_BAR = 0.60


def test_flagship_criteo_service_mesh_of_two_ranks(tmp_path):
    from persia_tpu_torch.config import EmbeddingSchema
    from persia_tpu_torch.service.helper import ServiceCtx

    results = tmp_path / "results"
    with ServiceCtx(EmbeddingSchema.load(str(SCHEMA)), n_workers=2, n_ps=2,
                    native_ps=True, ps_capacity=500_000,
                    ps_num_shards=4) as svc:
        env = {**os.environ, "PYTHONPATH": str(REPO),
               "PERSIA_COORDINATOR_ADDR": svc.coordinator_addr,
               "PERSIA_NUM_WORKERS": "2",
               "PERSIA_NUM_DATALOADERS": str(N_LOADERS),
               "WORLD_SIZE": "1", "RANK": "0", "OMP_NUM_THREADS": "2"}
        group = subprocess.Popen(
            [sys.executable, "-m", "persia_tpu_torch.launcher", "nn-worker",
             str(EX / "train.py"), "--mesh", "2,1", "--device", "cpu",
             "--learnable", "--batch-size", str(BS), "--vocab", str(VOCAB),
             "--test-samples", "4096", "--lr", "0.1", "--sparse-lr", "0.3",
             "--num-workers", "2", "--embedding-config", str(SCHEMA),
             "--result-dir", str(results)],
            env={**env, "PERSIA_TRAINER_PROCESSES": "2"}, cwd=REPO)
        loaders = [
            subprocess.Popen(
                [sys.executable, "-m", "persia_tpu_torch.launcher",
                 "data-loader", str(EX / "send_data.py"), "--learnable",
                 "--samples", str(SAMPLES), "--batch-size", str(BS),
                 "--vocab", str(VOCAB)],
                env={**env, "REPLICA_INDEX": str(i),
                     "REPLICA_SIZE": str(N_LOADERS)}, cwd=REPO)
            for i in range(N_LOADERS)]
        procs = [group, *loaders]
        try:
            deadline = time.monotonic() + 240
            while any(p.poll() is None for p in procs):
                failed = [p.returncode for p in procs
                          if p.poll() not in (None, 0)]
                assert not failed, f"a role exited with {failed}"
                assert time.monotonic() < deadline, "the job hung"
                time.sleep(0.2)
            assert [p.returncode for p in procs] == [0] * len(procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert not svc.crashed
    ranks = [json.loads((results / f"rank{i}.json").read_text())
             for i in range(2)]
    lead = ranks[0]
    print(f"flagship (port, 2 gloo ranks on the CPU): {lead['steps']} "
          f"steps, {lead['rows']} samples, "
          f"{lead['samples_per_s']:.0f} samples/s, held-out AUC "
          f"{lead['auc']:.4f}")
    assert [r["leader"] for r in ranks] == [True, False]
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["steps"] == ranks[1]["steps"] > 0
    assert sum(r["rows_trained"] for r in ranks) >= SAMPLES
    assert lead["auc"] > AUC_BAR, f"AUC {lead['auc']}: the job did not learn"
