"""The port's Criteo TSV reader and the scripts that read it, against the
JAX example's (``examples/criteo/``), on the CPU.

- ``write_synthetic_tsv`` writes the same bytes as the JAX example's for
  the same seed.
- ``criteo_batches`` yields the same batches as the JAX example's on the
  same plain or ``.gz`` file: labels, dense features, every slot's u64
  signs, ``batch_id`` and ``requires_grad``, bit for bit. The file mixes
  seeded lines with empty, hex, not-hex and 40-byte tokens and lines of
  the wrong field count; the cases cover batch sizes that leave a short
  last batch, ``max_samples`` and replica splits of 2 and 3, whose union
  is the whole stream.
- ``send_data.py``'s source for replica i of n is the JAX data loader's
  (``examples/criteo/send_data.py:67-72``), batch for batch.
- ``train.py --local --train --test --device cpu`` trains a small file
  and scores the test file. Through each script's ``build_ctx`` and
  ``batches_for``, from the JAX side's initial weights (the helpers of
  ``tests/test_torch_examples.py``), the steps on the TSV batches agree
  with JAX's within that file's stated tolerance (2e-2 on losses and
  predictions, the update within 20% in L2 norm) and so do the test
  AUCs (2e-2).
- adult-income: ``build_ctx(config_dir=examples/adult_income/config)``
  trains with the config's prefixed slots, and ``main_npz`` on a
  reference-format npz written from ``generate(6144, seed=5)`` passes the
  JAX test's bar (AUC above 0.68) and agrees with JAX's ``main_npz``
  from the same initial weights within 2e-2 of AUC.

Equality tests run with ``torch.use_deterministic_algorithms(True)``.
"""

import argparse
import gzip
import importlib
import json
import math
import shutil
import sys

import numpy as np
import pytest
import torch

from test_torch_examples import (
    REPO,
    STEPS,
    TOL,
    _check_state,
    _flat,
    _jax_script,
    _train_both,
    _transplant,
    jax_numpy_middleware,  # noqa: F401 - a fixture
)

from persia_tpu_torch.examples.criteo import criteo_data as tcd

JAX_CRITEO = REPO / "examples" / "criteo"
NUM_FIELDS = 1 + tcd.NUM_DENSE + tcd.NUM_SLOTS


@pytest.fixture(autouse=True)
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture(scope="module")
def jcd():
    """The JAX example's ``criteo_data`` (its directory on the path, as
    its scripts import it)."""
    sys.path.insert(0, str(JAX_CRITEO))
    try:
        return importlib.import_module("criteo_data")
    finally:
        sys.path.remove(str(JAX_CRITEO))


def _odd_lines():
    """Lines that exercise the parse's traps: empty, hex, not-hex and
    40-byte tokens, empty ints, negative ints, and malformed lines."""
    cats = (["deadbeef", "", "0000000f", "ffffffffffffffff1", "not-hex!",
             "x" * 40, "é-ü", "12AB"] * 4)[:tcd.NUM_SLOTS]
    ints = ["5", "", "-3", "0", "999"] * 3
    good = "\t".join(["1", *ints[:tcd.NUM_DENSE], *cats])
    return [
        good,
        "\t".join(["0", *[""] * tcd.NUM_DENSE, *[""] * tcd.NUM_SLOTS]),
        "\t".join(["1"] * (NUM_FIELDS - 1)),  # a field short
        "\t".join(["0"] * (NUM_FIELDS + 1)),  # a field too many
        "",  # an empty line
        good.replace("deadbeef", "DEADBEEF"),
    ]


@pytest.fixture(scope="module")
def tsv(tmp_path_factory, jcd):
    """A 613-line file: 600 seeded lines with the odd lines spread among
    them, and its ``.gz`` copy."""
    d = tmp_path_factory.mktemp("criteo")
    seeded = d / "seeded.tsv"
    jcd.write_synthetic_tsv(str(seeded), 600, seed=3)
    lines = seeded.read_text().splitlines()
    odd = _odd_lines()
    for i, line in enumerate(odd + odd[:1] + odd[:6]):
        lines.insert(37 * i + 5, line)
    path = d / "day_0.tsv"
    path.write_text("\n".join(lines) + "\n")
    with open(path, "rb") as src, gzip.open(str(path) + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return path


def _assert_batches_equal(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert g.batch_id == w.batch_id
        assert g.requires_grad == w.requires_grad
        (gl,), (wl,) = g.labels, w.labels
        assert gl.data.dtype == wl.data.dtype == np.float32
        np.testing.assert_array_equal(gl.data, wl.data)
        (gd,), (wd,) = g.non_id_type_features, w.non_id_type_features
        assert gd.data.dtype == wd.data.dtype == np.float32
        assert gd.data.tobytes() == wd.data.tobytes()
        assert ([f.name for f in g.id_type_features]
                == [f.name for f in w.id_type_features])
        for gf, wf in zip(g.id_type_features, w.id_type_features):
            assert gf.signs.dtype == wf.signs.dtype == np.uint64
            np.testing.assert_array_equal(gf.signs, wf.signs)
            np.testing.assert_array_equal(gf.offsets, wf.offsets)


@pytest.mark.parametrize("seed,n", [(0, 50), (4, 300), (11, 7)])
def test_write_synthetic_tsv_is_byte_equal(seed, n, tmp_path, jcd):
    tcd.write_synthetic_tsv(str(tmp_path / "t.tsv"), n, seed=seed)
    jcd.write_synthetic_tsv(str(tmp_path / "j.tsv"), n, seed=seed)
    got = (tmp_path / "t.tsv").read_bytes()
    assert got == (tmp_path / "j.tsv").read_bytes()
    assert got.count(b"\n") == n


CASES = {
    "short_last_batch": dict(batch_size=128),
    "one_batch_of_all": dict(batch_size=4096),
    "odd_batch": dict(batch_size=37, requires_grad=False),
    "max_samples": dict(batch_size=64, max_samples=301),
    "max_samples_inside_a_batch": dict(batch_size=100, max_samples=50),
    "replica_1_of_2": dict(batch_size=64, replica_index=1, replica_size=2),
    "replica_2_of_3": dict(batch_size=50, max_samples=555, replica_index=2,
                           replica_size=3),
}


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("case", list(CASES))
def test_criteo_batches_bit_equal(case, gz, tsv, jcd):
    path = str(tsv) + (".gz" if gz else "")
    kw = CASES[case]
    _assert_batches_equal(list(tcd.criteo_batches(path, **kw)),
                          list(jcd.criteo_batches(path, **kw)))


def test_odd_tokens_bit_equal(tmp_path, jcd):
    """The trap lines alone: malformed lines dropped, each token's sign
    as JAX's (0 for empty, ``farmhash64(u64) | 1`` otherwise)."""
    path = tmp_path / "odd.tsv"
    path.write_text("\n".join(_odd_lines()) + "\n")
    got = list(tcd.criteo_batches(str(path), 8))
    _assert_batches_equal(got, list(jcd.criteo_batches(str(path), 8)))
    signs = np.stack([f.signs for f in got[0].id_type_features], axis=1)
    assert signs.shape == (3, tcd.NUM_SLOTS)
    assert (signs[1] == 0).all() and (signs[0, 1] == 0)
    assert (signs[0, [0, 2, 3, 4, 5, 6, 7]] % 2 == 1).all()
    # hex is case-blind: DEADBEEF is deadbeef's sign
    assert signs[2, 0] == signs[0, 0]


@pytest.mark.parametrize("size", [2, 3])
def test_replica_union_is_the_stream(size, tsv):
    """The replicas' batches, interleaved, are the whole stream's lines:
    each replica's lines are the full read's in order, and no two
    replicas share a line."""
    full = list(tcd.criteo_batches(str(tsv), 64))

    def rows(batches):
        return (np.concatenate([b.labels[0].data for b in batches]),
                np.concatenate([b.non_id_type_features[0].data
                                for b in batches]))

    parts = [rows(list(tcd.criteo_batches(str(tsv), 64, replica_index=r,
                                          replica_size=size)))
             for r in range(size)]
    want_l, want_d = rows(full)
    assert sum(len(p[0]) for p in parts) == len(want_l)
    # batch k of the whole file (lines 64k..64k+63) is replica k % size's
    lines = str(tsv.read_text()).splitlines()
    owner = [(i // 64) % size for i in range(len(lines))]
    good = [len(line.split("\t")) == NUM_FIELDS for line in lines]
    for r, (lab, dense) in enumerate(parts):
        keep = np.array([o == r for o, g in zip(owner, good) if g])
        np.testing.assert_array_equal(lab, want_l[keep])
        np.testing.assert_array_equal(dense, want_d[keep])


@pytest.mark.parametrize("index,size", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_send_data_source_matches_jax(index, size, tsv, jcd):
    """The data-loader role's source with ``--train`` for replica
    ``index`` of ``size``: the JAX role's call on the same flags."""
    from persia_tpu_torch.examples.criteo import send_data

    args = send_data.parse_args(["--train", str(tsv), "--samples", "500",
                                 "--batch-size", "64"])
    want = jcd.criteo_batches(args.train, args.batch_size,
                              max_samples=args.samples,
                              replica_index=index, replica_size=size)
    _assert_batches_equal(list(send_data.batch_source(args, index, size)),
                          list(want))


def test_send_data_train_from_the_environment(monkeypatch, tsv):
    from persia_tpu_torch.examples.criteo import send_data

    monkeypatch.setenv("CRITEO_TRAIN", str(tsv))
    assert send_data.parse_args([]).train == str(tsv)
    monkeypatch.delenv("CRITEO_TRAIN")
    assert send_data.parse_args([]).train is None


def _criteo_args(path, test_path, **kw):
    base = dict(
        train=str(path), test=str(test_path) if test_path else None,
        synthetic=False, local=True, learnable=False,
        embedding_config=str(JAX_CRITEO / "config" / "embedding_config.yml"),
        num_remote_workers=1, model="dlrm", dim=16, batch_size=128,
        samples=STEPS * 128, test_samples=256, vocab=1 << 12, n_ps=2,
        ps_capacity=100_000, ps_shards=4, lr=0.02, sparse_lr=0.02,
        staleness=1, num_workers=1, mesh=None, grad_reduce_dtype=None,
        seed=0, log_every=100)
    base.update(kw)
    return argparse.Namespace(**base)


def test_criteo_train_matches_jax(tsv, tmp_path, jax_numpy_middleware):  # noqa: F811
    """``STEPS`` steps of batch 128 of the TSV file through each script's
    ``build_ctx`` (the DLRM tower over the job's 26 slots of dim 16),
    their state after them, then each script's test set (a second file)
    scored through ``eval_ctx``."""
    from persia_tpu.ctx import eval_ctx as jeval_ctx
    from persia_tpu.utils import roc_auc
    from persia_tpu_torch.examples.criteo import train as tct
    from persia_tpu_torch.weights import flax_params

    test_path = tmp_path / "test.tsv"
    tcd.write_synthetic_tsv(str(test_path), 256, seed=9)
    jct = _jax_script("criteo")
    targs = _criteo_args(tsv, test_path, device="cpu")
    jargs = _criteo_args(tsv, test_path)
    schema = tct.load_schema(targs)
    assert schema.feature_index_prefix_bit == 12
    jctx = jct.build_ctx(jargs, jct.load_schema(jargs))
    tctx = tct.build_ctx(targs, schema)
    _transplant(jctx, tctx, tcd.NUM_DENSE)
    init = _flat(flax_params(tctx.model)[0])
    seen = _train_both(jctx, tctx, jct.batches_for(jargs),
                       tct.batches_for(targs))
    _check_state(jctx, tctx, init, tct.build_ctx(targs, schema), seen)
    with jctx, tctx:
        preds, labels = [], []
        with jeval_ctx(jctx) as ectx:
            for b in jct.batches_for(jargs, requires_grad=False, test=True):
                pred, label = ectx.forward(b)
                preds.append(np.asarray(pred).reshape(-1))
                labels.append(np.asarray(label[0]).reshape(-1))
        jauc = roc_auc(np.concatenate(labels), np.concatenate(preds))
        tauc = tct.evaluate(targs, tctx)
    assert abs(tauc - jauc) <= TOL, (tauc, jauc)


def test_criteo_main_trains_a_file(tsv, tmp_path):
    """The script's ``main`` on ``--train`` / ``--test``: one step a
    batch of the first ``--samples`` lines (the file's malformed lines
    dropped), a finite AUC of the test file."""
    from persia_tpu_torch.examples.criteo import train as tct

    test_path = tmp_path / "test.tsv"
    tcd.write_synthetic_tsv(str(test_path), 300, seed=9)
    out = tmp_path / "result"
    auc = tct.main(["--local", "--train", str(tsv), "--test",
                    str(test_path), "--device", "cpu", "--batch-size",
                    "128", "--samples", "100000", "--test-samples", "300",
                    "--n-ps", "2", "--ps-capacity", "100000",
                    "--ps-shards", "4", "--staleness", "2",
                    "--num-workers", "2", "--result-dir", str(out)])
    lines = sum(len(line.split("\t")) == NUM_FIELDS
                for line in tsv.read_text().splitlines())
    doc = json.loads((out / "rank0.json").read_text())
    assert doc["steps"] == math.ceil(lines / 128) and doc["rows"] == lines
    assert np.isfinite(auc) and doc["auc"] == auc
    assert not any(doc["launches"].values())


def test_criteo_synthetic_flag_ignores_the_file(tsv):
    from persia_tpu_torch.examples.criteo import train as tct

    args = _criteo_args(tsv, None, synthetic=True, samples=256)
    got = list(tct.batches_for(args))
    want = list(tcd.synthetic_batches(256, 128, seed=0, vocab_per_slot=1 << 12))
    _assert_batches_equal(got, want)
    args = _criteo_args(tsv, None)
    test = list(tct.batches_for(args, requires_grad=False, test=True))
    _assert_batches_equal(test, list(tcd.criteo_batches(
        str(tsv), 128, max_samples=256, requires_grad=False)))


def test_adult_income_config_dir():
    """``build_ctx(config_dir=)`` loads the example's schema (slots
    prefixed by ``feature_index_prefix_bit`` 8) and sizes the replicas
    from its ``global_config.yml``; 2 steps train."""
    from persia_tpu_torch.examples.adult_income import train as tai
    from persia_tpu_torch.examples.adult_income.data_generator import batches

    cfg = str(REPO / "examples" / "adult_income" / "config")
    ctx = tai.build_ctx(config_dir=cfg, device="cpu")
    with ctx:
        losses = [float(ctx.train_step(b)[0])
                  for b in batches(2 * 64, 64, seed=2)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert ctx.schema.slots_config["slot_0"].index_prefix != 0
    assert ctx.schema.feature_index_prefix_bit == 8
    assert [h.capacity for h in ctx.worker.ps_clients] == [1_000_000] * 2


def _reference_npz(path, data_generator):
    """The JAX test's reference-format npz (``tests/test_e2e_local.py``):
    raw per-column codes from ``generate(6144, seed=5)``."""
    signs, dense, labels = data_generator.generate(6144, seed=5)
    codes = signs - (np.arange(signs.shape[1], dtype=np.uint64)[None, :]
                     * np.uint64(data_generator.VOCAB_PER_SLOT))
    assert codes.max() < data_generator.VOCAB_PER_SLOT
    cols = ["workclass", "education", "marital_status", "occupation",
            "relationship", "race", "gender", "native_country"]
    np.savez_compressed(path, target=labels.ravel().astype(np.float32),
                        continuous_data=dense, categorical_data=codes,
                        categorical_columns=np.array(cols))


def test_adult_income_main_npz_matches_jax(tmp_path, monkeypatch,
                                           jax_numpy_middleware):  # noqa: F811
    """``main_npz`` at batch 256 for 4 epochs, as the JAX test runs it:
    each side's ``main_npz``, the port's context given the JAX context's
    initial weights; AUC above 0.68 and within 2e-2 of JAX's."""
    from persia_tpu_torch.examples.adult_income import data_generator
    from persia_tpu_torch.examples.adult_income import train as tai

    path = tmp_path / "train.npz"
    _reference_npz(path, data_generator)
    jai = _jax_script("adult_income")
    monkeypatch.syspath_prepend(str(REPO / "examples" / "adult_income"))
    jbuild, tbuild, made = jai.build_ctx, tai.build_ctx, {}

    def jax_build(**kw):
        jctx = jbuild(**kw)
        made["port"] = tbuild(**kw, device="cpu")
        _transplant(jctx, made["port"], data_generator.NUM_DENSE)
        return jctx

    monkeypatch.setattr(jai, "build_ctx", jax_build)
    jauc = jai.main_npz(str(path), str(path), batch_size=256, epochs=4)
    monkeypatch.setattr(tai, "build_ctx", lambda **kw: made["port"])
    tauc = tai.main_npz(str(path), str(path), batch_size=256, epochs=4,
                        device="cpu")
    assert tauc > 0.68, tauc
    assert abs(tauc - jauc) <= TOL, (tauc, jauc)
