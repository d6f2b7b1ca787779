"""The port's in-process example scripts against the JAX package's, on the
CPU: ``persia_tpu_torch/examples/seq_rec/train.py`` against
``examples/seq_rec/train.py`` and ``persia_tpu_torch/examples/
adult_income/train.py``'s synthetic path against
``examples/adult_income/train.py``.

Each script's own ``build_ctx`` builds both sides at the script's widths
(seq_rec: 4 heads, a 64-long history over 50,000 items, batch 256;
adult-income: the DNN over 8 slots of dim 8); the port's tower takes the
JAX side's initial flax weights, both train the same batches from fresh
PS replicas and their ``evaluate`` scores the same held-out samples.
Tolerance, the bf16 rule of ``tests/test_torch_train.py``: both scripts
train in bf16 with the bf16 wire, 2e-2 on losses and predictions (the
two frameworks round to bf16 at different places, 2**-8 relative each,
through several bf16 layers); the AUC of the held-out samples within
2e-2 as well (predictions that move by 2e-2 reorder only near-ties).

After the steps the updated state is compared too: every PS row the
steps touched (embedding and Adagrad state) within 2e-2 as in
``tests/test_torch_train.py``, and the update itself (the state after
the steps less the state before), of the dense tower as one vector and of
each PS replica's touched rows as another, within 20% of JAX's update in
L2 norm. The update, not the parameters: Adam and Adagrad move a weight
by about their learning rate a step, far below 2e-2 in 3 steps, so only
the update shows a wrong or missing optimizer. 20%, since bf16 rounding
makes Adam's normalized step noisy where the true gradient is near zero
(a bias before a batch norm has only rounding for a gradient): 5-6% is
seen on both scripts; a tenfold learning rate is about 900% off and a
missing step 100%. ``test_seq_rec_script_matches_jax`` shows that the
comparison fails the script with a tenfold dense or sparse learning rate
or a tenfold PS row initialization.

The adult-income script's own claims (``tests/test_e2e_local.py``) hold
for the port: AUC above 0.70 at 300 steps of 256, and bit-identical
losses across two runs. seq_rec's ``main`` runs as a script at a reduced
``--steps`` (and over a one-rank ``--mesh``) and exits with its code.
"""

import argparse
import importlib.util
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 2e-2
UPDATE_RTOL = 0.2  # of JAX's update, in L2 norm (the module docstring)
STEPS = 3


def _jax_script(name):
    """The JAX package's example script ``examples/<name>/train.py`` as a
    module of its own (its directory on the path for its siblings)."""
    path = REPO / "examples" / name / "train.py"
    sys.path.insert(0, str(path.parent))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}_train",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(path.parent))
    return mod


@pytest.fixture
def jax_numpy_middleware(monkeypatch):
    from persia_tpu.worker import middleware as jmw

    monkeypatch.setattr(jmw, "_mw_native", lambda: None)


def _transplant(jctx, tctx, num_dense):
    """The JAX context's initial weights (drawn by ``build_state_template``
    at a fixed seed) set on both sides."""
    import jax.numpy as jnp

    from persia_tpu.parallel.train import TrainState, make_eval_step
    from persia_tpu.serving import build_state_template
    from persia_tpu_torch.weights import load_flax_params, numpy_tree

    tmpl = build_state_template(jctx.model, jctx.schema, num_dense, seed=5)
    jctx.state = TrainState(
        params=tmpl.params, batch_stats=tmpl.batch_stats,
        opt_state=jctx.dense_optimizer.init(tmpl.params),
        step=jnp.zeros((), jnp.int32))
    jctx._eval_step = make_eval_step(jctx.model)
    load_flax_params(tctx.model, numpy_tree(tmpl.params),
                     numpy_tree(tmpl.batch_stats))


def _record_updates(worker):
    """Wrap each PS replica's ``update_gradients`` to keep the signs it
    updated, with their dim: one ``{sign: dim}`` a replica."""
    seen = [{} for _ in worker.ps_clients]
    for h, signs in zip(worker.ps_clients, seen):
        def update(s, grads, dim, _inner=h.update_gradients, _seen=signs):
            _seen.update(dict.fromkeys(np.asarray(s).tolist(), dim))
            return _inner(s, grads, dim)

        h.update_gradients = update
    return seen


def _rows(holder, signs):
    """The rows (embedding and optimizer state, f32) of ``signs`` (``{sign:
    dim}``) in one holder, in sorted sign order."""
    out = []
    for dim in sorted(set(signs.values())):
        s = np.array(sorted(k for k, d in signs.items() if d == dim),
                     np.uint64)
        width = len(holder.get_entry(int(s[0]))[1])
        found, vecs = holder.get_entries(s, width)
        assert found.all()
        out.append(vecs.reshape(-1))
    return np.concatenate(out)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _train_both(jctx, tctx, jbatches, tbatches):
    """The steps on both sides, losses and predictions compared after
    each; returns the signs each side's PS replicas updated."""
    jseen, tseen = _record_updates(jctx.worker), _record_updates(tctx.worker)
    with jctx, tctx:
        for jb, tb in zip(jbatches, tbatches):
            jloss, jpred = jctx.train_step(jb)
            tloss, tpred = tctx.train_step(tb)
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose(tpred.float().numpy(),
                                       np.asarray(jpred, np.float32),
                                       rtol=TOL, atol=TOL)
    return jseen, tseen


def _update_close(got, want, init, what):
    move = np.linalg.norm(want - init)
    assert move > 0, f"{what}: JAX's steps did not move it"
    err = float(np.linalg.norm(got - want)) / move
    assert err <= UPDATE_RTOL, (
        f"{what}: the port's update is {err:.3f} of JAX's off")


def _check_state(jctx, tctx, init, fresh, seen):
    """The state after the steps: the dense parameters (``init``: before
    them) and the rows the steps touched on each PS replica (``fresh``: an
    untrained context of the port's script, whose replicas initialize the
    same signs as the steps did)."""
    from persia_tpu_torch.weights import flax_params

    want, got = _flat(jctx.state.params), _flat(flax_params(tctx.model)[0])
    assert set(got) == set(want) == set(init)
    _update_close(*(np.concatenate([t[k].ravel() for k in sorted(want)])
                    for t in (got, want, init)), "the dense tower")
    jseen, tseen = seen
    assert jseen == tseen and all(tseen)
    with fresh:
        for r, (jh, th, fh) in enumerate(zip(jctx.worker.ps_clients,
                                             tctx.worker.ps_clients,
                                             fresh.worker.ps_clients)):
            for dim in set(tseen[r].values()):
                fh.lookup(np.array([k for k, d in tseen[r].items()
                                    if d == dim], np.uint64), dim, True)
            a, b, c = (_rows(h, tseen[r]) for h in (jh, th, fh))
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
            _update_close(b, a, c, f"PS replica {r}'s touched rows")


@pytest.mark.parametrize("mutation", [
    None, ("DENSE_LR", 1e-2), ("SPARSE_LR", 1e-1), ("EMB_INIT", (-0.5, 0.5))],
    ids=["as_written", "dense_lr_x10", "sparse_lr_x10", "emb_init_x10"])
def test_seq_rec_script_matches_jax(mutation, jax_numpy_middleware,
                                    monkeypatch):
    """3 steps of batch 256 at the script's widths through each script's
    ``build_ctx`` and ``make_batches``, the state after them, then each
    script's ``evaluate`` on 512 held-out samples. With one of the port
    script's optimizer constants made ten times larger the comparison
    fails."""
    from persia_tpu_torch.examples.seq_rec import train as tsr
    from persia_tpu_torch.weights import flax_params

    if mutation is not None:
        monkeypatch.setattr(tsr, *mutation)
    jsr = _jax_script("seq_rec")
    targs = tsr.parse_args(["--device", "cpu", "--steps", str(STEPS)])
    jargs = argparse.Namespace(**{k: v for k, v in vars(targs).items()
                                  if k != "device"})
    jctx, tctx = jsr.build_ctx(jargs), tsr.build_ctx(targs)
    _transplant(jctx, tctx, tsr.spec(targs).num_dense)
    init = _flat(flax_params(tctx.model)[0])
    n = STEPS * targs.batch_size

    def compare():
        seen = _train_both(
            jctx, tctx, jsr.make_batches(jargs, n, targs.batch_size,
                                         seed=42),
            tsr.make_batches(targs, n, targs.batch_size, seed=42))
        _check_state(jctx, tctx, init, tsr.build_ctx(targs), seen)

    if mutation is not None:
        with pytest.raises(AssertionError):
            compare()
        return
    compare()
    with jctx, tctx:
        jauc = jsr.evaluate(jctx, jargs, num_samples=512)
        tauc = tsr.evaluate(tctx, targs, num_samples=512)
    assert abs(tauc - jauc) <= TOL, (tauc, jauc)
    assert 0.0 <= tauc <= 1.0


def test_adult_income_script_matches_jax(jax_numpy_middleware):
    """3 steps of batch 256 through each script's ``build_ctx`` (the DNN
    with its two batch norms, statistics transplanted too), the state
    after them, then each ``evaluate`` on 1024 held-out samples."""
    from persia_tpu_torch.examples.adult_income import (
        data_generator as tdata,
    )
    from persia_tpu_torch.examples.adult_income import train as tai
    from persia_tpu_torch.weights import flax_params

    jai = _jax_script("adult_income")
    jdata = sys.modules.get("data_generator") or _jax_data()
    jctx, tctx = jai.build_ctx(seed=42), tai.build_ctx(seed=42,
                                                       device="cpu")
    _transplant(jctx, tctx, tdata.NUM_DENSE)
    init = _flat(flax_params(tctx.model)[0])
    seen = _train_both(jctx, tctx, jdata.batches(STEPS * 256, 256, seed=1),
                       tdata.batches(STEPS * 256, 256, seed=1))
    _check_state(jctx, tctx, init, tai.build_ctx(seed=42, device="cpu"),
                 seen)
    with jctx, tctx:
        jauc = jai.evaluate(jctx, num_samples=1024)
        tauc = tai.evaluate(tctx, num_samples=1024)
    assert abs(tauc - jauc) <= TOL, (tauc, jauc)


def _jax_data():
    path = REPO / "examples" / "adult_income" / "data_generator.py"
    spec = importlib.util.spec_from_file_location("data_generator", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_adult_income_script_learns_signal():
    """``tests/test_e2e_local.py``'s bar on the port: AUC above 0.70 after
    300 steps of 256."""
    from persia_tpu_torch.examples.adult_income import train as tai

    auc = tai.main(steps=300, batch_size=256, device="cpu")
    assert auc > 0.70, f"AUC {auc}"


def test_adult_income_script_is_deterministic():
    """The same seeds give bit-identical losses (the synchronous local
    mode), as ``tests/test_e2e_local.py`` asserts of the JAX script."""
    from persia_tpu_torch.examples.adult_income import train as tai
    from persia_tpu_torch.examples.adult_income.data_generator import batches

    def run():
        ctx = tai.build_ctx(seed=7, device="cpu")
        with ctx:
            return [float(ctx.train_step(b)[0])
                    for b in batches(20 * 128, 128, seed=3)]

    a, b = run(), run()
    assert a == b and len(set(a)) > 1


@pytest.mark.parametrize("extra", [[], ["--mesh", "1,1"]],
                         ids=["in_process", "mesh_of_one"])
def test_seq_rec_main_exits_with_its_code(extra, tmp_path):
    """The script run as a program at a reduced depth (20 steps of 64, a
    16-long history): it prints the held-out AUC and exits 0 above the bar
    of 0.62, 1 below it; ``--mesh 1,1`` brings up a world of one first."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "persia_tpu_torch" / "examples" /
                             "seq_rec" / "train.py"), "--device", "cpu",
         "--steps", "20", "--batch-size", "64", "--t-hist", "16", *extra],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    m = re.search(r"^AUC: ([0-9.]+)$", proc.stdout, re.M)
    assert m, proc.stdout + proc.stderr
    assert proc.returncode == (0 if float(m.group(1)) > 0.62 else 1)
    assert "jax" not in proc.stderr.lower()
