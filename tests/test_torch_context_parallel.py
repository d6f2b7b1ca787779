"""Context parallelism of the PyTorch port against the JAX package, on the
CPU: ring attention, local (chunked) flash attention, Ulysses, and the
sequence tower trained with Ulysses + flash on a (1, 4) mesh.

The port's ranks are 4 gloo processes on the CPU (one group for the
module, under a deadline, importing only the port); the references are
the JAX functions on a (1, 4) mesh over the conftest's virtual CPU
devices. Each case is a test of its own on the module fixture's results.
Mirrored: ``tests/test_ring_attention.py`` and ``tests/test_ulysses.py``
(outputs and gradients, causal and not, key masks, fully masked rows,
the chunked inner scan, the Pallas impl, the refusals) and
``tests/test_models_parallel.py::test_sequence_tower_trains_context_parallel_pallas``.

Tolerances, each with its reason:

- outputs 3e-5, the JAX tests' own bound between strategies: f32
  online softmax summed in another block order;
- gradients 1e-4 (the JAX tests' bound for the chunked scan's), the same
  sums through the backward;
- the tower, 8 Adam steps in f32 on the plain versions of K2–K4 against
  the JAX tower on the Pallas kernels in interpret mode: losses and the
  embedding gradients 1e-4, the parameters after 1e-3 (Adam moves a
  parameter by ~lr = 1e-2 a step whatever its gradient's size, so the
  gradients' relative error of ~1e-6 stays far below it). The key
  projection's bias is left out: its gradient is 0 in exact arithmetic
  (it shifts all of a query's scores alike, and the softmax is
  invariant to that), so Adam, dividing by the gradient's own
  magnitude, moves it by ±lr on either framework's rounding noise.
"""

import os
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
P = 4  # ranks on the sequence axis
DEADLINE_S = 240.0
OUT_TOL, GRAD_TOL = 3e-5, 1e-4
TOWER_TOL, TOWER_PARAM_TOL = 1e-4, 1e-3
BS, T_HIST, DIM, HEADS, N_DENSE, TOWER_STEPS = 16, 8, 8, 4, 5, 8
KEY_BIAS = "SequenceSelfAttention_0/Dense_1/bias"

# (name, strategy, shape (b, h, t, dh), causal, mask kind, chunk, impl)
CASES = [
    ("ring", "ring", (2, 2, 32, 16), False, None, None, None),
    ("ring_causal", "ring", (2, 2, 32, 16), True, None, None, None),
    ("ring_mask", "ring", (2, 4, 32, 16), False, "half", None, None),
    ("ring_ragged_causal", "ring", (2, 4, 32, 16), True, "ragged", None,
     None),
    ("ring_empty_rows", "ring", (3, 2, 16, 8), False, "empty", None, None),
    ("ulysses", "ulysses", (2, 8, 32, 16), False, None, 512, "local"),
    ("ulysses_causal", "ulysses", (2, 8, 32, 16), True, None, 512, "local"),
    ("ulysses_chunked", "ulysses", (2, 8, 64, 16), False, None, 16,
     "local"),
    ("ulysses_mask_chunked", "ulysses", (2, 4, 32, 16), False, "half", 8,
     "local"),
    ("ulysses_empty_rows", "ulysses", (3, 4, 16, 8), True, "empty", 512,
     "local"),
    ("ulysses_flash_causal_mask", "ulysses", (2, 8, 64, 16), True,
     "ragged", 512, "flash"),
    ("ulysses_flash", "ulysses", (2, 4, 32, 16), False, None, 512, "flash"),
]


def _child_env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def case_inputs(case):
    """q, k, v (f32) and the (B, T) key mask or None, from the case's
    seed."""
    name, _, (b, h, t, dh), _, mask, _, _ = case
    rng = np.random.default_rng(CASES.index(case))
    q, k, v = (rng.normal(size=(b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    if mask is None:
        return q, k, v, None
    if mask == "half":  # the second half of the keys masked everywhere
        keep = np.zeros((b, t), bool)
        keep[:, : t // 2] = True
    elif mask == "ragged":
        keep = rng.random((b, t)) > 0.25
    else:  # "empty": the first row of the batch sees no key at all
        keep = rng.random((b, t)) > 0.3
        keep[0] = False
    return q, k, v, keep


def tower_inputs():
    """``test_sequence_tower_trains_context_parallel_pallas``'s inputs."""
    rng = np.random.default_rng(4)
    dense = rng.normal(size=(BS, N_DENSE)).astype(np.float32)
    emb = rng.normal(size=(BS * T_HIST + 1, DIM)).astype(np.float32)
    index = rng.integers(0, BS * T_HIST, size=(BS, T_HIST)).astype(np.int32)
    label = rng.integers(0, 2, size=(BS, 1)).astype(np.float32)
    return dense, emb, index, label


# --- the port's ranks (torch and the port only) ----------------------------


def port_attention(case, mesh, q, k, v, keep):
    from persia_tpu_torch.parallel.ring_attention import ring_self_attention
    from persia_tpu_torch.parallel.ulysses import ulysses_self_attention

    _, strategy, _, causal, _, chunk, impl = case
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    mask = None if keep is None else torch.from_numpy(keep)
    if strategy == "ring":
        out = ring_self_attention(qt, kt, vt, mesh, causal=causal,
                                  kv_mask=mask)
    else:
        out = ulysses_self_attention(qt, kt, vt, mesh, causal=causal,
                                     chunk_size=chunk, kv_mask=mask,
                                     impl=impl)
    grads = torch.autograd.grad((out ** 2).sum(), (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


def port_tower(params, mesh, context_parallel, attn_impl):
    from persia_tpu_torch.models.seq import SequenceTower
    from persia_tpu_torch.weights import load_flax_params

    model = SequenceTower(N_DENSE, [(DIM, True)], num_heads=HEADS,
                          compute_dtype=torch.float32, attn_impl=attn_impl,
                          mesh=mesh, context_parallel=context_parallel,
                          device="cpu")
    return load_flax_params(model, params)


def train_port_tower(model):
    """TOWER_STEPS packed train steps with Adam(1e-2): per step the loss
    and the raw slot's embedding gradient; then the flat parameters."""
    from persia_tpu_torch.parallel.train import make_train_step
    from persia_tpu_torch.weights import flax_params

    dense, emb, index, label = tower_inputs()
    step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                   lr=1e-2),
                           [emb.shape], wire_dtype=torch.float32)
    losses, grads = [], []
    for _ in range(TOWER_STEPS):
        loss, g, _ = step([torch.from_numpy(dense)],
                          torch.from_numpy(emb.reshape(-1)),
                          [torch.from_numpy(index)], torch.from_numpy(label))
        losses.append(float(loss))
        grads.append(g.reshape(emb.shape).numpy())
    return losses, grads, flat(flax_params(model)[0])


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _refusal(fn):
    try:
        fn()
    except Exception as e:  # the test asserts the type and the message
        return f"{type(e).__name__}: {e}"
    return None


def body_cp(inputs):
    from persia_tpu_torch.distributed import DistributedOption
    from persia_tpu_torch.models.seq import SequenceTower
    from persia_tpu_torch.parallel.ulysses import ulysses_self_attention

    torch.set_num_threads(1)
    mesh = DistributedOption(mesh_shape=(1, P), device="cpu",
                             timeout=60).initialize()
    out = {"cases": {c[0]: port_attention(c, mesh, *case_inputs(c))
                     for c in CASES}}
    out["tower"] = {
        "ulysses": train_port_tower(port_tower(inputs["tower"], mesh,
                                               "ulysses", "flash")),
        "ring": train_port_tower(port_tower(inputs["tower"], mesh, "ring",
                                            "reference")),
        "single": train_port_tower(port_tower(inputs["tower"], None,
                                              "ring", "flash"))}
    x = torch.zeros((1, 3, 32, 16))
    out["heads"] = _refusal(lambda: ulysses_self_attention(x, x, x, mesh))
    tower = SequenceTower(N_DENSE, [(DIM, True)], num_heads=HEADS,
                          mesh=mesh, device="cpu")
    emb, index = torch.zeros((2 * 6 + 1, DIM)), torch.zeros((2, 6),
                                                           dtype=torch.int32)
    out["seq_len"] = _refusal(lambda: tower([torch.zeros((2, N_DENSE))],
                                            [(emb, index)]))
    out["jax_modules"] = sorted(
        n for n in sys.modules
        if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                               "persia_tpu"))
    return out


BODIES = {"cp": body_cp}


# --- the JAX side -------------------------------------------------------------


def jax_mesh():
    import jax

    from persia_tpu.parallel.mesh import make_mesh

    return make_mesh((1, P), devices=jax.devices()[:P])


def jax_attention(case, mesh, q, k, v, keep):
    import jax
    import jax.numpy as jnp

    from persia_tpu.parallel.ring_attention import ring_self_attention
    from persia_tpu.parallel.ulysses import ulysses_self_attention

    _, strategy, _, causal, _, chunk, impl = case
    mask = None if keep is None else jnp.asarray(keep)

    def f(q, k, v):
        if strategy == "ring":
            return ring_self_attention(q, k, v, mesh, causal=causal,
                                       kv_mask=mask)
        return ulysses_self_attention(
            q, k, v, mesh, causal=causal, chunk_size=chunk, kv_mask=mask,
            impl={"local": "xla", "flash": "pallas"}[impl])

    both = jax.jit(lambda *a: (f(*a), jax.grad(
        lambda *b: jnp.sum(f(*b) ** 2), argnums=(0, 1, 2))(*a)))
    out, grads = both(*(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def jax_tower(context_parallel, attn_impl, mesh):
    import jax
    import jax.numpy as jnp
    import optax

    from persia_tpu.models import SequenceTower
    from persia_tpu.parallel.train import (
        create_train_state,
        make_train_step,
        split_embedding_inputs,
    )

    dense, emb, index, label = tower_inputs()
    non_id = [jnp.asarray(dense)]
    emb_inputs = [(jnp.asarray(emb), jnp.asarray(index))]
    model = SequenceTower(num_heads=HEADS, mesh=mesh,
                          context_parallel=context_parallel,
                          attn_impl=attn_impl, compute_dtype=jnp.float32)
    opt = optax.adam(1e-2)
    state = create_train_state(model, opt, jax.random.key(1), non_id,
                               emb_inputs)
    params = jax.tree_util.tree_map(np.asarray, dict(state.params))
    step = make_train_step(model, opt)
    ev, ei = split_embedding_inputs(emb_inputs)
    losses, grads = [], []
    with mesh:
        for _ in range(TOWER_STEPS):
            state, loss, emb_grads, _ = step(state, non_id, ev, ei,
                                             jnp.asarray(label))
            losses.append(float(loss))
            grads.append(np.asarray(emb_grads[0]))
    return params, (losses, grads, flat(state.params))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import test_torch_ranks as launch

    mesh = jax_mesh()
    params, ulysses = jax_tower("ulysses", "pallas", mesh)
    d = tmp_path_factory.mktemp("cp")
    group = launch.start_ranks(__file__, "cp", P, {"tower": params}, d,
                               env=_child_env())
    try:
        ref = {"cases": {c[0]: jax_attention(c, mesh, *case_inputs(c))
                         for c in CASES},
               "tower": {"ulysses": ulysses,
                         "ring": jax_tower("ring", "xla", mesh)[1]}}
    except BaseException:
        group.kill()
        raise
    return ref, launch.collect(group, d, DEADLINE_S)


# --- single-process cases (no mesh) --------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,chunk,masked", [(80, 32, False), (40, 16, True),
                                            (24, 512, True)])
def test_local_flash_attention_matches_jax(causal, t, chunk, masked):
    """The chunked scan (padding tail invalid) and, for T <= chunk, the
    one-block ring with no group, outputs and gradients, against
    ``local_flash_attention`` of the JAX package."""
    import jax
    import jax.numpy as jnp

    from persia_tpu.parallel.ring_attention import (
        local_flash_attention as jlocal,
    )
    from persia_tpu_torch.parallel.ring_attention import (
        local_flash_attention,
    )

    rng = np.random.default_rng(t)
    q, k, v = (rng.normal(size=(2, 2, t, 16)).astype(np.float32)
               for _ in range(3))
    keep = None
    if masked:
        keep = np.ones((2, t), bool)
        keep[:, t - 7:] = False
        keep[1, :3] = False
    jm = None if keep is None else jnp.asarray(keep)
    tm = None if keep is None else torch.from_numpy(keep)

    def jf(q, k, v):
        return jlocal(q, k, v, causal=causal, chunk_size=chunk, kv_mask=jm)

    want = np.asarray(jf(*(jnp.asarray(x) for x in (q, k, v))))
    jgrads = jax.grad(lambda *a: jnp.sum(jf(*a) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = local_flash_attention(qt, kt, vt, causal=causal, chunk_size=chunk,
                                kv_mask=tm)
    grads = torch.autograd.grad((got ** 2).sum(), (qt, kt, vt))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=OUT_TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=GRAD_TOL)


def test_ring_attention_without_a_group_and_fully_masked_rows():
    """``ring_attention(group=None)`` is flash attention on the local
    block; a query row with no valid key gives exactly 0 (and no NaN in
    its gradient), as the JAX kernel's."""
    import jax.numpy as jnp

    from persia_tpu.parallel.ring_attention import ring_attention as jring
    from persia_tpu_torch.parallel.ring_attention import (
        reference_attention,
        ring_attention,
    )

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 16, 8))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    np.testing.assert_allclose(ring_attention(q, k, v).detach().numpy(),
                               reference_attention(q, k, v).detach().numpy(),
                               atol=2e-5)
    mask = torch.zeros((2, 16), dtype=torch.bool)
    out = ring_attention(q, k, v, kv_mask=mask)
    assert torch.equal(out, torch.zeros_like(out))
    want = jring(*(jnp.asarray(x.detach().numpy()) for x in (q, k, v)),
                 kv_mask=jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    (g,) = torch.autograd.grad(out.sum(), q)
    assert torch.isfinite(g).all()


def test_strategy_and_impl_refusals():
    from persia_tpu_torch.models.seq import (
        SequenceSelfAttention,
        SequenceTower,
    )
    from persia_tpu_torch.parallel.ulysses import ulysses_attention

    with pytest.raises(ValueError, match="context_parallel"):
        SequenceSelfAttention(16, 4, context_parallel="ulyses", device="cpu")
    with pytest.raises(ValueError, match="context_parallel"):
        SequenceTower(5, [(8, True)], context_parallel="rings", device="cpu")
    x = torch.zeros((1, 4, 8, 4))
    with pytest.raises(ValueError, match="impl"):
        ulysses_attention(x, x, x, None, impl="pallas")


# --- over the (1, 4) mesh -------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_attention_over_the_mesh_matches_jax(world, case):
    """Every rank returns the whole output and the whole, equal gradients
    (not P times them: the gather back to the replicated value takes
    this rank's block of the cotangent), against the JAX function."""
    ref, ranks = world
    want, jgrads = ref["cases"][case[0]]
    for rank, r in enumerate(ranks):
        out, grads = r["cases"][case[0]]
        np.testing.assert_allclose(out, want, atol=OUT_TOL,
                                   err_msg=f"rank {rank}")
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g, jg, atol=GRAD_TOL,
                                       err_msg=f"rank {rank}")
        if case[4] == "empty":
            assert not out[0].any()
        for g, g0 in zip(grads, ranks[0]["cases"][case[0]][1]):
            np.testing.assert_array_equal(g, g0)


@pytest.mark.parametrize("strategy", ["ulysses", "ring"])
def test_sequence_tower_trains_context_parallel(world, strategy):
    """The tower on (1, 4): Ulysses with the flash path (the plain K2–K4
    on the CPU) against the JAX tower with the Pallas kernels, and the
    ring (f32) against the JAX ring tower, 8 Adam steps from the JAX
    weights, loaded unchanged into the tower built with the mesh; the
    losses fall, and equal the single-rank port tower's."""
    ref, ranks = world
    jlosses, jgrads, jparams = ref["tower"][strategy]
    for rank, r in enumerate(ranks):
        losses, grads, params = r["tower"][strategy]
        np.testing.assert_allclose(losses, jlosses, rtol=TOWER_TOL,
                                   atol=TOWER_TOL, err_msg=f"rank {rank}")
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g, jg, rtol=TOWER_TOL, atol=TOWER_TOL)
        assert set(params) == set(jparams)
        for k in params:
            np.testing.assert_array_equal(params[k],
                                          ranks[0]["tower"][strategy][2][k])
            if k == KEY_BIAS:
                continue  # rounding noise under Adam (module docstring)
            np.testing.assert_allclose(params[k], jparams[k],
                                       rtol=TOWER_PARAM_TOL,
                                       atol=TOWER_PARAM_TOL, err_msg=k)
    assert jlosses[-1] < jlosses[0]
    single = ranks[0]["tower"]["single"][0]
    np.testing.assert_allclose(ranks[0]["tower"][strategy][0], single,
                               rtol=TOWER_TOL, atol=TOWER_TOL)


@pytest.mark.parametrize("case,words", [
    ("heads", ("ValueError", "divisible")),
    ("seq_len", ("ValueError", "does not split")),
])
def test_mesh_refusals(world, case, words):
    _, ranks = world
    for r in ranks:
        got = r[case]
        assert got is not None and got.startswith(words[0] + ":")
        assert words[1] in got, got


def test_ranks_import_no_jax(world):
    _, ranks = world
    assert [r["jax_modules"] for r in ranks] == [[]] * P


if __name__ == "__main__":
    from test_torch_ranks import rank_main

    rank_main(BODIES)
