"""The port's public surface against the JAX package's, from the sources.

Each module ``persia_tpu/<path>`` is parsed beside its counterpart
``persia_tpu_torch/<path>``; neither package is imported. A public
function or class of the JAX module (a top-level name without a leading
underscore), a public method of such a class (``__init__`` included) and
every parameter of those must be in the port's module: a name it binds at
its top level (a ``def``, a ``class``, an assignment or an import), a
method of the port's class of the same name, a parameter of the port's
function or method. What the port leaves out on purpose is in
``ALLOWED``, with the reason; an entry that is no longer missing fails
too, so that the list stays exact.

Keys: ``"<path>"`` for a module without a counterpart,
``"<path>:<name>"`` for a member, ``"<path>:<name>(<param>)"`` for a
parameter.
"""

import ast
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "persia_tpu"
PORT_PKG = REPO / "persia_tpu_torch"

GSPMD = ("a GSPMD or flax concept with no counterpart in the port: its "
         "meshes are torch.distributed groups, its shards explicit "
         "collectives, its dense state a torch module")
FLAX_STATE = ("a flax target pytree of the serving state; the port serves "
              "from dense.pt (ROADMAP §C)")
STATED = "a stated difference (ROADMAP §C / §A)"
PLUMBING = "JAX/TPU process plumbing (ROADMAP §A)"
KERNEL = ("a Pallas or XLA kernel's entry point or option; its Hopper "
          "counterpart is named in PERF.md's kernel table, and block "
          "sizes, interpret mode and impl mean nothing there")

ALLOWED = {
    # GSPMD and flax concepts with no counterpart in the port
    "parallel/mesh.py:batch_sharding": GSPMD,
    "parallel/mesh.py:replicated": GSPMD,
    "parallel/mesh.py:table_sharding": GSPMD,
    "parallel/mesh.py:shard_batch_pytree": GSPMD,
    "parallel/mesh.py:make_mesh(axis_names)": GSPMD,
    "parallel/mesh.py:make_mesh(devices)": GSPMD,
    "parallel/ring_attention.py:ring_attention(axis_name)": GSPMD,
    "parallel/ulysses.py:ulysses_attention(axis_name)": GSPMD,
    "parallel/train.py:TrainState": GSPMD,
    "parallel/train.py:create_train_state": GSPMD,
    "parallel/train.py:make_packed_train_step": (
        GSPMD + "; the port's step is make_train_step / "
        "make_packed_train_step_ddp"),
    "parallel/train.py:init_ef_state(params)": GSPMD,
    "serving.py:build_state_template": FLAX_STATE,
    "serving.py:load_dense_state": FLAX_STATE,
    "serving.py:InferenceServer.__init__(state)": FLAX_STATE,
    "serving.py:InferenceServer.add_variant(state)": FLAX_STATE,
    "ctx.py:InferCtx.__init__(state)": FLAX_STATE,
    "ctx.py:InferCtx.__init__(**kw)": FLAX_STATE,
    # stated differences already in ROADMAP §C or §A
    "worker/device_cache.py:VictimBuffer.put": (
        STATED + ": the port's victim buffer has the batch forms"),
    "worker/device_cache.py:VictimBuffer.take": STATED,
    "worker/device_cache.py:VictimBuffer.peek_if": STATED,
    "worker/device_cache.py:VictimBuffer.take_if": STATED,
    "service/ps_service.py:ShardParallelDispatcher.__init__(enabled)": (
        STATED + ": the shard-parallel dispatch"),
    "service/ps_service.py:ShardParallelDispatcher.__init__(force)": STATED,
    "service/ps_service.py:ShardParallelDispatcher.lookup": STATED,
    "service/ps_service.py:ShardParallelDispatcher.update_gradients": STATED,
    "service/ps_service.py:ShardParallelDispatcher.close": STATED,
    "service/ps_service.py:PsService.__init__(shard_parallel)": STATED,
    "utils.py:arm_watchdog": PLUMBING,
    "utils.py:force_cpu_platform": PLUMBING,
    "utils.py:resolve_binary_path": (
        STATED + ": service/native_bin.py takes its place"),
    "env.py": ("process plumbing: the port reads its environment through "
               "knobs.py"),
    "logger.py": "the port logs through the standard logging module",
    "version.py": "the port's __version__ is in its __init__.py",
    # kernel entry points and options with no meaning in the port
    "ops/embedding_bag.py:xla_embedding_bag": KERNEL,
    "ops/embedding_bag.py:pack_table": KERNEL,
    "ops/embedding_bag.py:pallas_embedding_bag": KERNEL,
    "ops/embedding_bag.py:pallas_embedding_bag_packed": KERNEL,
    "ops/embedding_bag.py:embedding_bag(impl)": KERNEL,
    "ops/embedding_bag.py:embedding_bag(interpret)": KERNEL,
    "ops/flash_attention.py:flash_attention_fwd_pallas": KERNEL,
    "ops/flash_attention.py:flash_attention_bwd_pallas": KERNEL,
    "ops/flash_attention.py:flash_attention(block_q)": KERNEL,
    "ops/flash_attention.py:flash_attention(block_k)": KERNEL,
    "ops/flash_attention.py:flash_attention(interpret)": KERNEL,
    "ops/flash_attention.py:flash_attention_masked(block_q)": KERNEL,
    "ops/flash_attention.py:flash_attention_masked(block_k)": KERNEL,
    "ops/flash_attention.py:flash_attention_masked(interpret)": KERNEL,
}


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _is_def(node) -> bool:
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__init__"


def surface(path: pathlib.Path) -> dict:
    """``{member: [params]}`` of a module's public functions, classes
    (``[]``) and their public methods (``Class.method``)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if _is_def(node) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = []
            for sub in node.body:
                if _is_def(sub) and _public(sub.name):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
    return out


def bound_names(path: pathlib.Path) -> set:
    """The names a module binds at its top level by assignment or
    import."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def missing(rel: str) -> set:
    """The keys of ``persia_tpu/<rel>``'s surface the port lacks."""
    port = PORT_PKG / rel
    if not port.exists():
        return {rel}
    want, have = surface(JAX_PKG / rel), surface(port)
    names = bound_names(port)
    out = set()
    for member, params in want.items():
        if member not in have:
            if "." in member or member not in names:
                out.add(f"{rel}:{member}")
            continue
        out.update(f"{rel}:{member}({p})" for p in params
                   if p not in have[member])
    return out


MODULES = sorted(str(p.relative_to(JAX_PKG))
                 for p in JAX_PKG.rglob("*.py"))


def test_the_walk_sees_both_packages():
    assert len(MODULES) > 80
    assert sum((PORT_PKG / m).exists() for m in MODULES) == len(MODULES) - 3


@pytest.mark.parametrize("rel", MODULES)
def test_module_surface_is_ported(rel):
    """Every public member and parameter of the JAX module is in the
    port's module, or allowed with a reason."""
    gaps = missing(rel)
    allowed = {k for k in ALLOWED if k == rel or k.startswith(rel + ":")}
    assert not gaps - allowed, (
        f"the port lacks {sorted(gaps - allowed)} of persia_tpu/{rel}")
    assert not allowed - gaps, (
        f"allowed but present in the port (drop them from ALLOWED): "
        f"{sorted(allowed - gaps)}")


def test_every_allowance_names_a_module_and_a_reason():
    for key, reason in ALLOWED.items():
        assert key.split(":")[0] in MODULES, key
        assert len(reason) > 20, key


def test_the_walk_catches_a_missing_member(tmp_path, monkeypatch):
    """The walk on a port module with a member and a parameter taken out
    reports both."""
    rel = "ps/store.py"
    src = (PORT_PKG / rel).read_text()
    cut = src.replace("class EvictionMap:", "class _EvictionMapGone:", 1)
    cut = cut.replace("def load_bytes(self, buf: bytes",
                      "def load_bytes(self, payload: bytes", 1)
    assert cut.count("_EvictionMapGone") == 1 and "payload: bytes" in cut
    (tmp_path / "ps").mkdir()
    (tmp_path / rel).write_text(cut)
    monkeypatch.setattr(sys.modules[__name__], "PORT_PKG", tmp_path)
    gaps = missing(rel)
    assert "ps/store.py:EvictionMap" in gaps
    assert "ps/store.py:EmbeddingHolder.load_bytes(buf)" in gaps
