"""Dense weights of the port's models: flax transplant and seeded init.

:func:`load_flax_params` turns the JAX package's ``state.params`` (and
``state.batch_stats``), given as nested dicts of numpy arrays, into the
weights of the torch module. The torch modules carry flax's names, so
the two trees are walked name by name:

- ``SequenceTower``: ``SequenceSelfAttention_0/Dense_0..3``,
  ``MLP_0/Dense_i``, ``Dense_0``; ``DLRM``: ``MLP_0``, ``MLP_1``;
- ``DNN``: ``Dense_0``, ``BatchNorm_0``, ``Dense_1``, ``BatchNorm_1``,
  ``Dense_2..4``, with ``batch_stats`` ``BatchNorm_0/1`` ``mean`` /
  ``var``;
- ``DCNv2``: ``CrossLayer_i/Dense_0``, ``MLP_0``, ``Dense_0``;
- ``DeepFM``: ``Dense_0``, ``Dense_1`` (dense first order, only with
  dense features), ``MLP_0``, and the head ``Dense_2`` (``Dense_1``
  without dense features);
- ``WideAndDeep``: ``wide``, ``MLP_0``, ``deep_head``;
- the zoo's ``ZooDLRM``: ``MLP_0``, ``field_proj_{i}`` (the fields whose
  dim is not ``proj_dim``), ``MLP_1``; ``PooledSessionNet``: ``MLP_0``;
  ``MultiTaskDNN``: ``MLP_0``, ``head_{t}``. A flax ``Dense`` kernel is
(in, out) and becomes a ``Linear.weight`` (out, in); a device-mode
``DeviceEmbeddingBag`` ``table`` is (V, D) in both and is copied as it is;
a table row-sharded over a mesh's model axis takes the rows of its window
from the whole (V, D) flax table.
An unknown key, a missing one or a shape mismatch raises. :func:`flax_params` is the reverse
walk: the module's weights as a flax tree, to compare a trained port
model with a trained JAX one (a sharded table as this rank's rows, or,
with ``gather_tables``, as the whole table :func:`gather_table` puts back
together).
"""

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from persia_tpu_torch.models.common import FlaxBatchNorm
from persia_tpu_torch.parallel.device_embedding import DeviceEmbeddingBag

# the JAX package's SequenceTower.attn_impl values -> the port's
JAX_ATTN_IMPL = {"xla": "reference", "pallas": "flash"}


def _set(t: torch.Tensor, value: np.ndarray, where: str):
    value = np.array(value, dtype=np.float32)  # a private, writable copy
    if tuple(t.shape) != value.shape:
        raise ValueError(f"{where}: shape {value.shape} does not match the "
                         f"module's {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(torch.from_numpy(value))


def _expect_keys(tree: Mapping, keys, where: str):
    if set(tree) != set(keys):
        raise KeyError(f"{where}: expected keys {sorted(keys)}, got "
                       f"{sorted(tree)}")


def _load(module: nn.Module, params: Mapping, stats: Mapping, where: str):
    if isinstance(module, nn.Linear):
        _expect_keys(params, ("kernel", "bias"), where)
        _set(module.weight, np.asarray(params["kernel"]).T, f"{where}/kernel")
        _set(module.bias, params["bias"], f"{where}/bias")
        return
    if isinstance(module, DeviceEmbeddingBag):
        _expect_keys(params, ("table",), where)
        table = np.asarray(params["table"])
        if module.window is not None and table.shape[:1] == (
                module.vocab_size,):
            lo = module.window[0]
            table = table[lo:lo + module.table.shape[0]]
        _set(module.table, table, f"{where}/table")
        return
    if isinstance(module, FlaxBatchNorm):
        _expect_keys(params, ("scale", "bias"), where)
        _expect_keys(stats, ("mean", "var"), f"{where} (batch_stats)")
        for name in ("scale", "bias"):
            _set(getattr(module, name), params[name], f"{where}/{name}")
        for name in ("mean", "var"):
            _set(getattr(module, name), stats[name], f"{where}/{name}")
        return
    children = dict(module.named_children())
    _expect_keys(params, children, where or "params")
    extra = set(stats) - set(children)
    if extra:
        raise KeyError(f"{where}: unknown batch_stats keys {sorted(extra)}")
    for name, child in children.items():
        _load(child, params[name], stats.get(name, {}), f"{where}/{name}")


def load_flax_params(model: nn.Module, params_np: Mapping,
                     batch_stats_np: Optional[Mapping] = None) -> nn.Module:
    """Copy a flax parameter tree (nested dicts of numpy arrays) into
    ``model`` in place and return it."""
    _load(model, params_np, batch_stats_np or {}, "")
    return model


def _export(module: nn.Module, params: Dict, stats: Dict, gather: bool):
    def arr(t):
        return t.detach().float().cpu().numpy().copy()

    if isinstance(module, nn.Linear):
        params.update(kernel=arr(module.weight).T, bias=arr(module.bias))
        return
    if isinstance(module, DeviceEmbeddingBag):
        params.update(table=arr(gather_table(module) if gather
                                else module.table))
        return
    if isinstance(module, FlaxBatchNorm):
        params.update(scale=arr(module.scale), bias=arr(module.bias))
        stats.update(mean=arr(module.mean), var=arr(module.var))
        return
    for name, child in module.named_children():
        params[name], child_stats = {}, {}
        _export(child, params[name], child_stats, gather)
        if child_stats:
            stats[name] = child_stats


def flax_params(model: nn.Module, gather_tables: bool = False
                ) -> Tuple[Dict, Dict]:
    """The module's weights as flax trees of numpy f32 arrays:
    ``(params, batch_stats)``, the layout :func:`load_flax_params` reads.
    A row-sharded table is this rank's rows, or with ``gather_tables`` the
    whole table (a collective: every rank of the mesh calls it)."""
    params: Dict = {}
    stats: Dict = {}
    _export(model, params, stats, gather_tables)
    return params, stats


def gather_table(bag: DeviceEmbeddingBag) -> torch.Tensor:
    """The whole (V, D) table of a ``DeviceEmbeddingBag``: its shards
    all-gathered along the model axis in row order (every rank of that
    axis calls this), or the table itself when it is not sharded."""
    if bag.window is None:
        return bag.table.detach()
    from persia_tpu_torch.parallel.collectives import all_gather

    return all_gather(bag.table.detach(), bag.group, 0)


def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init with flax's defaults: a ``Dense`` kernel ~ N(0,
    1/fan_in) truncated at two standard deviations, bias zero; a batch
    norm's scale 1, bias 0, running mean 0 and var 1. The draws come from
    an explicit CPU ``torch.Generator``, so a seed gives the same weights
    on every device."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, FlaxBatchNorm):
            mod.reset_parameters()
        if isinstance(mod, nn.Linear):
            fan_in = mod.weight.shape[1]
            w = torch.empty(mod.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
            # 0.8796 is the std of N(0, 1) truncated to [-2, 2]: divide it
            # out so the variance is 1/fan_in, as flax's lecun_normal does
            w *= (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            with torch.no_grad():
                mod.weight.copy_(w)
                mod.bias.zero_()
    return model


def init_device_mode(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init of a device-mode model: every ``DeviceEmbeddingBag``
    table from flax's ``uniform(scale=0.01)``, U[0, 0.01), drawn whole in
    module order from one explicit CPU ``torch.Generator``, so a seed
    gives the same tables on every device and under every sharding; a
    row-sharded table then takes only its window's rows to its device.
    Then the dense layers by :func:`init_params`."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for bag in model.modules():
        if isinstance(bag, DeviceEmbeddingBag):
            table = torch.empty((bag.vocab_size, bag.table.shape[1]),
                                dtype=torch.float32)
            table.uniform_(0.0, 0.01, generator=gen)
            if bag.window is not None:
                lo = bag.window[0]
                table = table[lo:lo + bag.table.shape[0]]
            with torch.no_grad():
                bag.table.copy_(table)
    return init_params(model, seed)


def numpy_tree(tree) -> Dict:
    """A nested mapping of array-likes as nested dicts of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
