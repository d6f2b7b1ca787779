"""The port's YAML subset and job configuration against PyYAML and the JAX
package, on the CPU.

Tolerance: none. The reader must give what ``yaml.safe_load`` gives, the
writer must write what ``yaml.safe_load`` reads back equal, and the two
packages' loaded configurations must agree field by field.
"""

import dataclasses
import enum
import glob
import math
import os

import pytest
import yaml

from persia_tpu import config as jcfg
from persia_tpu.service.helper import _schema_to_yaml_dict as j_schema_dict
from persia_tpu_torch import _yaml
from persia_tpu_torch import config as tcfg
from persia_tpu_torch import utils as tutils
from persia_tpu_torch.service.helper import _schema_to_yaml_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_CONFIGS = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "examples", "*", "config",
                                    "*.yml")))


def _plain(x):
    """A dataclass tree as dicts, enums as their values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, enum.Enum):
        return x.value
    return x


def test_every_example_config_is_found():
    assert len(EXAMPLE_CONFIGS) >= 4


@pytest.mark.parametrize("path", EXAMPLE_CONFIGS)
def test_reader_matches_safe_load_on_example_configs(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    assert _yaml.load(text) == yaml.safe_load(text)


SUBSET_DOCS = {
    "block_lists": "a:\n- 1\n- 2\nb:\n  - x\n  - y\n",
    "nested_flow": "b: {x: 1, y: [1, 2, {z: null}], 'q r': \"s\"}\n",
    "list_of_maps": "- a: 1\n  b: 2\n- - x\n  - y\n-\n  c: 3\n",
    "scalars": ("k: 'it''s'\nj: \"a\\tb\\u00e9\"\nn: ~\no: Off\np: 0x1F\n"
                "q: 017\nr: 1_000\ns: .5\nt: -.inf\nu: 1e5\nv: 1.0e+5\n"
                "w: 0b101\nx: +12\ny: -0\nz: yes\n"),
    "empty_collections": "x:\n  y:\n    z: 1\n  w: []\n  e: {}\nn:\n",
    "document_start": "---\n# a comment\na: b c d\n\n  # indented\nc: /tmp/x\n",
    "typed_keys": "1: one\ntrue: t\n~: n\n",
    "empty": "# only a comment\n",
}


@pytest.mark.parametrize("name", sorted(SUBSET_DOCS))
def test_reader_matches_safe_load_on_the_subset(name):
    text = SUBSET_DOCS[name]
    assert _yaml.load(text) == yaml.safe_load(text)


OUTSIDE = {
    "block_scalar": "a: |\n  x\n",
    "anchor_alias": "a: &x 1\nb: *x\n",
    "tag": "a: !!str 1\n",
    "trailing_comment": "a: b # c\n",
    "multiline_flow": "a: [1,\n  2]\n",
    "timestamp": "a: 2001-12-14\n",
    "tab": "a:\tb\n",
    "two_documents": "a: 1\n---\nb: 2\n",
    "bad_indent": "a:\n    b: 1\n  c: 2\n",
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_document_outside_the_subset_raises(name):
    with pytest.raises(_yaml.YamlError):
        _yaml.load(OUTSIDE[name])


def _schemas(cfg):
    seq = cfg.uniform_slots(["user_geo", "user_device", "target_item"],
                            dim=16)
    seq["recent_items"] = cfg.SlotConfig(
        name="recent_items", dim=16, embedding_summation=False,
        sample_fixed_size=64)
    seq["recent_clicks"] = cfg.SlotConfig(name="recent_clicks", dim=16,
                                          pooling="last4")
    hs = {
        "hashed": cfg.SlotConfig(
            name="hashed", dim=8,
            hash_stack_config=cfg.HashStackConfig(hash_stack_rounds=2,
                                                  embedding_size=1000)),
        "mean": cfg.SlotConfig(name="mean", dim=8, pooling="mean",
                               sqrt_scaling=False),
        "scaled": cfg.SlotConfig(name="scaled", dim=4, sqrt_scaling=True),
    }
    return {
        "seq_rec": cfg.EmbeddingSchema(slots_config=seq),
        "dlrm26": cfg.EmbeddingSchema(
            slots_config=cfg.uniform_slots([f"C{i}" for i in range(1, 27)],
                                           dim=16),
            feature_index_prefix_bit=12),
        "hash_stack": cfg.EmbeddingSchema(
            slots_config=hs, feature_index_prefix_bit=8,
            feature_groups={"g": ["hashed", "mean"]}),
    }


@pytest.mark.parametrize("name", ["seq_rec", "dlrm26", "hash_stack"])
def test_schema_dump_reads_back_equal(name, tmp_path):
    """The port writes the schema document the JAX helper writes, PyYAML
    reads it back equal, and both packages load it to the same schema."""
    doc = _schema_to_yaml_dict(_schemas(tcfg)[name])
    assert doc == j_schema_dict(_schemas(jcfg)[name])
    text = _yaml.dump(doc)
    assert yaml.safe_load(text) == doc
    assert _yaml.load(text) == doc
    assert _yaml.load(yaml.safe_dump(doc)) == doc
    path = os.fspath(tmp_path / "schema.yml")
    tutils.dump_yaml(doc, path)
    assert _plain(tcfg.EmbeddingSchema.load(path)) == _plain(
        jcfg.EmbeddingSchema.load(path))


FULL_GLOBAL = {
    "common_config": {
        "job_type": "Eval",
        "embedding_wire_dtype": "f32",
        "metrics_config": {"enable_metrics": True, "push_interval_sec": 5},
        "checkpointing_config": {"num_workers": 3},
        "infer_config": {"servers": ["127.0.0.1:8888", "10.0.0.2:1"],
                         "initial_sparse_checkpoint": "ckpt/0001"},
    },
    "embedding_worker_config": {"forward_buffer_size": 64,
                                "buffered_data_expired_sec": 90},
    "embedding_parameter_server_config": {
        "capacity": 2_000_000, "num_hashmap_internal_shards": 8,
        "row_dtype": "bf16", "capacity_bytes": 1 << 30,
        "spill_dir": "spill", "spill_bytes": 0,
        "full_amount_manager_buffer_size": 10,
        "enable_incremental_update": False,
        "incremental_buffer_size": 100, "incremental_dir": "inc",
    },
}


def test_global_config_dump_reads_back_equal(tmp_path):
    text = _yaml.dump(FULL_GLOBAL)
    assert yaml.safe_load(text) == FULL_GLOBAL
    assert _yaml.load(text) == FULL_GLOBAL
    path = os.fspath(tmp_path / "global.yml")
    tutils.dump_yaml(FULL_GLOBAL, path)
    assert _plain(tcfg.GlobalConfig.load(path)) == _plain(
        jcfg.GlobalConfig.load(path))


@pytest.mark.parametrize("path", EXAMPLE_CONFIGS)
def test_both_packages_load_example_configs_alike(path):
    full = os.path.join(REPO, path)
    kind = ("EmbeddingSchema" if "embedding_config" in path
            else "GlobalConfig")
    got = getattr(tcfg, kind).load(full)
    want = getattr(jcfg, kind).load(full)
    assert _plain(got) == _plain(want)


def test_default_global_config_matches_jax():
    assert _plain(tcfg.GlobalConfig()) == _plain(jcfg.GlobalConfig())
    assert _plain(tcfg.GlobalConfig.from_dict(None)) == _plain(
        jcfg.GlobalConfig.from_dict(None))


@pytest.mark.parametrize("value", [
    "yes", "No", "on", "null", "~", "", "123", "0x1f", "1.5", ".inf",
    "- item", "key: value", "#hash", " padded", "tab\there", "new\nline",
    "[x]", "{x}", "'q'", "*alias", "&anchor", "!tag", "|", ">", "@", "%",
    "2001-12-14", "1:20", "é",
])
def test_dump_quotes_strings_that_read_as_something_else(value):
    doc = {"k": value, "l": [value]}
    text = _yaml.dump(doc)
    assert yaml.safe_load(text) == doc
    assert _yaml.load(text) == doc


@pytest.mark.parametrize("value", [
    0.1, -2.5, 1e-5, 1e20, -0.0, 3.0, 2 ** 70, -7, True, False, None,
])
def test_dump_numbers_keep_their_type(value):
    text = _yaml.dump({"v": value})
    back = yaml.safe_load(text)["v"]
    assert type(back) is type(value) and back == value
    assert _yaml.load(text)["v"] == value


def test_dump_special_floats():
    back = yaml.safe_load(_yaml.dump([math.inf, -math.inf, math.nan]))
    assert back[:2] == [math.inf, -math.inf] and math.isnan(back[2])


def test_load_yaml_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tutils.load_yaml(os.fspath(tmp_path / "absent.yml"))
