"""BENCHMARK.json against the rules of its format, and every cell,
configuration, traffic, limit and reader found by name; a new cell,
configuration and metric added as files plus manifest entries alone."""

import json
import re
import shutil

import pytest

from portbench import harness, registry
from portbench.arch import arch

from portbench_cpu import CELLS, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
MEASURED = {"train_samples_per_s", "eval_samples_per_s", "step_ms_p95",
            "setup_s"}  # what harness.run_cell measures


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keeps_its_format():
    raw = (registry.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    m = json.loads(raw)
    assert set(m) == KEYS
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (registry.ROOT / p).is_dir()
    assert 1 <= len(m["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert e["name"] in MEASURED
    layers = {}
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert e["moves"] in e2e and _line(e["layer"])
        layers.setdefault(e["layer"].lower(), set()).add(e["layer"])
    assert all(len(v) == 1 for v in layers.values())
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({e["name"] for e in metrics}) == len(metrics)
    for e in metrics:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        if e["unit"] == "%" and "roofline" in e["name"]:
            assert e["name"].split(".")[0].endswith("_roofline")
    cells = m["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    configs = {c["name"]: c for c in m["configs"]}
    assert len(configs) == len(m["configs"])
    assert len({c["file"] for c in m["configs"]}) == len(configs)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells)
        assert registry._load(registry.ROOT / c["file"])["reduced"] == \
            c["reduced"]
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        cell = registry.load_cell(w["name"])
        reported = {e.name for e in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for e in m["per_layer"]:
            if registry._applies(e, w["name"]):
                assert e["moves"] in reported


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = registry.load_cell(name)
    a = arch(cell.config)
    assert a.fields == len(a.rows) and cell.traffic["mode"] in ("train",
                                                                "eval")
    assert int(cell.traffic["pool"]) >= harness.FIRST_STEPS
    known = ({"loss_gap", "grad_gap", "change1_gap", "change_gap"}
             if cell.traffic["mode"] == "train" else {"pred_gap"})
    assert cell.limits and set(cell.limits) <= known
    for metric in cell.per_layer:
        assert callable(registry.reader(metric.name))


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a per-layer metric by new files and manifest entries; the
    harness finds each by name and runs the cell."""
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.ROOT / "portbench", tmp_path / "portbench")
    pkg = tmp_path / "portbench"
    m = registry.manifest(tmp_path)
    config = registry._load(pkg / "configs" / "dlrm-criteo-kaggle.json")
    config.update(name="dlrm-dummy", arch_embedding_size="50-60-70")
    (pkg / "configs" / "dlrm-dummy.json").write_text(json.dumps(config))
    traffic = registry._load(pkg / "traffic" / "train-zipf.json")
    traffic.update(batch=32, pool=3, warm_steps=1)
    (pkg / "traffic" / "train-dummy.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "dlrm-dummy.train-dummy.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3}}))
    (pkg / "metrics" / "dummy_rows.train.py").write_text(
        "def read(obs):\n    return obs.rows_traced\n")
    m["configs"].append({"name": "dlrm-dummy", "source": "a test",
                         "file": "portbench/configs/dlrm-dummy.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "dlrm-dummy.train-dummy",
                           "config": "dlrm-dummy", "traffic": "train-dummy",
                           "chips": 1, "why": "a test"})
    for e in m["end_to_end"]:
        if e["name"] == "train_samples_per_s":
            e["workloads"].append("dlrm-dummy.train-dummy")
    m["per_layer"].append({"name": "dummy_rows.train", "unit": "rows",
                           "better": "lower", "source": "program_counter",
                           "layer": "device", "moves": "train_samples_per_s",
                           "workloads": ["dlrm-dummy.train-dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = registry.load_cell("dlrm-dummy.train-dummy", tmp_path)
    assert arch(cell.config).rows == (50, 60, 70)
    assert [e.name for e in cell.per_layer] == ["dummy_rows.train"]
    assert "train_samples_per_s" in {e.name for e in cell.end_to_end}
    assert registry.reader("dummy_rows.train", tmp_path)(
        harness.Observations(None, True, 32, 3, None, 0, 7.0, None, 0, 0)
    ) == 7.0
    result, _ = harness.run_cell(tiny(cell), 2**31 + 7, 0.2, False, "cpu")
    assert result["correct"] and result["attempted"] > 0
