"""The check: the reference against the port's plain CPU path at a small
size of every cell, and runs with the timed path broken underneath that
must come out not correct (the harness's look for a card skipped: the
whole run on the CPU at a small size)."""

import math

import pytest
import torch

from portbench import check, control, harness
from portbench.reference.dlrm import hash_rows

from portbench_cpu import CELLS, tiny_cell

SEED = 2**31 + 99


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    """The port on the CPU reproduces the reference; a sound run passes."""
    result, lines = harness.run_cell(tiny_cell(name), SEED, 0.2, False,
                                     "cpu")
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert result["metrics"] == {}  # no device number from a CPU run
    for number in result["checks"].values():
        assert number["value"] <= 1e-6


def test_traced_run_is_correct_and_reads_no_device_metric():
    name = CELLS[0]
    result, lines = harness.run_cell(tiny_cell(name), SEED, 0.2, True, "cpu")
    assert result["correct"], lines
    assert result["metrics"] == {} and "breakdown" not in result


def test_hash_is_the_ports():
    from persia_tpu_torch.ops.embedding_bag import hash_ids

    ids = torch.randint(-5, 2**31 - 1, (64, 7), generator=torch.Generator()
                        .manual_seed(3), dtype=torch.int64).to(torch.int32)
    for vocab in (2, 3, 1460, 10_131_227):
        rows, mask = hash_rows(ids, vocab)
        want, want_mask = hash_ids(ids, vocab)
        assert torch.equal(rows, want.long()) and torch.equal(mask, want_mask)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_over_the_limits(name):
    """The reference in float8 put in the program's place fails the
    cell's limits (at a size a test run holds)."""
    cell = tiny_cell(name, rows=20000, batch=512, pool=4)
    r = control.readings(cell, SEED, "cpu")
    assert check.within(r["program"], cell.limits)
    assert not check.within(r["control"], cell.limits), r


def _train_cells():
    return [n for n in CELLS if tiny_cell(n).traffic["mode"] == "train"]


@pytest.mark.parametrize("name", _train_cells())
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    from persia_tpu_torch.parallel.optim import OptaxAdagrad

    monkeypatch.setattr(OptaxAdagrad, "step", lambda self, closure=None: None)
    result, _ = harness.run_cell(tiny_cell(name), SEED, 0.2, False, "cpu")
    assert not result["correct"]
    changes = [v["value"] for k, v in result["checks"].items()
               if k.startswith("change_gap")]
    assert changes and all(v == pytest.approx(1.0) for v in changes)


@pytest.mark.parametrize("name", _train_cells())
def test_half_batch_is_not_correct(name, monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from persia_tpu_torch.parallel.device_mode import DeviceModeStep

    rows = DeviceModeStep._rows
    monkeypatch.setattr(DeviceModeStep, "_rows",
                        lambda self, x: rows(self, x)[: len(x) // 2])
    result, _ = harness.run_cell(tiny_cell(name), SEED, 0.2, False, "cpu")
    assert not result["correct"]


@pytest.mark.parametrize("name", [n for n in CELLS if n not in _train_cells()])
def test_altered_answer_is_not_correct(name, monkeypatch):
    """One prediction altered where it is produced."""
    from persia_tpu_torch.parallel.device_mode import DeviceModeModel

    forward = DeviceModeModel.forward

    def altered(self, non_id, ids):
        out = forward(self, non_id, ids).clone()
        out[5] = (out[5] + 0.5) % 1.0
        return out

    monkeypatch.setattr(DeviceModeModel, "forward", altered)
    result, _ = harness.run_cell(tiny_cell(name), SEED, 0.2, False, "cpu")
    assert not result["correct"]


def test_non_finite_numbers_are_never_within():
    assert not check.within({"x": math.nan}, {"x": 1.0})
    assert not check.within({"x": math.inf}, {"x": 1.0})
    same = ([1.0], [1.0, 2.0], [1.0, 2.0], [1.0, 2.0])
    assert check.train_numbers(same, same) == {
        "loss_gap": 0.0, "grad_gap": 0.0, "change1_gap": 0.0,
        "change_gap": 0.0}
    # three leaves' changes off by 1%, 2% and 30% of the median's scale;
    # the third's gradient under a thousandth of the median's: left out
    n = check.train_numbers(([1.0], [1.0, 1.0, 1e-4], [1.01, 2.04, 3.9],
                             [1.01, 2.04, 3.9]),
                            ([1.0], [1.0, 1.0, 1e-4], [1.0, 2.0, 3.0],
                             [1.0, 2.0, 3.0]))
    assert n["grad_gap"] == 0.0
    assert n["change_gap"] == n["change1_gap"] == pytest.approx(0.04 / 2)
