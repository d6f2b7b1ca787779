"""The traffic generator's laws at a small size on the CPU."""

import math

import pytest
import torch

from portbench import generator


def _gen(seed=2**31 + 5):
    return torch.Generator().manual_seed(seed)


def test_log1p_count_dense_is_the_log_of_whole_nonnegative_counts():
    x = generator.draw_dense({"law": "log1p_count", "max": 4095},
                             (64, 1000, 13), _gen(), "cpu")
    assert x.dtype == torch.float32 and x.min() >= 0
    counts = torch.expm1(x.double())
    assert torch.allclose(counts, counts.round(), atol=1e-3 * counts.max())
    assert counts.max() <= 4095.5
    # the count's log is spread evenly: zero with probability log 2 / log 4096
    zero = (counts < 0.5).double().mean().item()
    assert zero == pytest.approx(math.log(2) / math.log(4096), abs=0.01)


def test_uniform_dense_and_unknown_laws():
    x = generator.draw_dense({"law": "uniform"}, (1000,), _gen(), "cpu")
    assert 0 <= x.min() and x.max() < 1
    assert torch.equal(x, torch.rand((1000,), generator=_gen()))
    with pytest.raises(ValueError, match="dense law"):
        generator.draw_dense({"law": "normal"}, (4,), _gen(), "cpu")


def test_zipf_ranks_follow_the_law():
    cdf = generator.zipf_cdf(1000, 1.2, "cpu")
    r = generator.zipf_ranks(_gen(), cdf, (200_000,))
    assert 0 <= r.min() and r.max() <= 999
    p0 = 1 / sum(k ** -1.2 for k in range(1, 1001))
    assert (r == 0).double().mean().item() == pytest.approx(p0, abs=0.01)
