"""The yardstick's counts against hand counts."""

import pytest

from portbench import counts, registry
from portbench.arch import arch, leaves


def _arch(name):
    m = registry.manifest()
    entry = next(c for c in m["configs"] if c["name"] == name)
    return arch(registry._load(registry.ROOT / entry["file"]))


def test_criteo_kaggle_tower_counts():
    a = _arch("dlrm-criteo-kaggle")
    # bottom 13-512-256-64-16: 6,656 + 131,072 + 16,384 + 1,024
    # interaction 27 x 27 x 16 = 11,664
    # top 367-512-256-1: 187,904 + 131,072 + 256
    assert a.top_in == 16 + 27 * 26 // 2 == 367
    assert counts.tower_macs(a) == 486_032
    assert counts.tower_flops(a, train=False) == 2 * 486_032
    # backward: both gradients of every product but the dense input's
    assert counts.tower_flops(a, train=True) == 2 * (3 * 486_032 - 13 * 512)
    assert sum(a.rows) == 33_762_577


def test_bench_random_tower_counts():
    a = _arch("dlrm-bench-random")
    # bottom 512-512-64: 262,144 + 32,768; interaction 9 x 9 x 64 = 5,184
    # top 100-1024-1024-1024-1: 102,400 + 2 x 1,048,576 + 1,024
    assert a.top_in == 100
    assert counts.tower_macs(a) == 2_500_672
    assert counts.tower_params(a) == (512 * 512 + 512 + 512 * 64 + 64
                                      + 100 * 1024 + 1024
                                      + 2 * (1024 * 1024 + 1024)
                                      + 1024 + 1)


@pytest.mark.parametrize("name", ["dlrm-criteo-kaggle", "dlrm-bench-random"])
def test_leaves_cover_the_tower(name):
    a = _arch(name)
    lv = leaves(a)
    assert len(lv) == a.fields + 2 * (len(a.bottom) + 1 + len(a.top) + 1)
    dense = sum(leaf.numel for leaf in lv[a.fields:])
    assert dense == counts.tower_params(a)


def test_k1_and_adagrad_bytes_by_hand():
    a = _arch("dlrm-criteo-kaggle")
    # 10 ids, 7 distinct rows of 16 f32, a (4, 26, 16) bf16 output
    assert counts.k1_bytes(10, 7, 4, a) == 10 * 4 + 7 * 64 + 4 * 26 * 16 * 2
    # 5 accesses of 4 bytes to each touched table value and tower value
    assert counts.adagrad_bytes(7, a) == 20 * (7 * 16
                                               + counts.tower_params(a))


def test_bound_is_the_bytes_over_the_memory_rate():
    assert counts.bound_s(3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(6.7e9) == pytest.approx(2e-3)


def test_trace_summary_union_and_gaps():
    """The busy union, the window and the idle gaps of a made-up trace:
    kernels at [0, 10) and [5, 20) us and a copy at [30, 40) us, launched
    by runtime calls on the host; 50 us of host time."""
    from portbench import trace

    def ev(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid}

    events = [ev("cuda_runtime", "cudaLaunchKernel", 0, 2),
              ev("cuda_runtime", "cudaLaunchKernel", 3, 2),
              ev("cuda_runtime", "cudaMemcpyAsync", 18, 15),
              ev("cpu_op", "aten::mm", 0, 50, tid=2),
              ev("kernel", "void (anonymous namespace)::bag_kernel<true, 1>"
                 "(Params)", 0, 10, tid=7),
              ev("kernel", "gemm", 5, 15, tid=7),
              ev("gpu_memcpy", "Memcpy HtoD", 30, 10, tid=8)]
    s = trace.summarize(events, 50e-6)
    assert s["window_s"] == pytest.approx(50e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["kernels"]["bag_kernel<true, 1>"] == (pytest.approx(10e-6), 1)
    assert trace.seconds_of(s["kernels"], r"\bbag_kernel\b")[1] == 1
    gaps = dict(s["idle_gaps"])
    assert gaps["host: cudaMemcpyAsync"] == pytest.approx(10e-6)
    assert gaps["host: Python between CUDA calls"] == pytest.approx(10e-6)
