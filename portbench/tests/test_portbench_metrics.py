"""The yardstick's arithmetic on synthetic records: intervals, idle share, bounds, percentiles, readers."""

import statistics

import pytest

from portbench import bounds, harness, tracing

SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_merge_joins_overlaps_and_touches():
    got = tracing._merge([(5, 7), (0, 2), (1, 3), (3, 4), (10, 11)])
    assert got == [(0, 4), (5, 7), (10, 11)]


def test_reduce_window_busy_gaps_and_launches():
    device = [
        (SPIN, 0.0, 10.0),
        ("void trace_kernel<2>(...)", 12.0, 20.0),
        ("elementwise", 18.0, 25.0),
        ("elementwise", 40.0, 50.0),
        (SPIN, 60.0, 61.0),
        ("after the window", 70.0, 80.0),
    ]
    host = [("cudaLaunchKernel", 11.0, 12.0), ("cudaMemcpyAsync", 26.0, 45.0), ("cudaLaunchKernel", 39.0, 40.0)]
    out = tracing.reduce(device, host)
    assert out["window_s"] == pytest.approx(50e-6)
    assert out["busy_s"] == pytest.approx(23e-6)  # 12-25 and 40-50
    assert out["host_launches"] == 2
    assert out["kernels"]["elementwise"] == [2, pytest.approx(17e-6)]
    gaps = dict(out["idle_gaps"])
    assert gaps["cudaMemcpyAsync (1 gaps)"] == pytest.approx(15e-6)
    assert gaps["host, between runtime calls (1 gaps)"] == pytest.approx(10e-6)
    assert gaps["cudaLaunchKernel (1 gaps)"] == pytest.approx(2e-6)
    assert tracing.idle_pct({**out}) == pytest.approx(100.0 * (1 - 23 / 50))


def test_reduce_without_markers_reads_nothing():
    assert tracing.reduce([("k", 0.0, 1.0)], []) is None


@pytest.mark.parametrize(
    ("ms", "args"),
    [
        (0.00804, (1, 4096, 128, 2, 20_738)),  # PERF.md §6 row (d): coverage chunk, order 2
        (0.00903, (1, 4096, 128, 2, 112_898)),  # row (l): the XL chunk
        (0.12294, (16, 256, 2048, 2, 20_738)),  # row (f): gradient tile, order 2
    ],
)
def test_trace_bound_matches_the_kernel_table(ms, args):
    assert bounds.trace_launch_s(*args) * 1e3 == pytest.approx(ms, abs=5e-6)


def test_closest_bound_matches_the_visibility_row():
    assert bounds.closest_launch_s(1_000_000, 20_738) * 1e3 == pytest.approx(0.00978, abs=5e-6)


def test_roofline_uses_the_launches_made():
    trace = {
        "kernels": {"void trace_kernel<2>(a)": [3, 3e-3], "void trace_kernel<1>(b)": [1, 1e-3], "x": [5, 1.0]},
        "counters": {"trace": 8},
        "bounds_s": {"trace": 4e-3},
    }
    # 4 records kept of 8 made, 1 ms each: 8 ms for a bound of 4 ms.
    assert tracing.roofline_pct(trace, "trace_kernel", "trace") == pytest.approx(50.0)
    assert tracing.roofline_pct({**trace, "counters": {"trace": 0}}, "trace_kernel", "trace") is None
    assert tracing.other_ms_per_tile(trace) == pytest.approx(1e3 / 8)


def test_readers_return_nothing_when_nothing_was_made():
    trace = {"kernels": {}, "counters": {}, "bounds_s": {}, "host_launches": 0, "window_s": 1.0, "busy_s": 0.5}
    for name in ("trace_roofline.map", "closest_roofline.map", "em.device_ms_per_tile.step", "tile.launches.map"):
        assert harness.metric_reader(name)(trace) is None
    assert harness.metric_reader("device.idle_pct.map")(trace) == pytest.approx(50.0)


@pytest.mark.parametrize("n", [2, 11, 110, 123])
def test_percentile_over_every_map(n):
    values = [0.3 + ((7 * i) % n) / n for i in range(n)]
    assert harness.quantile(values, 90) == statistics.quantiles(values, n=100, method="inclusive")[89]
    assert min(values) <= harness.quantile(values, 90) <= max(values)
