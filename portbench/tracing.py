"""The traced window: ``torch.profiler``'s device records reduced to what the per-layer metrics read.

The profiler records the device (kernels, copies, fills) and the CUDA
runtime calls of the host (launches, copies, synchronisations); it does
not record PyTorch's operators, whose cost would inflate the host's share
of a host-bound cell. A spin kernel of about :data:`LEAD_S` runs just
before the traced calls and a short one just after them: the first keeps
the card busy up to the first call (the profiler has been seen to lose
the records of a batch of launches that follows an idle card), and the
two mark the window on the device's clock. The window runs from the end
of the first to the start of the second.
"""

import bisect
import sys
import time

import torch

LEAD_S = 0.05  # s of spinning before the traced calls
SPIN_HZ = 1.755e9  # H100 SXM clock the spin's cycle count is reckoned at (its base clock)
PORT_KERNELS = ("trace_kernel", "compact_kernel", "anyhit_kernel", "closest_kernel")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
TOP = 10


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def reduce(device: list[tuple[str, float, float]], host: list[tuple[str, float, float]]) -> dict:
    """Reduce device records and host runtime calls, each ``(name, start_us, end_us)``.

    Returns ``None`` when either marker is missing. Otherwise ``window_s``,
    ``busy_s`` (the union of the device records inside the window),
    ``kernels`` (``name -> [records, seconds]``), ``host_launches`` (kernel
    launches the host made inside the window), ``device_ops`` and
    ``idle_gaps`` (the top of each, ``[name, seconds]``: the idle time
    grouped by the runtime call the host was in at the middle of each gap).
    """
    marks = sorted((r for r in device if "spin_kernel" in r[0]), key=lambda r: r[1])
    if len(marks) < 2:
        return None
    lo, hi = marks[0][2], marks[-1][1]
    inside = [
        (name, max(start, lo), min(end, hi))
        for name, start, end in device
        if "spin_kernel" not in name and end > lo and start < hi
    ]
    busy = _merge([(s, e) for _, s, e in inside])
    kernels: dict[str, list] = {}
    for name, s, e in inside:
        entry = kernels.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (e - s) * 1e-6
    calls = sorted((r for r in host if lo <= r[1] <= hi), key=lambda r: r[1])
    starts = [r[1] for r in calls]
    launches = sum(1 for name, _, _ in calls if name in LAUNCH_CALLS)
    gaps: dict[str, list] = {}
    edge = lo
    for s, e in [*busy, (hi, hi)]:
        if s > edge:
            mid = 0.5 * (edge + s)
            # The host's runtime calls come one after another: the one in
            # progress at ``mid`` is the last to start before it, if it has not ended.
            last = bisect.bisect_right(starts, mid) - 1
            label = calls[last][0] if last >= 0 and calls[last][2] >= mid else "host, between runtime calls"
            entry = gaps.setdefault(label, [0, 0.0])
            entry[0] += 1
            entry[1] += (s - edge) * 1e-6
        edge = max(edge, e)
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": kernels,
        "host_launches": launches,
        "device_ops": [[n[:160], v[1]] for n, v in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": [
            [f"{n} ({v[0]} gaps)", v[1]] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1][1])[:TOP]
        ],
    }


def capture(run_calls) -> dict | None:
    """Run ``run_calls()`` under the profiler between the two spin markers, and reduce its records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(LEAD_S * SPIN_HZ))
        start = time.perf_counter()
        run_calls()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    # Kineto's own events: building the profiler's FunctionEvent tree over
    # a hundred thousand launches takes minutes, and reads nothing more.
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
        (device if e.device_type() == DeviceType.CUDA else host).append(rec)
    out = reduce(device, host)
    marks = sum(1 for r in device if "spin_kernel" in r[0])
    print(
        f"profiler: {len(device)} device records ({marks} window markers), {len(host)} host records",
        file=sys.stderr,
    )
    if out is not None:
        out["host_wall_s"] = wall
    return out


def kept(trace: dict, kernel: str) -> tuple[int, float]:
    """Records kept of a port kernel (every instantiation) and their seconds."""
    count, seconds = 0, 0.0
    for name, (n, s) in trace["kernels"].items():
        if kernel in name:
            count += n
            seconds += s
    return count, seconds


def roofline_pct(trace: dict, kernel: str, counter: str) -> float | None:
    """A port kernel's bound over its time, in %: the time is the mean of the records
    kept times the launches made (the profiler may lose records)."""
    count, seconds = kept(trace, kernel)
    made = trace["counters"].get(counter, 0)
    bound = trace["bounds_s"].get(counter)
    if not count or not made or not bound:
        return None
    return 100.0 * bound / (seconds / count * made)


def idle_pct(trace: dict) -> float | None:
    """The share of the window in which no record of the device ran, in %."""
    if trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def other_ms_per_tile(trace: dict) -> float | None:
    """Device ms in records other than the port's own kernels, per ``trace.cu`` launch."""
    tiles = trace["counters"].get("trace", 0)
    if not tiles:
        return None
    seconds = sum(s for name, (_, s) in trace["kernels"].items() if not any(k in name for k in PORT_KERNELS))
    return 1e3 * seconds / tiles


def launches_per_tile(trace: dict) -> float | None:
    """Kernel launches the host made per ``trace.cu`` launch."""
    tiles = trace["counters"].get("trace", 0)
    if not tiles or not trace["host_launches"]:
        return None
    return trace["host_launches"] / tiles
