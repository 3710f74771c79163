"""One run of one cell: set-up, the measured (or traced) window, the comparison, the result line.

Everything that belongs to a cell is found by name: its entry in
``BENCHMARK.json`` names the configuration (``portbench/configs/<config>.json``,
whose ``scene`` names its builder in ``portbench/inputs/scenes/``) and the
traffic (``portbench/traffic/<traffic>.json``, whose ``entry`` names the
module that drives the port, ``portbench/entries/<entry>.py``); its limits
are ``portbench/limits/<workload>.json``; each metric, end-to-end or per
layer, is read by ``portbench/metrics/<metric>.py`` (see :func:`metric_reader`).
"""

import importlib
import importlib.util
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

import torch

from . import tracing

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "differt_tpu")  # top-level module names, compared whole


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(workload: str) -> dict:
    """The cell's entry, configuration, traffic and limits, and the metrics it reports."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        msg = f"no workload named {workload!r} in BENCHMARK.json"
        raise SystemExit(msg)
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def reports(metric: dict) -> bool:
        return workload in metric.get("workloads", [w["name"] for w in spec["workloads"]])

    end_to_end = [m for m in spec["end_to_end"] if reports(m)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"] if reports(m) and m["moves"] in names]
    return {
        "cell": cell,
        "config": load_json(ROOT / config["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": end_to_end,
        "per_layer": per_layer,
    }


def make_entry(files: dict, device):
    """``portbench/entries/<entry>.py``'s ``Entry``, on the cell's configuration and traffic."""
    module = importlib.import_module(f"portbench.entries.{files['traffic']['entry']}")
    return module.Entry(files["config"], files["traffic"], device)


def metric_reader(name: str):
    """The ``read`` of ``portbench/metrics/<name>.py``, or, where there is none, of the
    file named without the last dotted part (``device.idle_pct.py`` reads
    ``device.idle_pct.map`` and ``device.idle_pct.step``).

    An end-to-end metric's ``read(window)`` takes the dict of :func:`run`'s
    window (``walls``, ``wall_s``, ``calls``, ``setup_s``); a per-layer
    metric's ``read(trace) -> float | None`` takes the reduced trace
    (:func:`portbench.tracing.reduce`, with the counters, the kernels'
    bounds, the peak and the calls); ``None`` leaves the metric out.
    """
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def counters() -> dict:
    """The port's own counts: kernel launches, plain (reference) calls, BVH builds."""
    from differt_tpu_torch.ops import _bvh, _closest, _rt, _trace

    return {
        "trace": _trace.LAUNCHES,
        "anyhit": _rt.LAUNCHES,
        "closest": _closest.LAUNCHES,
        "plain_calls": _trace.REFERENCE_CALLS + _rt.REFERENCE_CALLS + _closest.REFERENCE_CALLS,
        "bvh_builds": _bvh.BUILDS,
    }


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def per_call_s(window: dict) -> float:
    """The window's wall time over the calls it completed."""
    return window["wall_s"] / window["calls"]


def quantile(values: list[float], q: int) -> float:
    """The ``q``-th percentile: ``statistics.quantiles(values, n=100)``, inclusive of the ends."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(entry, seconds: float, first: int, device):
    """Whole calls back to back until ``seconds`` have passed; each ends in a synchronise."""
    outputs, walls, failed = [], [], 0
    i = first
    synchronize(device)
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            out = entry.call(i)
            synchronize(device)
            if not entry.finite(out):
                failed += 1
        except Exception:  # noqa: BLE001  a failed call is counted and the window goes on
            traceback.print_exc()
            failed += 1
            out = None
        t1 = time.perf_counter()
        outputs.append(out)
        walls.append(t1 - t0)
        i += 1
        if t1 - start >= seconds:
            return outputs, walls, failed, t1 - start


def run(workload: str, seed: int, seconds: float, trace: bool, started: float, *, device=None, files=None):
    """One run; returns ``(result, checks)`` (the result is None when the run prints none).

    ``device`` and ``files`` (:func:`cell_files`) are for tests on the CPU,
    where the port runs its plain versions; the benchmark's runs leave them
    to the card and to ``BENCHMARK.json``.
    """
    files = cell_files(workload) if files is None else files
    device = torch.device("cuda", 0) if device is None else device
    on_card = device.type == "cuda"
    limits = files["limits"]
    entry = make_entry(files, device)
    entry.setup(seed)
    entry.warm()
    synchronize(device)
    setup_s = time.perf_counter() - started

    before = counters()
    first = len(getattr(entry, "history", []))
    metrics, device_info, breakdown = {}, {}, None
    if trace:
        calls = files["traffic"]["traced_calls"]
        outputs = []
        torch.cuda.reset_peak_memory_stats(device)

        def traced():
            for i in range(first, first + calls):
                outputs.append(entry.call(i))

        reduced = tracing.capture(traced)
        if reduced is None:
            print("the profiler kept no window markers: the trace cannot be read", file=sys.stderr)
            return None, None
        failed = sum(0 if entry.finite(o) else 1 for o in outputs)
        attempted = calls
        after = counters()
        reduced["counters"] = {k: after[k] - before[k] for k in after}
        reduced["bounds_s"] = entry.bounds_s(calls)
        reduced["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        reduced["calls"] = calls
        kept = {k: tracing.kept(reduced, name)[0] for k, name in (("trace", "trace_kernel"), ("closest", "closest_kernel"), ("anyhit", "anyhit_kernel"))}
        print(
            f"traced {calls} {entry.unit}(s): records kept of launches made "
            + ", ".join(f"{k} {kept[k]} of {reduced['counters'][k]}" for k in kept)
            + f"; host launches {reduced['host_launches']}; window {reduced['window_s']:.4f} s,"
            f" host wall {reduced['host_wall_s']:.4f} s, busy {reduced['busy_s']:.4f} s",
            file=sys.stderr,
        )
        for m in files["per_layer"]:
            value = metric_reader(m["name"])(reduced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": reduced["busy_s"], "window_s": reduced["window_s"]}
        breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    else:
        outputs, walls, failed, wall = window(entry, seconds, first, device)
        attempted = len(outputs)
        after = counters()
        measured = {"walls": walls, "wall_s": wall, "calls": attempted, "setup_s": setup_s}
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": metric_reader(m["name"])(measured), "unit": m["unit"]}
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    in_window = {k: after[k] - before[k] for k in after}

    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return None, None

    # The comparison, once the window has closed and the peak was read.
    checks = {
        "plain_calls": (in_window["plain_calls"], limits["plain_calls"]),
        "bvh_builds": (in_window["bvh_builds"], limits["bvh_builds"]),
        "failed": (failed, 0),
    }
    done = [o for o in outputs if o is not None]
    if len(done) == len(outputs):
        numbers = entry.compare(outputs)
        for name, limit in limits["compare"].items():
            checks[name] = (numbers[name], limit)
    else:
        checks["calls_that_raised"] = (len(outputs) - len(done), 0)
    correct = all(value <= limit for value, limit in checks.values())

    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": files["cell"]["chips"],
            "memory_peak_bytes": memory_peak,
            **device_info,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result, checks
