"""Timing and profiling (PyTorch port of ``differt_tpu.profiling``).

:func:`timeit` times a nullary function with warm-up runs, each run ending
in :func:`synchronize` of what it returned; :func:`trace` records a
``torch.profiler`` trace (CPU, and CUDA where there is a card) as a Chrome
trace file; :func:`annotate` names a region inside one.
"""

import contextlib
import os
import time
from collections.abc import Callable, Iterator
from typing import Any

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _tensors(item)
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _tensors(item)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def synchronize(tree: Any) -> Any:
    """Wait for the work on every card that holds a tensor of ``tree``; returns ``tree``.

    Tensors, tuples, lists, dicts and dataclasses are walked; a tree with
    no CUDA tensor returns at once.

    >>> import torch
    >>> x = torch.ones(3)
    >>> synchronize((x, {"y": None}))[0] is x
    True
    """
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


def timeit(fn: Callable[[], Any], *, repeats: int = 5, warmup: int = 1) -> dict[str, float]:
    """Wall-clock seconds of ``fn()`` over ``repeats`` runs after ``warmup`` runs: min, mean, max.

    Each run ends when :func:`synchronize` of its result returns.

    >>> import torch
    >>> stats = timeit(lambda: torch.ones(8).sum(), repeats=2)
    >>> sorted(stats)
    ['max', 'mean', 'min', 'repeats']
    """
    for _ in range(warmup):
        synchronize(fn())
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        synchronize(fn())
        times.append(time.perf_counter() - start)
    return {
        "min": min(times),
        "mean": sum(times) / len(times),
        "max": max(times),
        "repeats": float(repeats),
    }


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the block into ``log_dir`` (a Chrome trace, for Perfetto).

    CPU activity always, CUDA activity where a card is present. Yields the
    profiler, whose ``key_averages()`` summarize the block.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


annotate = torch.profiler.record_function
"""Name a region inside a profiler trace (``torch.profiler.record_function``)."""
