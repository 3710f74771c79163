"""Timing, profiling and the port's spans (PyTorch port of ``differt_tpu.profiling``).

:func:`timeit` times a nullary function with warm-up runs, each run ending
in :func:`synchronize` of what it returned; :func:`trace` records a
``torch.profiler`` trace (CPU, and CUDA where there is a card) as a Chrome
trace file; :func:`annotate` opens a span, the port's own timing of a
region inside a profiler session, and :func:`spans` reads them back.

Spans are on only while a ``torch.profiler`` session records (any set of
activities): then :func:`annotate` enters ``torch.profiler.record_function``
(so the region shows in the Chrome trace and in ``key_averages()``), stamps
its host start and end with ``time.time_ns()``, the clock of Kineto's
events, so that a span sits on the profiler's own timeline, and, where CUDA
is initialised, records a ``torch.cuda.Event`` on the current stream at
each end. Otherwise it returns one shared no-op that reads no clock and
records no event. Spans stay in memory; :func:`spans` returns those of the
newest session: from the first span recorded after :func:`annotate` or
:func:`spans` ran with the profiler off, or after :func:`clear_spans`.

The port's spans, where they open, and the benchmark metric that reads
each (``portbench/metrics/``; moving or renaming a span leaves its metric
empty):

=================  ==================================================  ==========================================
Span               Where                                               Read by
=================  ==================================================  ==========================================
``coverage.map``   ``coverage.power_map_chunked`` (a request)          every ``*.map`` span metric (per request)
``step``           ``parallel.streamed_placement_step`` (a request)    every ``*.step`` span metric (per request)
``step.pass1``     its pass 1, the forward tiles without a graph       ``pass1.device_ms.step``
``step.pass3``     its pass 3, each tile again and its backward        (parent of pass 3's spans)
``step.backward``  each ``torch.autograd.grad`` of pass 3              ``backward.device_ms.step``
``tile.prep``      ``coverage._tile_plan``: a candidate set's layout   ``tile.prep_reuse`` (fused tiles per plan)
                   for its tiles' kernels, once per set and call
``tile``           ``coverage._coverage_tile``, every tile             ``tile.glue_ms_per_tile``
``em``             ``coverage.complex_amplitudes``; a planned tile's   ``em.span_ms_per_tile``, ``tile.glue_*``
                   EM kernel call in its ``tile``
``kernel.em``      ``ops/_em.py::em_laid_out``, the launch alone       ``em.fused_pct`` (tiles that hold one)
``kernel.trace``   ``ops/_trace.py::launch_trace``, the launch alone   ``trace.span_roofline``, ``tile.glue_*``
``kernel.closest`` ``ops/_closest.py::launch_closest``, the launch     ``closest.span_roofline.map``
``visibility``     ``rt/_solvers.py::HybridPathTracer._visibility``    ``visibility.device_ms.map``
``dfs``            ``native.filtered_path_candidates``, from the        ``dfs.host_ms.map``
                   masks on the host to the rows on the device
=================  ==================================================  ==========================================
"""

import contextlib
import os
import threading
import time
from collections.abc import Callable, Iterator
from typing import Any

import torch
from torch.autograd import profiler as _autograd_profiler


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


_LOCK = threading.Lock()
_SPANS: list[list] = []  # [name, parent, root, thread, t0_ns, t1_ns, events, device_ms] per span
_STACKS = threading.local()  # each thread's open spans, as (session, index)
_session = 0  # which list the indices of _SPANS belong to
_new_session = True  # the next span recorded starts a new list


class _NoSpan:
    """What :func:`annotate` returns while no profiler records: one shared instance that does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("function", "name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        global _new_session, _session
        stack = getattr(_STACKS, "open", None)
        if stack is None:
            stack = _STACKS.open = []
        t0 = time.time_ns()
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        with _LOCK:
            if _new_session:
                _SPANS.clear()
                _session += 1
                _new_session = False
            index = len(_SPANS)
            # A span still open from an older session is no parent.
            parent = stack[-1][1] if stack and stack[-1][0] == _session else None
            root = index if parent is None else _SPANS[parent][2]
            self.record = [self.name, parent, root, threading.get_ident(), t0, None, events, None]
            _SPANS.append(self.record)
        stack.append((_session, index))

    def __exit__(self, *exc) -> None:
        events = self.record[6]
        if events is not None:
            events[1].record()
        self.function.__exit__(*exc)
        self.record[5] = time.time_ns()
        _STACKS.open.pop()


def annotate(name: str) -> contextlib.AbstractContextManager:
    """A span named ``name``, for ``with annotate(name):``; a shared no-op while no profiler records.

    >>> import torch
    >>> with annotate("region"):
    ...     pass
    >>> annotate("region") is annotate("other")
    True
    """
    global _new_session
    if not _autograd_profiler._is_profiler_enabled:
        _new_session = True
        return _NO_SPAN
    return _Span(name)


def spans() -> list[dict]:
    """The spans of the newest profiler session, in the order they opened.

    Each is a dict: ``name``; ``parent`` (the index of the innermost span
    of its thread open around it, or None); ``root`` (the index of its
    request, the span of its thread with no parent: its own index for a
    request); ``thread``; ``start_ns`` and ``end_ns`` (``time.time_ns()``,
    Kineto's clock; ``end_ns`` None while open); ``host_ms``; and
    ``device_ms``, the CUDA events' elapsed time on the stream that was
    current at its start (None without events or while open). Reading does
    not consume the list; the first read synchronises the device once.
    """
    global _new_session
    with _LOCK:
        records = list(_SPANS)
        if not _autograd_profiler._is_profiler_enabled:  # read after its session: the next span starts anew
            _new_session = True
    pending = [r for r in records if r[6] is not None and r[5] is not None and r[7] is None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r[7] = r[6][0].elapsed_time(r[6][1])
    return [
        {
            "name": name,
            "parent": parent,
            "root": root,
            "thread": thread,
            "start_ns": t0,
            "end_ns": t1,
            "host_ms": None if t1 is None else (t1 - t0) * 1e-6,
            "device_ms": device_ms,
        }
        for name, parent, root, thread, t0, t1, _, device_ms in records
    ]


def clear_spans() -> None:
    """Forget every recorded span; the next span recorded starts a new session."""
    global _new_session
    with _LOCK:
        _SPANS.clear()
        _new_session = True
