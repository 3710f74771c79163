"""The port's own spans (``differt_tpu_torch.profiling.spans``) reduced to what the span metrics read.

Spans are recorded while the profiler records, so after the traced window
:func:`read` gives the spans of the traced calls. A request is a span with
no parent (one ``power_map_chunked`` or ``streamed_placement_step`` call).
Each function returns None where the program has no such span, or no spans
at all (a program without them reads nothing, and raises nothing).
"""


def read() -> list[dict] | None:
    """The spans of the newest profiler session, or None where there are none."""
    from differt_tpu_torch import profiling

    spans = getattr(profiling, "spans", None)
    return (spans() or None) if spans is not None else None


def total_ms(spans: list[dict], name: str, key: str = "device_ms") -> float | None:
    """The sum of ``key`` over the spans named ``name``; None if there is none or one lacks it."""
    values = [s[key] for s in spans if s["name"] == name]
    if not values or any(v is None for v in values):
        return None
    return sum(values)


def per_request_ms(name: str, key: str = "device_ms") -> float | None:
    """Sum of ``key`` over the spans named ``name``, over the requests."""
    spans = read()
    if spans is None:
        return None
    total = total_ms(spans, name, key)
    requests = sum(1 for s in spans if s["parent"] is None)
    return None if total is None or not requests else total / requests


def per_launch_ms(trace: dict, total) -> float | None:
    """``total(spans)`` in ms over the window's ``trace.cu`` launches."""
    spans = read()
    launches = trace["counters"].get("trace", 0)
    if spans is None or not launches:
        return None
    value = total(spans)
    return None if value is None else value / launches


def roofline_pct(trace: dict, name: str, counter: str) -> float | None:
    """A kernel's bounds over the device time of its launches' spans, in %."""
    spans = read()
    bound = trace["bounds_s"].get(counter)
    if spans is None or not bound:
        return None
    total = total_ms(spans, name)
    return None if not total else 100.0 * bound / (total * 1e-3)


def glue_ms(spans: list[dict], inner: tuple[str, ...] = ("em", "kernel.trace")) -> float | None:
    """Device ms of the ``tile`` spans less that of their ``inner`` descendants."""
    tiles = [i for i, s in enumerate(spans) if s["name"] == "tile"]
    if not tiles or any(spans[i]["device_ms"] is None for i in tiles):
        return None
    total = sum(spans[i]["device_ms"] for i in tiles)
    for s in spans:
        if s["name"] not in inner:
            continue
        parent = s["parent"]
        while parent is not None and spans[parent]["name"] != "tile":
            parent = spans[parent]["parent"]
        if parent is not None:
            if s["device_ms"] is None:
                return None
            total -= s["device_ms"]
    return total
