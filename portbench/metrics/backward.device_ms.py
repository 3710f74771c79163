"""Device ms a step of pass 3's backward (the ``step.backward`` spans, each ``torch.autograd.grad``): the EM
chain's backward and the trace's recompute."""

from portbench.spans import per_request_ms


def read(trace: dict) -> float | None:
    return per_request_ms("step.backward")
