"""Path-candidate enumeration (PyTorch port of ``differt_tpu.geometry._candidates``).

Candidate ``i`` is a mixed-radix counter with a first digit in base ``N``
and later digits in base ``N - 1``; each later digit ``c`` maps to the
primitive ``c + (c >= previous)`` (no two consecutive equal indices). The
chunk start is decoded with exact Python integers, so candidate spaces far
beyond ``2**31`` decode in chunks with no device integer overflowing.
"""

import torch


def count_path_candidates(num_primitives: int, order: int) -> int:
    """Exact number of loop-free path candidates, as a Python integer.

    >>> count_path_candidates(10, 2), count_path_candidates(10, 0)
    (90, 1)
    """
    if order < 0 or num_primitives <= 0:
        return 0
    if order == 0:
        return 1
    return num_primitives * (num_primitives - 1) ** (order - 1)


def _counter_digits(index: int, num_primitives: int, order: int) -> tuple[int, ...]:
    """Decode a flat candidate index into counter digits with exact host ints."""
    digits = []
    rem = index
    for t in range(order):
        weight = (num_primitives - 1) ** (order - 1 - t)
        if weight == 0:  # Degenerate N == 1 cases (at most one candidate).
            digits.append(0)
        else:
            digit, rem = divmod(rem, weight)
            digits.append(digit)
    return tuple(digits)


def _decode_range(
    start: int,
    size: int,
    num_primitives: int,
    order: int,
    *,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Decode candidates ``start .. start+size`` as an ``[size, order]`` int64 tensor.

    Rows come in the same order as the JAX package's decode.
    """
    if order == 0:
        return torch.zeros((size, 0), dtype=torch.int64, device=device)

    base = num_primitives - 1
    start_digits = _counter_digits(start, num_primitives, order)
    j = torch.arange(size, dtype=torch.int64, device=device)

    # Offset digits of j in the same mixed radix; digits whose weight
    # exceeds the chunk size are zero.
    offset_digits = []
    rem = j
    for t in range(order):
        weight = base ** (order - 1 - t) if base > 0 else 1
        if weight > size or weight == 0:
            offset_digits.append(torch.zeros_like(j))
        else:
            offset_digits.append(rem // weight)
            rem = rem % weight
    # Add start digits and offset digits with carry, least significant first.
    counters = [None] * order
    carry = torch.zeros_like(j)
    for t in reversed(range(order)):
        digit_base = num_primitives if t == 0 else base
        total = offset_digits[t] + start_digits[t] + carry
        counters[t] = total % digit_base
        carry = total // digit_base

    out = [counters[0]]
    for t in range(1, order):
        c = counters[t]
        out.append(c + (c >= out[-1]).to(torch.int64))
    return torch.stack(out, dim=-1)


def generate_path_candidates(
    num_primitives: int,
    order: int,
    *,
    start: int = 0,
    size: int | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Generate (a chunk of) all loop-free path candidates, on the card unless ``device`` says otherwise.

    >>> generate_path_candidates(3, 2, device="cpu").tolist()
    [[0, 1], [0, 2], [1, 0], [1, 2], [2, 0], [2, 1]]
    """
    if device is None:
        device = torch.device("cuda")
    total = count_path_candidates(num_primitives, order)
    if size is None:
        size = max(total - start, 0)
    return _decode_range(start, size, num_primitives, order, device=device)
