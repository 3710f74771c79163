"""Path candidates: the mixed-radix decode and the benchmark's candidate sets (frozen).

:func:`decode_range` is a copy of
``differt_tpu_torch/geometry/_candidates.py::_decode_range`` (with
``_counter_digits``) as of commit ``d3b5058``: candidate ``i`` is a counter
whose first digit is in base ``N`` and later digits in base ``N - 1``, a
later digit ``c`` naming the primitive ``c + (c >= previous)``. The start
is decoded with exact Python integers, so ranges beyond ``2**31`` rows
decode on the device with no overflow. The sets below are chosen from
geometry and the seed alone, never by tracing.
"""

import torch


def count(num_primitives: int, order: int) -> int:
    """The number of loop-free candidates, ``N (N - 1)^(order - 1)``."""
    if order == 0:
        return 1
    return num_primitives * (num_primitives - 1) ** (order - 1)


def _counter_digits(index: int, num_primitives: int, order: int) -> tuple[int, ...]:
    digits, rem = [], index
    for t in range(order):
        weight = (num_primitives - 1) ** (order - 1 - t)
        if weight == 0:
            digits.append(0)
        else:
            digit, rem = divmod(rem, weight)
            digits.append(digit)
    return tuple(digits)


def decode_range(start: int, size: int, num_primitives: int, order: int, device) -> torch.Tensor:
    """Rows ``start .. start + size`` of the decode, ``[size, order]`` int64."""
    if order == 0:
        return torch.zeros((size, 0), dtype=torch.int64, device=device)
    base = num_primitives - 1
    start_digits = _counter_digits(start, num_primitives, order)
    j = torch.arange(size, dtype=torch.int64, device=device)
    offset_digits, rem = [], j
    for t in range(order):
        weight = base ** (order - 1 - t) if base > 0 else 1
        if weight > size or weight == 0:
            offset_digits.append(torch.zeros_like(j))
        else:
            offset_digits.append(rem // weight)
            rem = rem % weight
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


def decode_rows(rows: torch.Tensor, num_primitives: int, order: int) -> torch.Tensor:
    """The rows at the int64 indices ``rows`` (each below ``count``), ``[len(rows), order]``.

    The same mixed radix as :func:`decode_range`, digit by digit, for rows
    that are not consecutive.
    """
    base = num_primitives - 1
    digits, rem = [], rows
    for t in range(order):
        weight = base ** (order - 1 - t)
        digits.append(rem // weight)
        rem = rem % weight
    out = digits[:1]
    for c in digits[1:]:
        out.append(c + (c >= out[-1]).to(torch.int64))
    return torch.stack(out, dim=-1)


def strided(num_primitives: int, order: int, size: int, offset: int, device, group: int = 8) -> torch.Tensor:
    """``size`` rows in groups of ``group`` spread evenly over the whole decode, shifted by ``offset``.

    Group ``g`` starts at row ``g * step + offset`` (``step`` = rows / groups),
    ``offset`` taken modulo ``step - group + 1`` so that no group runs past
    its stride.
    """
    total = count(num_primitives, order)
    groups = max(size // group, 1)
    step = max(total // groups, 1)
    offset %= max(step - group + 1, 1)
    starts = torch.arange(groups, dtype=torch.int64, device=device) * step + offset
    starts = torch.clamp(starts, max=total - group)
    rows = (starts[:, None] + torch.arange(group, dtype=torch.int64, device=device)).reshape(-1)
    return decode_rows(rows, num_primitives, order)[:size]


def near_pairs(triangle_vertices: torch.Tensor, num_ground: int, tx, pool: int) -> torch.Tensor:
    """Every ordered pair of distinct primitives among the ``pool`` triangles
    whose centroids lie nearest ``tx`` in plan and the ground's (the last
    ``num_ground``), ``[(pool + num_ground)^2 - (pool + num_ground), 2]``."""
    num = triangle_vertices.shape[0]
    device = triangle_vertices.device
    tx = torch.as_tensor(tx, dtype=torch.float32, device=device)
    dist = (triangle_vertices[: num - num_ground].mean(dim=1)[:, :2] - tx[:2]).norm(dim=-1)
    nearest = torch.argsort(dist, stable=True)[:pool]
    picked = torch.cat((nearest, torch.arange(num - num_ground, num, device=device)))
    pairs = torch.cartesian_prod(picked, picked)
    return pairs[pairs[:, 0] != pairs[:, 1]]


def block_start(block_x: int, block_y: int, num_blocks_y: int, triangles_per_block: int, num_primitives: int) -> int:
    """The first order-2 row whose first bounce is on block ``(block_x, block_y)`` of the city."""
    return triangles_per_block * (block_x * num_blocks_y + block_y) * (num_primitives - 1)
