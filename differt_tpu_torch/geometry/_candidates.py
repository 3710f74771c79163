"""Path-candidate enumeration (PyTorch port of ``differt_tpu.geometry._candidates``).

Candidate ``i`` is a mixed-radix counter with a first digit in base ``N``
and later digits in base ``N - 1``; each later digit ``c`` maps to the
primitive ``c + (c >= previous)`` (no two consecutive equal indices). The
chunk start is decoded with exact Python integers, so candidate spaces far
beyond ``2**31`` decode in chunks with no device integer overflowing.

:func:`generate_filtered_path_candidates` keeps the candidates a predicate
accepts, decoding the space a chunk at a time: the plain fallback of the
host DFS in :mod:`differt_tpu_torch.native`, which never visits a pruned
branch.
"""

import warnings
from collections.abc import Callable, Iterator, Sized
from typing import TypeVar

import torch

_T = TypeVar("_T")


class SizedIterator(Iterator[_T], Sized):
    """An iterator that knows its length.

    >>> it = SizedIterator(iter("ab"), size=2)
    >>> len(it), list(it)
    (2, ['a', 'b'])
    """

    __slots__ = ("_iter", "_size")

    def __init__(self, iter: Iterator[_T], size: int | Callable[[], int]) -> None:  # noqa: A002
        self._iter = iter
        self._size = size

    def __iter__(self) -> "SizedIterator[_T]":
        return self

    def __next__(self) -> _T:
        return next(self._iter)

    def __len__(self) -> int:
        return self._size if isinstance(self._size, int) else self._size()


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


def generate_all_path_candidates(
    num_primitives: int, order: int, *, device: torch.device | str | None = None
) -> torch.Tensor:
    """All ``[C, order]`` candidates at once, on the card unless ``device`` says otherwise.

    >>> generate_all_path_candidates(3, 2, device="cpu").tolist()
    [[0, 1], [0, 2], [1, 0], [1, 2], [2, 0], [2, 1]]
    """
    return generate_path_candidates(num_primitives, order, device=device)


def generate_all_path_candidates_iter(
    num_primitives: int, order: int, *, device: torch.device | str | None = None
) -> SizedIterator[torch.Tensor]:
    """The candidates one by one (``[order]`` each), decoded 4,096 at a time.

    >>> [c.tolist() for c in generate_all_path_candidates_iter(3, 2, device="cpu")][:2]
    [[0, 1], [0, 2]]
    """
    chunks = generate_all_path_candidates_chunks_iter(num_primitives, order, 4096, device=device)
    rows = (row for chunk in chunks for row in chunk)
    return SizedIterator(rows, size=count_path_candidates(num_primitives, order))


def generate_all_path_candidates_chunks_iter(
    num_primitives: int,
    order: int,
    chunk_size: int = 1000,
    *,
    device: torch.device | str | None = None,
) -> SizedIterator[torch.Tensor]:
    """The candidates in ``[chunk_size, order]`` chunks (the last may be shorter).

    >>> [c.shape[0] for c in generate_all_path_candidates_chunks_iter(4, 2, 5, device="cpu")]
    [5, 5, 2]
    """
    total = count_path_candidates(num_primitives, order)
    num_chunks = -(-total // chunk_size) if total else 0

    def gen() -> Iterator[torch.Tensor]:
        for start in range(0, total, chunk_size):
            yield generate_path_candidates(
                num_primitives, order, start=start, size=min(chunk_size, total - start), device=device
            )

    return SizedIterator(gen(), size=num_chunks)


def generate_filtered_path_candidates(
    num_primitives: int,
    order: int,
    predicate: Callable[[torch.Tensor], torch.Tensor],
    *,
    chunk_size: int = 1 << 20,
    warn_above: int = 1 << 30,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """The candidates that ``predicate(chunk) -> bool [size]`` keeps, without the whole space.

    The ``N (N - 1)^(order - 1)`` candidates are decoded ``chunk_size`` at
    a time on ``device`` (the card when None) and filtered there: memory is
    one chunk plus the kept rows. Warns when the space holds more than
    ``warn_above`` candidates (minutes of work); the DFS of
    :func:`differt_tpu_torch.native.filtered_path_candidates` visits only
    the branches it keeps.

    >>> generate_filtered_path_candidates(3, 2, lambda c: c[:, 0] == 1, device="cpu").tolist()
    [[1, 0], [1, 2]]
    """
    total = count_path_candidates(num_primitives, order)
    if total > warn_above:
        warnings.warn(
            f"Filtering {total:.3g} path candidates by exhaustive chunked enumeration;"
            " this may take minutes. The native DFS (differt_tpu_torch.native) never"
            " visits pruned branches; or reduce the candidate space with masks.",
            stacklevel=2,
        )
    parts = [
        chunk[predicate(chunk)]
        for chunk in generate_all_path_candidates_chunks_iter(
            num_primitives, order, chunk_size, device=device
        )
    ]
    if not parts:
        return torch.zeros(
            (0, max(order, 0)), dtype=torch.int64, device=torch.device("cuda") if device is None else device
        )
    return torch.cat(parts)
