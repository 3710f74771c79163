"""Traced and launched path containers (PyTorch port of ``differt_tpu.geometry._paths``).

Paths keep full, fixed batch shapes plus validity masks: invalid paths are
masked, never dropped. A traced path's mask is boolean, or with the
smoothed checks a float confidence that :attr:`TracedPaths.valid_mask`
holds against a threshold.

Row grouping (:func:`merge_cell_ids`, :meth:`TracedPaths.group_by_objects`,
:meth:`TracedPaths.multipath_cells`, :meth:`TracedPaths.mask_duplicate_objects`)
rests on :func:`_group_index`: each row's id is the index of the first row
equal to it, the JAX package's numbering.
"""

import dataclasses
import warnings
from collections.abc import Callable, Iterator, Sequence
from typing import Any

import torch


def _group_index(rows: torch.Tensor) -> torch.Tensor:
    """``[num_rows]`` int64: the index of the first row of ``[num_rows, n]`` equal to each row.

    Equal rows share the value, so it doubles as a group id. One sort
    (``torch.unique`` over rows) and a scatter-min of positions, where the
    JAX package compares tiles of rows against all rows.

    >>> _group_index(torch.tensor([[1, 2], [3, 4], [1, 2]])).tolist()
    [0, 1, 0]
    """
    num_rows = rows.shape[0]
    if num_rows == 0:
        return torch.zeros((0,), dtype=torch.int64, device=rows.device)
    if rows.dtype == torch.bool:
        rows = rows.to(torch.uint8)
    _, inverse = torch.unique(rows, dim=0, return_inverse=True)
    first = torch.full((num_rows,), num_rows, dtype=torch.int64, device=rows.device)
    first = first.scatter_reduce(0, inverse, torch.arange(num_rows, device=rows.device), "amin")
    return first[inverse]


def merge_cell_ids(cell_ids_a, cell_ids_b) -> torch.Tensor:
    """Combine two cell-id tensors (broadcast together): two entries share an id iff they share both.

    The ids are fresh group ids (each the flat index of its group's first
    entry), unrelated to either input's numbering.

    >>> merge_cell_ids(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 1, 0, 0])).tolist()
    [0, 1, 2, 2]
    """
    a, b = torch.broadcast_tensors(torch.as_tensor(cell_ids_a), torch.as_tensor(cell_ids_b))
    pairs = torch.stack((a, b.to(a.device)), dim=-1)
    return _group_index(pairs.reshape(-1, 2)).reshape(pairs.shape[:-1])


def _batch_axis(axis: int, ndim: int) -> int:
    resolved = axis + ndim if axis < 0 else axis
    if not 0 <= resolved < ndim:
        msg = f"Axis {axis} is out-of-bounds for a {ndim}-dimensional batch."
        raise ValueError(msg)
    return resolved


@dataclasses.dataclass(frozen=True)
class TracedPaths:
    """Paths produced by exact tracing."""

    vertices: torch.Tensor
    """``[*batch, path_length, 3]`` path vertex coordinates."""
    objects: torch.Tensor
    """``[*batch, path_length]`` object index per vertex (TX and RX indices at the ends)."""
    mask: torch.Tensor
    """``[*batch]`` bool validity mask, or float confidence held against :attr:`confidence_threshold`."""
    interaction_types: torch.Tensor
    """``[*batch, path_length - 2]`` per-bounce interaction types."""
    confidence_threshold: float | torch.Tensor = 0.5
    """Confidence from which a path with a float mask counts as valid."""

    @property
    def shape(self) -> tuple[int, ...]:
        """Batch shape."""
        return tuple(self.vertices.shape[:-2])

    @property
    def path_length(self) -> int:
        return self.objects.shape[-1]

    @property
    def order(self) -> int:
        """Number of interactions per path."""
        return self.path_length - 2

    @property
    def valid_mask(self) -> torch.Tensor:
        """``[*batch]`` bool validity mask (a confidence resolved by the threshold)."""
        if self.mask.dtype == torch.bool:
            return self.mask
        return self.mask >= self.confidence_threshold

    @property
    def num_valid_paths(self) -> int:
        return int(torch.count_nonzero(self.valid_mask))

    _TRAILING = (("vertices", 2), ("objects", 1), ("mask", 0), ("interaction_types", 1))

    def _remap(self, fn) -> "TracedPaths":
        # fn(array, number of per-path trailing dimensions) -> array
        return dataclasses.replace(
            self, **{name: fn(getattr(self, name), nd) for name, nd in self._TRAILING}
        )

    def reshape(self, *batch: int) -> "TracedPaths":
        """Reshape the batch dimensions (``-1`` wildcards allowed)."""
        target = self.mask.reshape(*batch).shape
        return self._remap(lambda x, nd: x.reshape(*target, *x.shape[x.ndim - nd :]))

    def mask_duplicate_objects(self, axis: int = -1) -> "TracedPaths":
        """Mask the paths whose object sequence repeats an earlier one along the batch ``axis``.

        The first of each sequence keeps its mask; the batch shape is kept.

        >>> paths = TracedPaths(
        ...     torch.zeros((3, 3, 3)), torch.tensor([[0, 1, 0], [0, 2, 0], [0, 1, 0]]),
        ...     mask=torch.ones(3, dtype=torch.bool), interaction_types=torch.zeros((3, 1), dtype=torch.int32),
        ... )
        >>> paths.mask_duplicate_objects().mask.tolist()
        [True, True, False]
        """
        resolved = _batch_axis(axis, self.objects.ndim - 1)
        sequences = torch.movedim(self.objects, resolved, -2)
        *lead, axis_len, path_len = sequences.shape
        groups = sequences.reshape(-1, axis_len, path_len)
        # One grouping for all: each row tagged with the index of its group.
        tag = torch.arange(groups.shape[0], device=groups.device)[:, None, None].expand(-1, axis_len, 1)
        first = _group_index(torch.cat((tag, groups), dim=-1).reshape(-1, path_len + 1))
        keep = first == torch.arange(first.shape[0], device=first.device)
        keep = torch.movedim(keep.reshape(*lead, axis_len), -1, resolved)
        return dataclasses.replace(self, mask=self.mask * keep)

    def multipath_cells(self, axis: int = -1) -> torch.Tensor:
        """Group the batch entries that share the same pattern of valid paths along ``axis``.

        The entries with the same set of valid candidates get the same cell
        id: the multipath cells behind multipath lifetime maps.
        """
        patterns = torch.movedim(self.valid_mask, axis, -1)
        *partial_batch, width = patterns.shape
        return _group_index(patterns.reshape(-1, width)).reshape(partial_batch)

    def group_by_objects(self) -> torch.Tensor:
        """``[*batch]`` group ids: the paths with the same object sequence share one.

        >>> paths = TracedPaths(
        ...     torch.zeros((3, 3, 3)), torch.tensor([[0, 1, 0], [0, 2, 0], [0, 1, 0]]),
        ...     mask=torch.ones(3, dtype=torch.bool), interaction_types=torch.zeros((3, 1), dtype=torch.int32),
        ... )
        >>> paths.group_by_objects().tolist()
        [0, 1, 0]
        """
        *batch, path_length = self.objects.shape
        return _group_index(self.objects.reshape(-1, path_length)).reshape(batch)

    def reduce(self, fun: Callable[[torch.Tensor], torch.Tensor], axis: int | Sequence[int] | None = None) -> torch.Tensor:
        """The masked sum of ``fun(vertices)`` (``[*batch]``) over the batch ``axis`` (all axes when None).

        A float confidence weights each path (differentiably); a bool mask
        selects with ``where``, so that invalid paths' NaN or inf drop out.
        """
        contributions = fun(self.vertices)
        if self.mask.dtype == torch.bool:
            contributions = torch.where(self.mask, contributions, torch.zeros_like(contributions))
        else:
            contributions = contributions * self.mask
        if axis is None:
            return contributions.sum()
        return contributions.sum(dim=axis)

    def masked(self) -> "TracedPaths":
        """The valid paths only, their batch flattened (a mask of ones).

        >>> import torch
        >>> paths = TracedPaths(
        ...     torch.zeros((2, 3, 3, 3)), torch.zeros((2, 3, 3), dtype=torch.int64),
        ...     mask=torch.tensor([[True, False, True], [False, False, True]]),
        ...     interaction_types=torch.zeros((2, 3, 1), dtype=torch.int32),
        ... )
        >>> paths.masked().shape, paths.masked_objects.shape
        ((3,), torch.Size([3, 3]))
        """
        flat = self.reshape(-1)
        picks = torch.nonzero(flat.valid_mask).squeeze(-1)
        gathered = flat._remap(lambda x, nd: x[picks])
        return dataclasses.replace(
            gathered, mask=torch.ones(picks.shape, dtype=torch.bool, device=picks.device)
        )

    @property
    def masked_vertices(self) -> torch.Tensor:
        """``[num_valid_paths, path_length, 3]``: the vertices of the valid paths."""
        return self.masked().vertices

    @property
    def masked_objects(self) -> torch.Tensor:
        """``[num_valid_paths, path_length]``: the objects of the valid paths."""
        return self.masked().objects

    def pad_order(self, target_order: int) -> "TracedPaths":
        """Pad every path to ``target_order`` interactions.

        The extra points sit evenly along the last segment (between the last
        interaction and the RX), so that no segment has zero length and the
        length, delay and every frame stay as they were. They carry object
        -1 and interaction type -1, which the EM chain passes over.
        """
        extra = target_order - self.order
        if extra < 0:
            msg = f"Cannot pad order-{self.order} paths down to order {target_order}."
            raise ValueError(msg)
        if extra == 0:
            return self
        v = self.vertices
        seg_start, seg_end = v[..., -2:-1, :], v[..., -1:, :]
        fractions = (
            torch.arange(1, extra + 1, dtype=v.dtype, device=v.device) / (extra + 1)
        ).reshape(*([1] * (v.ndim - 2)), extra, 1)
        interior = seg_start + (seg_end - seg_start) * fractions
        pad = lambda x: torch.full((*x.shape[:-1], extra), -1, dtype=x.dtype, device=x.device)  # noqa: E731
        return dataclasses.replace(
            self,
            vertices=torch.cat((v[..., :-1, :], interior, seg_end), dim=-2),
            objects=torch.cat(
                (self.objects[..., :-1], pad(self.objects), self.objects[..., -1:]), dim=-1
            ),
            interaction_types=torch.cat(
                (self.interaction_types, pad(self.interaction_types)), dim=-1
            ),
        )

    def squeeze(self, axis: int | Sequence[int] | None = None) -> "TracedPaths":
        """Drop batch dimensions of extent one (all of them, or those of ``axis``)."""
        axes = _squeeze_axes(axis, self.shape)
        return self._remap(lambda x, nd: x.squeeze(axes) if axes else x)

    def __iter__(self) -> Iterator["TracedPaths"]:
        """The valid paths one by one, each of batch shape ``()`` with a true mask."""
        flat = self.masked()
        true = torch.ones((), dtype=torch.bool, device=flat.mask.device)
        for i in range(flat.vertices.shape[0]):
            yield TracedPaths(
                vertices=flat.vertices[i],
                objects=flat.objects[i],
                mask=true,
                interaction_types=flat.interaction_types[i],
                confidence_threshold=flat.confidence_threshold,
            )

    def plot(self, **kwargs: Any):
        """Draw the valid paths (:func:`differt_tpu_torch.plotting.draw_paths`)."""
        from ..plotting import draw_paths

        return draw_paths(self.masked_vertices, **kwargs)


def concatenate_paths(batches: Sequence[TracedPaths]) -> TracedPaths:
    """Join path batches along the candidate (last batch) axis.

    Batches of lower order are first padded to the highest
    (:meth:`TracedPaths.pad_order`), so that several orders merge into one
    container. The other batch axes must agree.

    >>> import torch
    >>> def batch(order, n):
    ...     return TracedPaths(
    ...         torch.zeros((n, order + 2, 3)), torch.zeros((n, order + 2), dtype=torch.int64),
    ...         mask=torch.ones(n, dtype=torch.bool),
    ...         interaction_types=torch.zeros((n, order), dtype=torch.int32),
    ...     )
    >>> merged = concatenate_paths([batch(1, 4), batch(2, 6)])
    >>> merged.shape, merged.order
    ((10,), 2)
    """
    if not batches:
        msg = "concatenate_paths needs at least one batch."
        raise ValueError(msg)
    target = max(b.order for b in batches)
    padded = [b.pad_order(target) for b in batches]

    def cat(name: str, trailing: int) -> torch.Tensor:
        tensors = [getattr(b, name) for b in padded]
        return torch.cat(tensors, dim=tensors[0].ndim - trailing - 1)

    return dataclasses.replace(
        padded[0], **{name: cat(name, nd) for name, nd in TracedPaths._TRAILING}
    )


class Paths(TracedPaths):
    """Deprecated alias of :class:`TracedPaths`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        warnings.warn(
            "Paths was renamed to TracedPaths; this alias will be removed.",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)


def _squeeze_axes(axis: int | Sequence[int] | None, batch_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Validate and normalize squeeze axes relative to the batch shape."""
    ndim = len(batch_shape)
    if axis is None:
        if ndim == 0:
            msg = "A 0-dimensional batch has no axes left to squeeze."
            raise ValueError(msg)
        # Only batch axes of extent one; never the per-path dimensions.
        return tuple(i for i, extent in enumerate(batch_shape) if extent == 1)
    resolved = []
    for a in (axis,) if isinstance(axis, int) else tuple(axis):
        shifted = a + ndim if a < 0 else a
        if not 0 <= shifted < ndim:
            msg = f"Squeeze axis {a} is out-of-bounds for a {ndim}-dimensional batch."
            raise ValueError(msg)
        if batch_shape[shifted] != 1:
            msg = f"Cannot squeeze batch axis {a} of extent {batch_shape[shifted]}."
            raise ValueError(msg)
        resolved.append(shifted)
    return tuple(resolved)


@dataclasses.dataclass(frozen=True)
class LaunchedPaths:
    """Paths produced by ray launching (SBR), with one mask per order."""

    vertices: torch.Tensor
    """``[*batch, path_length, 3]`` path vertex coordinates."""
    objects: torch.Tensor
    """``[*batch, path_length]`` object index per vertex (TX and RX indices at the ends)."""
    masks: torch.Tensor
    """``[*batch, path_length - 1]`` bool validity mask of each order 0 ... order."""
    interaction_types: torch.Tensor
    """``[*batch, path_length - 2]`` per-bounce interaction types."""

    _TRAILING = (("vertices", 2), ("objects", 1), ("masks", 1), ("interaction_types", 1))

    @property
    def shape(self) -> tuple[int, ...]:
        """Batch shape."""
        return tuple(self.vertices.shape[:-2])

    @property
    def path_length(self) -> int:
        return self.objects.shape[-1]

    @property
    def order(self) -> int:
        """The highest number of interactions per path."""
        return self.path_length - 2

    @property
    def mask(self) -> torch.Tensor:
        """The mask of the highest order."""
        return self.masks[..., -1]

    def get_paths(self, order: int) -> TracedPaths:
        """The :class:`TracedPaths` of one order (its first ``order`` bounces, then the RX)."""
        if not 0 <= order <= self.order:
            msg = (
                f"The requested order must be between 0 and {self.order} "
                f"(inclusive), got {order}."
            )
            raise ValueError(msg)
        head = slice(None, order + 1)
        return TracedPaths(
            vertices=torch.cat((self.vertices[..., head, :], self.vertices[..., -1:, :]), dim=-2),
            objects=torch.cat((self.objects[..., head], self.objects[..., -1:]), dim=-1),
            mask=self.masks[..., order],
            interaction_types=self.interaction_types[..., :order],
        )

    def _remap(self, fn) -> "LaunchedPaths":
        # fn(array, number of per-path trailing dimensions) -> array
        return dataclasses.replace(
            self, **{name: fn(getattr(self, name), nd) for name, nd in self._TRAILING}
        )

    def reshape(self, *batch: int) -> "LaunchedPaths":
        """Reshape the batch dimensions (``-1`` wildcards allowed)."""
        target = torch.empty(self.shape, device="meta").reshape(*batch).shape
        return self._remap(lambda x, nd: x.reshape(*target, *x.shape[x.ndim - nd :]))

    def squeeze(self, axis: int | Sequence[int] | None = None) -> "LaunchedPaths":
        """Drop batch dimensions of extent one (all of them, or those of ``axis``)."""
        axes = _squeeze_axes(axis, self.shape)
        return self._remap(lambda x, nd: x.squeeze(axes) if axes else x)

    def masked(self) -> TracedPaths:
        """The valid paths of the highest order, their batch flattened."""
        return self.get_paths(self.order).masked()

    @property
    def masked_vertices(self) -> torch.Tensor:
        """``[num_valid_paths, path_length, 3]``: the vertices of the valid highest-order paths."""
        return self.masked().vertices

    @property
    def masked_objects(self) -> torch.Tensor:
        """``[num_valid_paths, path_length]``: the objects of the valid highest-order paths."""
        return self.masked().objects

    def __iter__(self) -> Iterator[TracedPaths]:
        """The valid highest-order paths one by one."""
        yield from self.get_paths(self.order)

    def plot(self, **kwargs: Any):
        """Draw the valid paths of every order into one figure; ``kwargs`` go to every draw."""
        from ..plotting import reuse

        with reuse(**kwargs, pass_all_kwargs=True) as output:
            for order in range(self.order + 1):
                self.get_paths(order).plot()
        return output


class SBRPaths(LaunchedPaths):
    """Deprecated alias of :class:`LaunchedPaths`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        warnings.warn(
            "SBRPaths was renamed to LaunchedPaths; this alias will be removed.",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)
