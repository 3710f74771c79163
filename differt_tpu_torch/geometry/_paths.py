"""Traced and launched path containers (PyTorch port of ``differt_tpu.geometry._paths``, subset).

Paths keep full, fixed batch shapes plus validity masks: invalid paths are
masked, never dropped. A traced path's mask is boolean, or with the
smoothed checks a float confidence that :attr:`TracedPaths.valid_mask`
holds against a threshold.
"""

import dataclasses
from collections.abc import Sequence

import torch


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
    confidence_threshold: float = 0.5
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

    def reshape(self, *batch: int) -> "TracedPaths":
        """Reshape the batch dimensions (``-1`` wildcards allowed)."""
        target = self.mask.reshape(*batch).shape
        return dataclasses.replace(
            self,
            vertices=self.vertices.reshape(*target, *self.vertices.shape[-2:]),
            objects=self.objects.reshape(*target, self.objects.shape[-1]),
            mask=self.mask.reshape(target),
            interaction_types=self.interaction_types.reshape(
                *target, self.interaction_types.shape[-1]
            ),
        )


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
