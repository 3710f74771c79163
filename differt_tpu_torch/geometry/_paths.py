"""Traced path container (PyTorch port of ``differt_tpu.geometry._paths``, subset).

Paths keep full, fixed batch shapes plus a boolean validity mask: invalid
paths are masked, never dropped. (Float confidence masks come with the
smoothed checks, ROADMAP A5.)
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TracedPaths:
    """Paths produced by exact tracing."""

    vertices: torch.Tensor
    """``[*batch, path_length, 3]`` path vertex coordinates."""
    objects: torch.Tensor
    """``[*batch, path_length]`` object index per vertex (TX and RX indices at the ends)."""
    mask: torch.Tensor
    """``[*batch]`` bool validity mask."""
    interaction_types: torch.Tensor
    """``[*batch, path_length - 2]`` per-bounce interaction types."""

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
    def num_valid_paths(self) -> int:
        return int(torch.count_nonzero(self.mask))

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
